"""Command-line twins of ``examples/{flux,hunyuan,wan}_generate.py`` that
drive the port: ``python -m chipmunk_torch.cli.<name>``.  Each has
``main(argv=None)`` and a ``generate(...)`` to call from Python; each
runs on the card unless given ``--device cpu``."""
from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from ..config import ChipmunkConfig, load_config

# the ROADMAP items that flags of the JAX CLIs wait for
WAITS = {
    'parallel': 'ROADMAP Queue 1 item 5 (parallel/ on torch.distributed)',
}


def refuse(flag: str, wait: str, why: str = 'is not ported yet') -> None:
    """Exit non-zero naming the flag and the ROADMAP item it waits for."""
    raise SystemExit(f'{flag} {why}: it waits for {WAITS[wait]}')


def refuse_unported(args, parallel=()) -> None:
    """Refuse every given flag of ``parallel`` (attribute names of
    ``args``)."""
    for name in parallel:
        value = getattr(args, name, None)
        if value is not None and value is not False:
            refuse('--' + name.replace('_', '-'), 'parallel')


def read_config(path: Optional[str], steps: int,
                default: Optional[ChipmunkConfig] = None) -> ChipmunkConfig:
    """The config file (or ``default``) with ``steps`` set."""
    ck = load_config(path) if path else (default or ChipmunkConfig())
    return ck.replace(steps=steps)


# where a profiled generation writes its trace (utils/profiling.py), as
# the JAX CLIs write theirs: relative to the working directory
PROFILE_DIR = './profiles'


def model_dtype(dev: torch.device) -> torch.dtype:
    """bfloat16 on the card, float32 on the CPU (as the JAX CLIs take
    bfloat16 on the TPU only)."""
    return torch.bfloat16 if dev.type == 'cuda' else torch.float32


def noise(shape, seed: int, dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    """The initial latent: a float32 normal draw on the CPU from ``seed``
    (the same on every device), in the model's dtype."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).to(device)


def save_frames(pix: torch.Tensor, path: str) -> None:
    """Pixels in [-1, 1] as uint8 frames [B, 3, T, H, W] in a .npy."""
    frames = ((pix.float() + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)
    np.save(path, frames.cpu().numpy())
    print(f'pixels {tuple(frames.shape)} -> {path}')


def save_latents(lat: torch.Tensor, path: str) -> None:
    np.save(path, lat.float().cpu().numpy())


def warn(msg: str) -> None:
    print(f'WARNING: {msg}', file=sys.stderr)
