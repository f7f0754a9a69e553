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
    'profiling': 'ROADMAP Queue 1 item 6 (utils/profiling.py)',
    'text': 'ROADMAP Queue 1 item 3 (the tokenizer-bound text encoders)',
}


def refuse(flag: str, wait: str, why: str = 'is not ported yet') -> None:
    """Exit non-zero naming the flag and the ROADMAP item it waits for."""
    raise SystemExit(f'{flag} {why}: it waits for {WAITS[wait]}')


def refuse_unported(args, parallel=(), text=()) -> None:
    """Refuse every given flag of ``parallel`` / ``text`` (attribute
    names of ``args``), and ``--profile`` where the parser has it."""
    for name in parallel:
        value = getattr(args, name, None)
        if value is not None and value is not False:
            refuse('--' + name.replace('_', '-'), 'parallel')
    for name in text:
        if getattr(args, name, None):
            refuse('--' + name.replace('_', '-'), 'text')
    if getattr(args, 'profile', False):
        refuse('--profile', 'profiling')


def read_config(path: Optional[str], steps: int,
                default: Optional[ChipmunkConfig] = None) -> ChipmunkConfig:
    """The config file (or ``default``) with ``steps`` set; a config that
    asks for a profile trace is refused, as ``--profile`` is."""
    ck = load_config(path) if path else (default or ChipmunkConfig())
    if ck.should_profile:
        refuse('should_profile in the config', 'profiling',
               why='asks for a trace, which is not ported yet')
    return ck.replace(steps=steps)


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
