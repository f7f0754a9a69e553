"""Command-line twins of ``examples/{flux,hunyuan,wan}_generate.py`` that
drive the port: ``python -m chipmunk_torch.cli.<name>``.  Each has
``main(argv=None)`` and a ``generate(...)`` to call from Python; each
runs on the card unless given ``--device cpu``.  The video twins run
sharded over ranks with ``--mesh`` (``setup_parallel``), rank 0 alone
printing and writing the outputs."""
from __future__ import annotations

import os
import sys
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import ChipmunkConfig, load_config


def parse_mesh(spec: str) -> Dict[str, int]:
    """'dp=2,sp=4' -> {'dp': 2, 'sp': 4}; exits non-zero on another axis
    name or a malformed spec."""
    axes = {}
    for part in spec.split(','):
        name, _, size = part.partition('=')
        name = name.strip()
        if name not in ('dp', 'sp') or not size.strip().isdigit() \
                or int(size) < 1:
            raise SystemExit(f'--mesh {spec!r}: give dp=<n>,sp=<n> (axes dp '
                             f'and sp, sizes >= 1)')
        axes[name] = int(size)
    return axes


def setup_parallel(args, device: torch.device, num_heads: int):
    """The multi-host flags and ``--mesh`` of a twin.  ``--multihost``
    joins the process group (``parallel.initialize_multihost``: with
    ``--coordinator`` a world of ``--num-processes`` ranks, this one
    ``--process-id``; without it torchrun's world, else a world of one).
    ``--mesh dp=a,sp=b`` needs ``sp`` dividing the heads and a world of
    a*b ranks (torchrun or the multi-host flags), else it exits non-zero
    naming the numbers, before any process group is made.  Returns the
    mesh, or None without ``--mesh``."""
    from ..parallel import initialize_multihost, make_mesh
    coordinator = args.coordinator if args.multihost else None
    if coordinator and (args.num_processes is None
                        or args.process_id is None):
        raise SystemExit('--coordinator needs --num-processes and '
                         '--process-id')
    if args.mesh:
        axes = parse_mesh(args.mesh)
        if num_heads % axes.get('sp', 1):
            raise SystemExit(f'num_heads={num_heads} not divisible by '
                             f'sp={axes["sp"]}')
        need = int(np.prod(list(axes.values())))
        have = args.num_processes if coordinator else int(
            os.environ.get('WORLD_SIZE', 1))
        if need != have:
            raise SystemExit(
                f'--mesh {args.mesh} needs {need} ranks, the world has '
                f'{have}: launch {need} processes (torchrun '
                f'--nproc-per-node {need}, or --multihost)')
    if args.multihost or args.mesh:
        initialize_multihost(coordinator, args.num_processes,
                             args.process_id, device)
    return make_mesh(axes) if args.mesh else None


def is_main() -> bool:
    """Whether this process prints and writes the outputs: rank 0, or a
    run without a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def say(msg: str) -> None:
    """Print on rank 0 alone."""
    if is_main():
        print(msg)


def finish() -> None:
    """Leave the process group, if this run joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


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
