"""Device selection for the port's entry points: they run on the card
unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = 'cuda') -> torch.device:
    """``torch.device(device)``; raises for a CUDA device when no GPU is
    present (pass ``device='cpu'`` to run the plain versions on the CPU)."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'chipmunk_torch runs on a CUDA device and none is available; '
            "pass device='cpu' to run the plain PyTorch versions instead")
    return dev
