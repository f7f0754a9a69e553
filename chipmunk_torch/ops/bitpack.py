"""Bool-mask <-> uint8 bitfield packing (torch), the counterpart of
``chipmunk_tpu/ops/bitpack.py``: little-endian bit order within a byte,
byte for byte the reference's, of a whole mask (``bitpack``) or along the
last axis (``bitpack_rows``).  Compressed attention states keep their
selection mask in the row form (8x smaller than int32 indices)."""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

_WEIGHTS: Dict[torch.device, torch.Tensor] = {}


def _weights(device: torch.device) -> torch.Tensor:
    """The bit weights 1, 2, ..., 128 (uint8) on ``device``, made once per
    device: a tensor built from a list is a copy from the host, which
    every call would pay and a CUDA graph capture refuses."""
    w = _WEIGHTS.get(device)
    if w is None:
        w = _WEIGHTS[device] = torch.tensor([1 << i for i in range(8)],
                                            dtype=torch.uint8, device=device)
    return w


def bitpack_rows(mask: torch.Tensor) -> torch.Tensor:
    """bool [..., n] -> uint8 [..., ceil(n/8)]; bit i of byte j is
    mask[..., 8*j + i]."""
    n = mask.shape[-1]
    m = mask.to(torch.uint8)
    pad = (-n) % 8
    if pad:
        m = torch.nn.functional.pad(m, (0, pad))
    m = m.reshape(*m.shape[:-1], -1, 8)
    return (m * _weights(m.device)).sum(-1, dtype=torch.uint8)


def bitunpack_rows(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of bitpack_rows: uint8 [..., ceil(n/8)] -> bool [..., n]."""
    bits = (packed[..., None] & _weights(packed.device)) != 0
    return bits.reshape(*packed.shape[:-1], -1)[..., :n]


def bitpack(mask: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """A bool array as a flat bitfield: (uint8 [ceil(size/8)], its
    shape)."""
    return bitpack_rows(mask.reshape(-1)), tuple(mask.shape)


def bitunpack(packed: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Inverse of bitpack."""
    size = 1
    for s in shape:
        size *= s
    return bitunpack_rows(packed, size).reshape(tuple(shape))
