"""Bool-mask <-> uint8 bitfield packing along the last axis (torch), the
counterpart of ``bitpack_rows``/``bitunpack_rows`` in
``chipmunk_tpu/ops/bitpack.py``: little-endian bit order within a byte,
byte for byte the reference's.  Compressed attention states keep their
selection mask in this form (8x smaller than int32 indices)."""
from __future__ import annotations

import torch


def _weights(device) -> torch.Tensor:
    return torch.tensor([1 << i for i in range(8)], dtype=torch.uint8,
                        device=device)


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
