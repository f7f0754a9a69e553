"""The one place where the port rounds to fp8 e4m3.

``torch``'s ``.to(torch.float8_e4m3fn)`` saturates: 470 and 1e4 become
448.  The reference (``jnp.astype(jnp.float8_e4m3fn)``, ml_dtypes) gives
NaN for every |x| > 464 (448 plus half an ulp) and for +-inf, and rounds
to nearest even below that.  Every fp8 cache write of the port goes
through :func:`to_fp8` (or :func:`cast`), and the CUDA kernels convert
with the same rule (``f2fp8_hw`` in ``csrc/common.cuh``).
"""
from __future__ import annotations

from typing import Optional

import torch

FP8 = torch.float8_e4m3fn
FP8_OVERFLOW = 464.0


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return torch.where(xf.abs() > FP8_OVERFLOW,
                       torch.full_like(xf, float('nan')), xf).to(FP8)


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.to(dtype)`` with the reference's fp8 overflow rule."""
    return to_fp8(x) if dtype == FP8 else x.to(dtype)


def dtype_from_name(name: Optional[str]) -> Optional[torch.dtype]:
    """Config dtype names ('float8_e4m3fn', 'bfloat16', ...) -> torch."""
    if name is None:
        return None
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f'unknown dtype name {name!r}')
    return dt


def raw(x: torch.Tensor) -> torch.Tensor:
    """A uint8 view of an fp8 tensor (indexing ops refuse fp8); other
    dtypes unchanged."""
    return x.view(torch.uint8) if x.dtype == FP8 else x
