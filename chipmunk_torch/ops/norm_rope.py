"""The per-head RMSNorm and the interleaved RoPE of the DiT blocks' q and
k, in eager torch: the models' building blocks (``models/layers.py``
re-exports them) and the plain version of ``kernels.qkv_prologue``."""
from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    n = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * n).to(x.dtype) * scale.to(x.dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: [B, H, S, D]; rotates the interleaved pairs (x[2i], x[2i+1])."""
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    return torch.stack([r1, r2], -1).reshape(x.shape).to(x.dtype)
