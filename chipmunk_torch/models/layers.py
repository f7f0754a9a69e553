"""Shared DiT building blocks (torch, param-dict based), the counterparts
of ``chipmunk_tpu/models/layers.py``.  Linear weights are [d_in, d_out]."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..ops.norm_rope import apply_rope, rmsnorm  # noqa: F401 (re-exported)
from ..utils.quant import materialize


def linear(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """x @ w (+ b); a QTensor weight is dequantized in x's dtype first."""
    y = x @ materialize(p['w'], x.dtype)
    if 'b' in p:
        y = y + p['b'].to(y.dtype)
    return y


def layernorm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Non-affine LayerNorm in fp32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0,
                       time_factor: float = 1000.0) -> torch.Tensor:
    """Sinusoidal embedding (t scaled by 1000)."""
    t = t * time_factor
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], -1)


def mlp_embedder(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return linear(p['out'], F.silu(linear(p['in'], x)))


def modulation(p: Dict, vec: torch.Tensor, n_sets: int) -> Tuple:
    """adaLN modulation: silu(vec) -> linear -> n_sets x (shift, scale,
    gate), each [B, 1, C]."""
    out = linear(p, F.silu(vec))[:, None, :]
    parts = out.chunk(3 * n_sets, -1)
    return tuple(tuple(parts[3 * i:3 * i + 3]) for i in range(n_sets))


def rope_angles(pos: torch.Tensor, dim: int, theta: float) -> torch.Tensor:
    """pos [..., n] -> angles [..., n, dim//2]."""
    scale = torch.arange(0, dim, 2, dtype=torch.float32,
                         device=pos.device) / dim
    omega = 1.0 / (theta ** scale)
    return pos.float()[..., None] * omega


def build_rope(ids: torch.Tensor, axes_dim, theta: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids: [B, S, n_axes] integer positions -> (cos, sin), each
    [B, 1, S, D//2]."""
    ang = torch.cat([rope_angles(ids[..., i], d, theta)
                     for i, d in enumerate(axes_dim)], -1)
    return torch.cos(ang)[:, None], torch.sin(ang)[:, None]
