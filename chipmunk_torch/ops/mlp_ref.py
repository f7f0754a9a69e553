"""Eager sparse-delta MLP reference (torch), the counterpart of
``chipmunk_tpu/ops/mlp_ref.py``.  Caches are token-major [T, N]."""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from .attn_ref import gather_mask_from_indices


def block_mean(x: torch.Tensor, mbm: int) -> torch.Tensor:
    """[B, T, C] -> [B, T//mbm, C] mean over mbm-token groups."""
    B, T, C = x.shape
    assert T % mbm == 0
    return x.reshape(B, T // mbm, mbm, C).mean(2)


def csp_mlp_ref(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                w2: torch.Tensor, inds: torch.Tensor, counts: torch.Tensor,
                sparse_act: torch.Tensor, out_cache: torch.Tensor, bm: int,
                act: Callable) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse-delta MLP step with token-granular neuron indices.

    For each bm-token block m with selected neurons S_m =
    inds[m, :counts[m]]: recompute act(x @ w1 + b1) at S_m, add
    (new - cached) @ w2[S_m] to the output cache and refresh the
    activation cache at S_m.  x: [T, C]; w1: [C, N]; w2: [N, C].
    Returns (new_out_cache, new_sparse_act)."""
    T, C = x.shape
    N = w1.shape[1]
    assert T % bm == 0
    sel = gather_mask_from_indices(inds, counts, N)           # [M, N]
    sel_t = sel.repeat_interleave(bm, 0)                      # [T, N]
    mid = x.float() @ w1.float() + b1.float()
    new_act = act(mid).to(x.dtype)
    delta = torch.where(sel_t, (new_act - sparse_act).float(),
                        torch.zeros((), device=x.device))
    out = out_cache.float() + delta @ w2.float()
    return out.to(out_cache.dtype), torch.where(sel_t, new_act, sparse_act)
