"""Eager attention references (torch), the counterparts of
``chipmunk_tpu/ops/attn_ref.py``.

Numerics contract, as in the reference:
  * softmax in base 2: ``p_ij = 2^(s_ij * tau - norm_i)`` with
    ``tau = log2(e)/sqrt(D)``;
  * the per-row lse is kept in **log2 domain**, ``log2(sum_j 2^(s_ij tau))``;
  * padded query rows carry ``lse = PAD_LSE`` so their column-sum
    contribution is exactly 0;
  * column sums are normalised by the **previous step's** lse;
  * accumulation in fp32, outputs cast back to the input dtype.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

LOG2E = math.log2(math.e)
# Sentinel lse for padded rows: 2^(s - PAD_LSE) == 0 in fp32 for any real s.
PAD_LSE = 3.0e4


def attn_scale(head_dim: int) -> float:
    """tau such that 2^(s*tau) == e^(s/sqrt(D))."""
    return LOG2E / math.sqrt(head_dim)


def _scores2(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Base-2 scaled scores, fp32: [B,H,Sq,Sk]."""
    s = torch.einsum('bhid,bhjd->bhij', q.float(), k.float())
    return s * attn_scale(q.shape[-1])


def _softmax_out(s2: torch.Tensor, v: torch.Tensor, dtype
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    m = s2.amax(-1, keepdim=True)
    p = torch.exp2(s2 - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum('bhij,bhjd->bhid', p / l, v.float())
    return o.to(dtype), (m + torch.log2(l))[..., 0]


def dense_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_mask: Optional[torch.Tensor] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-causal attention forward returning (o [B,H,Sq,D], lse [B,H,Sq]).
    kv_mask: optional bool [Sk] marking valid KV rows."""
    s2 = _scores2(q, k)
    if kv_mask is not None:
        s2 = s2.masked_fill(~kv_mask, float('-inf'))
    return _softmax_out(s2, v, q.dtype)


def dense_colsum_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          prev_lse: torch.Tensor, qg: int,
                          kv_mask: Optional[torch.Tensor] = None,
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense attention plus per-query-group column sums of the
    previous-step-normalised probabilities.  Returns (o, colsums
    [B,H,G,Sk] fp32 token-granular, lse)."""
    B, H, Sq, D = q.shape
    assert Sq % qg == 0, f"Sq={Sq} must be padded to a multiple of qg={qg}"
    s2 = _scores2(q, k)
    if kv_mask is not None:
        s2 = s2.masked_fill(~kv_mask, float('-inf'))
    o, lse = _softmax_out(s2, v, q.dtype)
    p_prev = torch.exp2(s2 - prev_lse[..., None])
    colsums = p_prev.reshape(B, H, Sq // qg, qg, -1).sum(3)
    return o, colsums, lse


def gather_mask_from_indices(inds: torch.Tensor, counts: torch.Tensor,
                             n_cols: int) -> torch.Tensor:
    """bool [..., n_cols], True at inds[..., :counts[...]]."""
    valid = torch.arange(inds.shape[-1], device=inds.device) < counts[..., None]
    mask = torch.zeros(*inds.shape[:-1], n_cols + 1, dtype=torch.bool,
                       device=inds.device)
    # invalid entries go to the spare column n_cols, then dropped
    mask.scatter_(-1, torch.where(valid, inds.long(), n_cols), True)
    return mask[..., :n_cols]


def csp_block_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       block_inds: torch.Tensor, block_counts: torch.Tensor,
                       qg: int, kv_block: int,
                       kv_valid: Optional[int] = None) -> torch.Tensor:
    """Column-sparse attention with block-granular indices: query group g
    attends only to the kv_block-token blocks
    ``block_inds[..., g, :block_counts[..., g]]``."""
    Sk = k.shape[-2]
    assert Sk % kv_block == 0
    mask_b = gather_mask_from_indices(block_inds, block_counts,
                                      Sk // kv_block)
    mask = mask_b.repeat_interleave(kv_block, -1)            # [B,H,G,Sk]
    if kv_valid is not None and kv_valid < Sk:
        mask = mask & (torch.arange(Sk, device=q.device) < kv_valid)
    mask = mask.repeat_interleave(qg, 2)
    s2 = _scores2(q, k).masked_fill(~mask, float('-inf'))
    m = s2.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(mask, torch.exp2(s2 - m), torch.zeros_like(s2))
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum('bhij,bhjd->bhid', p / l, v.float())
    return o.to(q.dtype)
