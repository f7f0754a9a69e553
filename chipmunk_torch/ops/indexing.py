"""Index/mask ops (torch), the counterparts of
``chipmunk_tpu/ops/indexing.py`` used by the FLUX and HunyuanVideo paths.

Top-k is exact per row.  ``torch.topk`` and ``jax.lax.top_k`` order tied
values differently, so parity holds for tie-free scores (the tests assert
that their random inputs are tie-free).  Random keeps come from an
explicit ``torch.Generator`` or are injected, since torch cannot draw
``jax.random``'s bits.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def topk_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """bool mask of the top-k entries along the last axis."""
    mask = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    if k <= 0:
        return mask
    idx = torch.topk(scores, k, dim=-1).indices
    return mask.scatter_(-1, idx, True)


def random_and_topk_mask(colsums: torch.Tensor, k: int,
                         keep_mask: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         sparse_query_groups: Optional[torch.Tensor] = None,
                         static_mask: Optional[torch.Tensor] = None,
                         random_frac: float = 0.01) -> torch.Tensor:
    """Attention column mask: a Bernoulli(random_frac) keep, union the
    top-k of the column sums, gated by the per-query-group "is sparse"
    flags [G, 1], union the static mask [G, NB].

    colsums: [B,H,G,NB] fp32.  The keep is ``keep_mask`` when given (bool,
    the shape of colsums), else drawn from ``generator``.  Returns bool
    [B,H,G,NB]."""
    if keep_mask is None:
        if random_frac <= 0:
            keep_mask = torch.zeros(colsums.shape, dtype=torch.bool,
                                    device=colsums.device)
        elif generator is None:
            raise ValueError('attn.random_keys > 0 needs a generator or an '
                             'injected keep_mask')
        else:
            keep_mask = torch.rand(colsums.shape, generator=generator,
                                   device=colsums.device) < random_frac
    mask = keep_mask.to(colsums.device) | topk_mask(colsums, k)
    if sparse_query_groups is not None:
        mask = mask & sparse_query_groups
    if static_mask is not None:
        mask = mask | static_mask
    return mask


def mask_to_indices(mask: torch.Tensor, multiple_of: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row compaction of a bool mask [..., n]: (inds int32 [..., n],
    counts int32 [...]).  Selected columns first in ascending order, then
    the unselected ones in ascending order (a stable sort); counts rounded
    up to ``multiple_of`` and capped at n, so consumers read whole
    tiles."""
    n = mask.shape[-1]
    counts = (mask.sum(-1) + multiple_of - 1) // multiple_of * multiple_of
    inds = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
    return inds.to(torch.int32), counts.clamp(max=n).to(torch.int32)


def mask_to_indices_limited(mask: torch.Tensor, multiple_of: int, jmax: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first ``jmax`` slots of the reference's ``mask_to_indices``:
    selected columns first in ascending order, then unselected columns in
    ascending order; counts rounded up to ``multiple_of`` (capped at n).

    Same key as the reference, ``i + n*(1 - mask[i])``, whose jmax smallest
    entries (unique, so no ties) are exactly that layout.
    Returns (inds int32 [..., jmax], counts int32 [...])."""
    n = mask.shape[-1]
    jmax = min(jmax, n)
    nsel = mask.sum(-1)
    counts = (nsel + multiple_of - 1) // multiple_of * multiple_of
    counts = counts.clamp(max=n).to(torch.int32)
    iota = torch.arange(n, device=mask.device)
    key = torch.where(mask, iota, iota + n)
    smallest = torch.topk(key, jmax, dim=-1, largest=False, sorted=True).values
    return (smallest % n).to(torch.int32), counts


def blockify_scores(scores: torch.Tensor, block: int) -> torch.Tensor:
    """Sum scores within contiguous column blocks: [..., n] -> [..., n/block]."""
    assert scores.shape[-1] % block == 0
    return scores.reshape(*scores.shape[:-1], scores.shape[-1] // block,
                          block).sum(-1)


def blockify_mask(mask: torch.Tensor, block: int) -> torch.Tensor:
    """any() over contiguous column blocks: [..., n] -> bool [..., n/block]."""
    assert mask.shape[-1] % block == 0
    return mask.reshape(*mask.shape[:-1], mask.shape[-1] // block,
                        block).any(-1)


def copy_indices(new: torch.Tensor, cache: torch.Tensor,
                 sel_mask: torch.Tensor) -> torch.Tensor:
    """Refresh cached block-means only at selected columns."""
    return torch.where(sel_mask, new, cache)


def topk_indices(scores: torch.Tensor, sparsity: float, multiple_of: int,
                 random_frac: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 keep_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MLP neuron selection: the top (1 - sparsity) share of each row,
    union a Bernoulli(random_frac) keep (``keep_mask`` when given, else
    drawn from ``generator``), compacted by ``mask_to_indices``.  Returns
    (inds [..., n], counts [...], mask [..., n])."""
    n = scores.shape[-1]
    mask = topk_mask(scores, int(round((1.0 - sparsity) * n)))
    if keep_mask is not None:
        mask = mask | keep_mask.to(mask.device)
    elif random_frac > 0:
        if generator is None:
            raise ValueError('random_frac > 0 needs a generator or an '
                             'injected keep_mask')
        mask = mask | (torch.rand(scores.shape, generator=generator,
                                  device=scores.device) < random_frac)
    inds, counts = mask_to_indices(mask, multiple_of)
    return inds, counts, mask


def _index_mask(ix: torch.Tensor, n: int) -> torch.Tensor:
    """bool [..., n], True at the ids of ``ix`` [..., K]; ids in [-n, 0)
    count from the end, ids outside [-n, n) are dropped."""
    ix = ix.long()
    ix = torch.where(ix < 0, ix + n, ix)
    ix = torch.where((ix >= 0) & (ix < n), ix, n)
    m = torch.zeros(*ix.shape[:-1], n + 1, dtype=torch.bool,
                    device=ix.device)
    return m.scatter_(-1, ix, True)[..., :n]


def merge_indices(a: torch.Tensor, b: torch.Tensor, n_cols: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The union of two per-row index sets [..., Ka] and [..., Kb] over
    ``n_cols`` columns, without duplicates: ``mask_to_indices`` of it
    (counts exact)."""
    return mask_to_indices(_index_mask(a, n_cols) | _index_mask(b, n_cols),
                           1)


def scatter_add(packed: torch.Tensor, unpacked: torch.Tensor,
                inds: torch.Tensor, counts: torch.Tensor, block: int = 1
                ) -> torch.Tensor:
    """Add a packed per-row-block delta into a full buffer: row block m
    (``bm = packed.shape[0] / M`` rows) adds its column block j of
    ``packed`` into the columns ``inds[m, j] * block + [0, block)`` of
    ``unpacked``, for the first ``counts[m]`` slots.  packed [M*bm,
    jmax*block], unpacked [M*bm, n], inds [M, jmax] block ids, counts
    [M].  Returns a new buffer of unpacked's dtype."""
    M, jmax = inds.shape
    bm = packed.shape[0] // M
    n = unpacked.shape[-1]
    dev = unpacked.device
    valid = torch.arange(jmax, device=dev)[None] < counts.to(dev)[:, None]
    pk = packed.reshape(M, bm, jmax, block).to(unpacked.dtype)
    pk = torch.where(valid[:, None, :, None], pk, torch.zeros_like(pk))
    tgt = (inds.to(dev).long()[:, :, None] * block
           + torch.arange(block, device=dev)).reshape(M, jmax * block)
    tgt = torch.where(tgt < 0, tgt + n, tgt)
    tgt = torch.where((tgt >= 0) & (tgt < n), tgt, n)
    out = torch.nn.functional.pad(unpacked.reshape(M, bm, n), (0, 1))
    out.scatter_add_(-1, tgt[:, None, :].expand(M, bm, jmax * block),
                     pk.reshape(M, bm, jmax * block))
    return out[..., :n].reshape(unpacked.shape)
