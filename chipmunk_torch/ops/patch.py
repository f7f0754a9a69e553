"""2-D two-level space-filling token reorder for images, the counterpart
of ``chipmunk_tpu/ops/patch.py``: the permutations in numpy (they depend
on shapes only), and their application to torch tensors.

Tokens are reordered so that ``c1 x c1`` spatial patches (split further
into ``c2 x c2`` sub-patches) are contiguous, which makes the token blocks
of the MLP and the query groups of attention spatially local.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def patch_order(h: int, w: int, c1: int = 8, c2: int = 4) -> np.ndarray:
    """Permutation p of length h*w: patchified_flat = flat[p]."""
    assert h % c1 == 0 and w % c1 == 0 and c1 % c2 == 0
    ids = np.arange(h * w).reshape(h, w)
    ids = ids.reshape(h // c1, c1, w // c1, c1).transpose(0, 2, 1, 3)
    ids = ids.reshape(-1, c1, c1)
    r = c1 // c2
    ids = ids.reshape(-1, r, c2, r, c2).transpose(0, 1, 3, 2, 4)
    return ids.reshape(-1).astype(np.int32)


@lru_cache(maxsize=None)
def inverse_patch_order(h: int, w: int, c1: int = 8, c2: int = 4) -> np.ndarray:
    p = patch_order(h, w, c1, c2)
    inv = np.empty_like(p)
    inv[p] = np.arange(p.shape[0], dtype=np.int32)
    return inv


def _take(x: torch.Tensor, perm: np.ndarray, axis: int) -> torch.Tensor:
    return torch.index_select(x, axis, torch.from_numpy(perm).long()
                              .to(x.device))


def patchify(x: torch.Tensor, c1: int = 8, c2: int = 4) -> torch.Tensor:
    """[b, h, w] -> [b, h*w] in patch order."""
    assert x.ndim == 3
    b, h, w = x.shape
    return _take(x.reshape(b, h * w), patch_order(h, w, c1, c2), 1)


def unpatchify(x_flat: torch.Tensor, original_shape, c1: int = 8,
               c2: int = 4) -> torch.Tensor:
    """Inverse of patchify: [b, h*w] -> ``original_shape`` [b, h, w]."""
    b, h, w = original_shape
    return _take(x_flat, inverse_patch_order(h, w, c1, c2), 1
                 ).reshape(b, h, w)


def patchify_tokens(x: torch.Tensor, h: int, w: int, axis: int,
                    c1: int = 8, c2: int = 4) -> torch.Tensor:
    """The patch permutation along ``axis`` (length h*w) of any tensor."""
    return _take(x, patch_order(h, w, c1, c2), axis)


def unpatchify_tokens(x: torch.Tensor, h: int, w: int, axis: int,
                      c1: int = 8, c2: int = 4) -> torch.Tensor:
    return _take(x, inverse_patch_order(h, w, c1, c2), axis)


def patchify_rope(pe: torch.Tensor, img_tokens: int, h: int, w: int,
                  axis: int, c1: int = 8, c2: int = 4) -> torch.Tensor:
    """Reorder the trailing ``img_tokens`` positions of a RoPE table
    along ``axis`` by the patch permutation; the text positions before
    them stay."""
    txt = pe.shape[axis] - img_tokens
    perm = np.concatenate([np.arange(txt, dtype=np.int32),
                           txt + patch_order(h, w, c1, c2)])
    return _take(pe, perm, axis)
