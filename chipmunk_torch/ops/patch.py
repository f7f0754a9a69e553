"""2-D two-level space-filling token reorder for images (numpy), the
counterpart of ``chipmunk_tpu/ops/patch.py``.

Tokens are reordered so that ``c1 x c1`` spatial patches (split further
into ``c2 x c2`` sub-patches) are contiguous, which makes the token blocks
of the MLP and the query groups of attention spatially local.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np


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
