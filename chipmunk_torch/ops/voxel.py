"""3-D voxel token reordering and static local-attention masks for video,
the port's own copy of ``chipmunk_tpu/ops/voxel.py``: the permutations
and masks in numpy (array for array the same; they depend on shapes only
and are made once per model at build time), and the reorder of torch
tensors.

The reorder flattens a (t, h, w) token grid so each voxel's tokens (4x4x8 =
128 by default, one query group) are contiguous, with the t-, h- and
w-tails that do not fill a voxel appended in raster order.  The static
mask gives every query group its local voxel cube plus the text tail.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@lru_cache(maxsize=None)
def voxel_order(t: int, h: int, w: int,
                voxel_shape: Tuple[int, int, int] = (4, 4, 8)) -> np.ndarray:
    """Permutation p (length t*h*w): voxel_flat = raster_flat[p].  Full
    voxels in raster voxel order, then the t-, h- and w-tails raster."""
    vt, vh, vw = voxel_shape
    tf, hf, wf = (t // vt) * vt, (h // vh) * vh, (w // vw) * vw
    ids = np.arange(t * h * w).reshape(t, h, w)
    main = ids[:tf, :hf, :wf]
    main = main.reshape(tf // vt, vt, hf // vh, vh, wf // vw, vw)
    main = main.transpose(0, 2, 4, 1, 3, 5).reshape(-1)
    tails = [ids[tf:, :, :].reshape(-1),
             ids[:tf, hf:, :].reshape(-1),
             ids[:tf, :hf, wf:].reshape(-1)]
    return np.concatenate([main] + tails).astype(np.int32)


@lru_cache(maxsize=None)
def inverse_voxel_order(t: int, h: int, w: int,
                        voxel_shape: Tuple[int, int, int] = (4, 4, 8)
                        ) -> np.ndarray:
    p = voxel_order(t, h, w, voxel_shape)
    inv = np.empty_like(p)
    inv[p] = np.arange(p.shape[0], dtype=np.int32)
    return inv


def _take(x: torch.Tensor, perm: np.ndarray, axis: int) -> torch.Tensor:
    return torch.index_select(x, axis, torch.from_numpy(perm).long()
                              .to(x.device))


def voxel_chunk_no_padding(x: torch.Tensor,
                           voxel_shape: Tuple[int, int, int] = (4, 4, 8)
                           ) -> torch.Tensor:
    """[b, ah, t, h, w, d] -> [b, ah, t*h*w, d] in voxel order."""
    b, ah, t, h, w, d = x.shape
    return _take(x.reshape(b, ah, t * h * w, d),
                 voxel_order(t, h, w, voxel_shape), 2)


def reverse_voxel_chunk_no_padding(x_flat: torch.Tensor, original_shape,
                                   voxel_shape: Tuple[int, int, int]
                                   = (4, 4, 8)) -> torch.Tensor:
    """Inverse of voxel_chunk_no_padding, back to ``original_shape``."""
    b, ah, t, h, w, d = original_shape
    return _take(x_flat, inverse_voxel_order(t, h, w, voxel_shape), 2
                 ).reshape(b, ah, t, h, w, d)


def voxel_tokens(x: torch.Tensor, grid: Tuple[int, int, int], axis: int,
                 voxel_shape: Tuple[int, int, int] = (4, 4, 8)
                 ) -> torch.Tensor:
    """The voxel permutation along ``axis`` of any token-major tensor."""
    return _take(x, voxel_order(*grid, voxel_shape), axis)


def unvoxel_tokens(x: torch.Tensor, grid: Tuple[int, int, int], axis: int,
                   voxel_shape: Tuple[int, int, int] = (4, 4, 8)
                   ) -> torch.Tensor:
    return _take(x, inverse_voxel_order(*grid, voxel_shape), axis)


def _window_starts(n: int, span: int) -> np.ndarray:
    """Start of the length-``span`` window centred on each of [0, n),
    clamped in bounds."""
    span = min(span, n)
    return np.clip(np.arange(n) - span // 2, 0, n - span)


def get_local_voxel_indices(full_shape: Tuple[int, int, int],
                            local_shape: Tuple[int, int, int]) -> np.ndarray:
    """For each voxel of the (t, h, w) voxel grid, the flat ids of its
    local neighbourhood cube: int32 [t*h*w, st*sh*sw] with span
    2*(l//2)+1 per axis, clamped to the grid."""
    t, h, w = full_shape
    lt, lh, lw = local_shape
    if lt == 0 or lh == 0 or lw == 0:
        return np.zeros((t * h * w, 0), dtype=np.int32)
    st, sh, sw = (min(2 * (l // 2) + 1, n)
                  for l, n in zip((lt, lh, lw), (t, h, w)))
    ts = _window_starts(t, st)[:, None] + np.arange(st)[None, :]
    hs = _window_starts(h, sh)[:, None] + np.arange(sh)[None, :]
    ws = _window_starts(w, sw)[:, None] + np.arange(sw)[None, :]
    flat = (ts[:, None, None, :, None, None] * (h * w)
            + hs[None, :, None, None, :, None] * w
            + ws[None, None, :, None, None, :])
    return flat.reshape(t * h * w, st * sh * sw).astype(np.int32)


def get_local_indices_with_text(
    vid_shape: Tuple[int, int, int],
    txt_len: int,
    voxel_shape: Tuple[int, int, int] = (4, 4, 8),
    local_shape: Tuple[int, int, int] = (0, 0, 0),
    rk: float = 0.0,
    kv_tile_size: int = 128,
    rng: Optional[np.random.Generator] = None,
    full_tail_from_attn: bool = False,
    full_tail_to_attn: bool = False,
):
    """The static attention mask [n_query_groups, seq] over the
    voxel-ordered [img | txt] sequence: every group attends to all text
    tokens, image voxels to their local cube, tail rows to the last
    ``local_size`` tokens, text rows to the last (seq // kv_tile_size) *
    kv_tile_size tokens, plus optional random columns (prob rk).  Returns
    (mask bool [G, S], inds, counts) as numpy arrays."""
    tt, th, tw = vid_shape
    vt, vh, vw = voxel_shape
    lt, lh, lw = local_shape
    vid_seqlen = tt * th * tw
    seq = vid_seqlen + txt_len
    voxel_size = vt * vh * vw
    n_groups = _cdiv(seq, voxel_size)

    mask = np.zeros((n_groups, seq), dtype=bool)
    mask[:, vid_seqlen:] = True

    vtt, vth, vtw = tt // vt, th // vh, tw // vw
    n_img_voxels = vtt * vth * vtw
    local = get_local_voxel_indices((vtt, vth, vtw), (lt, lh, lw))
    if local.shape[1] > 0:
        vox_mask = np.zeros((n_img_voxels, n_img_voxels), dtype=bool)
        np.put_along_axis(vox_mask, local, True, axis=1)
        tok_mask = np.repeat(vox_mask, voxel_size, axis=1)
        n_main = n_img_voxels * voxel_size
        if full_tail_to_attn:
            mask[:n_img_voxels, n_main:] = True
        mask[:n_img_voxels, :n_main] |= tok_mask

    pad0 = n_groups - n_img_voxels
    local_size = voxel_size * lt * lh * lw
    if local_size > 0 and pad0 > 0:
        mask[n_img_voxels:, -local_size:] = True
    n_text_rows = txt_len // voxel_size + 1
    mask[-n_text_rows:, -((seq // kv_tile_size) * kv_tile_size):] = True
    if full_tail_from_attn and pad0 > 0:
        mask[-pad0:, -((seq // kv_tile_size) * kv_tile_size):] = True
    if rk > 0:
        rng = rng or np.random.default_rng(0)
        rand = rng.random(mask.shape) < rk
        if full_tail_from_attn and pad0 > 0:
            rand[-pad0:, :] = False
        rand[-n_text_rows:, :] = False
        mask |= rand

    counts = mask.sum(axis=-1).astype(np.int32)
    counts = ((counts + kv_tile_size - 1) // kv_tile_size) * kv_tile_size
    counts = np.minimum(counts, seq)
    inds = np.argsort(~mask, axis=-1, kind='stable').astype(np.int32)
    return mask, inds, counts


def local_1d_window_mask(vid_seqlen: int, total_seqlen: int,
                         window_frac: float, qg: int = 128) -> np.ndarray:
    """Static 1-D window: each image query group attends to
    ``window_frac * vid_seqlen`` tokens centred on it."""
    n_groups = -(-total_seqlen // qg)
    mask = np.zeros((n_groups, total_seqlen), dtype=bool)
    if window_frac <= 0:
        return mask
    w = int(window_frac * vid_seqlen)
    for g in range(vid_seqlen // qg):
        center = g * qg + qg // 2
        lo = max(0, center - w // 2)
        hi = min(vid_seqlen, center + w // 2)
        mask[g, lo:hi] = True
    return mask
