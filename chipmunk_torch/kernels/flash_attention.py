"""Dense flash attention with a log2-domain lse, and its column-sum
variant: wrappers over ``csrc/flash_attention.cu`` with their plain
PyTorch versions.

Counterparts of ``chipmunk_tpu/kernels/flash_attention.py`` (``dense_attn``
and ``dense_colsum_attn``).  On CPU tensors the wrappers run the plain
version; on CUDA tensors they launch the kernel or raise.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops.attn_ref import attn_scale
from . import _build

HEAD_DIM = 128   # the kernels' head dim
# score blocks below 64 keys that the column-sum kernel takes (besides the
# multiples of 64): the divisors of its 128-key tile down to one key
SMALL_SCORE_BLOCKS = (1, 2, 4, 8, 16, 32)


def _check_qkv(q, k, v):
    if q.dim() != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[-1] != k.shape[-1]:
        raise ValueError(f'q {tuple(q.shape)}, k {tuple(k.shape)}, '
                         f'v {tuple(v.shape)} are not [B,H,S,D] alike')
    if not (q.device == k.device == v.device):
        raise ValueError('q, k, v on different devices')
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError('q, k, v of different dtypes')


def check_cuda_attn(name: str, *tensors: torch.Tensor,
                    strided: bool = False) -> None:
    """The kernels take bf16 [B,H,S,128] CUDA tensors, contiguous or, with
    ``strided``, with contiguous rows and any stride between heads (a
    slice along S of a contiguous tensor, see head_stride)."""
    for t in tensors:
        if t.device.type != 'cuda':
            raise ValueError(f'{name}: tensors must be on one CUDA device '
                             f'or all on the CPU, got {t.device}')
        if t.dtype != torch.bfloat16 or t.shape[-1] != HEAD_DIM:
            raise ValueError(f'{name}: the kernel takes bf16 with head dim '
                             f'{HEAD_DIM}, got {t.dtype} {tuple(t.shape)}')
        if strided:
            head_stride(name, t)
        elif not t.is_contiguous():
            raise ValueError(f'{name}: inputs must be contiguous')


def head_stride(name: str, t: torch.Tensor) -> int:
    """Elements from one head's first row to the next head's of a
    [B,H,S,D] tensor whose rows are contiguous and whose heads are evenly
    spaced across B and H (``x[..., a:b, :]`` of a contiguous x)."""
    B, H, S, D = t.shape
    hs = t.stride(1)
    if t.stride(-1) != 1 or (S > 1 and t.stride(-2) != D) \
            or (B > 1 and t.stride(0) != H * hs) or hs < S * D:
        raise ValueError(f'{name}: rows must be contiguous and heads evenly '
                         f'spaced, got strides {t.stride()}')
    return hs


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _scores(q, k):
    """fp32 scores scaled by tau, as the kernel's mma + scale."""
    return torch.einsum('bhid,bhjd->bhij', q.float(), k.float()) \
        * attn_scale(q.shape[-1])


def _online_out(s, v, out_dtype):
    """Softmax rows of s (already scaled) against v the way the kernel
    does it: p in v's dtype for the product, l summed in fp32, l == 0
    guarded, lse = m + log2(l)."""
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum('bhij,bhjd->bhid', p.to(v.dtype).float(), v.float()) / l
    return o.to(out_dtype), (m + torch.log2(l))[..., 0]


def dense_attn_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dense kernel (same arithmetic, one shot)."""
    return _online_out(_scores(q, k), v, q.dtype)


def dense_colsum_attn_plain(q, k, v, prev_lse, qg: int = 128,
                            score_block: int = 128):
    """Plain version of the colsum kernel: (o, colsums
    [B,H,Sq/qg,ceil(Sk/score_block)], lse)."""
    B, H, Sq, _ = q.shape
    Sk = k.shape[-2]
    s = _scores(q, k)
    o, lse = _online_out(s, v, q.dtype)
    p_prev = torch.exp2(s - prev_lse.float()[..., None])
    gs = p_prev.reshape(B, H, Sq // qg, qg, Sk).sum(3)
    pad = (-Sk) % score_block
    gs = torch.nn.functional.pad(gs, (0, pad))
    cs = gs.reshape(B, H, Sq // qg, -1, score_block).sum(-1)
    return o, cs, lse


def _kv_strides(name, q, k, v):
    """Head strides of q and of k/v (which must share theirs)."""
    check_cuda_attn(name, q, k, v, strided=True)
    if k.stride() != v.stride():
        raise ValueError(f'{name}: k and v must have the same strides')
    return head_stride(name, q), head_stride(name, k)


def dense_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward.  q,k,v: [B,H,S,D] -> (o [B,H,Sq,D],
    lse fp32 [B,H,Sq] in log2 domain).  Ragged Sq and Sk are handled
    inside the kernel (the scores of keys past Sk are set to -inf and add
    exactly 0).  q, k and v
    may be slices along S of larger tensors (``k[..., :n, :]``,
    ``q[..., t0:, :]``): the kernel takes their head strides, so nothing
    is copied."""
    _check_qkv(q, k, v)
    if q.device.type == 'cpu':
        return dense_attn_plain(q, k, v)
    q_hs, kv_hs = _kv_strides('dense_attn', q, k, v)
    B, H, Sq, D = q.shape
    Sk = k.shape[-2]
    o = torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _build.library('flash_attention')
    _build.check(lib.chipmunk_dense_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B * H, Sq, Sk, q_hs, kv_hs, attn_scale(D),
        _stream(q)), 'dense_attn')
    _build.LAUNCHES['dense_attn'] += 1
    return o, lse


def dense_colsum_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      prev_lse: torch.Tensor, qg: int = 128,
                      score_block: int = 128
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash attention that also emits per-query-group column sums of the
    prev-lse-normalised probabilities, summed within ``score_block``-key
    blocks.  Padded query rows must carry prev_lse = PAD_LSE.  q, k, v
    may be slices along S, as for dense_attn.  Any qg that divides Sq; on
    the card score_block 1, 2, 4, 8, 16, 32 or a multiple of 64.

    Returns (o [B,H,Sq,D], colsums fp32 [B,H,Sq/qg,ceil(Sk/score_block)],
    lse fp32 [B,H,Sq])."""
    _check_qkv(q, k, v)
    B, H, Sq, D = q.shape
    Sk = k.shape[-2]
    if Sq % qg:
        raise ValueError(f'Sq={Sq} must be a multiple of qg={qg}')
    if prev_lse.shape != (B, H, Sq) or prev_lse.device != q.device:
        raise ValueError(f'prev_lse {tuple(prev_lse.shape)} does not match q')
    if q.device.type == 'cpu':
        return dense_colsum_attn_plain(q, k, v, prev_lse, qg, score_block)
    q_hs, kv_hs = _kv_strides('dense_colsum_attn', q, k, v)
    if score_block not in SMALL_SCORE_BLOCKS and score_block % 64:
        raise ValueError('dense_colsum_attn kernel: score_block must be 1, '
                         '2, 4, 8, 16, 32 or a multiple of 64 (got '
                         f'{score_block})')
    prev_lse = prev_lse.float().contiguous()
    nb = -(-Sk // score_block)
    lib = _build.library('flash_attention')
    nb_max = lib.chipmunk_colsum_max_blocks(score_block)
    if nb > nb_max:
        raise ValueError(f'dense_colsum_attn kernel: Sk={Sk} gives {nb} score '
                         f'blocks of {score_block}; a query group\'s row of '
                         f'column sums fits shared memory for at most {nb_max} '
                         f'(Sk <= {nb_max * score_block})')
    o = torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    G, cpg = Sq // qg, -(-qg // 128)
    cs = torch.empty((B, H, G, nb), dtype=torch.float32, device=q.device)
    # a group of more than one 128-row CTA: each CTA's row, then their sum
    part = torch.empty((B, H, G * cpg, nb), dtype=torch.float32,
                       device=q.device) if cpg > 1 else None
    _build.check(lib.chipmunk_dense_colsum_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), prev_lse.data_ptr(),
        o.data_ptr(), lse.data_ptr(), cs.data_ptr(),
        None if part is None else part.data_ptr(), B * H, Sq, Sk, q_hs,
        kv_hs, qg, score_block, attn_scale(D), _stream(q)),
        'dense_colsum_attn')
    _build.LAUNCHES['dense_colsum_attn'] += 1
    return o, cs, lse


__all__ = ['dense_attn', 'dense_colsum_attn', 'dense_attn_plain',
           'dense_colsum_attn_plain', 'head_stride']
