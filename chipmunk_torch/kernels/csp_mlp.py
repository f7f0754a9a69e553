"""Sparse-delta MLP step: wrappers over ``csrc/csp_mlp.cu`` with their
plain PyTorch versions.

Counterpart of ``chipmunk_tpu/kernels/csp_mlp.py`` with bf16 weights.
The TPU's single fused kernel holds a [bm, Cout] f32 accumulator in VMEM
that no SM can hold, so on the card the step is two launches behind
``csp_mlp_fused``, split where the reference's unfused path splits:

  * ``csp_mlp_mm1``: gathered fc1 rows, + b1, tanh-GELU, rounded to the
    act cache's dtype, delta against the cache (packed bf16
    [T, jmax*bn]), cache refreshed in place;
  * ``csp_mlp_mm2``: ``out_cache += packed @ w2[selected rows]`` with f32
    accumulation, in place.

Numerics follow the kernel (``_fused_kernel``), not ``mlp_ref``: the act is
rounded to the cache dtype *before* the delta is taken.

Index contract: inds int [T/bm, jmax] neuron-block ids, unique within a
row; counts int [T/bm], clipped here to [1, jmax]; padded by repeating the
last valid id.  Caches are updated in place on every device and returned.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops import fp8
from . import _build
from .csp_attention import pad_block_indices
from .flash_attention import _stream


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=True), in its operation order."""
    c = 0.7978845608028654
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x)))))


def _rows(inds: torch.Tensor, bn: int) -> torch.Tensor:
    """[M, jmax] block ids -> [M, jmax*bn] neuron ids."""
    M = inds.shape[0]
    return (inds.long()[..., None] * bn
            + torch.arange(bn, device=inds.device)).reshape(M, -1)


def _valid(counts: torch.Tensor, jmax: int, bn: int) -> torch.Tensor:
    """[M, jmax*bn] bool: slot j < counts[m]."""
    return (torch.arange(jmax, device=counts.device) < counts[:, None]
            ).repeat_interleave(bn, -1)


def csp_mlp_mm1_plain(x, w1t, b1, act_cache, inds, counts, bn: int, bm: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of mm1.  Returns (packed [T, jmax*bn] in x.dtype,
    new act cache); the input cache is not modified."""
    T, C = x.shape
    N = w1t.shape[0]
    M, jmax = inds.shape
    rows = _rows(inds, bn)
    valid = _valid(counts, jmax, bn)
    mid = (x.reshape(M, bm, C).float() @ w1t[rows].float().transpose(1, 2)
           + b1[rows].float()[:, None, :])                   # [M, bm, J]
    act = fp8.cast(gelu_tanh(mid), act_cache.dtype)
    cache = fp8.raw(act_cache).reshape(M, bm, N)
    old = torch.gather(cache, 2, rows[:, None, :].expand(M, bm, -1))
    old = old.view(act_cache.dtype) if act_cache.dtype == fp8.FP8 else old
    delta = (act.float() - old.float()).to(x.dtype)
    packed = torch.where(valid[:, None, :], delta, torch.zeros_like(delta))
    mi, ci = valid.nonzero(as_tuple=True)
    new = cache.clone()
    new[mi, :, rows[mi, ci]] = fp8.raw(act)[mi, :, ci]
    new = new.reshape(T, N)
    if act_cache.dtype == fp8.FP8:
        new = new.view(fp8.FP8)
    return packed.reshape(T, jmax * bn), new


def csp_mlp_mm2_plain(packed, w2, out_cache, inds, counts, bn: int, bm: int
                      ) -> torch.Tensor:
    """Plain version of mm2: out_cache + packed @ w2[selected rows] in
    f32, rounded to the cache dtype.  Returns a new tensor."""
    T, C = out_cache.shape
    M, jmax = inds.shape
    valid = _valid(counts, jmax, bn)
    pk = packed.reshape(M, bm, -1).float()
    pk = torch.where(valid[:, None, :], pk, torch.zeros_like(pk))
    out = out_cache.float().reshape(M, bm, C) + pk @ w2[_rows(inds, bn)].float()
    return fp8.cast(out.reshape(T, C), out_cache.dtype)


def _prep(inds, counts, T: int, bm: int, device: torch.device):
    M, jmax = inds.shape
    if T % bm or M != T // bm or counts.shape != (M,):
        raise ValueError(f'inds {tuple(inds.shape)} / counts '
                         f'{tuple(counts.shape)} do not match T={T}, bm={bm}')
    if not (inds.device == counts.device == device):
        raise ValueError('inds/counts must be on the device of the '
                         'activations')
    counts = counts.clamp(1, jmax).to(torch.int32).contiguous()
    inds = pad_block_indices(inds, counts).to(torch.int32).contiguous()
    return inds, counts


def _check_cuda(name, x, w, b1, cache, bn, bm):
    for t in (x, w, cache) + ((b1,) if b1 is not None else ()):
        if t.device.type != 'cuda' or not t.is_contiguous():
            raise ValueError(f'{name}: tensors must be contiguous, on one '
                             'CUDA device or all on the CPU')
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or (
            b1 is not None and b1.dtype != torch.bfloat16):
        raise ValueError(f'{name}: the kernel takes bf16 activations and '
                         'weights')
    if cache.dtype != fp8.FP8:
        raise NotImplementedError(f'{name}: the kernel keeps fp8 e4m3 '
                                  f'caches, got {cache.dtype}')
    if bm % 128 or bn % 128 or x.shape[-1] % 128 or w.shape[-1] % 128:
        raise ValueError(f'{name}: bm, bn and C must be multiples of 128')


def csp_mlp_mm1(x, w1t, b1, act_cache, inds, counts, bn: int = 128,
                bm: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 1.  x [T,C]; w1t [N,C]; b1 [N]; act_cache [T,N] (updated in
    place).  Returns (packed delta [T, jmax*bn], act_cache)."""
    T, C = x.shape
    N = w1t.shape[0]
    if w1t.shape != (N, C) or b1.shape != (N,) or act_cache.shape != (T, N) \
            or N % bn:
        raise ValueError('csp_mlp_mm1: shapes do not match')
    inds, counts = _prep(inds, counts, T, bm, x.device)
    if x.device.type == 'cpu':
        packed, new = csp_mlp_mm1_plain(x, w1t, b1, act_cache, inds, counts,
                                        bn, bm)
        act_cache.copy_(new)
        return packed, act_cache
    _check_cuda('csp_mlp_mm1', x, w1t, b1, act_cache, bn, bm)
    jmax = inds.shape[1]
    packed = torch.empty((T, jmax * bn), dtype=x.dtype, device=x.device)
    lib = _build.library('csp_mlp')
    _build.check(lib.chipmunk_csp_mlp_mm1(
        x.data_ptr(), w1t.data_ptr(), b1.data_ptr(), act_cache.data_ptr(),
        inds.data_ptr(), counts.data_ptr(), packed.data_ptr(), T, C, N, jmax,
        bn, bm, _stream(x)), 'csp_mlp_mm1')
    _build.LAUNCHES['csp_mlp_mm1'] += 1
    return packed, act_cache


def csp_mlp_mm2(packed, w2, out_cache, inds, counts, bn: int = 128,
                bm: int = 128) -> torch.Tensor:
    """Stage 2: out_cache += packed @ w2[selected rows] (in place).
    packed [T, jmax*bn]; w2 [N, C]; out_cache [T, C]."""
    T, C = out_cache.shape
    if packed.shape != (T, inds.shape[1] * bn) or w2.shape[1] != C \
            or w2.shape[0] % bn:
        raise ValueError('csp_mlp_mm2: shapes do not match')
    inds, counts = _prep(inds, counts, T, bm, packed.device)
    if packed.device.type == 'cpu':
        return out_cache.copy_(csp_mlp_mm2_plain(packed, w2, out_cache, inds,
                                                 counts, bn, bm))
    _check_cuda('csp_mlp_mm2', packed, w2, None, out_cache, bn, bm)
    lib = _build.library('csp_mlp')
    _build.check(lib.chipmunk_csp_mlp_mm2(
        packed.data_ptr(), w2.data_ptr(), out_cache.data_ptr(),
        inds.data_ptr(), counts.data_ptr(), T, C, inds.shape[1], bn, bm,
        _stream(packed)), 'csp_mlp_mm2')
    _build.LAUNCHES['csp_mlp_mm2'] += 1
    return out_cache


def csp_mlp_fused(x, w1t, b1, w2, act_cache, out_cache, inds, counts,
                  bn: int = 128, bm: int = 128
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse MLP step (mm1 then mm2).  Updates both caches in place and
    returns (out_cache, act_cache)."""
    packed, act_cache = csp_mlp_mm1(x, w1t, b1, act_cache, inds, counts,
                                    bn=bn, bm=bm)
    out_cache = csp_mlp_mm2(packed, w2, out_cache, inds, counts, bn=bn, bm=bm)
    return out_cache, act_cache


def csp_mlp(x, w1t, b1, w2, act_cache, out_cache, inds, counts,
            bn: int = 128, bm: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full sparse MLP step (the module's entry); see csp_mlp_fused."""
    return csp_mlp_fused(x, w1t, b1, w2, act_cache, out_cache, inds, counts,
                         bn=bn, bm=bm)
