"""Sparse-delta MLP step: wrappers over ``csrc/csp_mlp.cu`` with their
plain PyTorch versions.

Counterpart of ``chipmunk_tpu/kernels/csp_mlp.py`` for bf16 weights, int8
or int4 ``QTensor`` weights (``wq``/``w4``) and int8 or int4 weights with
int8 activations (``a8``).  The TPU's single fused kernel holds a
[bm, Cout] f32 accumulator in VMEM that no SM can hold, so on the card
the step is two launches behind ``csp_mlp_fused``, split where the
reference's unfused path splits:

  * ``csp_mlp_mm1``: gathered fc1 rows, + b1, tanh-GELU, rounded to the
    act cache's dtype, delta against the cache (packed bf16
    [T, jmax*bn]), cache refreshed in place;
  * ``csp_mlp_mm2``: ``out_cache += packed @ w2[selected rows]`` with f32
    accumulation, in place.

With a QTensor these take the ``wq`` (int8) or ``w4`` (int4, plane-packed
along C: a byte holds column c in its low and c + C/2 in its high nibble)
kernels: mm1 folds the per-row scale in after the product, mm2 multiplies
the delta by the scale in bf16 before it (``_mm1_kernel``/``_mm2_kernel``
with ``wq``/``w4``).  With ``a8`` the step is three launches, in
``_fused_kernel``'s operation order:
``quant_rows`` (x -> int8 per row), ``csp_mlp_mm1_a8`` (int8 products, the
act, its delta times w2's scale quantized per (row, neuron block): d8 int8
[T, jmax*bn], sd f32 [T, jmax]) and ``csp_mlp_mm2_a8`` (int8 products
flushed per block with sd into the f32 out cache).

Numerics follow the kernel (``_fused_kernel``), not ``mlp_ref``: the act is
rounded to the cache dtype *before* the delta is taken.  The plain
versions compute integer products exactly (in float64, where every sum
of int8 products is exact) and take every scalar step in the reference's
order, with one rounding for each multiply-add that XLA fuses.

Index contract: inds int [T/bm, jmax] neuron-block ids, unique within a
row; counts int [T/bm], clipped to [1, jmax] (here for the plain
versions, which then pad by repeating the last valid id; inside the
kernels, which read no id past the count).  Caches are updated in place
on every device and returned.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops import fp8
from ..utils.quant import QTensor
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


def _scale(w: QTensor) -> torch.Tensor:
    """Per-row (per-neuron) float32 scale of an [N, C] QTensor, [N]."""
    return w.scale.reshape(-1).float()


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of float32 operands rounded once to float32, as XLA fuses
    the reference's multiply-adds (float64 holds the product exactly)."""
    return (a.double() * b.double() + c.double()).float()


def _int4(w) -> bool:
    return isinstance(w, QTensor) and w.pack_axis is not None


def _codes(w: QTensor) -> torch.Tensor:
    """The int8 codes [N, C] of an int8 or int4 QTensor (int4: the two
    nibble planes widened to [-8, 7] and put side by side along C)."""
    if not _int4(w):
        return w.q
    return torch.cat([(w.q & 0xF).to(torch.int8) - 8,
                      (w.q >> 4).to(torch.int8) - 8], dim=-1)


def _imm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product of int8 operands, as float32: the sums run in
    float64, where every partial sum of int8 products is exact, and round
    once to float32 (as int32 -> float32 does)."""
    return (a.double() @ b.double()).float()


def _gather_cache(act_cache, rows, M, bm):
    """([M, bm, N] raw cache, [M, bm, J] old values at rows)."""
    N = act_cache.shape[1]
    cache = fp8.raw(act_cache).reshape(M, bm, N)
    old = torch.gather(cache, 2, rows[:, None, :].expand(M, bm, -1))
    return cache, (old.view(act_cache.dtype) if act_cache.dtype == fp8.FP8
                   else old)


def _refresh(cache, act, rows, valid, act_cache):
    """The cache with act written at the valid selected slots."""
    T, N = act_cache.shape
    mi, ci = valid.nonzero(as_tuple=True)
    new = cache.clone()
    new[mi, :, rows[mi, ci]] = fp8.raw(act)[mi, :, ci]
    new = new.reshape(T, N)
    return new.view(fp8.FP8) if act_cache.dtype == fp8.FP8 else new


def _prescale(packed, w2: QTensor, inds, bn: int) -> torch.Tensor:
    """packed * bf16(w2's row scale) at each slot's neuron, in the packed
    dtype: the reference's multiply of the wq mm2 (_mm2_kernel)."""
    T, M = packed.shape[0], inds.shape[0]
    s = _scale(w2)[_rows(inds, bn)].to(packed.dtype)        # [M, jmax*bn]
    return (packed.reshape(M, T // M, -1) * s[:, None, :]).reshape(T, -1)


def csp_mlp_mm1_plain(x, w1t, b1, act_cache, inds, counts, bn: int, bm: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of mm1 (bf16, int8 or int4 QTensor w1t).  Returns (packed
    [T, jmax*bn] in x.dtype, new act cache); the input cache is not
    modified."""
    T, C = x.shape
    M, jmax = inds.shape
    rows = _rows(inds, bn)
    valid = _valid(counts, jmax, bn)
    wq = isinstance(w1t, QTensor)
    w = (_codes(w1t) if wq else w1t)[rows].float()
    mid = x.reshape(M, bm, C).float() @ w.transpose(1, 2)   # [M, bm, J]
    bias = b1[rows].float()[:, None, :]
    mid = (_fma(mid, _scale(w1t)[rows][:, None, :], bias) if wq
           else mid + bias)
    act = fp8.cast(gelu_tanh(mid), act_cache.dtype)
    cache, old = _gather_cache(act_cache, rows, M, bm)
    delta = (act.float() - old.float()).to(x.dtype)
    packed = torch.where(valid[:, None, :], delta, torch.zeros_like(delta))
    return (packed.reshape(T, jmax * bn),
            _refresh(cache, act, rows, valid, act_cache))


def csp_mlp_mm2_plain(packed, w2, out_cache, inds, counts, bn: int, bm: int
                      ) -> torch.Tensor:
    """Plain version of mm2: out_cache + packed @ w2[selected rows] in
    f32, rounded to the cache dtype; a QTensor w2's scale multiplies the
    packed delta in its dtype first.  Returns a new tensor."""
    T, C = out_cache.shape
    M, jmax = inds.shape
    rows = _rows(inds, bn)
    valid = _valid(counts, jmax, bn)
    wq = isinstance(w2, QTensor)
    pk = (_prescale(packed, w2, inds, bn) if wq else packed).reshape(
        M, bm, -1).float()
    pk = torch.where(valid[:, None, :], pk, torch.zeros_like(pk))
    w = (_codes(w2) if wq else w2)[rows].float()
    out = out_cache.float().reshape(M, bm, C) + pk @ w
    return fp8.cast(out.reshape(T, C), out_cache.dtype)


def quant_rows_plain(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, C] -> (x8 int8 [T, C], sx float32 [T]):
    sx = max(max_c |x|, 1e-6) / 127, x8 = clip(round(x / sx), +-127)."""
    xf = x.float()
    sx = xf.abs().amax(1).clamp(min=1e-6) * (1.0 / 127.0)
    x8 = torch.round(xf / sx[:, None]).clamp(-127, 127).to(torch.int8)
    return x8, sx


def csp_mlp_mm1_a8_plain(x8, sx, w1t: QTensor, b1, w2s, act_cache, inds,
                         counts, bn: int, bm: int):
    """Plain version of the a8 mm1.  Returns (d8 int8 [T, jmax*bn],
    sd float32 [T, jmax], new act cache), zeros at invalid slots."""
    T, C = x8.shape
    M, jmax = inds.shape
    rows = _rows(inds, bn)
    valid = _valid(counts, jmax, bn)
    prod = _imm(x8.reshape(M, bm, C), _codes(w1t)[rows].transpose(1, 2))
    mid = _fma(prod, sx.reshape(M, bm, 1) * _scale(w1t)[rows][:, None, :],
               b1[rows].float()[:, None, :])
    act = fp8.cast(gelu_tanh(mid), act_cache.dtype)
    cache, old = _gather_cache(act_cache, rows, M, bm)
    ds = ((act.float() - old.float())
          * w2s.reshape(-1).float()[rows][:, None, :]).reshape(M, bm, jmax,
                                                                bn)
    sd = ds.abs().amax(-1).clamp(min=1e-12) * (1.0 / 127.0)
    d8 = torch.round(ds / sd[..., None]).clamp(-127, 127).to(torch.int8)
    vj = (torch.arange(jmax, device=counts.device) < counts[:, None]
          )[:, None, :]                                    # [M, 1, jmax]
    d8 = torch.where(vj[..., None], d8, torch.zeros_like(d8))
    sd = torch.where(vj, sd, torch.zeros_like(sd))
    return (d8.reshape(T, jmax * bn), sd.reshape(T, jmax),
            _refresh(cache, act, rows, valid, act_cache))


def csp_mlp_mm2_a8_plain(d8, sd, w2: QTensor, out_cache, inds, counts,
                         bn: int, bm: int) -> torch.Tensor:
    """Plain version of the a8 mm2: acc = f32(out_cache), then for each
    valid block j in order acc = fma(f32(d8_j . w2q[block j]), sd_j, acc);
    rounded to the cache dtype.  Returns a new tensor."""
    T, C = out_cache.shape
    M, jmax = inds.shape
    acc = out_cache.float().reshape(M, bm, C)
    d = d8.reshape(M, bm, jmax, bn)
    s = sd.reshape(M, bm, jmax)
    ar = torch.arange(bn, device=inds.device)
    codes = _codes(w2)
    for j in range(jmax):
        w = codes[inds[:, j].long()[:, None] * bn + ar]      # [M, bn, C]
        upd = _fma(_imm(d[:, :, j], w), s[:, :, j, None], acc)
        acc = torch.where((j < counts)[:, None, None], upd, acc)
    return fp8.cast(acc.reshape(T, C), out_cache.dtype)


# ------------------------------------------------------------ wrappers

def _prep(inds, counts, T: int, bm: int, device: torch.device):
    M, jmax = inds.shape
    if T % bm or M != T // bm or counts.shape != (M,):
        raise ValueError(f'inds {tuple(inds.shape)} / counts '
                         f'{tuple(counts.shape)} do not match T={T}, bm={bm}')
    if not (inds.device == counts.device == device):
        raise ValueError('inds/counts must be on the device of the '
                         'activations')
    if device.type == 'cuda':
        # the kernels clip the counts and read no index past them
        return (inds.to(torch.int32).contiguous(),
                counts.to(torch.int32).contiguous())
    counts = counts.clamp(1, jmax).to(torch.int32).contiguous()
    inds = pad_block_indices(inds, counts).to(torch.int32).contiguous()
    return inds, counts


def _check_kernel_weight(w, name: str) -> None:
    """The reference refuses fp8 QTensor weights in these kernels
    (``_check_kernel_weight``); the others are int8, or int4 packed along
    C (pack_axis -1)."""
    if not isinstance(w, QTensor):
        return
    if w.q.dtype == fp8.FP8:
        raise ValueError(f'{name}: fp8 QTensor weights are rejected by the '
                         'sparse MLP kernels; store int8 instead (same '
                         'bytes)')
    ok = (w.q.dtype == torch.uint8 and w.pack_axis in (-1, 1)) if _int4(w) \
        else w.q.dtype == torch.int8
    if not ok:
        raise ValueError(f'{name}: QTensor weights must be int8 or int4 '
                         f'packed along C, got {w.q.dtype}, pack_axis '
                         f'{w.pack_axis}')


def _wshape(w):
    """(N, C) of a weight as the model sees it (int4: C = 2 x bytes)."""
    if not isinstance(w, QTensor):
        return tuple(w.shape)
    return (w.q.shape[0], w.q.shape[1] * (2 if _int4(w) else 1))


def _on_cuda(name, *tensors):
    for t in tensors:
        if t.device.type != 'cuda' or not t.is_contiguous():
            raise ValueError(f'{name}: tensors must be contiguous, on one '
                             'CUDA device or all on the CPU')


def _check_dtypes(name, cache, *pairs) -> int:
    """Check the operands' dtypes; returns 1 for a bf16 cache, 0 for fp8
    e4m3 (the kernels' cache flag)."""
    for t, dt in pairs:
        if t.dtype != dt:
            raise ValueError(f'{name}: the kernel takes {dt}, got {t.dtype}')
    if cache.dtype not in (fp8.FP8, torch.bfloat16):
        raise ValueError(f'{name}: the kernel keeps fp8 e4m3 or bf16 '
                         f'caches, got {cache.dtype}')
    return int(cache.dtype == torch.bfloat16)


def _check_tiles(name, C, bn, bm, a8: bool, w4: bool):
    if a8:
        bm_unit = 64 if w4 else 128
        if bn % 128 or bm % bm_unit or C % 128:
            raise ValueError(f'{name}: the a8 kernels take bn a multiple of '
                             f'128, bm of {bm_unit} and C of 128')
    elif bm % 128 or bn % 128 or C % 128:
        raise ValueError(f'{name}: bm, bn and C must be multiples of 128')
    if w4 and C % 256:
        raise ValueError(f'{name}: int4 weights need C a multiple of 256 '
                         '(a 128-column tile inside one nibble plane)')


def _flat_scale(w: QTensor) -> torch.Tensor:
    return w.scale.reshape(-1).float().contiguous()


def kmajor_codes(w: QTensor) -> torch.Tensor:
    """The int8 codes [N, C] of an unpacked QTensor as a contiguous
    [C, N] copy: the B operand of the card's a8 fc2 kernel, which s8 wgmma
    reads K-major only.  Made by the first call for a weight and kept on
    the weight, so each weight is transposed once and holds N x C more
    bytes while it lives (the codes are not expected to change in place)."""
    t = w.__dict__.get('_kmajor')
    if t is None or t.device != w.q.device:
        t = w.q.t().contiguous()
        object.__setattr__(w, '_kmajor', t)
    return t


def csp_mlp_mm1(x, w1t, b1, act_cache, inds, counts, bn: int = 128,
                bm: int = 128, w2=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 1.  x [T,C]; w1t [N,C] (bf16, or an int8/int4 QTensor: the
    ``wq``/``w4`` kernel); b1 [N]; act_cache [T,N] (updated in place).
    Returns (packed delta [T, jmax*bn], act_cache).  With int8 weights and
    ``w2`` (their fc2 QTensor) the packed delta comes out multiplied by
    bf16 of w2's row scales, as ``csp_mlp_mm2(..., prescaled=True)`` takes
    it (csp_mlp_fused's route: the card's mm1 epilogue makes the multiply
    that its mm2 would make in place)."""
    _check_kernel_weight(w1t, 'csp_mlp_mm1')
    wq, w4 = isinstance(w1t, QTensor), _int4(w1t)
    T, C = x.shape
    w = w1t.q if wq else w1t
    N = w.shape[0]
    if _wshape(w1t) != (N, C) or b1.shape != (N,) \
            or act_cache.shape != (T, N) or N % bn:
        raise ValueError('csp_mlp_mm1: shapes do not match')
    if w2 is not None and (not wq or w4 or not isinstance(w2, QTensor)
                           or _int4(w2) or w2.q.shape[0] != N):
        raise ValueError('csp_mlp_mm1: w2 scales the delta of the int8 '
                         'pair only')
    inds, counts = _prep(inds, counts, T, bm, x.device)
    if x.device.type == 'cpu':
        packed, new = csp_mlp_mm1_plain(x, w1t, b1, act_cache, inds, counts,
                                        bn, bm)
        act_cache.copy_(new)
        if w2 is not None:
            packed = _prescale(packed, w2, inds, bn)
        return packed, act_cache
    name = ('csp_mlp_mm1_w4' if w4 else 'csp_mlp_mm1_wq' if wq
            else 'csp_mlp_mm1')
    _on_cuda(name, x, w, b1, act_cache)
    bf = _check_dtypes(name, act_cache, (x, torch.bfloat16),
                       (b1, torch.bfloat16),
                       *([] if wq else [(w, torch.bfloat16)]))
    _check_tiles(name, C, bn, bm, False, w4)
    jmax = inds.shape[1]
    packed = torch.empty((T, jmax * bn), dtype=x.dtype, device=x.device)
    lib = _build.library('csp_mlp')
    if wq:
        w2s = None if w2 is None else _flat_scale(w2)
        err = lib.chipmunk_csp_mlp_mm1_wq(
            x.data_ptr(), w.data_ptr(), _flat_scale(w1t).data_ptr(),
            b1.data_ptr(), act_cache.data_ptr(), inds.data_ptr(),
            counts.data_ptr(), packed.data_ptr(),
            None if w2s is None else w2s.data_ptr(), T, C, N, jmax, bn, bm,
            int(w4), bf, _stream(x))
    else:
        err = lib.chipmunk_csp_mlp_mm1(
            x.data_ptr(), w.data_ptr(), b1.data_ptr(), act_cache.data_ptr(),
            inds.data_ptr(), counts.data_ptr(), packed.data_ptr(), T, C, N,
            jmax, bn, bm, bf, _stream(x))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return packed, act_cache


def csp_mlp_mm2(packed, w2, out_cache, inds, counts, bn: int = 128,
                bm: int = 128, prescaled: bool = False) -> torch.Tensor:
    """Stage 2: out_cache += packed @ w2[selected rows] (in place).
    packed [T, jmax*bn]; w2 [N, C] (bf16, or an int8/int4 QTensor: the
    ``wq``/``w4`` kernel); out_cache [T, C].  ``prescaled`` (int8
    weights): the packed delta is already multiplied by bf16 of w2's row
    scales (``csp_mlp_mm1(..., w2=w2)``)."""
    _check_kernel_weight(w2, 'csp_mlp_mm2')
    wq, w4 = isinstance(w2, QTensor), _int4(w2)
    w = w2.q if wq else w2
    T, C = out_cache.shape
    if packed.shape != (T, inds.shape[1] * bn) or _wshape(w2)[1] != C \
            or w.shape[0] % bn:
        raise ValueError('csp_mlp_mm2: shapes do not match')
    if prescaled and (not wq or w4):
        raise ValueError('csp_mlp_mm2: prescaled takes int8 weights only')
    inds, counts = _prep(inds, counts, T, bm, packed.device)
    if packed.device.type == 'cpu':
        if prescaled:          # the codes with unit scales
            w2 = QTensor(w2.q, torch.ones_like(w2.scale))
        return out_cache.copy_(csp_mlp_mm2_plain(packed, w2, out_cache, inds,
                                                 counts, bn, bm))
    name = ('csp_mlp_mm2_w4' if w4 else 'csp_mlp_mm2_wq' if wq
            else 'csp_mlp_mm2')
    _on_cuda(name, packed, w, out_cache)
    bf = _check_dtypes(name, out_cache, (packed, torch.bfloat16),
                       *([] if wq else [(w, torch.bfloat16)]))
    _check_tiles(name, C, bn, bm, False, w4)
    lib = _build.library('csp_mlp')
    jmax = inds.shape[1]
    if wq:
        err = lib.chipmunk_csp_mlp_mm2_wq(
            packed.data_ptr(), w.data_ptr(), _flat_scale(w2).data_ptr(),
            out_cache.data_ptr(), inds.data_ptr(), counts.data_ptr(), T, C,
            w.shape[0], jmax, bn, bm, int(w4), int(prescaled), bf,
            _stream(packed))
    else:
        err = lib.chipmunk_csp_mlp_mm2(
            packed.data_ptr(), w.data_ptr(), out_cache.data_ptr(),
            inds.data_ptr(), counts.data_ptr(), T, C, w.shape[0], jmax, bn,
            bm, bf, _stream(packed))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out_cache


def quant_rows(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, C] -> (x8 int8 [T, C], sx float32 [T]), see quant_rows_plain
    (the ``j == 0`` block of ``_fused_kernel`` with ``a8``)."""
    if x.device.type == 'cpu':
        return quant_rows_plain(x)
    _on_cuda('quant_rows', x)
    if x.dtype != torch.bfloat16 or x.shape[1] % 2:
        raise ValueError('quant_rows: the kernel takes bf16 [T, C], C even')
    T, C = x.shape
    x8 = torch.empty((T, C), dtype=torch.int8, device=x.device)
    sx = torch.empty((T,), dtype=torch.float32, device=x.device)
    _build.check(_build.library('csp_mlp').chipmunk_quant_rows(
        x.data_ptr(), x8.data_ptr(), sx.data_ptr(), T, C, _stream(x)),
        'quant_rows')
    _build.LAUNCHES['quant_rows'] += 1
    return x8, sx


def csp_mlp_mm1_a8(x8, sx, w1t: QTensor, b1, w2s, act_cache, inds, counts,
                   bn: int = 128, bm: int = 128):
    """a8 stage 1.  x8 int8 [T, C] and sx [T] from quant_rows; w1t int8 or
    int4 QTensor [N, C]; b1 [N]; w2s: w2's per-row scale (N values);
    act_cache [T, N] (updated in place).  Returns (d8 int8 [T, jmax*bn],
    sd float32 [T, jmax], act_cache)."""
    _check_kernel_weight(w1t, 'csp_mlp_mm1_a8')
    T, C = x8.shape
    N, w4 = w1t.q.shape[0], _int4(w1t)
    if _wshape(w1t) != (N, C) or b1.shape != (N,) or w2s.numel() != N \
            or sx.shape != (T,) or act_cache.shape != (T, N) or N % bn:
        raise ValueError('csp_mlp_mm1_a8: shapes do not match')
    inds, counts = _prep(inds, counts, T, bm, x8.device)
    if x8.device.type == 'cpu':
        d8, sd, new = csp_mlp_mm1_a8_plain(x8, sx, w1t, b1, w2s, act_cache,
                                           inds, counts, bn, bm)
        act_cache.copy_(new)
        return d8, sd, act_cache
    name = 'csp_mlp_mm1_a8w4' if w4 else 'csp_mlp_mm1_a8'
    w1s, w2s = _flat_scale(w1t), w2s.reshape(-1).float().contiguous()
    _on_cuda(name, x8, sx, w1t.q, b1, act_cache)
    bf = _check_dtypes(name, act_cache, (x8, torch.int8),
                       (sx, torch.float32), (b1, torch.bfloat16))
    _check_tiles(name, C, bn, bm, True, w4)
    jmax = inds.shape[1]
    d8 = torch.empty((T, jmax * bn), dtype=torch.int8, device=x8.device)
    sd = torch.empty((T, jmax), dtype=torch.float32, device=x8.device)
    # bn > 256: the kernel runs per sub-block of 256 (or 128) neurons into
    # the scratch ds and the sub-blocks' row maxima, then forms d8 and sd
    ds = pmax = None
    if bn > 256:
        ds = torch.empty((T, jmax * bn), dtype=torch.float32,
                         device=x8.device)
        pmax = torch.empty((T, jmax * bn // 128), dtype=torch.float32,
                           device=x8.device)
    _build.check(_build.library('csp_mlp').chipmunk_csp_mlp_mm1_a8(
        x8.data_ptr(), sx.data_ptr(), w1t.q.data_ptr(), w1s.data_ptr(),
        b1.data_ptr(), w2s.data_ptr(), act_cache.data_ptr(), inds.data_ptr(),
        counts.data_ptr(), d8.data_ptr(), sd.data_ptr(),
        None if ds is None else ds.data_ptr(),
        None if pmax is None else pmax.data_ptr(), T, C, N, jmax, bn, bm,
        int(w4), bf, _stream(x8)), name)
    _build.LAUNCHES[name] += 1
    return d8, sd, act_cache


def csp_mlp_mm2_a8(d8, sd, w2: QTensor, out_cache, inds, counts,
                   bn: int = 128, bm: int = 128) -> torch.Tensor:
    """a8 stage 2: out_cache += per block, d8_j . w2q[block j] * sd_j
    (in place).  d8 [T, jmax*bn] int8; sd [T, jmax]; w2 int8 or int4
    QTensor [N, C]; out_cache [T, C]."""
    _check_kernel_weight(w2, 'csp_mlp_mm2_a8')
    T, C = out_cache.shape
    jmax, w4 = inds.shape[1], _int4(w2)
    if d8.shape != (T, jmax * bn) or sd.shape != (T, jmax) \
            or _wshape(w2)[1] != C or w2.q.shape[0] % bn:
        raise ValueError('csp_mlp_mm2_a8: shapes do not match')
    inds, counts = _prep(inds, counts, T, bm, d8.device)
    if d8.device.type == 'cpu':
        return out_cache.copy_(csp_mlp_mm2_a8_plain(d8, sd, w2, out_cache,
                                                    inds, counts, bn, bm))
    name = 'csp_mlp_mm2_a8w4' if w4 else 'csp_mlp_mm2_a8'
    _on_cuda(name, d8, sd, w2.q, out_cache)
    bf = _check_dtypes(name, out_cache, (d8, torch.int8),
                       (sd, torch.float32))
    _check_tiles(name, C, bn, bm, True, w4)
    w = w2.q if w4 else kmajor_codes(w2)
    _build.check(_build.library('csp_mlp').chipmunk_csp_mlp_mm2_a8(
        d8.data_ptr(), sd.data_ptr(), w.data_ptr(), out_cache.data_ptr(),
        inds.data_ptr(), counts.data_ptr(), T, C, w2.q.shape[0], jmax, bn,
        bm, int(w4), bf, _stream(d8)), name)
    _build.LAUNCHES[name] += 1
    return out_cache


def csp_mlp_fused(x, w1t, b1, w2, act_cache, out_cache, inds, counts,
                  bn: int = 128, bm: int = 128, a8: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse MLP step.  Updates both caches in place and returns
    (out_cache, act_cache).  w1t/w2 may be int8 or int4 QTensors (both or
    neither, both int4 or neither); ``a8`` runs the int8-activation path
    and needs them."""
    _check_kernel_weight(w1t, 'csp_mlp_fused')
    _check_kernel_weight(w2, 'csp_mlp_fused')
    wq = isinstance(w1t, QTensor)
    if wq != isinstance(w2, QTensor):
        raise ValueError('csp_mlp_fused: quantize both weights or neither')
    if _int4(w1t) != _int4(w2):
        raise ValueError('csp_mlp_fused: int4-pack both weights or neither')
    if a8:
        if not wq:
            raise ValueError('csp_mlp_fused: a8 needs int8 or int4-packed '
                             f'weights (got {type(w1t).__name__})')
        x8, sx = quant_rows(x)
        d8, sd, act_cache = csp_mlp_mm1_a8(x8, sx, w1t, b1, w2.scale,
                                           act_cache, inds, counts, bn=bn,
                                           bm=bm)
        out_cache = csp_mlp_mm2_a8(d8, sd, w2, out_cache, inds, counts,
                                   bn=bn, bm=bm)
        return out_cache, act_cache
    # int8 weights: mm1 scales the delta for mm2 (the same multiply)
    pre = wq and not _int4(w1t)
    packed, act_cache = csp_mlp_mm1(x, w1t, b1, act_cache, inds, counts,
                                    bn=bn, bm=bm, w2=w2 if pre else None)
    out_cache = csp_mlp_mm2(packed, w2, out_cache, inds, counts, bn=bn, bm=bm,
                            prescaled=pre)
    return out_cache, act_cache


def csp_mlp(x, w1t, b1, w2, act_cache, out_cache, inds, counts,
            bn: int = 128, bm: int = 128, a8: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full sparse MLP step (the module's entry); see csp_mlp_fused."""
    return csp_mlp_fused(x, w1t, b1, w2, act_cache, out_cache, inds, counts,
                         bn=bn, bm=bm, a8=a8)
