"""Quantized weight residency (torch), the port's own copy of
``chipmunk_tpu/utils/quant.py``: fp8 / int8 / int4 storage with
per-channel scales and dequantize-at-use.

Formats (byte for byte the reference's, so weights carry over unchanged):
  * fp8:  q float8_e4m3fn, original shape.
  * int8: q int8, original shape, values in [-127, 127].
  * int4: q uint8 **plane-packed along ``pack_axis``**: position r holds
    the low nibble of original position r and the high nibble of position
    r + n//2 along that axis; stored offset-binary (+8).

Scales are per-output-channel absmax, float32, shaped to broadcast
against the ORIGINAL (unpacked) array.  ``pack_axis`` is negative (or
None), as in the reference, so it survives splitting a stacked [L, ...]
tensor into layers.

Every fp8 rounding goes through ``ops/fp8.py`` (the reference's NaN
overflow rule, not torch's saturation).  The synthetic-weight functions
draw from ``np.random.default_rng(seed)`` in the order in which the
reference flattens its param tree (sorted dict keys over stacked [L, ...]
shapes), so the same seed gives the same bytes on both sides.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops import fp8

F8_MAX = 448.0


@dataclasses.dataclass(frozen=True)
class QTensor:
    """Quantized tensor + broadcastable float32 scale; ``pack_axis`` is
    the (negative) int4 plane-packing axis, None if unpacked."""
    q: torch.Tensor
    scale: torch.Tensor
    pack_axis: Optional[int] = None

    def to(self, device) -> "QTensor":
        return QTensor(self.q.to(device), self.scale.to(device),
                       self.pack_axis)


def _keep(keep_axes, ndim: int):
    if isinstance(keep_axes, int):
        keep_axes = (keep_axes,)
    return tuple(a % ndim for a in keep_axes)


def _int4_pack(qi, pack_axis: int, ndim: int):
    """int values in [0, 16) -> (uint8 planes, negative pack axis)."""
    ax = pack_axis % ndim
    half = qi.shape[ax] // 2
    if isinstance(qi, np.ndarray):
        lo, hi = np.split(qi, 2, axis=ax)
        return (lo | (hi << 4)).astype(np.uint8), ax - ndim
    lo, hi = qi.narrow(ax, 0, half), qi.narrow(ax, half, half)
    return (lo | (hi << 4)).to(torch.uint8), ax - ndim


def _check_int4(shape, keep, pack_axis):
    if pack_axis is None or pack_axis % len(shape) in keep:
        raise ValueError('int4 needs a pack_axis outside keep_axes')
    if shape[pack_axis] % 2:
        raise ValueError(f'int4 pack axis of {tuple(shape)} must be even')


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded as IEEE division on every device: CUDA divides by a
    Python scalar as a product with its reciprocal, which can land one
    ulp away from the reference's quotient."""
    return x / x.new_tensor(c)


def quantize(w: torch.Tensor, kind: str, keep_axes,
             pack_axis: Optional[int] = None) -> QTensor:
    """kind: 'fp8' | 'int8' | 'int4'.  keep_axes: the axes the scale
    varies over (output channel, plus the stack axis of stacked params).
    int4 requires ``pack_axis`` (even length, not in keep_axes)."""
    keep = _keep(keep_axes, w.ndim)
    wf = w.float()
    red = tuple(i for i in range(w.ndim) if i not in keep)
    amax = wf.abs().amax(dim=red, keepdim=True).clamp(min=1e-8)
    if kind == 'fp8':
        scale = true_div(amax, F8_MAX)
        return QTensor(fp8.to_fp8(wf / scale), scale, None)
    if kind == 'int8':
        scale = true_div(amax, 127.0)
        q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
        return QTensor(q, scale, None)
    if kind == 'int4':
        _check_int4(w.shape, keep, pack_axis)
        scale = true_div(amax, 7.0)
        qi = torch.round(wf / scale).clamp(-8, 7).to(torch.int32) + 8
        q, pa = _int4_pack(qi, pack_axis, w.ndim)
        return QTensor(q, scale, pa)
    raise ValueError(kind)


def dequant(w: Union[torch.Tensor, QTensor, Any],
            dtype: torch.dtype = torch.bfloat16):
    """QTensor -> dense tensor in ``dtype``, the scale applied in
    ``dtype`` as the reference does; plain tensors pass through."""
    if not isinstance(w, QTensor):
        return w
    q = w.q
    if w.pack_axis is not None:             # int4 plane-packed
        lo = (q & 0xF).to(torch.int8) - 8
        hi = (q >> 4).to(torch.int8) - 8
        q = torch.cat([lo, hi], dim=w.pack_axis)
    return q.to(dtype) * w.scale.to(dtype)


def materialize(w, dtype: torch.dtype) -> torch.Tensor:
    """A weight as a dense tensor in ``dtype``: QTensors dequantized,
    plain tensors cast (torch, unlike jnp, does not promote in ``@``)."""
    return dequant(w, dtype).to(dtype)


def is_quantized(w: Any) -> bool:
    return isinstance(w, QTensor)


# --------------------------------------------------------------- model spec

class QuantSpec(NamedTuple):
    """Per-category storage for quantize_flux_params; None keeps the
    weight as it is.

    attn:       qkv / proj / o_proj linears
    mod:        adaLN modulation linears
    mlp_sparse: weights read by the sparse MLP kernels
    mlp_dense:  dense-path MLP weights (the double blocks' text MLP)
    """
    attn: Optional[str] = 'fp8'
    mod: Optional[str] = 'fp8'
    mlp_sparse: Optional[str] = 'fp8'
    mlp_dense: Optional[str] = 'fp8'


def quantize_flux_params(params: Dict, spec: QuantSpec = QuantSpec()) -> Dict:
    """Quantize the port's FLUX params (``double``/``single`` as per-layer
    lists); returns a new tree.  Embedders, norms, biases and the final
    layer stay as they are.  Per layer this gives the bytes the reference
    gives for its stacked tree."""
    for kind in spec:
        if kind not in (None, 'fp8', 'int8', 'int4'):
            raise ValueError(f'unknown quantization {kind!r}')

    def qlin(p, kind):                  # {'w': [in, out], 'b': ...}
        if kind is None:
            return p
        w = p['w']
        return dict(p, w=quantize(w, kind, keep_axes=(w.ndim - 1,),
                                  pack_axis=(w.ndim - 2 if kind == 'int4'
                                             else None)))

    def qraw(w, kind):                  # [N, C] output-major
        if kind is None:
            return w
        return quantize(w, kind, keep_axes=(0,),
                        pack_axis=w.ndim - 1 if kind == 'int4' else None)

    def dbl(layer):
        d = dict(layer)
        for k in ('img_qkv', 'txt_qkv', 'img_proj', 'txt_proj'):
            d[k] = qlin(d[k], spec.attn)
        for k in ('img_mod', 'txt_mod'):
            d[k] = qlin(d[k], spec.mod)
        for k in ('img_w1t', 'img_w2'):
            d[k] = qraw(d[k], spec.mlp_sparse)
        for k in ('txt_w1t', 'txt_w2'):
            d[k] = qraw(d[k], spec.mlp_dense)
        return d

    def sgl(layer):
        s = dict(layer)
        for k in ('qkv', 'o_proj'):
            s[k] = qlin(s[k], spec.attn)
        s['mod'] = qlin(s['mod'], spec.mod)
        for k in ('w1t', 'w2'):
            s[k] = qraw(s[k], spec.mlp_sparse)
        return s

    return dict(params, double=[dbl(p) for p in params['double']],
                single=[sgl(p) for p in params['single']])


def param_bytes(tree) -> int:
    """Bytes of every tensor in a param tree (QTensor: q and scale)."""
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(param_bytes(v) for v in tree)
    if isinstance(tree, QTensor):
        return param_bytes(tree.q) + param_bytes(tree.scale)
    return tree.numel() * tree.element_size()


# ------------------------------------------------- host-side quantization

def quantize_host(w, kind: str, keep_axes,
                  pack_axis: Optional[int] = None) -> QTensor:
    """numpy-side quantize (the same formats as :func:`quantize`) for
    weights that arrive on the host; returns CPU tensors.  A [rows, cols]
    weight with per-row scales (int4 packed along the columns) goes
    through the host library's multi-threaded quantizers
    (``utils/native.py``), bit-equal to the numpy path below, where the
    fp8 rounding goes through ``ops/fp8.py``."""
    wf = np.asarray(w, np.float32)
    keep = _keep(keep_axes, wf.ndim)
    if (wf.ndim == 2 and keep == (0,) and kind in ('fp8', 'int8', 'int4')
            and (kind != 'int4' or pack_axis in (1, -1))):
        from .native import quantize_rows_native
        q, scale = quantize_rows_native(wf, kind)
        q = torch.from_numpy(q)
        return QTensor(q.view(fp8.FP8) if kind == 'fp8' else q,
                       torch.from_numpy(scale[:, None]),
                       -1 if kind == 'int4' else None)
    red = tuple(i for i in range(wf.ndim) if i not in keep)
    amax = np.maximum(np.abs(wf).max(axis=red, keepdims=True), 1e-8)
    pa = None
    if kind == 'fp8':
        scale = amax / F8_MAX
        q = fp8.to_fp8(torch.from_numpy(wf / scale))
    elif kind == 'int8':
        scale = amax / 127.0
        q = torch.from_numpy(
            np.clip(np.round(wf / scale), -127, 127).astype(np.int8))
    elif kind == 'int4':
        _check_int4(wf.shape, keep, pack_axis)
        scale = amax / 7.0
        qi = np.clip(np.round(wf / scale), -8, 7).astype(np.int32) + 8
        q, pa = _int4_pack(qi, pack_axis, wf.ndim)
        q = torch.from_numpy(q)
    else:
        raise ValueError(kind)
    return QTensor(q, torch.from_numpy(scale.astype(np.float32)), pa)


def synth_quantized_params(seed: int, shapes: Dict,
                           spec: QuantSpec = QuantSpec(
                               attn='int4', mod='int4',
                               mlp_sparse='int8', mlp_dense='int4'),
                           dtype: torch.dtype = torch.bfloat16,
                           device: DeviceLike = 'cuda') -> Dict:
    """Random quantized params drawn directly in their stored formats
    (random bytes; scales set to fan-in-normalised constants), never
    materialising the model in ``dtype``.

    ``shapes`` is the reference's tree of stacked shapes (tuples): nested
    dicts, with ``double``/``single`` leaves of shape [L, ...].  Leaves are
    drawn in sorted-key order, as the reference's tree flattening visits
    them, then ``double``/``single`` are split into per-layer lists (the
    port's layout) and every tensor is moved to ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def scale_of(shape, fan_in, div, scale_axes):
        ss = [1] * len(shape)
        for a in scale_axes:
            ss[a] = shape[a]
        return torch.full(ss, fan_in ** -0.5 / div, dtype=torch.float32)

    def qt(shape, fan_in, kind, pack_axis, scale_axes):
        if kind == 'int4':
            ps = list(shape)
            ps[pack_axis] //= 2
            q = rng.integers(0, 255, size=ps, dtype=np.uint8)
            return QTensor(torch.from_numpy(q),
                           scale_of(shape, fan_in, 7.0, scale_axes),
                           pack_axis - len(shape))
        if kind == 'int8':
            # a uint8 draw viewed as int8, as the reference draws it
            q = (rng.integers(0, 255, size=shape, dtype=np.uint8)
                 .view(np.int8) + np.int8(0))
            np.clip(q, -127, 127, out=q)
            return QTensor(torch.from_numpy(q),
                           scale_of(shape, fan_in, 127.0, scale_axes))
        b = rng.integers(0, 0x3F, size=shape, dtype=np.uint8)
        sign = rng.integers(0, 2, size=shape, dtype=np.uint8) << 7
        return QTensor(torch.from_numpy(b | sign).view(fp8.FP8),
                       scale_of(shape, fan_in, 4.0, scale_axes))

    def leaf(names: Sequence[str], shape):
        name = names[-1]
        in_blocks = any(n in ('double', 'single') for n in names)
        n = len(shape)
        if in_blocks and name == 'w' and n >= 2 and (spec.attn or spec.mod):
            # [L, in, out]: packed along in, scale per (L, out)
            kind = spec.mod if 'mod' in ''.join(names) else spec.attn
            if kind:
                return qt(shape, shape[-2], kind, n - 2,
                          [0, n - 1] if n == 3 else [n - 1])
        if in_blocks and name.endswith(('w1t', 'w2')) and n >= 2:
            kind = spec.mlp_dense if name.startswith('txt_') \
                else spec.mlp_sparse
            if kind:
                # [L, N, C]: packed along C, scale per (L, N)
                return qt(shape, shape[-1], kind, n - 1,
                          [0, 1] if n == 3 else [0])
        return torch.from_numpy(rng.standard_normal(shape) * 0.02).to(dtype)

    def walk(tree, names):
        if isinstance(tree, dict):
            return {k: walk(tree[k], names + [k]) for k in sorted(tree)}
        return leaf(names, tuple(tree))

    def put(t, i=None):
        if isinstance(t, dict):
            return {k: put(v, i) for k, v in t.items()}
        if isinstance(t, QTensor):
            return QTensor(put(t.q, i), put(t.scale, i), t.pack_axis)
        return (t if i is None else t[i]).to(dev)

    def n_layers(t):
        v = next(iter(t.values()))
        return n_layers(v) if isinstance(v, dict) else (
            v.q if isinstance(v, QTensor) else v).shape[0]

    drawn = walk(shapes, [])
    return {k: ([put(v, i) for i in range(n_layers(v))]
                if k in ('double', 'single') else put(v))
            for k, v in drawn.items()}


def synth_quantized_flux_params(seed: int, model,
                                spec: QuantSpec = QuantSpec(
                                    attn='int4', mod='int4',
                                    mlp_sparse='int8', mlp_dense='int4'),
                                device: DeviceLike = 'cuda') -> Dict:
    """:func:`synth_quantized_params` over the FLUX tree of ``model`` (a
    ``models.flux.FluxModelConfig``)."""
    from ..models.flux import flux_param_shapes
    return synth_quantized_params(seed, flux_param_shapes(model), spec,
                                  dtype=model.dtype, device=device)
