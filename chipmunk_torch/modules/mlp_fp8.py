"""fp8 (e4m3) MLP weights and inputs with per-tensor scales (torch), the
counterpart of ``chipmunk_tpu/modules/mlp_fp8.py``.

Weights are quantized with an amax scale, ``max(amax / 448, 1e-12)``;
inputs with a dynamic scale, either per call or calibrated over the first
``CALIBRATION_STEPS`` calls and then frozen (``F8InputState``, explicit
state as in the reference).  Every rounding to e4m3 goes through
``ops/fp8.py`` (NaN above 464, as the reference; torch would saturate),
after an f32 division by the scale, so that the codes are the
reference's bit for bit.

The product is fp8 x fp8 with f32 accumulation, as the reference's
``dot_general`` outside any Pallas kernel: on the card
``torch._scaled_mm`` with unit scales and an f32 result, on the CPU both
operands upcast to f32 (their products are exact) and ``torch.matmul``.
The scales and the bias are applied after it in f32, in the reference's
order.  Hopper's fp8 tensor cores sum the exact products in less than
f32 precision: the card's result is within one e4m3 ulp of the plain
one at the outputs' scale, not within f32 rounding.

``mlp.is_fp8: true`` maps to ``quant_spec_for_is_fp8`` at the load edge
(``models/loaders.load_flux_params``), and ``SparseDiffMlp`` runs fc1
through ``f8_input_matmul`` when its weight is an fp8 ``QTensor``.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..ops import fp8
from ..utils.quant import QTensor, QuantSpec, true_div

E4M3_MAX = 448.0
CALIBRATION_STEPS = 12


class F8Weight(NamedTuple):
    w8: torch.Tensor          # float8_e4m3fn, the weight's layout
    scale: torch.Tensor       # f32 scalar: w ~= w8 * scale


class F8InputState(NamedTuple):
    """Running input-scale calibration."""
    amax: torch.Tensor        # f32 scalar running max
    count: torch.Tensor       # int32 calls seen


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(true_div(amax, E4M3_MAX), min=1e-12)


def quantize_weight(w: torch.Tensor) -> F8Weight:
    wf = w.float()
    scale = _scale(wf.abs().amax())
    return F8Weight(w8=fp8.to_fp8(wf / scale), scale=scale)


def init_input_state(device: DeviceLike = 'cuda') -> F8InputState:
    """A fresh calibration state on ``device`` (the card unless the
    caller asks for the CPU)."""
    dev = resolve_device(device)
    return F8InputState(amax=torch.zeros((), device=dev),
                        count=torch.zeros((), dtype=torch.int32, device=dev))


def _amax(st: F8InputState, cur: torch.Tensor) -> torch.Tensor:
    return torch.where(st.count < CALIBRATION_STEPS,
                       torch.maximum(st.amax, cur), st.amax)


def update_calibration(st: F8InputState, x: torch.Tensor) -> F8InputState:
    return F8InputState(amax=_amax(st, x.float().abs().amax()),
                        count=st.count + 1)


def quantize_input(x: torch.Tensor, st: Optional[F8InputState]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x8, scale): x quantized with the calibrated scale (the running max
    with this call's while calibrating); ``st=None`` takes this call's
    amax alone."""
    xf = x.float()
    cur = xf.abs().amax()
    scale = _scale(cur if st is None else _amax(st, cur))
    return fp8.to_fp8(xf / scale), scale


def _dot_f32(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """x8 [M, K] @ w8 [N, K]^T in f32 (fp8 operands).  On the card
    ``torch._scaled_mm``, which takes K and N in multiples of 16 and the
    second operand column-major: a shape it does not take raises."""
    if x8.dtype != fp8.FP8 or w8.dtype != fp8.FP8:
        raise ValueError(f'fp8 operands expected, got {x8.dtype} and '
                         f'{w8.dtype}')
    if x8.dim() != 2 or w8.dim() != 2 or x8.shape[1] != w8.shape[1]:
        raise ValueError(f'shapes {tuple(x8.shape)} @ {tuple(w8.shape)}^T '
                         f'do not contract')
    if x8.device != w8.device:
        raise ValueError(f'operands on {x8.device} and {w8.device}')
    if x8.device.type == 'cpu':
        return x8.float() @ w8.float().t()
    if x8.device.type != 'cuda':
        raise ValueError(f'no fp8 product on {x8.device}')
    K, N = w8.shape[1], w8.shape[0]
    if K % 16 or N % 16:
        raise ValueError(f'torch._scaled_mm takes K and N in multiples of '
                         f'16, got K={K}, N={N}')
    b = w8.t()
    if b.stride(0) != 1:
        raise ValueError('the weight must be row-major [N, K], so that its '
                         'transpose is column-major')
    one = torch.ones((), dtype=torch.float32, device=x8.device)
    return torch._scaled_mm(x8.contiguous(), b, scale_a=one, scale_b=one,
                            out_dtype=torch.float32)


def f8_matmul(x8: torch.Tensor, x_scale: torch.Tensor, w: F8Weight,
              bias: Optional[torch.Tensor] = None,
              out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """y = (x8 @ w8^T) * (sx * sw) + b, with w8 output-major [N, C]."""
    y = _dot_f32(x8, w.w8) * (x_scale * w.scale)
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def f8_linear(x: torch.Tensor, w: F8Weight, st: F8InputState,
              bias: Optional[torch.Tensor] = None,
              out_dtype: torch.dtype = torch.bfloat16
              ) -> Tuple[torch.Tensor, F8InputState]:
    x8, sx = quantize_input(x, st)
    return f8_matmul(x8, sx, w, bias, out_dtype), update_calibration(st, x)


def quant_spec_for_is_fp8() -> QuantSpec:
    """The QuantSpec that ``mlp.is_fp8: true`` maps to, as the reference
    has it: the weights the sparse kernels read stored int8 (the same
    bytes as fp8; the sparse kernels take no fp8 weights), the dense text
    MLP's stored fp8, attention and modulation as they are."""
    return QuantSpec(attn=None, mod=None, mlp_sparse='int8',
                     mlp_dense='fp8')


def f8_input_matmul(x: torch.Tensor, wq: QTensor,
                    bias: Optional[torch.Tensor] = None,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """fc1 in fp8 x fp8 for ``mlp.is_fp8``: x [T, C] quantized with its
    per-call amax scale, contracted against an fp8 QTensor weight stored
    output-major [N, C] with per-row scales [N, 1]."""
    if not isinstance(wq, QTensor) or wq.pack_axis is not None:
        raise ValueError('f8_input_matmul takes an unpacked fp8 QTensor')
    x8, sx = quantize_input(x, None)
    y = _dot_f32(x8, wq.q) * (sx * wq.scale.reshape(1, -1))
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype or x.dtype)


def quantize_flux_mlps(params: Dict, quantize_sparse_fc2: bool = False
                       ) -> Tuple[Dict, Dict]:
    """The FLUX MLP fc1 weights (and, if asked, the sparse fc2 weights)
    as F8Weights, one per layer under the params' ``double``/``single``
    lists; modulation and the text fc2 stay as they are.  Returns
    (f8 weights, calibration states)."""
    def per_layer(blocks: List[Dict], name: str) -> List[F8Weight]:
        return [quantize_weight(p[name]) for p in blocks]

    dbl, sgl = params['double'], params['single']
    f8 = {'double': {'img_w1t': per_layer(dbl, 'img_w1t'),
                     'txt_w1t': per_layer(dbl, 'txt_w1t')},
          'single': {'w1t': per_layer(sgl, 'w1t')}}
    if quantize_sparse_fc2:
        f8['double']['img_w2'] = per_layer(dbl, 'img_w2')
        f8['single']['w2'] = per_layer(sgl, 'w2')
    dev = (dbl[0]['img_w1t'] if dbl else sgl[0]['w1t']).device
    calib = {k: init_input_state(dev)
             for k in ('double_img', 'double_txt', 'single')}
    return f8, calib
