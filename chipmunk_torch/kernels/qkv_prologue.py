"""A FLUX-architecture block's attention inputs in one pass: a wrapper over
``csrc/qkv_prologue.cu`` with its plain PyTorch version.

Each stream's qkv GEMM output (without its bias) becomes its part of the
joint sequence's q, k, v: the bias add, the head split, the per-head
RMSNorm of q and k with the stream's scales and the interleaved RoPE of q
and k.  The reference leaves this chain to XLA; it has no Pallas kernel.
On CPU tensors the wrapper runs the plain version; on CUDA tensors it
launches the kernel (one launch for every stream) or raises.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..ops.norm_rope import apply_rope, rmsnorm
from . import _build
from .flash_attention import HEAD_DIM, _stream


class QkvStream(NamedTuple):
    """One stream of the joint sequence: ``y`` [B, S_i, 3 H D], the qkv
    GEMM's output without its bias; ``bias`` [3 H D] or None; the q and k
    norm scales [D]."""
    y: torch.Tensor
    bias: Optional[torch.Tensor]
    q_scale: torch.Tensor
    k_scale: torch.Tensor


def qkv_prologue_plain(streams: Sequence[QkvStream], cos, sin, heads: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The blocks' eager op sequence: per stream the bias add (``linear``),
    the head split, ``rmsnorm`` of q and k; the streams concatenated in
    order; ``apply_rope`` of q and k."""
    parts = []
    for y, bias, qs, ks in streams:
        if bias is not None:
            y = y + bias.to(y.dtype)
        B, S, C = y.shape
        q, k, v = (z.reshape(B, S, heads, C // (3 * heads)).transpose(1, 2)
                   for z in y.chunk(3, -1))
        parts.append((rmsnorm(q, qs), rmsnorm(k, ks), v))
    q, k, v = (torch.cat(z, 2) if len(z) > 1 else z[0] for z in zip(*parts))
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v.contiguous()


def _rope_table(t, B, S, device, name):
    if t.device != device or t.dtype != torch.float32 or t.dim() != 4 \
            or t.shape[0] not in (1, B) or t.shape[1:] != (1, S, HEAD_DIM // 2):
        raise ValueError(f'{name}: cos and sin must be float32 [1 or B, 1, '
                         f'S, {HEAD_DIM // 2}] on {device}, got {t.dtype} '
                         f'{tuple(t.shape)} on {t.device}')
    return t.contiguous()


def qkv_prologue(streams: Sequence[QkvStream], cos: torch.Tensor,
                 sin: torch.Tensor, heads: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v [B, H, S, D] of the joint sequence of ``streams`` (one or
    two, in sequence order; S their token counts summed), with ``cos``,
    ``sin`` [B or 1, 1, S, D/2] the joint sequence's RoPE tables.  A
    stream of 0 tokens contributes nothing."""
    name = 'qkv_prologue'
    if not 1 <= len(streams) <= 2:
        raise ValueError(f'{name}: one or two streams, got {len(streams)}')
    y0 = streams[0].y
    if y0.device.type == 'cpu':
        return qkv_prologue_plain(streams, cos, sin, heads)
    B, _, W = y0.shape
    D = W // (3 * heads)
    if D != HEAD_DIM or W != 3 * heads * D:
        raise ValueError(f'{name}: the kernel takes a qkv width of 3 x '
                         f'{heads} heads x {HEAD_DIM}, got {W}')
    args = []
    for s in streams:
        y = s.y
        if y.device != y0.device or y.dtype != torch.bfloat16 \
                or not y.is_contiguous() or y.dim() != 3 \
                or y.shape[0] != B or y.shape[2] != W:
            raise ValueError(f'{name}: each stream must be a contiguous bf16 '
                             f'[{B}, S, {W}] on {y0.device}, got {y.dtype} '
                             f'{tuple(y.shape)} on {y.device}')
        if (s.bias is not None and (s.bias.shape != (W,)
                                    or s.bias.device != y0.device)) \
                or s.q_scale.shape != (D,) or s.k_scale.shape != (D,) \
                or s.q_scale.device != y0.device \
                or s.k_scale.device != y0.device:
            raise ValueError(f'{name}: bias [{W}] and norm scales [{D}] on '
                             f'{y0.device}')
        # the plain version's casts (``linear``, ``rmsnorm``)
        args.append((y, None if s.bias is None
                     else s.bias.to(torch.bfloat16).contiguous(),
                     s.q_scale.to(torch.bfloat16).contiguous(),
                     s.k_scale.to(torch.bfloat16).contiguous()))
    sizes = [a[0].shape[1] for a in args]
    S = sum(sizes)
    cos, sin = (_rope_table(t, B, S, y0.device, name) for t in (cos, sin))
    q, k, v = torch.empty((3, B, heads, S, D), dtype=torch.bfloat16,
                          device=y0.device).unbind(0)
    if B * S == 0:
        return q, k, v
    if len(args) == 1:
        args.append(args[0])
        sizes.append(0)
    ptrs = [0 if t is None else t.data_ptr() for a in args for t in a]
    if any(p % 16 for p in ptrs + [cos.data_ptr(), sin.data_ptr()]):
        raise ValueError(f'{name}: the kernel takes 16-byte aligned tensors')
    _build.check(_build.library('qkv_prologue').chipmunk_qkv_prologue(
        *ptrs, cos.data_ptr(), sin.data_ptr(), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), B, sizes[0], sizes[1], heads, int(cos.shape[0] > 1),
        _stream(y0)), name)
    _build.LAUNCHES[name] += 1
    return q, k, v
