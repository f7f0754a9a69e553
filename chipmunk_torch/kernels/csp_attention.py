"""Column-sparse (gathered-KV) attention: wrapper over
``csrc/csp_attention.cu`` with its plain PyTorch version.

Counterpart of ``chipmunk_tpu/kernels/csp_attention.py`` (``csp_attn``,
VMEM mode).  Each ``qg``-row query group attends, with an exact softmax,
only over its ``block_counts[g]`` selected ``kv_block``-key blocks
``block_inds[g, :]``; the output is fresh and the caller adds the delta
cache.

Layout contract: q [B,H,Sq,D] with Sq % qg == 0; k, v [B,H,Sk,D] with
Sk % kv_block == 0; block_inds int [B,H,G,jmax] in [0, Sk/kv_block);
block_counts int [B,H,G], clipped here to [1, jmax].
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.attn_ref import attn_scale
from . import _build
from .flash_attention import _check_qkv, _stream, check_cuda_attn


def pad_block_indices(inds: torch.Tensor, counts: torch.Tensor
                      ) -> torch.Tensor:
    """Replace entries at positions >= count with the last valid entry."""
    pos = torch.arange(inds.shape[-1], device=inds.device)
    last = torch.gather(inds, -1, (counts.long() - 1).clamp(min=0)[..., None])
    return torch.where(pos < counts[..., None], inds, last)


def csp_attn_plain(q, k, v, block_inds, block_counts, qg: int = 128,
                   kv_block: int = 128, kv_valid: Optional[int] = None):
    """Plain version of the kernel: gather each group's jmax blocks, mask
    the positions past its count (and keys past kv_valid), exact softmax."""
    B, H, Sq, D = q.shape
    Sk = k.shape[-2]
    G, jmax = Sq // qg, block_inds.shape[-1]
    tok = (block_inds.long()[..., None] * kv_block
           + torch.arange(kv_block, device=q.device)).reshape(B, H, G, -1)
    idx = tok.reshape(B, H, -1, 1).expand(-1, -1, -1, D)
    kg = torch.gather(k, 2, idx).reshape(B, H, G, -1, D)
    vg = torch.gather(v, 2, idx).reshape(B, H, G, -1, D)
    valid = (torch.arange(jmax, device=q.device) < block_counts[..., None]
             ).repeat_interleave(kv_block, -1)                 # [B,H,G,JT]
    if kv_valid is not None and kv_valid < Sk:
        valid = valid & (tok < kv_valid)
    s = torch.einsum('bhgid,bhgjd->bhgij', q.reshape(B, H, G, qg, D).float(),
                     kg.float()) * attn_scale(D)
    valid = valid[:, :, :, None, :]
    s = s.masked_fill(~valid, -1.0e30)
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp2(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum('bhgij,bhgjd->bhgid', p.to(v.dtype).float(),
                     vg.float()) / l
    return o.reshape(B, H, Sq, D).to(q.dtype)


def csp_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             block_inds: torch.Tensor, block_counts: torch.Tensor,
             qg: int = 128, kv_block: int = 128,
             kv_valid: Optional[int] = None) -> torch.Tensor:
    """Column-sparse attention.  Returns o [B,H,Sq,D] (q.dtype)."""
    _check_qkv(q, k, v)
    B, H, Sq, D = q.shape
    Sk = k.shape[-2]
    if Sq % qg or Sk % kv_block:
        raise ValueError(f'Sq={Sq} must divide by qg={qg} and Sk={Sk} by '
                         f'kv_block={kv_block}')
    G, jmax = Sq // qg, block_inds.shape[-1]
    if block_inds.shape != (B, H, G, jmax) or block_counts.shape != (B, H, G):
        raise ValueError(f'block_inds {tuple(block_inds.shape)} / '
                         f'block_counts {tuple(block_counts.shape)} do not '
                         f'match [B,H,G={G},jmax]')
    if not (block_inds.device == block_counts.device == q.device):
        raise ValueError('csp_attn: block_inds/block_counts must be on q\'s '
                         'device')
    counts = block_counts.clamp(1, jmax).to(torch.int32)
    inds = pad_block_indices(block_inds, counts).to(torch.int32)
    if q.device.type == 'cpu':
        return csp_attn_plain(q, k, v, inds, counts, qg, kv_block, kv_valid)
    check_cuda_attn('csp_attn', q, k, v)
    if qg != 128 or not (kv_block == 32 or kv_block % 64 == 0):
        raise ValueError('csp_attn kernel: qg must be 128 and kv_block 32 '
                         f'or a multiple of 64 (got {qg}, {kv_block})')
    inds, counts = inds.contiguous(), counts.contiguous()
    o = torch.empty_like(q)
    lib = _build.library('csp_attention')
    _build.check(lib.chipmunk_csp_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), inds.data_ptr(),
        counts.data_ptr(), o.data_ptr(), B * H, Sq, Sk, jmax, kv_block,
        Sk if kv_valid is None else min(kv_valid, Sk), attn_scale(D),
        _stream(q)), 'csp_attn')
    _build.LAUNCHES['csp_attn'] += 1
    return o
