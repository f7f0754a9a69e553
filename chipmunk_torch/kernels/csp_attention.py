"""Column-sparse (gathered-KV) attention: wrappers over the two entries of
``csrc/csp_attention.cu`` (one kernel, two places where K and V lie) with
their plain PyTorch versions.

Counterpart of ``chipmunk_tpu/kernels/csp_attention.py`` (``csp_attn``).
Each ``qg``-row query group attends, with an exact softmax, only over its
``block_counts[g]`` selected ``kv_block``-key blocks ``block_inds[g, :]``;
the output is fresh and the caller adds the delta cache.  Two modes, as in
the reference, and ``mode='auto'`` picks between them by the reference's
own rule, so every call takes the counterpart of the kernel JAX would:

  * ``'vmem'`` (image-scale sequences): ``csp_attn`` kernel, counterpart
    of ``_csp_vmem_kernel``; reads K and V where they lie.
  * ``'hbm'`` (video-scale sequences): K and V are packed per block into
    ``[B*H, nb, 2*kv_block, D]`` (one torch copy, as the reference's XLA
    concat), then ``csp_attn_hbm`` gathers the selected blocks from
    it: counterpart of ``_csp_hbm_packed_kernel``.

kv_block 1, 2 and 4 are smaller than the kernel's 8-row key box (one
128-byte swizzle atom), so ``pack_kv`` gives each of their blocks a
16-row slot (``[B*H, nb, 16, D]``: K rows first, V rows from row 8,
zeros elsewhere) and both modes run the packed kernel on it, one box per
selected block.  The copy holds 8 / kv_block times the bytes of K and V.

Layout contract: q [B,H,Sq,D] with Sq % qg == 0 (any such qg, on the
card too); k, v [B,H,Sk,D] with
Sk % kv_block == 0; block_inds int [B,H,G,jmax] in [0, Sk/kv_block);
block_counts int [B,H,G], clipped to [1, jmax].  Entries of block_inds
at positions past the clipped count are never read.  On the CPU the
wrappers clip the counts and pad the index rows with their last valid
entry (``pad_block_indices``) for the plain versions; on the card the
kernel does both itself.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.attn_ref import attn_scale
from . import _build
from .flash_attention import (_check_qkv, _kv_strides, _stream,
                              check_cuda_attn)

# The reference's scoped-VMEM cap (chipmunk_tpu/kernels/csp_attention.py:57);
# 'auto' applies its footprint rule with its constants.
VMEM_LIMIT = 100 * 1024 * 1024


def pad_block_indices(inds: torch.Tensor, counts: torch.Tensor
                      ) -> torch.Tensor:
    """Replace entries at positions >= count with the last valid entry."""
    pos = torch.arange(inds.shape[-1], device=inds.device)
    last = torch.gather(inds, -1, (counts.long() - 1).clamp(min=0)[..., None])
    return torch.where(pos < counts[..., None], inds, last)


def auto_mode(Sq: int, Sk: int, D: int, jmax: int, kv_block: int,
              itemsize: int) -> str:
    """The reference's choice (csp_attention.py:353-359): 'vmem' when the
    double-buffered whole-head q/k/v/o plus the gather scratch fit
    VMEM_LIMIT, else 'hbm'."""
    resident = (2 * Sk + 2 * Sq) * D * itemsize
    scratch = 4 * jmax * kv_block * D * itemsize
    return 'vmem' if 2 * resident + scratch + (4 << 20) <= VMEM_LIMIT \
        else 'hbm'


def kv_slot(kv_block: int) -> int:
    """Rows of K (and of V) per block in the packed layout: kv_block, or 8
    for kv_block 1, 2 and 4 (the kernel's smallest key box)."""
    return max(kv_block, 8)


def pack_kv(k: torch.Tensor, v: torch.Tensor, kv_block: int) -> torch.Tensor:
    """[B,H,Sk,D] K and V -> [B*H, Sk/kv_block, 2*slot, D]: each block's K
    rows, then its V rows, each in a slot of ``kv_slot(kv_block)`` rows
    (zeros past kv_block)."""
    B, H, Sk, D = k.shape
    nb, slot = Sk // kv_block, kv_slot(kv_block)
    parts = [t.reshape(B * H, nb, kv_block, D) for t in (k, v)]
    if slot > kv_block:
        parts = [torch.nn.functional.pad(t, (0, 0, 0, slot - kv_block))
                 for t in parts]
    return torch.cat(parts, 2)


def _gathered_attn(q, kg, vg, valid, qg):
    """Exact softmax of each group's rows over its gathered keys.
    q [B,H,Sq,D]; kg, vg [B,H,G,JT,D]; valid bool [B,H,G,JT]."""
    B, H, Sq, D = q.shape
    G = Sq // qg
    s = torch.einsum('bhgid,bhgjd->bhgij', q.reshape(B, H, G, qg, D).float(),
                     kg.float()) * attn_scale(D)
    valid = valid[:, :, :, None, :]
    s = s.masked_fill(~valid, -1.0e30)
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp2(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum('bhgij,bhgjd->bhgid', p.to(vg.dtype).float(),
                     vg.float()) / l
    return o.reshape(B, H, Sq, D).to(q.dtype)


def _valid(block_inds, block_counts, kv_block, kv_valid, Sk):
    """bool [B,H,G,jmax*kv_block]: positions before the count, and keys
    before kv_valid; also the gathered token ids."""
    B, H, G, jmax = block_inds.shape
    tok = (block_inds.long()[..., None] * kv_block
           + torch.arange(kv_block, device=block_inds.device)
           ).reshape(B, H, G, -1)
    valid = (torch.arange(jmax, device=block_inds.device)
             < block_counts[..., None]).repeat_interleave(kv_block, -1)
    if kv_valid is not None and kv_valid < Sk:
        valid = valid & (tok < kv_valid)
    return valid, tok


def csp_attn_plain(q, k, v, block_inds, block_counts, qg: int = 128,
                   kv_block: int = 128, kv_valid: Optional[int] = None):
    """Plain version of the 'vmem' kernel: gather each group's jmax blocks,
    mask the positions past its count (and keys past kv_valid), exact
    softmax."""
    B, H, Sq, D = q.shape
    valid, tok = _valid(block_inds, block_counts, kv_block, kv_valid,
                        k.shape[-2])
    idx = tok.reshape(B, H, -1, 1).expand(-1, -1, -1, D)
    kg = torch.gather(k, 2, idx).reshape(B, H, Sq // qg, -1, D)
    vg = torch.gather(v, 2, idx).reshape(B, H, Sq // qg, -1, D)
    return _gathered_attn(q, kg, vg, valid, qg)


def csp_attn_hbm_plain(q, kv, block_inds, block_counts, qg: int = 128,
                       kv_block: int = 128, kv_valid: Optional[int] = None):
    """Plain version of the 'hbm' kernel over the packed layout kv
    [B*H, nb, 2*slot, D] (see pack_kv)."""
    B, H, Sq, D = q.shape
    nb = kv.shape[1]
    G, jmax = block_inds.shape[-2:]
    valid, _ = _valid(block_inds, block_counts, kv_block, kv_valid,
                      nb * kv_block)
    kvr = kv.reshape(B, H, nb, 2, kv_slot(kv_block), D)[..., :kv_block, :]
    bi = torch.arange(B, device=q.device)[:, None, None, None]
    hi = torch.arange(H, device=q.device)[None, :, None, None]
    blk = kvr[bi, hi, block_inds.long()]          # [B,H,G,jmax,2,kvb,D]
    kg = blk[..., 0, :, :].reshape(B, H, G, jmax * kv_block, D)
    vg = blk[..., 1, :, :].reshape(B, H, G, jmax * kv_block, D)
    return _gathered_attn(q, kg, vg, valid, qg)


def _check_inds(q, block_inds, block_counts, G):
    B, H = q.shape[:2]
    jmax = block_inds.shape[-1]
    if block_inds.shape != (B, H, G, jmax) or block_counts.shape != (B, H, G):
        raise ValueError(f'block_inds {tuple(block_inds.shape)} / '
                         f'block_counts {tuple(block_counts.shape)} do not '
                         f'match [B,H,G={G},jmax]')
    if not (block_inds.device == block_counts.device == q.device):
        raise ValueError('csp_attn: block_inds/block_counts must be on q\'s '
                         'device')


def csp_attn_hbm(q: torch.Tensor, kv: torch.Tensor, block_inds: torch.Tensor,
                 block_counts: torch.Tensor, qg: int = 128,
                 kv_block: int = 128, kv_valid: Optional[int] = None
                 ) -> torch.Tensor:
    """Column-sparse attention over packed K+V (``pack_kv``): kv
    [B*H, nb, 2*kv_slot(kv_block), D].  On the CPU block_counts must lie
    in [1, jmax] and block_inds hold a valid block id at every position
    (as csp_attn makes them for the plain version); the kernel clips the
    counts and reads no position past them.  Returns o [B,H,Sq,D]
    (q.dtype)."""
    B, H, Sq, D = q.shape
    BH, nb, rows, Dk = kv.shape
    if BH != B * H or rows != 2 * kv_slot(kv_block) or Dk != D or Sq % qg:
        raise ValueError(f'csp_attn_hbm: q {tuple(q.shape)} and packed kv '
                         f'{tuple(kv.shape)} do not match (kv_block '
                         f'{kv_block}, qg {qg})')
    if kv.device != q.device or kv.dtype != q.dtype:
        raise ValueError('csp_attn_hbm: q and kv on different devices or '
                         'of different dtypes')
    _check_inds(q, block_inds, block_counts, Sq // qg)
    if q.device.type == 'cpu':
        return csp_attn_hbm_plain(q, kv, block_inds, block_counts, qg,
                                  kv_block, kv_valid)
    check_cuda_attn('csp_attn_hbm', q, kv)
    if kv_block not in (1, 2, 4, 8, 16, 32, 64, 128):
        raise ValueError('csp_attn_hbm kernel: kv_block must be a power of 2 '
                         f'up to 128 (got {kv_block})')
    inds = block_inds.to(torch.int32).contiguous()
    counts = block_counts.to(torch.int32).contiguous()
    Sk = nb * kv_block
    o = torch.empty_like(q)
    lib = _build.library('csp_attention')
    _build.check(lib.chipmunk_csp_hbm_attn(
        q.data_ptr(), kv.data_ptr(), inds.data_ptr(), counts.data_ptr(),
        o.data_ptr(), B * H, Sq, nb, qg, block_inds.shape[-1], kv_block,
        Sk if kv_valid is None else min(kv_valid, Sk), attn_scale(D),
        _stream(q)), 'csp_attn_hbm')
    _build.LAUNCHES['csp_attn_hbm'] += 1
    return o


def csp_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             block_inds: torch.Tensor, block_counts: torch.Tensor,
             qg: int = 128, kv_block: int = 128,
             kv_valid: Optional[int] = None, mode: str = 'auto'
             ) -> torch.Tensor:
    """Column-sparse attention.  Returns o [B,H,Sq,D] (q.dtype).
    mode: 'auto' | 'vmem' | 'hbm' (see the module docstring); kv_valid:
    keys at positions >= kv_valid are excluded from every softmax.  For
    'vmem' on the card q, k and v may be slices along S of larger tensors
    (``k[..., :n, :]``), as for dense_attn: the kernel takes their head
    strides."""
    _check_qkv(q, k, v)
    B, H, Sq, D = q.shape
    Sk = k.shape[-2]
    if Sq % qg or Sk % kv_block:
        raise ValueError(f'Sq={Sq} must divide by qg={qg} and Sk={Sk} by '
                         f'kv_block={kv_block}')
    G, jmax = Sq // qg, block_inds.shape[-1]
    _check_inds(q, block_inds, block_counts, G)
    if mode == 'auto':
        mode = auto_mode(Sq, Sk, D, jmax, kv_block, k.element_size())
    if mode not in ('vmem', 'hbm'):
        raise ValueError(f"csp_attn: mode must be 'auto', 'vmem' or 'hbm', "
                         f'got {mode!r}')
    if q.device.type == 'cpu':
        counts = block_counts.clamp(1, jmax).to(torch.int32)
        inds = pad_block_indices(block_inds, counts).to(torch.int32)
        if mode == 'hbm':
            return csp_attn_hbm(q, pack_kv(k, v, kv_block), inds, counts,
                                qg, kv_block, kv_valid)
        return csp_attn_plain(q, k, v, inds, counts, qg, kv_block, kv_valid)
    if mode == 'hbm' or kv_block < 8:
        # below 8 rows a block is read from its packed slot (module doc)
        check_cuda_attn('csp_attn', q, k, v, strided=mode == 'vmem')
        return csp_attn_hbm(q.contiguous(), pack_kv(k, v, kv_block),
                            block_inds, block_counts, qg, kv_block, kv_valid)
    q_hs, kv_hs = _kv_strides('csp_attn', q, k, v)
    if not (kv_block in (8, 16, 32) or kv_block % 64 == 0):
        raise ValueError('csp_attn kernel: kv_block must be 1, 2, 4, 8, 16, '
                         f'32 or a multiple of 64 (got {kv_block})')
    inds = block_inds.to(torch.int32).contiguous()
    counts = block_counts.to(torch.int32).contiguous()
    o = torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device)
    lib = _build.library('csp_attention')
    _build.check(lib.chipmunk_csp_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), inds.data_ptr(),
        counts.data_ptr(), o.data_ptr(), B * H, Sq, Sk, q_hs, kv_hs, qg, jmax,
        kv_block, Sk if kv_valid is None else min(kv_valid, Sk),
        attn_scale(D), _stream(q)), 'csp_attn')
    _build.LAUNCHES['csp_attn'] += 1
    return o
