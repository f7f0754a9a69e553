"""Sparse delta attention (torch), the counterpart of
``chipmunk_tpu/modules/attn.py`` (every branch but Ulysses head
parallelism).

A static-config object whose step methods take and return an explicit
``AttnState``:
  step 0            -> dense, store lse
  full+colsum steps -> dense_colsum_attn, select the block mask (plain
                       top-k, or with compressed indices the random keep
                       union top-k, gated per query group, union the static
                       mask), store the selection, cache = o - csp(...)
  full plain steps  -> dense, refresh cache with the stored selection
  sparse steps      -> out = cache + csp(...); the exact-dense tail groups
                       (text rows whose static mask covers everything) are
                       recomputed densely
  dense layers      -> dense always

``valid_len`` (a model that pads its sequence to a multiple of 128)
excludes keys past it from every softmax and gives pad queries
lse = PAD_LSE.  Compressed states keep the selection as a bitpacked mask;
unless ``materialize_indices`` they keep only that and rebuild the index
lists on every consuming step.  Random keeps come from the caller's
``torch.Generator`` or are injected (``keep_mask``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..config import AttnConfig
from ..device import DeviceLike, resolve_device
from ..ops import fp8, indexing
from ..ops.attn_ref import PAD_LSE
from ..ops.bitpack import bitpack_rows, bitunpack_rows
from ..utils.profiling import span


class AttnState(NamedTuple):
    """Per-layer attention caches.  Uncompressed states keep (inds,
    counts); compressed ones keep ``packed`` and, when materialized, also
    (inds, counts); absent fields are None."""
    out_cache: torch.Tensor                  # [B,H,S,D]
    lse: torch.Tensor                        # [B,H,S] fp32, log2 domain
    inds: Optional[torch.Tensor]             # [B,H,G,jmax] int32 block ids
    counts: Optional[torch.Tensor]           # [B,H,G] int32
    packed: Optional[torch.Tensor] = None    # [B,H,G,ceil(NB/8)] uint8


def init_attn_state(B: int, H: int, S: int, D: int, jmax: int,
                    dtype: torch.dtype = torch.bfloat16,
                    out_cache_dtype: Optional[torch.dtype] = None,
                    device: DeviceLike = 'cuda', kv_block: int = 128,
                    compress: bool = False, materialize: bool = True
                    ) -> AttnState:
    dev = resolve_device(device)
    G, nb = S // 128, S // kv_block
    inds = counts = packed = None
    if not compress or materialize:
        inds = torch.zeros((B, H, G, jmax), dtype=torch.int32, device=dev)
        counts = torch.ones((B, H, G), dtype=torch.int32, device=dev)
    if compress:
        packed = torch.zeros((B, H, G, -(-nb // 8)), dtype=torch.uint8,
                             device=dev)
    return AttnState(
        out_cache=torch.zeros((B, H, S, D), dtype=out_cache_dtype or dtype,
                              device=dev),
        lse=torch.full((B, H, S), PAD_LSE, dtype=torch.float32, device=dev),
        inds=inds, counts=counts, packed=packed)


@dataclass(frozen=True)
class SparseDiffAttn:
    """Static per-model attention sparsity config + step methods."""
    cfg: AttnConfig
    seq_len: int            # padded Sq == Sk
    jmax: int               # max selected kv blocks per query group
    sel_blocks: int         # top-k in kv blocks
    static_mask: Optional[torch.Tensor] = None          # bool [G, NB]
    sparse_query_groups: Optional[torch.Tensor] = None  # bool [G, 1]
    # real tokens when the model pads the sequence tail ([img|txt|pad])
    valid_len: Optional[int] = None
    # first query group of the exact-dense tail (None: no tail)
    dense_tail_g: Optional[int] = None
    fully_dense: bool = False   # cost gate: run the layer dense every step
    csp_mode: str = 'auto'      # csp_attn mode ('auto', 'vmem', 'hbm')
    # (sparse_query_groups, static_mask) per device, moved there once
    _on_device: Dict = field(default_factory=dict, init=False,
                             compare=False, repr=False)

    @staticmethod
    def build(cfg: AttnConfig, seq_len: int, static_mask_tokens=None,
              valid_len: Optional[int] = None, csp_mode: str = 'auto'
              ) -> "SparseDiffAttn":
        """static_mask_tokens: optional bool [G, S] (numpy or torch), the
        voxel/1-D-window/text mask of ``ops.voxel``."""
        if seq_len % cfg.mbm or seq_len % cfg.kv_block:
            raise ValueError(f'seq_len {seq_len} must be a multiple of '
                             f'attn.mbm {cfg.mbm} and attn.kv_block '
                             f'{cfg.kv_block}')
        nb = seq_len // cfg.kv_block
        mult_b = max(cfg.counts_multiple_of // cfg.kv_block, 1)
        sel_blocks = int(round(cfg.top_keys * seq_len / cfg.counts_multiple_of)
                         * cfg.counts_multiple_of) // cfg.kv_block
        sel_blocks = max(min(sel_blocks, nb), 0)
        static_mask = sparse_qg = None
        if static_mask_tokens is not None:
            sm = torch.as_tensor(np.asarray(static_mask_tokens), dtype=torch.bool)
            static_mask = indexing.blockify_mask(sm, cfg.kv_block)
            # query groups whose static mask + top-k would cover the whole
            # sequence do dense-equivalent work anyway: not sparse
            n_static = static_mask.sum(-1) * cfg.kv_block
            sparse_qg = ((n_static + sel_blocks * cfg.kv_block)
                         < seq_len)[:, None]
        # exact-dense tail: the non-sparse groups, when they form a
        # contiguous suffix, leave the gather capacity and are recomputed
        # exactly on every sparse step
        dense_tail_g = sparse_rows = None
        if sparse_qg is not None:
            nsq = ~sparse_qg[:, 0].numpy()
            if nsq.any():
                first = int(np.argmax(nsq))
                if nsq[first:].all():
                    dense_tail_g = first
                    sparse_rows = ~nsq
        # capacity = top-k + static mask + a random-keep margin
        static_max = 0
        if static_mask is not None:
            sm_rows = static_mask
            if sparse_rows is not None:
                sm_rows = static_mask[torch.from_numpy(sparse_rows)]
            if sm_rows.shape[0]:
                static_max = int(sm_rows.sum(-1).max())
        rand_margin = (max(8, int(3 * cfg.random_keys * nb))
                       if (cfg.should_compress_indices
                           and cfg.random_keys > 0) else 0)
        need = sel_blocks + static_max + rand_margin
        cap = nb if (cfg.max_selected_frac >= 1.0 or dense_tail_g is not None
                     ) else int(nb * cfg.max_selected_frac)
        jmax = max(min(need, cap, nb), 1)
        jmax = min(-(-jmax // mult_b) * mult_b, nb)
        if valid_len is not None and valid_len >= seq_len:
            valid_len = None
        fully_dense = (cfg.dense_fallback_frac < 1.0
                       and jmax >= nb * cfg.dense_fallback_frac)
        return SparseDiffAttn(cfg=cfg, seq_len=seq_len, jmax=jmax,
                              sel_blocks=sel_blocks, static_mask=static_mask,
                              sparse_query_groups=sparse_qg,
                              valid_len=valid_len, dense_tail_g=dense_tail_g,
                              fully_dense=fully_dense, csp_mode=csp_mode)

    @property
    def materialized(self) -> bool:
        """Whether compressed states also keep (inds, counts) next to the
        packed mask (attn.materialize_indices; None = yes)."""
        mat = self.cfg.materialize_indices
        return True if mat is None else bool(mat)

    # ---------------------------------------------------------------- ops
    def _fix_pad_lse(self, lse):
        """Pad queries carry PAD_LSE, so their colsums on the next colsum
        step are exactly 0 (in place: lse is the kernel's fresh output)."""
        if self.valid_len is not None:
            lse[..., self.valid_len:] = PAD_LSE
        return lse

    def _cut(self, k, v):
        """Keys and values before valid_len: views, the kernels take their
        head strides."""
        n = self.valid_len or k.shape[-2]
        return k[..., :n, :], v[..., :n, :]

    def _dense_raw(self, q, k, v):
        """Dense attention with the raw lse; q may be any slice of rows."""
        return kernels.dense_attn(q, *self._cut(k, v))

    def _dense(self, q, k, v):
        """Full-sequence dense attention (the pad fix indexes lse at
        full-sequence rows)."""
        o, lse = self._dense_raw(q, k, v)
        return o, self._fix_pad_lse(lse)

    def _colsum(self, q, k, v, prev_lse):
        nb_full = self.seq_len // self.cfg.kv_block
        o, cs, lse = kernels.dense_colsum_attn(
            q, *self._cut(k, v), prev_lse, qg=self.cfg.mbm,
            score_block=self.cfg.kv_block)
        if cs.shape[-1] < nb_full:   # cut blocks score 0: never in top-k
            cs = torch.nn.functional.pad(cs, (0, nb_full - cs.shape[-1]))
        return o, cs, self._fix_pad_lse(lse)

    def _csp(self, q, k, v, inds, counts):
        return kernels.csp_attn(q, k, v, inds, counts, qg=self.cfg.mbm,
                                kv_block=self.cfg.kv_block,
                                kv_valid=self.valid_len, mode=self.csp_mode)

    def _select_mask(self, colsums: torch.Tensor,
                     keep_mask: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        """Plain top-k of the block column sums (uncompressed indices), or
        the random keep union top-k, gated per query group, union the
        static mask (compressed indices)."""
        if not self.cfg.should_compress_indices:
            return indexing.topk_mask(colsums, self.sel_blocks)
        sparse_qg, static_mask = self.masks_on(colsums.device)
        return indexing.random_and_topk_mask(
            colsums, self.sel_blocks, keep_mask=keep_mask,
            generator=generator, sparse_query_groups=sparse_qg,
            static_mask=static_mask, random_frac=self.cfg.random_keys)

    def masks_on(self, device: torch.device
                 ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """(sparse_query_groups, static_mask) on ``device``, moved there by
        the first call for it and kept: a copy from the host on every
        colsum step would cost a pageable copy each time and stop a CUDA
        graph capture."""
        masks = self._on_device.get(device)
        if masks is None:
            masks = tuple(None if t is None else t.to(device)
                          for t in (self.sparse_query_groups,
                                    self.static_mask))
            self._on_device[device] = masks
        return masks

    def _mask_to_inds(self, mask: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Deterministic mask -> (inds, counts): freshly selected and
        stored-packed paths give the same lists.  Dense-tail groups skip
        the gather (count 1)."""
        mult_b = max(self.cfg.counts_multiple_of // self.cfg.kv_block, 1)
        inds, counts = indexing.mask_to_indices_limited(mask, mult_b,
                                                        self.jmax)
        counts = counts.clamp(1, self.jmax)
        if self.dense_tail_g is not None:
            counts[..., self.dense_tail_g:] = 1
        return inds, counts

    def _stored_inds(self, state: AttnState
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The stored selection; packed-only states rebuild it."""
        if not self.cfg.should_compress_indices or self.materialized:
            return state.inds, state.counts
        nb = self.seq_len // self.cfg.kv_block
        return self._mask_to_inds(bitunpack_rows(state.packed, nb))

    def _store_selection(self, state: AttnState, mask, inds, counts
                         ) -> AttnState:
        if not self.cfg.should_compress_indices:
            return state._replace(inds=inds, counts=counts)
        state = state._replace(packed=bitpack_rows(mask))
        if self.materialized:
            state = state._replace(inds=inds, counts=counts)
        return state

    def _delta_cache(self, o, o_sp, state: AttnState) -> torch.Tensor:
        return fp8.cast(o - o_sp, state.out_cache.dtype)

    # -------------------------------------------------------------- steps
    def dense_step(self, q, k, v):
        return self._dense(q, k, v)[0]

    def full_step_first(self, q, k, v, state: AttnState
                        ) -> Tuple[torch.Tensor, AttnState]:
        o, lse = self._dense(q, k, v)
        return o, state._replace(lse=lse)

    def full_step_colsum(self, q, k, v, state: AttnState,
                         keep_mask: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> Tuple[torch.Tensor, AttnState]:
        o, cs, lse = self._colsum(q, k, v, state.lse)
        with span('attn.select'):
            mask = self._select_mask(cs, keep_mask, generator)
            inds, counts = self._mask_to_inds(mask)
            state = self._store_selection(state, mask, inds, counts)
        o_sp = self._csp(q, k, v, inds, counts)
        return o, state._replace(out_cache=self._delta_cache(o, o_sp, state),
                                 lse=lse)

    def full_step_plain(self, q, k, v, state: AttnState
                        ) -> Tuple[torch.Tensor, AttnState]:
        o, lse = self._dense(q, k, v)
        o_sp = self._csp(q, k, v, *self._stored_inds(state))
        return o, state._replace(out_cache=self._delta_cache(o, o_sp, state),
                                 lse=lse)

    def sparse_step(self, q, k, v, state: AttnState
                    ) -> Tuple[torch.Tensor, AttnState]:
        o_sp = self._csp(q, k, v, *self._stored_inds(state))
        o = (state.out_cache.float() + o_sp.float()).to(q.dtype)
        if self.dense_tail_g is not None:
            # the text rows: an exact dense recompute, no delta cache
            t0 = self.dense_tail_g * self.cfg.mbm
            o[..., t0:, :] = self._dense_raw(q[..., t0:, :], k, v)[0]
        return o, state

    # ------------------------------------------------------------ frontend
    def __call__(self, q, k, v, state: AttnState, *, step_index: int,
                 is_full: bool, is_colsum: bool, layer_is_dense: bool,
                 keep_mask: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, AttnState]:
        """keep_mask / generator: the random keep of a colsum step with
        compressed indices (injected, or drawn from the generator)."""
        with span('attn'):
            if not self.cfg.is_enabled or layer_is_dense or self.fully_dense:
                return self.dense_step(q, k, v), state
            if is_full:
                if step_index == 0:
                    return self.full_step_first(q, k, v, state)
                if is_colsum:
                    return self.full_step_colsum(q, k, v, state, keep_mask,
                                                 generator)
                return self.full_step_plain(q, k, v, state)
            return self.sparse_step(q, k, v, state)

    def init_state(self, B: int, H: int, D: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device: DeviceLike = 'cuda') -> Optional[AttnState]:
        """None where the module never touches its caches."""
        if not self.cfg.is_enabled or self.fully_dense:
            return None
        return init_attn_state(B, H, self.seq_len, D, self.jmax, dtype,
                               fp8.dtype_from_name(self.cfg.out_cache_dtype),
                               device, kv_block=self.cfg.kv_block,
                               compress=self.cfg.should_compress_indices,
                               materialize=self.materialized)
