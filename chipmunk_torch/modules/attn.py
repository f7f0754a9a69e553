"""Sparse delta attention (torch), the counterpart of
``chipmunk_tpu/modules/attn.py`` for the FLUX path.

A static-config object whose step methods take and return an explicit
``AttnState``:
  step 0            -> dense, store lse
  full+colsum steps -> dense_colsum_attn, top-k block mask, store indices,
                       cache = o - csp(...)
  full plain steps  -> dense, refresh cache with the stored indices
  sparse steps      -> out = cache + csp(...)
  dense layers      -> dense always

Only the uncompressed-index path without a static mask is ported;
``should_compress_indices``, a static mask (and with it the dense tail)
and ``valid_len`` raise ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from .. import kernels
from ..config import AttnConfig
from ..device import DeviceLike, resolve_device
from ..ops import fp8, indexing
from ..ops.attn_ref import PAD_LSE


class AttnState(NamedTuple):
    """Per-layer attention caches."""
    out_cache: torch.Tensor   # [B,H,S,D]
    lse: torch.Tensor         # [B,H,S] fp32, log2 domain
    inds: torch.Tensor        # [B,H,G,jmax] int32 kv-block ids
    counts: torch.Tensor      # [B,H,G] int32


def init_attn_state(B: int, H: int, S: int, D: int, jmax: int,
                    dtype: torch.dtype = torch.bfloat16,
                    out_cache_dtype: Optional[torch.dtype] = None,
                    device: DeviceLike = 'cuda') -> AttnState:
    dev = resolve_device(device)
    G = S // 128
    return AttnState(
        out_cache=torch.zeros((B, H, S, D), dtype=out_cache_dtype or dtype,
                              device=dev),
        lse=torch.full((B, H, S), PAD_LSE, dtype=torch.float32, device=dev),
        inds=torch.zeros((B, H, G, jmax), dtype=torch.int32, device=dev),
        counts=torch.ones((B, H, G), dtype=torch.int32, device=dev))


@dataclass(frozen=True)
class SparseDiffAttn:
    """Static per-model attention sparsity config + step methods."""
    cfg: AttnConfig
    seq_len: int            # Sq == Sk
    jmax: int               # max selected kv blocks per query group
    sel_blocks: int         # top-k in kv blocks
    fully_dense: bool = False   # cost gate: run the layer dense every step

    @staticmethod
    def build(cfg: AttnConfig, seq_len: int, static_mask_tokens=None,
              valid_len: Optional[int] = None) -> "SparseDiffAttn":
        if cfg.should_compress_indices:
            raise NotImplementedError('attn.should_compress_indices is not '
                                      'ported yet')
        if static_mask_tokens is not None:
            raise NotImplementedError('static attention masks (and the '
                                      'dense tail) are not ported yet')
        if valid_len is not None and valid_len < seq_len:
            raise NotImplementedError('valid_len is not ported yet')
        if seq_len % cfg.mbm or seq_len % cfg.kv_block:
            raise ValueError(f'seq_len {seq_len} must be a multiple of '
                             f'attn.mbm {cfg.mbm} and attn.kv_block '
                             f'{cfg.kv_block}')
        nb = seq_len // cfg.kv_block
        mult_b = max(cfg.counts_multiple_of // cfg.kv_block, 1)
        sel_blocks = int(round(cfg.top_keys * seq_len / cfg.counts_multiple_of)
                         * cfg.counts_multiple_of) // cfg.kv_block
        sel_blocks = max(min(sel_blocks, nb), 0)
        # capacity = top-k, capped by max_selected_frac (no random margin
        # on the uncompressed path)
        cap = nb if cfg.max_selected_frac >= 1.0 else int(
            nb * cfg.max_selected_frac)
        jmax = max(min(sel_blocks, cap, nb), 1)
        jmax = min(-(-jmax // mult_b) * mult_b, nb)
        fully_dense = (cfg.dense_fallback_frac < 1.0
                       and jmax >= nb * cfg.dense_fallback_frac)
        return SparseDiffAttn(cfg=cfg, seq_len=seq_len, jmax=jmax,
                              sel_blocks=sel_blocks, fully_dense=fully_dense)

    # ---------------------------------------------------------------- ops
    def _dense(self, q, k, v):
        return kernels.dense_attn(q, k, v)

    def _colsum(self, q, k, v, prev_lse):
        return kernels.dense_colsum_attn(q, k, v, prev_lse, qg=self.cfg.mbm,
                                         score_block=self.cfg.kv_block)

    def _csp(self, q, k, v, inds, counts):
        return kernels.csp_attn(q, k, v, inds, counts, qg=self.cfg.mbm,
                                kv_block=self.cfg.kv_block)

    def _select_mask(self, colsums: torch.Tensor) -> torch.Tensor:
        """Plain top-k of the block column sums (the uncompressed path)."""
        return indexing.topk_mask(colsums, self.sel_blocks)

    def _mask_to_inds(self, mask: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        mult_b = max(self.cfg.counts_multiple_of // self.cfg.kv_block, 1)
        inds, counts = indexing.mask_to_indices_limited(mask, mult_b,
                                                        self.jmax)
        return inds, counts.clamp(1, self.jmax)

    def _delta_cache(self, o, o_sp, state: AttnState) -> torch.Tensor:
        return fp8.cast(o - o_sp, state.out_cache.dtype)

    # -------------------------------------------------------------- steps
    def dense_step(self, q, k, v):
        return self._dense(q, k, v)[0]

    def full_step_first(self, q, k, v, state: AttnState
                        ) -> Tuple[torch.Tensor, AttnState]:
        o, lse = self._dense(q, k, v)
        return o, state._replace(lse=lse)

    def full_step_colsum(self, q, k, v, state: AttnState
                         ) -> Tuple[torch.Tensor, AttnState]:
        o, cs, lse = self._colsum(q, k, v, state.lse)
        inds, counts = self._mask_to_inds(self._select_mask(cs))
        o_sp = self._csp(q, k, v, inds, counts)
        return o, state._replace(out_cache=self._delta_cache(o, o_sp, state),
                                 lse=lse, inds=inds, counts=counts)

    def full_step_plain(self, q, k, v, state: AttnState
                        ) -> Tuple[torch.Tensor, AttnState]:
        o, lse = self._dense(q, k, v)
        o_sp = self._csp(q, k, v, state.inds, state.counts)
        return o, state._replace(out_cache=self._delta_cache(o, o_sp, state),
                                 lse=lse)

    def sparse_step(self, q, k, v, state: AttnState
                    ) -> Tuple[torch.Tensor, AttnState]:
        o_sp = self._csp(q, k, v, state.inds, state.counts)
        o = (state.out_cache.float() + o_sp.float()).to(q.dtype)
        return o, state

    # ------------------------------------------------------------ frontend
    def __call__(self, q, k, v, state: AttnState, *, step_index: int,
                 is_full: bool, is_colsum: bool, layer_is_dense: bool
                 ) -> Tuple[torch.Tensor, AttnState]:
        if not self.cfg.is_enabled or layer_is_dense or self.fully_dense:
            return self.dense_step(q, k, v), state
        if is_full:
            if step_index == 0:
                return self.full_step_first(q, k, v, state)
            if is_colsum:
                return self.full_step_colsum(q, k, v, state)
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
                               device)
