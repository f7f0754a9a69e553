"""Sparse delta MLP (torch), the counterpart of
``chipmunk_tpu/modules/mlp.py``.  Weights are tensors or QTensors
(``utils/quant.py``): dense products dequantize them in x's dtype, the
sparse step hands them to the kernels as they are.

  full steps   -> dense fc1/act/fc2; cache the post-activations, the output
                  and the block means of the pre-activations
  sparse steps -> optionally re-select neuron blocks from
                  |fc1(block_mean(x)) - bm_mid| (top-k + Bernoulli keep),
                  then the sparse-delta kernel: recompute the selected
                  neurons, delta against the cache, out_cache += delta @ fc2

Caches are token-major; weights are w1t/w2 [N, C].  The random keep mask
comes from a ``torch.Generator`` or is injected (``keep_mask``), so a test
can feed the mask the reference drew.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from .. import kernels
from ..config import MlpConfig
from ..device import DeviceLike, resolve_device
from ..kernels.csp_mlp import gelu_tanh
from ..ops import fp8, indexing
from ..ops.mlp_ref import block_mean
from ..utils.profiling import span
from ..utils.quant import QTensor, materialize
from .mlp_fp8 import f8_input_matmul

_SAID = set()      # the int8_act message, once per weight type


def _fc1(cfg: MlpConfig, x, w1t, b1):
    """fc1 = x @ w1t^T + b1; under ``mlp.is_fp8`` with an fp8 QTensor
    weight, x is quantized per call and the product runs fp8 x fp8
    (``mlp_fp8.f8_input_matmul``).  fc2 stays in x's dtype, as the
    reference keeps the sparse MLP's second product."""
    if cfg.is_fp8 and isinstance(w1t, QTensor) and w1t.q.dtype == fp8.FP8:
        return f8_input_matmul(x, w1t, b1, out_dtype=x.dtype)
    return x @ materialize(w1t, x.dtype).t() + b1.to(x.dtype)


def _int8_weights(w1t, w2) -> bool:
    """The reference's condition for int8 activations: both weights are
    int8 or int4-packed QTensors (``modules/mlp.py:169-171``)."""
    return all(isinstance(w, QTensor)
               and (w.pack_axis is not None or w.q.dtype == torch.int8)
               for w in (w1t, w2))


class MlpState(NamedTuple):
    """Per-layer MLP caches."""
    out_cache: torch.Tensor   # [T, C]
    act_cache: torch.Tensor   # [T, N] post-activations
    bm_mid: torch.Tensor      # [T//mbm, N] block-mean pre-activations
    inds: torch.Tensor        # [M, jmax] int32 neuron-block ids
    counts: torch.Tensor      # [M] int32


@dataclass(frozen=True)
class SparseDiffMlp:
    cfg: MlpConfig
    n_tokens: int            # T (padded to bm)
    d_model: int             # C
    d_hidden: int            # N
    jmax: int                # max selected neuron blocks per token block
    sel_blocks: int          # top-k in neuron blocks

    @staticmethod
    def build(cfg: MlpConfig, n_tokens: int, d_model: int, d_hidden: int
              ) -> "SparseDiffMlp":
        n_tokens = -(-n_tokens // cfg.bm) * cfg.bm
        if d_hidden % cfg.neuron_block:
            raise ValueError(f'MLP width {d_hidden} must be a multiple of '
                             f'mlp.neuron_block {cfg.neuron_block}')
        nb = d_hidden // cfg.neuron_block
        sel = int(round(cfg.top_keys * d_hidden / cfg.counts_multiple_of)
                  * cfg.counts_multiple_of) // cfg.neuron_block
        sel = max(min(sel, nb), 1)
        cap = nb if cfg.max_selected_frac >= 1.0 else int(
            nb * cfg.max_selected_frac)
        mult_b = max(cfg.counts_multiple_of // cfg.neuron_block, 1)
        rand_margin = (max(8, int(3 * cfg.random_keys * nb))
                       if cfg.random_keys > 0 else 0)
        jmax = max(min(sel + rand_margin, cap, nb), 1)
        jmax = min(-(-jmax // mult_b) * mult_b, nb)
        return SparseDiffMlp(cfg=cfg, n_tokens=n_tokens, d_model=d_model,
                             d_hidden=d_hidden, jmax=jmax, sel_blocks=sel)

    # ---------------------------------------------------------------- steps
    def dense(self, x, w1t, b1, w2, b2):
        """x: [T, C]; w1t, w2: [N, C] (tensors or QTensors)."""
        mid = _fc1(self.cfg, x, w1t, b1)
        return (gelu_tanh(mid.float()).to(x.dtype) @ materialize(w2, x.dtype)
                + b2.to(x.dtype))

    def _pad(self, x):
        t = x.shape[0]
        if t == self.n_tokens:
            return x, t
        return torch.nn.functional.pad(x, (0, 0, 0, self.n_tokens - t)), t

    def full_step(self, x, w1t, b1, w2, b2, state: MlpState
                  ) -> Tuple[torch.Tensor, MlpState]:
        x, t = self._pad(x)
        mid = _fc1(self.cfg, x, w1t, b1)
        pa = gelu_tanh(mid.float()).to(x.dtype)
        out = pa @ materialize(w2, x.dtype) + b2.to(x.dtype)
        return out[:t], state._replace(
            out_cache=fp8.cast(out, state.out_cache.dtype),
            act_cache=fp8.cast(pa, state.act_cache.dtype),
            bm_mid=block_mean(mid[None], self.cfg.mbm)[0].to(
                state.bm_mid.dtype))

    def _recompute_indices(self, x, w1t, b1, state: MlpState,
                           keep_mask: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> MlpState:
        """Re-select neuron blocks; refresh bm_mid only at the blocks that
        survive the jmax truncation (a refreshed block the kernel does not
        recompute would lose its score while its act cache stays stale).
        keep_mask: optional bool [M, N/neuron_block] random keep, used in
        place of the draw from ``generator``."""
        with span('mlp.select'):
            mbm, bm, bn = self.cfg.mbm, self.cfg.bm, self.cfg.neuron_block
            bmx = block_mean(x[None], mbm)[0]                   # [Mb, C]
            bmfc1 = _fc1(self.cfg, bmx, w1t, b1)                # [Mb, N]
            mdiff = (bmfc1 - state.bm_mid).float().abs()
            r = bm // mbm
            Mb = mdiff.shape[0]
            mdiff = mdiff.reshape(Mb // r, r, -1).sum(1)         # [M, N]
            scores = indexing.blockify_scores(mdiff, bn)
            mask = indexing.topk_mask(scores, self.sel_blocks)
            if self.cfg.random_keys > 0:
                if keep_mask is None:
                    if generator is None:
                        raise ValueError('mlp.random_keys > 0 needs a '
                                         'generator or an injected '
                                         'keep_mask')
                    keep_mask = torch.rand(mask.shape, generator=generator,
                                           device=mask.device) \
                        < self.cfg.random_keys
                mask = mask | keep_mask.to(mask.device)
            mult_b = max(self.cfg.counts_multiple_of // bn, 1)
            inds, counts = indexing.mask_to_indices_limited(mask, mult_b,
                                                            self.jmax)
            counts = counts.clamp(1, self.jmax)
            M, nb = mask.shape
            valid = torch.arange(self.jmax, device=mask.device) \
                < counts[:, None]
            surv = torch.zeros((M, nb + 1), dtype=torch.bool,
                               device=mask.device)
            surv.scatter_(1, torch.where(valid, inds.long(), nb), True)
            surv = surv[:, :nb] & mask      # round-up padding ids are unmasked
            sel_tok = surv.repeat_interleave(bn, -1).repeat_interleave(r, 0)
            bm_mid = indexing.copy_indices(bmfc1, state.bm_mid, sel_tok)
            return state._replace(inds=inds, counts=counts, bm_mid=bm_mid)

    def sparse_step(self, x, w1t, b1, w2, state: MlpState, *,
                    recompute: bool, keep_mask: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, MlpState]:
        x, t = self._pad(x)
        if recompute:
            state = self._recompute_indices(x, w1t, b1, state, keep_mask,
                                            generator)
        a8 = self.cfg.int8_act
        if a8 and not _int8_weights(w1t, w2):
            # as the reference: without int8/int4 weights there is nothing
            # to pair int8 activations with, so the bf16 kernels run
            kind = type(w1t).__name__
            if kind not in _SAID:
                _SAID.add(kind)
                print(f"chipmunk: mlp.int8_act ignored - MLP weights are "
                      f"{kind}, not int8/int4 QTensor (quantized residency)")
            a8 = False
        new_out, new_act = kernels.csp_mlp(
            x, w1t, b1, w2, state.act_cache, state.out_cache, state.inds,
            state.counts, bn=self.cfg.neuron_block, bm=self.cfg.bm, a8=a8)
        return new_out[:t].to(x.dtype), state._replace(out_cache=new_out,
                                                       act_cache=new_act)

    # ------------------------------------------------------------ frontend
    def __call__(self, x, w1t, b1, w2, b2, state: MlpState, *,
                 is_full: bool, recompute_mask: bool, layer_is_dense: bool,
                 keep_mask: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, MlpState]:
        with span('mlp'):
            if not self.cfg.is_enabled or layer_is_dense:
                return self.dense(x, w1t, b1, w2, b2), state
            if is_full:
                return self.full_step(x, w1t, b1, w2, b2, state)
            return self.sparse_step(x, w1t, b1, w2, state,
                                    recompute=recompute_mask,
                                    keep_mask=keep_mask, generator=generator)

    def init_state(self, dtype: torch.dtype = torch.bfloat16,
                   device: DeviceLike = 'cuda') -> Optional[MlpState]:
        """None where the module never touches its caches."""
        if not self.cfg.is_enabled:
            return None
        dev = resolve_device(device)
        T, C, N = self.n_tokens, self.d_model, self.d_hidden
        act_dt = fp8.dtype_from_name(self.cfg.act_cache_dtype) or dtype
        out_dt = fp8.dtype_from_name(self.cfg.out_cache_dtype) or dtype
        return MlpState(
            out_cache=torch.zeros((T, C), dtype=out_dt, device=dev),
            act_cache=torch.zeros((T, N), dtype=act_dt, device=dev),
            bm_mid=torch.zeros((T // self.cfg.mbm, N), dtype=dtype,
                               device=dev),
            inds=torch.zeros((T // self.cfg.bm, self.jmax), dtype=torch.int32,
                             device=dev),
            counts=torch.ones((T // self.cfg.bm,), dtype=torch.int32,
                              device=dev))
