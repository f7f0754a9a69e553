"""Host-offloaded, layer-chunked FLUX-core forward (torch), the
counterpart of ``chipmunk_tpu/models/streamed.py`` and of the reference's
per-layer cache offload (its PIPELINE_DEPTH=2 window of device slots,
async copies on dedicated streams).

The per-layer caches that the policy names live in host memory (page-
locked on the card) between steps, in chunks of consecutive layers; the
runner fetches the next chunk while one computes and writes each chunk's
updated caches back, only for the families that the step kind mutates.
Caches the policy keeps on the device stay there in the same chunks.
Device residency of the host-side caches drops from all layers to
``resident_chunks`` plus the prefetch window, which is what lets
HunyuanVideo's 44 GB of attention caches at 720p leave room on one card.

Correctness contract: a streamed run equals the resident ``flux_forward``
bit for bit: the same block calls in the same order, with the global
layer index and the one generator.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..modules import AttnState, MlpState
from ..utils.offload import (OffloadPolicy, Pending, offload_to_host,
                             pinned_bytes, start_fetch, tree_map)
from ..utils.streaming import chunk_tree, unchunk_tree
from .flux import (FluxModelConfig, FluxSparse, FluxState, FluxStep,
                   double_block, flux_embed, flux_final, single_block)

_NO_ATTN = AttnState(*(False,) * len(AttnState._fields))
_NO_MLP = MlpState(*(False,) * len(MlpState._fields))


def _host_flags(policy: OffloadPolicy) -> Tuple[AttnState, MlpState]:
    """Per-field host placement of a layer's (AttnState, MlpState).
    ``packed`` follows attn_indices: it is the compressed index storage."""
    a = AttnState(out_cache=policy.wants_host('attn_out_cache'),
                  lse=policy.wants_host('attn_lse'),
                  inds=policy.wants_host('attn_indices'),
                  counts=policy.wants_host('attn_counts'),
                  packed=policy.wants_host('attn_indices'))
    m = MlpState(out_cache=policy.wants_host('mlp_out_cache'),
                 act_cache=policy.wants_host('mlp_act_cache'),
                 bm_mid=policy.wants_host('mlp_bm_mid'),
                 inds=policy.wants_host('mlp_indices'),
                 counts=policy.wants_host('mlp_counts'))
    return (a, m)


def _flags_of(chunk: List, flags) -> List:
    """``flags`` (one layer's) for every layer of a chunk."""
    return [flags] * len(chunk)


def _placed_flags(chunk: List, flags, to_host: bool, device, out=None):
    """Move the flagged leaves of a chunk host-side (D2H, into ``out``'s
    host buffers when given) or start their fetch to ``device`` (H2D,
    returns a Pending); other leaves pass as they are."""
    where = _flags_of(chunk, flags)
    if to_host:
        return offload_to_host(chunk, out=out, where=where)
    return start_fetch(chunk, device, where)


def _placed(chunk: List, policy: OffloadPolicy, to_host: bool, device,
            out=None):
    return _placed_flags(chunk, _host_flags(policy), to_host, device, out)


def _retain(old_chunk: List, new_chunk: List, flags) -> List:
    """Keep the still-valid host copies of the flagged leaves (no D2H) and
    take the new values of the others: in a streamed chunk a flagged leaf
    is always a host buffer."""
    return tree_map(lambda old, new, f: old if f else new, old_chunk,
                    new_chunk, _flags_of(old_chunk, flags))


@dataclass
class StreamedFluxState:
    """A FluxState as chunks of consecutive layers, each layer an
    (AttnState, MlpState) pair (None for a module without caches), with
    the policy's leaves in host memory between steps."""
    double: List[List]
    single: List[List]
    policy: OffloadPolicy
    device: torch.device
    # per stage: chunk index -> its fetch in flight, or a resident chunk
    window: Dict = field(default_factory=dict, repr=False)

    @staticmethod
    def create(state: FluxState, n_chunks_double: int, n_chunks_single: int,
               policy: OffloadPolicy, device: DeviceLike = 'cuda'
               ) -> "StreamedFluxState":
        """Chunk a resident FluxState and move its policy leaves host-side
        (one host slab for all); the device leaves are taken as they are."""
        dbl = chunk_tree(list(zip(state.double_attn, state.double_mlp)),
                     n_chunks_double)
        sgl = chunk_tree(list(zip(state.single_attn, state.single_mlp)),
                     n_chunks_single)
        flags = _host_flags(policy)
        dbl, sgl = offload_to_host(
            [dbl, sgl], where=[[_flags_of(c, flags) for c in dbl],
                               [_flags_of(c, flags) for c in sgl]])
        return StreamedFluxState(double=dbl, single=sgl, policy=policy,
                                 device=resolve_device(device))

    @staticmethod
    def create_hostwise(sp: FluxSparse, model_cfg: FluxModelConfig, B: int,
                        n_chunks_double: int, n_chunks_single: int,
                        policy: OffloadPolicy, device: DeviceLike = 'cuda'
                        ) -> "StreamedFluxState":
        """The chunked init state without ever building the whole
        device-resident FluxState (a full-depth video model's caches
        exceed the card, which is why streaming exists): one layer's init
        values per stage on the device, copied into every layer's host
        buffers (one slab), and a copy of them per layer for the leaves
        that stay on the device."""
        dev = resolve_device(device)
        H, D, dt = model_cfg.num_heads, model_cfg.head_dim, model_cfg.dtype
        flags = _host_flags(policy)

        def build(depth, attn, mlp):
            init = (attn.init_state(B, H, D, dt, dev), mlp.init_state(dt, dev))
            # device leaves: a copy a layer; host leaves: the shared init,
            # copied into each layer's buffer below
            return [tree_map(lambda x, f: x if f else x.clone(), init, flags)
                    for _ in range(depth)]

        dbl = build(model_cfg.depth, sp.attn_d, sp.mlp_d)
        sgl = build(model_cfg.depth_single_blocks, sp.attn_s, sp.mlp_s)
        dbl, sgl = offload_to_host(
            [dbl, sgl], where=[_flags_of(dbl, flags), _flags_of(sgl, flags)])
        return StreamedFluxState(double=chunk_tree(dbl, n_chunks_double),
                                 single=chunk_tree(sgl, n_chunks_single),
                                 policy=policy, device=dev)

    def gather(self) -> FluxState:
        """A device-resident FluxState of the current caches (tests,
        checkpoints)."""
        def cat(chunks):
            layers = unchunk_tree(
                [_placed(c, self.policy, False, self.device).wait()
                 for c in chunks])
            return [a for a, _ in layers], [m for _, m in layers]
        da, dm = cat(self.double)
        sa, sm = cat(self.single)
        return FluxState(double_attn=da, double_mlp=dm, single_attn=sa,
                         single_mlp=sm)

    def host_bytes(self) -> int:
        """Bytes of host memory that the state's buffers lie in (page-
        locked on the card)."""
        return pinned_bytes([self.double, self.single])


@dataclass
class StreamedFluxRunner:
    """The layer loop of ``flux_forward`` over a StreamedFluxState: chunks
    [0, resident_chunks) of each stage stay on the device across steps
    (their round trip would be latency on every step, for 1/n of the
    caches); the others stream through a window of ``prefetch_depth``
    chunks."""
    cfg: FluxModelConfig
    sp: FluxSparse
    prefetch_depth: int = 2
    resident_chunks: int = 1

    def forward(self, params: Dict, st: StreamedFluxState, img, txt,
                timesteps, y, pe, step: FluxStep, guidance=None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """The streamed ``flux_forward``: mutates ``st``'s chunks and
        returns the prediction."""
        cfg, sp = self.cfg, self.sp
        img, txt, vec = flux_embed(params, cfg, img, txt, timesteps, y,
                                   guidance)
        cos, sin = pe
        fa, fm = _host_flags(st.policy)
        # What can this step kind mutate?  Attention caches change only on
        # full steps (a sparse step reads out_cache and the selection);
        # MLP caches on every computed step where the MLP is on.  An
        # unmutated family keeps its host copy and issues no D2H.
        store = {stage: (fa if step.full_attn and attn.cfg.is_enabled
                         else _NO_ATTN,
                         fm if mlp.cfg.is_enabled else _NO_MLP)
                 for stage, attn, mlp in (('double', sp.attn_d, sp.mlp_d),
                                          ('single', sp.attn_s, sp.mlp_s))}

        def run_stage(chunks, stage, io):
            n = len(chunks)
            res = min(self.resident_chunks, n - 1) if n > 1 else n
            per = len(chunks[0])
            window = st.window.setdefault(stage, {})
            for j in range(min(self.prefetch_depth, n)):
                if j not in window:
                    window[j] = _placed(chunks[j], st.policy, False,
                                        st.device)
            for i in range(n):
                dev_chunk = window.pop(i).wait()
                nxt = i + self.prefetch_depth - 1
                if nxt < n and nxt not in window:
                    window[nxt] = _placed(chunks[nxt], st.policy, False,
                                          st.device)
                new_chunk = []
                for j, (a, m) in enumerate(dev_chunk):
                    idx = i * per + j           # the global layer index
                    if stage == 'double':
                        img_, txt_, a, m = double_block(
                            cfg, sp, params['double'][idx], *io, vec, cos,
                            sin, a, m, idx, step, generator)
                        io = (img_, txt_)
                    else:
                        x, a, m = single_block(
                            cfg, sp, params['single'][idx], io, vec, cos,
                            sin, a, m, idx, step, generator)
                        io = x
                    new_chunk.append((a, m))
                if i < res:
                    chunks[i] = new_chunk
                    window[i] = Pending(new_chunk)
                else:
                    stored = _placed_flags(new_chunk, store[stage], True,
                                           st.device, out=chunks[i])
                    chunks[i] = _retain(chunks[i], stored, (fa, fm))
            return io

        img, txt = run_stage(st.double, 'double', (img, txt))
        x = torch.cat([txt, img] if cfg.txt_first else [img, txt], 1)
        x = run_stage(st.single, 'single', x)
        return flux_final(params, cfg, x, vec)
