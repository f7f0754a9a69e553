"""FLUX-architecture DiT with chipmunk sparsity (torch), the counterpart
of ``chipmunk_tpu/models/flux.py``.

Params are a dict whose ``double``/``single`` entries are lists of
per-layer dicts (the reference stacks them along a leading layer axis and
scans; here a Python loop walks the layers and their per-layer states).
Double blocks run SparseDiffAttn on the joint sequence -- [txt, img] for
FLUX, [img, txt] with ``txt_first=False`` as HunyuanVideo has it -- and
SparseDiffMlp on the image MLP; single blocks keep linear1/linear2 split
into qkv/fc1 and o_proj/fc2.  txt_len and S must be multiples of 128.
The forward's ``generator`` draws every random keep (attention, with
compressed indices, and MLP).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ChipmunkConfig
from ..device import DeviceLike, resolve_device
from ..kernels.csp_mlp import gelu_tanh
from ..kernels.qkv_prologue import QkvStream, qkv_prologue
from ..modules import AttnState, MlpState, SparseDiffAttn, SparseDiffMlp
from ..schedule import StepKind
from ..utils.profiling import span
from ..utils.quant import QTensor, materialize
from .layers import (layernorm, linear, mlp_embedder, modulation,
                     timestep_embedding)


@dataclass(frozen=True)
class FluxModelConfig:
    in_channels: int = 64
    vec_in_dim: int = 768
    context_in_dim: int = 4096
    hidden_size: int = 3072
    num_heads: int = 24
    mlp_ratio: float = 4.0
    depth: int = 19            # double blocks
    depth_single_blocks: int = 38
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    theta: int = 10_000
    qkv_bias: bool = True
    guidance_embed: bool = True
    txt_len: int = 512
    # sequence order: FLUX concatenates [txt, img]; HunyuanVideo [img, txt]
    txt_first: bool = True
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def mlp_hidden(self):
        return int(self.hidden_size * self.mlp_ratio)


# ------------------------------------------------------------------ params

def _flux_tree(cfg: FluxModelConfig, normal: Callable, zeros: Callable,
               ones: Callable, n_double: int, n_single: int) -> Dict:
    """The FLUX param tree built from leaf makers normal(*shape, scale=),
    zeros(n), ones(n), with n_double/n_single per-layer dicts."""
    h, mh = cfg.hidden_size, cfg.mlp_hidden

    def lin(d_in, d_out, bias=True):
        p = {'w': normal(d_in, d_out, scale=d_in ** -0.5)}
        if bias:
            p['b'] = zeros(d_out)
        return p

    def embedder(d_in):
        return {'in': lin(d_in, h), 'out': lin(h, h)}

    def dbl():
        p = {'img_mod': lin(h, 6 * h), 'txt_mod': lin(h, 6 * h),
             'img_qkv': lin(h, 3 * h, cfg.qkv_bias),
             'txt_qkv': lin(h, 3 * h, cfg.qkv_bias),
             'img_proj': lin(h, h), 'txt_proj': lin(h, h)}
        for n in ('img_qnorm', 'img_knorm', 'txt_qnorm', 'txt_knorm'):
            p[n] = ones(cfg.head_dim)
        for s in ('img', 'txt'):
            # MLP weights output-major ([N, C]) for the sparse kernels
            p[f'{s}_w1t'] = normal(mh, h, scale=h ** -0.5)
            p[f'{s}_b1'] = zeros(mh)
            p[f'{s}_w2'] = normal(mh, h, scale=mh ** -0.5)
            p[f'{s}_b2'] = zeros(h)
        return p

    def sgl():
        return {'mod': lin(h, 3 * h), 'qkv': lin(h, 3 * h),
                'w1t': normal(mh, h, scale=h ** -0.5), 'b1': zeros(mh),
                'o_proj': lin(h, h), 'w2': normal(mh, h, scale=mh ** -0.5),
                'qnorm': ones(cfg.head_dim), 'knorm': ones(cfg.head_dim)}

    params = {
        'img_in': lin(cfg.in_channels, h),
        'txt_in': lin(cfg.context_in_dim, h),
        'time_in': embedder(256),
        'vector_in': embedder(cfg.vec_in_dim),
        'double': [dbl() for _ in range(n_double)],
        'single': [sgl() for _ in range(n_single)],
        'final_mod': lin(h, 2 * h),
        'final_proj': lin(h, cfg.in_channels),
    }
    if cfg.guidance_embed:
        params['guidance_in'] = embedder(256)
    return params


def init_flux_params(generator: torch.Generator, cfg: FluxModelConfig,
                     device: DeviceLike = 'cuda') -> Dict:
    """Random weights with the reference's shapes and scales (normal /
    sqrt(d_in), zero biases, unit norms), drawn from ``generator`` (which
    must live on ``device``)."""
    dev, dt = resolve_device(device), cfg.dtype

    def normal(*shape, scale):
        return (torch.randn(shape, generator=generator, device=dev)
                * scale).to(dt)

    return _flux_tree(cfg, normal,
                      lambda n: torch.zeros(n, dtype=dt, device=dev),
                      lambda n: torch.ones(n, dtype=dt, device=dev),
                      cfg.depth, cfg.depth_single_blocks)


def flux_param_shapes(cfg: FluxModelConfig) -> Dict:
    """The reference's param tree as shapes: ``double``/``single`` stacked
    along a leading layer axis ([L, ...]), as ``jax.eval_shape`` of its
    ``init_flux_params`` gives them."""
    tree = _flux_tree(cfg, lambda *s, scale: s, lambda n: (n,),
                      lambda n: (n,), 1, 1)

    def stack(t, n):
        return ({k: stack(v, n) for k, v in t.items()}
                if isinstance(t, dict) else (n,) + t)

    return dict(tree, double=stack(tree['double'][0], cfg.depth),
                single=stack(tree['single'][0], cfg.depth_single_blocks))


def _np_to_torch(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    name = a.dtype.name
    if name == 'bfloat16':
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    elif name == 'float8_e4m3fn':
        t = torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_jax(np_params: Dict, device: DeviceLike = 'cuda') -> Dict:
    """The reference's FLUX, HunyuanVideo, Wan or UMT5 param tree (numpy
    arrays, e.g. via ``jax.tree_util.tree_map(np.asarray, params)``) as
    the port's params.  The layouts are the same, so this copies leaves
    and splits the stacked ``[L, ...]`` top-level ``double``/``single``/
    ``blocks`` subtrees into lists of per-layer dicts.
    Quantized leaves (anything with ``q``/``scale``/``pack_axis``, as the
    reference's QTensor has) become the port's QTensor, with ``q`` and
    ``scale`` split per layer and ``pack_axis`` kept.  Lists (the
    HunyuanVideo text refiner's ``blocks``) stay lists."""
    dev = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [conv(v) for v in tree]
        if all(hasattr(tree, a) for a in ('q', 'scale', 'pack_axis')):
            return QTensor(_np_to_torch(tree.q, dev),
                           _np_to_torch(tree.scale, dev), tree.pack_axis)
        return _np_to_torch(tree, dev)

    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        if isinstance(tree, QTensor):
            return QTensor(tree.q[i], tree.scale[i], tree.pack_axis)
        return tree[i]

    def n_layers(tree):
        v = next(iter(tree.values()))
        if isinstance(v, dict):
            return n_layers(v)
        return (v.q if isinstance(v, QTensor) else v).shape[0]

    out = {}
    for k, v in np_params.items():
        out[k] = conv(v)
        if k in ('double', 'single', 'blocks'):
            out[k] = [layer(out[k], i) for i in range(n_layers(out[k]))]
    return out


# ------------------------------------------------------------------- state

class FluxState(NamedTuple):
    """Chipmunk caches for one model invocation, one entry per layer (None
    for a module that never touches its caches)."""
    double_attn: List[Optional[AttnState]]
    double_mlp: List[Optional[MlpState]]
    single_attn: List[Optional[AttnState]]
    single_mlp: List[Optional[MlpState]]


@dataclass(frozen=True)
class FluxSparse:
    """Static sparsity context: the module configs + per-layer dense flags,
    and with ``with_ulysses`` the token shards of this rank."""
    attn_d: SparseDiffAttn      # double-block attention (joint sequence)
    mlp_d: Optional[SparseDiffMlp]  # double-block image MLP (None: a
    #                                 rank that holds none of its rows)
    attn_s: SparseDiffAttn      # single-block attention
    mlp_s: Optional[SparseDiffMlp]  # single-block full-sequence MLP
    n_dense_attn_double: int
    n_dense_attn_single: int
    n_dense_mlp_double: int
    n_dense_mlp_single: int
    txt_len: int = 0            # text tokens of the joint sequence
    txt_first: bool = True
    batch: int = 1              # the batch the MLP caches fold in
    # head-parallel attention over token shards (parallel.TokenShards)
    # and the MLP routes of the image and the joint stream (None: the
    # MLP runs on the rank's own tokens)
    ulysses: Optional[object] = None
    route_d: Optional[object] = None
    route_s: Optional[object] = None

    def with_ulysses(self, mesh, axis: str,
                     batch_axis: Optional[str] = None) -> "FluxSparse":
        """This rank's context for Ulysses attention over ``axis`` of
        ``mesh`` (the batch sharded over ``batch_axis`` where it
        divides): the joint sequence split over the ranks
        (``parallel.TokenShards``: in whole MLP token groups where such a
        split exists, else as evenly as tokens allow, each MLP stream
        then routed to a whole-group split of its own) and the MLP
        modules built for this rank's rows of each stream."""
        from ..parallel.sharding import TokenShards
        S, T, m = self.attn_d.seq_len, self.txt_len, self.mlp_s
        img = (T, S - T) if self.txt_first else (0, S - T)
        shards = TokenShards.plan(mesh, axis, batch_axis, S, m.cfg,
                                  ((0, S), img), self.batch)

        def mlp(n_rows):
            return SparseDiffMlp.build(m.cfg, n_rows, m.d_model,
                                       m.d_hidden) if n_rows else None

        (n_s, n_d), (r_s, r_d) = shards.mlp_rows, shards.routes
        return dataclasses.replace(self, mlp_d=mlp(n_d), mlp_s=mlp(n_s),
                                   ulysses=shards, route_d=r_d, route_s=r_s)

    @staticmethod
    def build(ck: ChipmunkConfig, model: FluxModelConfig, seq_len: int,
              batch: int = 1, static_mask_tokens=None,
              valid_len: Optional[int] = None, csp_mode: str = 'auto'
              ) -> "FluxSparse":
        """static_mask_tokens / valid_len / csp_mode: see
        SparseDiffAttn.build."""
        img_len = seq_len - model.txt_len
        attn = SparseDiffAttn.build(ck.attn, seq_len,
                                    static_mask_tokens=static_mask_tokens,
                                    valid_len=valid_len, csp_mode=csp_mode)
        # MLP caches fold batch into the token axis ([B*T, ...])
        mlp_d = SparseDiffMlp.build(ck.mlp, batch * img_len,
                                    model.hidden_size, model.mlp_hidden)
        mlp_s = SparseDiffMlp.build(ck.mlp, batch * seq_len,
                                    model.hidden_size, model.mlp_hidden)
        nd_a = ck.attn.first_n_dense_layers
        nd_m = ck.mlp.first_n_dense_layers
        # layers are numbered double blocks first, then single blocks
        return FluxSparse(
            attn_d=attn, mlp_d=mlp_d, attn_s=attn, mlp_s=mlp_s,
            n_dense_attn_double=min(nd_a, model.depth),
            n_dense_attn_single=max(0, nd_a - model.depth),
            n_dense_mlp_double=min(nd_m, model.depth),
            n_dense_mlp_single=max(0, nd_m - model.depth),
            txt_len=model.txt_len, txt_first=model.txt_first, batch=batch)

    def init_state(self, model: FluxModelConfig, B: int,
                   device: DeviceLike = 'cuda') -> FluxState:
        """The caches of a batch of B; with ``ulysses`` this rank's: its
        heads of its batch rows, the MLP caches of its tokens."""
        H, D, dt = model.num_heads, model.head_dim, model.dtype
        u = self.ulysses
        if u is not None:
            B, H = u.rows(B), H // u.n
        return FluxState(
            double_attn=[self.attn_d.init_state(B, H, D, dt, device)
                         for _ in range(model.depth)],
            double_mlp=[self.mlp_d.init_state(dt, device)
                        if self.mlp_d is not None else None
                        for _ in range(model.depth)],
            single_attn=[self.attn_s.init_state(B, H, D, dt, device)
                         for _ in range(model.depth_single_blocks)],
            single_mlp=[self.mlp_s.init_state(dt, device)
                        if self.mlp_s is not None else None
                        for _ in range(model.depth_single_blocks)])


@dataclass(frozen=True)
class FluxStep:
    """Step descriptor: schedule.StepKind + step index."""
    index: int
    full_attn: bool
    full_mlp: bool
    colsum: bool
    recompute_mlp_mask: bool

    @staticmethod
    def of(kind: StepKind, index: int) -> "FluxStep":
        return FluxStep(index=index, full_attn=kind.full_attn,
                        full_mlp=kind.full_mlp, colsum=kind.colsum,
                        recompute_mlp_mask=kind.recompute_mlp_mask)


# ----------------------------------------------------------------- forward

def _split_heads(x, H):
    B, S, C = x.shape
    return x.reshape(B, S, H, C // H).transpose(1, 2)


def _merge_heads(x):
    B, H, S, D = x.shape
    return x.transpose(1, 2).reshape(B, S, H * D)


def _qkv_stream(p: Dict, prefix: str, x) -> QkvStream:
    """A stream's qkv GEMM (its bias left to ``qkv_prologue``) and norm
    scales: ``p[prefix + 'qkv']``, ``'qnorm'``, ``'knorm'``."""
    lin = p[prefix + 'qkv']
    return QkvStream(x @ materialize(lin['w'], x.dtype), lin.get('b'),
                     p[prefix + 'qnorm'], p[prefix + 'knorm'])


def _attn_call(mod: SparseDiffAttn, q, k, v, st, step: FluxStep,
               is_dense: bool, generator, ulysses=None):
    """One attention; with ``ulysses`` (parallel.TokenShards) q, k, v are
    this rank's token shard and the attention runs head-parallel
    (``parallel.ulysses_attention``), ``generator`` being this rank's
    (``parallel.rank_generator``)."""
    def run(q, k, v, st):
        return mod(q.contiguous(), k.contiguous(), v.contiguous(), st,
                   step_index=step.index, is_full=step.full_attn,
                   is_colsum=step.colsum, layer_is_dense=is_dense,
                   generator=generator)

    if ulysses is None:
        return run(q, k, v, st)
    from ..parallel.comm import ulysses_attention
    return ulysses_attention(ulysses.mesh, ulysses.axis, run, q, k, v, st,
                             batch_axis=ulysses.batch_axis,
                             sizes=ulysses.sizes)


def _mlp_call(mod: Optional[SparseDiffMlp], x2d, w1t, b1, w2, b2, st,
              step: FluxStep, is_dense: bool, generator, route=None):
    """One MLP on this rank's rows ``x2d``; with ``route``
    (parallel.MlpRoute) the rows move to the MLP's whole-group split and
    the output comes back.  A rank that holds none of the MLP's rows
    (``mod`` None) keeps its state None."""
    if route is not None:
        x2d = route.to_mlp(x2d)
    if mod is None:
        out = x2d
    else:
        out, st = mod(x2d, w1t, b1, w2, b2, st, is_full=step.full_mlp,
                      recompute_mask=step.recompute_mlp_mask,
                      layer_is_dense=is_dense, generator=generator)
    return (out if route is None else route.back(out)), st


def double_block(cfg: FluxModelConfig, sp: FluxSparse, p: Dict,
                 img, txt, vec, cos, sin, ast, mst, idx: int,
                 step: FluxStep, generator=None):
    """One double-stream (MMDiT) block."""
    with span('block.double'):
        H = cfg.num_heads
        (im1, it1) = modulation(p['img_mod'], vec, 2)
        (tm1, tt1) = modulation(p['txt_mod'], vec, 2)
        img_mod = (1 + im1[1]) * layernorm(img) + im1[0]
        txt_mod = (1 + tm1[1]) * layernorm(txt) + tm1[0]

        streams = (_qkv_stream(p, 'txt_', txt_mod),
                   _qkv_stream(p, 'img_', img_mod))
        q, k, v = qkv_prologue(streams if cfg.txt_first else streams[::-1],
                               cos, sin, H)

        o, ast = _attn_call(sp.attn_d, q, k, v, ast, step,
                            idx < sp.n_dense_attn_double, generator,
                            sp.ulysses)
        o = _merge_heads(o)
        # the streams' token counts (a rank's shard may hold few or none)
        nt, ni = txt.shape[1], img.shape[1]
        if cfg.txt_first:
            txt_o, img_o = o[:, :nt], o[:, nt:]
        else:
            img_o, txt_o = o[:, :ni], o[:, ni:]
        img = img + im1[2] * linear(p['img_proj'], img_o)
        txt = txt + tm1[2] * linear(p['txt_proj'], txt_o)

        # image MLP (sparse), text MLP (dense, small)
        if ni or sp.route_d is not None:
            img_mod2 = (1 + it1[1]) * layernorm(img) + it1[0]
            mo, mst = _mlp_call(sp.mlp_d,
                                img_mod2.reshape(-1, img_mod2.shape[-1]),
                                p['img_w1t'], p['img_b1'], p['img_w2'],
                                p['img_b2'], mst, step,
                                idx < sp.n_dense_mlp_double, generator,
                                sp.route_d)
            img = img + it1[2] * mo.reshape(img.shape)

        txt_mod2 = (1 + tt1[1]) * layernorm(txt) + tt1[0]
        dt = txt.dtype
        tmid = (txt_mod2 @ materialize(p['txt_w1t'], dt).t()
                + p['txt_b1'].to(dt))
        tact = gelu_tanh(tmid.float()).to(dt)
        txt = txt + tt1[2] * (tact @ materialize(p['txt_w2'], dt)
                              + p['txt_b2'].to(dt))
        return img, txt, ast, mst


def single_block(cfg: FluxModelConfig, sp: FluxSparse, p: Dict,
                 x, vec, cos, sin, ast, mst, idx: int, step: FluxStep,
                 generator=None):
    """One single-stream block with linear1/linear2 pre-split."""
    with span('block.single'):
        H = cfg.num_heads
        ((sh, sc, gate),) = modulation(p['mod'], vec, 1)
        x_mod = (1 + sc) * layernorm(x) + sh
        q, k, v = qkv_prologue((_qkv_stream(p, '', x_mod),), cos, sin, H)

        o, ast = _attn_call(sp.attn_s, q, k, v, ast, step,
                            idx < sp.n_dense_attn_single, generator,
                            sp.ulysses)
        attn_out = linear(p['o_proj'], _merge_heads(o))
        mo, mst = _mlp_call(sp.mlp_s, x_mod.reshape(-1, x_mod.shape[-1]),
                            p['w1t'], p['b1'], p['w2'],
                            torch.zeros(cfg.hidden_size, dtype=x.dtype,
                                        device=x.device),
                            mst, step, idx < sp.n_dense_mlp_single, generator,
                            sp.route_s)
        x = x + gate * (attn_out + mo.reshape(x.shape))
        return x, ast, mst


def flux_embed(params: Dict, cfg: FluxModelConfig, img, txt, timesteps, y,
               guidance=None):
    """Input embedders: returns (img tokens, txt tokens, vec)."""
    with span('embed'):
        dt = cfg.dtype
        vec = mlp_embedder(params['time_in'],
                           timestep_embedding(timesteps, 256).to(dt))
        if cfg.guidance_embed:
            assert guidance is not None
            vec = vec + mlp_embedder(params['guidance_in'],
                                     timestep_embedding(guidance, 256).to(dt))
        vec = vec + mlp_embedder(params['vector_in'], y.to(dt))
        return (linear(params['img_in'], img.to(dt)),
                linear(params['txt_in'], txt.to(dt)), vec)


def flux_final(params: Dict, cfg: FluxModelConfig, x, vec,
               n_txt: Optional[int] = None):
    """Final adaLN + projection of the image tokens of x (which holds
    ``n_txt`` text tokens, cfg.txt_len if None)."""
    with span('final'):
        n_txt = cfg.txt_len if n_txt is None else n_txt
        img = x[:, n_txt:] if cfg.txt_first else x[:, :x.shape[1] - n_txt]
        shift, scale = linear(params['final_mod'], F.silu(vec))[:, None, :] \
            .chunk(2, -1)
        return linear(params['final_proj'],
                      (1 + scale) * layernorm(img) + shift)


def flux_forward(params: Dict, cfg: FluxModelConfig, sp: FluxSparse,
                 img: torch.Tensor, txt: torch.Tensor,
                 timesteps: torch.Tensor, y: torch.Tensor,
                 pe: Tuple[torch.Tensor, torch.Tensor],
                 state: FluxState, step: FluxStep,
                 guidance: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 ) -> Tuple[torch.Tensor, FluxState]:
    """One model evaluation.  img: [B, S_img, in_ch] (patch-reordered),
    txt: [B, txt_len, ctx_dim], y: [B, vec_in], pe: (cos, sin) for the
    joint sequence.  ``generator`` draws the random keeps (attention with
    compressed indices, MLP).
    With ``sp.ulysses`` the inputs are this rank's batch rows (whole
    sequences) and its state; the blocks run on its token shard, the
    attention head-parallel, the weights gathered layer by layer where
    they are FSDP-sharded, and the prediction is all-gathered over the
    shards.
    Returns (prediction [B, S_img, in_ch], new state)."""
    u = sp.ulysses
    if u is not None:
        from ..parallel.sharding import gathered, gathered_top
        params = gathered_top(params)
        off_img = cfg.txt_len if cfg.txt_first else 0
        off_txt = 0 if cfg.txt_first else img.shape[1]
        img, txt = u.local(img, off_img), u.local(txt, off_txt)
        pe = tuple(u.local(t, dim=2) for t in pe)
    img, txt, vec = flux_embed(params, cfg, img, txt, timesteps, y, guidance)
    cos, sin = pe
    d_attn, d_mlp = list(state.double_attn), list(state.double_mlp)
    for i, p in enumerate(params['double']):
        img, txt, d_attn[i], d_mlp[i] = double_block(
            cfg, sp, p if u is None else gathered(p), img, txt, vec, cos,
            sin, d_attn[i], d_mlp[i], i, step, generator)
    n_txt = txt.shape[1]
    x = torch.cat([txt, img] if cfg.txt_first else [img, txt], 1)
    s_attn, s_mlp = list(state.single_attn), list(state.single_mlp)
    for i, p in enumerate(params['single']):
        x, s_attn[i], s_mlp[i] = single_block(
            cfg, sp, p if u is None else gathered(p), x, vec, cos, sin,
            s_attn[i], s_mlp[i], i, step, generator)
    out = flux_final(params, cfg, x, vec, n_txt)
    if u is not None:
        out = u.gather(out, off_img, sp.attn_d.seq_len - cfg.txt_len)
    return out, FluxState(d_attn, d_mlp, s_attn, s_mlp)


def flux_rope_ids(B: int, h_img: int, w_img: int, txt_len: int,
                  device: DeviceLike = 'cuda') -> torch.Tensor:
    """Position ids of the joint sequence: text ids zero, image ids
    (0, row, col)."""
    dev = torch.device(device)
    txt_ids = torch.zeros((B, txt_len, 3), dtype=torch.int32, device=dev)
    rows = torch.arange(h_img, device=dev).repeat_interleave(w_img)
    cols = torch.arange(w_img, device=dev).repeat(h_img)
    img_ids = torch.stack([torch.zeros_like(rows), rows, cols], -1)
    img_ids = img_ids[None].expand(B, -1, -1).to(torch.int32)
    return torch.cat([txt_ids, img_ids], 1)
