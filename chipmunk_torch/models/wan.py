"""Wan2.1-architecture video DiT with chipmunk sparsity (torch), the
counterpart of ``chipmunk_tpu/models/wan.py``.

Each block is self-attention through ``SparseDiffAttn`` over the video
tokens alone (text enters through cross-attention, so the static voxel
mask has no text part), a dense cross-attention over the text context
(``kernels.dense_attn``, Sk = txt_len), and an FFN through
``SparseDiffMlp``, with 6-way adaLN modulation from per-block learned
offsets plus the projected time embedding.  q and k of the
self-attention take a full-width RMSNorm before the head split.  The
sequence is padded to a multiple of 128 and the pad keys are excluded
through ``SparseDiffAttn.valid_len``.  Classifier-free guidance runs two
invocations a step, each with its own state (``init_cfg_states``,
``video_sampling.wan_denoise``).

Params are the reference's tree with ``blocks`` as a list of per-layer
dicts.  ``sharded`` / ``place`` give the model of one rank of a
``torch.distributed`` mesh: the self-attention head-parallel over token
shards (Ulysses), the cross-attention local (its queries are the rank's
tokens, the text context is replicated), the batch over ``dp`` where it
divides, optionally FSDP weights.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..config import ChipmunkConfig
from ..device import DeviceLike, resolve_device
from ..kernels.csp_mlp import gelu_tanh
from ..modules import AttnState, MlpState, SparseDiffAttn, SparseDiffMlp
from ..ops.voxel import get_local_indices_with_text
from .flux import FluxStep, _attn_call, _merge_heads, _mlp_call, _split_heads
from .hunyuan import VideoTokens, place, sharded_model
from .layers import apply_rope, layernorm, linear, rmsnorm, timestep_embedding


@dataclass(frozen=True)
class WanModelConfig:
    """Wan2.1 T2V shape (1.3B: dim 1536; 14B: dim 5120); the latent is
    (t, h, w) after the VAE."""
    latent_t: int = 21
    latent_h: int = 60
    latent_w: int = 104
    in_channels: int = 16
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    dim: int = 1536
    ffn_dim: int = 8960
    num_heads: int = 12
    num_layers: int = 30
    text_dim: int = 4096
    txt_len: int = 512
    freq_dim: int = 256
    axes_dim: Tuple[int, ...] = (44, 42, 42)   # head_dim 128
    theta: int = 10_000
    voxel_shape: Tuple[int, int, int] = (4, 4, 8)
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def grid(self) -> Tuple[int, int, int]:
        pt, ph, pw = self.patch_size
        return (self.latent_t // pt, self.latent_h // ph,
                self.latent_w // pw)

    @property
    def seq_len(self) -> int:
        t, h, w = self.grid
        return t * h * w


def init_wan_params(generator: torch.Generator, cfg: WanModelConfig,
                    device: DeviceLike = 'cuda') -> Dict:
    """Random weights with the reference's tree, shapes and scales (normal
    / sqrt(d_in) linears, zero biases, unit norms, 0.02 modulation
    offsets), drawn from ``generator`` (which must live on ``device``).
    FFN weights are output-major ([ffn, dim]) for the sparse kernels."""
    dev, dt, d, f = resolve_device(device), cfg.dtype, cfg.dim, cfg.ffn_dim

    def normal(*shape, scale):
        return (torch.randn(shape, generator=generator, device=dev)
                * scale).to(dt)

    def lin(d_in, d_out):
        return {'w': normal(d_in, d_out, scale=d_in ** -0.5),
                'b': torch.zeros(d_out, dtype=dt, device=dev)}

    def ones(n):
        return torch.ones(n, dtype=dt, device=dev)

    def blk():
        p = {'mod_bias': normal(6, d, scale=0.02)}
        for n in ('q', 'k', 'v', 'o'):
            p[n] = lin(d, d)
        # full-width RMSNorm of q and k before the head split
        p['qnorm'], p['knorm'] = ones(d), ones(d)
        for n in ('cq', 'ck', 'cv', 'co'):
            p[n] = lin(d, d)
        # in the tree as the reference has them; its forward reads neither
        p['cqnorm'], p['cknorm'] = ones(d), ones(d)
        p['norm3_scale'] = ones(d)
        p['norm3_bias'] = torch.zeros(d, dtype=dt, device=dev)
        p['w1t'] = normal(f, d, scale=d ** -0.5)
        p['b1'] = torch.zeros(f, dtype=dt, device=dev)
        p['w2'] = normal(f, d, scale=f ** -0.5)
        p['b2'] = torch.zeros(d, dtype=dt, device=dev)
        return p

    pt, ph, pw = cfg.patch_size
    patch = cfg.in_channels * pt * ph * pw
    return {
        'patch_in': lin(patch, d),
        'text_in': {'fc1': lin(cfg.text_dim, d), 'fc2': lin(d, d)},
        'time_in': {'fc1': lin(cfg.freq_dim, d), 'fc2': lin(d, d)},
        'time_proj': lin(d, 6 * d),
        'blocks': [blk() for _ in range(cfg.num_layers)],
        'head_mod': normal(2, d, scale=0.02),
        'head': lin(d, patch),
    }


class WanState(NamedTuple):
    """Chipmunk caches of one invocation, one entry per layer (None for a
    module that never touches its caches)."""
    attn: List[Optional[AttnState]]
    mlp: List[Optional[MlpState]]


@dataclass
class WanModel(VideoTokens):
    """Model config + sparsity context; builds the static voxel mask.

    csp_mode: the csp_attn mode of every sparse layer ('auto' takes the
    reference's rule)."""
    cfg: WanModelConfig
    ck: ChipmunkConfig
    batch: int = 1           # MLP caches fold batch into the token axis
    csp_mode: str = 'auto'
    device: DeviceLike = 'cuda'
    _perm: Dict = field(default_factory=dict, repr=False)
    # set by sharded(): this rank's token shards (parallel.TokenShards)
    # and (mesh, sp axis, dp axis, fsdp)
    ulysses: Optional[object] = field(default=None, repr=False)
    mesh_info: Optional[tuple] = field(default=None, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        t, h, w = self.cfg.grid
        seq = self.cfg.seq_len
        pad = (-seq) % 128
        self.seq_padded = seq + pad
        lv = self.ck.attn.local_voxels
        mask, _, _ = get_local_indices_with_text(
            vid_shape=(t, h, w), txt_len=0,
            voxel_shape=self.cfg.voxel_shape, local_shape=(lv, lv, lv),
            rk=0.0, kv_tile_size=self.ck.attn.counts_multiple_of)
        if pad:
            # the rows already cover the last, partial group; the pad
            # columns are appended all False (valid_len excludes them)
            assert mask.shape[0] == self.seq_padded // 128
            mask = np.concatenate(
                [mask, np.zeros((mask.shape[0], pad), bool)], axis=1)
        self.static_mask = mask
        self.attn_mod = SparseDiffAttn.build(
            self.ck.attn, self.seq_padded, static_mask_tokens=mask,
            valid_len=seq if pad else None, csp_mode=self.csp_mode)
        self.mlp_mod = SparseDiffMlp.build(
            self.ck.mlp, self.batch * self.seq_padded, self.cfg.dim,
            self.cfg.ffn_dim)

    # -------------------------------------------------------- multi-card
    def sharded(self, mesh, sp: str = 'sp', dp: Optional[str] = None,
                fsdp: bool = False) -> "WanModel":
        """A new model for this rank of ``mesh`` (``parallel.make_mesh``):
        the self-attention head-parallel over the token shards of axis
        ``sp`` (the reference's own Wan multi-GPU path is dense xDiT USP,
        which bypasses chipmunk; here the sparse path itself runs
        head-parallel), the batch over ``dp`` where it divides, the
        weights FSDP-sharded over ``sp`` with ``fsdp``.  The padded
        sequence splits in whole MLP token groups (ValueError where it
        cannot); the state holds the rank's heads and tokens."""
        from ..parallel.sharding import TokenShards
        S = self.seq_padded
        shards = TokenShards.plan(mesh, sp, dp, S, self.ck.mlp,
                                  (('the video', 0, S),), self.batch)
        mlp = SparseDiffMlp.build(
            self.ck.mlp, shards.rows(self.batch) * shards.sizes[shards.rank],
            self.cfg.dim, self.cfg.ffn_dim)
        return sharded_model(self, mesh, sp, dp, fsdp, self.cfg.num_heads,
                             ulysses=shards, mlp_mod=mlp)

    def place(self, params, arrays, state):
        """(params, arrays, state) for this rank (as given when the model
        is not sharded): ``parallel.sharding.place_video_inputs``."""
        return place(self, params, arrays, state)

    # ----------------------------------------------------------- forward
    def forward(self, params: Dict, latents: torch.Tensor, txt: torch.Tensor,
                t_vec: torch.Tensor, state: WanState, step: FluxStep,
                generator: Optional[torch.Generator] = None, pe=None
                ) -> Tuple[torch.Tensor, WanState]:
        """One model invocation (once per CFG branch, each with its own
        state).  latents [B, C, T, H, W]; txt [B, txt_len, text_dim], the
        text encoder's context with pad rows zeroed; t_vec [B].
        ``generator`` draws the attention random keeps.  Sharded, the
        inputs are the rank's batch rows and state, the blocks run on its
        token shard (the weights gathered layer by layer where they are
        FSDP-sharded) and the prediction is all-gathered.  Returns
        (velocity prediction [B, C, T, H, W], new state)."""
        cfg, u = self.cfg, self.ulysses
        B, dt, H = latents.shape[0], cfg.dtype, cfg.num_heads
        tokens = self.patchify_video(latents).to(dt)
        n_tok = self.seq_padded
        if u is not None:
            from ..parallel.sharding import gathered, gathered_top
            params = gathered_top(params)
            tokens, n_tok = u.local(tokens), u.sizes[u.rank]
        x = linear(params['patch_in'], tokens)
        pad = n_tok - x.shape[1]       # the pad tokens of this shard
        if pad:
            x = torch.cat([x, x.new_zeros((B, pad, cfg.dim))], 1)
        ti = params['text_in']
        ctx = linear(ti['fc2'], gelu_tanh(
            linear(ti['fc1'], txt.to(dt)).float()).to(dt))
        temb = timestep_embedding(t_vec, cfg.freq_dim).to(dt)
        e = linear(params['time_in']['fc2'],
                   F.silu(linear(params['time_in']['fc1'], temb)))
        e6 = linear(params['time_proj'], F.silu(e)).reshape(B, 6, cfg.dim)
        cos, sin = pe if pe is not None else self.rope(B)
        if u is not None:
            cos, sin = u.local(cos, dim=2), u.local(sin, dim=2)

        s_attn, s_mlp = list(state.attn), list(state.mlp)
        for idx, p in enumerate(params['blocks']):
            if u is not None:
                p = gathered(p)
            mod = (e6 + p['mod_bias'][None])[:, :, None, :]   # [B,6,1,d]
            # self attention
            xn = (1 + mod[:, 1]) * layernorm(x) + mod[:, 0]
            q = _split_heads(rmsnorm(linear(p['q'], xn), p['qnorm']), H)
            k = _split_heads(rmsnorm(linear(p['k'], xn), p['knorm']), H)
            v = _split_heads(linear(p['v'], xn), H)
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            o, s_attn[idx] = _attn_call(
                self.attn_mod, q, k, v, s_attn[idx], step,
                idx < self.ck.attn.first_n_dense_layers, generator, u)
            x = x + mod[:, 2] * linear(p['o'], _merge_heads(o))

            # cross attention over the text context (dense)
            xn3 = layernorm(x) * p['norm3_scale'] + p['norm3_bias']
            cq, ck_, cv = (_split_heads(linear(p[n], z), H).contiguous()
                           for n, z in (('cq', xn3), ('ck', ctx),
                                        ('cv', ctx)))
            co = kernels.dense_attn(cq, ck_, cv)[0]
            x = x + linear(p['co'], _merge_heads(co))

            # FFN
            xn2 = (1 + mod[:, 4]) * layernorm(x) + mod[:, 3]
            mo, s_mlp[idx] = _mlp_call(
                self.mlp_mod, xn2.reshape(-1, xn2.shape[-1]), p['w1t'],
                p['b1'], p['w2'], p['b2'], s_mlp[idx], step,
                idx < self.ck.mlp.first_n_dense_layers, generator)
            x = x + mod[:, 5] * mo.reshape(x.shape)

        hm = params['head_mod']
        x = (1 + hm[1]) * layernorm(x) + hm[0]
        out = linear(params['head'], x)
        if u is not None:
            out = u.gather(out, 0, self.seq_padded)
        out = out[:, :cfg.seq_len]
        return self.unpatchify_video(out, B), WanState(s_attn, s_mlp)

    def init_state(self, B: int) -> WanState:
        """The caches of a batch of B; sharded, this rank's: its heads of
        its batch rows, the MLP caches of its tokens."""
        L, dt, dev = self.cfg.num_layers, self.cfg.dtype, self.device
        H, u = self.cfg.num_heads, self.ulysses
        if u is not None:
            B, H = u.rows(B), H // u.n
        return WanState(
            attn=[self.attn_mod.init_state(B, H, self.cfg.head_dim, dt, dev)
                  for _ in range(L)],
            mlp=[self.mlp_mod.init_state(dt, dev) for _ in range(L)])

    def init_cfg_states(self, B: int) -> Tuple[WanState, WanState]:
        """Two invocation states, for the cond and the uncond branch."""
        return self.init_state(B), self.init_state(B)
