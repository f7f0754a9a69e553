"""HunyuanVideo-architecture video DiT with chipmunk sparsity (torch), the
counterpart of ``chipmunk_tpu/models/hunyuan.py``.

The transformer core is the FLUX double/single-stream structure
(``flux_forward`` with ``txt_first=False``: the sequence is [img | txt |
pad]); this module adds the video shell: the 3-D patch embed (reshape +
linear), 3-axis RoPE over the (t, h, w) latent grid, the voxel token order
(each 128-token query group is a 4x4x8 voxel), the static local-attention
mask with its text tail, the text token refiner, and the pad that makes
the joint sequence a multiple of 128 (pad keys are excluded through
``SparseDiffAttn.valid_len``), and the streamed forward over host-
offloaded caches (``make_streamed``, ``forward_streamed``) that the
config's ``offloading`` block selects, and ``sharded`` / ``place``: the
model of one rank of a ``torch.distributed`` mesh (Ulysses attention
over token shards, the batch over ``dp``, optionally FSDP weights).
"""
from __future__ import annotations

import copy
import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ChipmunkConfig
from ..device import DeviceLike, resolve_device
from ..ops.voxel import (get_local_indices_with_text, inverse_voxel_order,
                         local_1d_window_mask, voxel_order)
from ..utils.offload import OffloadPolicy
from .flux import (FluxModelConfig, FluxSparse, FluxState, FluxStep,
                   flux_forward, init_flux_params)
from .layers import (build_rope, layernorm, linear, mlp_embedder,
                     timestep_embedding)
from .sampling import STREAMED_NO_MESH
from .streamed import StreamedFluxRunner, StreamedFluxState


@dataclass(frozen=True)
class HunyuanModelConfig:
    """HunyuanVideo-T2V 13B shape; the latent is (t, h, w) after the VAE."""
    latent_t: int = 33
    latent_h: int = 90
    latent_w: int = 160
    in_channels: int = 16
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    hidden_size: int = 3072
    num_heads: int = 24
    mlp_ratio: float = 4.0
    depth_double: int = 20
    depth_single: int = 40
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    theta: int = 256
    text_dim: int = 4096
    txt_len: int = 256
    vec_in_dim: int = 768
    guidance_embed: bool = True
    voxel_shape: Tuple[int, int, int] = (4, 4, 8)   # 128-token voxels
    dtype: torch.dtype = torch.bfloat16

    @property
    def grid(self) -> Tuple[int, int, int]:
        pt, ph, pw = self.patch_size
        return (self.latent_t // pt, self.latent_h // ph,
                self.latent_w // pw)

    @property
    def img_len(self) -> int:
        t, h, w = self.grid
        return t * h * w

    @property
    def seq_len(self) -> int:
        return self.img_len + self.txt_len

    @property
    def seq_pad(self) -> int:
        """Zero tokens appended after the text so the joint sequence is a
        multiple of 128: [img | txt | pad]; they ride the txt stream."""
        return (-self.seq_len) % 128

    def core(self) -> FluxModelConfig:
        pt, ph, pw = self.patch_size
        return FluxModelConfig(
            in_channels=self.in_channels * pt * ph * pw,
            vec_in_dim=self.vec_in_dim, context_in_dim=self.hidden_size,
            hidden_size=self.hidden_size, num_heads=self.num_heads,
            mlp_ratio=self.mlp_ratio, depth=self.depth_double,
            depth_single_blocks=self.depth_single, axes_dim=self.axes_dim,
            theta=self.theta, qkv_bias=True,
            guidance_embed=self.guidance_embed,
            txt_len=self.txt_len + self.seq_pad, txt_first=False,
            dtype=self.dtype)


def init_hunyuan_params(generator: torch.Generator, cfg: HunyuanModelConfig,
                        device: DeviceLike = 'cuda') -> Dict:
    """Random weights with the reference's shapes and scales (normal /
    sqrt(d_in), zero biases, unit affine norms), drawn from ``generator``
    (which must live on ``device``): the FLUX core, then the text refiner
    (input projection, timestep and context embedders, two blocks)."""
    params = init_flux_params(generator, cfg.core(), device)
    dev, dt, h = resolve_device(device), cfg.dtype, cfg.hidden_size

    def lin(d_in, d_out):
        w = torch.randn((d_in, d_out), generator=generator, device=dev)
        return {'w': (w * d_in ** -0.5).to(dt),
                'b': torch.zeros(d_out, dtype=dt, device=dev)}

    def embedder(d_in):
        return {'in': lin(d_in, h), 'out': lin(h, h)}

    def block():
        p = {'qkv': lin(h, 3 * h), 'proj': lin(h, h), 'fc1': lin(h, 4 * h),
             'fc2': lin(4 * h, h), 'gate': lin(h, 2 * h)}
        for n in ('norm1', 'norm2'):
            p[f'{n}_w'] = torch.ones(h, dtype=dt, device=dev)
            p[f'{n}_b'] = torch.zeros(h, dtype=dt, device=dev)
        return p

    params['refiner'] = {'in': lin(cfg.text_dim, h),
                         't_embed': embedder(256),
                         'c_embed': embedder(cfg.text_dim),
                         'blocks': [block() for _ in range(2)]}
    return params


def text_refiner(p: Dict, txt: torch.Tensor, t_emb: torch.Tensor,
                 num_heads: int,
                 txt_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Individual-token text refiner: self-attention + silu-MLP blocks with
    affine norms, residuals gated by adaLN of (timestep embed + context
    embed of the text states).  Plain torch, as the reference computes it
    outside any kernel.

    txt_mask: optional bool/int [B, S] validity of padded prompts.  With
    it the context embed takes the mask-weighted mean over valid tokens
    and the self-attention masks pairs where either token is padding, key
    column 0 forced valid so that no row is empty."""
    if txt_mask is None:
        cmean = txt.mean(1)
        attn_bias = None
    else:
        mf = txt_mask.float()[..., None]                      # [B, S, 1]
        cmean = ((txt.float() * mf).sum(1)
                 / mf.sum(1).clamp(min=1.0)).to(txt.dtype)
        m = txt_mask.bool()
        pair = m[:, None, :, None] & m[:, None, None, :]      # [B,1,S,S]
        pair[..., 0] = True
        attn_bias = torch.zeros(pair.shape, device=txt.device).masked_fill(
            ~pair, float('-inf'))
    c = mlp_embedder(p['t_embed'], t_emb) + mlp_embedder(p['c_embed'], cmean)
    x = linear(p['in'], txt)
    B, S, h = x.shape
    D = h // num_heads
    for blk in p['blocks']:
        g1, g2 = linear(blk['gate'], F.silu(c))[:, None, :].chunk(2, -1)
        xn = layernorm(x) * blk['norm1_w'] + blk['norm1_b']
        q, k, v = (z.reshape(B, S, num_heads, D).transpose(1, 2)
                   for z in linear(blk['qkv'], xn).chunk(3, -1))
        s = q @ k.transpose(-1, -2) / math.sqrt(D)
        if attn_bias is not None:
            s = s + attn_bias.to(s.dtype)
        o = torch.softmax(s.float(), -1).to(x.dtype) @ v
        x = x + g1 * linear(blk['proj'], o.transpose(1, 2).reshape(B, S, h))
        xn2 = layernorm(x) * blk['norm2_w'] + blk['norm2_b']
        xm = F.silu(linear(blk['fc1'], xn2).float()).to(x.dtype)
        x = x + g2 * linear(blk['fc2'], xm)
    return x


def sharded_model(model, mesh, axis: str, batch_axis: Optional[str],
                  fsdp: bool, num_heads: int, **attrs):
    """A shallow copy of a video model with ``attrs`` set and its
    ``mesh_info``; raises unless the size of ``axis`` divides the
    heads."""
    n = mesh[axis].size()
    if num_heads % n:
        raise ValueError(f'num_heads={num_heads} not divisible by '
                         f'{axis}={n}')
    m = copy.copy(model)
    m.__dict__.update(attrs, mesh_info=(mesh, axis, batch_axis, fsdp))
    return m


def place(model, params, arrays, state):
    """A video model's denoise inputs for its rank (as given when the
    model is not sharded)."""
    if model.mesh_info is None:
        return params, tuple(arrays), state
    from ..parallel.sharding import place_video_inputs
    mesh, sp, dp, fsdp = model.mesh_info
    return place_video_inputs(mesh, params, arrays, state, sp=sp, dp=dp,
                              fsdp=fsdp)


class VideoTokens:
    """The video token layout shared by the video models: patches of the
    (t, h, w) latent grid in voxel order (each 128-token query group one
    voxel of ``cfg.voxel_shape``), then whatever the model appends up to
    ``seq_padded``.  Needs ``cfg`` (patch_size, grid, in_channels,
    voxel_shape, axes_dim, theta), ``device``, ``seq_padded`` and a dict
    ``_perm``."""

    def _order(self, inverse: bool) -> torch.Tensor:
        if inverse not in self._perm:
            fn = inverse_voxel_order if inverse else voxel_order
            p = fn(*self.cfg.grid, self.cfg.voxel_shape)
            self._perm[inverse] = torch.from_numpy(p.astype(np.int64)).to(
                self.device)
        return self._perm[inverse]

    def patchify_video(self, latents: torch.Tensor) -> torch.Tensor:
        """[B, C, T, H, W] -> [B, t*h*w, C*pt*ph*pw] in voxel order."""
        B, C = latents.shape[:2]
        pt, ph, pw = self.cfg.patch_size
        t, h, w = self.cfg.grid
        x = latents.reshape(B, C, t, pt, h, ph, w, pw)
        x = x.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(B, t * h * w,
                                                      C * pt * ph * pw)
        return x[:, self._order(False).to(x.device)]

    def unpatchify_video(self, x: torch.Tensor, B: int) -> torch.Tensor:
        pt, ph, pw = self.cfg.patch_size
        C = self.cfg.in_channels
        t, h, w = self.cfg.grid
        x = x[:, self._order(True).to(x.device)]
        x = x.reshape(B, t, h, w, C, pt, ph, pw)
        return x.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(
            B, C, t * pt, h * ph, w * pw)

    def rope(self, B: int):
        """(cos, sin) of the padded sequence: video ids (t, h, w) in voxel
        order, then zero ids (the identity) for the rest (text, pad)."""
        t, h, w = self.cfg.grid
        dev = self.device
        ids = torch.stack(torch.meshgrid(
            torch.arange(t, device=dev), torch.arange(h, device=dev),
            torch.arange(w, device=dev), indexing='ij'), -1).reshape(-1, 3)
        ids = ids[self._order(False)]
        ids = torch.cat([ids, torch.zeros((self.seq_padded - t * h * w, 3),
                                          dtype=ids.dtype, device=dev)])
        return build_rope(ids[None].expand(B, -1, -1), self.cfg.axes_dim,
                          self.cfg.theta)


@dataclass
class HunyuanModel(VideoTokens):
    """Model config + sparsity context; builds the static voxel mask.

    ``materialize_indices`` left unset in the config is decided here, as
    in the reference: compressed states keep their index lists only when
    the offloading policy keeps attention indices on the device.
    csp_mode: the csp_attn mode of every sparse layer ('auto' takes the
    reference's rule)."""
    cfg: HunyuanModelConfig
    ck: ChipmunkConfig
    batch: int = 1
    csp_mode: str = 'auto'
    device: DeviceLike = 'cuda'
    _perm: Dict = field(default_factory=dict, repr=False)
    # set by sharded(): (mesh, sp axis, dp axis, fsdp)
    mesh_info: Optional[tuple] = field(default=None, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        t, h, w = self.cfg.grid
        attn = self.ck.attn
        lv = attn.local_voxels
        # local voxel cube + text, at the real [img | txt] layout; pad
        # columns are appended after it, all False
        mask, _, _ = get_local_indices_with_text(
            vid_shape=(t, h, w), txt_len=self.cfg.txt_len,
            voxel_shape=self.cfg.voxel_shape, local_shape=(lv, lv, lv),
            rk=0.0, kv_tile_size=attn.counts_multiple_of)
        if attn.local_1d_window > 0:
            mask |= local_1d_window_mask(
                self.cfg.img_len, mask.shape[1], attn.local_1d_window,
                qg=128)[:mask.shape[0]]
        seq, pad = self.cfg.seq_len, self.cfg.seq_pad
        self.seq_padded = seq + pad
        if pad:
            assert mask.shape[0] == self.seq_padded // 128
            mask = np.concatenate(
                [mask, np.zeros((mask.shape[0], pad), bool)], axis=1)
        self.static_mask = mask
        if attn.materialize_indices is None:
            policy = OffloadPolicy.from_config(self.ck.offloading)
            mat = not (policy.enabled and policy.wants_host('attn_indices'))
            self.ck = self.ck.replace(attn=dataclasses.replace(
                attn, materialize_indices=mat))
        self.sp = FluxSparse.build(
            self.ck, self.cfg.core(), self.seq_padded, batch=self.batch,
            static_mask_tokens=mask, valid_len=seq if pad else None,
            csp_mode=self.csp_mode)

    # -------------------------------------------------------- multi-card
    def sharded(self, mesh, sp: str = 'sp', dp: Optional[str] = None,
                fsdp: bool = False) -> "HunyuanModel":
        """A new model for this rank of ``mesh`` (``parallel.make_mesh``):
        Ulysses head-parallel attention over the token shards of axis
        ``sp`` (the reference's multi-GPU path for this model,
        ``head_parallel.py``), the batch over ``dp`` where it divides, the
        weights FSDP-sharded over ``sp`` with ``fsdp``.  Its state holds
        the rank's heads and tokens; the denoise loops place their inputs
        with ``place`` and return the whole result on every rank."""
        return sharded_model(self, mesh, sp, dp, fsdp, self.cfg.num_heads,
                             sp=self.sp.with_ulysses(mesh, sp, dp))

    def place(self, params, arrays, state):
        """(params, arrays, state) for this rank (as given when the model
        is not sharded): ``parallel.sharding.place_video_inputs``."""
        return place(self, params, arrays, state)

    # ----------------------------------------------------------- forward
    def forward(self, params: Dict, latents: torch.Tensor, txt: torch.Tensor,
                t_vec: torch.Tensor, y: torch.Tensor, state: FluxState,
                step: FluxStep, guidance: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, pe=None,
                txt_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, FluxState]:
        """latents [B, C, T, H, W]; txt [B, txt_len, text_dim]; y [B,
        vec_in]; txt_mask optional [B, txt_len] prompt validity.
        ``generator`` draws the attention random keeps.  Returns (velocity
        prediction [B, C, T, H, W], new state)."""
        cfg = self.cfg
        B = latents.shape[0]
        if self.mesh_info is not None:
            from ..parallel.sharding import gathered_top
            params = gathered_top(params)
        img, txt_ref = self.prep_tokens(params, latents, txt, t_vec, txt_mask)
        pe = pe if pe is not None else self.rope(B)
        pred, state = flux_forward(params, cfg.core(), self.sp, img, txt_ref,
                                   t_vec, y, pe, state, step,
                                   guidance=guidance, generator=generator)
        return self.unpatchify_video(pred[:, :cfg.img_len], B), state

    def prep_tokens(self, params: Dict, latents: torch.Tensor,
                    txt: torch.Tensor, t_vec: torch.Tensor,
                    txt_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The front of ``forward`` that both forwards share: the patch
        tokens and the refined text padded to the sequence's multiple of
        128."""
        cfg = self.cfg
        B = latents.shape[0]
        img = self.patchify_video(latents)
        t_emb = timestep_embedding(t_vec, 256).to(cfg.dtype)
        txt_ref = text_refiner(params['refiner'], txt.to(cfg.dtype), t_emb,
                               cfg.num_heads, txt_mask=txt_mask)
        if cfg.seq_pad:
            txt_ref = torch.cat([txt_ref, txt_ref.new_zeros(
                (B, cfg.seq_pad, txt_ref.shape[-1]))], 1)
        return img, txt_ref

    # ------------------------------------------------ streamed (offload)
    def make_streamed(self, n_chunks_double: int = 2,
                      n_chunks_single: int = 4, B: int = 1
                      ) -> Tuple[StreamedFluxRunner, StreamedFluxState]:
        """The host-offloaded runner and its state as the config's
        ``offloading`` block asks (the shipped config: attention out_cache
        and indices in host memory), for ``hunyuan_denoise(...,
        streamed=...)``.  Each chunk count is cut to the largest divisor
        of its depth that is at most the count asked for.  A sharded
        model raises: the streamed runner has no mesh path."""
        if self.mesh_info is not None:
            raise ValueError(STREAMED_NO_MESH)

        def fit(n, depth):
            n = max(1, min(n, depth))
            while depth % n:
                n -= 1
            return n

        n_chunks_double = fit(n_chunks_double, self.cfg.depth_double)
        n_chunks_single = fit(n_chunks_single, self.cfg.depth_single)
        core = self.cfg.core()
        runner = StreamedFluxRunner(cfg=core, sp=self.sp)
        sst = StreamedFluxState.create_hostwise(
            self.sp, core, B, n_chunks_double, n_chunks_single,
            OffloadPolicy.from_config(self.ck.offloading), self.device)
        return runner, sst

    def forward_streamed(self, params: Dict, latents: torch.Tensor,
                         txt: torch.Tensor, t_vec: torch.Tensor,
                         y: torch.Tensor, runner: StreamedFluxRunner,
                         sst: StreamedFluxState, step: FluxStep,
                         guidance: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         pe=None, txt_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """``forward`` with the caches in ``sst`` (mutated in place),
        streamed chunk by chunk; returns the velocity prediction only."""
        B = latents.shape[0]
        img, txt_ref = self.prep_tokens(params, latents, txt, t_vec, txt_mask)
        pe = pe if pe is not None else self.rope(B)
        pred = runner.forward(params, sst, img, txt_ref, t_vec, y, pe, step,
                              guidance=guidance, generator=generator)
        return self.unpatchify_video(pred[:, :self.cfg.img_len], B)

    def init_state(self, B: int) -> FluxState:
        return self.sp.init_state(self.cfg.core(), B, self.device)
