"""FLUX denoising loops with chipmunk step scheduling and step caching
(torch), the counterparts of the host loop and the compiled loop of
``chipmunk_tpu/models/sampling.py``.

The latent is patch-reordered and RoPE built once, then the Euler loop
runs over the timesteps; on a skipped (step-cached) step the model is not
invoked and the previous prediction is reused.  The compiled loop folds
the skipped steps into the computed ones and replays one CUDA graph per
step kind (``step_graphs``); the streamed loop keeps the caches in host
memory between steps and runs the layers chunk by chunk
(``models/streamed.py``).  ``FluxSampler.sharded`` runs the loops on one
rank of a ``torch.distributed`` mesh (Ulysses attention over token
shards, the batch over ``dp``, optionally FSDP weights).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..config import ChipmunkConfig
from ..device import DeviceLike, resolve_device
from ..ops.patch import inverse_patch_order, patch_order
from ..schedule import step_plan
from ..utils.offload import OffloadPolicy
from .flux import (FluxModelConfig, FluxSparse, FluxStep, flux_forward,
                   flux_rope_ids)
from .layers import build_rope
from .step_graphs import carry_state, compiled_euler, draws_keeps
from .streamed import StreamedFluxRunner, StreamedFluxState


# why a sharded model or sampler has no streamed runner (the JAX twin's
# reason, examples/hunyuan_generate.py)
STREAMED_NO_MESH = (
    'a mesh and offloading are mutually exclusive: the streamed runner '
    'has no mesh path (sharding the caches over sp removes the memory '
    'pressure that offloading works around; drop the offloading: block '
    'instead)')


def flux_time_shift(mu: float, sigma: float, t: torch.Tensor) -> torch.Tensor:
    return math.exp(mu) / (math.exp(mu) + (1 / t - 1) ** sigma)


def get_schedule(num_steps: int, image_seq_len: int,
                 base_shift: float = 0.5, max_shift: float = 1.15,
                 shift: bool = True) -> torch.Tensor:
    """Timesteps linear in sigma with the resolution-dependent shift
    (float32 [num_steps + 1], from 1 to 0)."""
    timesteps = torch.linspace(1, 0, num_steps + 1, dtype=torch.float32)
    if shift:
        m = (max_shift - base_shift) / (4096 - 256)
        b = base_shift - m * 256
        timesteps = flux_time_shift(m * image_seq_len + b, 1.0, timesteps)
    return timesteps


def unpack(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Latent tokens [B, (h w), (c 2 2)] -> z [B, c, 2h, 2w] for an image
    of height x width pixels (h = ceil(height / 16)): the reference's
    ``sampling.unpack``, the reshape of examples/flux_generate.py:155-157."""
    B, S, D = x.shape
    h, w = math.ceil(height / 16), math.ceil(width / 16)
    c = D // 4
    return x.reshape(B, h, w, c, 2, 2).permute(0, 3, 1, 4, 2, 5).reshape(
        B, c, 2 * h, 2 * w)


@dataclass
class FluxSampler:
    """Model config + sparsity context + the image's patch grid."""
    cfg: FluxModelConfig
    ck: ChipmunkConfig
    sp: FluxSparse
    h_img: int                     # latent patch grid height
    w_img: int
    use_patchify: bool = True
    device: DeviceLike = 'cuda'
    _perm: Dict = field(default_factory=dict, repr=False)
    # set by sharded(): (mesh, sp axis, dp axis, fsdp)
    mesh_info: Optional[tuple] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def sharded(self, mesh, sp: str = 'sp', dp: Optional[str] = None,
                fsdp: bool = False) -> "FluxSampler":
        """The sampler of this rank of ``mesh`` (``parallel.make_mesh``):
        Ulysses head-parallel attention over the token shards of axis
        ``sp``, the batch over ``dp`` where it divides, the weights
        FSDP-sharded over ``sp`` with ``fsdp``.  ``denoise`` and
        ``denoise_compiled`` then place their inputs themselves and
        return the whole result on every rank."""
        n = mesh[sp].size()
        if self.cfg.num_heads % n:
            raise ValueError(f'num_heads={self.cfg.num_heads} not '
                             f'divisible by {sp}={n}')
        return dataclasses.replace(
            self, sp=self.sp.with_ulysses(mesh, sp, batch_axis=dp),
            mesh_info=(mesh, sp, dp, fsdp), _perm={})

    def _place(self, params, img, txt, y, state):
        """(params, img, txt, y, state) for this rank (as given when the
        sampler is not sharded)."""
        if self.mesh_info is None:
            return params, img, txt, y, state
        from ..parallel.sharding import place_flux_inputs
        mesh, sp_ax, dp_ax, fsdp = self.mesh_info
        return place_flux_inputs(mesh, params, img, txt, y, state,
                                 sp=sp_ax, dp=dp_ax, fsdp=fsdp)

    def _whole(self, img: torch.Tensor, B: int) -> torch.Tensor:
        """The whole batch of a sharded loop's result (this rank's rows
        gathered over dp)."""
        if self.mesh_info is None:
            return img
        from ..parallel.sharding import gather_batch
        mesh, _, dp_ax, _ = self.mesh_info
        return gather_batch(img, mesh, dp_ax, B)

    def _order(self, inverse: bool) -> torch.Tensor:
        if inverse not in self._perm:
            fn = inverse_patch_order if inverse else patch_order
            p = fn(self.h_img, self.w_img, self.ck.patchify.chunk_size_1,
                   self.ck.patchify.chunk_size_2)
            self._perm[inverse] = torch.from_numpy(p.astype(np.int64)).to(
                self.device)
        return self._perm[inverse]

    def rope(self, B: int):
        ids = flux_rope_ids(B, self.h_img, self.w_img, self.cfg.txt_len,
                            self.device)
        if self.use_patchify:
            perm = torch.cat([torch.arange(self.cfg.txt_len,
                                           device=self.device),
                              self.cfg.txt_len + self._order(False)])
            ids = ids[:, perm]
        return build_rope(ids, self.cfg.axes_dim, self.cfg.theta)

    def patchify_img(self, img: torch.Tensor) -> torch.Tensor:
        return img[:, self._order(False)] if self.use_patchify else img

    def unpatchify_img(self, img: torch.Tensor) -> torch.Tensor:
        return img[:, self._order(True)] if self.use_patchify else img

    def _inputs(self, params, img, txt, y, guidance, generator,
                with_state: bool = True):
        """The loops' common inputs on the sampler's device, placed for
        this rank when sharded: the params, the latent patch-reordered in
        float32, txt, y, RoPE, the guidance vector, the generator (seed 0
        if None; this rank's when sharded) and the state (None unless
        ``with_state``)."""
        dev = self.device
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        img = self.patchify_img(img.to(dev)).float()
        # the state takes the whole batch; a sharded one keeps its rows
        state = self.sp.init_state(self.cfg, img.shape[0], self.device) \
            if with_state else None
        params, img, txt, y, state = self._place(params, img, txt.to(dev),
                                                 y.to(dev), state)
        B = img.shape[0]
        g = torch.full((B,), guidance, dtype=torch.float32, device=dev) \
            if self.cfg.guidance_embed else None
        if self.mesh_info is not None:
            from ..parallel.comm import rank_generator
            generator = rank_generator(generator, self.mesh_info[0])
        return params, img, txt, y, self.rope(B), g, generator, state

    def _euler(self, img, timesteps, callback, predict) -> torch.Tensor:
        """Euler over the step plan: ``predict(img, t_vec, step)`` on each
        computed step, the previous prediction reused on a skipped one."""
        B = img.shape[0]
        plan = step_plan(self.ck)
        ts = torch.as_tensor(timesteps, dtype=torch.float32).tolist()
        pred = None
        for i in range(min(len(plan), len(ts) - 1)):
            kind = plan[i]
            dt = ts[i + 1] - ts[i]
            if kind.skip and pred is not None:
                img = img + dt * pred
                if callback:
                    callback(i, skipped=True)
                continue
            t_vec = torch.full((B,), ts[i], dtype=torch.float32,
                               device=self.device)
            pred = predict(img, t_vec, FluxStep.of(kind, i))
            img = img + dt * pred.float()
            if callback:
                callback(i, skipped=False)
        return self.unpatchify_img(img)

    def denoise(self, params: Dict, img: torch.Tensor, txt: torch.Tensor,
                y: torch.Tensor,
                timesteps: Union[torch.Tensor, Sequence[float]],
                guidance: float = 4.0,
                generator: Optional[torch.Generator] = None,
                callback: Optional[Callable] = None) -> torch.Tensor:
        """Euler flow-matching loop with chipmunk scheduling and step
        caching.  img: [B, S_img, C_in].  ``generator`` (on the sampler's
        device; seed 0 if None) draws the random keeps.  The latent is
        carried in float32.  Returns the denoised latent [B, S_img, C_in]
        (float32)."""
        B = img.shape[0]
        params, img, txt, y, pe, g, generator, state = self._inputs(
            params, img, txt, y, guidance, generator)

        def predict(lat, t_vec, step):
            nonlocal state
            pred, state = flux_forward(params, self.cfg, self.sp, lat, txt,
                                       t_vec, y, pe, state, step, guidance=g,
                                       generator=generator)
            return pred

        return self._whole(self._euler(img, timesteps, callback, predict), B)

    def make_streamed(self, n_chunks_double: int = 1,
                      n_chunks_single: int = 2, B: int = 1,
                      policy: Optional[OffloadPolicy] = None):
        """The layer-chunked runner (``models/streamed.py``) and its state,
        for ``denoise_streamed``: the caches that ``policy`` names (the
        config's ``offloading`` block if None) live in host memory between
        steps; with a policy that offloads nothing the step still runs
        chunk by chunk.  A sharded sampler raises: the streamed runner
        has no mesh path."""
        if self.mesh_info is not None:
            raise ValueError(STREAMED_NO_MESH)
        if policy is None:
            policy = OffloadPolicy.from_config(self.ck.offloading)
        runner = StreamedFluxRunner(cfg=self.cfg, sp=self.sp)
        sst = StreamedFluxState.create_hostwise(
            self.sp, self.cfg, B, n_chunks_double, n_chunks_single, policy,
            self.device)
        return runner, sst

    def denoise_streamed(self, params: Dict, img: torch.Tensor,
                         txt: torch.Tensor, y: torch.Tensor,
                         timesteps: Union[torch.Tensor, Sequence[float]],
                         streamed, guidance: float = 4.0,
                         generator: Optional[torch.Generator] = None,
                         callback: Optional[Callable] = None
                         ) -> torch.Tensor:
        """The loop of ``denoise`` over the layer-chunked runner
        (``streamed`` = (runner, state) from ``make_streamed``).  Arguments
        and result as ``denoise``; equal to it bit for bit."""
        runner, sst = streamed
        if self.mesh_info is not None:
            raise ValueError(STREAMED_NO_MESH)
        params, img, txt, y, pe, g, generator, _ = self._inputs(
            params, img, txt, y, guidance, generator, with_state=False)

        def predict(lat, t_vec, step):
            return runner.forward(params, sst, lat, txt, t_vec, y, pe, step,
                                  guidance=g, generator=generator)

        return self._euler(img, timesteps, callback, predict)

    def denoise_compiled(self, params: Dict, img: torch.Tensor,
                         txt: torch.Tensor, y: torch.Tensor,
                         timesteps: Union[torch.Tensor, Sequence[float]],
                         guidance: float = 4.0,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
        """The loop of ``denoise`` as the reference's single dispatch
        (``chipmunk_tpu/models/sampling.py:131``): skipped steps folded
        into the preceding computed step's Euler increment, and on the
        card each computed step a replay of the CUDA graph of its step
        kind (``step_graphs.compiled_euler``).  Arguments and result as
        ``denoise``; the keeps are drawn in the host loop's order.
        Sharded, the steps' collectives are captured in the graphs."""
        B = img.shape[0]
        params, lat, txt, y, pe, g, generator, state = self._inputs(
            params, img, txt, y, guidance, generator)

        def predict(lat, t_vec, step):
            pred, new = flux_forward(params, self.cfg, self.sp, lat, txt,
                                     t_vec, y, pe, state, step, guidance=g,
                                     generator=generator)
            carry_state(state, new)
            return pred

        lat = compiled_euler(step_plan(self.ck), timesteps, lat, predict,
                             generator, draws_keeps(self.ck))
        return self._whole(self.unpatchify_img(lat), B)
