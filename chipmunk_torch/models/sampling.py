"""FLUX denoising loops with chipmunk step scheduling and step caching
(torch), the counterparts of the host loop and the compiled loop of
``chipmunk_tpu/models/sampling.py``.

The latent is patch-reordered and RoPE built once, then the Euler loop
runs over the timesteps; on a skipped (step-cached) step the model is not
invoked and the previous prediction is reused.  The compiled loop folds
the skipped steps into the computed ones and replays one CUDA graph per
step kind (``step_graphs``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..config import ChipmunkConfig
from ..device import DeviceLike, resolve_device
from ..ops.patch import inverse_patch_order, patch_order
from ..schedule import step_plan
from .flux import (FluxModelConfig, FluxSparse, FluxStep, flux_forward,
                   flux_rope_ids)
from .layers import build_rope
from .step_graphs import carry_state, compiled_euler, draws_keeps


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

    def __post_init__(self):
        self.device = resolve_device(self.device)

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
        dev = self.device
        B = img.shape[0]
        img = self.patchify_img(img.to(dev)).float()
        txt, y = txt.to(dev), y.to(dev)
        pe = self.rope(B)
        state = self.sp.init_state(self.cfg, B, dev)
        plan = step_plan(self.ck)
        ts = torch.as_tensor(timesteps, dtype=torch.float32).tolist()
        g = torch.full((B,), guidance, dtype=torch.float32, device=dev) \
            if self.cfg.guidance_embed else None
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)

        pred = None
        for i in range(min(len(plan), len(ts) - 1)):
            kind = plan[i]
            dt = ts[i + 1] - ts[i]
            if kind.skip and pred is not None:
                img = img + dt * pred
                if callback:
                    callback(i, skipped=True)
                continue
            t_vec = torch.full((B,), ts[i], dtype=torch.float32, device=dev)
            pred, state = flux_forward(params, self.cfg, self.sp, img, txt,
                                       t_vec, y, pe, state,
                                       FluxStep.of(kind, i), guidance=g,
                                       generator=generator)
            img = img + dt * pred.float()
            if callback:
                callback(i, skipped=False)
        return self.unpatchify_img(img)

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
        ``denoise``; the keeps are drawn in the host loop's order."""
        dev = self.device
        B = img.shape[0]
        lat = self.patchify_img(img.to(dev)).float()
        txt, y = txt.to(dev), y.to(dev)
        pe = self.rope(B)
        state = self.sp.init_state(self.cfg, B, dev)
        g = torch.full((B,), guidance, dtype=torch.float32, device=dev) \
            if self.cfg.guidance_embed else None
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)

        def predict(lat, t_vec, step):
            pred, new = flux_forward(params, self.cfg, self.sp, lat, txt,
                                     t_vec, y, pe, state, step, guidance=g,
                                     generator=generator)
            carry_state(state, new)
            return pred

        lat = compiled_euler(step_plan(self.ck), timesteps, lat, predict,
                             generator, draws_keeps(self.ck))
        return self.unpatchify_img(lat)
