"""Video denoising loops (torch): HunyuanVideo (guidance-distilled) and
Wan2.1 (classifier-free guidance, two model invocations a step), the
counterparts of the resident host loops ``hunyuan_denoise(...,
streamed=None)`` and ``wan_denoise`` of
``chipmunk_tpu/models/video_sampling.py``.

Euler flow-matching loops over the chipmunk step plan; on a skipped
(step-cached) step the model is not invoked and the previous prediction
is reused.  Not ported yet: the host-offload streamed runner
(``streamed=``) and the compiled loops.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Union

import torch

from ..schedule import step_plan
from .flux import FluxStep


def _euler(model, latents: torch.Tensor, timesteps, callback, predict
           ) -> torch.Tensor:
    """Euler flow-matching over the model's step plan: ``predict(lat,
    t_vec, step)`` on each computed step, the last prediction reused on a
    skipped one.  The latent is carried in float32 on the model's
    device."""
    dev = model.device
    B = latents.shape[0]
    lat = latents.to(dev).float()
    plan = step_plan(model.ck)
    ts = torch.as_tensor(timesteps, dtype=torch.float32).tolist()
    pred = None
    for i in range(min(len(plan), len(ts) - 1)):
        skipped = plan[i].skip and pred is not None
        if not skipped:
            t_vec = torch.full((B,), ts[i], dtype=torch.float32, device=dev)
            pred = predict(lat, t_vec, FluxStep.of(plan[i], i)).float()
        lat = lat + (ts[i + 1] - ts[i]) * pred
        if callback:
            callback(i, skipped=skipped)
    return lat


def hunyuan_denoise(model, params: Dict, latents: torch.Tensor,
                    txt: torch.Tensor, y: torch.Tensor,
                    timesteps: Union[torch.Tensor, Sequence[float]],
                    guidance: float = 6.0,
                    generator: Optional[torch.Generator] = None,
                    callback: Optional[Callable] = None,
                    txt_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Euler loop for a HunyuanModel.  latents [B, C, T, H, W]; the latent
    is carried in float32 on the model's device.  ``generator`` (on that
    device; seed 0 if None) draws the attention random keeps.
    ``callback(i, skipped=...)`` is called after every step.  Returns the
    denoised latent (float32)."""
    dev = model.device
    B = latents.shape[0]
    txt, y = txt.to(dev), y.to(dev)
    if txt_mask is not None:
        txt_mask = txt_mask.to(dev)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    state = model.init_state(B)
    pe = model.rope(B)
    g = torch.full((B,), guidance, dtype=torch.float32, device=dev) \
        if model.cfg.guidance_embed else None

    def predict(lat, t_vec, step):
        nonlocal state
        pred, state = model.forward(params, lat, txt, t_vec, y, state, step,
                                    guidance=g, generator=generator, pe=pe,
                                    txt_mask=txt_mask)
        return pred

    return _euler(model, latents, timesteps, callback, predict)


def wan_denoise(model, params: Dict, latents: torch.Tensor,
                ctx_cond: torch.Tensor, ctx_uncond: torch.Tensor,
                timesteps: Union[torch.Tensor, Sequence[float]],
                guide_scale: float = 5.0,
                generator: Optional[torch.Generator] = None,
                callback: Optional[Callable] = None) -> torch.Tensor:
    """CFG loop for a WanModel.  latents [B, C, T, H, W]; ctx_cond /
    ctx_uncond [B, txt_len, text_dim], pad rows zeroed.  Each computed
    step runs a cond and an uncond invocation, each with its own state,
    and takes ``pred = p_u + guide_scale * (p_c - p_u)``; a skipped step
    reuses the last ``pred``.  The latent is carried in float32 on the
    model's device.  ``generator`` (on that device; seed 0 if None) draws
    both invocations' random keeps.  ``callback(i, skipped=...)`` is
    called after every step.  Returns the denoised latent (float32)."""
    dev = model.device
    B = latents.shape[0]
    ctx = (ctx_cond.to(dev), ctx_uncond.to(dev))
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    states = list(model.init_cfg_states(B))
    pe = model.rope(B)

    def predict(lat, t_vec, step):
        p = []
        for j in range(2):          # cond, then uncond
            o, states[j] = model.forward(params, lat, ctx[j], t_vec,
                                         states[j], step,
                                         generator=generator, pe=pe)
            p.append(o.float())
        return p[1] + guide_scale * (p[0] - p[1])

    return _euler(model, latents, timesteps, callback, predict)
