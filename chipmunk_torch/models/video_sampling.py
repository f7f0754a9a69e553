"""HunyuanVideo denoising loop (torch), the counterpart of the resident
host loop ``hunyuan_denoise(..., streamed=None)`` of
``chipmunk_tpu/models/video_sampling.py``.

An Euler flow-matching loop over the chipmunk step plan; on a skipped
(step-cached) step the model is not invoked and the previous prediction
is reused.  Not ported yet: the host-offload streamed runner
(``streamed=``), the compiled loops and Wan2.1's ``wan_denoise``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Union

import torch

from ..schedule import step_plan
from .flux import FluxStep


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
    lat = latents.to(dev).float()
    txt, y = txt.to(dev), y.to(dev)
    if txt_mask is not None:
        txt_mask = txt_mask.to(dev)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    plan = step_plan(model.ck)
    state = model.init_state(B)
    pe = model.rope(B)
    g = torch.full((B,), guidance, dtype=torch.float32, device=dev) \
        if model.cfg.guidance_embed else None
    ts = torch.as_tensor(timesteps, dtype=torch.float32).tolist()
    pred = None
    for i in range(min(len(plan), len(ts) - 1)):
        kind = plan[i]
        dt = ts[i + 1] - ts[i]
        if kind.skip and pred is not None:
            lat = lat + dt * pred
            if callback:
                callback(i, skipped=True)
            continue
        t_vec = torch.full((B,), ts[i], dtype=torch.float32, device=dev)
        pred, state = model.forward(params, lat, txt, t_vec, y, state,
                                    FluxStep.of(kind, i), guidance=g,
                                    generator=generator, pe=pe,
                                    txt_mask=txt_mask)
        pred = pred.float()
        lat = lat + dt * pred
        if callback:
            callback(i, skipped=False)
    return lat
