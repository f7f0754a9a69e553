"""Video denoising loops (torch): HunyuanVideo (guidance-distilled) and
Wan2.1 (classifier-free guidance, two model invocations a step), the
counterparts of the resident host loops ``hunyuan_denoise(...,
streamed=None)`` and ``wan_denoise`` and of the compiled loops
``hunyuan_denoise_compiled`` and ``wan_denoise_compiled`` of
``chipmunk_tpu/models/video_sampling.py``.

Euler flow-matching loops over the chipmunk step plan; on a skipped
(step-cached) step the model is not invoked and the previous prediction
is reused.  The compiled loops fold the skipped steps into the computed
ones and replay one CUDA graph per step kind (``step_graphs``).
``hunyuan_denoise(..., streamed=model.make_streamed())`` keeps the
caches in host memory between steps and streams them chunk by chunk
(``models/streamed.py``).  A sharded model (``model.sharded(mesh)``) has
every loop place its inputs and state for the rank (``model.place``),
draw from the rank's generator (``parallel.rank_generator``) and return
the whole batch on every rank.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Union

import torch

from ..schedule import step_plan
from .flux import FluxStep
from .sampling import STREAMED_NO_MESH
from .step_graphs import (carry_state, check_chunk, compiled_euler,
                          draws_keeps)


def _placed(model, params, latents, arrays, states, generator):
    """A loop's inputs for the model's rank: (params, latents, arrays,
    states, generator), the generator this rank's; as given when the
    model is not sharded."""
    if model.mesh_info is None:
        return params, latents, arrays, list(states), generator
    from ..parallel.comm import rank_generator
    params, (latents, *arrays), states = model.place(
        params, (latents, *arrays), list(states))
    return (params, latents, tuple(arrays), states,
            rank_generator(generator, model.mesh_info[0]))


def _whole(model, lat: torch.Tensor, B: int) -> torch.Tensor:
    """The whole batch of B rows of a loop's result (gathered over dp when
    the model is sharded)."""
    if model.mesh_info is None:
        return lat
    from ..parallel.sharding import gather_batch
    mesh, _, dp, _ = model.mesh_info
    return gather_batch(lat, mesh, dp, B)


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
                    txt_mask: Optional[torch.Tensor] = None,
                    streamed=None) -> torch.Tensor:
    """Euler loop for a HunyuanModel.  latents [B, C, T, H, W]; the latent
    is carried in float32 on the model's device.  ``generator`` (on that
    device; seed 0 if None) draws the attention random keeps.
    ``callback(i, skipped=...)`` is called after every step.  ``streamed``:
    (runner, state) from ``model.make_streamed()``: the caches then live
    in host memory between steps, as the config's ``offloading`` block
    asks, and stream chunk by chunk (equal to the resident loop bit for
    bit).  Returns the denoised latent (float32)."""
    dev = model.device
    B0 = latents.shape[0]
    txt, y = txt.to(dev), y.to(dev)
    if txt_mask is not None:
        txt_mask = txt_mask.to(dev)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    if streamed is not None and model.mesh_info is not None:
        raise ValueError(STREAMED_NO_MESH)
    state = model.init_state(B0) if streamed is None else None
    params, latents, (txt, y, txt_mask), (state,), generator = _placed(
        model, params, latents, (txt, y, txt_mask), (state,), generator)
    B = latents.shape[0]
    pe = model.rope(B)
    g = torch.full((B,), guidance, dtype=torch.float32, device=dev) \
        if model.cfg.guidance_embed else None

    def predict(lat, t_vec, step):
        nonlocal state
        if streamed is not None:
            return model.forward_streamed(params, lat, txt, t_vec, y,
                                          *streamed, step, guidance=g,
                                          generator=generator, pe=pe,
                                          txt_mask=txt_mask)
        pred, state = model.forward(params, lat, txt, t_vec, y, state, step,
                                    guidance=g, generator=generator, pe=pe,
                                    txt_mask=txt_mask)
        return pred

    return _whole(model, _euler(model, latents, timesteps, callback,
                                predict), B0)


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
    B0 = latents.shape[0]
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    params, latents, ctx, states, generator = _placed(
        model, params, latents, (ctx_cond.to(dev), ctx_uncond.to(dev)),
        model.init_cfg_states(B0), generator)
    pe = model.rope(latents.shape[0])

    def predict(lat, t_vec, step):
        p = []
        for j in range(2):          # cond, then uncond
            o, states[j] = model.forward(params, lat, ctx[j], t_vec,
                                         states[j], step,
                                         generator=generator, pe=pe)
            p.append(o.float())
        return p[1] + guide_scale * (p[0] - p[1])

    return _whole(model, _euler(model, latents, timesteps, callback,
                                predict), B0)


def hunyuan_denoise_compiled(model, params: Dict, latents: torch.Tensor,
                             txt: torch.Tensor, y: torch.Tensor,
                             timesteps: Union[torch.Tensor, Sequence[float]],
                             guidance: float = 6.0,
                             generator: Optional[torch.Generator] = None,
                             txt_mask: Optional[torch.Tensor] = None,
                             chunk: Optional[int] = None) -> torch.Tensor:
    """The loop of ``hunyuan_denoise`` as the reference's compiled loop
    (``video_sampling.py:192``): skipped steps folded into the preceding
    computed step's Euler increment, and on the card each computed step a
    replay of the CUDA graph of its step kind
    (``step_graphs.compiled_euler``).  ``chunk``: None or 0 runs the loop
    as one window, N > 0 in windows of at most N steps of one kind
    (``step_graphs._kind_pure_windows``; the same math); a negative
    chunk raises.  Other arguments and the result as
    ``hunyuan_denoise``."""
    check_chunk(chunk)
    dev = model.device
    B0 = latents.shape[0]
    txt, y = txt.to(dev), y.to(dev)
    if txt_mask is not None:
        txt_mask = txt_mask.to(dev)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    params, latents, (txt, y, txt_mask), (state,), generator = _placed(
        model, params, latents, (txt, y, txt_mask), (model.init_state(B0),),
        generator)
    B = latents.shape[0]
    pe = model.rope(B)
    g = torch.full((B,), guidance, dtype=torch.float32, device=dev) \
        if model.cfg.guidance_embed else None

    def predict(lat, t_vec, step):
        pred, new = model.forward(params, lat, txt, t_vec, y, state, step,
                                  guidance=g, generator=generator, pe=pe,
                                  txt_mask=txt_mask)
        carry_state(state, new)
        return pred

    return _whole(model, compiled_euler(
        step_plan(model.ck), timesteps,
        latents.to(dev, torch.float32, copy=True), predict,
        generator, draws_keeps(model.ck), chunk), B0)


def wan_denoise_compiled(model, params: Dict, latents: torch.Tensor,
                         ctx_cond: torch.Tensor, ctx_uncond: torch.Tensor,
                         timesteps: Union[torch.Tensor, Sequence[float]],
                         guide_scale: float = 5.0,
                         generator: Optional[torch.Generator] = None,
                         chunk: Optional[int] = None) -> torch.Tensor:
    """The loop of ``wan_denoise`` as the reference's compiled loop
    (``video_sampling.py:305``): one step (and on the card one CUDA graph
    per step kind) holds both invocations, cond then uncond, each with its
    own state and both drawing from ``generator``, the CFG combine and the
    Euler update.  ``chunk`` as for ``hunyuan_denoise_compiled``; other
    arguments and the result as ``wan_denoise``."""
    check_chunk(chunk)
    dev = model.device
    B0 = latents.shape[0]
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    params, latents, ctx, states, generator = _placed(
        model, params, latents, (ctx_cond.to(dev), ctx_uncond.to(dev)),
        model.init_cfg_states(B0), generator)
    pe = model.rope(latents.shape[0])

    def predict(lat, t_vec, step):
        p = []
        for j in range(2):          # cond, then uncond
            o, new = model.forward(params, lat, ctx[j], t_vec, states[j],
                                   step, generator=generator, pe=pe)
            carry_state(states[j], new)
            p.append(o.float())
        return p[1] + guide_scale * (p[0] - p[1])

    return _whole(model, compiled_euler(
        step_plan(model.ck), timesteps,
        latents.to(dev, torch.float32, copy=True), predict,
        generator, draws_keeps(model.ck), chunk), B0)
