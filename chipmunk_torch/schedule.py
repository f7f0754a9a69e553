"""Step schedules (the port's copy of ``chipmunk_tpu/schedule.py``):
boolean tables indexed by inference step, from the config."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from .config import ChipmunkConfig


def full_attn_steps(cfg: ChipmunkConfig) -> np.ndarray:
    """bool[steps]: full if step < 2 or step % full_step_every == 0, unless
    an explicit schedule set is given."""
    s = np.arange(cfg.steps)
    if cfg.attn.full_step_schedule is not None:
        return np.isin(s, sorted(cfg.attn.full_step_schedule))
    return (s < 2) | (s % cfg.attn.full_step_every == 0)


def full_mlp_steps(cfg: ChipmunkConfig) -> np.ndarray:
    s = np.arange(cfg.steps)
    return s % cfg.mlp.full_step_every == 0


def skip_steps(cfg: ChipmunkConfig) -> np.ndarray:
    """bool[steps]: step-caching skips (only when enabled)."""
    s = np.arange(cfg.steps)
    if not cfg.step_caching.is_enabled:
        return np.zeros_like(s, dtype=bool)
    return np.isin(s, sorted(cfg.step_caching.skip_step_schedule))


def recompute_mlp_mask_steps(cfg: ChipmunkConfig) -> np.ndarray:
    """bool[steps]: sparse MLP steps that re-select neurons (step %
    block_mask_cache == 0 or step < 10)."""
    s = np.arange(cfg.steps)
    recompute = (s % cfg.mlp.block_mask_cache == 0) | (s < 10)
    return recompute & ~full_mlp_steps(cfg)


def colsum_steps(cfg: ChipmunkConfig) -> np.ndarray:
    """bool[steps]: full attention steps that also emit column sums and
    refresh the mask (step 1, or every full step > 1 with recompute_mask)."""
    full = full_attn_steps(cfg)
    s = np.arange(cfg.steps)
    if cfg.attn.recompute_mask:
        return full & (s >= 1)
    return full & (s == 1)


@dataclass(frozen=True)
class StepKind:
    """Per-step flags consumed by the sampler loop."""
    full_attn: bool
    full_mlp: bool
    colsum: bool
    recompute_mlp_mask: bool
    skip: bool
    is_first: bool


def step_plan(cfg: ChipmunkConfig) -> Tuple[StepKind, ...]:
    fa, fm = full_attn_steps(cfg), full_mlp_steps(cfg)
    cs, rm, sk = colsum_steps(cfg), recompute_mlp_mask_steps(cfg), skip_steps(cfg)
    return tuple(
        StepKind(full_attn=bool(fa[i]), full_mlp=bool(fm[i]), colsum=bool(cs[i]),
                 recompute_mlp_mask=bool(rm[i]), skip=bool(sk[i]), is_first=(i == 0))
        for i in range(cfg.steps)
    )


def step_span(cfg: ChipmunkConfig, kind: StepKind) -> str:
    """The tracer's span of a computed step (``utils/profiling.py``):
    ``step.sparse`` where an enabled attention or MLP takes its sparse
    path, else ``step.full`` (a skipped step's is ``step.skip``)."""
    sparse = (cfg.attn.is_enabled and not kind.full_attn) or \
        (cfg.mlp.is_enabled and not kind.full_mlp)
    return 'step.sparse' if sparse else 'step.full'


def fold_skip_steps(plan, timesteps, n):
    """Collapse skipped steps into the preceding computed step's Euler
    increment: a computed step at t_i followed by skips through t_k
    integrates to ``lat += (t_{k+1} - t_i) * pred_i``.

    Returns ``(indices, step_sigs, t_curr, t_end)`` over computed steps;
    ``step_sigs`` entries are ``(min(i, 2), full_attn, full_mlp, colsum,
    recompute_mlp_mask)``."""
    idxs, sigs, t_curr, t_end = [], [], [], []
    for i in range(n):
        k = plan[i]
        if k.skip and i > 0:
            t_end[-1] = timesteps[i + 1]
            continue
        idxs.append(i)
        sigs.append((min(i, 2), k.full_attn, k.full_mlp, k.colsum,
                     k.recompute_mlp_mask))
        t_curr.append(timesteps[i])
        t_end.append(timesteps[i + 1])
    return idxs, sigs, t_curr, t_end
