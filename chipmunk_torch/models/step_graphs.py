"""The compiled denoise loops' step runner (torch): one CUDA graph per step
kind, the counterpart of the reference's single dispatch (``jax.jit``
with the cache state donated, over ``lax.scan``;
``chipmunk_tpu/models/sampling.py:131``, ``video_sampling.py:192,305``).

A compiled loop keeps everything a step reads or writes in fixed
buffers: the latent, the step's timestep ``t_vec`` and Euler increment
``dt`` (device tensors the loop fills before each step), and the cache
state.  Weights, text states, RoPE tables and masks are held by
reference.  A step computes one prediction from those buffers, copies
each state leaf the model replaced back into the old buffer
(``carry_state``: the counterpart of the reference's donation; a leaf
updated in place, or left as it was, costs nothing) and updates the
latent in place, ``lat = lat + dt * pred`` as the reference's scan body
does.  Run eagerly or replayed from a graph, it has the same effect.

``StepGraphs`` runs the first occurrence of a step kind eagerly on a side
stream (real work, its results kept; the warm-up a capture needs),
captures the second and replays it, and replays every later one.  A kind
that occurs once is never captured.  A replay launches the kernels the
capture recorded, on the same buffers and with the same arguments, so a
step computes exactly what it computes eagerly and what the reference's
single dispatch computes for it.  On a CUDA device a capture that fails
raises: the step never falls back to eager.  On the CPU there are no
graphs and every step runs eagerly, in the same folded schedule.

The loop's ``torch.Generator`` is registered with every graph, so each
replay draws fresh random keeps, the same bits the host loop draws at
that step.  A PyTorch without ``CUDAGraph.register_generator_state``
would replay frozen keeps: a loop that draws keeps refuses to run there.

Kernel wrappers count launches on the host (``LAUNCHES``), which a
replay does not reach: each capture's count is taken out again and added
once per replay, so a compiled loop counts what its host loop counts.
The graphs of one loop share one memory pool and live as long as the
loop call.  ``GRAPH_STATS`` holds the last compiled loop's graphs,
replays, eager steps, capture seconds and pool bytes.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import ChipmunkConfig
from ..kernels._build import LAUNCHES
from ..schedule import fold_skip_steps, step_plan, step_span
from ..utils.profiling import paused, span
from .flux import FluxStep

# the last compiled loop's runner, as StepGraphs.stats gives it
GRAPH_STATS: Dict[str, Optional[float]] = {}


def draws_keeps(ck: ChipmunkConfig) -> bool:
    """Whether a loop of this config draws random keeps: attention with
    compressed indices, or the MLP's re-selection."""
    return ((ck.attn.is_enabled and ck.attn.should_compress_indices
             and ck.attn.random_keys > 0)
            or (ck.mlp.is_enabled and ck.mlp.random_keys > 0))


def _leaves(tree) -> List[Optional[torch.Tensor]]:
    if tree is None or isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    raise TypeError(f'a state holds tensors, tuples and lists, not '
                    f'{type(tree).__name__}')


def carry_state(old, new) -> None:
    """Copy every leaf of ``new`` that is not the tensor at the same place
    in ``old`` into that tensor, so that ``old``'s buffers hold the new
    state.  Both trees must have the same structure, shapes and dtypes."""
    olds, news = _leaves(old), _leaves(new)
    if len(olds) != len(news):
        raise ValueError('carry_state: the new state has another structure')
    for o, n in zip(olds, news):
        if n is o:
            continue
        if o is None or n is None or o.shape != n.shape \
                or o.dtype != n.dtype:
            raise ValueError(
                'carry_state: a state leaf changed from '
                f'{None if o is None else (tuple(o.shape), o.dtype)} to '
                f'{None if n is None else (tuple(n.shape), n.dtype)}')
        o.copy_(n)


def _kind_pure_windows(kind_ix: Sequence[int], chunk: int):
    """(start, length, kind) windows over the computed steps that never
    cross a step-kind boundary, each at most ``chunk`` steps (the
    reference's, ``video_sampling.py:169``).  They partition the steps in
    order, so the math is the same at every chunk size."""
    wins = []
    s, n = 0, len(kind_ix)
    while s < n:
        e = s
        while e < n and kind_ix[e] == kind_ix[s]:
            e += 1
        for w in range(s, e, chunk):
            wins.append((w, min(chunk, e - w), kind_ix[s]))
        s = e
    return wins


def check_chunk(chunk: Optional[int]) -> None:
    """A negative chunk raises (the reference returns the noise
    untouched)."""
    if chunk is not None and chunk < 0:
        raise ValueError(f'chunk must be None or >= 0, got {chunk}')


def _windows(kind_ix: Sequence[int], chunk: Optional[int]):
    """The whole loop for chunk None or 0 (or >= the steps), else the
    kind-pure windows."""
    if not chunk or chunk >= len(kind_ix):
        return [(0, len(kind_ix), None)]
    return _kind_pure_windows(kind_ix, chunk)


class StepGraphs:
    """One CUDA graph per step kind (see the module docstring).  ``run``
    computes a step; ``stats`` counts what it did."""

    def __init__(self, device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 keeps: bool = False):
        self.device = torch.device(device)
        self.generator = generator
        self.graphs: Dict = {}          # sig -> (CUDAGraph, launches)
        self._seen = set()
        self.replays = self.eager = 0
        self.capture_s = 0.0
        self.pool = self._stream = None
        if self.device.type == 'cuda':
            if keeps and not hasattr(torch.cuda.CUDAGraph,
                                     'register_generator_state'):
                raise RuntimeError(
                    f'torch {torch.__version__} cannot register a generator '
                    'with a CUDA graph, so replays would draw the same '
                    'random keeps: run the host loop, or set random_keys 0')
            self.pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)

    def run(self, sig, fn: Callable[[], None]) -> None:
        """Compute one step of kind ``sig``; ``fn()`` reads and writes only
        the loop's fixed buffers and returns nothing."""
        if self.device.type != 'cuda':
            fn()
            self.eager += 1
            return
        hit = self.graphs.get(sig)
        if hit is None and sig not in self._seen:
            self._seen.add(sig)
            self._on_side_stream(fn)
            self.eager += 1
            return
        if hit is None:
            hit = self.graphs[sig] = self._capture(fn)
        graph, launches = hit
        graph.replay()
        for k, n in launches.items():
            LAUNCHES[k] += n
        self.replays += 1

    def _on_side_stream(self, fn):
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            fn()
        cur.wait_stream(self._stream)

    def _capture(self, fn):
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None and hasattr(
                graph, 'register_generator_state'):
            graph.register_generator_state(self.generator)
        before = dict(LAUNCHES)
        t0 = time.perf_counter()

        def record():
            # a capture launches nothing: no span records inside it
            with paused():
                graph.capture_begin(pool=self.pool)
                try:
                    fn()
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass
                    raise
                graph.capture_end()

        try:
            self._on_side_stream(record)
            launches = {k: n - before[k] for k, n in LAUNCHES.items()
                        if n != before[k]}
        finally:
            LAUNCHES.update(before)        # a capture launches nothing
        self.capture_s += time.perf_counter() - t0
        return graph, launches

    def pool_bytes(self) -> Optional[int]:
        """Bytes the graphs' pool holds on the card (its peak: a pool
        keeps its segments while its graphs live); None on the CPU."""
        if self.pool is None:
            return None
        return sum(s['total_size'] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get('segment_pool_id', ())) == tuple(self.pool))

    def stats(self) -> Dict[str, Optional[float]]:
        return {'graphs': len(self.graphs), 'replays': self.replays,
                'eager': self.eager, 'capture_s': self.capture_s,
                'pool_bytes': self.pool_bytes()}


def compiled_euler(ck: ChipmunkConfig, timesteps, lat: torch.Tensor,
                   predict, generator: torch.Generator,
                   chunk: Optional[int] = None) -> torch.Tensor:
    """The compiled Euler loop over the config's step plan: skipped steps
    folded into the preceding computed step's increment
    (``schedule.fold_skip_steps``), each computed step ``lat += dt *
    predict(lat, t_vec, step)`` in place, through ``StepGraphs``, inside
    its step span.  ``lat`` [B, ...] float32 is the loop's latent buffer;
    ``predict`` carries its state in place (``carry_state``) and returns
    the prediction.  ``chunk``: see ``_windows``.  Returns ``lat``."""
    dev, B = lat.device, lat.shape[0]
    plan = step_plan(ck)
    ts = torch.as_tensor(timesteps, dtype=torch.float32).tolist()
    n = min(len(plan), len(ts) - 1)
    idxs, sigs, t_c, t_e = fold_skip_steps(plan, ts, n)
    names = [step_span(ck, plan[i]) for i in idxs]
    uniq = list(dict.fromkeys(sigs))
    windows = _windows([uniq.index(s) for s in sigs], chunk)
    t_vec = torch.zeros((B,), dtype=torch.float32, device=dev)
    dt = torch.zeros((), dtype=torch.float32, device=dev)
    graphs = StepGraphs(dev, generator, draws_keeps(ck))

    def step(sig):
        pred = predict(lat, t_vec, FluxStep(*sig))
        lat.copy_((lat + dt * pred.float()).to(lat.dtype))

    for start, length, _ in windows:
        for j in range(start, start + length):
            with span(names[j]):
                t_vec.fill_(t_c[j])
                # t_end covers this step and the skipped steps folded
                # into it
                dt.fill_(float(np.float32(t_e[j]) - np.float32(t_c[j])))
                graphs.run(sigs[j], lambda s=sigs[j]: step(s))
    GRAPH_STATS.clear()
    GRAPH_STATS.update(graphs.stats())
    return lat
