"""Tracing and timing (torch), the counterpart of
``chipmunk_tpu/utils/profiling.py``: an opt-in ``torch.profiler`` region
around the denoise loop, gated as the reference gates it (``should_profile``
and a warmed-up generation), and a small per-span wall-clock registry.

The trace is written as Chrome/TensorBoard JSON
(``tensorboard_trace_handler``: ``<logdir>/<host>_<pid>.<ms>.pt.trace.json``),
which needs no package beyond torch; open it in Perfetto or
chrome://tracing, or in TensorBoard's profiler plugin.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List

import torch


@contextlib.contextmanager
def profile_region(logdir: str = './profiles', enabled: bool = True,
                   warmup_done: bool = True):
    """Trace the region into ``logdir`` when ``enabled`` and
    ``warmup_done`` (the callers pass the reference's gates), with CPU
    activity and, where a card is present, CUDA activity.  Yields the
    ``torch.profiler.profile`` (None when off).  A profiler that fails
    raises."""
    if not (enabled and warmup_done):
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    from torch.profiler import tensorboard_trace_handler
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def _sync(x) -> None:
    """Wait for the device of ``x`` (a tensor, a torch.device or a device
    name; nested lists, tuples and dicts of tensors) to finish its
    queued work."""
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for t in x:
            _sync(t)
        return
    dev = x.device if isinstance(x, torch.Tensor) else torch.device(x)
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


class StepTimer:
    """Wall-clock seconds per named span."""

    def __init__(self):
        self.records: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str, sync=None):
        """Time the block; with ``sync`` (a tensor, or a device) wait for
        its device before the clock stops, so that the span holds the
        device work it queued."""
        t0 = time.perf_counter()
        yield
        if sync is not None:
            _sync(sync)
        self.records[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.records.items():
            out[name] = {'count': len(xs), 'total_s': sum(xs),
                         'mean_ms': 1e3 * sum(xs) / max(len(xs), 1),
                         'min_ms': 1e3 * min(xs)}
        return out

    def log(self, printer=print) -> None:
        for name, s in sorted(self.summary().items()):
            printer(f"{name}: n={s['count']} mean={s['mean_ms']:.2f}ms "
                    f"min={s['min_ms']:.2f}ms total={s['total_s']:.2f}s")
