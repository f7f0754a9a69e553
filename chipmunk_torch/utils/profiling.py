"""Tracing and timing (torch), the counterpart of
``chipmunk_tpu/utils/profiling.py``: the port's one tracer.

``span(name)`` marks a stretch of host time in which the program issues
a piece of work (a denoise step, a block, an attention or MLP call, a
selection).  Off, it is one flag check that returns a shared no-op
context: it records nothing, allocates nothing and never synchronises.
On, it appends ``Span(name, start_ns, end_ns, depth)``, stamped with
``time.time_ns()``, to one in-process record.  It is on

- while a ``torch.profiler`` is active in the process, and
- inside a ``recording()`` block.

The record holds the spans of the current region only (one profiled
region, or the outermost ``recording()`` block): a region that starts
clears it, so its memory is bounded by one region.  ``spans()``
returns it.  A torch profiler's exported
Chrome trace stamps its events ``ts`` microseconds after the trace's
``baseTimeNanoseconds``, on the same wall clock, so the spans can be laid
on its timeline and the kernels each span launched found.  No span
records inside ``paused()``, which the compiled loops open around a CUDA
graph capture: a capture launches nothing.

``profile_region`` is the operators' opt-in ``torch.profiler`` region,
gated as the reference gates it (``should_profile`` and a warmed-up
generation); inside it each span is also a ``record_function`` range, so
the spans show on the host's row of the trace it writes as
Chrome/TensorBoard JSON (``tensorboard_trace_handler``:
``<logdir>/<host>_<pid>.<ms>.pt.trace.json``; open it in Perfetto or
chrome://tracing).  ``StepTimer`` times named spans of the same tracer.

Spans are opened and closed on one thread: the denoise loops'.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple

import torch

class Span(NamedTuple):
    name: str
    start_ns: int       # time.time_ns() when the span opened
    end_ns: int
    depth: int          # recorded spans open around it


_ON = False             # a region is open and no paused() block
_ACTIVE = False         # a region is open: a profiler or recording()
_PROFILING = False      # a torch profiler is active
_RECORDING = 0          # recording() blocks open
_PAUSED = 0             # paused() blocks open
_ANNOTATING = 0         # profile_region() blocks open
_DEPTH = 0
_RECORD: List[list] = []     # [name, start_ns, end_ns, depth], by start


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str, sync=None):
    """A context manager that records the block as the span ``name``
    while the tracer is on; with ``sync`` (a tensor, a device, or lists
    and dicts of tensors) it also waits for that device before the span
    ends, so that the span holds the device work it queued."""
    if not _ON:
        return _NO_SPAN
    return _Span(name, sync)


class _Span:
    __slots__ = ('name', 'sync', 'entry', 'annotation')

    def __init__(self, name, sync):
        self.name, self.sync = name, sync
        self.entry = self.annotation = None

    def __enter__(self):
        global _DEPTH
        self.entry = [self.name, time.time_ns(), 0, _DEPTH]
        _RECORD.append(self.entry)
        _DEPTH += 1
        if _ANNOTATING:
            self.annotation = torch.autograd.profiler.record_function(
                self.name)
            self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        global _DEPTH
        if self.sync is not None:
            _sync(self.sync)
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        self.entry[2] = time.time_ns()
        _DEPTH -= 1
        return False


def spans() -> List[Span]:
    """The current region's closed spans, in the order they opened."""
    return [Span(*e) for e in _RECORD if e[2]]


def _update() -> None:
    """Open or close the region, and turn the tracer on or off; a region
    that opens clears the record."""
    global _ON, _ACTIVE
    active = _PROFILING or _RECORDING > 0
    if active and not _ACTIVE:
        _RECORD.clear()
    _ACTIVE = active
    _ON = active and not _PAUSED


@contextlib.contextmanager
def recording():
    """Record spans inside the block (tests, operators); the outermost
    block starts a region unless a profiler is already active."""
    global _RECORDING
    _RECORDING += 1
    _update()
    try:
        yield
    finally:
        _RECORDING -= 1
        _update()


@contextlib.contextmanager
def paused():
    """Record no span inside the block (a CUDA graph capture), without
    ending the region."""
    global _PAUSED
    _PAUSED += 1
    _update()
    try:
        yield
    finally:
        _PAUSED -= 1
        _update()


def _profiler_active(active: bool) -> None:
    global _PROFILING
    _PROFILING = active
    _update()


def _hook_profiler() -> None:
    """Follow every torch profiler's start and stop through the hooks
    that ``torch.autograd.profiler`` runs at each (the ones that set its
    ``_is_profiler_enabled`` flag).  Wraps them once per process; a
    reloaded module takes the wrapping over."""
    ap = torch.autograd.profiler
    for name, active in (('_run_on_profiler_start', True),
                         ('_run_on_profiler_stop', False)):
        hook = getattr(ap, name, None)
        if hook is None:
            continue
        hook = getattr(hook, '_tracer_wraps', hook)

        def wrapped(hook=hook, active=active):
            hook()
            _profiler_active(active)

        wrapped._tracer_wraps = hook
        setattr(ap, name, wrapped)
    if getattr(ap, '_is_profiler_enabled', False):
        _profiler_active(True)


_hook_profiler()


@contextlib.contextmanager
def profile_region(logdir: str = './profiles', enabled: bool = True,
                   warmup_done: bool = True):
    """Trace the region into ``logdir`` when ``enabled`` and
    ``warmup_done`` (the callers pass the reference's gates), with CPU
    activity and, where a card is present, CUDA activity; the program's
    spans show as ``record_function`` ranges.  Yields the
    ``torch.profiler.profile`` (None when off).  A profiler that fails
    raises."""
    global _ANNOTATING
    if not (enabled and warmup_done):
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    from torch.profiler import tensorboard_trace_handler
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    _ANNOTATING += 1
    try:
        with profile(activities=acts,
                     on_trace_ready=tensorboard_trace_handler(logdir)) \
                as prof:
            yield prof
    finally:
        _ANNOTATING -= 1


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
    """Wall-clock seconds per named span: each is a span of the tracer,
    recorded inside ``recording()``, so the spans the block opens are
    recorded with it; the timer reads its own spans' entries of the
    record."""

    def __init__(self):
        self._entries: List[list] = []

    @contextlib.contextmanager
    def span(self, name: str, sync=None):
        """Time the block; with ``sync`` (a tensor, or a device) wait for
        its device before the clock stops, so that the span holds the
        device work it queued."""
        with recording():
            with span(name, sync=sync) as s:
                yield
        if s is not _NO_SPAN:
            self._entries.append(s.entry)

    @property
    def records(self) -> Dict[str, List[float]]:
        """Seconds of each span, by name, in the order they opened."""
        out: Dict[str, List[float]] = defaultdict(list)
        for name, t0, t1, _ in self._entries:
            out[name].append((t1 - t0) / 1e9)
        return out

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
