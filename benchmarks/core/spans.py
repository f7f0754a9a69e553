"""The program's spans (``chipmunk_torch.utils.profiling.spans()``) laid
on a traced generation's timeline (``core/trace.py``'s ``Trace``).

The program stamps a span with ``time.time_ns()``; the profiler's
exported trace stamps an event ``ts`` microseconds after its
``baseTimeNanoseconds`` on the same clock.  Kineto takes that base as
the wall clock floored to a multiple of 7,889,238 s (a quarter of a
year), once a process; ``placed`` tries that floor and the one before it
(a boundary crossed between the base and the first span), and keeps the
one under which the most launches fall inside the spans.

A launch is a CUDA runtime or driver call that queues a kernel, a copy or
a memset; it is "in" span S when its host start lies inside S, and its
path is the names of the spans that hold it, outermost first.  Each
device event is joined to the launch that queued it by order: on one
stream, from one host thread, the i-th event the device runs is the one
the i-th launch queued.  On the card the profiler has lost the records of
the last few launches of a generation, the device clock has read up to
26 us behind the host's, and sorting by start has swapped a few
neighbours in a thousand: so the join pairs the device events with the
first launches, in order, and checks the pairing where it can: a copy
(or memset) launch must meet a copy (or memset), at 99 of each hundred
such pairs (a swap of neighbours costs two; a device event lost before
the last hundredth of the generation puts nearly every later copy beside
a kernel).  More device events than launches, a graph launch or a failed
check leave it None, and then only the metrics of host time and launch
counts are read."""
from __future__ import annotations

import bisect
import statistics
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

QUARTER_YEAR_S = 7889238
LAUNCH_PARTS = ('launchkernel', 'launchcooperativekernel', 'memcpy',
                'memset')
AGREE = 0.99          # share of copy and memset pairs whose kinds agree


def program_spans() -> Optional[list]:
    """The program's record of its last traced region, or None where the
    program has no tracer or recorded nothing."""
    try:
        from chipmunk_torch.utils import profiling
    except ImportError:
        return None
    get = getattr(profiling, 'spans', None)
    spans = list(get()) if get is not None else []
    return spans or None


def is_launch(name: str) -> bool:
    low = name.lower()
    return any(p in low for p in LAUNCH_PARTS)


@dataclass
class Placed:
    """Spans and launches on the trace's clock (microseconds)."""
    spans: List[Tuple[str, float, float, int]]   # name, start, end, depth
    launches: List[Tuple[float, Tuple[str, ...]]]  # host start, path
    times: List[float]                             # the host starts
    # each device event (name, start, end) with its launch's path, in
    # launch order (the i-th launched by the i-th launch); None without
    # a join
    device: Optional[List[Tuple[str, float, float, Tuple[str, ...]]]]

    def named(self, name: str) -> List[Tuple[float, float]]:
        return [(s, e) for n, s, e, _ in self.spans if n == name]

    def _between(self, s: float, e: float) -> slice:
        """The launches (and, joined, device events) launched in [s, e]:
        both lists are in launch order."""
        return slice(bisect.bisect_left(self.times, s),
                     bisect.bisect_right(self.times, e))

    def launches_in(self, s: float, e: float) -> int:
        k = self._between(s, e)
        return k.stop - k.start

    def device_in(self, s: float, e: float) -> Optional[float]:
        """Microseconds of the union of the device events launched in
        [s, e]; None without a join."""
        if self.device is None:
            return None
        return union_us([(a, b) for _, a, b, _ in
                         self.device[self._between(s, e)]])


def _bases(spans) -> List[int]:
    q = QUARTER_YEAR_S * 10 ** 9
    floor = spans[0][1] // q * q
    return [floor, floor - q]


def _paths(spans, times: Sequence[float]) -> List[Tuple[str, ...]]:
    """For each time (ascending), the names of the spans holding it,
    outermost first; spans in the order they opened, properly nested."""
    out, stack, k = [], [], 0
    for t in times:
        while k < len(spans) and spans[k][1] <= t:
            while stack and stack[-1][2] < spans[k][1]:
                stack.pop()
            stack.append(spans[k])
            k += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out.append(tuple(s[0] for s in stack))
    return out


def _kind(name: str) -> str:
    """What a launch queues, or what a device event is: a copy, a memset
    or a kernel (no kernel's name holds 'memcpy' or 'memset')."""
    low = name.lower()
    return 'copy' if 'memcpy' in low else 'set' if 'memset' in low \
        else 'kernel'


def _join(trace, launches: List[Tuple[float, str]]) -> Optional[list]:
    """The device events in start order, the i-th paired with the i-th
    launch, or None (module docstring)."""
    dev = sorted(trace.kernels, key=lambda d: d[1])
    if len(dev) > len(launches) or any(
            'graphlaunch' in n.lower() for n, _, _ in trace.runtime):
        return None
    pairs = [(_kind(ln), _kind(dn)) for (_, ln), (dn, _, _) in
             zip(launches, dev)]
    marked = [a == b for a, b in pairs if a != 'kernel' or b != 'kernel']
    if marked and sum(marked) < AGREE * len(marked):
        return None
    return dev


def placed(trace, spans=None) -> Optional[Placed]:
    """The spans (the program's record if None) and the trace's launches
    on the trace's clock, and its device events joined to their launches;
    None without a trace, spans or launches."""
    if trace is None:
        return None
    spans = program_spans() if spans is None else spans
    if not spans:
        return None
    launches = sorted((s, n) for n, s, _ in trace.runtime if is_launch(n))
    launch_t = [s for s, _ in launches]
    if not launch_t:
        return None
    best = None
    for base in _bases(spans):
        on = [(n, (a - base) / 1e3, (b - base) / 1e3, d)
              for n, a, b, d in spans]
        lo, hi = min(s[1] for s in on), max(s[2] for s in on)
        inside = sum(1 for t in launch_t if lo <= t <= hi)
        if best is None or inside > best[0]:
            best = (inside, on)
    inside, on = best
    if not inside:
        return None
    paths = _paths(on, launch_t)
    dev = _join(trace, launches)
    joined = None if dev is None else [
        (n, s, e, p) for (n, s, e), p in zip(dev, paths)]
    return Placed(spans=on, launches=list(zip(launch_t, paths)),
                  times=launch_t, device=joined)


def union_us(iv: List[Tuple[float, float]]) -> float:
    total, end = 0.0, None
    for s, e in sorted(iv):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def median_over(placed_: Placed, name: str, per_span):
    """The median of ``per_span(start, end)`` over the spans ``name``;
    None where there are none."""
    vals = [per_span(s, e) for s, e in placed_.named(name)]
    return statistics.median(vals) if vals else None


def device_us(placed_: Optional[Placed], pick) -> Optional[float]:
    """Device microseconds (summed) of the events whose (name, path)
    ``pick`` keeps; None without a join."""
    if placed_ is None or placed_.device is None:
        return None
    return sum(e - s for n, s, e, p in placed_.device if pick(n, p))


def coverage(trace, placed_: Optional[Placed]) -> Optional[dict]:
    """The share of device time in events launched inside some span, and
    the share of idle time (inside the window) that ends at an event
    launched inside some span."""
    if placed_ is None or placed_.device is None:
        return None
    dev = placed_.device
    total = sum(e - s for _, s, e, _ in dev)
    held = sum(e - s for _, s, e, p in dev if p)
    gaps = _gaps(trace)
    idle = sum(e - s for s, e, _ in gaps)
    named = sum(e - s for s, e, i in gaps if i is not None and dev[i][3])
    return {'device_in_spans': held / total if total else None,
            'idle_in_spans': named / idle if idle else None}


def _gaps(trace) -> List[Tuple[float, float, Optional[int]]]:
    """The stretches of the window with no device event running, each
    with the index (in device order) of the event that ends it."""
    a, b = trace.span()
    starts = sorted(d[1] for d in trace.kernels)
    out, t = [], a
    for s, e in trace.busy_intervals() + [(b, b)]:
        if s > t:
            i = bisect.bisect_left(starts, s)
            out.append((t, s, i if i < len(starts) else None))
        t = max(t, e)
    return out


def idle_gaps(trace, placed_: Optional[Placed], n: int = 10) -> List[List]:
    """``Trace.idle_gaps`` with, where spans were joined, the path of the
    span that launched the event ending each gap: ``host in
    cudaLaunchKernel [step.sparse/block.single/mlp.select]``."""
    gaps = sorted(_gaps(trace), key=lambda g: g[0] - g[1])[:n]
    starts = sorted(trace.kernels, key=lambda k: k[1])
    out = []
    for s, e, i in gaps:
        name = trace._host_during(s, e, starts)
        if placed_ is not None and placed_.device is not None and \
                i is not None:
            name += f' [{"/".join(_shown(placed_.device[i][3]))}]'
        out.append([name, (e - s) / 1e6])
    return out


def _shown(path: Tuple[str, ...]) -> Tuple[str, ...]:
    """A launch's path as a gap names it: without the ``generate`` that
    holds nearly every launch; ``(no span)`` outside every span."""
    if not path:
        return ('(no span)',)
    return path[1:] if path[0] == 'generate' and len(path) > 1 else path
