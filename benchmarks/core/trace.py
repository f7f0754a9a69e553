"""What the benchmark reads from a ``torch.profiler`` trace of the device:
the kernels' intervals, the CUDA runtime calls of the host, the busy
time as the union of the kernel intervals inside the traced window (so
it can never exceed the window), the idle gaps between kernels named by
what the host was doing in them, and device time by kernel."""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# the port's kernels in a trace (a part of the lower-cased name), first
# match wins; each gemm_sm90_kernel instantiation by its Op
OUR_KERNELS = (
    ('attention (attn_sm90_kernel)', 'attn_sm90_kernel'),
    ('bf16 MLP mm1 (Mm1Bf16)', 'mm1bf16<'),
    ('bf16 MLP mm2 (Mm2Bf16)', 'mm2bf16<'),
    ('a8 MLP mm1 (Mm1A8)', 'mm1a8<'),
    ('a8 MLP mm2 (Mm2A8)', 'mm2a8<'),
    ('w4 MLP mm1 (Mm1W4)', 'mm1w4<'),
    ('w4 MLP mm2 (Mm2W4)', 'mm2w4<'),
    ('a8w4 MLP mm1 (Mm1A8W4)', 'mm1a8w4<'),
    ('a8w4 MLP mm2 (Mm2A8W4)', 'mm2a8w4<'),
    ('wq MLP mm1 (Mm1Wq)', 'mm1wq<'),
    ('wq MLP mm2 (Mm2Wq)', 'mm2wq<'),
    ('quant_rows', 'quant_rows_kernel'),
    ('colsum fold', 'colsum_fold_kernel'),
    ('a8 split finish', 'a8_split_finish_kernel'),
    ('int8/bf16 probe', 'probe'))
# cuBLAS, CUTLASS and cuDNN's implicit GEMMs
GEMM_NAMES = ('nvjet', 'gemm', 'cutlass', 'xmma', 'gemv')


def ours(name: str) -> Optional[str]:
    low = name.lower()
    return next((label for label, part in OUR_KERNELS if part in low), None)


def is_gemm(name: str) -> bool:
    low = name.lower()
    return ours(name) is None and any(k in low for k in GEMM_NAMES)


def is_glue(name: str) -> bool:
    return ours(name) is None and not is_gemm(name)


@dataclass
class Trace:
    """Intervals in microseconds on the trace's clock."""
    kernels: List[Tuple[str, float, float]]            # name, start, end
    runtime: List[Tuple[str, float, float]] = field(default_factory=list)
    window: Optional[Tuple[float, float]] = None
    generations: int = 1

    def span(self) -> Tuple[float, float]:
        if self.window is not None:
            return self.window
        ev = self.kernels + self.runtime
        return min(e[1] for e in ev), max(e[2] for e in ev)

    def window_s(self) -> float:
        a, b = self.span()
        return (b - a) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the kernel intervals, clipped to the window."""
        a, b = self.span()
        iv = sorted((max(s, a), min(e, b)) for _, s, e in self.kernels
                    if e > a and s < b)
        out: List[List[float]] = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def idle_pct(self) -> float:
        w = self.window_s()
        return 100.0 * (w - self.busy_s()) / w if w > 0 else 0.0

    def device_s(self, pick) -> float:
        """Summed kernel time (not a union) of the kernels ``pick`` keeps."""
        return sum(e - s for n, s, e in self.kernels if pick(n)) / 1e6

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, s, e in self.kernels:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[k[:160], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest stretches with no kernel running, longest first,
        each named by the CUDA runtime call that covers at least half of
        it (a synchronisation, a copy), else by the kernel the host
        launched next."""
        a, b = self.span()
        busy = self.busy_intervals()
        gaps, t = [], a
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if b > t:
            gaps.append((t, b))
        gaps.sort(key=lambda g: g[0] - g[1])
        starts = sorted(self.kernels, key=lambda k: k[1])
        out = []
        for s, e in gaps[:n]:
            out.append([self._host_during(s, e, starts), (e - s) / 1e6])
        return out

    def _host_during(self, s, e, starts) -> str:
        best, name = 0.0, None
        for rn, rs, re_ in self.runtime:
            ov = min(e, re_) - max(s, rs)
            if ov > best:
                best, name = ov, rn
        if name is not None and best >= 0.5 * (e - s):
            return f'host in {name}'[:160]
        nxt = next((k for k in starts if k[1] >= e), None)
        return ('host before ' + nxt[0])[:160] if nxt else \
            'host after the last kernel'


def from_chrome(events: List[Dict], generations: int = 1) -> Trace:
    """A Trace from the ``traceEvents`` of ``export_chrome_trace``."""
    kernels, runtime = [], []
    for ev in events:
        if ev.get('ph') != 'X' or 'dur' not in ev:
            continue
        cat = str(ev.get('cat', '')).lower()
        s = float(ev['ts'])
        iv = (str(ev.get('name', '')), s, s + float(ev['dur']))
        if cat in ('kernel', 'gpu_memcpy', 'gpu_memset'):
            kernels.append(iv)
        elif cat in ('cuda_runtime', 'cuda_driver'):
            runtime.append(iv)
    return Trace(kernels=kernels, runtime=runtime, generations=generations)


def read_profile(prof, generations: int = 1) -> Trace:
    """Export ``prof``'s trace to a private temporary directory, read it
    and remove the directory."""
    d = tempfile.mkdtemp(prefix='bench-trace-')
    try:
        path = os.path.join(d, 'trace.json')
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    events = data['traceEvents'] if isinstance(data, dict) else data
    return from_chrome(events, generations)
