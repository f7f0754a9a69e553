"""Run one cell of the benchmark once, on the card this process sees.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix; both are files under this folder, found
by name (``core/loader.py``).  Set-up draws the weights from ``--seed``
on the card and warms up the cell's step kinds and decode; the window
then runs whole generations back to back, one client in a closed loop,
starting a further one only while the last one's time still fits in
``--seconds`` (at least one; traced, at least two).  After the window
the program's state is freed and one generation, chosen by the seed, is
judged against the plain reference (``families/<family>.py``,
``Cell.check``) by the numbers that ``limits/<cell>.json`` names.  The
last line of standard output is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics,
read from a ``torch.profiler`` trace of the window's first generation),
``device`` and, traced, ``breakdown``; ``checks`` (each compared number
beside its limit) comes last, and the same numbers end standard error.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'chipmunk_tpu')
EXIT_NO_CARD, EXIT_FORBIDDEN = 2, 3


def process_age_s() -> float:
    """Seconds since this process started (from /proc), else since this
    module was loaded."""
    try:
        with open('/proc/self/stat') as f:
            start = int(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf('SC_CLK_TCK'))
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _LOADED


_LOADED = time.perf_counter()


def forbidden_modules(names) -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``chipmunk_torch`` is not ``chipmunk_tpu``)."""
    return sorted(n for n in names if n.split('.', 1)[0] in FORBIDDEN)


def run_window(seconds: float, one, least: int = 1) -> tuple:
    """Whole generations back to back: ``one(i)`` runs generation i and
    returns its seconds (None if it failed, which ends the window);
    another starts only while the last one's time still fits in
    ``seconds``, or while fewer than ``least`` have finished.  Returns
    (window seconds, [seconds of each finished generation])."""
    t0 = time.perf_counter()
    times = []
    while True:
        t = one(len(times))
        if t is None:
            break
        times.append(t)
        if len(times) >= least and time.perf_counter() - t0 + t > seconds:
            break
    return time.perf_counter() - t0, times


class Run:
    """What the metric readers read (``metrics/<name>.py``)."""

    def __init__(self, workload, counts):
        self.workload, self.counts = workload, counts
        self.spans = {}            # span name -> [seconds] per generation
        self.traced = None         # index of the traced generation
        self.trace = None          # core.trace.Trace of it
        self.window_s = self.setup_s = 0.0
        self.generations = 0
        self.peak_bytes = 0

    def span(self, name: str):
        """The median of a span over the generations the profiler did not
        slow (all of them when only the traced one ran)."""
        v = self.spans.get(name, [])
        plain = [x for i, x in enumerate(v) if i != self.traced]
        return statistics.median(plain or v) if v else None


def _device_info(torch, dev, peak):
    info = {'platform': 'gpu' if dev.type == 'cuda' else dev.type,
            'kind': torch.cuda.get_device_name(dev) if dev.type == 'cuda'
            else 'cpu', 'count': 1, 'memory_peak_bytes': int(peak)}
    if dev.type == 'cuda':
        import subprocess
        try:
            p = subprocess.run(['nvidia-smi', '--query-gpu=power.limit',
                                '--format=csv,noheader', '-i',
                                str(dev.index or 0)], capture_output=True,
                               text=True, timeout=20)
            info['power_limit'] = p.stdout.strip()
        except (OSError, subprocess.SubprocessError):
            info['power_limit'] = 'not read'
    return info


def main(argv=None, device=None, bench_dir=BENCH_DIR, root=ROOT) -> int:
    ap = argparse.ArgumentParser(prog='benchmarks/run.py')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's caches stay in the checkout, at fixed paths
    cache = os.path.join(root, 'build', 'bench_cache')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(cache, 'torch_ext')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(cache, 'triton')
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'
    if root not in sys.path:
        sys.path.insert(0, root)
    import torch
    from benchmarks.core.loader import Bench, value
    from benchmarks.core.trace import read_profile

    bench = Bench.from_root(root, bench_dir)
    w = bench.workload(args.workload)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < w['chips']:
            print(f'{args.workload} needs {w["chips"]} CUDA device(s); '
                  f'this process sees '
                  f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
                  file=sys.stderr)
            return EXIT_NO_CARD
        device = 'cuda:0'
    dev = torch.device(device)
    cfg = bench.config(w['config'])
    traffic = bench.traffic(w['traffic'])
    limits = bench.limits(w['name'])['limits']
    cell = bench.family(cfg['family']).Cell(cfg, traffic, dev, args.seed)
    run = Run(w, bench.counts(w['config']).count(cfg, traffic))
    cell.setup()
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    run.setup_s = process_age_s()
    prof = [None]
    failed = [0]

    def one(i):
        try:
            if args.trace and i == 0 and dev.type == 'cuda':
                from torch.profiler import ProfilerActivity, profile
                # kernels and CUDA runtime calls only: host operator
                # records would cost the profiler minutes to fold; the
                # traced generation is not recorded for the check, so the
                # trace holds the program's work alone
                with profile(activities=[ProfilerActivity.CUDA]) as p:
                    spans = cell.generation(i, keep=False)
                prof[0] = p
                run.traced = i
            else:
                spans = cell.generation(i)
        except Exception as e:       # a failed generation ends the window
            failed[0] += 1
            print(f'generation {i} failed: {type(e).__name__}: {e}',
                  file=sys.stderr)
            return None
        for k, v in spans.items():
            run.spans.setdefault(k, []).append(v)
        return sum(spans.values())

    # a traced run's first generation is traced and not judged: one more
    # always follows it, for the check
    run.window_s, times = run_window(args.seconds, one,
                                     2 if args.trace else 1)
    print(f'generations: {len(times)} in {run.window_s!r} s: '
          f'{[round(t, 4) for t in times]}', file=sys.stderr)
    run.generations = len(times)
    attempted = run.generations + failed[0]
    run.peak_bytes = torch.cuda.max_memory_allocated(dev) \
        if dev.type == 'cuda' else 0
    if prof[0] is not None:
        run.trace = read_profile(prof[0])
        prof[0] = None

    # the check: one finished generation, drawn from the seed
    checks, correct = {}, failed[0] == 0 and run.generations > 0
    cell.release()
    if run.generations:
        got = cell.check()
        for name, lim in limits.items():
            v = got.get(name, float('inf'))
            # a gap that is not finite is not correct, and JSON has no inf
            checks[name] = {'value': v if math.isfinite(v) else None,
                            'limit': lim}
            correct = correct and v <= lim
    metrics = {}
    for m in bench.metrics(w['name'], bool(args.trace)):
        v = value(bench.reader(m['name']), run)
        if v is not None:
            metrics[m['name']] = {'value': v, 'unit': m['unit']}
    device_info = _device_info(torch, dev, run.peak_bytes)
    result = {'correct': bool(correct), 'attempted': attempted,
              'failed': failed[0], 'metrics': metrics,
              'device': device_info}
    if run.trace is not None:
        device_info['busy_s'] = run.trace.busy_s()
        device_info['window_s'] = run.trace.window_s()
        result['breakdown'] = {'device_ops': run.trace.top_ops(10),
                               'idle_gaps': run.trace.idle_gaps(10)}
    result['checks'] = checks
    found = forbidden_modules(sys.modules)
    if found:
        print(f'forbidden modules loaded in this process: {found}',
              file=sys.stderr)
        return EXIT_FORBIDDEN
    for name, c in checks.items():
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
