"""Readings that the limits of a cell's correctness check are set from,
at the cell's own size, many seeds in one process.  For each seed: one
generation of the program, judged by the check that ``run.py`` makes
(``Cell.check``, every number it can compare); with ``--control-seeds``
the same for the cell's control, the program with the lower-precision
path that the cell's limits file names under ``control`` (chipmunk
settings merged onto the traffic's); and, on the program's generation,
the reference computed from e4m3 operands against the float32 one
(``reference_fp8``: the control of the numbers that path leaves alone),
the Euler rule with the latent in bfloat16 (of ``euler_err``) and the
program's decoder with bfloat16 weights (of ``pixel_err``).  One JSON line per seed; the benchmark's own runs never
run this.

    python3 benchmarks/calibrate.py --workload flux1-dev.sparse.b1 \\
        --seeds 11,12,13 [--control-seeds 11,12]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(',') if s]


def main(argv=None, device=None, bench_dir=BENCH_DIR, root=ROOT) -> int:
    ap = argparse.ArgumentParser(prog='benchmarks/calibrate.py')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--control-seeds', default='')
    args = ap.parse_args(argv)
    if root not in sys.path:
        sys.path.insert(0, root)
    import torch
    from benchmarks.core.loader import Bench
    bench = Bench.from_root(root, bench_dir)
    w = bench.workload(args.workload)
    cfg, traffic = bench.config(w['config']), bench.traffic(w['traffic'])
    family = bench.family(cfg['family'])
    control = dict(traffic, chipmunk=family.merged(
        traffic.get('chipmunk', {}),
        bench.limits(w['name']).get('control', {})))
    dev = torch.device(device or 'cuda:0')
    cseeds = set(_seeds(args.control_seeds))
    for seed in _seeds(args.seeds):
        row = {'workload': w['name'], 'seed': seed}
        runs = [('program', traffic)] + \
            ([('control', control)] if seed in cseeds else [])
        for which, tr in runs:
            cell = family.Cell(cfg, tr, dev, seed)
            t0 = time.perf_counter()
            cell.setup()
            row[f'{which}_setup_s'] = time.perf_counter() - t0
            row[f'{which}_gen_s'] = sum(cell.generation(0).values())
            cell.release()
            t0 = time.perf_counter()
            if which == 'program':
                row[which], row['reference_fp8'] = cell.check(low=True)
            else:
                row[which] = cell.check()
            row[f'{which}_check_s'] = time.perf_counter() - t0
            if which == 'program':
                i, rec, lat, pix = cell.kept[:4]
                nxt = [r[1] for r in rec[1:]] + [lat]
                rule = cell.euler(torch.bfloat16)
                row['euler_bf16'] = {'euler_err': max(
                    family.rel(x, rule[r[0]]) for r, x in zip(rec, nxt))}
                with torch.no_grad():
                    low = cell.decode_in(torch.bfloat16)
                    row['decode_bf16'] = {'pixel_err': family.rel(
                        low, cell.decode_in(torch.float32))}
            del cell
        if dev.type == 'cuda':
            row['peak_gib'] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            torch.cuda.reset_peak_memory_stats(dev)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
