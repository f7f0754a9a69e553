"""Fixtures of the benchmark's tests: a copy of the benchmark's data
folder in a temporary directory with a tiny FLUX cell, run on the CPU
through the plain versions of the port's kernels."""
import json
import os
import shutil
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

DATA = ('configs', 'traffic', 'limits', 'metrics', 'counts', 'families')


def tiny_config():
    """flux1-dev cut to 3 + 2 blocks of width 256 (2 heads of 128), 128
    text tokens, a 512x512 image (1024 image tokens: 9 key blocks, one
    kept a query group), 12 steps and a 32-channel decoder: the same code
    paths, every step kind."""
    with open(os.path.join(BENCH_DIR, 'configs', 'flux1-dev.json')) as f:
        cfg = json.load(f)
    cfg['name'] = 'tiny'
    cfg['model'].update(hidden_size=256, num_heads=2, depth=3,
                        depth_single_blocks=2, txt_len=128,
                        context_in_dim=64, vec_in_dim=32)
    cfg['autoencoder'].update(ch=32, ch_mult=[1, 2])
    cfg.update(width=512, height=512, steps=12)
    return cfg


@pytest.fixture
def tiny_bench(tmp_path):
    """(root, bench_dir) of a checkout whose manifest holds the tiny cells
    ``tiny.sparse.b1`` and ``tiny.dense.b1`` beside the real metrics."""
    bench = tmp_path / 'benchmarks'
    for d in DATA:
        shutil.copytree(os.path.join(BENCH_DIR, d), bench / d)
    (bench / 'configs' / 'tiny.json').write_text(json.dumps(tiny_config()))
    shutil.copy(os.path.join(BENCH_DIR, 'counts', 'flux1-dev.py'),
                bench / 'counts' / 'tiny.py')
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        man = json.load(f)
    man['configs'].append(dict(man['configs'][0], name='tiny',
                               file='benchmarks/configs/tiny.json'))
    for t in ('sparse.b1', 'dense.b1'):
        man['workloads'].append({'name': f'tiny.{t}', 'config': 'tiny',
                                 'traffic': t, 'chips': 1, 'why': 'test'})
        lim = json.loads((bench / 'limits' / f'flux1-dev.{t}.json')
                         .read_text())
        (bench / 'limits' / f'tiny.{t}.json').write_text(json.dumps(lim))
    for m in man['per_layer']:
        if 'workloads' in m:
            m['workloads'].append('tiny.sparse.b1')
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(man))
    return str(tmp_path), str(bench)


@pytest.fixture
def run_main():
    """run.main on the CPU, skipping the look for a card; returns (exit
    code, the result line parsed or None, standard error)."""
    from benchmarks.core.loader import load_module
    bench_run = load_module(os.path.join(BENCH_DIR, 'run.py'), 'bench_run')

    def go(root, bench, workload, seed=7, seconds=0.1, trace=0, capsys=None):
        rc = bench_run.main(['--workload', workload, '--seed', str(seed),
                             '--seconds', str(seconds), '--trace',
                             str(trace)], device='cpu', bench_dir=bench,
                            root=root)
        out, err = capsys.readouterr()
        lines = [ln for ln in out.splitlines() if ln.strip()]
        res = json.loads(lines[-1]) if rc == 0 and lines else None
        return rc, res, err
    return go
