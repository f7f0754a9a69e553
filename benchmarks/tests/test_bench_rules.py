"""The window rule, the import rules, and what a later change adds as
files being found by name."""
import ast
import json
import os

import pytest

from benchmarks.core.loader import Bench, load_module

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
run = load_module(os.path.join(BENCH_DIR, 'run.py'), 'bench_run_rules')


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize('gen_s, seconds, least, n', [
    (7.0, 51.0, 1, 7),     # 7 x 7 = 49, and 49 + 7 > 51
    (7.0, 49.0, 1, 7),     # 49 + 7 > 49: the seventh is the last
    (7.0, 48.9, 1, 6),     # 42 + 7 > 48.9
    (46.0, 51.0, 1, 1),
    (60.0, 51.0, 1, 1),    # always at least one
    (0.5, 2.0, 1, 4),      # 1.5 + 0.5 fits, 2.0 + 0.5 does not
    (46.0, 51.0, 2, 2),    # a traced run: the traced one and one more
    (7.0, 51.0, 2, 7),
])
def test_window_runs_whole_generations_while_the_last_fits(
        monkeypatch, gen_s, seconds, least, n):
    clock = Clock()
    monkeypatch.setattr(run.time, 'perf_counter', clock)

    def one(i):
        clock.t += gen_s
        return gen_s

    window, times = run.run_window(seconds, one, least)
    assert len(times) == n
    assert window == pytest.approx(n * gen_s)


def test_a_failed_generation_ends_the_window(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(run.time, 'perf_counter', clock)

    def one(i):
        clock.t += 1.0
        return None if i == 2 else 1.0

    window, times = run.run_window(100.0, one)
    assert times == [1.0, 1.0] and window == pytest.approx(3.0)


def test_forbidden_modules_are_matched_by_whole_top_level_name():
    names = ['jax', 'jax.numpy', 'jaxlib.xla_client', 'flax.linen',
             'chipmunk_tpu', 'chipmunk_tpu.kernels', 'chipmunk_torch',
             'chipmunk_torch.models', 'jaxtyping', 'flaxen', 'torch']
    assert run.forbidden_modules(names) == sorted(
        ['jax', 'jax.numpy', 'jaxlib.xla_client', 'flax.linen',
         'chipmunk_tpu', 'chipmunk_tpu.kernels'])


def _imports(path):
    """Top-level names of every module a Python file imports."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and \
                node.module:
            out.add(node.module.split('.')[0])
        elif isinstance(node, ast.Call) and getattr(node.func, 'attr', '') \
                == 'import_module' and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split('.')[0])
    return out


def _sources(sub=''):
    top = os.path.join(BENCH_DIR, sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = _imports(path) & {'jax', 'jaxlib', 'flax', 'chipmunk_tpu'}
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    paths = list(_sources('reference'))
    assert paths
    for path in paths:
        imp = _imports(path)
        assert 'chipmunk_torch' not in imp, path
        assert imp <= {'__future__', 'contextlib', 'math', 'typing',
                       'numpy', 'torch'}, (path, imp)


def test_the_import_scan_sees_a_forbidden_import(tmp_path):
    p = tmp_path / 'x.py'
    p.write_text('import os\nfrom jax import numpy\n'
                 'import chipmunk_tpu.kernels as k\n'
                 'from chipmunk_torch import models\n')
    assert _imports(str(p)) == {'os', 'jax', 'chipmunk_tpu',
                                'chipmunk_torch'}


def test_files_a_later_change_adds_are_found_by_name(tiny_bench):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and entries, with no file of the harness edited."""
    root, bench = tiny_bench
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        man = json.load(f)
    with open(os.path.join(bench, 'traffic', 'sparse.b1.json')) as f:
        tr = json.load(f)
    tr['chipmunk'] = {'attn': {'top_keys': 0.3}}
    with open(os.path.join(bench, 'traffic', 'wide.b1.json'), 'w') as f:
        json.dump(tr, f)
    with open(os.path.join(bench, 'metrics', 'toy_gens.py'), 'w') as f:
        f.write('def read(run):\n    return run.generations\n')
    man['workloads'].append({'name': 'tiny.wide.b1', 'config': 'tiny',
                             'traffic': 'wide.b1', 'chips': 1, 'why': 'x'})
    man['per_layer'].append({'name': 'toy_gens', 'unit': 'count',
                             'better': 'higher', 'source': 'program_counter',
                             'layer': 'samplers', 'moves': 'gen_s',
                             'workloads': ['tiny.wide.b1']})
    b = Bench(man, bench)
    w = b.workload('tiny.wide.b1')
    cfg = b.config(w['config'])
    assert cfg['model']['hidden_size'] == 256
    assert b.traffic(w['traffic'])['chipmunk']['attn']['top_keys'] == 0.3
    assert b.family(cfg['family']).Cell
    assert b.counts('tiny').count(cfg, tr)['flops'] > 0
    names = [m['name'] for m in b.metrics('tiny.wide.b1', trace=True)]
    assert 'toy_gens' in names and 'csp_mlp_roofline' not in names

    class R:
        generations = 3
    assert b.reader('toy_gens').read(R()) == 3
