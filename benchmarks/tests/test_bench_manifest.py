"""BENCHMARK.json against the naming rules, and every name in it backed
by its files (configurations, counters, traffic, limits, readers)."""
import copy
import json
import os

import pytest

from benchmarks.core.loader import Bench, problems

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@pytest.fixture
def manifest():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def test_manifest_names_and_units_are_allowed(manifest):
    assert problems(manifest) == []


@pytest.mark.parametrize('where, bad', [
    (('workloads', 0, 'name'), 'flux dev'),        # a space
    (('workloads', 0, 'name'), 'flux/dev'),        # a slash
    (('workloads', 0, 'traffic'), '.hidden,x'),    # a comma
    (('configs', 0, 'name'), 'x' * 65),            # too long
    (('end_to_end', 0, 'unit'), 'tokens per s'),   # a space
    (('end_to_end', 0, 'unit'), 'µs'),        # not a to z
    (('per_layer', 0, 'layer'), 'two\nlines'),
    (('workloads', 0, 'why'), 'y' * 201),
])
def test_bad_names_and_units_are_found(manifest, where, bad):
    m = copy.deepcopy(manifest)
    node = m
    for k in where[:-1]:
        node = node[k]
    node[where[-1]] = bad
    assert problems(m)


def test_duplicate_metric_names_are_found(manifest):
    m = copy.deepcopy(manifest)
    m['per_layer'].append(dict(m['per_layer'][0]))
    assert any('twice' in p for p in problems(m))


def test_every_name_has_its_files(manifest):
    b = Bench(manifest, BENCH_DIR)
    for w in manifest['workloads']:
        cfg = b.config(w['config'])
        b.family(cfg['family'])
        b.counts(w['config'])
        b.traffic(w['traffic'])
        assert b.limits(w['name'])
    for group in ('end_to_end', 'per_layer'):
        for m in manifest[group]:
            assert hasattr(b.reader(m['name']), 'read'), m['name']


def test_per_layer_metrics_name_a_reported_metric(manifest):
    e2e = {m['name'] for m in manifest['end_to_end']}
    cells = {w['name'] for w in manifest['workloads']}
    for m in manifest['per_layer']:
        assert m['moves'] in e2e
        assert set(m.get('workloads', cells)) <= cells


def test_bounds_and_run_length_are_within_the_rules(manifest):
    assert 1 <= manifest['run_seconds'] <= 51
    for m in manifest['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
    assert any(m['name'] == 'setup_s' for m in manifest['end_to_end'])
    runs = 2 + 14 * 24
    total = runs * (manifest['run_seconds'] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
