"""The benchmark's data, found by the names in ``BENCHMARK.json``:

- ``configs/<config>.json``: a configuration (its ``family`` names the
  module ``families/<family>.py``);
- ``counts/<config>.py``: its operations and bytes per generation;
- ``traffic/<traffic>.json``: a traffic mix;
- ``limits/<workload>.json``: the cell's limits of the correctness check;
- ``metrics/<metric>.py``: one reader per metric, ``read(run)``.

A later change adds a configuration, a traffic or a metric by adding
such files and entries; nothing here names one."""
from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Dict, List, Optional

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
TEXT_MAX = 200


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A Python file loaded by its path (names may hold dots and dashes)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f'cannot load {path}')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """The manifest and the folder of data beside it (``bench_dir``)."""

    def __init__(self, manifest: Dict, bench_dir: str):
        self.manifest, self.dir = manifest, bench_dir

    @staticmethod
    def from_root(root: str, bench_dir: str) -> 'Bench':
        return Bench(read_json(os.path.join(root, 'BENCHMARK.json')),
                     bench_dir)

    def _file(self, *parts: str) -> str:
        path = os.path.join(self.dir, *parts)
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
        return path

    def workload(self, name: str) -> Dict:
        for w in self.manifest['workloads']:
            if w['name'] == name:
                return w
        raise KeyError(f'no workload {name!r} in BENCHMARK.json')

    def config(self, name: str) -> Dict:
        entry = next((c for c in self.manifest['configs']
                      if c['name'] == name), None)
        if entry is None:
            raise KeyError(f'no config {name!r} in BENCHMARK.json')
        return read_json(os.path.join(os.path.dirname(self.dir),
                                      entry['file']))

    def traffic(self, name: str) -> Dict:
        return read_json(self._file('traffic', f'{name}.json'))

    def limits(self, workload: str) -> Dict[str, float]:
        return read_json(self._file('limits', f'{workload}.json'))

    def counts(self, config: str):
        return load_module(self._file('counts', f'{config}.py'),
                           f'bench_counts_{config}')

    def family(self, family: str):
        return load_module(self._file('families', f'{family}.py'),
                           f'bench_family_{family}')

    def metrics(self, workload: str, trace: bool) -> List[Dict]:
        """The cell's metrics: end-to-end ones untraced, per-layer ones
        traced; each listed for this cell or for every cell."""
        group = self.manifest['per_layer' if trace else 'end_to_end']
        return [m for m in group
                if 'workloads' not in m or workload in m['workloads']]

    def reader(self, metric: str):
        return load_module(self._file('metrics', f'{metric}.py'),
                           f'bench_metric_{metric}')


def problems(manifest: Dict) -> List[str]:
    """What in a manifest breaks the naming rules (empty when none)."""
    out = []

    def name(v, what):
        if not isinstance(v, str) or not NAME.match(v):
            out.append(f'{what}: bad name {v!r}')

    def text(v, what):
        if not isinstance(v, str) or not 1 <= len(v) <= TEXT_MAX or \
                '\n' in v or '\t' in v:
            out.append(f'{what}: bad text {v!r}')

    for c in manifest.get('configs', []):
        name(c.get('name'), 'config')
        text(c.get('source'), 'config source')
        for k in c.get('reduced', []):
            name(k, 'reduced key')
    for w in manifest.get('workloads', []):
        for k in ('name', 'config', 'traffic'):
            name(w.get(k), f'workload {k}')
        text(w.get('why'), 'workload why')
        if w.get('chips') not in (1, 4):
            out.append(f'workload {w.get("name")}: chips must be 1 or 4')
    seen = set()
    for group in ('end_to_end', 'per_layer'):
        for m in manifest.get(group, []):
            name(m.get('name'), f'{group} metric')
            if m.get('name') in seen:
                out.append(f'metric {m.get("name")} twice')
            seen.add(m.get('name'))
            if not isinstance(m.get('unit'), str) or \
                    not UNIT.match(m['unit']):
                out.append(f'metric {m.get("name")}: bad unit '
                           f'{m.get("unit")!r}')
            if m.get('better') not in ('lower', 'higher'):
                out.append(f'metric {m.get("name")}: bad better')
            if group == 'per_layer':
                text(m.get('layer'), 'layer')
    for group in ('configs', 'workloads'):
        names = [e.get('name') for e in manifest.get(group, [])]
        if len(names) != len(set(names)):
            out.append(f'{group}: a name twice')
    for word in manifest.get('command', []):
        text(word, 'command word')
    return out


def value(reader, run) -> Optional[float]:
    v = reader.read(run)
    return None if v is None else float(v)
