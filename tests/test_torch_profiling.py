"""The port's profiler region and step timer (chipmunk_torch/utils/
profiling.py), the counterpart of chipmunk_tpu/utils/profiling.py: a
trace file appears under the log directory only when the region is
enabled and warmed up, and it records the region's ops; StepTimer counts
spans and summarises them as the reference's does."""
import json
import os

import pytest
import torch

from chipmunk_tpu.utils import profiling as jprof
from chipmunk_torch.utils.profiling import StepTimer, profile_region


def traces(d):
    return sorted(f for f in os.listdir(d) if f.endswith('.json')) \
        if os.path.isdir(d) else []


def test_profile_region_writes_a_trace(tmp_path):
    logdir = str(tmp_path / 'profiles')
    with profile_region(logdir) as prof:
        x = torch.randn(32, 32)
        torch.mm(x, x)
    assert prof is not None
    (name,) = traces(logdir)
    with open(os.path.join(logdir, name)) as f:
        events = json.load(f)['traceEvents']
    assert any(e.get('name') == 'aten::mm' for e in events)


@pytest.mark.parametrize('enabled,warmup_done', [(False, True),
                                                 (True, False),
                                                 (False, False)])
def test_profile_region_off_writes_nothing(tmp_path, enabled, warmup_done):
    logdir = str(tmp_path / 'profiles')
    with profile_region(logdir, enabled=enabled,
                        warmup_done=warmup_done) as prof:
        torch.ones(4).sum()
    assert prof is None and traces(logdir) == []


def test_profile_region_raises_what_fails_inside(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with profile_region(str(tmp_path)):
            1 / 0


def test_step_timer_counts_like_the_reference():
    got, ref = StepTimer(), jprof.StepTimer()
    for t in (got, ref):
        for name in ('denoise', 'decode', 'denoise'):
            with t.span(name, sync=torch.ones(2)):
                pass
    s, r = got.summary(), ref.summary()
    assert sorted(s) == sorted(r) == ['decode', 'denoise']
    for name in s:
        assert s[name]['count'] == r[name]['count']
        assert s[name]['total_s'] >= 0 and s[name]['min_ms'] <= \
            s[name]['mean_ms']
    lines = []
    got.log(lines.append)
    assert [ln.split(':')[0] for ln in lines] == ['decode', 'denoise']
    assert 'n=2' in lines[1]
    with got.span('cpu', sync=torch.device('cpu')):
        pass
    with got.span('tree', sync=[torch.ones(1), {'a': torch.zeros(1)}]):
        pass
    assert got.summary()['tree']['count'] == 1
