"""The benchmark's span readers (benchmarks/core/spans.py and the five
metrics that read it) on a small synthetic Chrome trace with synthetic
program spans: each reads its hand-computed value, the readers that were
there before read theirs unchanged, a trace without spans (a program
without the tracer) reads None, a trace whose device events cannot be
joined to their launches by order keeps only the host-side metrics, and
the join holds through lost last records, a device clock behind the
host's and swapped neighbours.
On the card (``-m cuda``): a span around one launch holds that launch's
runtime event on the exported trace's clock, and its kernel is joined
to it."""
import json
import os
import types

import pytest
import torch

from benchmarks.core import spans as S
from benchmarks.core.loader import load_module
from benchmarks.core.trace import Trace, from_chrome
from chipmunk_torch.utils import profiling as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = 7889238 * 227 * 10 ** 9     # a quarter-year boundary, as Kineto's
T0_US = 5e6                        # the first span, 5 s after it

# name, start, end, depth (microseconds after T0)
SPANS = [('generate', 0, 1000, 0), ('step.sparse', 100, 400, 1),
         ('block.single', 110, 390, 2), ('attn', 150, 250, 3),
         ('attn.select', 160, 200, 4), ('mlp', 260, 350, 3),
         ('mlp.select', 270, 300, 4), ('step.sparse', 500, 700, 1),
         ('block.double', 510, 690, 2), ('step.full', 800, 900, 1)]
# launch (runtime name, host start) -> device event (category, name,
# start, end), in order
LAUNCHED = [
    ('cudaLaunchKernel', 50, 'kernel', 'vectorized_elementwise_kernel', 60,
     70),
    ('cudaLaunchKernel', 120, 'kernel', 'layer_norm_kernel', 130, 140),
    ('cudaLaunchKernel', 165, 'kernel', 'topk_kernel', 170, 180),
    ('cudaLaunchKernel', 210, 'kernel', 'void attn_sm90_kernel<CspKeys<8>>',
     215, 245),
    ('cuLaunchKernel', 275, 'kernel', 'nvjet_tst_128x128', 280, 290),
    ('cudaLaunchKernelExC', 320, 'kernel',
     'void gemm_sm90_kernel<Mm1Bf16<256>>', 325, 340),
    ('cudaLaunchKernel', 360, 'kernel', 'add_kernel', 395, 420),
    ('cudaMemcpyAsync', 520, 'gpu_memcpy', 'Memcpy HtoD (Pageable)', 525,
     530),
    ('cudaLaunchKernel', 600, 'kernel', 'rope_kernel', 610, 640),
    ('cudaLaunchKernel', 820, 'kernel', 'mul_kernel', 830, 850)]
SYNC = ('cudaStreamSynchronize', 950, 990)


def chrome(launched=LAUNCHED, t0=T0_US):
    ev = []
    for rn, rs, cat, kn, ks, ke in launched:
        ev.append({'ph': 'X', 'cat': 'cuda_runtime', 'name': rn,
                   'ts': t0 + rs, 'dur': 2.0})
        ev.append({'ph': 'X', 'cat': cat, 'name': kn, 'ts': t0 + ks,
                   'dur': float(ke - ks)})
    ev.append({'ph': 'X', 'cat': 'cuda_runtime', 'name': SYNC[0],
               'ts': t0 + SYNC[1], 'dur': float(SYNC[2] - SYNC[1])})
    return from_chrome(ev)


def program(spans=SPANS, t0=T0_US):
    at = BASE + int(t0) * 1000
    return [P.Span(n, at + int(s * 1e3), at + int(e * 1e3), d)
            for n, s, e, d in spans]


@pytest.fixture
def bench_run(monkeypatch):
    """A run of the synthetic trace, the program's record set to
    ``spans`` (None: a program with no tracer)."""
    def make(spans=SPANS, launched=LAUNCHED, counts=None):
        if spans is None:
            monkeypatch.delattr(P, 'spans')
        else:
            record = program(spans)
            monkeypatch.setattr(P, 'spans', lambda: list(record),
                                raising=False)
        marks = {'denoise': 2.0, 'decode': 0.5}
        return types.SimpleNamespace(
            trace=chrome(launched), generations=1, window_s=3.0,
            setup_s=1.0, peak_bytes=0, counts=counts or {},
            span=marks.get)
    return make


def read(metric, run):
    path = os.path.join(ROOT, 'benchmarks', 'metrics', f'{metric}.py')
    return load_module(path, f'test_metric_{metric}').read(run)


NEW = {'sparse_step_host_ms': 0.25,          # 300 and 200 us
       'sparse_step_launches': 4,            # 6 and 2 launches
       # unions 10+10+30+10+15+25 and 5+30 us
       'sparse_step_device_ms': 0.0675,
       'select_ms': 0.020,                   # topk 10 + nvjet 10 us
       # layer norm 10, add 25, the copy 5, rope 30 us
       'block_glue_ms': 0.070}


@pytest.mark.parametrize('metric', sorted(NEW))
def test_new_readers_read_their_hand_computed_values(bench_run, metric):
    assert read(metric, bench_run()) == pytest.approx(NEW[metric])


@pytest.mark.parametrize('metric', sorted(NEW))
def test_new_readers_read_none_without_spans(bench_run, metric):
    assert read(metric, bench_run(spans=None)) is None
    assert read(metric, bench_run(spans=[])) is None


@pytest.mark.parametrize('metric', sorted(NEW))
def test_a_device_clock_behind_the_host_joins_the_same(bench_run, metric):
    # the card's clock as read on the host's: up to 26 us early
    run = bench_run()
    run.trace.kernels[:] = [(n, s - 26, e - 26)
                            for n, s, e in run.trace.kernels]
    assert read(metric, run) == pytest.approx(NEW[metric])


@pytest.mark.parametrize('metric', sorted(NEW))
def test_records_lost_at_the_end_join_the_same(bench_run, metric):
    # the profiler lost the last launch's kernel (in step.full)
    run = bench_run()
    run.trace.kernels.pop()
    assert read(metric, run) == pytest.approx(NEW[metric])


def long_trace(n=1000):
    """n launches 10 us apart, every fourth a memset, each event 2 us
    after its launch."""
    rt, dev = [], []
    for i in range(n):
        memset = i % 4 == 3
        rt.append(('cudaMemsetAsync' if memset else 'cudaLaunchKernel',
                   10.0 * i, 10.0 * i + 1))
        dev.append(('Memset (Device)' if memset else f'kernel_{i}',
                    10.0 * i + 2, 10.0 * i + 3))
    return rt, dev


@pytest.mark.parametrize('case,joins', [
    ('whole', True), ('neighbours_swapped', True), ('last_three_lost', True),
    ('one_lost_in_the_middle', False), ('one_more_event', False)])
def test_the_join_holds_where_copies_and_memsets_line_up(case, joins):
    rt, dev = long_trace()
    if case == 'neighbours_swapped':      # a memset and a kernel
        dev[503], dev[504] = (dev[503][0], 10.0 * 504 + 2, 10.0 * 504 + 3), \
            (dev[504][0], 10.0 * 503 + 2, 10.0 * 503 + 3)
    elif case == 'last_three_lost':
        dev = dev[:-3]
    elif case == 'one_lost_in_the_middle':
        dev.pop(300)
    elif case == 'one_more_event':
        dev.append(('extra', 1e5, 1e5 + 1))
    launches = sorted((s, n) for n, s, _ in rt)
    assert (S._join(Trace(kernels=dev, runtime=rt), launches)
            is not None) == joins


@pytest.mark.parametrize('metric', sorted(NEW))
def test_a_failed_join_keeps_only_the_host_side_readers(bench_run, metric):
    # a launch whose device event is missing: the order no longer joins
    run = bench_run(launched=LAUNCHED[:3] + [
        ('cudaLaunchKernel', 200, 'kernel', 'x', 201, 202)] + LAUNCHED[3:])
    run.trace.kernels.pop(3)
    host = {'sparse_step_host_ms': 0.25, 'sparse_step_launches': 4.5}
    assert read(metric, run) == (pytest.approx(host[metric])
                                 if metric in host else None)


# the readers that were there before: the values the trace gives them
OLD = {'glue_ms': 0.110,                     # 10+10+10+25+5+30+20 us
       'device_idle_pct': 100 * (940 - 165) / 940,
       'attn_roofline': 100 * 15e-6 / 30e-6,
       'csp_mlp_roofline': 100 * 7.5e-6 / 15e-6,
       'denoise_s': 2.0, 'decode_s': 0.5,
       'gen_mfu': 100 * 989e12 / (2.5 * 989e12)}


@pytest.mark.parametrize('metric', sorted(OLD))
def test_old_readers_read_as_before(bench_run, metric):
    run = bench_run(counts={'attn_bound_s': 15e-6, 'mlp_bound_s': 7.5e-6,
                            'flops': 989e12})
    assert read(metric, run) == pytest.approx(OLD[metric])


def test_launch_paths_coverage_and_named_gaps(bench_run):
    run = bench_run()
    p = S.placed(run.trace, program())
    assert [path[-1] for _, path in p.launches] == [
        'generate', 'block.single', 'attn.select', 'attn', 'mlp.select',
        'mlp', 'block.single', 'block.double', 'block.double', 'step.full']
    assert [d[3] for d in p.device] == [path for _, path in p.launches]
    cov = S.coverage(run.trace, p)
    assert cov['device_in_spans'] == pytest.approx(1.0)
    # every gap but the last (140 us after the last kernel) ends at an
    # event launched in a span
    assert cov['idle_in_spans'] == pytest.approx((775 - 140) / 775)
    gaps = S.idle_gaps(run.trace, p, 3)
    assert gaps[0] == ['host before mul_kernel [step.full]',
                       pytest.approx(190e-6)]
    assert gaps[1] == ['host after the last kernel', pytest.approx(140e-6)]
    assert gaps[2] == ['host before Memcpy HtoD (Pageable) '
                       '[step.sparse/block.double]', pytest.approx(105e-6)]
    # the trace's own names and lengths are these, in the same order
    assert [[n.split(' [')[0], s] for n, s in gaps] == \
        run.trace.idle_gaps(3)


def test_the_clock_is_found_across_a_quarter_year_boundary():
    # Kineto took its base at BASE; the first span opens 0.1 s after the
    # next quarter-year boundary
    t0 = 7889238 * 10 ** 6 + 1e5
    p = S.placed(chrome(t0=t0), program(t0=t0))
    assert p is not None and p.spans[0][1] == pytest.approx(t0)
    assert [path[-1] for _, path in p.launches][:3] == [
        'generate', 'block.single', 'attn.select']


@pytest.mark.cuda
def test_cuda_a_span_holds_its_launch_and_its_kernel(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the launch is a CUDA one')
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1 << 20, device='cuda')
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        y = x + 1
        with P.span('one'):
            y = y * 2
        y = y - 1
        torch.cuda.synchronize()
    (one,) = P.spans()
    path = str(tmp_path / 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    base = int(data['baseTimeNanoseconds'])
    assert base == (one.start_ns // (7889238 * 10 ** 9)) * 7889238 * 10 ** 9
    ev = [e for e in data['traceEvents'] if e.get('ph') == 'X']
    kernels = sorted((e for e in ev if e.get('cat') == 'kernel'),
                     key=lambda e: e['ts'])
    assert len(kernels) == 3
    corr = kernels[1]['args']['correlation']
    (launch,) = [e for e in ev if e.get('cat') == 'cuda_runtime'
                 and e.get('args', {}).get('correlation') == corr]
    assert one.start_ns <= base + launch['ts'] * 1e3 <= one.end_ns
    p = S.placed(from_chrome(data['traceEvents']))
    assert p is not None and p.device is not None
    assert [d[3] for d in p.device] == [(), ('one',), ()]
    assert p.device[1][1] == pytest.approx(kernels[1]['ts'])
