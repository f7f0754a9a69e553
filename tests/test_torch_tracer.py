"""The port's tracer (chipmunk_torch/utils/profiling.py): off, a span is
one shared no-op object and records nothing; on (a torch profiler, or
``recording()``), spans keep their order and depth, land on the exported
trace's clock around the profiler's own events, and a new region clears
the record; a tiny FLUX loop opens one step span per step of its plan,
named by its kind, and selection spans only where the plan selects."""
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from chipmunk_torch.config import config_from_dict
from chipmunk_torch.models import (FluxModelConfig, FluxSampler, FluxSparse,
                                   get_schedule, init_flux_params)
from chipmunk_torch.schedule import step_plan
from chipmunk_torch.utils import profiling as P

H_IMG, W_IMG, TXT = 16, 24, 128
TINY = dict(in_channels=16, vec_in_dim=32, context_in_dim=32,
            hidden_size=128, num_heads=2, mlp_ratio=4.0, depth=2,
            depth_single_blocks=2, axes_dim=(16, 24, 24),
            guidance_embed=False, txt_len=TXT)
CK = {'attn': {'top_keys': 0.4, 'kv_block': 32, 'counts_multiple_of': 32,
               'first_n_dense_layers': 1, 'should_compress_indices': False,
               'mbm': 128, 'full_step_every': 5, 'recompute_mask': True},
      'mlp': {'top_keys': 0.5, 'neuron_block': 128, 'bm': 128,
              'counts_multiple_of': 128, 'first_n_dense_layers': 1,
              'random_keys': 0.0, 'full_step_every': 5},
      'patchify': {'chunk_size_1': 4, 'chunk_size_2': 2}, 'steps': 12,
      'step_caching': {'is_enabled': True, 'skip_step_schedule': {3, 7, 8}}}


def test_off_span_is_the_shared_no_op_and_records_nothing():
    with P.recording():
        with P.span('kept'):
            pass
    before = P.spans()
    a, b = P.span('x'), P.span('y', sync=torch.ones(1))
    assert a is b
    with a:
        with P.span('inner'):
            pass
    assert P.spans() == before and [s.name for s in before] == ['kept']


def test_spans_nest_in_order_on_the_profilers_clock(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.span('outer'):
            with P.span('inner'):
                with record_function('op_inside'):
                    torch.ones(8).sum()
            with P.span('second'):
                pass
    got = P.spans()
    assert [(s.name, s.depth) for s in got] == [('outer', 0), ('inner', 1),
                                                ('second', 1)]
    outer, inner, second = got
    assert outer.start_ns <= inner.start_ns <= inner.end_ns \
        <= second.start_ns <= second.end_ns <= outer.end_ns
    path = str(tmp_path / 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    base = int(data['baseTimeNanoseconds'])
    (ev,) = [e for e in data['traceEvents'] if e.get('name') == 'op_inside'
             and e.get('ph') == 'X']
    start = base + round(float(ev['ts']) * 1e3)
    end = start + round(float(ev['dur']) * 1e3)
    # the trace's microseconds hold three decimals: a ns of rounding
    assert inner.start_ns - 1 <= start <= end <= inner.end_ns + 1


def test_a_new_region_clears_the_record():
    for name in ('first', 'second'):
        with profile(activities=[ProfilerActivity.CPU]):
            with P.span(name):
                pass
        assert [s.name for s in P.spans()] == [name]
    with P.recording():
        with P.span('third'):
            with P.recording():          # nested: the same region
                with P.span('fourth'):
                    pass
    assert [s.name for s in P.spans()] == ['third', 'fourth']
    with profile(activities=[ProfilerActivity.CPU]):
        pass
    assert P.spans() == []


def test_paused_records_nothing_and_keeps_the_region():
    with P.recording():
        with P.span('before'):
            pass
        with P.paused():
            assert P.span('captured') is P.span('other')
            with P.span('captured'):
                pass
        with P.span('after'):
            pass
    assert [s.name for s in P.spans()] == ['before', 'after']


def test_profile_region_shows_the_spans_on_the_host_row(tmp_path):
    logdir = str(tmp_path / 'profiles')
    with P.profile_region(logdir):
        with P.span('region_span'):
            torch.ones(4).sum()
    assert [s.name for s in P.spans()] == ['region_span']
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as f:
        events = json.load(f)['traceEvents']
    assert any(e.get('name') == 'region_span' and e.get('ph') == 'X'
               for e in events)


def test_step_timer_reads_the_record():
    t = P.StepTimer()
    with t.span('denoise', sync=torch.device('cpu')):
        with P.span('inside'):
            pass
    assert [s.name for s in P.spans()] == ['denoise', 'inside']
    assert t.summary()['denoise']['count'] == 1
    rec = P.spans()[0]
    assert t.records['denoise'] == [(rec.end_ns - rec.start_ns) / 1e9]


def tiny_sampler():
    ck = config_from_dict(CK)
    tm = FluxModelConfig(**TINY, dtype=torch.float32)
    params = init_flux_params(torch.Generator().manual_seed(0), tm, 'cpu')
    sampler = FluxSampler(cfg=tm, ck=ck,
                          sp=FluxSparse.build(ck, tm, TXT + H_IMG * W_IMG),
                          h_img=H_IMG, w_img=W_IMG, device='cpu')
    g = torch.Generator().manual_seed(0)
    inputs = (torch.randn(1, H_IMG * W_IMG, 16, generator=g),
              torch.randn(1, TXT, 32, generator=g),
              torch.randn(1, 32, generator=g))
    return ck, params, sampler, inputs


def steps_of(spans):
    """[(step span name, names of the spans inside it)] in order."""
    out = []
    for s in spans:
        if s.name.startswith('step.'):
            out.append((s.name, []))
        elif out and s.depth > 0:
            out[-1][1].append(s.name)
    return out


@pytest.mark.parametrize('loop', ['host', 'compiled'])
def test_flux_loop_opens_a_step_span_per_step_of_the_plan(loop):
    ck, params, sampler, inputs = tiny_sampler()
    ts = get_schedule(ck.steps, H_IMG * W_IMG)
    run = sampler.denoise if loop == 'host' else sampler.denoise_compiled
    with P.recording():
        run(params, *inputs, ts)
    plan = step_plan(ck)
    # the compiled loop folds skipped steps into the computed ones
    kinds = [k for i, k in enumerate(plan)
             if loop == 'host' or not (k.skip and i > 0)]
    want = ['step.skip' if k.skip and i > 0 else
            'step.sparse' if not (k.full_attn and k.full_mlp)
            else 'step.full' for i, k in enumerate(kinds)]
    got = steps_of(P.spans())
    assert [name for name, _ in got] == want
    assert 'step.sparse' in want and 'step.full' in want
    for k, (name, inner) in zip(kinds, got):
        assert ('attn.select' in inner) == k.colsum
        assert ('mlp.select' in inner) == \
            (k.recompute_mlp_mask and not k.full_mlp and name != 'step.skip')
        blocks = [n for n in inner if n.startswith('block.')]
        assert blocks == ([] if name == 'step.skip' else
                          ['block.double'] * 2 + ['block.single'] * 2)
        if name != 'step.skip':
            assert inner.count('attn') == inner.count('mlp') == 4
            assert inner[0] == 'embed' and inner[-1] == 'final'
    assert P.spans()[0].name == 'generate.setup'


def test_flux_loop_with_chipmunk_off_opens_only_full_steps():
    _, params, sampler, inputs = tiny_sampler()
    off = config_from_dict(dict(
        CK, attn=dict(CK['attn'], is_enabled=False),
        mlp=dict(CK['mlp'], is_enabled=False),
        step_caching=dict(CK['step_caching'], is_enabled=False)))
    sampler = FluxSampler(cfg=sampler.cfg, ck=off,
                          sp=FluxSparse.build(off, sampler.cfg,
                                              TXT + H_IMG * W_IMG),
                          h_img=H_IMG, w_img=W_IMG, device='cpu')
    with P.recording():
        sampler.denoise(params, *inputs, get_schedule(off.steps,
                                                      H_IMG * W_IMG))
    got = steps_of(P.spans())
    assert [n for n, _ in got] == ['step.full'] * off.steps
    assert not any('select' in n for _, inner in got for n in inner)
