"""A whole run of run.py on the CPU at a tiny size: the window, the
metrics, the check against the reference, and the check failing when
the timed path is broken underneath."""
import pytest
import torch


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('traffic', ['sparse.b1', 'dense.b1'])
def test_tiny_run_is_correct(tiny_bench, run_main, capsys, traffic):
    root, bench = tiny_bench
    rc, res, err = run_main(root, bench, f'tiny.{traffic}', seed=2 ** 33 + 5,
                            capsys=capsys)
    assert rc == 0, err
    assert res['correct'] is True, res
    assert res['attempted'] == 1 and res['failed'] == 0
    assert set(res['metrics']) == {'gen_s', 'peak_mem_gib', 'setup_s'} - \
        {'peak_mem_gib'}          # nothing on the card: no peak
    assert list(res)[-1] == 'checks'
    assert err.strip().splitlines()[-1].startswith('check ')


def test_tiny_traced_run_reads_the_spans(tiny_bench, run_main, capsys):
    root, bench = tiny_bench
    rc, res, err = run_main(root, bench, 'tiny.sparse.b1', seed=3, trace=1,
                            capsys=capsys)
    assert rc == 0, err
    assert res['correct'] is True
    # no card: nothing from a device trace, the spans and the count only
    assert set(res['metrics']) == {'denoise_s', 'decode_s', 'gen_mfu'}
    assert 'breakdown' not in res


def _keep_state(orig):
    """A step that computes its output but returns its state unchanged."""
    def step(self, *a, **k):
        out, _ = orig(self, *a, **k)
        state = next(x for x in a if isinstance(x, tuple))
        return out, state
    return step


def _sparse_keeps_caches(orig):
    """A sparse MLP step that computes its output but leaves its caches as
    they were (the kernels update them in place: they are put back)."""
    def step(self, x, w1t, b1, w2, state, **k):
        out_c, act_c = state.out_cache.clone(), state.act_cache.clone()
        out, st = orig(self, x, w1t, b1, w2, state, **k)
        state.out_cache.copy_(out_c)
        state.act_cache.copy_(act_c)
        return out, st._replace(out_cache=state.out_cache,
                                act_cache=state.act_cache)
    return step


def _sparse_attn_alters_cache(orig):
    """A sparse attention step that returns its output right but halves
    its output cache, which the next steps read."""
    def step(self, q, k, v, state):
        out, st = orig(self, q, k, v, state)
        return out, st._replace(out_cache=(st.out_cache.float() * 0.5)
                                .to(st.out_cache.dtype))
    return step


def _alter_pixels(orig):
    """The decoder's answer altered where it is produced: a quarter of
    the image set to zero."""
    def decode(*a, **k):
        pix = orig(*a, **k).clone()
        pix[..., :pix.shape[-2] // 2, :pix.shape[-1] // 2] = 0
        return pix
    return decode


def _stalled_step(orig):
    """Step 1 predicts nothing: its prediction zero, so the latent leaves
    it unchanged."""
    def forward(*a, **k):
        pred, state = orig(*a, **k)
        step = a[9] if len(a) > 9 else k['step']
        return (pred * 0 if step.index == 1 else pred), state
    return forward


def _update_skipped(orig):
    """The sampler's Euler loop with step 3's update left out: the step
    computes its prediction and returns the latent unchanged."""
    from chipmunk_torch.models.flux import FluxStep
    from chipmunk_torch.schedule import step_plan

    def _euler(self, img, timesteps, callback, predict):
        plan = step_plan(self.ck)
        ts = torch.as_tensor(timesteps, dtype=torch.float32).tolist()
        pred = None
        for i in range(min(len(plan), len(ts) - 1)):
            dt = ts[i + 1] - ts[i]
            if plan[i].skip and pred is not None:
                img = img + dt * pred
                continue
            t = torch.full((img.shape[0],), ts[i], dtype=torch.float32,
                           device=self.device)
            pred = predict(img, t, FluxStep.of(plan[i], i))
            if i != 3:
                img = img + dt * pred.float()
        return self.unpatchify_img(img)
    return _euler


FAULTS = {
    'mlp_full_step_keeps_state': ('chipmunk_torch.modules.mlp',
                                  'SparseDiffMlp.full_step', _keep_state),
    'attn_colsum_step_keeps_state': ('chipmunk_torch.modules.attn',
                                     'SparseDiffAttn.full_step_colsum',
                                     _keep_state),
    'mlp_sparse_step_keeps_caches': ('chipmunk_torch.modules.mlp',
                                     'SparseDiffMlp.sparse_step',
                                     _sparse_keeps_caches),
    'attn_sparse_step_alters_cache': ('chipmunk_torch.modules.attn',
                                      'SparseDiffAttn.sparse_step',
                                      _sparse_attn_alters_cache),
    'euler_step_keeps_latent': ('chipmunk_torch.models.sampling',
                                'flux_forward', _stalled_step),
    'euler_update_left_out': ('chipmunk_torch.models.sampling',
                              'FluxSampler._euler', _update_skipped),
    'pixels_altered': ('chipmunk_torch.models', 'decode', _alter_pixels),
}


@pytest.mark.parametrize('traffic, fault', [
    ('sparse.b1', 'mlp_full_step_keeps_state'),
    ('sparse.b1', 'attn_colsum_step_keeps_state'),
    ('sparse.b1', 'mlp_sparse_step_keeps_caches'),
    ('sparse.b1', 'attn_sparse_step_alters_cache'),
    ('sparse.b1', 'euler_step_keeps_latent'),
    ('sparse.b1', 'euler_update_left_out'),
    ('sparse.b1', 'pixels_altered'),
    ('dense.b1', 'euler_step_keeps_latent'),
    ('dense.b1', 'euler_update_left_out'),
    ('dense.b1', 'pixels_altered'),
])
def test_broken_timed_path_is_not_correct(tiny_bench, run_main, capsys,
                                          monkeypatch, traffic, fault):
    import importlib
    mod_name, attr, wrap = FAULTS[fault]
    mod = importlib.import_module(mod_name)
    owner, name = (getattr(mod, attr.split('.')[0]), attr.split('.')[1]) \
        if '.' in attr else (mod, attr)
    monkeypatch.setattr(owner, name, wrap(getattr(owner, name)))
    root, bench = tiny_bench
    rc, res, err = run_main(root, bench, f'tiny.{traffic}', seed=11,
                            capsys=capsys)
    assert rc == 0, err
    assert res['correct'] is False, res['checks']
