"""The port's host-offloaded, layer-chunked runner (``models/streamed.py``,
``utils/offload.py``, ``utils/streaming.py``) and its entry points against
chipmunk_tpu and against the port's own resident runs, on the CPU at the
tiny configs of tests/test_streamed_forward.py (float32).

Against the port's resident runs a streamed run must be equal bit for bit
(``torch.equal``): the same block calls in the same order, the same
generator; the CPU copies every placement and writeback, so a stale host
copy or a chunk-local layer index shows here.  Against the reference the
tolerance of the model tests (1e-4), with attn.random_keys and
mlp.random_keys 0 (torch cannot draw jax.random's keeps; see
tests/test_torch_hunyuan.py); the reference runs its eager oracles
(use_kernels=False).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chipmunk_tpu.config import config_from_dict as j_config_from_dict
from chipmunk_tpu.models import FluxModelConfig as JModel
from chipmunk_tpu.models import FluxSparse as JSparse
from chipmunk_tpu.models import init_flux_params as j_init_flux_params
from chipmunk_tpu.models.flux import FluxStep as JStep
from chipmunk_tpu.models.flux import flux_forward as j_flux_forward
from chipmunk_tpu.models.hunyuan import HunyuanModel as JHunyuan
from chipmunk_tpu.models.hunyuan import HunyuanModelConfig as JVideo
from chipmunk_tpu.models.hunyuan import init_hunyuan_params as j_init_video
from chipmunk_tpu.models.sampling import FluxSampler as JSampler
from chipmunk_tpu.models.streamed import StreamedFluxState as JStreamedState
from chipmunk_tpu.models.video_sampling import hunyuan_denoise as j_denoise
from chipmunk_tpu.utils import offload as joff
from chipmunk_tpu.utils.streaming import StreamedScan as JStreamedScan
from chipmunk_tpu.utils.streaming import chunk_tree as j_chunk_tree
from chipmunk_torch.config import config_from_dict
from chipmunk_torch.models import (FluxModelConfig, FluxSampler, FluxSparse,
                                   FluxStep, HunyuanModel,
                                   HunyuanModelConfig, StreamedFluxRunner,
                                   StreamedFluxState, flux_forward,
                                   hunyuan_denoise, params_from_jax)
from chipmunk_torch.utils import (DoubleBufferedLoader, OffloadPolicy,
                                  StreamedScan, chunk_tree, fetch_to_device,
                                  offload_to_host, unchunk_tree)
from chipmunk_torch.utils import offload

TOL = dict(atol=1e-4, rtol=1e-4)
H_IMG, W_IMG, TXT = 16, 24, 128
SEQ = TXT + H_IMG * W_IMG
TINY = dict(in_channels=16, vec_in_dim=32, context_in_dim=32, hidden_size=128,
            num_heads=2, mlp_ratio=4.0, depth=2, depth_single_blocks=4,
            axes_dim=(16, 24, 24), guidance_embed=False, txt_len=TXT)
SPARSE = {'attn': {'top_keys': 0.4, 'kv_block': 32, 'counts_multiple_of': 32,
                   'first_n_dense_layers': 1, 'should_compress_indices': False,
                   'random_keys': 0.0, 'recompute_mask': True, 'mbm': 128},
          'mlp': {'top_keys': 0.5, 'neuron_block': 128, 'bm': 128,
                  'counts_multiple_of': 128, 'first_n_dense_layers': 1,
                  'random_keys': 0.0},
          'patchify': {'chunk_size_1': 4, 'chunk_size_2': 2}}
# first, colsum with MLP re-selection, sparse with and without it, a
# plain full step: (index, full_attn, full_mlp, colsum, recompute_mlp_mask)
KINDS = [(0, True, True, False, False), (1, True, False, True, True),
         (2, False, False, False, True), (3, False, False, False, False),
         (4, True, True, False, False)]
EVERYTHING = OffloadPolicy(attn_out_cache=True, attn_indices=True,
                           attn_counts=True, attn_lse=True,
                           mlp_out_cache=True, mlp_act_cache=True,
                           mlp_indices=True, mlp_counts=True,
                           mlp_bm_mid=True)


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """These tensors are small enough that torch's intra-op threads only
    contend with the other test processes' (70x slower under a loaded
    CPU); the runs compared bit for bit share the setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def equal_trees(a, b):
    la, lb = offload.tree_leaves(a), offload.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)


@pytest.fixture(scope='module')
def flux():
    """The tiny FLUX on both sides, its inputs, and the reference's
    predictions over KINDS (resident, eager oracles)."""
    jm = JModel(**TINY, dtype=jnp.float32)
    tm = FluxModelConfig(**TINY, dtype=torch.float32)
    params = j_init_flux_params(jax.random.PRNGKey(0), jm)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              device='cpu')
    rng = np.random.default_rng(0)
    img = rng.standard_normal((1, H_IMG * W_IMG, 16)).astype(np.float32)
    txt = rng.standard_normal((1, TXT, 32)).astype(np.float32)
    y = rng.standard_normal((1, 32)).astype(np.float32)
    jck, ck = j_config_from_dict(SPARSE), config_from_dict(SPARSE)
    jsp = JSparse.build(jck, jm, SEQ, use_kernels=False)
    js = JSampler(cfg=jm, ck=jck, sp=jsp, h_img=H_IMG, w_img=W_IMG)
    jst, jpe, preds = jsp.init_state(jm, 1), js.rope(1), []
    for i, kind in enumerate(KINDS):
        t = np.full((1,), 1.0 - 0.15 * i, np.float32)
        p, jst = j_flux_forward(params, jm, jsp, jnp.asarray(img + 0.05 * i),
                                jnp.asarray(txt), jnp.asarray(t),
                                jnp.asarray(y), jpe, jst, JStep(*kind),
                                key=jax.random.PRNGKey(i))
        preds.append(np.asarray(p))
    return dict(tm=tm, ck=ck, tparams=tparams, img=img, txt=txt, y=y,
                preds=preds, params=params, jm=jm, jck=jck)


def run_both(f, ck, policy, n_double, n_single, kinds=KINDS, **runner_kw):
    """The port's resident flux_forward and its streamed runner step by
    step over ``kinds`` from the same init; after each step the
    predictions and the gathered state must be equal.  Returns the
    streamed predictions and state."""
    tm = f['tm']
    sp = FluxSparse.build(ck, tm, SEQ)
    sampler = FluxSampler(cfg=tm, ck=ck, sp=sp, h_img=H_IMG, w_img=W_IMG,
                          device='cpu')
    pe = sampler.rope(1)
    state = sp.init_state(tm, 1, device='cpu')
    sst = StreamedFluxState.create_hostwise(sp, tm, 1, n_double, n_single,
                                            policy, device='cpu')
    runner = StreamedFluxRunner(cfg=tm, sp=sp, **runner_kw)
    g_res = torch.Generator().manual_seed(11)
    g_str = torch.Generator().manual_seed(11)
    preds = []
    for i, kind in enumerate(kinds):
        args = (torch.from_numpy(f['img'] + 0.05 * i),
                torch.from_numpy(f['txt']),
                torch.full((1,), 1.0 - 0.15 * i), torch.from_numpy(f['y']),
                pe)
        p_r, state = flux_forward(f['tparams'], tm, sp, *args[:4], pe, state,
                                  FluxStep(*kind), generator=g_res)
        p_s = runner.forward(f['tparams'], sst, *args, FluxStep(*kind),
                             generator=g_str)
        assert torch.equal(p_s, p_r), f'step {i} ({kind}) differs'
        equal_trees(sst.gather(), state)
        preds.append(p_s)
    return preds, sst


@pytest.mark.parametrize('policy,n_double,n_single,kw', [
    (EVERYTHING, 2, 2, {}),                       # 2 chunks per stage
    (OffloadPolicy(), 1, 2, {}),                  # the partial policy
    (EVERYTHING, 2, 4, dict(resident_chunks=0, prefetch_depth=3)),
])
def test_streamed_forward_matches_resident_and_reference(flux, policy,
                                                         n_double, n_single,
                                                         kw):
    """Every step kind: equal to the port's resident forward (predictions
    and gathered state after each step) and to the reference's."""
    preds, sst = run_both(flux, flux['ck'], policy, n_double, n_single, **kw)
    for i, (p, ref) in enumerate(zip(preds, flux['preds'])):
        np.testing.assert_allclose(p.numpy(), ref, err_msg=f'step {i}',
                                   **TOL)
    # the policy's leaves are host buffers of one slab in every streamed
    # chunk, the others are not
    fa, fm = (policy.wants_host('attn_out_cache'),
              policy.wants_host('mlp_act_cache'))
    res = kw.get('resident_chunks', 1)
    for chunks in (sst.double, sst.single):
        for c in chunks[res:]:
            for a, m in c:
                assert (offload.slab_of(a.out_cache) is not None) == fa
                assert (offload.slab_of(a.lse) is not None) == \
                    policy.wants_host('attn_lse')
                assert (offload.slab_of(m.act_cache) is not None) == fm
    assert sst.host_bytes() > 0


def test_streamed_draws_the_resident_keeps(flux):
    """Random keeps on (compressed attention indices and the MLP's
    re-selection, drawn from the one generator): the streamed runner
    draws them in the resident order.  Port against port only: torch
    cannot draw the reference's keeps."""
    d = dict(SPARSE, attn=dict(SPARSE['attn'], should_compress_indices=True,
                               random_keys=0.2),
             mlp=dict(SPARSE['mlp'], random_keys=0.2))
    run_both(flux, config_from_dict(d), EVERYTHING, 2, 2)


def test_sparse_attention_step_without_mlp_writes_nothing_back(flux):
    """With the MLP off a sparse step mutates no cache: it fetches the
    streamed chunks' attention caches and issues no D2H copy; the full
    steps write them back."""
    d = dict(SPARSE, mlp={'is_enabled': False},
             attn=dict(SPARSE['attn'], should_compress_indices=True))
    kinds = [(0, True, True, False, False), (1, True, True, True, False),
             (2, False, False, False, False)]
    tm = flux['tm']
    sp = FluxSparse.build(config_from_dict(d), tm, SEQ)
    sst = StreamedFluxState.create_hostwise(sp, tm, 1, 1, 2, OffloadPolicy(),
                                            device='cpu')
    runner = StreamedFluxRunner(cfg=tm, sp=sp)
    stats = []
    sampler = FluxSampler(cfg=tm, ck=config_from_dict(d), sp=sp,
                          h_img=H_IMG, w_img=W_IMG, device='cpu')
    for i, kind in enumerate(kinds):
        offload.reset_copy_stats()
        runner.forward(flux['tparams'], sst, torch.from_numpy(flux['img']),
                       torch.from_numpy(flux['txt']),
                       torch.full((1,), 1.0 - 0.2 * i),
                       torch.from_numpy(flux['y']), sampler.rope(1),
                       FluxStep(*kind), generator=torch.Generator())
        stats.append(dict(offload.COPY_STATS))
    # one streamed chunk (single blocks 2-3): its out_cache, inds and
    # packed leaves go each way on a full step, only to the device on a
    # sparse one
    streamed = [x for x in offload.tree_leaves(sst.single[1])
                if offload.slab_of(x) is not None]
    assert len(streamed) == 6
    assert [s['d2h'] for s in stats] == [6, 6, 0]
    assert stats[2]['h2d'] == 6
    assert stats[2]['h2d_bytes'] == sum(x.numel() * x.element_size()
                                        for x in streamed)


def test_create_hostwise_matches_create_and_reference(flux):
    """create_hostwise (no whole resident state) builds the state that
    create builds from sp.init_state, leaf for leaf, in one host slab;
    its leaves equal the reference's create_hostwise layer by layer."""
    tm, ck = flux['tm'], flux['ck']
    sp = FluxSparse.build(ck, tm, SEQ)
    policy = OffloadPolicy(mlp_act_cache=True)
    a = StreamedFluxState.create(sp.init_state(tm, 1, 'cpu'), 2, 2, policy,
                                 'cpu')
    b = StreamedFluxState.create_hostwise(sp, tm, 1, 2, 2, policy, 'cpu')
    equal_trees([a.double, a.single], [b.double, b.single])
    slabs = {id(offload.slab_of(x)) for x in
             offload.tree_leaves([b.double, b.single])
             if offload.slab_of(x) is not None}
    assert len(slabs) == 1
    # host: attention out_cache and indices, the MLP act cache
    a0, m0 = b.single[1][0]
    assert offload.slab_of(a0.out_cache) is not None
    assert offload.slab_of(a0.inds) is not None
    assert offload.slab_of(a0.lse) is None
    assert offload.slab_of(m0.act_cache) is not None
    assert offload.slab_of(m0.out_cache) is None
    jsp = JSparse.build(flux['jck'], flux['jm'], SEQ, use_kernels=False)
    jpol = joff.OffloadPolicy(mlp_act_cache=True)
    j = JStreamedState.create_hostwise(jsp, flux['jm'], 1, 2, 2, jpol)
    for tch, jch in ((b.double, j.double), (b.single, j.single)):
        for tc, (ja, jm_) in zip(tch, jch):
            for li, (ta, tmlp) in enumerate(tc):
                for tst, jst in ((ta, ja), (tmlp, jm_)):
                    for name in tst._fields:
                        x = getattr(tst, name)
                        if x is not None:
                            np.testing.assert_array_equal(
                                x.numpy(), np.asarray(getattr(jst, name)[li]))


def tiny_video(txt_len=72):
    kw = dict(latent_t=8, latent_h=8, latent_w=16, in_channels=4,
              patch_size=(1, 2, 2), hidden_size=128, num_heads=2,
              mlp_ratio=4.0, depth_double=2, depth_single=2,
              axes_dim=(16, 24, 24), theta=256, text_dim=64, txt_len=txt_len,
              vec_in_dim=32, guidance_embed=False, voxel_shape=(4, 4, 8))
    return JVideo(**kw, dtype=jnp.float32), \
        HunyuanModelConfig(**kw, dtype=torch.float32)


def test_hunyuan_denoise_streamed(flux):
    """hunyuan_denoise(..., streamed=model.make_streamed(2, 2)) with a
    skipped step and a padded prompt's txt_mask, as the config's
    offloading block asks (attention out_cache and indices host-side):
    equal to the resident loop, within TOL of the reference's streamed
    loop, and the mask reaches the refiner."""
    jc, tc = tiny_video()
    d = {'steps': 4,
         'attn': {'top_keys': 0.3, 'kv_block': 32, 'counts_multiple_of': 32,
                  'random_keys': 0.0, 'local_voxels': 1,
                  'first_n_dense_layers': 1, 'full_step_schedule': [0, 1],
                  'should_compress_indices': True, 'recompute_mask': True,
                  'dense_fallback_frac': 1.0},
         'mlp': {'is_enabled': False},
         'step_caching': {'is_enabled': True, 'skip_step_schedule': [2]},
         'offloading': {'attn.out_cache': True, 'attn.indices': True}}
    jm = JHunyuan(cfg=jc, ck=j_config_from_dict(d), use_kernels=False)
    tm = HunyuanModel(cfg=tc, ck=config_from_dict(d), device='cpu')
    params = j_init_video(jax.random.PRNGKey(0), jc)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              device='cpu')
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((1, 4, 8, 8, 16)).astype(np.float32)
    txt = rng.standard_normal((1, 72, 64)).astype(np.float32)
    y = rng.standard_normal((1, 32)).astype(np.float32)
    mask = np.arange(72)[None] < 40
    ts = np.linspace(1.0, 0.0, 5).astype(np.float32)
    out_j = j_denoise(jm, params, *map(jnp.asarray, (lat, txt, y)),
                      jnp.asarray(ts), key=jax.random.PRNGKey(5),
                      streamed=jm.make_streamed(2, 2),
                      txt_mask=jnp.asarray(mask))
    args = (tm, tparams, *map(torch.from_numpy, (lat, txt, y, ts)))
    out_r = hunyuan_denoise(*args, txt_mask=torch.from_numpy(mask))
    streamed = tm.make_streamed(2, 2)
    assert [len(streamed[1].double), len(streamed[1].single)] == [2, 2]
    calls = []
    out_s = hunyuan_denoise(*args, txt_mask=torch.from_numpy(mask),
                            streamed=streamed,
                            callback=lambda i, skipped: calls.append(skipped))
    assert calls == [False, False, True, False]
    assert torch.equal(out_s, out_r)
    np.testing.assert_allclose(out_s.numpy(), np.asarray(out_j), **TOL)
    unmasked = hunyuan_denoise(*args)
    assert (out_s - unmasked).abs().max() > 1e-4
    # make_streamed cuts the counts to divisors of the depth
    assert [len(c) for c in (tm.make_streamed(3, 5)[1].double,
                             tm.make_streamed(3, 5)[1].single)] == [2, 2]


def test_flux_denoise_streamed(flux):
    """FluxSampler.denoise_streamed over 6 steps with a skipped one, the
    config's offloading (make_streamed's default policy) and an explicit
    partial one: equal to denoise, within TOL of the reference's
    denoise."""
    d = dict(SPARSE, steps=6,
             attn=dict(SPARSE['attn'], full_step_every=4),
             mlp=dict(SPARSE['mlp'], full_step_every=4),
             step_caching={'is_enabled': True, 'skip_step_schedule': {3}})
    tm, tparams = flux['tm'], flux['tparams']
    ck = config_from_dict(d)
    sampler = FluxSampler(cfg=tm, ck=ck, sp=FluxSparse.build(ck, tm, SEQ),
                          h_img=H_IMG, w_img=W_IMG, device='cpu')
    inputs = tuple(map(torch.from_numpy, (flux['img'], flux['txt'],
                                          flux['y'])))
    jck = j_config_from_dict(d)
    js = JSampler(cfg=flux['jm'], ck=jck,
                  sp=JSparse.build(jck, flux['jm'], SEQ, use_kernels=False),
                  h_img=H_IMG, w_img=W_IMG)
    ts = np.linspace(1.0, 0.0, 7).astype(np.float32)
    out_j = js.denoise(flux['params'], *map(jnp.asarray, (flux['img'],
                                                          flux['txt'],
                                                          flux['y'])),
                       jnp.asarray(ts))
    out_r = sampler.denoise(tparams, *inputs, torch.from_numpy(ts))
    for policy in (None, EVERYTHING):
        calls = []
        out_s = sampler.denoise_streamed(
            tparams, *inputs, torch.from_numpy(ts),
            sampler.make_streamed(2, 2, policy=policy),
            callback=lambda i, skipped: calls.append(skipped))
        assert calls == [i == 3 for i in range(6)]
        assert torch.equal(out_s, out_r)
    np.testing.assert_allclose(out_s.numpy(), np.asarray(out_j), **TOL)


def test_chunk_tree_and_streamed_scan():
    """chunk_tree / unchunk_tree round trip; StreamedScan with params and
    state host-side equals the monolithic layer loop bit for bit, and the
    reference's StreamedScan within float32 rounding."""
    L, C = 8, 4
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((L, 4, 4)) * 0.3).astype(np.float32)
    layers = [{'w': torch.from_numpy(w[i])} for i in range(L)]
    chunks = chunk_tree(layers, C)
    assert len(chunks) == C and len(chunks[0]) == 2
    assert unchunk_tree(chunks) == layers
    with pytest.raises(AssertionError):
        chunk_tree(layers, 3)

    def body(x, wi, si, idx):
        y = torch.tanh(wi @ x + si)
        return y, y + idx

    x_ref, s_ref = torch.ones(4), []
    for i in range(L):
        x_ref, s = body(x_ref, torch.from_numpy(w[i]), torch.zeros(4),
                        float(i))
        s_ref.append(s)

    def chunk_fn(x, pc, sc, ic):
        new = []
        for p, s, i in zip(pc, sc, ic):
            x, s = body(x, p['w'], s, i)
            new.append(s)
        return x, new

    runner = StreamedScan(chunk_fn, chunks,
                          chunk_tree([torch.zeros(4)] * L, C),
                          offload_params=True, offload_state=True,
                          device='cpu')
    x = runner(torch.ones(4), chunk_tree([float(i) for i in range(L)], C))
    assert torch.equal(x, x_ref)
    for a, b in zip(runner.gathered_state(), s_ref):
        assert torch.equal(a, b)

    def j_body(x, layer):
        wi, si, idx = layer
        y = jnp.tanh(wi @ x + si)
        return y, y + idx

    def j_chunk(x, wc, sc, ic):
        return jax.lax.scan(j_body, x, (wc, sc, ic))

    idx = jnp.arange(L, dtype=jnp.float32)
    jr = JStreamedScan(j_chunk, j_chunk_tree(jnp.asarray(w), C),
                       j_chunk_tree(jnp.zeros((L, 4)), C),
                       offload_params=True)
    np.testing.assert_allclose(x.numpy(),
                               np.asarray(jr(jnp.ones(4),
                                             j_chunk_tree(idx, C))),
                               atol=1e-6)
    np.testing.assert_allclose(
        torch.stack(runner.gathered_state()).numpy(),
        np.asarray(jr.gathered_state()), atol=1e-6)


def test_double_buffered_loader_and_copies():
    """The reference's loader flow: a bounded window, store then get
    gives back what was stored (in the same host buffers), prefetched
    copies of a stored slice are dropped; offload_to_host refuses a buffer
    of another shape or dtype."""
    slices = [{'x': torch.full((4,), float(i))} for i in range(5)]
    hosted = [offload_to_host(s) for s in slices]
    ahead = DoubleBufferedLoader(hosted, depth=2, device='cpu')
    for i in range(5):
        ahead.prefetch(i)
        assert len(ahead._inflight) <= 2
    assert sorted(ahead._inflight) == [3, 4]
    loader = DoubleBufferedLoader(hosted, depth=2, device='cpu')
    bufs = [h['x'] for h in hosted]
    loader.prefetch(0)
    loader.prefetch(1)
    for i in range(5):
        cur = loader.get(i)
        loader.prefetch(i + 1)
        assert len(loader._inflight) <= 2
        assert float(cur['x'][0]) == float(i)
        loader.store(i, {'x': cur['x'] + 100.0})
        assert loader.host_slices()[i]['x'] is bufs[i]
    loader.prefetch(3)
    loader.store(3, {'x': torch.full((4,), -1.0)})
    assert float(loader.get(3)['x'][0]) == -1.0
    out = fetch_to_device(loader.host_slices(), 'cpu')
    assert [float(o['x'][0]) for o in out] == [100.0, 101.0, 102.0, -1.0,
                                              104.0]
    # the reference's loader over the same flow
    jl = joff.DoubleBufferedLoader(
        [joff.offload_to_host({'x': jnp.full((4,), float(i))})
         for i in range(5)])
    jl.prefetch(0)
    jl.prefetch(1)
    for i in range(5):
        cur = jl.get(i)
        jl.prefetch(i + 1)
        jl.store(i, {'x': cur['x'] + 100.0})
    jout = joff.fetch_to_device(jl.host_slices())
    assert [float(o['x'][0]) for o in jout][:3] == \
        [float(o['x'][0]) for o in out][:3]
    with pytest.raises(ValueError):
        offload_to_host({'x': torch.zeros(4, dtype=torch.float64)},
                        out=hosted[0])
    with pytest.raises(ValueError):
        offload_to_host({'x': torch.zeros(5)}, out=hosted[0])
