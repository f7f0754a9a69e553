"""The chipmunk_torch Wan2.1 model, its CFG denoise loop and its UMT5 text
encoder against chipmunk_tpu on tiny configs (float32), with the
reference's weights carried over by params_from_jax and the same numpy
inputs.

Two grids: latent (8, 8, 16), 256 tokens and no pad; latent (7, 8, 16),
224 tokens and 32 pad (valid_len, the pad lse).  At local_voxels 1 the
last query group's static mask covers every block, so both grids run the
exact-dense tail.  Model-level parity uses attn.random_keys = 0: torch
cannot draw jax.random's Bernoulli keep (the module-level tests inject
it instead).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chipmunk_tpu.config import config_from_dict as j_config_from_dict
from chipmunk_tpu.config import load_config as j_load_config
from chipmunk_tpu.models import video_encoders as jve
from chipmunk_tpu.models.flux import FluxStep as JStep
from chipmunk_tpu.models.sampling import get_schedule as j_get_schedule
from chipmunk_tpu.models.video_sampling import wan_denoise as j_denoise
from chipmunk_tpu.models.wan import WanModel as JWan
from chipmunk_tpu.models.wan import WanModelConfig as JConfig
from chipmunk_tpu.models.wan import init_wan_params as j_init
from chipmunk_tpu.schedule import step_plan
from chipmunk_torch.config import config_from_dict, load_config
from chipmunk_torch.models import (FluxStep, HunyuanModel,
                                   HunyuanModelConfig, UMT5Config, WanModel,
                                   WanModelConfig, get_schedule,
                                   init_umt5_params, init_wan_params,
                                   load_umt5_torch, params_from_jax,
                                   umt5_encode, wan_denoise)

# float32 on both sides: summation order only
TOL = dict(atol=1e-4, rtol=1e-4)
GRIDS = {'unpadded': (8, 8, 16), 'padded': (7, 8, 16)}


def tiny(latent):
    kw = dict(latent_t=latent[0], latent_h=latent[1], latent_w=latent[2],
              in_channels=4, patch_size=(1, 2, 2), dim=128, ffn_dim=512,
              num_heads=2, num_layers=2, text_dim=64, txt_len=64,
              freq_dim=64, axes_dim=(16, 24, 24), voxel_shape=(4, 4, 8))
    return JConfig(**kw, dtype=jnp.float32), \
        WanModelConfig(**kw, dtype=torch.float32)


def ck_dict(mlp=False, **attn):
    a = {'top_keys': 0.3, 'kv_block': 32, 'counts_multiple_of': 32,
         'random_keys': 0.0, 'local_voxels': 1, 'first_n_dense_layers': 1,
         'full_step_schedule': [0, 1, 3], 'should_compress_indices': True,
         'recompute_mask': True, 'dense_fallback_frac': 1.0}
    a.update(attn)
    m = ({'top_keys': 0.5, 'neuron_block': 32, 'counts_multiple_of': 32,
          'first_n_dense_layers': 1, 'full_step_every': 3,
          'random_keys': 0.0, 'bm': 128, 'mbm': 128}
         if mlp else {'is_enabled': False})
    return {'steps': 4, 'num_model_invocations_per_inference_step': 2,
            'attn': a, 'mlp': m, 'step_caching': {'is_enabled': False}}


def setup(grid='padded', csp_mode='auto', use_kernels=True, mlp=False,
          **attn):
    """The reference runs its Pallas kernels in interpret mode, or with
    use_kernels=False its eager oracles."""
    jc, tc = tiny(GRIDS[grid])
    d = ck_dict(mlp, **attn)
    jm = JWan(cfg=jc, ck=j_config_from_dict(d), use_kernels=use_kernels,
              interpret=True)
    tm = WanModel(cfg=tc, ck=config_from_dict(d), csp_mode=csp_mode,
                  device='cpu')
    params = j_init(jax.random.PRNGKey(0), jc)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              device='cpu')
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((1, 4) + GRIDS[grid]).astype(np.float32)
    ctx_c, ctx_u = (rng.standard_normal((1, 64, 64)).astype(np.float32)
                    for _ in range(2))
    ctx_u[:, 40:] = 0.0          # a shorter prompt: pad rows zeroed
    return (jm, params), (tm, tparams), (lat, ctx_c, ctx_u)


@pytest.mark.parametrize('grid', list(GRIDS))
def test_build_matches_reference(grid):
    """Static mask, padded length, jmax, top-k, the per-group sparse
    flags, the dense tail and valid_len."""
    (jm, _), (tm, _), _ = setup(grid, use_kernels=False)
    np.testing.assert_array_equal(tm.static_mask, jm.static_mask)
    assert tm.seq_padded == jm.seq_padded == 256
    ja, ta = jm.attn_mod, tm.attn_mod
    assert (ta.jmax, ta.sel_blocks, ta.valid_len, ta.dense_tail_g,
            ta.fully_dense) == (ja.jmax, ja.sel_blocks, ja.valid_len,
                                ja.dense_tail_g, ja.fully_dense)
    assert ta.valid_len == (224 if grid == 'padded' else None)
    assert ta.dense_tail_g == 1
    np.testing.assert_array_equal(ta.static_mask.numpy(),
                                  np.asarray(ja.static_mask))
    np.testing.assert_array_equal(ta.sparse_query_groups.numpy(),
                                  np.asarray(ja.sparse_query_groups))


def test_build_matches_reference_at_the_shipped_geometry():
    """configs/wan-chipmunk.yml at 480x832x81 frames: 32,760 tokens padded
    to 32,768, jmax 62 of 256 kv blocks, top-k 26, the dense tail at the
    last group, no dense fallback."""
    ck = load_config('configs/wan-chipmunk.yml')
    jck = j_load_config('configs/wan-chipmunk.yml')
    tm = WanModel(cfg=WanModelConfig(num_layers=2), ck=ck, device='cpu')
    jm = JWan(cfg=JConfig(num_layers=2), ck=jck, use_kernels=False)
    assert (tm.cfg.grid, tm.cfg.seq_len, tm.seq_padded) == \
        ((21, 30, 52), 32760, 32768)
    ja, ta = jm.attn_mod, tm.attn_mod
    assert (ta.jmax, ta.sel_blocks, ta.valid_len, ta.dense_tail_g,
            ta.fully_dense) == (ja.jmax, ja.sel_blocks, ja.valid_len,
                                ja.dense_tail_g, ja.fully_dense) == \
        (62, 26, 32760, 255, False)
    np.testing.assert_array_equal(tm.static_mask, jm.static_mask)
    assert tm.static_mask.shape == (256, 32768)
    assert tm.init_state(1).mlp == [None, None]     # the MLP is off


@pytest.mark.parametrize('grid', list(GRIDS))
def test_patchify_round_trip_and_rope(grid):
    (jm, _), (tm, _), (lat, _, _) = setup(grid, use_kernels=False)
    tok = tm.patchify_video(torch.from_numpy(lat))
    np.testing.assert_array_equal(
        tok.numpy(), np.asarray(jm.patchify_video(jnp.asarray(lat))))
    np.testing.assert_array_equal(tm.unpatchify_video(tok, 1).numpy(), lat)
    for a, b in zip(tm.rope(1), jm.rope(1)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize('grid,mlp', [('padded', False), ('unpadded', False),
                                      ('padded', True)])
def test_forward_matches_reference_per_step_kind(grid, mlp):
    """first, colsum, sparse and plain full steps, one invocation; the
    reference runs its eager oracles (its kernels run in
    test_denoise_matches_reference).  The packed selection, the index
    lists and the lse of the sparse layer are equal.  With ``mlp`` the
    FFN takes the sparse-delta MLP (full, then re-selecting sparse
    steps)."""
    (jm, params), (tm, tparams), (lat, ctx, _) = setup(
        grid, use_kernels=False, mlp=mlp)
    jst, tst = jm.init_state(1), tm.init_state(1)
    jpe, tpe = jm.rope(1), tm.rope(1)
    for i, (idx, fa, cs) in enumerate([(0, True, False), (1, True, True),
                                       (2, False, False), (3, True, False),
                                       (4, False, False)]):
        t = np.full((1,), 1.0 - 0.15 * i, np.float32)
        x = lat + 0.05 * i
        jstep = JStep(idx, fa, fa, cs, not fa)
        pj, jst = jm.forward(params, jnp.asarray(x), jnp.asarray(ctx),
                             jnp.asarray(t), jst, jstep,
                             key=jax.random.PRNGKey(i), pe=jpe)
        pt, tst = tm.forward(tparams, torch.from_numpy(x),
                             torch.from_numpy(ctx), torch.from_numpy(t), tst,
                             FluxStep(idx, fa, fa, cs, not fa), pe=tpe)
        assert pt.shape == lat.shape
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **TOL)
        ja, ta = jst.attn, tst.attn[1]          # the sparse layer
        np.testing.assert_array_equal(ta.packed.numpy(),
                                      np.asarray(ja.packed[1]))
        np.testing.assert_array_equal(ta.inds.numpy(),
                                      np.asarray(ja.inds[1]))
        np.testing.assert_array_equal(ta.counts.numpy(),
                                      np.asarray(ja.counts[1]))
        np.testing.assert_allclose(ta.lse.numpy(), np.asarray(ja.lse[1]),
                                   **TOL)
        if mlp:
            jmst, tmst = jst.mlp, tst.mlp[1]
            np.testing.assert_array_equal(tmst.inds.numpy(),
                                          np.asarray(jmst.inds[1]))
            np.testing.assert_allclose(tmst.out_cache.float().numpy(),
                                       np.asarray(jmst.out_cache[1],
                                                  np.float32), **TOL)


@pytest.mark.parametrize('grid,csp_mode', [('padded', 'auto'),
                                           ('padded', 'hbm'),
                                           ('unpadded', 'auto')])
def test_denoise_matches_reference(grid, csp_mode):
    """4 steps of wan_denoise (first, colsum, sparse, colsum: the config
    recomputes the mask on every full step), cond and uncond each with
    its own state, the reference's kernels in
    interpret mode; the port's csp in either mode (the reference picks
    its VMEM mode at this size, both compute the same function)."""
    (jm, params), (tm, tparams), (lat, ctx_c, ctx_u) = setup(grid, csp_mode)
    ts = j_get_schedule(4, jm.cfg.seq_len, shift=False)
    np.testing.assert_array_equal(
        get_schedule(4, tm.cfg.seq_len, shift=False).numpy(), np.asarray(ts))
    out_j = j_denoise(jm, params, *map(jnp.asarray, (lat, ctx_c, ctx_u)),
                      ts, key=jax.random.PRNGKey(5))
    calls = []
    out_t = wan_denoise(tm, tparams, *map(torch.from_numpy,
                                          (lat, ctx_c, ctx_u)),
                        torch.from_numpy(np.array(ts)),
                        callback=lambda i, skipped: calls.append(i))
    assert calls == [0, 1, 2, 3]
    assert out_t.shape == lat.shape and torch.isfinite(out_t).all()
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


def test_init_wan_params_has_the_reference_tree():
    """The port's random init has the reference's tree, shapes and
    per-layer lists (params_from_jax splits the stacked ``blocks``), and
    the loop runs with the shipped random keep drawn from a generator and
    step caching on."""
    jc, tc = tiny(GRIDS['padded'])
    shapes = jax.eval_shape(lambda k: j_init(k, jc), jax.random.PRNGKey(0))
    tp = init_wan_params(torch.Generator().manual_seed(0), tc, device='cpu')
    ref = params_from_jax(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes), device='cpu')
    assert isinstance(ref['blocks'], list) and len(ref['blocks']) == 2

    def walk(a, b):
        if isinstance(b, dict):
            assert a.keys() == b.keys()
            for k in b:
                walk(a[k], b[k])
        elif isinstance(b, list):
            assert len(a) == len(b)
            for x, z in zip(a, b):
                walk(x, z)
        else:
            assert a.shape == b.shape and a.dtype == torch.float32
    walk(tp, ref)
    d = ck_dict(random_keys=0.05)
    d['step_caching'] = {'is_enabled': True, 'skip_step_schedule': [2]}
    assert [k.skip for k in step_plan(j_config_from_dict(d))] == \
        [False, False, True, False]
    m = WanModel(cfg=tc, ck=config_from_dict(d), device='cpu')
    rng = np.random.default_rng(2)
    lat = torch.from_numpy(rng.standard_normal((1, 4) + GRIDS['padded'])
                           .astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 1, 64, 64))
                           .astype(np.float32))
    calls = []
    out = wan_denoise(m, tp, lat, ctx[0], ctx[1],
                      get_schedule(4, tc.seq_len, shift=False),
                      generator=torch.Generator().manual_seed(3),
                      callback=lambda i, skipped: calls.append(skipped))
    assert calls == [False, False, True, False]
    assert out.shape == lat.shape and torch.isfinite(out).all()


TINY_T5 = dict(vocab_size=64, dim=32, dim_attn=32, dim_ffn=64, num_heads=2,
               num_layers=2)


def test_umt5_encode_matches_reference():
    """umt5_encode on the reference's weights (params_from_jax splits the
    stacked ``blocks``), one full row and one with a partial mask; the
    bucket ids are the reference's."""
    jcfg = jve.UMT5Config(**TINY_T5)
    tcfg = UMT5Config(**TINY_T5)
    params = jve.init_umt5_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                         device='cpu')
    assert isinstance(tp['blocks'], list) and len(tp['blocks']) == 2
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 64, (2, 24)).astype(np.int32)
    mask = (np.arange(24)[None] < np.array([[24], [13]])).astype(np.int32)
    o_j = jve.umt5_encode(params, jnp.asarray(ids), jnp.asarray(mask), jcfg)
    o_t = umt5_encode(tp, torch.from_numpy(ids), torch.from_numpy(mask),
                      tcfg)
    assert o_t.shape == (2, 24, 32)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    from chipmunk_torch.models.video_encoders import _bucket_ids
    np.testing.assert_array_equal(_bucket_ids(300, tcfg),
                                  jve._bucket_ids(300, jcfg))
    # the random init has the reference's tree and shapes
    ti = init_umt5_params(torch.Generator().manual_seed(0), tcfg, 'cpu')
    assert ti.keys() == tp.keys() and len(ti['blocks']) == 2
    for a, b in zip(ti['blocks'], tp['blocks']):
        assert {k: v.shape for k, v in a.items()} == \
            {k: v.shape for k, v in b.items()}
    assert ti['token_embedding'].shape == tp['token_embedding'].shape


def test_load_umt5_torch_reads_a_pth(tmp_path):
    """A .pth state dict in the checkpoint's key layout, written with
    torch.save, loads into the same tree in both packages (Linear weights
    transposed), and the two encodings agree; the same state dict as a
    .safetensors file loads tensor for tensor equal to the .pth and to
    the reference's load of that file."""
    cfg = UMT5Config(**TINY_T5)
    g = torch.Generator().manual_seed(5)

    def r(*shape):
        return torch.randn(shape, generator=g) * 0.1

    d, da, df = cfg.dim, cfg.dim_attn, cfg.dim_ffn
    sd = {'token_embedding.weight': r(cfg.vocab_size, d) * 10,
          'norm.weight': 1 + r(d)}
    for i in range(cfg.num_layers):
        p = f'blocks.{i}'
        sd.update({f'{p}.norm1.weight': 1 + r(d),
                   f'{p}.attn.q.weight': r(da, d),
                   f'{p}.attn.k.weight': r(da, d),
                   f'{p}.attn.v.weight': r(da, d),
                   f'{p}.attn.o.weight': r(d, da),
                   f'{p}.pos_embedding.embedding.weight':
                       r(cfg.num_buckets, cfg.num_heads) * 10,
                   f'{p}.norm2.weight': 1 + r(d),
                   f'{p}.ffn.gate.0.weight': r(df, d),
                   f'{p}.ffn.fc1.weight': r(df, d),
                   f'{p}.ffn.fc2.weight': r(d, df)})
    path = str(tmp_path / 'umt5_tiny.pth')
    torch.save(sd, path)
    tp = load_umt5_torch(path, cfg, device='cpu')
    jp = jve.load_umt5_torch(path, jve.UMT5Config(**TINY_T5))
    assert torch.equal(tp['blocks'][1]['q'], sd['blocks.1.attn.q.weight'].t())
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                          device='cpu')
    for a, b in zip(tp['blocks'], ref['blocks']):
        for k in b:
            assert torch.equal(a[k], b[k]), k
    ids = np.arange(16, dtype=np.int32)[None] * 3 % 64
    mask = (np.arange(16) < 11).astype(np.int32)[None]
    np.testing.assert_allclose(
        umt5_encode(tp, torch.from_numpy(ids), torch.from_numpy(mask),
                    cfg).numpy(),
        np.asarray(jve.umt5_encode(jp, jnp.asarray(ids), jnp.asarray(mask),
                                   jve.UMT5Config(**TINY_T5))), **TOL)
    from chipmunk_torch.utils.safetensors_io import save_file
    st = str(tmp_path / 'umt5_tiny.safetensors')
    save_file(sd, st)
    ts = load_umt5_torch(st, cfg, device='cpu')
    js = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jve.load_umt5_torch(st, jve.UMT5Config(**TINY_T5))),
        device='cpu')
    for got, want in ((ts, tp), (ts, js)):
        assert torch.equal(got['token_embedding'], want['token_embedding'])
        assert torch.equal(got['norm'], want['norm'])
        for a, b in zip(got['blocks'], want['blocks'], strict=True):
            assert a.keys() == b.keys()
            for k in b:
                assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize('model', ['wan 480x832x81', 'hunyuan 540p'])
def test_module_never_makes_a_keyless_group(model):
    """Every query group outside the exact-dense tail keeps, in its static
    mask, a kv block that starts before valid_len, so the selection
    (static mask union top-k) never leaves a group whose selected blocks
    all lie past valid_len (the shipped configs, real geometries)."""
    if model.startswith('wan'):
        m = WanModel(cfg=WanModelConfig(num_layers=2),
                     ck=load_config('configs/wan-chipmunk.yml'),
                     device='cpu')
        mod = m.attn_mod
    else:
        m = HunyuanModel(cfg=HunyuanModelConfig(
            latent_t=33, latent_h=68, latent_w=120, depth_double=2,
            depth_single=4), ck=load_config('configs/hunyuan-chipmunk.yml'),
            device='cpu')
        mod = m.sp.attn_s
    assert mod.valid_len is not None and mod.dense_tail_g is not None
    kvb = mod.cfg.kv_block
    first_cut = -(-mod.valid_len // kvb)     # blocks from here hold no key
    rows = mod.static_mask[:mod.dense_tail_g]
    assert bool(rows[:, :first_cut].any(-1).all())
