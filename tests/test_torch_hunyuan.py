"""The chipmunk_torch HunyuanVideo model and denoise loop against
chipmunk_tpu on the tiny config of tests/test_hunyuan_model.py (float32),
with the reference's weights carried over by params_from_jax and the same
numpy inputs.

Model-level parity uses attn.random_keys = 0: torch cannot draw
jax.random's Bernoulli keep (module-level tests inject it instead), and
random_keys = 0 also sets the capacity margin rand_margin to 0, so jmax
is smaller than with the shipped 0.01 (both sides compute it alike).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chipmunk_tpu.config import config_from_dict as j_config_from_dict
from chipmunk_tpu.models.flux import FluxStep as JStep
from chipmunk_tpu.models.hunyuan import HunyuanModel as JHunyuan
from chipmunk_tpu.models.hunyuan import HunyuanModelConfig as JConfig
from chipmunk_tpu.models.hunyuan import init_hunyuan_params as j_init
from chipmunk_tpu.models.hunyuan import text_refiner as j_text_refiner
from chipmunk_tpu.models.sampling import get_schedule as j_get_schedule
from chipmunk_tpu.models.video_sampling import hunyuan_denoise as j_denoise
from chipmunk_tpu.schedule import step_plan
from chipmunk_torch.config import config_from_dict, load_config
from chipmunk_torch.models import (FluxStep, HunyuanModel,
                                   HunyuanModelConfig, get_schedule,
                                   hunyuan_denoise, init_hunyuan_params,
                                   params_from_jax, text_refiner)

# float32 on both sides, 4 layers deep: summation order only
TOL = dict(atol=1e-4, rtol=1e-4)
LATENT = (8, 8, 16)


def tiny(txt_len):
    """txt_len 128: [img 256 | txt 128], no pad; 72: [img 256 | txt 72 |
    pad 56]."""
    kw = dict(latent_t=8, latent_h=8, latent_w=16, in_channels=4,
              patch_size=(1, 2, 2), hidden_size=128, num_heads=2,
              mlp_ratio=4.0, depth_double=2, depth_single=2,
              axes_dim=(16, 24, 24), theta=256, text_dim=64, txt_len=txt_len,
              vec_in_dim=32, guidance_embed=False, voxel_shape=(4, 4, 8))
    return JConfig(**kw, dtype=jnp.float32), \
        HunyuanModelConfig(**kw, dtype=torch.float32)


def ck_dict(**attn):
    a = {'top_keys': 0.3, 'kv_block': 32, 'counts_multiple_of': 32,
         'random_keys': 0.0, 'local_voxels': 1, 'first_n_dense_layers': 1,
         'full_step_schedule': [0, 1, 3], 'should_compress_indices': True,
         'recompute_mask': True, 'dense_fallback_frac': 1.0}
    a.update(attn)
    return {'steps': 4, 'attn': a, 'mlp': {'is_enabled': False},
            'step_caching': {'is_enabled': False}}


def setup(txt_len=72, csp_mode='auto', use_kernels=True, **attn):
    """The reference runs its Pallas kernels in interpret mode, or with
    use_kernels=False its eager oracles."""
    jc, tc = tiny(txt_len)
    d = ck_dict(**attn)
    jm = JHunyuan(cfg=jc, ck=j_config_from_dict(d), use_kernels=use_kernels,
                  interpret=True)
    tm = HunyuanModel(cfg=tc, ck=config_from_dict(d), csp_mode=csp_mode,
                      device='cpu')
    params = j_init(jax.random.PRNGKey(0), jc)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              device='cpu')
    rng = np.random.default_rng(0)
    inputs = (rng.standard_normal((1, 4) + LATENT).astype(np.float32),
              rng.standard_normal((1, txt_len, 64)).astype(np.float32),
              rng.standard_normal((1, 32)).astype(np.float32))
    return (jm, params), (tm, tparams), inputs


def test_build_matches_reference():
    """Static mask, padded length, the materialize decision, jmax, the
    per-group sparse flags, the dense tail and valid_len, for the padded
    and the unpadded layout and for the shipped config at 540p."""
    for txt_len in (72, 128):
        (jm, _), (tm, _), _ = setup(txt_len, use_kernels=False)
        np.testing.assert_array_equal(tm.static_mask, jm.static_mask)
        assert tm.seq_padded == jm.seq_padded
        ja, ta = jm.sp.attn_d, tm.sp.attn_d
        assert (ta.jmax, ta.sel_blocks, ta.valid_len, ta.dense_tail_g,
                ta.fully_dense) == (ja.jmax, ja.sel_blocks, ja.valid_len,
                                    ja.dense_tail_g, ja.fully_dense)
        np.testing.assert_array_equal(ta.static_mask.numpy(),
                                      np.asarray(ja.static_mask))
        np.testing.assert_array_equal(ta.sparse_query_groups.numpy(),
                                      np.asarray(ja.sparse_query_groups))
        assert tm.ck.attn.materialize_indices is False \
            and jm.ck.attn.materialize_indices is False
    assert tiny(72)[1].seq_pad == 56
    # the shipped config at 544x960x129 frames, the reference's rule
    from chipmunk_tpu.config import load_config as j_load_config
    ck = load_config('configs/hunyuan-chipmunk.yml')
    jck = j_load_config('configs/hunyuan-chipmunk.yml')
    kw = dict(latent_t=33, latent_h=68, latent_w=120, depth_double=2,
              depth_single=4)
    tm = HunyuanModel(cfg=HunyuanModelConfig(**kw), ck=ck, device='cpu')
    jm = JHunyuan(cfg=JConfig(**kw), ck=jck, use_kernels=False)
    assert (tm.cfg.img_len, tm.seq_padded) == (67320, 67584)
    ja, ta = jm.sp.attn_d, tm.sp.attn_d
    assert (ta.jmax, ta.sel_blocks, ta.valid_len, ta.dense_tail_g) == \
        (ja.jmax, ja.sel_blocks, ja.valid_len, ja.dense_tail_g) == \
        (44, 26, 67576, 525)
    np.testing.assert_array_equal(tm.static_mask, jm.static_mask)


def test_patchify_round_trip_and_rope():
    (jm, _), (tm, _), (lat, _, _) = setup(use_kernels=False)
    tok = tm.patchify_video(torch.from_numpy(lat))
    np.testing.assert_array_equal(tok.numpy(),
                                  np.asarray(jm.patchify_video(
                                      jnp.asarray(lat))))
    np.testing.assert_array_equal(tm.unpatchify_video(tok, 1).numpy(), lat)
    jpe, tpe = jm.rope(1), tm.rope(1)
    for a, b in zip(tpe, jpe):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize('masked', [False, True])
def test_text_refiner_matches_reference(masked):
    jc, _ = tiny(128)
    params = j_init(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                         device='cpu')
    assert isinstance(tp['refiner']['blocks'], list)
    rng = np.random.default_rng(1)
    txt = rng.standard_normal((2, 128, 64)).astype(np.float32)
    t_emb = rng.standard_normal((2, 256)).astype(np.float32)
    mask = np.arange(128)[None] < np.array([[37], [128]]) if masked else None
    o_j = j_text_refiner(params['refiner'], jnp.asarray(txt),
                         jnp.asarray(t_emb), 2,
                         txt_mask=None if mask is None else jnp.asarray(mask))
    o_t = text_refiner(tp['refiner'], torch.from_numpy(txt),
                       torch.from_numpy(t_emb), 2,
                       txt_mask=None if mask is None else
                       torch.from_numpy(mask))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize('txt_len,materialize', [(72, None), (72, True),
                                                 (128, None)])
def test_forward_matches_reference_per_step_kind(txt_len, materialize):
    """first, colsum, sparse and plain full steps; the reference runs its
    eager oracles (its kernels run in test_denoise_matches_reference).
    With txt_len 72 the layout is
    padded (valid_len, pad lse) and the last group is the exact-dense
    tail; materialize None takes the config's offloading (packed-only
    states)."""
    (jm, params), (tm, tparams), (lat, txt, y) = setup(
        txt_len, use_kernels=False, materialize_indices=materialize)
    jst, tst = jm.init_state(1), tm.init_state(1)
    jpe, tpe = jm.rope(1), tm.rope(1)
    for i, (idx, fa, cs) in enumerate([(0, True, False), (1, True, True),
                                       (2, False, False), (3, True, False),
                                       (4, False, False)]):
        t = np.full((1,), 1.0 - 0.15 * i, np.float32)
        x = lat + 0.05 * i
        pj, jst = jm.forward(params, jnp.asarray(x), jnp.asarray(txt),
                             jnp.asarray(t), jnp.asarray(y), jst,
                             JStep(idx, fa, False, cs, False),
                             key=jax.random.PRNGKey(i), pe=jpe)
        pt, tst = tm.forward(tparams, torch.from_numpy(x),
                             torch.from_numpy(txt), torch.from_numpy(t),
                             torch.from_numpy(y), tst,
                             FluxStep(idx, fa, False, cs, False), pe=tpe)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **TOL)
        for layer in (1,):             # the sparse double block
            ja, ta = jst.double_attn, tst.double_attn[layer]
            np.testing.assert_array_equal(ta.packed.numpy(),
                                          np.asarray(ja.packed[layer]))
            if tm.sp.attn_d.materialized:
                np.testing.assert_array_equal(ta.inds.numpy(),
                                              np.asarray(ja.inds[layer]))
            else:
                assert ta.inds is None
            np.testing.assert_allclose(ta.lse.numpy(),
                                       np.asarray(ja.lse[layer]), **TOL)


@pytest.mark.parametrize('csp_mode', ['auto', 'hbm'])
def test_denoise_matches_reference(csp_mode):
    """4 steps of hunyuan_denoise (first, colsum, sparse, plain full) on
    the padded layout; the port's csp in either mode (the reference picks
    its VMEM mode at this size, both compute the same function)."""
    (jm, params), (tm, tparams), (lat, txt, y) = setup(72, csp_mode)
    ts = j_get_schedule(4, jm.cfg.img_len, shift=False)
    np.testing.assert_array_equal(
        get_schedule(4, tm.cfg.img_len, shift=False).numpy(), np.asarray(ts))
    out_j = j_denoise(jm, params, *map(jnp.asarray, (lat, txt, y)), ts,
                      key=jax.random.PRNGKey(5))
    calls = []
    out_t = hunyuan_denoise(tm, tparams, *map(torch.from_numpy,
                                              (lat, txt, y)),
                            torch.from_numpy(np.array(ts)),
                            callback=lambda i, skipped: calls.append(i))
    assert calls == [0, 1, 2, 3]
    assert out_t.shape == lat.shape and torch.isfinite(out_t).all()
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


def test_schedule_matches_reference_at_540p():
    """get_schedule at the 540p image length (67,320 tokens), unshifted
    (the video loop's) and shifted."""
    for shift in (False, True):
        np.testing.assert_allclose(
            get_schedule(50, 67320, shift=shift).numpy(),
            np.asarray(j_get_schedule(50, 67320, shift=shift)), atol=1e-6)


def test_init_hunyuan_params_has_the_reference_tree():
    """The port's random init has the reference's tree and shapes."""
    jc, tc = tiny(72)
    shapes = jax.eval_shape(lambda k: j_init(k, jc), jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    tp = init_hunyuan_params(gen, tc, device='cpu')
    ref = params_from_jax(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes), device='cpu')

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
    plan = step_plan(j_config_from_dict(ck_dict()))
    assert [k.colsum for k in plan] == [False, True, False, True]
    # the loop with the shipped random keep runs (drawn from a generator)
    m = HunyuanModel(cfg=tc, ck=config_from_dict(ck_dict(random_keys=0.05)),
                     device='cpu')
    rng = np.random.default_rng(2)
    out = hunyuan_denoise(
        m, tp, torch.from_numpy(rng.standard_normal((1, 4) + LATENT)
                                .astype(np.float32)),
        torch.from_numpy(rng.standard_normal((1, 72, 64)).astype(np.float32)),
        torch.from_numpy(rng.standard_normal((1, 32)).astype(np.float32)),
        get_schedule(4, tc.img_len, shift=False),
        generator=torch.Generator().manual_seed(3))
    assert torch.isfinite(out).all()
