"""The chipmunk_torch compiled denoise loops (``FluxSampler.denoise_compiled``,
``hunyuan_denoise_compiled``, ``wan_denoise_compiled``) on the CPU, where
they run every step eagerly in the folded schedule: against the JAX
package's compiled loops (Pallas in interpret mode) on the tiny float32
models of tests/test_torch_flux.py, test_torch_hunyuan.py and
test_torch_wan.py at their tolerance, against the port's own host loops
at the reference's compiled-vs-host tolerance (2e-4,
tests/test_flux_model.py), with skipped steps folded; the kind-pure
windows against the reference's; and the constants a CUDA graph capture
needs on the device (no copy from the host in a step)."""
import importlib
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_flux as tf
import test_torch_hunyuan as th
import test_torch_wan as tw
from chipmunk_tpu.config import config_from_dict as j_config_from_dict
from chipmunk_tpu.models.hunyuan import HunyuanModel as JHunyuan
from chipmunk_tpu.models.hunyuan import init_hunyuan_params as j_init_hy
from chipmunk_tpu.models.sampling import FluxSampler as JSampler
from chipmunk_tpu.models.sampling import get_schedule as j_get_schedule
from chipmunk_tpu.models.video_sampling import \
    _kind_pure_windows as j_kind_pure_windows
from chipmunk_tpu.models.video_sampling import \
    hunyuan_denoise_compiled as j_hunyuan_compiled
from chipmunk_tpu.models.video_sampling import \
    wan_denoise_compiled as j_wan_compiled
from chipmunk_tpu.models.wan import WanModel as JWan
from chipmunk_tpu.models.wan import init_wan_params as j_init_wan
from chipmunk_torch.config import config_from_dict
from chipmunk_torch.models import (FluxSampler, FluxSparse, HunyuanModel,
                                   WanModel, get_schedule, hunyuan_denoise,
                                   hunyuan_denoise_compiled, params_from_jax,
                                   wan_denoise, wan_denoise_compiled)
from chipmunk_torch.models.step_graphs import GRAPH_STATS, _kind_pure_windows
from chipmunk_torch.modules import SparseDiffAttn

# the module (chipmunk_torch.ops re-exports a function of the same name)
bitpack = importlib.import_module('chipmunk_torch.ops.bitpack')

# the reference's compiled loop against its host loop
# (tests/test_flux_model.py:151-162): only the folded Euler sums differ
FOLD_TOL = dict(atol=2e-4, rtol=2e-4)


def flux_case():
    """test_torch_flux's 12-step schedule: first, colsum (recompute_mask),
    sparse with and without MLP re-selection, plain full steps and the
    skipped steps 3, 7 and 8."""
    cfg = dict(tf.SPARSE, steps=12,
               attn=dict(tf.SPARSE['attn'], full_step_every=5,
                         recompute_mask=True),
               mlp=dict(tf.SPARSE['mlp'], full_step_every=5),
               step_caching={'is_enabled': True,
                             'skip_step_schedule': {3, 7, 8}})
    (jm, jck, params), (tm, ck, tparams), inputs = tf.setup(cfg)
    sampler = FluxSampler(cfg=tm, ck=ck,
                          sp=FluxSparse.build(ck, tm, tf.SEQ),
                          h_img=tf.H_IMG, w_img=tf.W_IMG, device='cpu')
    return (jm, jck, params), (sampler, tparams), inputs


def test_flux_compiled_matches_reference_compiled_loop():
    (jm, jck, params), (sampler, tparams), (img, txt, y) = flux_case()
    jsp = tf.JSparse.build(jck, jm, tf.SEQ, use_kernels=True, interpret=True)
    js = JSampler(cfg=jm, ck=jck, sp=jsp, h_img=tf.H_IMG, w_img=tf.W_IMG)
    ts = j_get_schedule(12, tf.H_IMG * tf.W_IMG)
    out_j = js.denoise_compiled(params, *map(jnp.asarray, (img, txt, y)), ts)
    out_t = sampler.denoise_compiled(tparams,
                                     *map(torch.from_numpy, (img, txt, y)),
                                     torch.from_numpy(np.array(ts)))
    # 12 steps, 3 skipped: 9 computed, each run eagerly on the CPU
    assert GRAPH_STATS == {'graphs': 0, 'replays': 0, 'eager': 9,
                           'capture_s': 0.0, 'pool_bytes': None}
    assert out_t.shape == img.shape and torch.isfinite(out_t).all()
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **tf.TOL)


def test_flux_compiled_matches_host_loop():
    _, (sampler, tparams), (img, txt, y) = flux_case()
    args = (tparams, *map(torch.from_numpy, (img, txt, y)),
            get_schedule(12, tf.H_IMG * tf.W_IMG))
    out_c = sampler.denoise_compiled(*args)
    out_h = sampler.denoise(*args)
    assert not torch.equal(out_c, out_h)       # the skips are folded
    np.testing.assert_allclose(out_c.numpy(), out_h.numpy(), **FOLD_TOL)


def video_ck(mod):
    """The video tests' config at 6 steps: full steps {0, 1, 4} (colsum:
    recompute_mask), step 3 skipped: computed kinds first, colsum,
    sparse, colsum, sparse."""
    d = mod.ck_dict(full_step_schedule=[0, 1, 4])
    d.update(steps=6, step_caching={'is_enabled': True,
                                    'skip_step_schedule': [3]})
    return d


def hunyuan_case():
    jc, tc = th.tiny(72)
    d = video_ck(th)
    jm = JHunyuan(cfg=jc, ck=j_config_from_dict(d), use_kernels=True,
                  interpret=True)
    tm = HunyuanModel(cfg=tc, ck=config_from_dict(d), device='cpu')
    params = j_init_hy(jax.random.PRNGKey(0), jc)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              device='cpu')
    rng = np.random.default_rng(0)
    inputs = (rng.standard_normal((1, 4) + th.LATENT).astype(np.float32),
              rng.standard_normal((1, 72, 64)).astype(np.float32),
              rng.standard_normal((1, 32)).astype(np.float32))
    ts = j_get_schedule(6, jc.img_len, shift=False)
    return (jm, params), (tm, tparams), inputs, ts


def wan_case():
    jc, tc = tw.tiny(tw.GRIDS['padded'])
    d = video_ck(tw)
    jm = JWan(cfg=jc, ck=j_config_from_dict(d), use_kernels=True,
              interpret=True)
    tm = WanModel(cfg=tc, ck=config_from_dict(d), device='cpu')
    params = j_init_wan(jax.random.PRNGKey(0), jc)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              device='cpu')
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((1, 4) + tw.GRIDS['padded']).astype(np.float32)
    ctx_c, ctx_u = (rng.standard_normal((1, 64, 64)).astype(np.float32)
                    for _ in range(2))
    ctx_u[:, 40:] = 0.0
    ts = j_get_schedule(6, jc.seq_len, shift=False)
    return (jm, params), (tm, tparams), (lat, ctx_c, ctx_u), ts


@pytest.mark.parametrize('model', ['hunyuan', 'wan'])
def test_video_compiled_matches_reference_compiled_loop(model):
    """Both video loops at chunk None (the whole loop) and chunk 3 (the
    kind-pure windows), each against the reference's at the same chunk;
    the reference's kernels in interpret mode."""
    if model == 'hunyuan':
        (jm, params), (tm, tparams), inputs, ts = hunyuan_case()
        j_loop, t_loop = j_hunyuan_compiled, hunyuan_denoise_compiled
    else:
        (jm, params), (tm, tparams), inputs, ts = wan_case()
        j_loop, t_loop = j_wan_compiled, wan_denoise_compiled
    for chunk in (None, 3):
        out_j = j_loop(jm, params, *map(jnp.asarray, inputs), ts,
                       key=jax.random.PRNGKey(5), chunk=chunk)
        out_t = t_loop(tm, tparams, *map(torch.from_numpy, inputs),
                       torch.from_numpy(np.array(ts)), chunk=chunk)
        assert GRAPH_STATS['eager'] == 5            # step 3 folded
        assert out_t.shape == inputs[0].shape and torch.isfinite(out_t).all()
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                                   **th.TOL)


@pytest.mark.parametrize('model', ['hunyuan', 'wan'])
def test_video_compiled_matches_host_loop(model):
    """The compiled loop against the port's host loop (step 3 folded) at
    the reference's tolerance; chunk 0 and 2 compute what None computes
    (within 1e-6, as the reference's own chunk test holds it: the CPU's
    matmuls may round by the operands' alignment)."""
    if model == 'hunyuan':
        _, (tm, tparams), inputs, ts = hunyuan_case()
        host, loop = hunyuan_denoise, hunyuan_denoise_compiled
    else:
        _, (tm, tparams), inputs, ts = wan_case()
        host, loop = wan_denoise, wan_denoise_compiled
    args = (tm, tparams, *map(torch.from_numpy, inputs),
            torch.from_numpy(np.array(ts)))
    out_h = host(*args)
    out_c = loop(*args)
    assert not torch.equal(out_c, out_h)
    np.testing.assert_allclose(out_c.numpy(), out_h.numpy(), **FOLD_TOL)
    for chunk in (0, 2):
        np.testing.assert_allclose(loop(*args, chunk=chunk).numpy(),
                                   out_c.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize('kinds', [[0], [0, 1, 2, 2, 2, 2, 2, 3, 2, 2],
                                   [0, 1, 1, 2, 3, 3, 3, 1],
                                   [0, 1, 2, 3, 2, 4, 2, 2, 2]])
@pytest.mark.parametrize('chunk', [1, 2, 3, 7])
def test_kind_pure_windows_match_reference(kinds, chunk):
    assert _kind_pure_windows(kinds, chunk) == \
        j_kind_pure_windows(kinds, chunk)


@pytest.mark.parametrize('loop', [hunyuan_denoise_compiled,
                                  wan_denoise_compiled])
def test_negative_chunk_raises(loop):
    """The reference returns the noise untouched for a negative chunk;
    the port refuses it before any work."""
    with pytest.raises(ValueError, match='chunk'):
        loop(None, None, torch.zeros(1), None, None, [1.0, 0.0], chunk=-1)


def test_attention_masks_are_moved_once_per_device():
    """The static mask and the sparse-group flags of a compressed-index
    module reach its device once, at the first colsum step, and are
    reused after: _select_mask makes no copy from the host."""
    S, nb = 512, 16
    rng = np.random.default_rng(0)
    static = rng.random((S // 128, S)) < 0.1
    cfg = config_from_dict({'attn': {
        'top_keys': 0.2, 'kv_block': 32, 'counts_multiple_of': 32,
        'random_keys': 0.05}}).attn
    mod = SparseDiffAttn.build(cfg, S, static_mask_tokens=static)
    assert mod._on_device == {}
    cs = torch.rand((1, 2, S // 128, nb))
    gen = torch.Generator().manual_seed(0)
    m1 = mod._select_mask(cs, generator=gen)
    dev = cs.device
    consts = mod._on_device[dev]
    assert all(t.device == dev for t in consts)
    m2 = mod._select_mask(cs, generator=gen)
    assert mod.masks_on(dev) is consts and list(mod._on_device) == [dev]
    assert m1.shape == m2.shape == cs.shape
    # the static mask is always kept, whatever the draw
    sm = consts[1]
    assert bool((m1 | ~sm).all()) and bool((m2 | ~sm).all())


def test_bitpack_weights_are_built_once_per_device():
    mask = torch.rand((3, 4, 21)) < 0.5
    packed = bitpack.bitpack_rows(mask)
    w = bitpack._weights(torch.device('cpu'))
    assert bitpack._weights(torch.device('cpu')) is w
    assert w.tolist() == [1, 2, 4, 8, 16, 32, 64, 128]
    assert torch.equal(bitpack.bitunpack_rows(packed, 21), mask)
    assert bitpack._weights(torch.device('cpu')) is w
