"""The chipmunk_torch FLUX model and sampler against chipmunk_tpu on the
tiny model of tests/test_flux_model.py (float32), with the reference's
weights carried over by params_from_jax and the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from chipmunk_tpu.config import config_from_dict as j_config_from_dict
from chipmunk_tpu.models import FluxModelConfig as JModel
from chipmunk_tpu.models import FluxSparse as JSparse
from chipmunk_tpu.models import init_flux_params as j_init_flux_params
from chipmunk_tpu.models.flux import FluxStep as JStep
from chipmunk_tpu.models.flux import flux_forward as j_flux_forward
from chipmunk_tpu.models.sampling import FluxSampler as JSampler
from chipmunk_tpu.models.sampling import get_schedule as j_get_schedule
from chipmunk_tpu.utils import quant as jq
from chipmunk_torch.config import config_from_dict
from chipmunk_torch.models import (FluxModelConfig, FluxSampler, FluxSparse,
                                   FluxStep, flux_forward, get_schedule,
                                   params_from_jax)
from chipmunk_torch.utils.quant import QTensor

H_IMG, W_IMG, TXT = 16, 24, 128
SEQ = TXT + H_IMG * W_IMG
TINY = dict(in_channels=16, vec_in_dim=32, context_in_dim=32, hidden_size=128,
            num_heads=2, mlp_ratio=4.0, depth=2, depth_single_blocks=2,
            axes_dim=(16, 24, 24), guidance_embed=False, txt_len=TXT)
# float32 on both sides, 4 layers deep: summation order only
TOL = dict(atol=1e-4, rtol=1e-4)


def setup(cfg_dict):
    jm = JModel(**TINY, dtype=jnp.float32)
    tm = FluxModelConfig(**TINY, dtype=torch.float32)
    params = j_init_flux_params(jax.random.PRNGKey(0), jm)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              device='cpu')
    rng = np.random.default_rng(0)
    inputs = (rng.standard_normal((1, H_IMG * W_IMG, 16)).astype(np.float32),
              rng.standard_normal((1, TXT, 32)).astype(np.float32),
              rng.standard_normal((1, 32)).astype(np.float32))
    return (jm, j_config_from_dict(cfg_dict), params), \
        (tm, config_from_dict(cfg_dict), tparams), inputs


SPARSE = {'attn': {'top_keys': 0.4, 'kv_block': 32, 'counts_multiple_of': 32,
                   'first_n_dense_layers': 1, 'should_compress_indices': False,
                   'mbm': 128},
          'mlp': {'top_keys': 0.5, 'neuron_block': 128, 'bm': 128,
                  'counts_multiple_of': 128, 'first_n_dense_layers': 1,
                  'random_keys': 0.0},
          'patchify': {'chunk_size_1': 4, 'chunk_size_2': 2}}


def test_params_from_jax_splits_layers():
    (jm, _, params), (tm, _, tparams), _ = setup(SPARSE)
    assert len(tparams['double']) == 2 and len(tparams['single']) == 2
    for i in range(2):
        np.testing.assert_array_equal(
            tparams['double'][i]['img_qkv']['w'].numpy(),
            np.asarray(params['double']['img_qkv']['w'][i]))
        np.testing.assert_array_equal(tparams['single'][i]['w2'].numpy(),
                                      np.asarray(params['single']['w2'][i]))
    np.testing.assert_array_equal(tparams['time_in']['out']['b'].numpy(),
                                  np.asarray(params['time_in']['out']['b']))


def test_flux_forward_matches_reference_per_step_kind():
    """first, colsum, sparse with and without MLP re-selection, plain full;
    the reference runs its eager oracles (use_kernels=False)."""
    (jm, jck, params), (tm, ck, tparams), (img, txt, y) = setup(SPARSE)
    jsp = JSparse.build(jck, jm, SEQ, use_kernels=False)
    tsp = FluxSparse.build(ck, tm, SEQ)
    js = JSampler(cfg=jm, ck=jck, sp=jsp, h_img=H_IMG, w_img=W_IMG)
    ts_ = FluxSampler(cfg=tm, ck=ck, sp=tsp, h_img=H_IMG, w_img=W_IMG,
                      device='cpu')
    jpe, tpe = js.rope(1), ts_.rope(1)
    np.testing.assert_allclose(tpe[0].numpy(), np.asarray(jpe[0]), **TOL)
    jst, tst = jsp.init_state(jm, 1), tsp.init_state(tm, 1, device='cpu')
    kinds = [(0, True, True, False, False), (1, True, False, True, True),
             (2, False, False, False, True), (3, False, False, False, False),
             (4, True, True, False, False)]
    for i, (idx, fa, fm, cs, rm) in enumerate(kinds):
        t = np.full((1,), 1.0 - 0.15 * i, np.float32)
        x = img + 0.05 * i
        pj, jst = j_flux_forward(params, jm, jsp, jnp.asarray(x),
                                 jnp.asarray(txt), jnp.asarray(t),
                                 jnp.asarray(y), jpe, jst,
                                 JStep(idx, fa, fm, cs, rm),
                                 key=jax.random.PRNGKey(i))
        pt, tst = flux_forward(tparams, tm, tsp, torch.from_numpy(x),
                               torch.from_numpy(txt), torch.from_numpy(t),
                               torch.from_numpy(y), tpe, tst,
                               FluxStep(idx, fa, fm, cs, rm))
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **TOL)
        for layer in range(1, 2):      # the sparse double block
            np.testing.assert_array_equal(
                tst.double_attn[layer].inds.numpy(),
                np.asarray(jst.double_attn.inds[layer]))
            np.testing.assert_array_equal(
                tst.double_mlp[layer].inds.numpy(),
                np.asarray(jst.double_mlp.inds[layer]))


def test_denoise_matches_reference_kernels_in_interpret_mode():
    """12 steps: first, colsum (recompute_mask), sparse with and without
    MLP re-selection, plain full steps and step-cached skips; the
    reference runs its Pallas kernels in interpret mode."""
    cfg = dict(SPARSE, steps=12,
               attn=dict(SPARSE['attn'], full_step_every=5,
                         recompute_mask=True),
               mlp=dict(SPARSE['mlp'], full_step_every=5),
               step_caching={'is_enabled': True,
                             'skip_step_schedule': {3, 7, 8}})
    (jm, jck, params), (tm, ck, tparams), (img, txt, y) = setup(cfg)
    jsp = JSparse.build(jck, jm, SEQ, use_kernels=True, interpret=True)
    js = JSampler(cfg=jm, ck=jck, sp=jsp, h_img=H_IMG, w_img=W_IMG)
    ts = j_get_schedule(12, H_IMG * W_IMG)
    np.testing.assert_allclose(get_schedule(12, H_IMG * W_IMG).numpy(),
                               np.asarray(ts), atol=1e-6)
    out_j = js.denoise(params, *map(jnp.asarray, (img, txt, y)), ts)
    calls = []
    sampler = FluxSampler(cfg=tm, ck=ck, sp=FluxSparse.build(ck, tm, SEQ),
                          h_img=H_IMG, w_img=W_IMG, device='cpu')
    out_t = sampler.denoise(tparams, *map(torch.from_numpy, (img, txt, y)),
                            torch.from_numpy(np.array(ts)),
                            callback=lambda i, skipped: calls.append(skipped))
    assert calls == [i in (3, 7, 8) for i in range(12)]
    assert out_t.shape == img.shape and torch.isfinite(out_t).all()
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


def quantized_setup(cfg_dict):
    """setup() with the weights quantized as the JAX package ships them
    (QuantSpec(attn='int4', mod='int4', mlp_sparse='int8',
    mlp_dense='int4')), carried over by params_from_jax."""
    (jm, jck, params), (tm, ck, _), inputs = setup(cfg_dict)
    qparams = jq.quantize_flux_params(params, jq.QuantSpec(
        attn='int4', mod='int4', mlp_sparse='int8', mlp_dense='int4'))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, qparams),
                              device='cpu')
    return (jm, jck, qparams), (tm, ck, tparams), inputs


def test_params_from_jax_carries_quantized_leaves():
    (_, _, qparams), (_, _, tparams), _ = quantized_setup(SPARSE)
    for i in range(2):
        w = tparams['double'][i]['img_qkv']['w']
        ref = qparams['double']['img_qkv']['w']
        assert isinstance(w, QTensor) and w.pack_axis == ref.pack_axis == -2
        np.testing.assert_array_equal(w.q.numpy(), np.asarray(ref.q[i]))
        np.testing.assert_array_equal(w.scale.numpy(),
                                      np.asarray(ref.scale[i]))
        w1 = tparams['single'][i]['w1t']
        assert w1.q.dtype == torch.int8 and w1.pack_axis is None
        np.testing.assert_array_equal(
            w1.q.numpy(), np.asarray(qparams['single']['w1t'].q[i]))
        assert tparams['double'][i]['txt_w2'].pack_axis == -1
    assert not isinstance(tparams['img_in']['w'], QTensor)


def test_quantized_int8_act_denoise_matches_reference_kernels():
    """The shipped quantization with int8 activations: 12 steps as in
    test_denoise_matches_reference_kernels_in_interpret_mode, the
    reference running its a8 Pallas kernel in interpret mode.  The two
    sides' float32 activations differ in the last bits (summation order,
    tanh), and per-row int8 rounding turns such a difference into a whole
    quantization step wherever x / sx lies near a half; each sparse MLP
    step flips a few of them, and the loop carries them on.  Measured
    here: relative (Frobenius) norm difference 6.9e-3 after 12 steps (per
    step 2e-4 to 6e-4; 2e-6 without int8_act); the bound is 2e-2."""
    cfg = dict(SPARSE, steps=12,
               attn=dict(SPARSE['attn'], full_step_every=5,
                         recompute_mask=True),
               mlp=dict(SPARSE['mlp'], full_step_every=5, int8_act=True),
               step_caching={'is_enabled': True,
                             'skip_step_schedule': {3, 7, 8}})
    (jm, jck, params), (tm, ck, tparams), (img, txt, y) = \
        quantized_setup(cfg)
    assert jck.mlp.int8_act and ck.mlp.int8_act
    jsp = JSparse.build(jck, jm, SEQ, use_kernels=True, interpret=True)
    js = JSampler(cfg=jm, ck=jck, sp=jsp, h_img=H_IMG, w_img=W_IMG)
    ts = j_get_schedule(12, H_IMG * W_IMG)
    out_j = np.asarray(js.denoise(params, *map(jnp.asarray, (img, txt, y)),
                                  ts))
    sampler = FluxSampler(cfg=tm, ck=ck, sp=FluxSparse.build(ck, tm, SEQ),
                          h_img=H_IMG, w_img=W_IMG, device='cpu')
    out_t = sampler.denoise(tparams, *map(torch.from_numpy, (img, txt, y)),
                            torch.from_numpy(np.array(ts))).numpy()
    assert out_t.shape == img.shape and np.isfinite(out_t).all()
    rel = np.linalg.norm(out_t - out_j) / np.linalg.norm(out_j)
    print(f'quantized int8-act denoise: relative difference {rel:.3e}')
    assert rel < 2e-2, rel
