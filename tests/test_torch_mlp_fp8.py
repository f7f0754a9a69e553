"""chipmunk_torch.modules.mlp_fp8 against chipmunk_tpu.modules.mlp_fp8 on
the CPU, numpy-seeded: the elementwise functions (weight and input
quantization, calibration) bit for bit, the fp8 x fp8 products within
PROD_TOL (both upcast exact fp8 products to f32; only the summation
order differs), and ``SparseDiffMlp`` under ``mlp.is_fp8`` against the
reference module (the setup of tests/test_fp8.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chipmunk_tpu.config import config_from_dict as j_config_from_dict
from chipmunk_tpu.models import FluxModelConfig as JFlux
from chipmunk_tpu.models import init_flux_params as j_init_flux_params
from chipmunk_tpu.modules import mlp_fp8 as jf8
from chipmunk_tpu.modules.mlp import SparseDiffMlp as JMlp
from chipmunk_tpu.utils import quant as jq
from chipmunk_torch.config import config_from_dict
from chipmunk_torch.kernels import csp_mlp
from chipmunk_torch.models import params_from_jax
from chipmunk_torch.modules import SparseDiffMlp
from chipmunk_torch.modules import mlp_fp8 as tf8
from chipmunk_torch.utils.quant import QTensor, dequant, quantize

# f32 accumulation of exact fp8 products on both sides: summation order
PROD_TOL = dict(rtol=1e-5, atol=1e-5)
# the module's bf16-free f32 path, two products deep
MOD_TOL = dict(rtol=1e-4, atol=1e-5)


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def raw8(x):
    """fp8 codes as bytes (torch or jax)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def assert_codes_equal(got, want):
    """Bit for bit, NaN codes included."""
    np.testing.assert_array_equal(raw8(got), raw8(want))


def draw(rng, shape, scale):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize('shape,scale', [((256, 64), 0.05), ((96, 48), 3e2),
                                         ((128, 32), 0.0)])
def test_quantize_weight_is_bit_equal(shape, scale):
    """Codes and scale; a zero weight takes the 1e-12 floor."""
    w = draw(np.random.default_rng(0), shape, scale)
    jw, tw = jf8.quantize_weight(jnp.asarray(w)), tf8.quantize_weight(t(w))
    assert tw.w8.dtype == torch.float8_e4m3fn and tw.scale.shape == ()
    assert_codes_equal(tw.w8, jw.w8)
    assert tw.scale.item() == float(jw.scale)


def test_calibration_freezes_after_twelve_calls_bit_equal():
    """amax and count after each of 14 calls with growing inputs: the
    running max stops at call 12; a frozen scale then sends inputs past
    464 x scale to NaN, as the reference's e4m3 cast does."""
    rng = np.random.default_rng(1)
    js, ts = jf8.init_input_state(), tf8.init_input_state()
    assert ts.amax.dtype == torch.float32 and ts.count.dtype == torch.int32
    for i in range(tf8.CALIBRATION_STEPS + 2):
        x = draw(rng, (16, 32), 0.5 * (i + 1))
        jx8, jsx = jf8.quantize_input(jnp.asarray(x), js)
        tx8, tsx = tf8.quantize_input(t(x), ts)
        assert_codes_equal(tx8, jx8)
        assert tsx.item() == float(jsx)
        js, ts = jf8.update_calibration(js, jnp.asarray(x)), \
            tf8.update_calibration(ts, t(x))
        assert ts.amax.item() == float(js.amax)
        assert ts.count.item() == int(js.count) == i + 1
    assert tf8.CALIBRATION_STEPS == jf8.CALIBRATION_STEPS == 12
    frozen = ts.amax.item()
    big = draw(rng, (16, 32), 5e2 * frozen)
    jx8, jsx = jf8.quantize_input(jnp.asarray(big), js)
    tx8, tsx = tf8.quantize_input(t(big), ts)
    assert tsx.item() == float(jsx) == np.float32(frozen) / np.float32(448)
    assert torch.isnan(tx8.float()).any()
    assert_codes_equal(tx8, jx8)


@pytest.mark.parametrize('scale', [0.5, 1e-3, 0.0])
def test_quantize_input_per_call_is_bit_equal(scale):
    x = draw(np.random.default_rng(2), (64, 48), scale)
    jx8, jsx = jf8.quantize_input(jnp.asarray(x), None)
    tx8, tsx = tf8.quantize_input(t(x), None)
    assert_codes_equal(tx8, jx8)
    assert tsx.item() == float(jsx)


@pytest.mark.parametrize('out_dtype', ['float32', 'bfloat16'])
def test_f8_matmul_and_f8_linear_match(out_dtype):
    rng = np.random.default_rng(3)
    x, w, b = draw(rng, (32, 64), 0.5), draw(rng, (128, 64), 0.05), \
        draw(rng, (128,), 0.05)
    jdt, tdt = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    jw, tw = jf8.quantize_weight(jnp.asarray(w)), tf8.quantize_weight(t(w))
    jx8, jsx = jf8.quantize_input(jnp.asarray(x), None)
    tx8, tsx = tf8.quantize_input(t(x), None)
    yj = jf8.f8_matmul(jx8, jsx, jw, jnp.asarray(b), out_dtype=jdt)
    yt = tf8.f8_matmul(tx8, tsx, tw, t(b), out_dtype=tdt)
    assert yt.dtype == tdt and yt.shape == (32, 128)
    tol = PROD_TOL if out_dtype == 'float32' else dict(rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(yt.float().numpy(),
                               np.asarray(yj, np.float32), **tol)
    yj, js = jf8.f8_linear(jnp.asarray(x), jw, jf8.init_input_state(),
                           jnp.asarray(b), out_dtype=jdt)
    yt, ts = tf8.f8_linear(t(x), tw, tf8.init_input_state(), t(b),
                           out_dtype=tdt)
    np.testing.assert_allclose(yt.float().numpy(),
                               np.asarray(yj, np.float32), **tol)
    assert ts.count.item() == int(js.count) == 1
    assert ts.amax.item() == float(js.amax)


@pytest.mark.parametrize('bias', [True, False])
def test_f8_input_matmul_matches(bias):
    """fc1 of mlp.is_fp8: an fp8 QTensor [N, C] with per-row scales, the
    input quantized per call; the port's quantize and the reference's
    give the same weight bytes."""
    rng = np.random.default_rng(4)
    x, w, b = draw(rng, (40, 64), 0.5), draw(rng, (96, 64), 0.05), \
        draw(rng, (96,), 0.05)
    jw = jq.quantize(jnp.asarray(w), 'fp8', keep_axes=(0,))
    tw = quantize(t(w), 'fp8', keep_axes=(0,))
    assert_codes_equal(tw.q, jw.q)
    yj = jf8.f8_input_matmul(jnp.asarray(x), jw,
                             jnp.asarray(b) if bias else None)
    yt = tf8.f8_input_matmul(t(x), tw, t(b) if bias else None)
    assert yt.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **PROD_TOL)
    yt16 = tf8.f8_input_matmul(t(x), tw, out_dtype=torch.bfloat16)
    assert yt16.dtype == torch.bfloat16


def test_products_refuse_what_they_do_not_take():
    x8, _ = tf8.quantize_input(torch.ones(4, 32), None)
    with pytest.raises(ValueError, match='fp8'):
        tf8.f8_matmul(x8, torch.ones(()),
                      tf8.F8Weight(torch.ones(16, 32), torch.ones(())))
    with pytest.raises(ValueError, match='contract'):
        tf8.f8_matmul(x8, torch.ones(()),
                      tf8.quantize_weight(torch.ones(16, 48)))
    int8 = quantize(torch.ones(16, 32), 'int8', keep_axes=(0,))
    with pytest.raises(ValueError, match='fp8'):
        tf8.f8_input_matmul(torch.ones(4, 32), int8)
    int4 = quantize(torch.ones(16, 32), 'int4', keep_axes=(0,), pack_axis=1)
    with pytest.raises(ValueError, match='unpacked'):
        tf8.f8_input_matmul(torch.ones(4, 32), int4)
    meta = tf8.F8Weight(torch.empty(16, 32, dtype=torch.float8_e4m3fn,
                                    device='meta'), torch.ones(()))
    with pytest.raises(ValueError):
        tf8.f8_matmul(x8.to('meta'), torch.ones(()), meta)


def test_quant_spec_for_is_fp8():
    assert tuple(tf8.quant_spec_for_is_fp8()) == \
        tuple(jf8.quant_spec_for_is_fp8())
    assert tf8.quant_spec_for_is_fp8() == (None, None, 'int8', 'fp8')


@pytest.mark.parametrize('sparse_fc2', [False, True])
def test_quantize_flux_mlps_per_layer_bit_equal(sparse_fc2):
    """The port's per-layer lists against the reference's vmapped stack."""
    jm = JFlux(in_channels=16, vec_in_dim=32, context_in_dim=32,
               hidden_size=128, num_heads=2, depth=2, depth_single_blocks=3,
               axes_dim=(16, 24, 24), txt_len=128, dtype=jnp.float32)
    params = j_init_flux_params(jax.random.PRNGKey(0), jm)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              device='cpu')
    jf, jc = jf8.quantize_flux_mlps(params, sparse_fc2)
    tf, tc = tf8.quantize_flux_mlps(tparams, sparse_fc2)
    for part in ('double', 'single'):
        assert sorted(tf[part]) == sorted(jf[part])
        for name, layers in tf[part].items():
            assert len(layers) == (2 if part == 'double' else 3)
            for i, fw in enumerate(layers):
                assert_codes_equal(fw.w8, jf[part][name].w8[i])
                assert fw.scale.item() == float(jf[part][name].scale[i])
    assert sorted(tc) == sorted(jc)
    for k in tc:
        assert tc[k].amax.item() == 0.0 and tc[k].count.item() == 0


# ------------------------------------------------------------ the module

def module_setup(is_fp8):
    """tests/test_fp8.py's shapes: T 256, C 64, N 256."""
    rng = np.random.default_rng(5)
    T, C, N = 256, 64, 256
    x, w1t, b1 = draw(rng, (T, C), 0.5), draw(rng, (N, C), 0.05), \
        draw(rng, (N,), 0.01)
    w2, b2 = draw(rng, (N, C), 0.05), np.zeros((C,), np.float32)
    d = {'mlp': {'is_fp8': is_fp8, 'is_enabled': True}}
    jmod = JMlp.build(j_config_from_dict(d).mlp, T, C, N, use_kernels=False)
    tmod = SparseDiffMlp.build(config_from_dict(d).mlp, T, C, N)
    jw1 = jq.quantize(jnp.asarray(w1t), 'fp8', keep_axes=(0,))
    tw1 = quantize(t(w1t), 'fp8', keep_axes=(0,))
    return (jmod, (jnp.asarray(x), jw1, jnp.asarray(b1), jnp.asarray(w2),
                   jnp.asarray(b2))), \
        (tmod, (t(x), tw1, t(b1), t(w2), t(b2)))


@pytest.mark.parametrize('is_fp8', [True, False])
def test_module_dense_and_full_step_honour_is_fp8(is_fp8):
    """With is_fp8 fc1 runs fp8 x fp8 (its result differs from the
    dequantized product); without it the same fp8 weight is dequantized,
    as in the reference.  full_step's output and caches match too."""
    (jmod, ja), (tmod, ta) = module_setup(is_fp8)
    yj, yt = jmod.dense(*ja), tmod.dense(*ta)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **MOD_TOL)
    x, w1, b1, w2, b2 = ta
    deq = (torch.nn.functional.gelu(x @ dequant(w1, x.dtype).t() + b1,
                                    approximate='tanh') @ w2 + b2)
    if is_fp8:
        assert not torch.allclose(yt, deq, rtol=1e-4, atol=1e-5)
    else:
        torch.testing.assert_close(yt, deq, rtol=1e-5, atol=1e-6)
    oj, sj = jmod.full_step(*ja, jmod.init_state(jnp.float32))
    ot, st = tmod.full_step(*ta, tmod.init_state(torch.float32,
                                                 device='cpu'))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **MOD_TOL)
    for name in ('out_cache', 'act_cache', 'bm_mid'):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(sj, name)), **MOD_TOL)


def test_sparse_kernels_still_refuse_fp8_weights():
    """is_fp8 never sends an fp8 weight to the sparse kernels: the plain
    versions refuse one, as the reference's kernels do."""
    (_, _), (tmod, (x, w1, b1, w2, _)) = module_setup(True)
    st = tmod.init_state(torch.float32, device='cpu')
    with pytest.raises(ValueError, match='fp8 QTensor'):
        csp_mlp(x, w1, b1, w2, st.act_cache, st.out_cache, st.inds,
                st.counts, bn=128, bm=128)
    assert isinstance(w1, QTensor)
