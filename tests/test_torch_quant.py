"""chipmunk_torch.utils.quant against chipmunk_tpu.utils.quant on the same
numpy inputs: quantized bytes, scales and pack axes are identical, and
the synthetic quantized FLUX tree is byte-identical for the same seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chipmunk_tpu.models import FluxModelConfig as JModel
from chipmunk_tpu.models import init_flux_params as j_init_flux_params
from chipmunk_tpu.utils import quant as jq
from chipmunk_torch.models import FluxModelConfig, params_from_jax
from chipmunk_torch.utils import quant as tq

TINY = dict(in_channels=16, vec_in_dim=32, context_in_dim=32, hidden_size=128,
            num_heads=2, mlp_ratio=4.0, depth=2, depth_single_blocks=2,
            axes_dim=(16, 24, 24), guidance_embed=False, txt_len=128)
SHIPPED = tq.QuantSpec('int4', 'int4', 'int8', 'int4')


def raw_bytes(t):
    t = t.detach().cpu().contiguous()
    return t.view(torch.uint8).numpy() if t.dtype.itemsize == 1 else \
        t.view({2: torch.int16, 4: torch.int32}[t.dtype.itemsize]).numpy()


def np_bytes(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view({1: np.uint8, 2: np.int16, 4: np.int32}[a.dtype.itemsize])


def assert_qt_equal(got: tq.QTensor, ref):
    assert isinstance(got, tq.QTensor)
    assert got.pack_axis == ref.pack_axis
    assert tuple(got.q.shape) == tuple(np.shape(ref.q))
    np.testing.assert_array_equal(raw_bytes(got.q), np_bytes(ref.q))
    np.testing.assert_array_equal(raw_bytes(got.scale), np_bytes(ref.scale))


def assert_tree_equal(got, ref):
    """Port tree vs the port's conversion of the reference tree."""
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert_tree_equal(got[k], ref[k])
    elif isinstance(ref, list):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert_tree_equal(g, r)
    elif isinstance(ref, tq.QTensor):
        assert isinstance(got, tq.QTensor) and got.pack_axis == ref.pack_axis
        assert got.q.dtype == ref.q.dtype
        np.testing.assert_array_equal(raw_bytes(got.q), raw_bytes(ref.q))
        np.testing.assert_array_equal(raw_bytes(got.scale),
                                      raw_bytes(ref.scale))
    else:
        assert not isinstance(got, tq.QTensor) and got.dtype == ref.dtype
        np.testing.assert_array_equal(raw_bytes(got), raw_bytes(ref))


# (shape, keep_axes, pack_axis): stacked [L, in, out] linear, one layer's
# linear, one layer's output-major MLP weight
CASES = [((3, 64, 32), (0, 2), 1), ((64, 32), (1,), 0), ((32, 64), (0,), 1)]


@pytest.mark.parametrize('kind', ['fp8', 'int8', 'int4'])
@pytest.mark.parametrize('shape,keep,pack', CASES)
def test_quantize_matches_reference(kind, shape, keep, pack):
    w = (np.random.default_rng(0).standard_normal(shape) * 0.3).astype(
        np.float32)
    w[0] *= 5.0                        # unequal channel ranges
    pack = pack if kind == 'int4' else None
    ref = jq.quantize(jnp.asarray(w), kind, keep_axes=keep, pack_axis=pack)
    got = tq.quantize(torch.from_numpy(w), kind, keep_axes=keep,
                      pack_axis=pack)
    assert_qt_equal(got, ref)
    host_ref = jq.quantize_host(w, kind, keep_axes=keep, pack_axis=pack)
    assert_qt_equal(tq.quantize_host(w, kind, keep_axes=keep,
                                     pack_axis=pack), host_ref)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            raw_bytes(tq.dequant(got, dt)),
            np_bytes(jq.dequant(ref, jdt)))
    plain = torch.ones(3)
    assert tq.dequant(plain) is plain and not tq.is_quantized(plain)
    assert tq.is_quantized(got)


def test_quantize_refuses_bad_requests():
    w = torch.ones((4, 6))
    with pytest.raises(ValueError):
        tq.quantize(w, 'int4', keep_axes=(1,), pack_axis=1)   # in keep
    with pytest.raises(ValueError):
        tq.quantize(torch.ones((3, 4)), 'int4', keep_axes=(1,), pack_axis=0)
    with pytest.raises(ValueError):
        tq.quantize(w, 'int2', keep_axes=(1,))
    with pytest.raises(ValueError):
        tq.quantize_flux_params({'double': [], 'single': []},
                                tq.QuantSpec(attn='int2'))


@pytest.mark.parametrize('spec', [SHIPPED, tq.QuantSpec()],
                         ids=['shipped', 'fp8'])
def test_quantize_flux_params_matches_reference(spec):
    jm = JModel(**TINY, dtype=jnp.float32)
    params = j_init_flux_params(jax.random.PRNGKey(0), jm)
    ref = jq.quantize_flux_params(params, jq.QuantSpec(*spec))
    ref_t = params_from_jax(jax.tree_util.tree_map(np.asarray, ref),
                            device='cpu')
    got = tq.quantize_flux_params(
        params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                        device='cpu'), spec)
    assert_tree_equal(got, ref_t)
    assert isinstance(got['double'][1]['img_qkv']['w'], tq.QTensor)
    assert tq.param_bytes(got) == jq.param_bytes(ref)


@pytest.mark.parametrize('spec', [SHIPPED, tq.QuantSpec()],
                         ids=['shipped', 'fp8'])
@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_synth_quantized_flux_params_matches_reference(spec, dtype):
    """Depth 1+1 at the tiny widths: the same seed gives the same bytes
    (the port draws in the reference's tree order, then splits layers)."""
    kw = dict(TINY, depth=1, depth_single_blocks=1, guidance_embed=True)
    jm = JModel(**kw, dtype=getattr(jnp, dtype))
    tm = FluxModelConfig(**kw, dtype=getattr(torch, dtype))
    ref = jq.synth_quantized_flux_params(3, jm, jq.QuantSpec(*spec))
    ref_t = params_from_jax(jax.tree_util.tree_map(np.asarray, ref),
                            device='cpu')
    got = tq.synth_quantized_flux_params(3, tm, spec, device='cpu')
    assert_tree_equal(got, ref_t)
    assert tq.param_bytes(got) == jq.param_bytes(ref)
    w1t = got['single'][0]['w1t']
    assert w1t.q.dtype == (torch.int8 if spec == SHIPPED else
                           torch.float8_e4m3fn)
