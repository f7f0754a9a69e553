"""The chipmunk_torch checkpoint loaders against chipmunk_tpu's on the
state dicts of tests/test_loaders.py: each leaf of the port's tree is
torch.equal to params_from_jax of the reference loader's tree, from numpy
and torch values, a lazy mapping, and .safetensors files written by the
``safetensors`` package and by the port's own writer; one forward of each
tiny model from the loaded params against the reference's forward from
its loaded params (float32, TOL)."""
import collections.abc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy
import torch

from chipmunk_tpu.config import config_from_dict as j_config_from_dict
from chipmunk_tpu.models import loaders as jld
from chipmunk_tpu.models.flux import FluxModelConfig as JFlux
from chipmunk_tpu.models.flux import FluxSparse as JSparse
from chipmunk_tpu.models.flux import FluxStep as JStep
from chipmunk_tpu.models.flux import flux_forward as j_flux_forward
from chipmunk_tpu.models.hunyuan import HunyuanModel as JHunyuan
from chipmunk_tpu.models.hunyuan import HunyuanModelConfig as JHyConfig
from chipmunk_tpu.models.wan import WanModel as JWan
from chipmunk_tpu.models.wan import WanModelConfig as JWanConfig
from chipmunk_torch.config import config_from_dict
from chipmunk_torch.models import (FluxModelConfig, FluxSparse, FluxStep,
                                   HunyuanModel, HunyuanModelConfig,
                                   WanModel, WanModelConfig, flux_forward,
                                   params_from_jax)
from chipmunk_torch.models import loaders as tld
from chipmunk_torch.models.flux import flux_rope_ids
from chipmunk_torch.models.layers import build_rope
from chipmunk_torch.utils.quant import QTensor
from chipmunk_torch.utils.safetensors_io import save_file
from test_loaders import (synth_hunyuan_state_dict, synth_state_dict,
                          synth_wan_state_dict)

# float32 on both sides, a few layers: summation order only
TOL = dict(atol=1e-4, rtol=1e-4)
DTYPES = {'float32': (jnp.float32, torch.float32),
          'bfloat16': (jnp.bfloat16, torch.bfloat16)}
FLUX = dict(in_channels=8, vec_in_dim=16, context_in_dim=16, hidden_size=64,
            num_heads=2, mlp_ratio=2.0, depth=2, depth_single_blocks=2,
            axes_dim=(8, 12, 12), guidance_embed=True, txt_len=128)
HY = dict(latent_t=2, latent_h=8, latent_w=16, in_channels=4,
          hidden_size=128, num_heads=2, depth_double=2, depth_single=2,
          axes_dim=(16, 24, 24), text_dim=64, vec_in_dim=32, txt_len=128,
          guidance_embed=True)
WAN = dict(latent_t=2, latent_h=8, latent_w=16, in_channels=4, dim=128,
           ffn_dim=256, num_heads=2, num_layers=2, text_dim=64, txt_len=64,
           freq_dim=64, axes_dim=(16, 24, 24))


def perturbed(sd, rng):
    """Norm weights of ones and zero biases made random, so that a leaf
    read from the wrong key shows."""
    return {k: (v + rng.standard_normal(v.shape).astype(np.float32) * 0.1
                if np.all(v == v.flat[0]) else v) for k, v in sd.items()}


def flux_case(dtype='float32'):
    jdt, tdt = DTYPES[dtype]
    jc, tc = JFlux(**FLUX, dtype=jdt), FluxModelConfig(**FLUX, dtype=tdt)
    return jc, tc, perturbed(synth_state_dict(jc, np.random.default_rng(0)),
                             np.random.default_rng(1))


def hunyuan_case():
    jc = JHyConfig(**HY, dtype=jnp.float32)
    tc = HunyuanModelConfig(**HY, dtype=torch.float32)
    return jc, tc, perturbed(synth_hunyuan_state_dict(
        jc, np.random.default_rng(2)), np.random.default_rng(3))


def wan_case():
    jc = JWanConfig(**WAN, dtype=jnp.float32)
    tc = WanModelConfig(**WAN, dtype=torch.float32)
    return jc, tc, perturbed(synth_wan_state_dict(
        jc, np.random.default_rng(4)), np.random.default_rng(5))


def reference_tree(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                           device='cpu')


def assert_trees_equal(got, want, path=''):
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_trees_equal(got[k], want[k], f'{path}/{k}')
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f'{path}/{i}')
    elif isinstance(want, QTensor):
        assert got.pack_axis == want.pack_axis, path
        assert_trees_equal(got.q, want.q, f'{path}.q')
        assert_trees_equal(got.scale, want.scale, f'{path}.scale')
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, \
            (path, got.dtype, want.dtype, got.shape, want.shape)
        assert torch.equal(got, want), path


def as_torch(sd):
    return {k: torch.from_numpy(v.copy()) for k, v in sd.items()}


class CountingMapping(collections.abc.Mapping):
    """A lazy state dict: values made on each read, reads counted; a
    membership test makes no value."""

    def __init__(self, sd):
        self.sd, self.reads = sd, collections.Counter()

    def __contains__(self, k):
        return k in self.sd

    def __getitem__(self, k):
        self.reads[k] += 1
        return torch.from_numpy(self.sd[k].copy())

    def __iter__(self):
        return iter(self.sd)

    def __len__(self):
        return len(self.sd)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('values', ['numpy', 'torch'])
@pytest.mark.parametrize('is_fp8', [False, True])
def test_flux_loader_matches_reference(dtype, values, is_fp8):
    """Every leaf torch.equal, the single-block split and, under
    mlp.is_fp8, the int8 sparse and fp8 text MLP QTensors (the port
    quantizes in torch, the reference in numpy)."""
    jc, tc, sd = flux_case(dtype)
    d = {'mlp': {'is_fp8': is_fp8}}
    want = reference_tree(jld.load_flux_params(sd, jc,
                                               ck=j_config_from_dict(d)))
    got = tld.load_flux_params(sd if values == 'numpy' else as_torch(sd), tc,
                               ck=config_from_dict(d), device='cpu')
    assert_trees_equal(got, want)
    w1t, txt = got['double'][0]['img_w1t'], got['double'][0]['txt_w1t']
    if is_fp8:
        assert w1t.q.dtype == torch.int8 and w1t.scale.shape == (128, 1)
        assert txt.q.dtype == torch.float8_e4m3fn
        assert got['single'][1]['w2'].q.dtype == torch.int8
        assert not isinstance(got['double'][0]['img_qkv']['w'], QTensor)
    else:
        assert w1t.dtype == DTYPES[dtype][1]


def test_flux_loader_without_ck_or_guidance_and_bf16_values():
    """No ck: plain tensors; a config without guidance drops guidance_in;
    bfloat16 values (as real checkpoints store them) load as their
    float32 upcast would."""
    jc, tc, sd = flux_case()
    got = tld.load_flux_params(sd, tc, device='cpu')
    assert not isinstance(got['double'][0]['img_w1t'], QTensor)
    assert 'guidance_in' in got
    no_g = FluxModelConfig(**dict(FLUX, guidance_embed=False),
                           dtype=torch.float32)
    assert 'guidance_in' not in tld.load_flux_params(sd, no_g, device='cpu')
    bf = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in sd.items()}
    up = {k: v.float() for k, v in bf.items()}
    assert_trees_equal(tld.load_flux_params(bf, tc, device='cpu'),
                       tld.load_flux_params(up, tc, device='cpu'))


@pytest.mark.parametrize('values', ['numpy', 'torch'])
def test_hunyuan_loader_matches_reference(values):
    """The Conv3d img_in as a (C, pt, ph, pw) patch linear, the identity
    txt_in, the two-block refiner, guidance_in."""
    jc, tc, sd = hunyuan_case()
    want = reference_tree(jld.load_hunyuan_params(sd, jc))
    got = tld.load_hunyuan_params(sd if values == 'numpy' else as_torch(sd),
                                  tc, device='cpu')
    assert_trees_equal(got, want)
    assert len(got['refiner']['blocks']) == 2 and 'guidance_in' in got
    assert torch.equal(got['txt_in']['w'], torch.eye(128))


@pytest.mark.parametrize('values', ['numpy', 'torch'])
def test_wan_loader_matches_reference(values):
    """modulation[0], head.modulation[0], the patch-embedding conv as a
    linear, the cross-attention norms."""
    jc, tc, sd = wan_case()
    want = reference_tree(jld.load_wan_params(sd, jc))
    got = tld.load_wan_params(sd if values == 'numpy' else as_torch(sd), tc,
                              device='cpu')
    assert_trees_equal(got, want)
    assert got['blocks'][0]['mod_bias'].shape == (6, 128)
    assert got['head_mod'].shape == (2, 128)


@pytest.mark.parametrize('model', ['flux', 'hunyuan', 'wan'])
def test_loaders_read_a_lazy_mapping_once_per_key(model):
    jc, tc, sd = {'flux': flux_case, 'hunyuan': hunyuan_case,
                  'wan': wan_case}[model]()
    lazy = CountingMapping(sd)
    if model == 'flux':
        ck = config_from_dict({'mlp': {'is_fp8': True}})
        got = tld.load_flux_params(lazy, tc, ck=ck, device='cpu')
        want = reference_tree(jld.load_flux_params(
            sd, jc, ck=j_config_from_dict({'mlp': {'is_fp8': True}})))
    else:
        got = getattr(tld, f'load_{model}_params')(lazy, tc, device='cpu')
        want = reference_tree(getattr(jld, f'load_{model}_params')(sd, jc))
    assert_trees_equal(got, want)
    assert max(lazy.reads.values()) == 1


@pytest.mark.parametrize('writer', ['safetensors', 'port'])
@pytest.mark.parametrize('model', ['flux', 'flux_fp8', 'hunyuan', 'wan'])
def test_safetensors_loaders_match_reference(model, writer, tmp_path):
    """``load_*_safetensors`` from a file written by the safetensors
    package and by ``safetensors_io.save_file``; the reference reads the
    package's file."""
    case = {'flux': flux_case, 'flux_fp8': flux_case, 'hunyuan': hunyuan_case,
            'wan': wan_case}[model]
    jc, tc, sd = case()
    ref_file = str(tmp_path / 'ref.safetensors')
    safetensors.numpy.save_file(sd, ref_file)
    f = str(tmp_path / 'ckpt.safetensors')
    if writer == 'port':
        save_file(as_torch(sd), f)
    else:
        f = ref_file
    if model.startswith('flux'):
        d = {'mlp': {'is_fp8': model == 'flux_fp8'}}
        want = jld.load_flux_safetensors(ref_file, jc,
                                         ck=j_config_from_dict(d))
        got = tld.load_flux_safetensors(f, tc, ck=config_from_dict(d),
                                        device='cpu')
    else:
        name = 'hunyuan' if model == 'hunyuan' else 'wan'
        want = getattr(jld, f'load_{name}_safetensors')(ref_file, jc)
        got = getattr(tld, f'load_{name}_safetensors')(f, tc, device='cpu')
    assert_trees_equal(got, reference_tree(want))


def test_loaders_need_a_gpu_unless_asked_for_cpu(monkeypatch):
    _, tc, sd = flux_case()
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        tld.load_flux_params(sd, tc)


# ------------------------------------------------------- tiny forwards

def dense_ck():
    return {'attn': {'is_enabled': False}, 'mlp': {'is_enabled': False}}


def test_flux_forward_from_loaded_params_matches_reference():
    """A full step (every module dense) of the loaded tiny FLUX: [txt 128
    | img 8 x 16]."""
    jc, tc, sd = flux_case()
    jp = jld.load_flux_params(sd, jc)
    tp = tld.load_flux_params(sd, tc, device='cpu')
    h_img, w_img, seq = 8, 16, 256
    jsp = JSparse.build(j_config_from_dict(dense_ck()), jc, seq,
                        use_kernels=False)
    tsp = FluxSparse.build(config_from_dict(dense_ck()), tc, seq)
    rng = np.random.default_rng(6)
    img = rng.standard_normal((1, h_img * w_img, 8)).astype(np.float32)
    txt = rng.standard_normal((1, 128, 16)).astype(np.float32)
    y = rng.standard_normal((1, 16)).astype(np.float32)
    t, g = np.full((1,), 0.7, np.float32), np.full((1,), 4.0, np.float32)
    ids = flux_rope_ids(1, h_img, w_img, 128, 'cpu')
    pe = build_rope(ids, tc.axes_dim, tc.theta)
    from chipmunk_tpu.models.layers import build_rope as j_build_rope
    jpe = j_build_rope(jnp.asarray(ids.numpy()), jc.axes_dim, jc.theta)
    step = (True, True, False, False)
    pj, _ = j_flux_forward(jp, jc, jsp, jnp.asarray(img), jnp.asarray(txt),
                           jnp.asarray(t), jnp.asarray(y), jpe,
                           jsp.init_state(jc, 1), JStep(0, *step),
                           guidance=jnp.asarray(g))
    pt, _ = flux_forward(tp, tc, tsp, torch.from_numpy(img),
                         torch.from_numpy(txt), torch.from_numpy(t),
                         torch.from_numpy(y), pe,
                         tsp.init_state(tc, 1, device='cpu'),
                         FluxStep(0, *step), guidance=torch.from_numpy(g))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **TOL)


def test_hunyuan_forward_from_loaded_params_matches_reference():
    jc, tc, sd = hunyuan_case()
    jp = jld.load_hunyuan_params(sd, jc)
    tp = tld.load_hunyuan_params(sd, tc, device='cpu')
    jm = JHunyuan(cfg=jc, ck=j_config_from_dict(dense_ck()),
                  use_kernels=False)
    tm = HunyuanModel(cfg=tc, ck=config_from_dict(dense_ck()), device='cpu')
    rng = np.random.default_rng(7)
    lat = rng.standard_normal((1, 4, 2, 8, 16)).astype(np.float32)
    txt = rng.standard_normal((1, 128, 64)).astype(np.float32)
    y = rng.standard_normal((1, 32)).astype(np.float32)
    t, g = np.full((1,), 0.5, np.float32), np.full((1,), 4.0, np.float32)
    step = (True, True, False, False)
    pj, _ = jm.forward(jp, jnp.asarray(lat), jnp.asarray(txt), jnp.asarray(t),
                       jnp.asarray(y), jm.init_state(1), JStep(0, *step),
                       guidance=jnp.asarray(g))
    pt, _ = tm.forward(tp, torch.from_numpy(lat), torch.from_numpy(txt),
                       torch.from_numpy(t), torch.from_numpy(y),
                       tm.init_state(1), FluxStep(0, *step),
                       guidance=torch.from_numpy(g))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **TOL)


def test_wan_forward_from_loaded_params_matches_reference():
    jc, tc, sd = wan_case()
    jp = jld.load_wan_params(sd, jc)
    tp = tld.load_wan_params(sd, tc, device='cpu')
    jm = JWan(cfg=jc, ck=j_config_from_dict(dense_ck()), use_kernels=False)
    tm = WanModel(cfg=tc, ck=config_from_dict(dense_ck()), device='cpu')
    rng = np.random.default_rng(8)
    lat = rng.standard_normal((1, 4, 2, 8, 16)).astype(np.float32)
    ctx = rng.standard_normal((1, 64, 64)).astype(np.float32)
    t = np.full((1,), 0.5, np.float32)
    step = (True, True, False, False)
    pj, _ = jm.forward(jp, jnp.asarray(lat), jnp.asarray(ctx), jnp.asarray(t),
                       jm.init_state(1), JStep(0, *step),
                       key=jax.random.PRNGKey(0))
    pt, _ = tm.forward(tp, torch.from_numpy(lat), torch.from_numpy(ctx),
                       torch.from_numpy(t), tm.init_state(1),
                       FluxStep(0, *step))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **TOL)


@pytest.mark.parametrize('model', ['flux', 'hunyuan', 'wan'])
def test_smoke_state_dicts_have_the_synth_layouts(model):
    """The lazy state dicts chip_smoke.py draws on the card have the keys
    and shapes of tests/test_loaders.py's synth_*_state_dict, and load
    through the port's loaders (here on the CPU)."""
    from chip_smoke import (SeededStateDict, flux_bfl_shapes, hunyuan_shapes,
                            wan_shapes)
    jc, tc, sd = {'flux': flux_case, 'hunyuan': hunyuan_case,
                  'wan': wan_case}[model]()
    shapes = {'flux': flux_bfl_shapes, 'hunyuan': hunyuan_shapes,
              'wan': wan_shapes}[model](tc)
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(s) for k, (s, _) in shapes.items()}
    lazy = SeededStateDict(torch, shapes, 0, 'cpu', torch.float32)
    assert torch.equal(lazy[next(iter(lazy))], lazy[next(iter(lazy))])
    getattr(tld, f'load_{model}_params')(lazy, tc, device='cpu')
