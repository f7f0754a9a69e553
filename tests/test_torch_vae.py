"""The chipmunk_torch decoders (the FLUX autoencoder, the HunyuanVideo
causal-3D VAE, the Wan2.1 VAE), their primitives, the FLUX latent unpack
and the decoders' loaders against chipmunk_tpu, on the JAX tests' tiny
configs, with the same numpy inputs and the reference's trees, every leaf
perturbed with seeded noise (the initialisers zero every bias and Wan's
attention projection, and set every norm weight to 1, which would hide a
transposed bias, a swapped gamma or a wrong attention path), carried
across by the converters.

The reference is channels-last; the port is NCDHW, so inputs go in
transposed and outputs come back transposed.  float32 on both sides:
primitives and decoders to 1e-4 (convolutions summed in another order).
The port's pieces (a conv split over time, the HunyuanVideo attention one
query frame at a time in row blocks) are also held against the unsplit
form: the same values to 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chipmunk_tpu.models import autoencoder as jae
from chipmunk_tpu.models import loaders as jld
from chipmunk_tpu.models import video_vae as jvv
from chipmunk_torch.models import autoencoder as tae
from chipmunk_torch.models import loaders as tld
from chipmunk_torch.models import params_from_jax, unpack
from chipmunk_torch.models import video_vae as tvv

TOL = dict(atol=1e-4, rtol=1e-4)
SPLIT = dict(atol=1e-5, rtol=1e-5)
HY_KW = dict(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
             latent_channels=4, norm_groups=4)
WAN_KW = dict(dim=8, z_dim=4, num_res_blocks=1)
# the reference's decoders and initialisers, jitted (op by op they take
# seconds to dispatch on the CPU)
J_HY_DECODE = jax.jit(jvv.hunyuan_vae_decode, static_argnums=(2,))
J_WAN_DECODE = jax.jit(jvv.wan_vae_decode, static_argnums=(2,))
J_HY_INIT = jax.jit(jvv.init_hunyuan_vae_decoder, static_argnums=(1,))
J_WAN_INIT = jax.jit(jvv.init_wan_vae_decoder, static_argnums=(1,))
J_AE_DECODE = jax.jit(jae.decode, static_argnums=(2,))


def perturb(tree, seed):
    """Every leaf plus seeded noise of a tenth of its mean magnitude (0.05
    for an all-zero leaf)."""
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.asarray(a, np.float32)
        mag = float(np.abs(a).mean()) or 0.5
        return jnp.asarray(a + rng.standard_normal(a.shape).astype(
            np.float32) * 0.1 * mag)
    return jax.tree_util.tree_map(leaf, tree)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def randn(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def cl(x):
    """NCDHW numpy -> channels-last jax."""
    return jnp.asarray(np.moveaxis(x, 1, -1))


def from_cl(y):
    return np.moveaxis(np.asarray(y), -1, 1)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------- primitives

@pytest.mark.parametrize('pad_mode', ['edge', 'constant'])
@pytest.mark.parametrize('k', [(3, 3, 3), (3, 1, 1), (1, 1, 1)])
def test_causal_conv3d_matches_reference(pad_mode, k, monkeypatch):
    x = randn(0, 2, 6, 5, 7, 9)                       # [B, C, T, H, W]
    w = randn(1, 8, 6, *k, scale=0.2)                  # [Co, Ci, kt, kh, kw]
    b = randn(2, 8)
    ref = jvv.causal_conv3d(cl(x), jnp.asarray(w.transpose(2, 3, 4, 1, 0)),
                            jnp.asarray(b), pad_mode=pad_mode)
    got = tvv.causal_conv3d(t(x), t(w), t(b), pad_mode)
    np.testing.assert_allclose(got.numpy(), from_cl(ref), **TOL)
    # split over time into pieces of 1-2 output frames, each with its
    # own halo: the same function
    for piece_elems in (1, 3 * 6 * 7 * 9 * 2):
        monkeypatch.setattr(tvv, 'PIECE_ELEMS', piece_elems)
        split = tvv.causal_conv3d(t(x), t(w), t(b), pad_mode)
        np.testing.assert_allclose(split.numpy(), got.numpy(), **SPLIT)


def test_conv2d_samepad_matches_reference(monkeypatch):
    x = randn(3, 1, 6, 4, 5, 7)
    w = randn(4, 5, 6, 3, 3, scale=0.2)
    b = randn(5, 5)
    ref = jvv.conv2d_samepad(cl(x), jnp.asarray(w.transpose(2, 3, 1, 0)),
                             jnp.asarray(b))
    got = tvv.conv2d_samepad(t(x), t(w), t(b))
    np.testing.assert_allclose(got.numpy(), from_cl(ref), **TOL)
    monkeypatch.setattr(tvv, 'PIECE_ELEMS', 1)
    np.testing.assert_allclose(tvv.conv2d_samepad(t(x), t(w), t(b)).numpy(),
                               got.numpy(), **SPLIT)


def test_norms_and_upsample_match_reference():
    x = randn(6, 2, 8, 3, 4, 5) * 3 + 1
    g, be = randn(7, 8) + 1, randn(8, 8)
    ref = jvv.group_norm(cl(x), jnp.asarray(g), jnp.asarray(be), 4)
    np.testing.assert_allclose(
        tvv.group_norm(t(x), t(g), t(be), 4).numpy(), from_cl(ref), **TOL)
    ref = jvv.channel_rms_norm(cl(x), jnp.asarray(g))
    np.testing.assert_allclose(tvv.channel_rms_norm(t(x), t(g)).numpy(),
                               from_cl(ref), **TOL)
    np.testing.assert_array_equal(tvv.nearest_up2d(t(x)).numpy(),
                                  from_cl(jvv.nearest_up2d(cl(x))))


@pytest.mark.parametrize('time', [False, True])
def test_hunyuan_upsample_matches_reference(time):
    """Nearest 2x, every frame but the first doubled in time, replicate
    padding: gathered per piece in the port."""
    x = randn(9, 1, 4, 3, 4, 5)
    w = randn(10, 4, 4, 3, 3, 3, scale=0.2)
    p = {'conv_w': jnp.asarray(w.transpose(2, 3, 4, 1, 0)),
         'conv_b': jnp.asarray(randn(11, 4))}
    ref = from_cl(jvv._hy_upsample(p, cl(x), time=time))
    tp = tvv.hunyuan_vae_params_from_jax(np_tree(p), device='cpu')
    got = tvv._hy_upsample(tp, t(x), time)
    assert got.shape == ref.shape == (1, 4, 5 if time else 3, 8, 10)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize('temporal', [False, True])
def test_wan_upsample_matches_reference(temporal):
    """Wan's interleave of the time conv's 2C channels (pair-major: the
    first C are the even frame) over 4 frames, then up and conv."""
    x = randn(12, 1, 8, 4, 3, 5)
    p = {'conv_w': randn(13, 3, 3, 8, 4, scale=0.2),
         'conv_b': randn(14, 4)}
    if temporal:
        p.update(time_w=randn(15, 3, 1, 1, 8, 16, scale=0.2),
                 time_b=randn(16, 16))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    ref = from_cl(jvv._wan_upsample(jp, cl(x), temporal=temporal))
    got = tvv._wan_upsample(tvv.wan_vae_params_from_jax(p, device='cpu'),
                            t(x), temporal)
    assert got.shape == ref.shape == (1, 4, 7 if temporal else 4, 6, 10)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def hy_attn_params(C, seed):
    rng = np.random.default_rng(seed)
    p = {'gn_w': 1 + 0.1 * rng.standard_normal(C),
         'gn_b': 0.1 * rng.standard_normal(C)}
    for n in 'qkvo':
        p[n + '_w'] = rng.standard_normal((C, C)) * C ** -0.5
        p[n + '_b'] = 0.1 * rng.standard_normal(C)
    return {k: np.asarray(v, np.float32) for k, v in p.items()}


def test_hunyuan_mid_attention_frame_at_a_time_matches_reference(
        monkeypatch):
    """The port's frame-causal attention (one query frame over key frames
    0..t, in row blocks) against the reference's whole masked score
    matrix, and the row blocks against one block a frame."""
    C = 8
    x = randn(17, 1, C, 4, 3, 5)
    p = hy_attn_params(C, 18)
    ref = from_cl(jvv._hy_mid_attn({k: jnp.asarray(v) for k, v in p.items()},
                                   cl(x), groups=4))
    tp = tvv.hunyuan_vae_params_from_jax(p, device='cpu')
    got = tvv._hy_mid_attn(tp, t(x), 4)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    for score_elems in (1, 40):      # one row a block; a few rows a block
        monkeypatch.setattr(tvv, 'SCORE_ELEMS', score_elems)
        np.testing.assert_allclose(tvv._hy_mid_attn(tp, t(x), 4).numpy(),
                                   got.numpy(), **SPLIT)


# --------------------------------------------------------- FLUX autoencoder

AE_SMALL = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=16)


def test_flux_ae_decode_matches_reference():
    jcfg, tcfg = jae.AutoEncoderParams(**AE_SMALL), \
        tae.AutoEncoderParams(**AE_SMALL)
    jp = perturb(jae.init_decoder_params(jax.random.PRNGKey(0), jcfg), 0)
    tp = params_from_jax(np_tree(jp), device='cpu')
    z = randn(19, 1, 16, 8, 12)
    ref = np.asarray(J_AE_DECODE(jp, jnp.asarray(z), jcfg))
    got = tae.decode(tp, t(z), tcfg)
    assert got.shape == ref.shape == (1, 3, 16, 24)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # the port's initialiser draws the same tree
    mine = tae.init_decoder_params(torch.Generator().manual_seed(0), tcfg,
                                   device='cpu')
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), mine) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), tp)


def test_unpack_matches_the_example_reshape():
    """examples/flux_generate.py:155-157: tokens [B, h*w, 64] -> z [B, 16,
    2h, 2w]."""
    B, h, w = 2, 3, 5
    x = randn(20, B, h * w, 64)
    ref = x.reshape(B, h, w, 16, 2, 2).transpose(0, 3, 1, 4, 2, 5).reshape(
        B, 16, 2 * h, 2 * w)
    np.testing.assert_array_equal(unpack(t(x), 16 * h, 16 * w).numpy(), ref)


def test_flux_ae_loader_matches_reference_loader(tmp_path):
    """ae.safetensors: the ``decoder.*`` keys (OIHW, as stored) load into
    the same tree on both sides, and decode alike; other keys are
    skipped."""
    import safetensors.numpy
    jcfg = jae.AutoEncoderParams(**AE_SMALL)
    jp = perturb(jae.init_decoder_params(jax.random.PRNGKey(0), jcfg), 1)
    sd = {'encoder.conv_in.weight': np.zeros((4, 3, 3, 3), np.float32)}

    def flat(tree, pre):
        if isinstance(tree, dict):
            for k, v in tree.items():
                flat(v, f'{pre}.{k}')
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                flat(v, f'{pre}.{i}')
        else:
            sd[pre] = np.asarray(tree, np.float32)
    flat(jp['decoder'], 'decoder')
    f = str(tmp_path / 'ae.safetensors')
    safetensors.numpy.save_file(sd, f)
    ref_tree = jld.load_ae_decoder_safetensors(f)
    tp = tld.load_ae_decoder_safetensors(f, device='cpu')
    assert sorted(tp['decoder']['up']) == [0, 1]
    assert isinstance(tp['decoder']['up'][1]['block'], list)
    for a, b in zip(jax.tree_util.tree_leaves(tp),
                    jax.tree_util.tree_leaves(np_tree(ref_tree))):
        np.testing.assert_array_equal(a.numpy(), b)
    z = randn(21, 1, 16, 4, 6)
    np.testing.assert_allclose(
        tae.decode(tp, t(z), tae.AutoEncoderParams(**AE_SMALL)).numpy(),
        np.asarray(J_AE_DECODE(ref_tree, jnp.asarray(z), jcfg)), **TOL)


# ------------------------------------------------------------ video VAEs

@functools.lru_cache(maxsize=None)
def hy_pair(seed=0):
    jcfg = jvv.HyVaeConfig(**HY_KW)
    jp = perturb(J_HY_INIT(jax.random.PRNGKey(seed), jcfg), seed)
    return jcfg, jp, tvv.HyVaeConfig(**HY_KW), \
        tvv.hunyuan_vae_params_from_jax(np_tree(jp), device='cpu')


@functools.lru_cache(maxsize=None)
def wan_pair(seed=0):
    jcfg = jvv.WanVaeConfig(**WAN_KW)
    jp = perturb(J_WAN_INIT(jax.random.PRNGKey(seed), jcfg), seed)
    return jcfg, jp, tvv.WanVaeConfig(**WAN_KW), \
        tvv.wan_vae_params_from_jax(np_tree(jp), device='cpu')


def test_hunyuan_vae_decode_matches_reference():
    jcfg, jp, tcfg, tp = hy_pair()
    z = randn(22, 1, 4, 3, 4, 6)
    ref = np.asarray(J_HY_DECODE(jp, jnp.asarray(z), jcfg))
    got = tvv.hunyuan_vae_decode(tp, t(z), tcfg)
    assert got.shape == ref.shape == (1, 3, 9, 32, 48)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    mine = tvv.init_hunyuan_vae_decoder(torch.Generator().manual_seed(0),
                                        tcfg, device='cpu')
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), mine) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), tp)


def test_wan_vae_decode_matches_reference_and_is_prefix_closed():
    jcfg, jp, tcfg, tp = wan_pair()
    z = randn(23, 1, 4, 4, 4, 6)
    ref = np.asarray(J_WAN_DECODE(jp, jnp.asarray(z), jcfg))
    got = tvv.wan_vae_decode(tp, t(z), tcfg)
    assert got.shape == ref.shape == (1, 3, 13, 32, 48)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # the first N latent frames decode to the first 4(N-1)+1 frames
    for n in (1, 2, 3):
        pre = tvv.wan_vae_decode(tp, t(z[:, :, :n]), tcfg)
        np.testing.assert_allclose(pre.numpy(),
                                   got[:, :, :4 * (n - 1) + 1].numpy(),
                                   **SPLIT)
    mine = tvv.init_wan_vae_decoder(torch.Generator().manual_seed(0), tcfg,
                                    device='cpu')
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), mine) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), tp)


def test_video_decoders_split_into_pieces_match_unsplit(monkeypatch):
    """Every conv split into one-frame pieces and every attention into
    one-row blocks: the same decodes."""
    _, _, hcfg, hp = hy_pair(1)
    _, _, wcfg, wp = wan_pair(1)
    z = t(randn(24, 1, 4, 3, 4, 6))
    whole = (tvv.hunyuan_vae_decode(hp, z, hcfg),
             tvv.wan_vae_decode(wp, z, wcfg))
    monkeypatch.setattr(tvv, 'PIECE_ELEMS', 1)
    monkeypatch.setattr(tvv, 'SCORE_ELEMS', 1)
    pieces = (tvv.hunyuan_vae_decode(hp, z, hcfg),
              tvv.wan_vae_decode(wp, z, wcfg))
    for a, b in zip(pieces, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **SPLIT)


# -------------------------------------------------------- video loaders

def torch_conv(rng, co, ci, k):
    return (rng.standard_normal((co, ci) + k) * 0.05).astype(np.float32)


def hunyuan_state_dict(cfg, rng):
    """A diffusers-layout AutoencoderKLCausal3D decoder state dict."""
    sd = {}

    def conv(name, ci, co, k=(3, 3, 3)):
        sd[f'{name}.weight'] = torch_conv(rng, co, ci, k)
        sd[f'{name}.bias'] = (rng.standard_normal(co) * .01).astype(
            np.float32)

    def norm(name, c):
        sd[f'{name}.weight'] = (1 + 0.1 * rng.standard_normal(c)).astype(
            np.float32)
        sd[f'{name}.bias'] = (0.1 * rng.standard_normal(c)).astype(np.float32)

    def res(pre, ci, co):
        norm(f'{pre}.norm1', ci)
        conv(f'{pre}.conv1.conv', ci, co)
        norm(f'{pre}.norm2', co)
        conv(f'{pre}.conv2.conv', co, co)
        if ci != co:
            conv(f'{pre}.conv_shortcut.conv', ci, co, k=(1, 1, 1))

    ch = cfg.block_out_channels
    top = ch[-1]
    d = 'decoder'
    conv(f'{d}.conv_in.conv', cfg.latent_channels, top)
    res(f'{d}.mid_block.resnets.0', top, top)
    res(f'{d}.mid_block.resnets.1', top, top)
    at = f'{d}.mid_block.attentions.0'
    norm(f'{at}.group_norm', top)
    for nm in ('to_q', 'to_k', 'to_v', 'to_out.0'):
        sd[f'{at}.{nm}.weight'] = (rng.standard_normal((top, top))
                                   * top ** -0.5).astype(np.float32)
        sd[f'{at}.{nm}.bias'] = (0.1 * rng.standard_normal(top)).astype(
            np.float32)
    rev = list(reversed(ch))
    prev = rev[0]
    for i, out in enumerate(rev):
        for j in range(cfg.layers_per_block + 1):
            res(f'{d}.up_blocks.{i}.resnets.{j}', prev if j == 0 else out,
                out)
        if i < 3 or 1 <= i < len(ch) - 1:
            conv(f'{d}.up_blocks.{i}.upsamplers.0.conv.conv', out, out)
        prev = out
    norm(f'{d}.conv_norm_out', ch[0])
    conv(f'{d}.conv_out.conv', ch[0], 3)
    sd['encoder.conv_in.conv.weight'] = np.zeros((1,), np.float32)
    return sd


def wan_state_dict(cfg, rng):
    """A WanVAE_ state dict (decoder.* and conv2.*)."""
    sd = {}

    def conv3(name, ci, co, k=(3, 3, 3)):
        sd[f'{name}.weight'] = torch_conv(rng, co, ci, k)
        sd[f'{name}.bias'] = (rng.standard_normal(co) * .01).astype(
            np.float32)

    def gam(name, c, dims=3):
        sd[f'{name}.gamma'] = (1 + 0.1 * rng.standard_normal(
            (c,) + (1,) * dims)).astype(np.float32)

    def res(pre, ci, co):
        gam(f'{pre}.residual.0', ci)
        conv3(f'{pre}.residual.2', ci, co)
        gam(f'{pre}.residual.3', co)
        conv3(f'{pre}.residual.6', co, co)
        if ci != co:
            conv3(f'{pre}.shortcut', ci, co, k=(1, 1, 1))

    dims = cfg.dims
    d0 = dims[0]
    d = 'decoder'
    conv3('conv2', cfg.z_dim, cfg.z_dim, k=(1, 1, 1))
    conv3(f'{d}.conv1', cfg.z_dim, d0)
    res(f'{d}.middle.0', d0, d0)
    gam(f'{d}.middle.1.norm', d0, dims=2)
    conv3(f'{d}.middle.1.to_qkv', d0, 3 * d0, k=(1, 1))
    conv3(f'{d}.middle.1.proj', d0, d0, k=(1, 1))
    res(f'{d}.middle.2', d0, d0)
    k = 0
    n = len(cfg.dim_mult)
    for i, (ci, co) in enumerate(zip(dims[:-1], dims[1:])):
        if i >= 1:
            ci //= 2
        for j in range(cfg.num_res_blocks + 1):
            res(f'{d}.upsamples.{k}', ci if j == 0 else co, co)
            k += 1
        if i != n - 1:
            conv3(f'{d}.upsamples.{k}.resample.1', co, co // 2, k=(3, 3))
            if cfg.temporal_upsample[i]:
                conv3(f'{d}.upsamples.{k}.time_conv', co, co * 2,
                      k=(3, 1, 1))
            k += 1
    gam(f'{d}.head.0', dims[-1])
    conv3(f'{d}.head.2', dims[-1], 3)
    return sd


def test_hunyuan_vae_loaders_match_reference_loaders(tmp_path):
    """The diffusers layout, as a dict and as a .safetensors file: the
    port's tree (weights as stored) decodes like the reference loader's
    tree (transposed channels-last)."""
    import safetensors.numpy
    jcfg, tcfg = jvv.HyVaeConfig(**HY_KW), tvv.HyVaeConfig(**HY_KW)
    sd = hunyuan_state_dict(jcfg, np.random.default_rng(25))
    f = str(tmp_path / 'vae.safetensors')
    safetensors.numpy.save_file(sd, f)
    z = randn(26, 1, 4, 3, 4, 4)
    for jp, tp in ((jvv.load_hunyuan_vae_decoder(sd, jcfg),
                    tvv.load_hunyuan_vae_decoder(sd, tcfg, device='cpu')),
                   (jvv.load_hunyuan_vae_safetensors(f, jcfg),
                    tvv.load_hunyuan_vae_safetensors(f, tcfg,
                                                     device='cpu'))):
        np.testing.assert_array_equal(tp['conv_in_w'].numpy(),
                                      sd['decoder.conv_in.conv.weight'])
        np.testing.assert_allclose(
            tvv.hunyuan_vae_decode(tp, t(z), tcfg).numpy(),
            np.asarray(J_HY_DECODE(jp, jnp.asarray(z), jcfg)),
            **TOL)


@pytest.mark.parametrize('ext', ['.pth', '.safetensors'])
def test_wan_vae_loaders_match_reference_loaders(tmp_path, ext):
    jcfg, tcfg = jvv.WanVaeConfig(**WAN_KW), tvv.WanVaeConfig(**WAN_KW)
    sd = wan_state_dict(jcfg, np.random.default_rng(27))
    f = str(tmp_path / f'Wan2.1_VAE{ext}')
    if ext == '.pth':
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, f)
    else:
        import safetensors.numpy
        safetensors.numpy.save_file(sd, f)
    jp, tp = jvv.load_wan_vae(f, jcfg), tvv.load_wan_vae(f, tcfg,
                                                         device='cpu')
    np.testing.assert_array_equal(tp['up'][1]['upsample']['time_w'].numpy(),
                                  sd['decoder.upsamples.5.time_conv.weight'])
    assert tp['mid_attn']['norm_g'].shape == (tcfg.dims[0],)
    z = randn(28, 1, 4, 3, 4, 4)
    np.testing.assert_allclose(
        tvv.wan_vae_decode(tp, t(z), tcfg).numpy(),
        np.asarray(J_WAN_DECODE(jp, jnp.asarray(z), jcfg)), **TOL)


def test_decoders_need_a_gpu_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    gen = torch.Generator()
    for call in (lambda: tae.init_decoder_params(gen),
                 lambda: tvv.init_hunyuan_vae_decoder(gen),
                 lambda: tvv.init_wan_vae_decoder(gen),
                 lambda: tvv.load_hunyuan_vae_decoder({}),
                 lambda: tvv.load_wan_vae_decoder({}),
                 lambda: tvv.hunyuan_vae_params_from_jax({}),
                 lambda: tvv.wan_vae_params_from_jax({})):
        with pytest.raises(RuntimeError, match='CUDA'):
            call()
