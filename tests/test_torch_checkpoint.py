"""chipmunk_torch/utils/checkpoint.py against chipmunk_tpu/utils/checkpoint.py:
the same keys and bytes for a structurally equal tree, the load rules,
the reference's stacked FLUX and Wan states carried into the port, and a
tiny FLUX loop resumed in the port from a snapshot that the reference
wrote, held to the reference's own continued loop."""
import collections
import zipfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from chipmunk_tpu.config import config_from_dict as j_config_from_dict
from chipmunk_tpu.models import FluxModelConfig as JModel
from chipmunk_tpu.models import FluxSparse as JSparse
from chipmunk_tpu.models import init_flux_params as j_init_flux_params
from chipmunk_tpu.models.flux import FluxStep as JStep
from chipmunk_tpu.models.flux import flux_forward as j_flux_forward
from chipmunk_tpu.models.sampling import FluxSampler as JSampler
from chipmunk_tpu.models.wan import WanModel as JWan
from chipmunk_tpu.models.wan import WanModelConfig as JWanConfig
from chipmunk_tpu.utils import checkpoint as jck
from chipmunk_torch.config import config_from_dict
from chipmunk_torch.models import (FluxModelConfig, FluxSampler, FluxSparse,
                                   FluxStep, WanModel, WanModelConfig,
                                   flux_forward, params_from_jax)
from chipmunk_torch.utils import load_pytree, save_pytree
from chipmunk_torch.utils.checkpoint import (flux_state_from_jax,
                                             wan_state_from_jax)
from chipmunk_torch.utils.quant import QTensor

# the continued loop: float32 compute, bf16 and fp8 caches
LOOP_TOL = dict(atol=1e-3, rtol=1e-3)
Pair = collections.namedtuple('Pair', 'a b')

H_IMG, W_IMG, TXT = 16, 24, 128
SEQ = TXT + H_IMG * W_IMG
TINY = dict(in_channels=16, vec_in_dim=32, context_in_dim=32, hidden_size=128,
            num_heads=2, mlp_ratio=4.0, depth=2, depth_single_blocks=2,
            axes_dim=(16, 24, 24), guidance_embed=False, txt_len=TXT)
CACHES = {'attn': {'top_keys': 0.4, 'kv_block': 32, 'counts_multiple_of': 32,
                   'first_n_dense_layers': 1, 'should_compress_indices': False,
                   'random_keys': 0.0, 'out_cache_dtype': 'float8_e4m3fn'},
          'mlp': {'top_keys': 0.5, 'neuron_block': 128, 'bm': 128,
                  'counts_multiple_of': 128, 'first_n_dense_layers': 1,
                  'random_keys': 0.0, 'act_cache_dtype': 'bfloat16',
                  'out_cache_dtype': 'bfloat16'}}
BEFORE = [(0, True, True, False, False), (1, True, False, True, True),
          (2, False, False, False, True)]
AFTER = [(3, False, False, False, False), (4, False, False, False, True),
         (5, True, True, False, False)]


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """The tiny models' tensors are small enough that torch's intra-op
    threads only contend with the other test processes' (the port's
    resume took 200x its time alone under a loaded CPU); the runs held
    bit for bit to each other share the setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_tree():
    """fp32, int, bf16 and fp8 leaves; None entries; a NamedTuple; a
    QTensor."""
    g = torch.Generator().manual_seed(0)
    return {'f32': torch.randn(3, 4, generator=g),
            'ints': [torch.arange(5, dtype=torch.int32), None,
                     torch.tensor(7, dtype=torch.int64)],
            'bf16': torch.randn(2, 3, generator=g).bfloat16(),
            'fp8': (torch.randn(6, generator=g) * 8).to(torch.float8_e4m3fn),
            'nt': Pair(torch.ones(2, dtype=torch.uint8), None),
            'qt': QTensor(torch.arange(8, dtype=torch.int8).reshape(2, 4),
                          torch.ones(2, 1), -1)}


def jax_twin(tree):
    """The same tree as the reference holds it (ml_dtypes for bf16 and
    fp8; the reference's QTensor)."""
    from chipmunk_tpu.utils.quant import QTensor as JQ

    def leaf(x):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        if x.dtype == torch.float8_e4m3fn:
            return x.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn)
        return x.numpy()

    def conv(t):
        if t is None:
            return None
        if isinstance(t, QTensor):
            return JQ(q=leaf(t.q), scale=leaf(t.scale), pack_axis=t.pack_axis)
        if isinstance(t, Pair):
            return Pair(*(conv(v) for v in t))
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, list):
            return [conv(v) for v in t]
        return leaf(t)

    return conv(tree)


def like_of(tree):
    """``tree`` with every tensor zeroed (same shapes and dtypes)."""
    if tree is None:
        return None
    if isinstance(tree, QTensor):
        return QTensor(like_of(tree.q), like_of(tree.scale), tree.pack_axis)
    if isinstance(tree, Pair):
        return Pair(*(like_of(v) for v in tree))
    if isinstance(tree, dict):
        return {k: like_of(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [like_of(v) for v in tree]
    return torch.zeros_like(tree)


def bits(t):
    """``t`` as integers of its item size where numpy has no type for it
    (bf16, fp8)."""
    size = t.element_size()
    return t.view(torch.uint8) if size == 1 else \
        t.view(torch.int16) if size == 2 else t


def assert_tree_equal(a, b):
    if isinstance(a, QTensor):
        assert a.pack_axis == b.pack_axis
        a, b = (a.q, a.scale), (b.q, b.scale)
    if a is None:
        assert b is None
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(bits(a), bits(b))
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            assert_tree_equal(a[k], b[k])
    else:
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_tree_equal(x, y)


def members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


@pytest.mark.parametrize('suffix', ['.npz', ''])
def test_round_trip_every_leaf_kind(tmp_path, suffix):
    """Saved and loaded bit for bit; a name without .npz gets it, as
    np.savez gives it."""
    tree = port_tree()
    save_pytree(str(tmp_path / f'ck{suffix}'), tree)
    got = load_pytree(str(tmp_path / 'ck.npz'), like_of(tree))
    assert_tree_equal(got, tree)


def test_keys_and_bytes_equal_the_reference(tmp_path):
    """A structurally equal tree writes the reference's keys, in its
    order, each member byte for byte (bf16 as <V2, fp8 as <V1)."""
    tree = port_tree()
    save_pytree(str(tmp_path / 'port.npz'), tree)
    jck.save_pytree(str(tmp_path / 'ref.npz'), jax_twin(tree))
    mine, ref = members(tmp_path / 'port.npz'), members(tmp_path / 'ref.npz')
    assert list(mine) == list(ref)
    for name in ref:
        assert mine[name] == ref[name], name
    assert "path:['bf16'].npy" in ref and "path:['nt'].a.npy" in ref
    assert "path:['qt'].q.npy" in ref and "path:['ints'][2].npy" in ref


def test_reads_what_the_reference_wrote(tmp_path):
    """The reference's bf16 and fp8 leaves (raw void items in the file)
    read back as the port tree's dtypes."""
    tree = port_tree()
    jck.save_pytree(str(tmp_path / 'ref.npz'), jax_twin(tree))
    assert_tree_equal(load_pytree(str(tmp_path / 'ref.npz'), like_of(tree)),
                      tree)


def test_a_path_the_file_lacks_keeps_likes_value(tmp_path):
    tree = {'a': torch.arange(3.0)}
    save_pytree(str(tmp_path / 'ck.npz'), tree)
    like = {'a': torch.zeros(3), 'new': Pair(torch.full((2,), 5.0), None)}
    got = load_pytree(str(tmp_path / 'ck.npz'), like)
    assert torch.equal(got['a'], tree['a'])
    assert torch.equal(got['new'].a, like['new'].a)
    assert got['new'].b is None


@pytest.mark.parametrize('case', ['shape', 'dtype', 'raw_size'])
def test_shape_and_dtype_refusals_name_the_path(tmp_path, case):
    tree = {'x': [torch.zeros(2, 3), torch.zeros(4, dtype=torch.bfloat16)]}
    save_pytree(str(tmp_path / 'ck.npz'), tree)
    like = like_of(tree)
    if case == 'shape':
        like['x'][0], where = torch.zeros(3, 2), r"\['x'\]\[0\]"
    elif case == 'dtype':
        like['x'][0], where = torch.zeros(2, 3, dtype=torch.float64), \
            r"\['x'\]\[0\]"
    else:      # a 2-byte raw item read as a 1-byte fp8
        like['x'][1], where = torch.zeros(4, dtype=torch.float8_e4m3fn), \
            r"\['x'\]\[1\]"
    with pytest.raises(ValueError, match=where):
        load_pytree(str(tmp_path / 'ck.npz'), like)


def test_v1_files_load_by_position_strictly(tmp_path):
    a, b = np.arange(4, dtype=np.float32), np.ones((2, 2), np.int32)
    np.savez(tmp_path / 'v1.npz', leaf_0=a, leaf_1=b)
    # leaves in JAX's order: sorted dict keys
    got = load_pytree(str(tmp_path / 'v1.npz'),
                      {'y': torch.zeros(2, 2, dtype=torch.int32),
                       'x': torch.zeros(4)})
    np.testing.assert_array_equal(got['x'].numpy(), a)
    np.testing.assert_array_equal(got['y'].numpy(), b)
    with pytest.raises(ValueError, match='positional'):
        load_pytree(str(tmp_path / 'v1.npz'), {'x': torch.zeros(4)})
    with pytest.raises(ValueError, match='leaf_0'):
        load_pytree(str(tmp_path / 'v1.npz'),
                    {'x': torch.zeros(5), 'y': torch.zeros(2, 2)})


def test_reference_cannot_read_back_its_bf16_and_fp8_leaves(tmp_path):
    """A fault of the reference, recorded: np.savez writes an ml_dtypes
    leaf as a raw void type and the reference's load_pytree hands that to
    jnp.asarray, which refuses it, so the reference cannot resume a
    snapshot of its own bf16 or fp8 caches.  The port reads the same
    file (test_reads_what_the_reference_wrote)."""
    tree = {'a': np.zeros((2, 3), ml_dtypes.bfloat16),
            'f': np.zeros(4, ml_dtypes.float8_e4m3fn)}
    jck.save_pytree(str(tmp_path / 'ref.npz'), tree)
    with pytest.raises(TypeError, match='V2|V1'):
        jck.load_pytree(str(tmp_path / 'ref.npz'), tree)


# ------------------------------------------------ the reference's states

def random_like(tree, seed):
    """Every leaf of a reference state replaced by seeded values of its
    shape and dtype."""
    rng = np.random.default_rng(seed)

    def fill(x):
        x = np.asarray(x)
        if x.dtype.kind in 'iu':
            return rng.integers(0, 7, x.shape).astype(x.dtype)
        return rng.standard_normal(x.shape).astype(np.float32).astype(
            x.dtype)

    return jax.tree_util.tree_map(fill, tree)


def assert_layers_match(port, ref):
    """Each non-None port leaf equals its layer of the stacked reference
    leaf, bit for bit."""
    n = 0
    for name in port._fields:
        for i, layer in enumerate(getattr(port, name)):
            if layer is None:
                continue
            for f in layer._fields:
                v = getattr(layer, f)
                if v is None:
                    continue
                want = np.asarray(getattr(getattr(ref, name), f))[i]
                got = bits(v.cpu())
                assert tuple(v.shape) == want.shape
                np.testing.assert_array_equal(
                    got.numpy(), want.view(got.numpy().dtype))
                n += 1
    return n


@pytest.mark.parametrize('compress', [False, True])
def test_flux_state_from_jax(compress):
    """The stacked reference state as per-layer lists: compressed
    indices keep only ``packed`` (the port's inds/counts None where the
    reference holds placeholders), bf16 and fp8 caches bit for bit."""
    ck = dict(CACHES, attn=dict(CACHES['attn'],
                                should_compress_indices=compress,
                                materialize_indices=False))
    jm = JModel(**TINY, dtype=jnp.float32)
    tm = FluxModelConfig(**TINY, dtype=torch.float32)
    ref = random_like(JSparse.build(j_config_from_dict(ck), jm, SEQ,
                                    use_kernels=False).init_state(jm, 1), 1)
    like = FluxSparse.build(config_from_dict(ck), tm, SEQ).init_state(
        tm, 1, 'cpu')
    got = flux_state_from_jax(ref, like)
    assert (got.double_attn[0].inds is None) == compress
    assert got.double_mlp[0].act_cache.dtype == torch.bfloat16
    assert assert_layers_match(got, ref) == sum(
        sum(v is not None for v in layer)
        for field in like for layer in field if layer is not None)


def test_wan_state_from_jax():
    """Wan's stacked state (the reference's MLP placeholder where its
    MLP is off) as the port's lists, the MLP entries None."""
    kw = dict(latent_t=4, latent_h=8, latent_w=16, in_channels=4,
              patch_size=(1, 2, 2), dim=256, ffn_dim=512, num_heads=4,
              num_layers=2, text_dim=64, txt_len=64, freq_dim=64,
              axes_dim=(16, 24, 24), voxel_shape=(4, 4, 8))
    ck = {'attn': {'top_keys': 0.3, 'kv_block': 32, 'counts_multiple_of': 32,
                   'random_keys': 0.0, 'local_voxels': 1,
                   'out_cache_dtype': 'bfloat16'},
          'mlp': {'is_enabled': False}}
    ref = random_like(JWan(cfg=JWanConfig(**kw, dtype=jnp.float32),
                           ck=j_config_from_dict(ck),
                           use_kernels=False).init_state(1), 2)
    like = WanModel(cfg=WanModelConfig(**kw, dtype=torch.float32),
                    ck=config_from_dict(ck), device='cpu').init_state(1)
    got = wan_state_from_jax(ref, like)
    assert got.mlp == [None, None]
    assert got.attn[1].out_cache.dtype == torch.bfloat16
    assert assert_layers_match(got, ref) > 0


def test_flux_resumes_a_snapshot_the_reference_wrote(tmp_path):
    """The reference runs three steps, saves the latent and its state
    (bf16 and fp8 caches) with its save_pytree and goes on for three
    more; the port reads the file (load_pytree, flux_state_from_jax)
    and runs the same three steps from it."""
    jm = JModel(**TINY, dtype=jnp.float32)
    tm = FluxModelConfig(**TINY, dtype=torch.float32)
    params = j_init_flux_params(jax.random.PRNGKey(0), jm)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              device='cpu')
    jsp = JSparse.build(j_config_from_dict(CACHES), jm, SEQ,
                        use_kernels=False)
    tsp = FluxSparse.build(config_from_dict(CACHES), tm, SEQ)
    jpe = JSampler(cfg=jm, ck=j_config_from_dict(CACHES), sp=jsp,
                   h_img=H_IMG, w_img=W_IMG).rope(1)
    tpe = FluxSampler(cfg=tm, ck=config_from_dict(CACHES), sp=tsp,
                      h_img=H_IMG, w_img=W_IMG, device='cpu').rope(1)
    rng = np.random.default_rng(0)
    img = rng.standard_normal((1, H_IMG * W_IMG, 16)).astype(np.float32)
    txt = rng.standard_normal((1, TXT, 32)).astype(np.float32)
    y = rng.standard_normal((1, 32)).astype(np.float32)

    def jax_steps(x, st, steps):
        for s in steps:
            t = jnp.full((1,), 1.0 - 0.1 * s[0], jnp.float32)
            p, st = j_flux_forward(params, jm, jsp, x, jnp.asarray(txt), t,
                                   jnp.asarray(y), jpe, st, JStep(*s),
                                   key=jax.random.PRNGKey(s[0]))
            x = x - 0.1 * p
        return x, st

    x, st = jax_steps(jnp.asarray(img), jsp.init_state(jm, 1), BEFORE)
    jck.save_pytree(str(tmp_path / 'snap.npz'), {'img': x, 'state': st})
    want, _ = jax_steps(x, st, AFTER)

    snap = load_pytree(str(tmp_path / 'snap.npz'))
    tst = flux_state_from_jax(snap['state'], tsp.init_state(tm, 1, 'cpu'))
    assert tst.single_mlp[1].out_cache.dtype == torch.bfloat16
    assert tst.single_attn[1].out_cache.dtype == torch.float8_e4m3fn
    xt = torch.from_numpy(snap['img'])
    for s in AFTER:
        t = torch.full((1,), 1.0 - 0.1 * s[0])
        p, tst = flux_forward(tparams, tm, tsp, xt, torch.from_numpy(txt),
                              t, torch.from_numpy(y), tpe, tst, FluxStep(*s))
        xt = xt - 0.1 * p
    np.testing.assert_allclose(xt.numpy(), np.asarray(want), **LOOP_TOL)


def test_port_resume_equals_the_straight_loop(tmp_path):
    """The port's own mid-generation snapshot: latent, last prediction,
    state and the generator that draws the random keeps (on, at 0.3),
    saved after a sparse step, loaded into a fresh state and generator;
    the resumed loop equals the straight one bit for bit."""
    ck = dict(CACHES, mlp=dict(CACHES['mlp'], random_keys=0.3))
    tm = FluxModelConfig(**TINY, dtype=torch.float32)
    sp = FluxSparse.build(config_from_dict(ck), tm, SEQ)
    g0 = torch.Generator().manual_seed(0)
    from chipmunk_torch.models import init_flux_params
    params = init_flux_params(g0, tm, device='cpu')
    pe = FluxSampler(cfg=tm, ck=config_from_dict(ck), sp=sp, h_img=H_IMG,
                     w_img=W_IMG, device='cpu').rope(1)
    x0 = torch.randn(1, H_IMG * W_IMG, 16, generator=g0)
    txt, y = torch.randn(1, TXT, 32, generator=g0), torch.randn(1, 32,
                                                                generator=g0)

    def run(x, st, gen, steps, pred=None):
        for s in steps:
            p, st = flux_forward(params, tm, sp, x, txt,
                                 torch.full((1,), 1.0 - 0.1 * s[0]), y, pe,
                                 st, FluxStep(*s), generator=gen)
            pred, x = p, x - 0.1 * p
        return x, st, pred

    want, _, _ = run(x0, sp.init_state(tm, 1, 'cpu'),
                     torch.Generator().manual_seed(5), BEFORE + AFTER)
    gen = torch.Generator().manual_seed(5)
    x, st, pred = run(x0, sp.init_state(tm, 1, 'cpu'), gen, BEFORE)
    save_pytree(str(tmp_path / 'ck.npz'), {
        'img': x, 'pred': pred, 'state': st, 'generator': gen.get_state()})
    fresh = torch.Generator().manual_seed(123)
    ck_ = load_pytree(str(tmp_path / 'ck.npz'), {
        'img': torch.zeros_like(x), 'pred': torch.zeros_like(pred),
        'state': sp.init_state(tm, 1, 'cpu'),
        'generator': fresh.get_state()})
    fresh.set_state(ck_['generator'])
    got, _, _ = run(ck_['img'], ck_['state'], fresh, AFTER)
    assert torch.equal(got, want)
