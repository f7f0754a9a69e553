"""The chipmunk_torch FLUX prompt encoders (T5-v1.1, CLIP-L text), the
TextEncoders holder, their loaders and HunyuanVideo's skip-layer
selection against chipmunk_tpu on tiny configs, with the same numpy
inputs and the reference's weights, every leaf perturbed with seeded noise
(so that a swapped bias, a mislabelled norm weight or a dropped term
shows), carried over by params_from_jax.

Tolerances: float32 on both sides 1e-5 elementwise (summation order
only); bfloat16 a mean relative difference of 2e-2 and a largest
difference of 2e-2 of the largest magnitude (the two sides round their
matmuls and elementwise chains differently: a few bf16 ulps of the
residual stream, which the final RMS norm passes on to small outputs as
well).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chipmunk_tpu.models import encoders as jenc
from chipmunk_tpu.models import flux_encoders as jfe
from chipmunk_tpu.models import video_encoders as jve
from chipmunk_torch.models import encoders as tenc
from chipmunk_torch.models import flux_encoders as tfe
from chipmunk_torch.models import params_from_jax, select_skip_layer_hidden

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = 2e-2
DTYPES = {'float32': (jnp.float32, torch.float32, F32),
          'bfloat16': (jnp.bfloat16, torch.bfloat16, BF16)}
T5_KW = dict(vocab_size=64, dim=32, d_kv=8, dim_ffn=64, num_heads=4,
             num_layers=2)
CLIP_KW = dict(vocab_size=64, width=32, num_heads=2, num_layers=2,
               ctx_len=16)
EOT = 63


def perturb(tree, seed):
    """Every leaf plus seeded noise of a tenth of its mean magnitude (0.05
    for an all-zero leaf), in the leaf's dtype."""
    rng = np.random.default_rng(seed)

    def leaf(a):
        a32 = np.asarray(a, np.float32)
        mag = float(np.abs(a32).mean()) or 0.5
        noise = rng.standard_normal(a32.shape).astype(np.float32) * 0.1 * mag
        return jnp.asarray(a32 + noise, a.dtype)
    return jax.tree_util.tree_map(leaf, tree)


def to_torch(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                           device='cpu')


def t5_pair(jdt, tdt, seed=0):
    jcfg = jfe.T5Config(**T5_KW, dtype=jdt)
    jp = perturb(jfe.init_t5_params(jax.random.PRNGKey(seed), jcfg), seed)
    return jcfg, jp, tfe.T5Config(**T5_KW, dtype=tdt), to_torch(jp)


def clip_pair(jdt, tdt, seed=1, ctx_len=16):
    kw = dict(CLIP_KW, ctx_len=ctx_len)
    jcfg = jfe.ClipTextConfig(**kw, dtype=jdt)
    jp = perturb(jfe.init_clip_params(jax.random.PRNGKey(seed), jcfg), seed)
    return jcfg, jp, tfe.ClipTextConfig(**kw, dtype=tdt), to_torch(jp)


def clip_ids(rng, B=2, L=16, eot_at=(5, 11)):
    """Random ids below EOT, then EOT at ``eot_at`` and EOT-valued padding
    after it, as CLIP tokenizers pad."""
    ids = rng.integers(0, EOT, (B, L))
    for b, p in enumerate(eot_at):
        ids[b, p:] = EOT
    return ids


def close(got, ref, tol):
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    if isinstance(tol, dict):
        np.testing.assert_allclose(got, ref, **tol)
        return
    d = np.abs(got - ref)
    assert d.mean() / np.abs(ref).mean() <= tol, d.mean()
    assert d.max() <= tol * np.abs(ref).max(), d.max()


@pytest.mark.parametrize('dtype', list(DTYPES))
def test_t5_encode_matches_reference_with_padding(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    jcfg, jp, tcfg, tp = t5_pair(jdt, tdt)
    assert isinstance(tp['blocks'], list) and len(tp['blocks']) == 2
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 64, (2, 24))
    mask = (np.arange(24)[None] < np.array([[24], [9]])).astype(np.int32)
    ref = jfe.t5_encode(jp, jnp.asarray(ids, jnp.int32), jnp.asarray(mask),
                        jcfg)
    got = tfe.t5_encode(tp, torch.from_numpy(ids), torch.from_numpy(mask),
                        tcfg)
    assert got.dtype == tdt and got.shape == (2, 24, 32)
    close(got, ref, tol)


@pytest.mark.parametrize('dtype', list(DTYPES))
def test_clip_text_encode_matches_reference_with_eot_padding(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    jcfg, jp, tcfg, tp = clip_pair(jdt, tdt)
    ids = clip_ids(np.random.default_rng(1))
    rh, rp = jfe.clip_text_encode(jp, jnp.asarray(ids, jnp.int32), jcfg)
    gh, gp = tfe.clip_text_encode(tp, torch.from_numpy(ids), tcfg)
    close(gh, rh, tol)
    close(gp, rp, tol)
    # the pooled row is the first EOT's, not a padding row's
    np.testing.assert_array_equal(gp.float().numpy(),
                                  gh[[0, 1], [5, 11]].float().numpy())


class StandInTokenizer:
    """Ids from the prompt's characters, padded to max_length with
    ``pad`` (CLIP: the EOT id, which also ends each prompt)."""

    def __init__(self, vocab, pad, eot=None):
        self.vocab, self.pad, self.eot = vocab, pad, eot

    def __call__(self, prompts, max_length, padding, truncation,
                 return_tensors):
        assert padding == 'max_length' and truncation
        ids = np.full((len(prompts), max_length), self.pad, np.int64)
        mask = np.zeros((len(prompts), max_length), np.int64)
        for b, p in enumerate(prompts):
            row = [ord(ch) % (self.vocab - 1) for ch in p]
            if self.eot is not None:
                row.append(self.eot)
            row = row[:max_length]
            ids[b, :len(row)], mask[b, :len(row)] = row, 1
        return {'input_ids': ids, 'attention_mask': mask}


@pytest.mark.parametrize('dtype', list(DTYPES))
def test_text_encoders_embed_matches_reference(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    jt5cfg, jt5, tt5cfg, tt5 = t5_pair(jdt, tdt)
    # the holder pads CLIP's ids to its 77 positions
    jccfg, jclip, tccfg, tclip = clip_pair(jdt, tdt, ctx_len=77)
    prompts = ['a red fox', 'the quick brown dog jumps']
    toks = (StandInTokenizer(64, 0), StandInTokenizer(64, EOT, EOT))
    jholder = jenc.TextEncoders(t5_path='t5', clip_path='clip',
                                max_length=24, dtype=jdt, backend='pure')
    jholder._t5_tok, jholder._clip_tok = toks
    jholder._pure = (jt5, jt5cfg, jclip, jccfg)
    tholder = tenc.TextEncoders(t5_path='t5', clip_path='clip',
                                max_length=24, dtype=tdt, device='cpu')
    tholder._t5_tok, tholder._clip_tok = toks
    tholder._pure = (tt5, tt5cfg, tclip, tccfg)
    assert tholder.available()
    rtxt, ry = jholder.embed(prompts)
    gtxt, gy = tholder.embed(prompts)
    assert gtxt.shape == (2, 24, 32) and gy.shape == (2, 32)
    close(gtxt, rtxt, tol)
    close(gy, ry, tol)
    tholder.release()
    assert tholder._pure is None


def test_text_encoders_need_a_gpu_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        tenc.TextEncoders(t5_path='t5', clip_path='clip')
    gen = torch.Generator()
    with pytest.raises(RuntimeError, match='CUDA'):
        tfe.init_t5_params(gen, tfe.T5Config(**T5_KW))
    with pytest.raises(RuntimeError, match='CUDA'):
        tfe.init_clip_params(gen, tfe.ClipTextConfig(**CLIP_KW))


def test_init_params_draw_the_loader_tree():
    """The port's initialisers draw the tree the loaders fill: same keys
    and shapes as the reference's, from a torch.Generator."""
    for jinit, jcfg, tinit, tcfg in (
            (jfe.init_t5_params, jfe.T5Config(**T5_KW), tfe.init_t5_params,
             tfe.T5Config(**T5_KW)),
            (jfe.init_clip_params, jfe.ClipTextConfig(**CLIP_KW),
             tfe.init_clip_params, tfe.ClipTextConfig(**CLIP_KW))):
        ref = to_torch(jinit(jax.random.PRNGKey(0), jcfg))
        got = tinit(torch.Generator().manual_seed(0), tcfg, device='cpu')
        shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), ref)
        assert jax.tree_util.tree_map(lambda t: tuple(t.shape), got) == shapes


def test_select_skip_layer_hidden_matches_reference():
    rng = np.random.default_rng(2)
    hs = [rng.standard_normal((2, 12, 8)).astype(np.float32)
          for _ in range(5)]
    for skip, crop in ((2, 5), (0, 0), (1, 3)):
        ref = jve.select_skip_layer_hidden(tuple(jnp.asarray(h) for h in hs),
                                           skip, crop)
        got = select_skip_layer_hidden(tuple(torch.from_numpy(h)
                                             for h in hs), skip, crop)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ------------------------------------------------------------- loaders

def t5_state_dict(rng):
    d, dk, f, nb = 32, 32, 64, 32
    sd = {'shared.weight': rng.standard_normal((64, d)),
          'encoder.final_layer_norm.weight': 1 + 0.1 * rng.standard_normal(d),
          'encoder.block.0.layer.0.SelfAttention.relative_attention_bias'
          '.weight': rng.standard_normal((nb, 4))}
    for i in range(2):
        p = f'encoder.block.{i}.layer'
        sd[f'{p}.0.layer_norm.weight'] = 1 + 0.1 * rng.standard_normal(d)
        for n in 'qkv':
            sd[f'{p}.0.SelfAttention.{n}.weight'] = \
                rng.standard_normal((dk, d)) * d ** -0.5
        sd[f'{p}.0.SelfAttention.o.weight'] = \
            rng.standard_normal((d, dk)) * dk ** -0.5
        sd[f'{p}.1.layer_norm.weight'] = 1 + 0.1 * rng.standard_normal(d)
        for n in ('wi_0', 'wi_1'):
            sd[f'{p}.1.DenseReluDense.{n}.weight'] = \
                rng.standard_normal((f, d)) * d ** -0.5
        sd[f'{p}.1.DenseReluDense.wo.weight'] = \
            rng.standard_normal((d, f)) * f ** -0.5
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def clip_state_dict(rng, prefix):
    d = 32
    sd = {'embeddings.token_embedding.weight':
          rng.standard_normal((64, d)) * 0.02,
          'embeddings.position_embedding.weight':
          rng.standard_normal((16, d)) * 0.01,
          'final_layer_norm.weight': 1 + 0.1 * rng.standard_normal(d),
          'final_layer_norm.bias': 0.1 * rng.standard_normal(d)}
    for i in range(2):
        p = f'encoder.layers.{i}'
        for n in ('layer_norm1', 'layer_norm2'):
            sd[f'{p}.{n}.weight'] = 1 + 0.1 * rng.standard_normal(d)
            sd[f'{p}.{n}.bias'] = 0.1 * rng.standard_normal(d)
        for n, (o, ii) in (('self_attn.q_proj', (d, d)),
                           ('self_attn.k_proj', (d, d)),
                           ('self_attn.v_proj', (d, d)),
                           ('self_attn.out_proj', (d, d)),
                           ('mlp.fc1', (4 * d, d)), ('mlp.fc2', (d, 4 * d))):
            sd[f'{p}.{n}.weight'] = rng.standard_normal((o, ii)) * ii ** -0.5
            sd[f'{p}.{n}.bias'] = 0.1 * rng.standard_normal(o)
    return {prefix + k: np.asarray(v, np.float32) for k, v in sd.items()}


def test_t5_loader_matches_reference_loader(tmp_path):
    """HF T5EncoderModel layout, one file and a directory of two shards:
    the port's tree equals the reference loader's leaf for leaf and
    encodes alike."""
    import safetensors.numpy
    sd = t5_state_dict(np.random.default_rng(3))
    f = str(tmp_path / 'model.safetensors')
    safetensors.numpy.save_file(sd, f)
    shards = tmp_path / 'shards'
    shards.mkdir()
    ks = sorted(sd)
    for name, part in (('a', ks[:len(ks) // 2]), ('b', ks[len(ks) // 2:])):
        safetensors.numpy.save_file({k: sd[k] for k in part},
                                    str(shards / f'{name}.safetensors'))
    jcfg, tcfg = jfe.T5Config(**T5_KW), tfe.T5Config(**T5_KW)
    ids = np.random.default_rng(4).integers(0, 64, (2, 12))
    mask = (np.arange(12)[None] < np.array([[12], [7]])).astype(np.int32)
    for path in (f, str(shards)):
        ref_tree = to_torch(jfe.load_t5_safetensors(path, jcfg))
        tp = tfe.load_t5_safetensors(path, tcfg, device='cpu')
        for a, b in zip(jax.tree_util.tree_leaves(tp),
                        jax.tree_util.tree_leaves(ref_tree)):
            assert torch.equal(a, b)
        ref = jfe.t5_encode(jfe.load_t5_safetensors(path, jcfg),
                            jnp.asarray(ids, jnp.int32), jnp.asarray(mask),
                            jcfg)
        close(tfe.t5_encode(tp, torch.from_numpy(ids),
                            torch.from_numpy(mask), tcfg), ref, F32)


@pytest.mark.parametrize('prefix', ['text_model.', ''])
def test_clip_loader_matches_reference_loader(tmp_path, prefix):
    import safetensors.numpy
    f = str(tmp_path / 'model.safetensors')
    safetensors.numpy.save_file(
        clip_state_dict(np.random.default_rng(5), prefix), f)
    jcfg, tcfg = jfe.ClipTextConfig(**CLIP_KW), tfe.ClipTextConfig(**CLIP_KW)
    jp = jfe.load_clip_safetensors(f, jcfg)
    tp = tfe.load_clip_safetensors(f, tcfg, device='cpu')
    for a, b in zip(jax.tree_util.tree_leaves(tp),
                    jax.tree_util.tree_leaves(to_torch(jp))):
        assert torch.equal(a, b)
    ids = clip_ids(np.random.default_rng(6), eot_at=(3, 15))
    rh, rp = jfe.clip_text_encode(jp, jnp.asarray(ids, jnp.int32), jcfg)
    gh, gp = tfe.clip_text_encode(tp, torch.from_numpy(ids), tcfg)
    close(gh, rh, F32)
    close(gp, rp, F32)
