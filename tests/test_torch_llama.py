"""The port's LLaMA-3 trunk (chipmunk_torch/models/llama.py) against the
model the reference's HunyuanVideo prompt encoder runs, transformers'
FlaxLlamaModel, and against transformers' torch LlamaModel, at a tiny
config with grouped key/value heads (2 layers, hidden 64, 4 heads over 2
key/value heads), a right-padded batch, weights drawn from a seed (every
Flax leaf perturbed, so that a swapped norm weight shows).

FlaxLlamaModel builds its RoPE table with theta 10,000 whatever the
config says; LLaMA-3 uses 500,000.  The port follows the config: it is
held to the Flax model at 10,000 and to the torch LlamaModel (which reads
rope_theta) at 500,000, and one test records the Flax model's
indifference to rope_theta.

Tolerances: float32 1e-5 elementwise (summation order only); bfloat16 a
mean relative difference of 2e-2 and a largest difference of 2e-2 of the
largest magnitude (the sides round their products and norms at different
points).
"""
import json
import os

os.environ.setdefault('USE_TF', '0')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from chipmunk_torch.models import llama as tl  # noqa: E402

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = 2e-2
DTYPES = {'float32': (jnp.float32, torch.float32, F32),
          'bfloat16': (jnp.bfloat16, torch.bfloat16, BF16)}
TINY = dict(vocab_size=96, hidden_size=64, intermediate_size=112,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, rms_norm_eps=1e-5)
VALID = (12, 7)


def hf_config(theta, **kw):
    from transformers import LlamaConfig
    return LlamaConfig(**dict(TINY, **kw), rope_theta=theta,
                       max_position_embeddings=256,
                       attn_implementation='eager')


def port_config(theta, dtype, **kw):
    return tl.LlamaConfig(**dict(TINY, **kw), rope_theta=theta, dtype=dtype)


def batch(seed=0, L=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, TINY['vocab_size'], (2, L))
    mask = (np.arange(L)[None] < np.array(VALID)[:, None]).astype(np.int32)
    return ids, mask


def perturbed(tree, seed):
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.asarray(a, np.float32)
        mag = float(np.abs(a).mean()) or 0.5
        return a + rng.standard_normal(a.shape).astype(np.float32) * 0.1 * mag
    return jax.tree_util.tree_map(leaf, tree)


def flax_model(theta, jdt, seed=0, **kw):
    from transformers import FlaxLlamaModel
    m = FlaxLlamaModel(hf_config(theta, **kw), dtype=jdt, seed=seed)
    m.params = perturbed(jax.tree_util.tree_map(np.asarray, m.params), seed)
    return m


def close(got, ref, tol):
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    if isinstance(tol, dict):
        np.testing.assert_allclose(got, ref, **tol)
        return
    d = np.abs(got - ref)
    assert d.mean() / np.abs(ref).mean() <= tol, d.mean()
    assert d.max() <= tol * np.abs(ref).max(), d.max()


@pytest.mark.parametrize('dtype', list(DTYPES))
def test_trunk_matches_flax_llama_at_theta_10000(dtype):
    """Every hidden state (embeddings, layer 1, the normed layer 2) of a
    padded batch; and a run cut after layer 1 gives the same first two."""
    jdt, tdt, tol = DTYPES[dtype]
    m = flax_model(10000.0, jdt)
    ids, mask = batch()
    ref = m(input_ids=ids, attention_mask=mask,
            output_hidden_states=True).hidden_states
    params = tl.llama_params_from_flax(m.params, tdt, device='cpu')
    cfg = port_config(10000.0, tdt)
    got = tl.llama_hidden_states(params, torch.from_numpy(ids),
                                 torch.from_numpy(mask), cfg)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g.dtype == tdt and g.shape == (2, 12, 64)
        close(g, r, tol)
    cut = tl.llama_hidden_states(params, torch.from_numpy(ids),
                                 torch.from_numpy(mask), cfg, layers=1)
    assert len(cut) == 2
    for a, b in zip(cut, got[:2]):
        assert torch.equal(a, b)


def torch_llama(theta, seed=1, causal_lm=False, **kw):
    from transformers import LlamaForCausalLM, LlamaModel
    torch.manual_seed(seed)
    m = (LlamaForCausalLM if causal_lm else LlamaModel)(
        hf_config(theta, **kw)).eval()
    with torch.no_grad():
        for p in m.parameters():            # norms away from 1
            p.add_(torch.randn_like(p) * 0.1 * p.abs().mean())
    return m


@pytest.mark.parametrize('dtype', list(DTYPES))
def test_trunk_matches_torch_llama_at_theta_500000(dtype, tmp_path):
    """LLaMA-3's theta, against the torch LlamaModel read through
    load_llama_safetensors from its save_pretrained directory."""
    _, tdt, tol = DTYPES[dtype]
    m = torch_llama(500000.0)
    m.save_pretrained(str(tmp_path))
    cfg = tl.read_llama_config(str(tmp_path), tdt)
    assert cfg.rope_theta == 500000.0 and cfg.num_key_value_heads == 2
    params = tl.load_llama_safetensors(str(tmp_path), cfg, device='cpu')
    ids, mask = batch(2)
    with torch.no_grad():
        ref = m.to(tdt)(input_ids=torch.from_numpy(ids),
                        attention_mask=torch.from_numpy(mask).long(),
                        output_hidden_states=True).hidden_states
    got = tl.llama_hidden_states(params, torch.from_numpy(ids),
                                 torch.from_numpy(mask), cfg)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        close(g, r.float(), tol)


def test_flax_llama_ignores_rope_theta():
    """FlaxLlamaModel gives the same hidden states at theta 10,000 and
    500,000 (its table is built with 10,000 either way); the port's differ,
    and at 500,000 it is the torch LlamaModel the port follows."""
    ids, mask = batch(3)
    outs = []
    for theta in (10000.0, 500000.0):
        m = flax_model(theta, jnp.float32, seed=4)
        outs.append(m(input_ids=ids, attention_mask=mask,
                      output_hidden_states=True).hidden_states[-1])
    np.testing.assert_array_equal(np.asarray(outs[0]), np.asarray(outs[1]))
    params = tl.llama_params_from_flax(m.params, device='cpu')
    got = [tl.llama_hidden_states(params, torch.from_numpy(ids),
                                  torch.from_numpy(mask),
                                  port_config(theta, torch.float32))[-1]
           for theta in (10000.0, 500000.0)]
    close(got[0], outs[0], F32)
    assert (got[1] - got[0]).abs().max() > 1e-3


@pytest.mark.parametrize('causal_lm', [True, False])
def test_loader_reads_a_sharded_directory(causal_lm, tmp_path):
    """save_pretrained with small shards: a causal-LM checkpoint (names
    under ``model.``, an ``lm_head`` that is not read) or a bare model;
    each leaf equals the state dict's, linear weights transposed."""
    m = torch_llama(500000.0, seed=5, causal_lm=causal_lm,
                    attention_bias=True)
    m.save_pretrained(str(tmp_path), max_shard_size='40KB')
    shards = [f for f in os.listdir(tmp_path) if f.endswith('.safetensors')]
    assert len(shards) > 2
    with open(tmp_path / 'config.json') as f:
        assert json.load(f)['rope_theta'] == 500000.0
    sd = {k.removeprefix('model.'): v for k, v in m.state_dict().items()}
    cfg = tl.read_llama_config(str(tmp_path))
    assert cfg.attention_bias and cfg.num_hidden_layers == 2
    p = tl.load_llama_safetensors(str(tmp_path), device='cpu')
    assert torch.equal(p['embed'], sd['embed_tokens.weight'])
    assert torch.equal(p['norm'], sd['norm.weight'])
    for i, lp in enumerate(p['layers']):
        assert torch.equal(lp['ln1'], sd[f'layers.{i}.input_layernorm.weight'])
        for n, hf in tl.HF_NAMES.items():
            assert torch.equal(lp[n], sd[f'layers.{i}.{hf}.weight'].t())
        for n in tl.ATTN:
            assert torch.equal(lp[n + '_b'],
                               sd[f'layers.{i}.{tl.HF_NAMES[n]}.bias'])


def test_config_refuses_what_the_trunk_does_not_compute(tmp_path):
    base = dict(TINY, hidden_act='silu')
    for extra, says in (({'rope_scaling': {'rope_type': 'llama3'}},
                         'rope_scaling'),
                        ({'hidden_act': 'gelu'}, 'hidden_act'),
                        ({'head_dim': 32}, 'head_dim')):
        (tmp_path / 'config.json').write_text(json.dumps(dict(base,
                                                              **extra)))
        with pytest.raises(ValueError, match=says):
            tl.read_llama_config(str(tmp_path))
    (tmp_path / 'config.json').write_text(json.dumps(
        {k: v for k, v in base.items() if k != 'num_key_value_heads'}))
    cfg = tl.read_llama_config(str(tmp_path))
    assert cfg.num_key_value_heads == 4 and cfg.rope_theta == 10000.0
    # the defaults are LLaVA-LLaMA-3-8B's: about 7.50B parameters
    full = tl.LlamaConfig()
    n = full.vocab_size * full.hidden_size + full.hidden_size \
        + full.num_hidden_layers * (
            2 * full.hidden_size + 2 * full.hidden_size ** 2
            + 2 * full.hidden_size * full.num_key_value_heads * full.head_dim
            + 3 * full.hidden_size * full.intermediate_size)
    assert full.head_dim == 128 and abs(n / 1e9 - 7.50) < 0.01


def test_init_draws_the_loader_tree(tmp_path):
    m = torch_llama(500000.0, seed=6, attention_bias=True)
    m.save_pretrained(str(tmp_path))
    cfg = tl.read_llama_config(str(tmp_path))
    got = tl.init_llama_params(torch.Generator().manual_seed(0), cfg,
                               device='cpu')
    want = tl.load_llama_safetensors(str(tmp_path), cfg, device='cpu')
    shape = jax.tree_util.tree_map(lambda t: tuple(t.shape), want)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), got) == shape
