"""The video models' prompt wrappers of the port, HunyuanTextEncoders and
WanTextEncoder (chipmunk_torch/models/video_encoders.py), against the
reference's wrappers (chipmunk_tpu/models/video_encoders.py) on the same
seed-made weights and the same stand-in tokenizers: the reference runs
transformers' FlaxLlamaModel and FlaxCLIPTextModel (tiny configs, theta
10,000, where the port and the Flax model agree) and its UMT5; the port
runs llama.py, flux_encoders.py's CLIP and its UMT5 on the weights
carried across.  CLIP's pooling is held in both of the Flax model's
branches (eos_token_id 2: the largest id; another id: its first
occurrence).  Then the holders read local directories (config.json,
safetensors, a tokenizer saved with transformers), and refuse to run
without a tokenizer.

Tolerances as in test_torch_encoders.py: float32 1e-5 elementwise;
bfloat16 a mean relative difference of 2e-2 and a largest difference of
2e-2 of the largest magnitude.
"""
import json
import os

os.environ.setdefault('USE_TF', '0')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from chipmunk_tpu.models import video_encoders as jve  # noqa: E402
from chipmunk_torch.models import flux_encoders as tfe  # noqa: E402
from chipmunk_torch.models import llama as tl  # noqa: E402
from chipmunk_torch.models import params_from_jax  # noqa: E402
from chipmunk_torch.models import video_encoders as tve  # noqa: E402
from chipmunk_torch.utils.safetensors_io import save_file  # noqa: E402
from test_torch_encoders import StandInTokenizer, close  # noqa: E402
from test_torch_llama import flax_model, perturbed  # noqa: E402

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = 2e-2
DTYPES = {'float32': (jnp.float32, torch.float32, F32),
          'bfloat16': (jnp.bfloat16, torch.bfloat16, BF16)}
PROMPTS = ['a red fox runs', 'the quick brown dog jumps over it']
CLIP_KW = dict(vocab_size=64, hidden_size=32, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=2,
               max_position_embeddings=77, layer_norm_eps=1e-5)
TXT = 16                      # UMT5 rows
HY_TXT = 48                   # prompt rows after the template's 95
UMT5_KW = dict(vocab_size=64, dim=32, dim_attn=32, dim_ffn=64, num_heads=4,
               num_layers=2)


class TemplateTokenizer(StandInTokenizer):
    """The LLM's stand-in: the video template's instruction prefix (the
    text before its ``{}``) as VIDEO_CROP_START ids, as LLaMA-3's
    tokenizer cuts it, then one id per character of the rest."""

    PREFIX = tve.PROMPT_TEMPLATE_ENCODE_VIDEO.split('{}')[0]

    def __call__(self, texts, max_length, **kw):
        out = super().__call__([t[len(self.PREFIX):] for t in texts],
                               max_length - tve.VIDEO_CROP_START, **kw)
        head = np.arange(tve.VIDEO_CROP_START)[None] % (self.vocab - 1)
        B = len(texts)
        return {'input_ids': np.concatenate(
                    [np.repeat(head, B, 0), out['input_ids']], 1),
                'attention_mask': np.concatenate(
                    [np.ones((B, tve.VIDEO_CROP_START), np.int64),
                     out['attention_mask']], 1)}


def flax_clip(eos, jdt, seed=2):
    from transformers import CLIPTextConfig, FlaxCLIPTextModel
    cfg = CLIPTextConfig(**CLIP_KW, hidden_act='quick_gelu',
                         eos_token_id=eos)
    m = FlaxCLIPTextModel(cfg, dtype=jdt, seed=seed)
    m.params = perturbed(jax.tree_util.tree_map(np.asarray, m.params), seed)
    return m


def clip_from_flax(params, tdt):
    """A FlaxCLIPTextModel tree as the port's clip_text_encode tree."""
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(tdt)
    tm = params['text_model']
    blocks = []
    for i in range(len(tm['encoder']['layers'])):
        lf = tm['encoder']['layers'][str(i)]
        b = {'ln1_w': t(lf['layer_norm1']['scale']),
             'ln1_b': t(lf['layer_norm1']['bias']),
             'ln2_w': t(lf['layer_norm2']['scale']),
             'ln2_b': t(lf['layer_norm2']['bias'])}
        for n, (mod, proj) in (('q', ('self_attn', 'q_proj')),
                               ('k', ('self_attn', 'k_proj')),
                               ('v', ('self_attn', 'v_proj')),
                               ('o', ('self_attn', 'out_proj')),
                               ('fc1', ('mlp', 'fc1')),
                               ('fc2', ('mlp', 'fc2'))):
            b[n] = t(lf[mod][proj]['kernel'])
            b[n + '_b'] = t(lf[mod][proj]['bias'])
        blocks.append(b)
    emb = tm['embeddings']
    return {'token_embedding': t(emb['token_embedding']['embedding']),
            'pos_embedding': t(emb['position_embedding']['embedding']),
            'blocks': blocks,
            'lnf_w': t(tm['final_layer_norm']['scale']),
            'lnf_b': t(tm['final_layer_norm']['bias'])}


def port_clip_config(eos, tdt):
    return tfe.ClipTextConfig(vocab_size=64, width=32, num_heads=2,
                              num_layers=2, ctx_len=77, eos_token_id=eos,
                              dtype=tdt)


# eos 2: pools at the largest id (the EOT, which also pads); eos 40: pools
# at its first occurrence, the prompt's ids running past it
CLIP_CASES = {'eos 2': (2, StandInTokenizer(64, 63, 63)),
              'eos 40': (40, StandInTokenizer(64, 0, 40))}


@pytest.mark.parametrize('eos', list(CLIP_CASES))
@pytest.mark.parametrize('dtype', list(DTYPES))
def test_hunyuan_text_encoders_match_reference(dtype, eos):
    jdt, tdt, tol = DTYPES[dtype]
    eos_id, clip_tok = CLIP_CASES[eos]
    llm = flax_model(10000.0, jdt, seed=1, num_hidden_layers=3)
    clip = flax_clip(eos_id, jdt)
    llm_tok = TemplateTokenizer(96, 0)
    kw = dict(llm_path='llm', clip_path='clip',
              max_length=tve.VIDEO_CROP_START + HY_TXT)
    jh = jve.HunyuanTextEncoders(**kw, dtype=jdt)
    jh._llm, jh._llm_tok, jh._clip, jh._clip_tok = llm, llm_tok, clip, \
        clip_tok
    th = tve.HunyuanTextEncoders(**kw, dtype=tdt, device='cpu')
    lcfg = tl.LlamaConfig(vocab_size=96, hidden_size=64,
                          intermediate_size=112, num_hidden_layers=3,
                          num_attention_heads=4, num_key_value_heads=2,
                          rope_theta=10000.0, dtype=tdt)
    th._llm = (tl.llama_params_from_flax(llm.params, tdt, 'cpu'), lcfg)
    th._clip = (clip_from_flax(clip.params, tdt),
                port_clip_config(eos_id, tdt))
    th._llm_tok, th._clip_tok = llm_tok, clip_tok
    rtxt, rmask, ry = jh.embed(PROMPTS)
    gtxt, gmask, gy = th.embed(PROMPTS)
    assert gtxt.shape == (2, HY_TXT, 64) and gy.shape == (2, 32)
    assert gmask.dtype == torch.int32
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(rmask))
    assert gmask[:, 0].all() and not gmask[:, -1].any()
    close(gtxt, rtxt, tol)
    close(gy, ry, tol)
    # the pooled row is the one the branch names
    ids = clip_tok(PROMPTS, max_length=77, padding='max_length',
                   truncation=True, return_tensors='np')['input_ids']
    at = (ids.argmax(-1) if eos_id == 2
          else (ids == eos_id).argmax(-1))
    if eos_id != 2:
        assert (at != ids.argmax(-1)).all()
    hidden, pooled = tfe.clip_text_encode(th._clip[0], torch.from_numpy(ids),
                                          th._clip[1])
    assert torch.equal(pooled, hidden[torch.arange(2), torch.from_numpy(at)])
    th.release()
    assert th._llm is None and th._clip is None


@pytest.mark.parametrize('dtype', list(DTYPES))
def test_wan_text_encoder_matches_reference(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    jcfg = jve.UMT5Config(**UMT5_KW, dtype=jdt)
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jdt),
        perturbed(jve.init_umt5_params(jax.random.PRNGKey(3), jcfg), 3))
    tok = StandInTokenizer(64, 0, 1)
    jw = jve.WanTextEncoder('umt5', 'tok', text_len=TXT, dtype=jdt)
    jw._params, jw._tok, jw._cfg = jp, tok, jcfg
    tw = tve.WanTextEncoder('umt5', 'tok', text_len=TXT, dtype=tdt,
                            device='cpu')
    tw._params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                 device='cpu')
    tw._tok, tw._cfg = tok, tve.UMT5Config(**UMT5_KW, dtype=tdt)
    assert tw.available()
    ref = jw.embed(['a cat', 'a much longer prompt than that'])
    got = tw.embed(['a cat', 'a much longer prompt than that'])
    assert got.shape == (2, TXT, 32) and got.dtype == tdt
    assert not got[0, 6:].any() and got[0, :6].abs().sum(-1).all()
    close(got, ref, tol)
    tw.release()
    assert tw._params is None


# ------------------------------------------------ local directories

def write_tokenizer(path, words, pad='[PAD]', eos=None):
    """A word-level tokenizer saved with transformers (nothing
    downloaded): ids 0 [PAD], 1 [UNK], then ``words``; ``eos`` appended to
    every text and, where ``pad`` is it, also the pad (CLIP's way)."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors
    from transformers import PreTrainedTokenizerFast
    vocab = {'[PAD]': 0, '[UNK]': 1}
    for w in words:
        vocab.setdefault(w, len(vocab))
    if eos is not None:
        vocab[eos] = len(vocab)
    tok = Tokenizer(models.WordLevel(vocab, unk_token='[UNK]'))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    if eos is not None:
        tok.post_processor = processors.TemplateProcessing(
            single=f'$A {eos}', special_tokens=[(eos, vocab[eos])])
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token=pad,
                            unk_token='[UNK]').save_pretrained(str(path))
    return len(vocab)


WORDS = ('a red fox the quick brown dog jumps over cat runs video '
         'describe').split()


def write_llm_dir(path, hidden=64, layers=3, heads=4, kv=2, ffn=112,
                  seed=0, dtype=torch.float32):
    """An HF LLaMA causal-LM directory: config.json (theta 500,000), one
    safetensors file under ``model.`` with an lm_head, a tokenizer."""
    os.makedirs(path, exist_ok=True)
    vocab = write_tokenizer(path, WORDS)
    cfg = tl.LlamaConfig(vocab_size=vocab, hidden_size=hidden,
                         num_hidden_layers=layers, num_attention_heads=heads,
                         num_key_value_heads=kv, intermediate_size=ffn)
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump({'architectures': ['LlamaForCausalLM'],
                   'model_type': 'llama', 'hidden_act': 'silu',
                   'rope_scaling': None, 'vocab_size': vocab,
                   'hidden_size': hidden, 'num_hidden_layers': layers,
                   'num_attention_heads': heads, 'num_key_value_heads': kv,
                   'intermediate_size': ffn, 'rms_norm_eps': 1e-5,
                   'rope_theta': 500000.0}, f)
    p = tl.init_llama_params(torch.Generator().manual_seed(seed), cfg,
                             device='cpu')
    sd = {'model.embed_tokens.weight': p['embed'],
          'model.norm.weight': p['norm'] + 0.1,
          'lm_head.weight': p['embed'].clone()}
    for i, lp in enumerate(p['layers']):
        pre = f'model.layers.{i}.'
        sd[pre + 'input_layernorm.weight'] = lp['ln1'] * 1.1
        sd[pre + 'post_attention_layernorm.weight'] = lp['ln2'] * 0.9
        for n, hf in tl.HF_NAMES.items():
            sd[f'{pre}{hf}.weight'] = lp[n].t().contiguous()
    save_file({k: v.to(dtype) for k, v in sd.items()},
              os.path.join(path, 'model.safetensors'))
    return cfg


def write_clip_dir(path, width=32, layers=2, heads=2, seed=0):
    """An HF CLIP text directory: config.json (eos_token_id the EOT id,
    which is also the pad), text_model.* safetensors, a tokenizer."""
    os.makedirs(path, exist_ok=True)
    eot = '<|endoftext|>'
    vocab = write_tokenizer(path, WORDS, pad=eot, eos=eot)
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump({'model_type': 'clip_text_model', 'vocab_size': vocab,
                   'hidden_size': width, 'num_attention_heads': heads,
                   'num_hidden_layers': layers, 'intermediate_size': 4 * width,
                   'max_position_embeddings': 77, 'layer_norm_eps': 1e-5,
                   'hidden_act': 'quick_gelu', 'eos_token_id': vocab - 1}, f)
    cfg = tfe.ClipTextConfig(vocab_size=vocab, width=width, num_heads=heads,
                             num_layers=layers, eos_token_id=vocab - 1)
    p = tfe.init_clip_params(torch.Generator().manual_seed(seed), cfg,
                             device='cpu')
    sd = {'text_model.embeddings.token_embedding.weight':
          p['token_embedding'] * 10,
          'text_model.embeddings.position_embedding.weight':
          p['pos_embedding'],
          'text_model.final_layer_norm.weight': p['lnf_w'] * 1.1,
          'text_model.final_layer_norm.bias': p['lnf_b'] + 0.1}
    for i, b in enumerate(p['blocks']):
        pre = f'text_model.encoder.layers.{i}.'
        for n, src in (('q', 'self_attn.q_proj'), ('k', 'self_attn.k_proj'),
                       ('v', 'self_attn.v_proj'),
                       ('o', 'self_attn.out_proj'), ('fc1', 'mlp.fc1'),
                       ('fc2', 'mlp.fc2')):
            sd[f'{pre}{src}.weight'] = b[n].t().contiguous()
            sd[f'{pre}{src}.bias'] = b[n + '_b'] + 0.01
        for n in ('1', '2'):
            sd[f'{pre}layer_norm{n}.weight'] = b[f'ln{n}_w'] * 0.9
            sd[f'{pre}layer_norm{n}.bias'] = b[f'ln{n}_b'] - 0.1
    save_file(sd, os.path.join(path, 'model.safetensors'))
    return cfg


def write_umt5(path, tok_dir, dim=32, seed=0):
    """A UMT5 encoder .safetensors in the reference's key layout
    (geometry UMT5_KW with ``dim``) and a tokenizer directory."""
    vocab = write_tokenizer(tok_dir, WORDS, eos='</s>')
    cfg = tve.UMT5Config(**dict(UMT5_KW, vocab_size=vocab, dim=dim))
    p = tve.init_umt5_params(torch.Generator().manual_seed(seed), cfg,
                             device='cpu')
    sd = {'token_embedding.weight': p['token_embedding'],
          'norm.weight': p['norm'] * 1.1}
    names = {'q': 'attn.q', 'k': 'attn.k', 'v': 'attn.v', 'o': 'attn.o',
             'gate': 'ffn.gate.0', 'fc1': 'ffn.fc1', 'fc2': 'ffn.fc2'}
    for i, b in enumerate(p['blocks']):
        sd[f'blocks.{i}.norm1.weight'] = b['norm1'] * 0.9
        sd[f'blocks.{i}.norm2.weight'] = b['norm2'] * 1.1
        sd[f'blocks.{i}.pos_embedding.embedding.weight'] = b['pos_emb']
        for n, src in names.items():
            sd[f'blocks.{i}.{src}.weight'] = b[n].t().contiguous()
    save_file(sd, str(path))
    return cfg


def test_holders_read_local_directories(tmp_path):
    """The holders' own loading (config.json geometry, safetensors,
    AutoTokenizer) gives what the same weights and tokenizers set on a
    holder give; the UMT5 geometry is the checkpoint's."""
    from transformers import AutoTokenizer
    lcfg = write_llm_dir(tmp_path / 'llm')
    ccfg = write_clip_dir(tmp_path / 'clip')
    h = tve.HunyuanTextEncoders(str(tmp_path / 'llm'), str(tmp_path / 'clip'),
                                max_length=tve.VIDEO_CROP_START + TXT,
                                dtype=torch.float32, device='cpu')
    txt, mask, y = h.embed(PROMPTS)
    assert h._llm[1].rope_theta == 500000.0
    assert h._clip[1] == ccfg
    assert txt.shape == (2, TXT, 64) and y.shape == (2, 32)
    same = tve.HunyuanTextEncoders(max_length=h.max_length,
                                   dtype=torch.float32, device='cpu')
    same._llm = (tl.load_llama_safetensors(str(tmp_path / 'llm'),
                                           device='cpu'),
                 tl.dataclasses.replace(lcfg, rms_norm_eps=1e-5,
                                        rope_theta=500000.0))
    same._clip = (tfe.load_clip_safetensors(str(tmp_path / 'clip'), ccfg,
                                            'cpu'), ccfg)
    same._llm_tok = AutoTokenizer.from_pretrained(str(tmp_path / 'llm'))
    same._clip_tok = AutoTokenizer.from_pretrained(str(tmp_path / 'clip'))
    for a, b in zip((txt, mask, y), same.embed(PROMPTS)):
        assert torch.equal(a, b)
    ucfg = write_umt5(tmp_path / 'umt5.safetensors', tmp_path / 'tok')
    w = tve.WanTextEncoder(str(tmp_path / 'umt5.safetensors'),
                           str(tmp_path / 'tok'), text_len=TXT,
                           dtype=torch.float32, device='cpu')
    ctx = w.embed(['a red fox', ''])
    assert w._cfg == ucfg and ctx.shape == (2, TXT, 32)
    assert ctx[0, :4].abs().sum(-1).all() and not ctx[0, 4:].any()


def test_holders_need_their_tokenizers_and_weights(monkeypatch):
    """No fallback: a holder without a path, or without the tokenizer
    package, raises; nothing encodes to zeros."""
    with pytest.raises(ValueError, match='llm_path'):
        tve.HunyuanTextEncoders(device='cpu').embed(['a cat'])
    w = tve.WanTextEncoder(device='cpu')
    w._params = {}
    with pytest.raises(ValueError, match='tokenizer'):
        w.embed(['a cat'])
    monkeypatch.setitem(__import__('sys').modules, 'transformers', None)
    with pytest.raises(ImportError, match='transformers'):
        tve.load_tokenizer('some/dir', 'WanTextEncoder')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for holder in (tve.HunyuanTextEncoders, tve.WanTextEncoder):
        with pytest.raises(RuntimeError, match='CUDA'):
            holder()
