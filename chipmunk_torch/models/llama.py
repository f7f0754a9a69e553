"""The LLaMA-3 decoder trunk (torch) that HunyuanVideo's prompt encoder
runs: the counterpart of the ``FlaxLlamaModel`` that
``chipmunk_tpu/models/video_encoders.py``'s ``HunyuanTextEncoders`` builds.

Pre-norm decoder layers: RMS norm, causal self-attention with grouped
key/value heads (each of ``num_key_value_heads`` shared by
``num_attention_heads / num_key_value_heads`` query heads) and rotary
position embeddings (rotate-half layout, angles ``pos / theta^(2i/d)``),
then the SwiGLU feed-forward ``down(up(x) * silu(gate(x)))``.  It is plain
torch, as the reference computes it outside any kernel, with the numerics
of the Flax model:

* RMS norm: ``x / sqrt(mean(x^2) + eps)`` in float32, cast to the
  compute dtype before the weight;
* RoPE applied in float32 and cast back; position ids ``arange(L)``
  (prompts are right-padded);
* scores in float32 (``q / sqrt(head_dim)`` against k), an additive
  causal and padding bias of the compute dtype's lowest value, the
  softmax in float32 and its weights cast to the compute dtype.

``rope_theta`` comes from the checkpoint's ``config.json``: 500,000 for
LLaMA-3-8B and the LLaVA-LLaMA-3-8B that HunyuanVideo ships.  The Flax
model always builds its table with 10,000 (it never reads
``rope_theta``); the two agree at 10,000 only.

Params: ``embed`` [vocab, hidden], ``layers`` a list of per-layer dicts
(linear weights [d_in, d_out]; ``*_b`` biases where
``attention_bias``), ``norm`` [hidden].
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..utils.safetensors_io import load_file

ATTN = ('q', 'k', 'v', 'o')
HF_NAMES = {'q': 'self_attn.q_proj', 'k': 'self_attn.k_proj',
            'v': 'self_attn.v_proj', 'o': 'self_attn.o_proj',
            'gate': 'mlp.gate_proj', 'up': 'mlp.up_proj',
            'down': 'mlp.down_proj'}


@dataclass(frozen=True)
class LlamaConfig:
    """LLaVA-LLaMA-3-8B's language model: vocab 128,256, hidden 4096, 32
    layers, 32 heads over 8 key/value heads (head dim 128), SwiGLU 14,336,
    RMS norm eps 1e-5, RoPE theta 500,000, no biases."""
    vocab_size: int = 128256
    hidden_size: int = 4096
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    intermediate_size: int = 14336
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    attention_bias: bool = False
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


# what a config.json that leaves a key out means (transformers' LlamaConfig
# defaults), so that a file is read as the library reads it
_JSON_DEFAULTS = dict(rms_norm_eps=1e-6, rope_theta=10000.0,
                      attention_bias=False)


def read_llama_config(path: str, dtype: torch.dtype = torch.float32
                      ) -> LlamaConfig:
    """The ``config.json`` of an HF LLaMA checkpoint directory (or the
    file itself) as a LlamaConfig in ``dtype``.  Raises for what this
    trunk does not compute: RoPE scaling, an activation other than SiLU,
    a head dim other than hidden / heads."""
    f = os.path.join(path, 'config.json') if os.path.isdir(path) else path
    with open(f) as fh:
        d = json.load(fh)
    if d.get('rope_scaling'):
        raise ValueError(f'{f}: rope_scaling {d["rope_scaling"]} is not '
                         'computed by this trunk')
    if d.get('hidden_act', 'silu') != 'silu':
        raise ValueError(f'{f}: hidden_act {d["hidden_act"]!r}, not silu')
    kw = {}
    for fld in dataclasses.fields(LlamaConfig):
        if fld.name == 'dtype':
            continue
        if fld.name in d and d[fld.name] is not None:
            kw[fld.name] = d[fld.name]
        elif fld.name in _JSON_DEFAULTS:
            kw[fld.name] = _JSON_DEFAULTS[fld.name]
    kw.setdefault('num_key_value_heads', d['num_attention_heads'])
    cfg = LlamaConfig(**kw, dtype=dtype)
    if d.get('head_dim', cfg.head_dim) != cfg.head_dim:
        raise ValueError(f'{f}: head_dim {d["head_dim"]} is not hidden_size'
                         f' / num_attention_heads = {cfg.head_dim}')
    return cfg


def init_llama_params(generator: torch.Generator, cfg: LlamaConfig,
                      device: DeviceLike = 'cuda') -> Dict:
    """Random weights with the loader's tree, drawn from ``generator``
    (which must live on ``device``): embeddings N(0, 1), linear weights
    N(0, 1 / fan-in), zero biases, unit norms."""
    dev = resolve_device(device)
    d, f = cfg.hidden_size, cfg.intermediate_size
    nq = cfg.num_attention_heads * cfg.head_dim
    nkv = cfg.num_key_value_heads * cfg.head_dim

    def w(shape, scale):
        return (torch.randn(shape, generator=generator, device=dev)
                * scale).to(cfg.dtype)

    def full(n, v):
        return torch.full((n,), v, dtype=cfg.dtype, device=dev)

    shapes = {'q': (d, nq), 'k': (d, nkv), 'v': (d, nkv), 'o': (nq, d),
              'gate': (d, f), 'up': (d, f), 'down': (f, d)}

    def layer():
        p = {'ln1': full(d, 1.0), 'ln2': full(d, 1.0)}
        for n, sh in shapes.items():
            p[n] = w(sh, sh[0] ** -0.5)
        if cfg.attention_bias:
            for n in ATTN:
                p[n + '_b'] = full(shapes[n][1], 0.0)
        return p

    return {'embed': w((cfg.vocab_size, d), 1.0),
            'layers': [layer() for _ in range(cfg.num_hidden_layers)],
            'norm': full(d, 1.0)}


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    h = xf / torch.sqrt(xf.square().mean(-1, keepdim=True) + eps)
    return w * h.to(x.dtype)


def _lin(x: torch.Tensor, p: Dict, n: str) -> torch.Tensor:
    y = x @ p[n]
    b = p.get(n + '_b')
    return y if b is None else y + b


def _rope_tables(L: int, cfg: LlamaConfig, dev: torch.device):
    """(cos, sin) float32 [L, 1, head_dim]: angles formed in float64 and
    rounded to float32, both halves alike (rotate-half layout)."""
    hd = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, hd, 2) / hd))
    ang = np.einsum('i,j->ij', np.arange(L), inv).astype(np.float32)
    ang = torch.from_numpy(np.concatenate([ang, ang], -1)).to(dev)
    return ang.cos()[:, None], ang.sin()[:, None]


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], -1)


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
          ) -> torch.Tensor:
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


@torch.no_grad()
def llama_hidden_states(params: Dict, ids: torch.Tensor, mask: torch.Tensor,
                        cfg: LlamaConfig, layers: Optional[int] = None
                        ) -> List[torch.Tensor]:
    """ids int [B, L], mask {0,1} [B, L] (right padding) -> the hidden
    states in the order of transformers' ``output_hidden_states``: the
    embeddings, then each layer's output, the last one through the final
    norm (``num_hidden_layers + 1`` tensors [B, L, hidden] in cfg.dtype).
    With ``layers`` < num_hidden_layers only that many layers run and the
    list stops at the output of the last of them (no final norm): the
    same values as the full list's first ``layers + 1`` entries."""
    n = cfg.num_hidden_layers if layers is None else layers
    if not 0 <= n <= cfg.num_hidden_layers:
        raise ValueError(f'layers={layers} outside [0, '
                         f'{cfg.num_hidden_layers}]')
    B, L = ids.shape
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    emb = params['embed']
    dev = emb.device
    x = emb[ids.to(dev).long()].to(cfg.dtype)
    cos, sin = _rope_tables(L, cfg, dev)
    pos = torch.arange(L, device=dev)
    keep = (pos[None, :] <= pos[:, None])[None] & (mask.to(dev) > 0)[:, None]
    bias = torch.zeros((B, 1, L, L), dtype=cfg.dtype, device=dev).masked_fill(
        ~keep[:, None], torch.finfo(cfg.dtype).min)
    scale = torch.tensor(math.sqrt(hd), dtype=torch.float32)
    hidden = [x]
    for p in params['layers'][:n]:
        y = _rms_norm(x, p['ln1'], cfg.rms_norm_eps)
        q = _rope(_lin(y, p, 'q').reshape(B, L, H, hd), cos, sin)
        k = _rope(_lin(y, p, 'k').reshape(B, L, KV, hd), cos, sin)
        v = _lin(y, p, 'v').reshape(B, L, KV, hd)
        k = k.repeat_interleave(H // KV, 2)
        v = v.repeat_interleave(H // KV, 2)
        s = torch.einsum('bqhd,bkhd->bhqk', q.float() / scale, k.float())
        a = torch.softmax(s + bias, -1).to(cfg.dtype)
        y = torch.einsum('bhqk,bkhd->bqhd', a, v).reshape(B, L, H * hd)
        x = x + _lin(y, p, 'o')
        y = _rms_norm(x, p['ln2'], cfg.rms_norm_eps)
        x = x + _lin(_lin(y, p, 'up') * torch.nn.functional.silu(
            _lin(y, p, 'gate')), p, 'down')
        hidden.append(x)
    if n == cfg.num_hidden_layers:
        hidden[-1] = _rms_norm(x, params['norm'], cfg.rms_norm_eps)
    return hidden


def load_llama_safetensors(path: str, cfg: Optional[LlamaConfig] = None,
                           device: DeviceLike = 'cuda') -> Dict:
    """An HF LLaMA checkpoint directory (``config.json`` and
    ``model-*.safetensors`` shards, or one file) as the
    ``llama_hidden_states`` tree in cfg.dtype on ``device``.  Names may
    carry the ``model.`` prefix (a causal-LM checkpoint) or not (a bare
    model); ``lm_head`` is not read.  ``cfg`` defaults to the directory's
    ``config.json``.  torch Linear weights [out, in] become [in, out]."""
    if cfg is None:
        cfg = read_llama_config(path)
    dev = resolve_device(device)
    sd = load_file(path)
    pre = 'model.' if 'model.embed_tokens.weight' in sd else ''

    def get(name):
        key = pre + name
        if key not in sd:
            raise KeyError(f'{path}: no tensor {key!r}')
        return sd[key].to(dev).to(cfg.dtype)

    embed = get('embed_tokens.weight')
    if tuple(embed.shape) != (cfg.vocab_size, cfg.hidden_size):
        raise ValueError(f'{path}: embed_tokens {tuple(embed.shape)}, the '
                         f'config says ({cfg.vocab_size}, '
                         f'{cfg.hidden_size})')
    layers = []
    for i in range(cfg.num_hidden_layers):
        lp = f'layers.{i}.'
        p = {'ln1': get(lp + 'input_layernorm.weight'),
             'ln2': get(lp + 'post_attention_layernorm.weight')}
        for n, hf in HF_NAMES.items():
            p[n] = get(f'{lp}{hf}.weight').t().contiguous()
        if cfg.attention_bias:
            for n in ATTN:
                p[n + '_b'] = get(f'{lp}{HF_NAMES[n]}.bias')
        layers.append(p)
    return {'embed': embed, 'layers': layers, 'norm': get('norm.weight')}


def llama_params_from_flax(np_params: Dict, dtype: Optional[torch.dtype]
                           = None, device: DeviceLike = 'cuda') -> Dict:
    """A ``FlaxLlamaModel`` param tree (leaves as numpy arrays) as the
    ``llama_hidden_states`` tree (Flax kernels are [in, out] already), in
    ``dtype`` (default: as stored) on ``device``."""
    dev = resolve_device(device)

    def t(a):
        x = torch.from_numpy(np.asarray(a, np.float32)).to(dev)
        return x if dtype is None else x.to(dtype)

    fl = np_params
    layers = []
    for i in range(len(fl['layers'])):
        lf = fl['layers'][str(i)]
        p = {'ln1': t(lf['input_layernorm']['weight']),
             'ln2': t(lf['post_attention_layernorm']['weight'])}
        for n, hf in HF_NAMES.items():
            mod, proj = hf.split('.')
            p[n] = t(lf[mod][proj]['kernel'])
            if 'bias' in lf[mod][proj]:
                p[n + '_b'] = t(lf[mod][proj]['bias'])
        layers.append(p)
    return {'embed': t(fl['embed_tokens']['embedding']), 'layers': layers,
            'norm': t(fl['norm']['weight'])}
