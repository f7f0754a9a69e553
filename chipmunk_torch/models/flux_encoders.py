"""The FLUX prompt encoders (torch): T5-v1.1-XXL (sequence embeddings) and
CLIP-L text (pooled vector), the counterparts of
``chipmunk_tpu/models/flux_encoders.py``.

T5 v1.1 differs from the UMT5 of ``video_encoders.py`` in one way: the
relative-position bias lives in layer 0 only and every layer shares it
(``pos_emb`` at the top of the tree).  Attention is unscaled, the
feed-forward is the gated tanh-GELU, the norms are RMS norms, as in UMT5.

CLIP-L text is a 12-layer pre-LN transformer: learned absolute position
embeddings, a causal mask of float32's lowest value, quick-GELU
(x * sigmoid(1.702 x)), scaled attention and a final layer norm; the
pooled output is the hidden state at each row's argmax token id (the EOT
token has the largest id; ``torch.argmax`` takes the first of equal
maxima, so padding with the EOT id pools the first EOT), or, where the
config names another ``eos_token_id`` than the legacy 2, at its first
occurrence.

Both are plain torch: their attention has head dim 64 and an additive
bias, which the port's attention kernels (head dim 128) do not take.
Params: linear weights [d_in, d_out], ``blocks`` a list of per-layer
dicts (``params_from_jax`` splits the reference's stacked trees).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..utils.safetensors_io import load_file
from .video_encoders import _bucket_ids, _gelu_tanh, _t5_layer_norm


@dataclass(frozen=True)
class T5Config:
    """google/t5-v1_1-xxl, the FLUX text encoder."""
    vocab_size: int = 32128
    dim: int = 4096
    d_kv: int = 64           # head dim (inner = num_heads * d_kv = 4096)
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    max_dist: int = 128
    dtype: torch.dtype = torch.float32

    @property
    def dim_attn(self) -> int:
        return self.num_heads * self.d_kv


def init_t5_params(generator: torch.Generator, cfg: T5Config,
                   device: DeviceLike = 'cuda') -> Dict:
    """Random weights with the loader's tree and the reference's scales,
    drawn from ``generator`` (which must live on ``device``)."""
    dev = resolve_device(device)
    d, da, df = cfg.dim, cfg.dim_attn, cfg.dim_ffn

    def w(shape, scale):
        return (torch.randn(shape, generator=generator, device=dev)
                * scale).to(cfg.dtype)

    def ones():
        return torch.ones(d, dtype=cfg.dtype, device=dev)

    def layer():
        return {'norm1': ones(),
                'q': w((d, da), (d * da) ** -0.25),
                'k': w((d, da), d ** -0.5),
                'v': w((d, da), d ** -0.5),
                'o': w((da, d), (d * da) ** -0.25),
                'norm2': ones(),
                'gate': w((d, df), d ** -0.5),
                'fc1': w((d, df), d ** -0.5),
                'fc2': w((df, d), df ** -0.5)}

    blocks = [layer() for _ in range(cfg.num_layers)]
    return {'token_embedding': w((cfg.vocab_size, d), 1.0),
            'pos_emb': w((cfg.num_buckets, cfg.num_heads), d ** -0.5),
            'blocks': blocks, 'norm': ones()}


@torch.no_grad()
def t5_encode(params: Dict, ids: torch.Tensor, mask: torch.Tensor,
              cfg: T5Config) -> torch.Tensor:
    """ids int [B, L], mask {0,1} [B, L] -> [B, L, dim] final hidden
    states in cfg.dtype (HF T5EncoderModel.last_hidden_state)."""
    B, L = ids.shape
    h, hd = cfg.num_heads, cfg.d_kv
    emb = params['token_embedding']
    dev = emb.device
    x = emb[ids.to(dev).long()].to(cfg.dtype)
    buckets = torch.from_numpy(_bucket_ids(L, cfg)).to(dev)      # [L, L]
    bias = params['pos_emb'][buckets].permute(2, 0, 1)[None].float()
    neg = torch.finfo(torch.float32).min
    bias = bias + torch.zeros((B, 1, 1, L), device=dev).masked_fill(
        mask.to(dev)[:, None, None, :] <= 0, neg)                # [B,h,L,L]
    for p in params['blocks']:
        y = _t5_layer_norm(x, p['norm1'])
        q, k, v = ((y @ p[n]).reshape(B, L, h, hd) for n in 'qkv')
        s = torch.einsum('binc,bjnc->bnij', q, k).float()
        a = torch.softmax(s + bias, -1).to(x.dtype)
        y = torch.einsum('bnij,bjnc->binc', a, v).reshape(B, L, -1)
        x = x + y @ p['o']
        y = _t5_layer_norm(x, p['norm2'])
        x = x + (_gelu_tanh(y @ p['gate']) * (y @ p['fc1'])) @ p['fc2']
    return _t5_layer_norm(x, params['norm'])


@dataclass(frozen=True)
class ClipTextConfig:
    """openai/clip-vit-large-patch14's text tower."""
    vocab_size: int = 49408
    width: int = 768
    num_heads: int = 12
    num_layers: int = 12
    ctx_len: int = 77
    ln_eps: float = 1e-5
    # 2 (the legacy value in that model's config.json) pools at each
    # row's largest id; any other id pools at its first occurrence, as
    # transformers' CLIP text model does
    eos_token_id: int = 2
    dtype: torch.dtype = torch.float32


def init_clip_params(generator: torch.Generator, cfg: ClipTextConfig,
                     device: DeviceLike = 'cuda') -> Dict:
    """Random weights with the loader's tree, drawn from ``generator``
    (on ``device``); biases 0, norm weights 1, as the reference's."""
    dev = resolve_device(device)
    d = cfg.width

    def w(shape, scale=None):
        scale = scale if scale is not None else shape[0] ** -0.5
        return (torch.randn(shape, generator=generator, device=dev)
                * scale).to(cfg.dtype)

    def full(n, v):
        return torch.full((n,), v, dtype=cfg.dtype, device=dev)

    def layer():
        return {'ln1_w': full(d, 1.0), 'ln1_b': full(d, 0.0),
                'q': w((d, d)), 'q_b': full(d, 0.0),
                'k': w((d, d)), 'k_b': full(d, 0.0),
                'v': w((d, d)), 'v_b': full(d, 0.0),
                'o': w((d, d)), 'o_b': full(d, 0.0),
                'ln2_w': full(d, 1.0), 'ln2_b': full(d, 0.0),
                'fc1': w((d, 4 * d)), 'fc1_b': full(4 * d, 0.0),
                'fc2': w((4 * d, d)), 'fc2_b': full(d, 0.0)}

    blocks = [layer() for _ in range(cfg.num_layers)]
    return {'token_embedding': w((cfg.vocab_size, d), 0.02),
            'pos_embedding': w((cfg.ctx_len, d), 0.01),
            'blocks': blocks, 'lnf_w': full(d, 1.0), 'lnf_b': full(d, 0.0)}


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
        eps: float) -> torch.Tensor:
    """Layer norm with float32 statistics, normalised value cast to x's
    dtype before the affine."""
    xf = x.float()
    m = xf.mean(-1, keepdim=True)
    v = xf.var(-1, unbiased=False, keepdim=True)
    return w * ((x - m) * torch.rsqrt(v + eps)).to(x.dtype) + b


@torch.no_grad()
def clip_text_encode(params: Dict, ids: torch.Tensor, cfg: ClipTextConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids int [B, 77] -> (last hidden [B, 77, width], pooled [B, width])
    in cfg.dtype (HF CLIPTextModel last_hidden_state / pooler_output)."""
    B, L = ids.shape
    h, hd = cfg.num_heads, cfg.width // cfg.num_heads
    emb = params['token_embedding']
    dev = emb.device
    ids = ids.to(dev).long()
    x = (emb[ids] + params['pos_embedding'][None, :L]).to(cfg.dtype)
    pos = torch.arange(L, device=dev)
    causal = torch.zeros((L, L), device=dev).masked_fill(
        pos[None, :] > pos[:, None], torch.finfo(torch.float32).min)
    for p in params['blocks']:
        y = _ln(x, p['ln1_w'], p['ln1_b'], cfg.ln_eps)
        q, k, v = ((y @ p[n] + p[n + '_b']).reshape(B, L, h, hd)
                   for n in 'qkv')
        s = torch.einsum('binc,bjnc->bnij', q, k).float()
        a = torch.softmax(s * (hd ** -0.5) + causal, -1).to(x.dtype)
        y = torch.einsum('bnij,bjnc->binc', a, v).reshape(B, L, -1)
        x = x + (y @ p['o'] + p['o_b'])
        y = _ln(x, p['ln2_w'], p['ln2_b'], cfg.ln_eps)
        y = y @ p['fc1'] + p['fc1_b']
        y = y * torch.sigmoid(1.702 * y)                   # quick-GELU
        x = x + (y @ p['fc2'] + p['fc2_b'])
    x = _ln(x, params['lnf_w'], params['lnf_b'], cfg.ln_eps)
    at = (ids.argmax(-1) if cfg.eos_token_id == 2
          else (ids == cfg.eos_token_id).int().argmax(-1))
    pooled = x[torch.arange(B, device=dev), at]
    return x, pooled


def _load_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """A single .safetensors file or a directory of shards, as CPU
    tensors (``utils/safetensors_io``)."""
    return load_file(path)


def _getters(sd: Dict[str, torch.Tensor], dtype: torch.dtype,
             dev: torch.device, prefix: str = ''):
    """(a, lin): a leaf as stored, and a torch Linear weight [out, in] as
    [in, out], each in ``dtype`` on ``dev``."""
    def a(name):
        return sd[prefix + name].to(device=dev, dtype=dtype)

    def lin(name):
        return sd[prefix + name].t().contiguous().to(device=dev, dtype=dtype)

    return a, lin


def load_t5_safetensors(path: str, cfg: Optional[T5Config] = None,
                        device: DeviceLike = 'cuda') -> Dict:
    """HF T5EncoderModel key layout (encoder.block.{i}.layer.{0,1}...),
    one file or a directory of shards -> the t5_encode tree, in cfg.dtype
    on ``device``."""
    cfg = cfg or T5Config()
    dev = resolve_device(device)
    a, lin = _getters(_load_safetensors_dir(path), cfg.dtype, dev)
    blocks = []
    for i in range(cfg.num_layers):
        p = f'encoder.block.{i}.layer'
        blocks.append({
            'norm1': a(f'{p}.0.layer_norm.weight'),
            'q': lin(f'{p}.0.SelfAttention.q.weight'),
            'k': lin(f'{p}.0.SelfAttention.k.weight'),
            'v': lin(f'{p}.0.SelfAttention.v.weight'),
            'o': lin(f'{p}.0.SelfAttention.o.weight'),
            'norm2': a(f'{p}.1.layer_norm.weight'),
            'gate': lin(f'{p}.1.DenseReluDense.wi_0.weight'),
            'fc1': lin(f'{p}.1.DenseReluDense.wi_1.weight'),
            'fc2': lin(f'{p}.1.DenseReluDense.wo.weight')})
    return {'token_embedding': a('shared.weight'),
            'pos_emb': a('encoder.block.0.layer.0.SelfAttention.'
                         'relative_attention_bias.weight'),
            'blocks': blocks,
            'norm': a('encoder.final_layer_norm.weight')}


def load_clip_safetensors(path: str, cfg: Optional[ClipTextConfig] = None,
                          device: DeviceLike = 'cuda') -> Dict:
    """HF CLIPTextModel key layout (text_model.encoder.layers.{i}..., or
    the same keys without the ``text_model.`` prefix) -> the
    clip_text_encode tree, in cfg.dtype on ``device``."""
    cfg = cfg or ClipTextConfig()
    dev = resolve_device(device)
    sd = _load_safetensors_dir(path)
    pre = ('text_model.' if any(k.startswith('text_model.') for k in sd)
           else '')
    a, lin = _getters(sd, cfg.dtype, dev, pre)
    blocks = []
    for i in range(cfg.num_layers):
        p = f'encoder.layers.{i}'
        blk = {'ln1_w': a(f'{p}.layer_norm1.weight'),
               'ln1_b': a(f'{p}.layer_norm1.bias'),
               'ln2_w': a(f'{p}.layer_norm2.weight'),
               'ln2_b': a(f'{p}.layer_norm2.bias')}
        for n, src in (('q', 'self_attn.q_proj'), ('k', 'self_attn.k_proj'),
                       ('v', 'self_attn.v_proj'), ('o', 'self_attn.out_proj'),
                       ('fc1', 'mlp.fc1'), ('fc2', 'mlp.fc2')):
            blk[n] = lin(f'{p}.{src}.weight')
            blk[n + '_b'] = a(f'{p}.{src}.bias')
        blocks.append(blk)
    return {'token_embedding': a('embeddings.token_embedding.weight'),
            'pos_embedding': a('embeddings.position_embedding.weight'),
            'blocks': blocks,
            'lnf_w': a('final_layer_norm.weight'),
            'lnf_b': a('final_layer_norm.bias')}
