"""The UMT5-XXL text encoder of Wan2.1 (torch), the counterpart of the
UMT5 half of ``chipmunk_tpu/models/video_encoders.py``.

The encoder is T5's with per-layer relative-position biases (UMT5): RMS
layer norms without mean subtraction, unscaled attention with the
bidirectional bucketed position bias and an additive padding mask of
float32's lowest value, and the gated tanh-GELU feed-forward
``fc2(fc1(x) * gelu(gate(x)))``.  It is plain torch, as the reference
computes it outside any kernel.  ``umt5_encode`` returns every row at the
full length; the caller zeroes the context rows past each prompt's valid
length (``ctx * mask``), as the reference's ``WanTextEncoder.embed`` does.
``select_skip_layer_hidden`` is HunyuanVideo's output selection.

Params: ``token_embedding`` [vocab, dim], ``blocks`` a list of per-layer
dicts (linear weights [d_in, d_out]), ``norm``.  Not ported: the
tokenizer wrapper ``WanTextEncoder`` and the LLaVA wrapper
``HunyuanTextEncoders``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


@dataclass(frozen=True)
class UMT5Config:
    """umt5-xxl: 24 layers, dim 4096, 64 heads, vocab 256,384."""
    vocab_size: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    max_dist: int = 128
    dtype: torch.dtype = torch.float32


def _t5_layer_norm(x: torch.Tensor, w: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """RMS norm without mean subtraction; the float32 rsqrt is cast to
    x's dtype before the product."""
    r = torch.rsqrt(x.float().square().mean(-1, keepdim=True) + eps)
    return w * (x * r.to(x.dtype))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * torch.pow(x, 3.0))))


def relative_position_bucket(rel_pos: np.ndarray, num_buckets: int,
                             max_dist: int) -> np.ndarray:
    """Bidirectional bucket ids of relative positions (host side: the
    sequence length is fixed per call)."""
    nb = num_buckets // 2
    rel_buckets = (rel_pos > 0).astype(np.int64) * nb
    rel_pos = np.abs(rel_pos)
    max_exact = nb // 2
    large = max_exact + (
        np.log(np.maximum(rel_pos, 1).astype(np.float64) / max_exact)
        / math.log(max_dist / max_exact) * (nb - max_exact)).astype(np.int64)
    large = np.minimum(large, nb - 1)
    rel_buckets += np.where(rel_pos < max_exact, rel_pos, large)
    return rel_buckets


def _bucket_ids(seq: int, cfg: UMT5Config) -> np.ndarray:
    rel = np.arange(seq)[None, :] - np.arange(seq)[:, None]
    return relative_position_bucket(rel, cfg.num_buckets, cfg.max_dist)


def init_umt5_params(generator: torch.Generator, cfg: UMT5Config,
                     device: DeviceLike = 'cuda') -> Dict:
    """Random weights with the loader's tree and the reference's scales,
    drawn from ``generator`` (which must live on ``device``)."""
    dev = resolve_device(device)
    d, da, df, h = cfg.dim, cfg.dim_attn, cfg.dim_ffn, cfg.num_heads

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
                'pos_emb': w((cfg.num_buckets, h), d ** -0.5),
                'norm2': ones(),
                'gate': w((d, df), d ** -0.5),
                'fc1': w((d, df), d ** -0.5),
                'fc2': w((df, d), df ** -0.5)}

    blocks = [layer() for _ in range(cfg.num_layers)]
    return {'token_embedding': w((cfg.vocab_size, d), 1.0),
            'blocks': blocks, 'norm': ones()}


@torch.no_grad()
def umt5_encode(params: Dict, ids: torch.Tensor, mask: torch.Tensor,
                cfg: UMT5Config) -> torch.Tensor:
    """ids int [B, L], mask {0,1} [B, L] -> context [B, L, dim] in
    cfg.dtype (every row at full length; see the module docstring)."""
    B, L = ids.shape
    h, hd = cfg.num_heads, cfg.dim_attn // cfg.num_heads
    emb = params['token_embedding']
    dev = emb.device
    x = emb[ids.to(dev).long()].to(cfg.dtype)
    buckets = torch.from_numpy(_bucket_ids(L, cfg)).to(dev)      # [L, L]
    neg = torch.finfo(torch.float32).min
    mbias = torch.zeros((B, 1, 1, L), device=dev).masked_fill(
        mask.to(dev)[:, None, None, :] <= 0, neg)
    for p in params['blocks']:
        bias = p['pos_emb'][buckets].permute(2, 0, 1)[None]      # [1,h,L,L]
        y = _t5_layer_norm(x, p['norm1'])
        q, k, v = ((y @ p[n]).reshape(B, L, h, hd) for n in 'qkv')
        # T5 attention is unscaled
        s = torch.einsum('binc,bjnc->bnij', q, k).float()
        s = s + bias.float() + mbias
        a = torch.softmax(s, -1).to(x.dtype)
        y = torch.einsum('bnij,bjnc->binc', a, v).reshape(B, L, -1)
        x = x + y @ p['o']
        y = _t5_layer_norm(x, p['norm2'])
        x = x + ((y @ p['fc1']) * _gelu_tanh(y @ p['gate'])) @ p['fc2']
    return _t5_layer_norm(x, params['norm'])


def load_umt5_torch(path: str, cfg: Optional[UMT5Config] = None,
                    device: DeviceLike = 'cuda') -> Dict:
    """The UMT5-XXL encoder checkpoint (a torch ``.pth`` state dict with
    keys token_embedding / blocks.{i}.{norm1, attn.{q,k,v,o},
    pos_embedding.embedding, norm2, ffn.{gate.0, fc1, fc2}} / norm) as
    the ``umt5_encode`` tree, in cfg.dtype on ``device``.  torch Linear
    weights are [out, in] and become [in, out]."""
    cfg = cfg or UMT5Config()
    if path.endswith('.safetensors'):
        raise ValueError(f'{path}: load_umt5_torch reads the .pth state '
                         'dict only (safetensors is not a dependency of '
                         'this package); convert the checkpoint with '
                         'torch.save first')
    dev = resolve_device(device)
    sd = torch.load(path, map_location='cpu', weights_only=True)

    def a(name):
        return sd[name].to(device=dev, dtype=cfg.dtype)

    def lin(name):
        return sd[name].t().contiguous().to(device=dev, dtype=cfg.dtype)

    blocks = []
    for i in range(cfg.num_layers):
        p = f'blocks.{i}'
        blocks.append({
            'norm1': a(f'{p}.norm1.weight'),
            'q': lin(f'{p}.attn.q.weight'),
            'k': lin(f'{p}.attn.k.weight'),
            'v': lin(f'{p}.attn.v.weight'),
            'o': lin(f'{p}.attn.o.weight'),
            'pos_emb': a(f'{p}.pos_embedding.embedding.weight'),
            'norm2': a(f'{p}.norm2.weight'),
            'gate': lin(f'{p}.ffn.gate.0.weight'),
            'fc1': lin(f'{p}.ffn.fc1.weight'),
            'fc2': lin(f'{p}.ffn.fc2.weight')})
    return {'token_embedding': a('token_embedding.weight'),
            'blocks': blocks, 'norm': a('norm.weight')}


def select_skip_layer_hidden(hidden_states, skip_layer: int,
                             crop_start: int = 0) -> torch.Tensor:
    """HunyuanVideo's text-encoder output selection: the hidden states of
    the layer ``skip_layer`` before the last (no final norm: the shipped
    config leaves apply_final_norm off), without the first
    ``crop_start`` rows (the instruction template)."""
    h = hidden_states[-(skip_layer + 1)]
    return h[:, crop_start:] if crop_start > 0 else h
