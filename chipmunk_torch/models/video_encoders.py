"""The video models' prompt encoders (torch), the counterpart of
``chipmunk_tpu/models/video_encoders.py``.

UMT5-XXL (Wan2.1) is T5's encoder with per-layer relative-position biases:
RMS layer norms without mean subtraction, unscaled attention with the
bidirectional bucketed position bias and an additive padding mask of
float32's lowest value, and the gated tanh-GELU feed-forward
``fc2(fc1(x) * gelu(gate(x)))``.  It is plain torch, as the reference
computes it outside any kernel.  ``umt5_encode`` returns every row at the
full length; ``WanTextEncoder.embed`` zeroes the rows past each prompt.

HunyuanVideo encodes a prompt with LLaVA-LLaMA-3-8B's language model
(``llama.py``) under an instruction template, takes the hidden states of
the layer ``hidden_state_skip_layer`` before the last without the final
norm (``select_skip_layer_hidden``), drops the template's
``VIDEO_CROP_START`` rows, and adds CLIP-L's pooled vector
(``flux_encoders.py``).

The tokenizers come from ``transformers.AutoTokenizer``, imported when a
holder first needs one (``load_tokenizer``); a tokenizer object set on a
holder (``_tok``, ``_llm_tok``, ``_clip_tok``) is used as given.  Nothing
runs without its tokenizer and its weights.

UMT5 params: ``token_embedding`` [vocab, dim], ``blocks`` a list of
per-layer dicts (linear weights [d_in, d_out]), ``norm``.
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..utils.safetensors_io import load_file


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


def _umt5_state_dict(path: str) -> Dict[str, torch.Tensor]:
    if path.endswith('.safetensors'):
        return load_file(path)
    return torch.load(path, map_location='cpu', weights_only=True)


def umt5_config_from_state_dict(sd: Dict[str, torch.Tensor],
                                dtype: torch.dtype = torch.float32
                                ) -> UMT5Config:
    """The encoder geometry a state dict holds (umt5-xxl's for the
    shipped checkpoint); ``max_dist`` is not stored and stays 128."""
    vocab, dim = sd['token_embedding.weight'].shape
    buckets, heads = sd['blocks.0.pos_embedding.embedding.weight'].shape
    layers = 0
    while f'blocks.{layers}.norm1.weight' in sd:
        layers += 1
    return UMT5Config(vocab_size=vocab, dim=dim,
                      dim_attn=sd['blocks.0.attn.q.weight'].shape[0],
                      dim_ffn=sd['blocks.0.ffn.fc1.weight'].shape[0],
                      num_heads=heads, num_layers=layers,
                      num_buckets=buckets, dtype=dtype)


def _umt5_tree(sd: Dict[str, torch.Tensor], cfg: UMT5Config,
               dev: torch.device) -> Dict:
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


def load_umt5_torch(path: str, cfg: Optional[UMT5Config] = None,
                    device: DeviceLike = 'cuda') -> Dict:
    """The UMT5-XXL encoder checkpoint (a torch ``.pth`` state dict, or
    the same keys in a ``.safetensors`` file: token_embedding /
    blocks.{i}.{norm1, attn.{q,k,v,o}, pos_embedding.embedding, norm2,
    ffn.{gate.0, fc1, fc2}} / norm) as the ``umt5_encode`` tree, in
    cfg.dtype on ``device``.  torch Linear weights are [out, in] and
    become [in, out]."""
    dev = resolve_device(device)
    return _umt5_tree(_umt5_state_dict(path), cfg or UMT5Config(), dev)


def select_skip_layer_hidden(hidden_states, skip_layer: int,
                             crop_start: int = 0) -> torch.Tensor:
    """HunyuanVideo's text-encoder output selection: the hidden states of
    the layer ``skip_layer`` before the last (no final norm: the shipped
    config leaves apply_final_norm off), without the first
    ``crop_start`` rows (the instruction template)."""
    h = hidden_states[-(skip_layer + 1)]
    return h[:, crop_start:] if crop_start > 0 else h


def load_tokenizer(path: Optional[str], who: str):
    """``transformers.AutoTokenizer`` from the local directory ``path``,
    padding on the right (the template crop and the position ids assume
    it, as the reference's LLaVA encoder sets it).  Raises when no path is
    given or the package is missing: nothing encodes without its
    tokenizer."""
    if not path:
        raise ValueError(f'{who}: no tokenizer directory given and none set '
                         f'on the holder')
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(f'{who}: the tokenizer needs the transformers '
                          f'package, which is not installed; set a '
                          f'tokenizer object on the holder instead') from e
    return AutoTokenizer.from_pretrained(path, padding_side='right')


def _need(path: Optional[str], who: str, what: str) -> str:
    if not path:
        raise ValueError(f'{who}: no {what} given and no weights set on the '
                         f'holder')
    return path


def _ids(a, device: torch.device, dtype=torch.long) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


@dataclass
class WanTextEncoder:
    """Wan2.1's prompt encoder: the UMT5 tokenizer, ids padded or cut to
    ``text_len``, UMT5-XXL, the rows past each prompt zeroed (the model
    takes a fixed ``text_len`` with zero padding).  checkpoint_path: the
    ``.pth`` or ``.safetensors`` encoder; tokenizer_path: a local
    tokenizer directory.  The encoder's geometry is the checkpoint's."""
    checkpoint_path: Optional[str] = None
    tokenizer_path: Optional[str] = None
    text_len: int = 512
    dtype: torch.dtype = torch.bfloat16
    device: DeviceLike = 'cuda'

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._params = self._tok = None
        self._cfg = UMT5Config(dtype=self.dtype)

    def available(self) -> bool:
        return bool(self.checkpoint_path and self.tokenizer_path)

    def _load(self):
        if self._params is None:
            sd = _umt5_state_dict(_need(self.checkpoint_path,
                                        'WanTextEncoder', 'checkpoint_path'))
            self._cfg = umt5_config_from_state_dict(sd, self.dtype)
            self._params = _umt5_tree(sd, self._cfg, self.device)
        if self._tok is None:
            self._tok = load_tokenizer(self.tokenizer_path, 'WanTextEncoder')

    def embed(self, prompts) -> torch.Tensor:
        """list[str] -> [B, text_len, dim] in self.dtype with the rows past
        each prompt zeroed."""
        self._load()
        tt = self._tok(list(prompts), max_length=self.text_len,
                       padding='max_length', truncation=True,
                       return_tensors='np')
        ids = _ids(tt['input_ids'], self.device)
        mask = _ids(tt['attention_mask'], self.device, torch.int32)
        ctx = umt5_encode(self._params, ids, mask, self._cfg)
        return ctx * (mask[..., None] > 0)

    def release(self) -> None:
        """Drop the encoder weights (the tokenizer stays)."""
        self._params = None


# HunyuanVideo's video prompt template and the rows its tokens take
PROMPT_TEMPLATE_ENCODE_VIDEO = (
    "<|start_header_id|>system<|end_header_id|>\n\nDescribe the video by "
    "detailing the following aspects: "
    "1. The main content and theme of the video."
    "2. The color, shape, size, texture, quantity, text, and spatial "
    "relationships of the objects."
    "3. Actions, events, behaviors temporal relationships, physical "
    "movement changes of the objects."
    "4. background environment, light, style and atmosphere."
    "5. camera angles, movements, and transitions used in the video:"
    "<|eot_id|><|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>")
VIDEO_CROP_START = 95


def read_clip_config(path: str, dtype: torch.dtype = torch.float32):
    """The CLIP text tower of a local HF directory: its ``config.json``
    where there is one (transformers' defaults for keys it leaves out),
    else CLIP-L's geometry with the legacy pooling rule."""
    from .flux_encoders import ClipTextConfig
    f = os.path.join(path, 'config.json')
    if not os.path.isfile(f):
        return ClipTextConfig(dtype=dtype)
    with open(f) as fh:
        d = json.load(fh)
    if d.get('hidden_act', 'quick_gelu') != 'quick_gelu':
        raise ValueError(f'{f}: hidden_act {d["hidden_act"]!r}, not '
                         'quick_gelu')
    dflt = ClipTextConfig()
    return ClipTextConfig(
        vocab_size=d.get('vocab_size', dflt.vocab_size),
        width=d.get('hidden_size', dflt.width),
        num_heads=d.get('num_attention_heads', dflt.num_heads),
        num_layers=d.get('num_hidden_layers', dflt.num_layers),
        ctx_len=d.get('max_position_embeddings', dflt.ctx_len),
        ln_eps=d.get('layer_norm_eps', dflt.ln_eps),
        eos_token_id=d.get('eos_token_id', 49407), dtype=dtype)


@dataclass
class HunyuanTextEncoders:
    """HunyuanVideo's prompt encoders: LLaVA-LLaMA-3-8B's language model
    under the video template (the hidden states ``hidden_state_skip_layer``
    layers before the last, without the template's rows) and CLIP-L's
    pooled vector.  llm_path / clip_path: local HF directories
    (``config.json``, safetensors, tokenizer)."""
    llm_path: Optional[str] = None
    clip_path: Optional[str] = None
    max_length: int = 256 + VIDEO_CROP_START   # prompt tokens + template
    hidden_state_skip_layer: int = 2
    dtype: torch.dtype = torch.bfloat16
    device: DeviceLike = 'cuda'

    def __post_init__(self):
        self.device = resolve_device(self.device)
        # _llm: (params, LlamaConfig); _clip: (params, ClipTextConfig)
        self._llm = self._llm_tok = self._clip = self._clip_tok = None

    def available(self) -> bool:
        return bool(self.llm_path and self.clip_path)

    def _load(self):
        from .flux_encoders import load_clip_safetensors
        from .llama import load_llama_safetensors, read_llama_config
        who = 'HunyuanTextEncoders'
        if self._llm is None:
            path = _need(self.llm_path, who, 'llm_path')
            cfg = read_llama_config(path, self.dtype)
            self._llm = (load_llama_safetensors(path, cfg, self.device), cfg)
        if self._llm_tok is None:
            self._llm_tok = load_tokenizer(self.llm_path, who)
        if self._clip is None:
            path = _need(self.clip_path, who, 'clip_path')
            ccfg = read_clip_config(path, self.dtype)
            self._clip = (load_clip_safetensors(path, ccfg, self.device),
                          ccfg)
        if self._clip_tok is None:
            self._clip_tok = load_tokenizer(self.clip_path, who)

    def embed(self, prompts) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
        """list[str] -> (txt [B, max_length - VIDEO_CROP_START, hidden],
        txt_mask int32 [B, same], y [B, width]) on self.device: the (txt,
        txt_mask, vec) HunyuanModel takes.  Only the layers up to the
        selected one run."""
        from .flux_encoders import clip_text_encode
        from .llama import llama_hidden_states
        self._load()
        prompts = list(prompts)
        texts = [PROMPT_TEMPLATE_ENCODE_VIDEO.format(p) for p in prompts]
        tt = self._llm_tok(texts, max_length=self.max_length,
                           padding='max_length', truncation=True,
                           return_tensors='np')
        params, cfg = self._llm
        mask = _ids(tt['attention_mask'], self.device, torch.int32)
        hs = llama_hidden_states(
            params, _ids(tt['input_ids'], self.device), mask, cfg,
            layers=cfg.num_hidden_layers - self.hidden_state_skip_layer)
        txt = select_skip_layer_hidden(hs, 0, VIDEO_CROP_START)
        ct = self._clip_tok(prompts, max_length=77, padding='max_length',
                            truncation=True, return_tensors='np')
        cparams, ccfg = self._clip
        _, y = clip_text_encode(cparams, _ids(ct['input_ids'], self.device),
                                ccfg)
        return txt, mask[:, VIDEO_CROP_START:], y

    def release(self) -> None:
        """Drop both encoders' weights (the tokenizers stay)."""
        self._llm = self._clip = None
