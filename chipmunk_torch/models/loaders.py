"""Checkpoint loaders (torch), the counterpart of
``chipmunk_tpu/models/loaders.py``: BFL FLUX, HunyuanVideo and Wan2.1
state dicts as the port's param trees, and the FLUX autoencoder's
decoder.

A state dict is any mapping of name -> value (numpy arrays, CPU or CUDA
tensors).  A lazy ``Mapping`` works: each value is read once, and a
membership test should not make the value.  Each value is
moved to ``device`` as it is converted, so that the host holds no more
than the state dict itself.  The trees are the reference's with
``double``/``single``/``blocks`` as lists of per-layer dicts: torch
Linear weights [out, in] become [in, out]; MLP weights are output-major
[N, C] for the sparse kernels; FLUX's single-block ``linear1``/``linear2``
are split into qkv/fc1 and o_proj/fc2 (the reference's sparsify split);
the video models' patch-embedding Conv3d (stride == kernel) becomes a
linear over patches flattened in (C, pt, ph, pw) order.  Files are read
with ``utils/safetensors_io``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from ..device import DeviceLike, resolve_device
from ..utils.quant import quantize
from ..utils.safetensors_io import load_file
from .flux import _np_to_torch


class _Reader:
    """Leaf makers over one state dict, on one device and dtype."""

    def __init__(self, sd: Mapping[str, Any], dtype: torch.dtype,
                 device: DeviceLike):
        self.sd, self.dt, self.dev = sd, dtype, resolve_device(device)

    def __contains__(self, name: str) -> bool:
        return name in self.sd

    def raw(self, name: str) -> torch.Tensor:
        """The value as stored, on the device."""
        v = self.sd[name]
        if isinstance(v, torch.Tensor):
            return v.to(self.dev)
        return _np_to_torch(v, self.dev)

    def a(self, name: str) -> torch.Tensor:
        return self.raw(name).to(self.dt)

    def t(self, name: str) -> torch.Tensor:
        """A torch Linear weight [out, in] as [in, out]."""
        return self.raw(name).to(self.dt).t().contiguous()

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dt).contiguous()

    def lin(self, name: str) -> Dict:
        p = {'w': self.t(f'{name}.weight')}
        if f'{name}.bias' in self.sd:
            p['b'] = self.a(f'{name}.bias')
        return p

    def embedder(self, name: str, first: str, second: str) -> Dict:
        return {'in': self.lin(f'{name}.{first}'),
                'out': self.lin(f'{name}.{second}')}

    def patch_linear(self, name: str) -> Dict:
        """A Conv3d with stride == kernel as a linear over (C, pt, ph,
        pw)-flattened patches."""
        conv = self.raw(f'{name}.weight')                # [d, C, pt, ph, pw]
        return {'w': self.cast(conv.reshape(conv.shape[0], -1).t()),
                'b': self.a(f'{name}.bias')}


# -------------------------------------------------------------------- FLUX

def load_flux_params(state_dict: Mapping[str, Any], cfg, ck=None,
                     device: DeviceLike = 'cuda') -> Dict:
    """A BFL FLUX state dict as the ``flux_forward`` tree (``cfg``: a
    ``FluxModelConfig``) on ``device``.

    ``ck`` (optional ChipmunkConfig): under ``ck.mlp.is_fp8`` the MLP
    weights are stored as ``mlp_fp8.quant_spec_for_is_fp8`` says, the
    weights of the sparse kernels int8 and the text MLP's fp8, each with
    per-row scales (``keep_axes=(0,)``); they are quantized from the
    stored values in f32 on ``device``, byte for byte the reference's
    ``quantize_host``."""
    r = _Reader(state_dict, cfg.dtype, device)
    h = cfg.hidden_size
    is_fp8 = bool(ck is not None and ck.mlp.is_fp8)

    def mlpw(w: torch.Tensor, sparse: bool = True):
        """An output-major [N, C] MLP weight, quantized under is_fp8."""
        if not is_fp8:
            return r.cast(w)
        return quantize(w.float().contiguous(), 'int8' if sparse else 'fp8',
                        keep_axes=(0,))

    def dbl(i: int) -> Dict:
        p = f'double_blocks.{i}'
        d = {'img_mod': r.lin(f'{p}.img_mod.lin'),
             'txt_mod': r.lin(f'{p}.txt_mod.lin'),
             'img_qkv': r.lin(f'{p}.img_attn.qkv'),
             'txt_qkv': r.lin(f'{p}.txt_attn.qkv')}
        for s in ('img', 'txt'):
            d[f'{s}_qnorm'] = r.a(f'{p}.{s}_attn.norm.query_norm.scale')
            d[f'{s}_knorm'] = r.a(f'{p}.{s}_attn.norm.key_norm.scale')
        d['img_proj'] = r.lin(f'{p}.img_attn.proj')
        d['txt_proj'] = r.lin(f'{p}.txt_attn.proj')
        for s, sparse in (('img', True), ('txt', False)):
            d[f'{s}_w1t'] = mlpw(r.raw(f'{p}.{s}_mlp.0.weight'), sparse)
            d[f'{s}_b1'] = r.a(f'{p}.{s}_mlp.0.bias')
            d[f'{s}_w2'] = mlpw(r.raw(f'{p}.{s}_mlp.2.weight').t(), sparse)
            d[f'{s}_b2'] = r.a(f'{p}.{s}_mlp.2.bias')
        return d

    def sgl(i: int) -> Dict:
        p = f'single_blocks.{i}'
        w1 = r.raw(f'{p}.linear1.weight')                # [3h + mh, h]
        b1 = r.raw(f'{p}.linear1.bias')
        w2 = r.raw(f'{p}.linear2.weight')                # [h, h + mh]
        return {
            'mod': r.lin(f'{p}.modulation.lin'),
            'qkv': {'w': r.cast(w1[:3 * h].t()), 'b': r.cast(b1[:3 * h])},
            'w1t': mlpw(w1[3 * h:]),
            'b1': r.cast(b1[3 * h:]),
            'o_proj': {'w': r.cast(w2[:, :h].t()),
                       'b': r.a(f'{p}.linear2.bias')},
            'w2': mlpw(w2[:, h:].t()),
            'qnorm': r.a(f'{p}.norm.query_norm.scale'),
            'knorm': r.a(f'{p}.norm.key_norm.scale')}

    params = {
        'img_in': r.lin('img_in'),
        'txt_in': r.lin('txt_in'),
        'time_in': r.embedder('time_in', 'in_layer', 'out_layer'),
        'vector_in': r.embedder('vector_in', 'in_layer', 'out_layer'),
        'double': [dbl(i) for i in range(cfg.depth)],
        'single': [sgl(i) for i in range(cfg.depth_single_blocks)],
        'final_mod': r.lin('final_layer.adaLN_modulation.1'),
        'final_proj': r.lin('final_layer.linear'),
    }
    if cfg.guidance_embed and 'guidance_in.in_layer.weight' in r:
        params['guidance_in'] = r.embedder('guidance_in', 'in_layer',
                                           'out_layer')
    return params


def load_flux_safetensors(path: str, cfg, ck=None,
                          device: DeviceLike = 'cuda') -> Dict:
    """:func:`load_flux_params` over a ``.safetensors`` file (or a
    directory of shards)."""
    return load_flux_params(load_file(path), cfg, ck=ck, device=device)


# ------------------------------------------------------------ HunyuanVideo

def load_hunyuan_params(state_dict: Mapping[str, Any], cfg,
                        device: DeviceLike = 'cuda') -> Dict:
    """A HunyuanVideo transformer state dict (the hyvideo layout) as the
    ``HunyuanModel`` tree (``cfg``: a ``HunyuanModelConfig``) on
    ``device``: the Conv3d ``img_in`` as a patch linear, the core's
    ``txt_in`` the identity (the token refiner already gives hidden-size
    tokens), the refiner's input / timestep / context embedders and its
    two blocks, the double and single blocks as FLUX's (single blocks
    split the same way), the final layer's (shift, scale)."""
    r = _Reader(state_dict, cfg.dtype, device)
    core = cfg.core()
    h = core.hidden_size

    def dbl(i: int) -> Dict:
        p = f'double_blocks.{i}'
        d = {'img_mod': r.lin(f'{p}.img_mod.linear'),
             'txt_mod': r.lin(f'{p}.txt_mod.linear'),
             'img_qkv': r.lin(f'{p}.img_attn_qkv'),
             'txt_qkv': r.lin(f'{p}.txt_attn_qkv')}
        for s in ('img', 'txt'):
            d[f'{s}_qnorm'] = r.a(f'{p}.{s}_attn_q_norm.weight')
            d[f'{s}_knorm'] = r.a(f'{p}.{s}_attn_k_norm.weight')
        d['img_proj'] = r.lin(f'{p}.img_attn_proj')
        d['txt_proj'] = r.lin(f'{p}.txt_attn_proj')
        for s in ('img', 'txt'):
            d[f'{s}_w1t'] = r.a(f'{p}.{s}_mlp.fc1.weight')
            d[f'{s}_b1'] = r.a(f'{p}.{s}_mlp.fc1.bias')
            d[f'{s}_w2'] = r.t(f'{p}.{s}_mlp.fc2.weight')
            d[f'{s}_b2'] = r.a(f'{p}.{s}_mlp.fc2.bias')
        return d

    def sgl(i: int) -> Dict:
        p = f'single_blocks.{i}'
        w1 = r.raw(f'{p}.linear1.weight')                # [3h + mh, h]
        b1 = r.raw(f'{p}.linear1.bias')
        w2 = r.raw(f'{p}.linear2.weight')                # [h, h + mh]
        return {
            'mod': r.lin(f'{p}.modulation.linear'),
            'qkv': {'w': r.cast(w1[:3 * h].t()), 'b': r.cast(b1[:3 * h])},
            'w1t': r.cast(w1[3 * h:]),
            'b1': r.cast(b1[3 * h:]),
            'o_proj': {'w': r.cast(w2[:, :h].t()),
                       'b': r.a(f'{p}.linear2.bias')},
            'w2': r.cast(w2[:, h:].t()),
            'qnorm': r.a(f'{p}.q_norm.weight'),
            'knorm': r.a(f'{p}.k_norm.weight')}

    rp = 'txt_in.individual_token_refiner.blocks'

    def refiner_block(i: int) -> Dict:
        p = f'{rp}.{i}'
        return {'qkv': r.lin(f'{p}.self_attn_qkv'),
                'proj': r.lin(f'{p}.self_attn_proj'),
                'fc1': r.lin(f'{p}.mlp.fc1'),
                'fc2': r.lin(f'{p}.mlp.fc2'),
                'gate': r.lin(f'{p}.adaLN_modulation.1'),
                'norm1_w': r.a(f'{p}.norm1.weight'),
                'norm1_b': r.a(f'{p}.norm1.bias'),
                'norm2_w': r.a(f'{p}.norm2.weight'),
                'norm2_b': r.a(f'{p}.norm2.bias')}

    params = {
        'img_in': r.patch_linear('img_in.proj'),
        'txt_in': {'w': torch.eye(h, dtype=r.dt, device=r.dev),
                   'b': torch.zeros(h, dtype=r.dt, device=r.dev)},
        'time_in': r.embedder('time_in', 'mlp.0', 'mlp.2'),
        'vector_in': r.embedder('vector_in', 'in_layer', 'out_layer'),
        'double': [dbl(i) for i in range(cfg.depth_double)],
        'single': [sgl(i) for i in range(cfg.depth_single)],
        'final_mod': r.lin('final_layer.adaLN_modulation.1'),
        'final_proj': r.lin('final_layer.linear'),
        'refiner': {
            'in': r.lin('txt_in.input_embedder'),
            't_embed': r.embedder('txt_in.t_embedder', 'mlp.0', 'mlp.2'),
            'c_embed': r.embedder('txt_in.c_embedder', 'linear_1',
                                  'linear_2'),
            'blocks': [refiner_block(i) for i in range(2)]},
    }
    if cfg.guidance_embed and 'guidance_in.mlp.0.weight' in r:
        params['guidance_in'] = r.embedder('guidance_in', 'mlp.0', 'mlp.2')
    return params


def load_hunyuan_safetensors(path: str, cfg,
                             device: DeviceLike = 'cuda') -> Dict:
    """:func:`load_hunyuan_params` over a ``.safetensors`` file (or a
    directory of shards)."""
    return load_hunyuan_params(load_file(path), cfg, device=device)


# ------------------------------------------------------------------ Wan2.1

def load_wan_params(state_dict: Mapping[str, Any], cfg,
                    device: DeviceLike = 'cuda') -> Dict:
    """A Wan2.1 T2V state dict (the wan/modules/model.py layout) as the
    ``WanModel`` tree (``cfg``: a ``WanModelConfig``) on ``device``: the
    patch embedding as a patch linear; per block the self- and
    cross-attention q/k/v/o with their full-width norms, the affine
    norm3, the FFN output-major and ``modulation[0]`` ([6, dim]); the
    head's linear and ``head.modulation[0]`` ([2, dim])."""
    r = _Reader(state_dict, cfg.dtype, device)

    def blk(i: int) -> Dict:
        p = f'blocks.{i}'
        d = {'mod_bias': r.cast(r.raw(f'{p}.modulation')[0])}
        for n in ('q', 'k', 'v', 'o'):
            d[n] = r.lin(f'{p}.self_attn.{n}')
        d['qnorm'] = r.a(f'{p}.self_attn.norm_q.weight')
        d['knorm'] = r.a(f'{p}.self_attn.norm_k.weight')
        for n in ('q', 'k', 'v', 'o'):
            d[f'c{n}'] = r.lin(f'{p}.cross_attn.{n}')
        d['cqnorm'] = r.a(f'{p}.cross_attn.norm_q.weight')
        d['cknorm'] = r.a(f'{p}.cross_attn.norm_k.weight')
        d['norm3_scale'] = r.a(f'{p}.norm3.weight')
        d['norm3_bias'] = r.a(f'{p}.norm3.bias')
        d['w1t'] = r.a(f'{p}.ffn.0.weight')                # [ffn, dim]
        d['b1'] = r.a(f'{p}.ffn.0.bias')
        d['w2'] = r.t(f'{p}.ffn.2.weight')                 # [ffn, dim]
        d['b2'] = r.a(f'{p}.ffn.2.bias')
        return d

    return {
        'patch_in': r.patch_linear('patch_embedding'),
        'text_in': {'fc1': r.lin('text_embedding.0'),
                    'fc2': r.lin('text_embedding.2')},
        'time_in': {'fc1': r.lin('time_embedding.0'),
                    'fc2': r.lin('time_embedding.2')},
        'time_proj': r.lin('time_projection.1'),
        'blocks': [blk(i) for i in range(cfg.num_layers)],
        'head_mod': r.cast(r.raw('head.modulation')[0]),
        'head': r.lin('head.head'),
    }


def load_wan_safetensors(path: str, cfg,
                         device: DeviceLike = 'cuda') -> Dict:
    """:func:`load_wan_params` over a ``.safetensors`` file (or a
    directory of shards)."""
    return load_wan_params(load_file(path), cfg, device=device)


# ------------------------------------------------------------ autoencoder

def load_ae_decoder_safetensors(path: str,
                                dtype: torch.dtype = torch.float32,
                                device: DeviceLike = 'cuda') -> Dict:
    """The ``decoder.*`` subtree of BFL's ``ae.safetensors`` as the
    ``autoencoder.decode`` tree, weights as stored (OIHW), in ``dtype``
    on ``device``: dotted keys become nested dicts, the ``block``
    sequences lists, ``up`` a dict of level -> subtree."""
    dev = resolve_device(device)
    tree: Dict = {}
    for k, v in load_file(path, 'decoder.').items():
        parts = k[len('decoder.'):].split('.')
        cur = tree
        for p in parts[:-1]:
            cur = cur.setdefault(int(p) if p.isdigit() else p, {})
        cur[parts[-1]] = v.to(device=dev, dtype=dtype)

    def listify(d):
        if isinstance(d, dict):
            if d and all(isinstance(x, int) for x in d) \
                    and set(d) == set(range(len(d))):
                return [listify(d[i]) for i in range(len(d))]
            return {k: listify(v) for k, v in d.items()}
        return d

    tree = {k: listify(v) for k, v in tree.items()}
    if isinstance(tree.get('up'), list):
        tree['up'] = dict(enumerate(tree['up']))
    return {'decoder': tree}
