"""The FLUX autoencoder's decoder (torch), the counterpart of
``chipmunk_tpu/models/autoencoder.py``: z [B, 16, H/8, W/8] -> image
[B, 3, H, W] in about [-1, 1].

BFL's AutoEncoder decoder: ch 128, ch_mult (1, 2, 4, 4), 2 res blocks per
level (+1 in the decoder), GroupNorm(32, eps 1e-6) + swish, one
single-head spatial attention block at the bottleneck, nearest 2x
upsampling, scale_factor 0.3611 / shift_factor 0.1159.  NCHW tensors and
OIHW conv weights, the layout of ``ae.safetensors`` (``decoder.*``), so
the loader (``loaders.load_ae_decoder_safetensors``) copies the weights
as stored.  Plain torch: convolutions, group norms and one attention of
head dim C (512), which the port's attention kernels do not take.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..utils.profiling import span

SCALE_FACTOR = 0.3611
SHIFT_FACTOR = 0.1159


def _conv(p: Dict, x: torch.Tensor, padding: int = 1) -> torch.Tensor:
    return F.conv2d(x, p['weight'].to(x.dtype), p['bias'].to(x.dtype),
                    padding=padding)


def _group_norm(p: Dict, x: torch.Tensor, groups: int = 32,
                eps: float = 1e-6) -> torch.Tensor:
    return F.group_norm(x.float(), groups, p['weight'].float(),
                        p['bias'].float(), eps).to(x.dtype)


def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x.float()).to(x.dtype)


def _resnet(p: Dict, x: torch.Tensor) -> torch.Tensor:
    h = _conv(p['conv1'], _swish(_group_norm(p['norm1'], x)))
    h = _conv(p['conv2'], _swish(_group_norm(p['norm2'], h)))
    if 'nin_shortcut' in p:
        x = _conv(p['nin_shortcut'], x, padding=0)
    return x + h


def _attn(p: Dict, x: torch.Tensor) -> torch.Tensor:
    B, C, H, W = x.shape
    h = _group_norm(p['norm'], x)
    q, k, v = (_conv(p[n], h, padding=0).reshape(B, C, H * W).float()
               for n in 'qkv')
    s = torch.einsum('bci,bcj->bij', q, k) * C ** -0.5
    o = torch.einsum('bij,bcj->bci', torch.softmax(s, -1), v)
    return x + _conv(p['proj_out'], o.reshape(B, C, H, W).to(x.dtype),
                     padding=0)


def _upsample(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return _conv(p['conv'], F.interpolate(x, scale_factor=2.0,
                                          mode='nearest'))


@dataclass(frozen=True)
class AutoEncoderParams:
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 16


@torch.no_grad()
def decode(params: Dict, z: torch.Tensor,
           cfg: AutoEncoderParams = AutoEncoderParams()) -> torch.Tensor:
    """z [B, z_ch, h, w] (scaled latents) -> image [B, 3, 8h, 8w] in the
    params' dtype, on the params' device (the reference's
    Decoder.forward after ``z / scale + shift``)."""
    with span('decode'):
        d = params['decoder']
        w0 = d['conv_in']['weight']
        z = z.to(device=w0.device, dtype=w0.dtype) / SCALE_FACTOR \
            + SHIFT_FACTOR
        h = _conv(d['conv_in'], z)
        h = _resnet(d['mid']['block_1'], h)
        h = _attn(d['mid']['attn_1'], h)
        h = _resnet(d['mid']['block_2'], h)
        for i in reversed(range(len(cfg.ch_mult))):
            up = d['up'][i]
            for j in range(cfg.num_res_blocks + 1):
                h = _resnet(up['block'][j], h)
            if i > 0:
                h = _upsample(up['upsample'], h)
        return _conv(d['conv_out'], _swish(_group_norm(d['norm_out'], h)))


def init_decoder_params(generator: torch.Generator,
                        cfg: AutoEncoderParams = AutoEncoderParams(),
                        dtype: torch.dtype = torch.float32,
                        device: DeviceLike = 'cuda') -> Dict:
    """Random decoder params with the BFL layout, drawn from
    ``generator`` (on ``device``): conv weights N(0, 0.02^2), biases 0,
    norm weights 1, as the reference's initialiser scales them."""
    dev = resolve_device(device)

    def conv(cin, cout, k=3):
        return {'weight': (torch.randn((cout, cin, k, k), generator=generator,
                                       device=dev) * 0.02).to(dtype),
                'bias': torch.zeros(cout, dtype=dtype, device=dev)}

    def norm(c):
        return {'weight': torch.ones(c, dtype=dtype, device=dev),
                'bias': torch.zeros(c, dtype=dtype, device=dev)}

    def res(cin, cout):
        p = {'norm1': norm(cin), 'conv1': conv(cin, cout),
             'norm2': norm(cout), 'conv2': conv(cout, cout)}
        if cin != cout:
            p['nin_shortcut'] = conv(cin, cout, k=1)
        return p

    block_in = cfg.ch * cfg.ch_mult[-1]
    d = {'conv_in': conv(cfg.z_channels, block_in),
         'mid': {'block_1': res(block_in, block_in),
                 'attn_1': {'norm': norm(block_in),
                            **{n: conv(block_in, block_in, 1)
                               for n in ('q', 'k', 'v', 'proj_out')}},
                 'block_2': res(block_in, block_in)}}
    up = {}
    cur = block_in
    for i in reversed(range(len(cfg.ch_mult))):
        cout = cfg.ch * cfg.ch_mult[i]
        blocks = []
        for _ in range(cfg.num_res_blocks + 1):
            blocks.append(res(cur, cout))
            cur = cout
        up[i] = {'block': blocks}
        if i > 0:
            up[i]['upsample'] = {'conv': conv(cur, cur)}
    d['up'] = up
    d['norm_out'] = norm(cur)
    d['conv_out'] = conv(cur, 3)
    return {'decoder': d}
