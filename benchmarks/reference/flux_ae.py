"""Plain PyTorch reference of the FLUX autoencoder's decoder (BFL's
AutoEncoder: ch 128, ch_mult (1, 2, 4, 4), 2 + 1 res blocks a level,
GroupNorm(32, eps 1e-6) and swish, one single-head attention at the
bottleneck, nearest 2x upsampling; latents unscaled by 0.3611 and
shifted by 0.1159) in float32, on weights in ``ae.safetensors``'s
``decoder.*`` layout (OIHW convolutions)."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

SCALE_FACTOR = 0.3611
SHIFT_FACTOR = 0.1159


def _conv(p, x, padding=1):
    return F.conv2d(x, p['weight'].float(), p['bias'].float(),
                    padding=padding)


def _norm(p, x):
    return F.group_norm(x, 32, p['weight'].float(), p['bias'].float(), 1e-6)


def _swish(x):
    return x * torch.sigmoid(x)


def _res(p, x):
    h = _conv(p['conv1'], _swish(_norm(p['norm1'], x)))
    h = _conv(p['conv2'], _swish(_norm(p['norm2'], h)))
    if 'nin_shortcut' in p:
        x = _conv(p['nin_shortcut'], x, padding=0)
    return x + h


def _attn(p, x):
    B, C, H, W = x.shape
    h = _norm(p['norm'], x)
    q, k, v = (_conv(p[n], h, padding=0).reshape(B, C, H * W) for n in 'qkv')
    a = torch.softmax(torch.einsum('bci,bcj->bij', q, k) * C ** -0.5, -1)
    o = torch.einsum('bij,bcj->bci', a, v).reshape(B, C, H, W)
    return x + _conv(p['proj_out'], o, padding=0)


@torch.no_grad()
def decode(params: Dict, z: torch.Tensor, levels: int = 4,
           blocks: int = 3) -> torch.Tensor:
    """z [B, 16, h, w] -> image [B, 3, 8h, 8w], float32."""
    d = params['decoder']
    h = _conv(d['conv_in'], z.float() / SCALE_FACTOR + SHIFT_FACTOR)
    h = _res(d['mid']['block_2'], _attn(d['mid']['attn_1'],
                                        _res(d['mid']['block_1'], h)))
    for i in reversed(range(levels)):
        for j in range(blocks):
            h = _res(d['up'][i]['block'][j], h)
        if i > 0:
            h = _conv(d['up'][i]['upsample']['conv'],
                      F.interpolate(h, scale_factor=2.0, mode='nearest'))
    return _conv(d['conv_out'], _swish(_norm(d['norm_out'], h)))
