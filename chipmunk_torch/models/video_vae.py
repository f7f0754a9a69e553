"""The video VAE decoders (torch): HunyuanVideo's causal-3D VAE and the
Wan2.1 VAE, the counterparts of ``chipmunk_tpu/models/video_vae.py``.

PyTorch's layout throughout: NCDHW tensors, conv weights [Co, Ci, kt, kh,
kw] (2-D: [Co, Ci, kh, kw]), linear weights [out, in], the checkpoints'
own layout, so the loaders copy weights as stored; the reference's
channels-last trees (DHWIO weights, [in, out] linears) come across
through ``hunyuan_vae_params_from_jax`` / ``wan_vae_params_from_jax``,
which transpose each weight once.  float32 throughout.

The same functions as the reference, computed so that a full-size clip
fits one card:

  * every convolution runs over pieces of the time axis
    (``_conv_frames``): each piece gathers its own kt - 1 halo frames and
    pads itself, so no padded copy of the whole tensor is made and no
    single cuDNN call sees a tensor beyond ``PIECE_ELEMS`` elements (ATen
    refuses cuDNN a tensor above int32 indexing whose batch it cannot
    split).  What stands in front of a convolution is done per piece:
    the norm and SiLU of a resnet (its statistics taken first, over the
    whole tensor where they span it), a nearest 2x upsample, and
    HunyuanVideo's doubled frames, so none of those tensors is formed
    whole; a resnet's second convolution writes over its input (the
    pieces run backwards) and its shortcut adds into the output, so a
    resnet holds two tensors of its stage at a time;
  * HunyuanVideo's mid attention (one score matrix over all T·hw tokens
    with a frame-causal mask in the reference) is computed one query
    frame at a time over the key frames 0..t only, in row blocks of at
    most ``SCORE_ELEMS`` scores; every row keeps its own frame, so no row
    is all -inf.  Wan's attention is per frame.

Wan's decoder is prefix-closed (per-position RMS norms, zero-padded causal
convs, per-frame attention): decoding the first N latent frames gives the
first 4(N-1)+1 frames of the whole clip.  HunyuanVideo's is not: its group
norms reduce over T, so N latent frames decode to a shorter video.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..utils.safetensors_io import load_file

# the largest padded input or output of one convolution call (elements)
PIECE_ELEMS = 2 ** 28
# the largest block of attention scores formed at once (elements)
SCORE_ELEMS = 2 ** 28

Pre = Optional[Callable[[torch.Tensor], torch.Tensor]]


# ------------------------------------------------------------- primitives

def _pieces(n: int, per_item: int, halo: int,
            max_elems: int) -> List[Tuple[int, int]]:
    """Split range(n) into consecutive pieces of k items with (k + halo)
    * per_item <= max_elems (at least one item a piece)."""
    k = max(1, max_elems // max(per_item, 1) - halo)
    return [(i, min(i + k, n)) for i in range(0, n, k)]


def _conv_frames(x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor], src: Sequence[int],
                 pad_mode: str, up: bool = False, pre: Pre = None,
                 out: Optional[torch.Tensor] = None,
                 accumulate: bool = False) -> torch.Tensor:
    """Causal 3-D convolution (stride 1) of the frame sequence
    ``pre(x[:, :, src])`` (nearest 2x upsampled in space first if ``up``),
    time padded (kt - 1, 0) and space padded k // 2 on each side:
    replicated ('edge') or zeros ('constant').  Runs over pieces of output
    frames, each gathering its input frames and halo itself; ``pre`` is a
    per-position function (a norm with fixed statistics and an
    activation) applied in place to each gathered piece.  Writes into
    ``out`` if given (added to it with ``accumulate``); ``out`` may be
    ``x`` itself when the channels match and ``src`` is every frame in
    order: the pieces then run from the last to the first, so that each
    reads its input frames before they are overwritten."""
    kt, kh, kw = w.shape[2:]
    src = list(src)
    # the time-padded frame sequence; -1 is a zero frame
    lead = src[0] if pad_mode == 'edge' else -1
    seq = [lead] * (kt - 1) + src
    B, Ci, _, H, W = x.shape
    Co = w.shape[0]
    if up:
        H, W = 2 * H, 2 * W
    ph, pw = kh // 2, kw // 2
    Ho, Wo = H + 2 * ph - kh + 1, W + 2 * pw - kw + 1
    T = len(src)
    pieces = _pieces(T, B * max(Ci * (H + 2 * ph) * (W + 2 * pw),
                                Co * Ho * Wo),
                     kt - 1, PIECE_ELEMS)
    if out is x:
        if Ci != Co or up or src != list(range(x.shape[2])):
            raise ValueError('a convolution in place takes every frame in '
                             'order, no upsampling, and Co == Ci')
        pieces = pieces[::-1]
    for t0, t1 in pieces:
        fr = seq[t0:t1 + kt - 1]
        n0 = next((i for i, f in enumerate(fr) if f >= 0), len(fr))
        p = x.index_select(2, torch.tensor(fr[n0:], device=x.device))
        if pre is not None:
            p = pre(p)
        if n0:
            p = torch.cat([p.new_zeros(B, Ci, n0, *p.shape[3:]), p], 2)
        if up:
            p = F.interpolate(p, scale_factor=(1.0, 2.0, 2.0), mode='nearest')
        if ph or pw:
            p = F.pad(p, (pw, pw, ph, ph, 0, 0),
                      mode='replicate' if pad_mode == 'edge' else 'constant')
        y = F.conv3d(p, w, b)
        del p
        if out is None:
            if len(pieces) == 1:
                return y
            out = y.new_empty(B, Co, T, Ho, Wo)
        if accumulate:
            out[:, :, t0:t1] += y
        else:
            out[:, :, t0:t1] = y
        del y
    return out


def _group_normaliser(x: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, groups: int,
                      eps: float = 1e-6) -> Callable:
    """GroupNorm of x over (C / groups, T, H, W): the group statistics of
    x are taken now, in float32; the returned function normalises a
    float32 piece of x's frames in place."""
    B, C = x.shape[:2]
    var, mean = torch.var_mean(x.float().reshape(B, groups, -1), -1,
                               unbiased=False)

    def per_channel(v):
        return v.repeat_interleave(C // groups, 1)[:, :, None, None, None]
    m, r = per_channel(mean), per_channel(torch.rsqrt(var + eps))
    g, bb = (v.float()[None, :, None, None, None] for v in (gamma, beta))
    return lambda p: p.sub_(m).mul_(r).mul_(g).add_(bb)


def _rms_(p: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """Wan's RMS_norm in place on a float32 [B, C, T, H, W]: the channel
    vector at each position L2-normalised, rescaled by sqrt(C) * gamma."""
    n = torch.linalg.vector_norm(p, dim=1, keepdim=True).add_(1e-12)
    return p.div_(n).mul_(p.shape[1] ** 0.5).mul_(
        gamma.float()[:, None, None, None])


def _silu_after(norm: Callable) -> Pre:
    return lambda p: F.silu(norm(p), inplace=True)


def causal_conv3d(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None,
                  pad_mode: str = 'constant') -> torch.Tensor:
    """Causal 3-D conv of x [B, Ci, T, H, W] with w [Co, Ci, kt, kh, kw]:
    time pads (kt - 1, 0), space pads k // 2 on each side, replicated
    ('edge', HunyuanVideo) or zeros ('constant', Wan); stride 1.  Split
    over the time axis into pieces of at most ``PIECE_ELEMS`` elements
    (the same function)."""
    return _conv_frames(x, w, b, range(x.shape[2]), pad_mode)


def conv2d_samepad(x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-frame 2-D conv of [B, Ci, T, H, W] with w [Co, Ci, kh, kw],
    zero SAME padding (a 3-D conv with kt = 1)."""
    return _conv_frames(x, w[:, :, None], b, range(x.shape[2]), 'constant')


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               groups: int, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm of [B, C, T, H, W] over (C / groups, T, H, W) in
    float32."""
    return _group_normaliser(x, gamma, beta, groups, eps)(
        x.to(torch.float32, copy=True)).to(x.dtype)


def channel_rms_norm(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """Wan's RMS_norm of [B, C, T, H, W] (see ``_rms_``)."""
    return _rms_(x.to(torch.float32, copy=True), gamma).to(x.dtype)


def nearest_up2d(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample of [B, C, T, H, W]."""
    return F.interpolate(x, scale_factor=(1.0, 2.0, 2.0), mode='nearest')


# ------------------------------------------------- HunyuanVideo causal-3D VAE

@dataclass(frozen=True)
class HyVaeConfig:
    """Decoder shape (HF hunyuan-video VAE config: block_out_channels
    (128, 256, 512, 512), layers_per_block 2, latent 16 channels, GN
    groups 32, time x4 / space x8)."""
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 16
    out_channels: int = 3
    norm_groups: int = 32
    scaling_factor: float = 0.476986


def _hy_resnet(p: Dict, x: torch.Tensor, groups: int) -> torch.Tensor:
    """ResnetBlockCausal3D, group-norm flavour (no temb): norm, SiLU and
    conv twice (each norm applied per piece inside its conv, the second
    conv in place), plus x or its 1x1x1 shortcut conv (added in place)."""
    frames = range(x.shape[2])
    h = _conv_frames(x, p['conv1_w'], p['conv1_b'], frames, 'edge',
                     pre=_silu_after(_group_normaliser(
                         x, p['norm1_w'], p['norm1_b'], groups)))
    _conv_frames(h, p['conv2_w'], p['conv2_b'], frames, 'edge',
                 pre=_silu_after(_group_normaliser(
                     h, p['norm2_w'], p['norm2_b'], groups)), out=h)
    if 'short_w' in p:
        return _conv_frames(x, p['short_w'], p.get('short_b'), frames,
                            'edge', out=h, accumulate=True)
    return h.add_(x)


def _hy_mid_attn(p: Dict, x: torch.Tensor, groups: int) -> torch.Tensor:
    """Mid-block attention: single head, frame-causal (a query of frame t
    sees the keys of frames 0..t), residual.  One query frame at a time
    over its key frames only, in row blocks of at most ``SCORE_ELEMS``
    scores."""
    B, C, T, H, W = x.shape
    hw = H * W
    # tokens [B, T*H*W, C] in (t, h, w) order
    tok = group_norm(x, p['gn_w'], p['gn_b'], groups).flatten(2) \
        .transpose(1, 2)
    q, k, v = (F.linear(tok, p[n + '_w'], p[n + '_b']) for n in 'qkv')
    del tok
    o = torch.empty_like(q)
    for t in range(T):
        nk = (t + 1) * hw
        kt, vt = k[:, :nk].transpose(1, 2), v[:, :nk]
        for r0, r1 in _pieces(hw, B * nk, 0, SCORE_ELEMS):
            rows = slice(t * hw + r0, t * hw + r1)
            s = (q[:, rows] @ kt).float() * (C ** -0.5)
            o[:, rows] = torch.softmax(s, -1).to(x.dtype) @ vt
            del s
    o = F.linear(o, p['o_w'], p['o_b'])
    return x + o.transpose(1, 2).reshape(x.shape)


def _hy_upsample(p: Dict, x: torch.Tensor, time: bool) -> torch.Tensor:
    """UpsampleCausal3D: nearest 2x in space; with ``time`` every frame
    but the first doubled in time; then the causal conv (replicate
    padding).  Gathered and upsampled per piece."""
    T = x.shape[2]
    src = [0] + [t for t in range(1, T) for _ in range(2 if time else 1)]
    return _conv_frames(x, p['conv_w'], p['conv_b'], src, 'edge', up=True)


@torch.no_grad()
def hunyuan_vae_decode(params: Dict, z: torch.Tensor,
                       cfg: HyVaeConfig = HyVaeConfig(),
                       scale_latents: bool = True) -> torch.Tensor:
    """z [B, Cz, T, H, W] -> pixels [B, 3, 4(T-1)+1, 8H, 8W] in about
    [-1, 1], float32, on the params' device.  DecoderCausal3D: conv_in ->
    mid (res, attn, res) -> 4 up blocks (3 resnets + upsample: spatial on
    blocks 0-2, temporal on 1-2) -> GN / SiLU / conv_out.
    ``scale_latents`` divides by the VAE's scaling_factor first (in
    float32)."""
    z = z.to(device=params['conv_in_w'].device, dtype=torch.float32)
    if scale_latents:
        z = z / cfg.scaling_factor
    g = cfg.norm_groups
    x = causal_conv3d(z, params['conv_in_w'], params['conv_in_b'], 'edge')
    mid = params['mid']
    x = _hy_resnet(mid['res0'], x, g)
    x = _hy_mid_attn(mid['attn'], x, g)
    x = _hy_resnet(mid['res1'], x, g)
    n_blocks = len(cfg.block_out_channels)
    for i, blk in enumerate(params['up']):
        for rp in blk['resnets']:
            x = _hy_resnet(rp, x, g)
        if 'upsample' in blk:
            x = _hy_upsample(blk['upsample'], x,
                             time=(1 <= i < n_blocks - 1))
    return _conv_frames(x, params['conv_out_w'], params['conv_out_b'],
                        range(x.shape[2]), 'edge',
                        pre=_silu_after(_group_normaliser(
                            x, params['out_norm_w'], params['out_norm_b'],
                            g)))


def init_hunyuan_vae_decoder(generator: torch.Generator,
                             cfg: HyVaeConfig = HyVaeConfig(),
                             device: DeviceLike = 'cuda') -> Dict:
    """Random decoder params (the loader's tree and the reference's
    scales: conv weights N(0, 1 / (27 Ci)), linears N(0, 1 / C), biases
    0, norm weights 1), drawn from ``generator`` (on ``device``)."""
    dev = resolve_device(device)

    def randn(shape, scale):
        return torch.randn(shape, generator=generator, device=dev) * scale

    def zeros(c):
        return torch.zeros(c, device=dev)

    def ones(c):
        return torch.ones(c, device=dev)

    def conv(ci, co, k=3):
        return randn((co, ci, k, k, k), (ci * 27) ** -0.5), zeros(co)

    def res(ci, co):
        c1w, c1b = conv(ci, co)
        c2w, c2b = conv(co, co)
        p = {'norm1_w': ones(ci), 'norm1_b': zeros(ci),
             'conv1_w': c1w, 'conv1_b': c1b,
             'norm2_w': ones(co), 'norm2_b': zeros(co),
             'conv2_w': c2w, 'conv2_b': c2b}
        if ci != co:
            p['short_w'], p['short_b'] = conv(ci, co, k=1)
        return p

    ch = cfg.block_out_channels
    top = ch[-1]
    ciw, cib = conv(cfg.latent_channels, top)
    attn = {'gn_w': ones(top), 'gn_b': zeros(top)}
    for n in 'qkvo':
        attn[n + '_w'] = randn((top, top), top ** -0.5)
        attn[n + '_b'] = zeros(top)
    mid = {'res0': res(top, top), 'res1': res(top, top), 'attn': attn}
    up = []
    rev = list(reversed(ch))
    prev = rev[0]
    n = len(ch)
    for i in range(n):
        out = rev[i]
        blk = {'resnets': [res(prev if j == 0 else out, out)
                           for j in range(cfg.layers_per_block + 1)]}
        if i < 3 or 1 <= i < n - 1:
            uw, ub = conv(out, out)
            blk['upsample'] = {'conv_w': uw, 'conv_b': ub}
        up.append(blk)
        prev = out
    cow, cob = conv(ch[0], cfg.out_channels)
    return {'conv_in_w': ciw, 'conv_in_b': cib, 'mid': mid, 'up': up,
            'out_norm_w': ones(ch[0]), 'out_norm_b': zeros(ch[0]),
            'conv_out_w': cow, 'conv_out_b': cob}


def _sd_getter(sd: Dict[str, Any], dev: torch.device):
    def a(name):
        v = sd[name]
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.array(v, np.float32))
        return v.to(device=dev, dtype=torch.float32)
    return a


def load_hunyuan_vae_decoder(sd: Dict[str, Any],
                             cfg: HyVaeConfig = HyVaeConfig(),
                             device: DeviceLike = 'cuda') -> Dict:
    """A diffusers-style AutoencoderKLCausal3D state dict (``decoder.*``
    keys, tensors or numpy arrays) as the decode tree, weights as stored,
    float32 on ``device``."""
    a = _sd_getter(sd, resolve_device(device))

    def res(pre):
        p = {'norm1_w': a(f'{pre}.norm1.weight'),
             'norm1_b': a(f'{pre}.norm1.bias'),
             'conv1_w': a(f'{pre}.conv1.conv.weight'),
             'conv1_b': a(f'{pre}.conv1.conv.bias'),
             'norm2_w': a(f'{pre}.norm2.weight'),
             'norm2_b': a(f'{pre}.norm2.bias'),
             'conv2_w': a(f'{pre}.conv2.conv.weight'),
             'conv2_b': a(f'{pre}.conv2.conv.bias')}
        if f'{pre}.conv_shortcut.conv.weight' in sd:
            p['short_w'] = a(f'{pre}.conv_shortcut.conv.weight')
            p['short_b'] = a(f'{pre}.conv_shortcut.conv.bias')
        return p

    d = 'decoder'
    at = f'{d}.mid_block.attentions.0'
    attn = {'gn_w': a(f'{at}.group_norm.weight'),
            'gn_b': a(f'{at}.group_norm.bias')}
    for n, src in (('q', 'to_q'), ('k', 'to_k'), ('v', 'to_v'),
                   ('o', 'to_out.0')):
        attn[n + '_w'] = a(f'{at}.{src}.weight')
        attn[n + '_b'] = a(f'{at}.{src}.bias')
    mid = {'res0': res(f'{d}.mid_block.resnets.0'),
           'res1': res(f'{d}.mid_block.resnets.1'), 'attn': attn}
    up = []
    for i in range(len(cfg.block_out_channels)):
        blk = {'resnets': [res(f'{d}.up_blocks.{i}.resnets.{j}')
                           for j in range(cfg.layers_per_block + 1)]}
        u = f'{d}.up_blocks.{i}.upsamplers.0.conv.conv'
        if f'{u}.weight' in sd:
            blk['upsample'] = {'conv_w': a(f'{u}.weight'),
                               'conv_b': a(f'{u}.bias')}
        up.append(blk)
    return {'conv_in_w': a(f'{d}.conv_in.conv.weight'),
            'conv_in_b': a(f'{d}.conv_in.conv.bias'),
            'mid': mid, 'up': up,
            'out_norm_w': a(f'{d}.conv_norm_out.weight'),
            'out_norm_b': a(f'{d}.conv_norm_out.bias'),
            'conv_out_w': a(f'{d}.conv_out.conv.weight'),
            'conv_out_b': a(f'{d}.conv_out.conv.bias')}


def _read_safetensors(path: str, prefix: str = '') -> Dict[str, torch.Tensor]:
    return load_file(path, prefix)


def load_hunyuan_vae_safetensors(path: str, cfg: HyVaeConfig = HyVaeConfig(),
                                 device: DeviceLike = 'cuda') -> Dict:
    return load_hunyuan_vae_decoder(_read_safetensors(path, 'decoder.'),
                                    cfg, device)


# ------------------------------------------------------------ Wan2.1 VAE

# per-channel latent normalisation of the Wan2.1 VAE
WAN_LATENT_MEAN = (
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921)
WAN_LATENT_STD = (
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160)


@dataclass(frozen=True)
class WanVaeConfig:
    """Decoder3d shape (z_dim 16 for Wan2.1)."""
    dim: int = 128
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temporal_upsample: Tuple[bool, ...] = (False, True, True)
    out_channels: int = 3

    @property
    def dims(self):
        m = list(self.dim_mult)
        return tuple(self.dim * u for u in [m[-1]] + m[::-1])


def _wan_res(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """ResidualBlock: RMS, SiLU and conv twice (per piece, the second conv
    in place), plus x or its shortcut conv (added in place)."""
    frames = range(x.shape[2])
    h = _conv_frames(x, p['conv1_w'], p['conv1_b'], frames, 'constant',
                     pre=_silu_after(lambda q: _rms_(q, p['norm1_g'])))
    _conv_frames(h, p['conv2_w'], p['conv2_b'], frames, 'constant',
                 pre=_silu_after(lambda q: _rms_(q, p['norm2_g'])), out=h)
    if 'short_w' in p:
        return _conv_frames(x, p['short_w'], p['short_b'], frames,
                            'constant', out=h, accumulate=True)
    return h.add_(x)


def _wan_attn(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """AttentionBlock: per-frame single-head spatial attention (qkv and
    proj are 1x1 convs), residual; frames in blocks of at most
    ``SCORE_ELEMS`` scores."""
    B, C, T, H, W = x.shape
    hw = H * W
    h = channel_rms_norm(x, p['norm_g'])
    tok = h.permute(0, 2, 3, 4, 1).reshape(B * T, hw, C)
    del h
    o = torch.empty_like(tok)
    for f0, f1 in _pieces(B * T, hw * hw, 0, SCORE_ELEMS):
        q, k, v = F.linear(tok[f0:f1], p['qkv_w'].flatten(1),
                           p['qkv_b']).chunk(3, -1)
        s = (q @ k.transpose(1, 2)).float() * (C ** -0.5)
        o[f0:f1] = torch.softmax(s, -1).to(x.dtype) @ v
        del q, k, v, s
    o = F.linear(o, p['proj_w'].flatten(1), p['proj_b'])
    return x + o.reshape(B, T, H, W, C).permute(0, 4, 1, 2, 3)


def _wan_upsample(p: Dict, x: torch.Tensor, temporal: bool) -> torch.Tensor:
    """Resample upsample2d / upsample3d.  The full-sequence form of the
    reference's cached time path: the first frame passes, frames 2..T
    run a causal (3, 1, 1) conv to 2C channels whose halves are the even
    and odd frame of each pair, interleaved along time; then nearest 2x
    in space and the 3x3 conv (per piece)."""
    B, C, T, H, W = x.shape
    if temporal and T > 1:
        y = _conv_frames(x, p['time_w'], p['time_b'], range(1, T),
                         'constant')                        # [B,2C,T-1,H,W]
        z = x.new_empty(B, C, 2 * T - 1, H, W)
        z[:, :, :1] = x[:, :, :1]
        z[:, :, 1:].view(B, C, T - 1, 2, H, W).copy_(
            y.view(B, 2, C, T - 1, H, W).permute(0, 2, 3, 1, 4, 5))
        del y
        x = z
    return _conv_frames(x, p['conv_w'][:, :, None], p['conv_b'],
                        range(x.shape[2]), 'constant', up=True)


@torch.no_grad()
def wan_vae_decode(params: Dict, z: torch.Tensor,
                   cfg: WanVaeConfig = WanVaeConfig(),
                   scale_latents: bool = True) -> torch.Tensor:
    """z [B, Cz, T, H, W] -> pixels [B, 3, 4(T-1)+1, 8H, 8W] clamped to
    [-1, 1], float32, on the params' device.  ``scale_latents`` applies
    z * std + mean (inverting the encoder's normalisation)."""
    dev = params['conv1_w'].device
    z = z.to(device=dev, dtype=torch.float32)
    if scale_latents:
        mean = torch.tensor(WAN_LATENT_MEAN[:cfg.z_dim], device=dev)
        std = torch.tensor(WAN_LATENT_STD[:cfg.z_dim], device=dev)
        z = z * std[:, None, None, None] + mean[:, None, None, None]
    # conv2 (the z-space 1x1x1) then the decoder proper
    x = causal_conv3d(z, params['conv2_w'], params['conv2_b'])
    x = causal_conv3d(x, params['conv1_w'], params['conv1_b'])
    x = _wan_res(params['mid_res0'], x)
    x = _wan_attn(params['mid_attn'], x)
    x = _wan_res(params['mid_res1'], x)
    for i, blk in enumerate(params['up']):
        for rp in blk['resnets']:
            x = _wan_res(rp, x)
        if 'upsample' in blk:
            x = _wan_upsample(blk['upsample'], x, cfg.temporal_upsample[i])
    x = _conv_frames(x, params['head_w'], params['head_b'], range(x.shape[2]),
                     'constant', pre=_silu_after(
                         lambda q: _rms_(q, params['head_norm_g'])))
    return x.clamp_(-1.0, 1.0)


def init_wan_vae_decoder(generator: torch.Generator,
                         cfg: WanVaeConfig = WanVaeConfig(),
                         device: DeviceLike = 'cuda') -> Dict:
    """Random decoder params (the loader's tree and the reference's
    scales: conv weights N(0, 1 / fan_in), the attention's proj zero, as
    the reference initialises it, biases 0, gammas 1), drawn from
    ``generator`` (on ``device``)."""
    dev = resolve_device(device)

    def conv(ci, co, k=(3, 3, 3)):
        fan = ci * int(np.prod(k))
        return (torch.randn((co, ci) + tuple(k), generator=generator,
                            device=dev) * fan ** -0.5,
                torch.zeros(co, device=dev))

    def ones(c):
        return torch.ones(c, device=dev)

    def res(ci, co):
        c1w, c1b = conv(ci, co)
        c2w, c2b = conv(co, co)
        p = {'norm1_g': ones(ci), 'conv1_w': c1w, 'conv1_b': c1b,
             'norm2_g': ones(co), 'conv2_w': c2w, 'conv2_b': c2b}
        if ci != co:
            p['short_w'], p['short_b'] = conv(ci, co, k=(1, 1, 1))
        return p

    dims = cfg.dims
    d0 = dims[0]
    c2w, c2b = conv(cfg.z_dim, cfg.z_dim, k=(1, 1, 1))
    c1w, c1b = conv(cfg.z_dim, d0)
    qkvw, qkvb = conv(d0, 3 * d0, k=(1, 1))
    params = {'conv2_w': c2w, 'conv2_b': c2b,
              'conv1_w': c1w, 'conv1_b': c1b,
              'mid_res0': res(d0, d0), 'mid_res1': res(d0, d0),
              'mid_attn': {'norm_g': ones(d0), 'qkv_w': qkvw, 'qkv_b': qkvb,
                           'proj_w': torch.zeros((d0, d0, 1, 1), device=dev),
                           'proj_b': torch.zeros(d0, device=dev)}}
    up = []
    n = len(cfg.dim_mult)
    for i, (ci, co) in enumerate(zip(dims[:-1], dims[1:])):
        if i >= 1:
            ci = ci // 2     # the previous Resample conv halved the channels
        blk = {'resnets': [res(ci if j == 0 else co, co)
                           for j in range(cfg.num_res_blocks + 1)]}
        if i != n - 1:
            cw, cb = conv(co, co // 2, k=(3, 3))
            u = {'conv_w': cw, 'conv_b': cb}
            if cfg.temporal_upsample[i]:
                u['time_w'], u['time_b'] = conv(co, co * 2, k=(3, 1, 1))
            blk['upsample'] = u
        up.append(blk)
    params['up'] = up
    params['head_norm_g'] = ones(dims[-1])
    params['head_w'], params['head_b'] = conv(dims[-1], cfg.out_channels)
    return params


def load_wan_vae_decoder(sd: Dict[str, Any],
                         cfg: WanVaeConfig = WanVaeConfig(),
                         device: DeviceLike = 'cuda') -> Dict:
    """A WanVAE_ state dict (``decoder.*`` and ``conv2.*`` keys, tensors
    or numpy arrays) as the decode tree: weights as stored, the RMS
    gammas [C, 1, 1(, 1)] as [C], float32 on ``device``."""
    a = _sd_getter(sd, resolve_device(device))

    def conv(name):
        return a(f'{name}.weight'), a(f'{name}.bias')

    def gamma(name):
        return a(f'{name}.gamma').reshape(-1)

    def res(pre):
        p = {'norm1_g': gamma(f'{pre}.residual.0'),
             'norm2_g': gamma(f'{pre}.residual.3')}
        p['conv1_w'], p['conv1_b'] = conv(f'{pre}.residual.2')
        p['conv2_w'], p['conv2_b'] = conv(f'{pre}.residual.6')
        if f'{pre}.shortcut.weight' in sd:
            p['short_w'], p['short_b'] = conv(f'{pre}.shortcut')
        return p

    d = 'decoder'
    params = {'mid_res0': res(f'{d}.middle.0'),
              'mid_res1': res(f'{d}.middle.2'),
              'mid_attn': {'norm_g': gamma(f'{d}.middle.1.norm')}}
    params['conv2_w'], params['conv2_b'] = conv('conv2')
    params['conv1_w'], params['conv1_b'] = conv(f'{d}.conv1')
    at = params['mid_attn']
    at['qkv_w'], at['qkv_b'] = conv(f'{d}.middle.1.to_qkv')
    at['proj_w'], at['proj_b'] = conv(f'{d}.middle.1.proj')
    up = []
    n = len(cfg.dim_mult)
    k = 0
    for i in range(n):
        blk = {'resnets': [res(f'{d}.upsamples.{k + j}')
                           for j in range(cfg.num_res_blocks + 1)]}
        k += cfg.num_res_blocks + 1
        if i != n - 1:
            u = {}
            u['conv_w'], u['conv_b'] = conv(f'{d}.upsamples.{k}.resample.1')
            if cfg.temporal_upsample[i]:
                u['time_w'], u['time_b'] = conv(
                    f'{d}.upsamples.{k}.time_conv')
            blk['upsample'] = u
            k += 1
        up.append(blk)
    params['up'] = up
    params['head_norm_g'] = gamma(f'{d}.head.0')
    params['head_w'], params['head_b'] = conv(f'{d}.head.2')
    return params


def load_wan_vae(path: str, cfg: WanVaeConfig = WanVaeConfig(),
                 device: DeviceLike = 'cuda') -> Dict:
    """The Wan VAE checkpoint: a ``.pth`` state dict (torch.load) or
    ``.safetensors`` (``utils/safetensors_io``)."""
    if path.endswith('.safetensors'):
        sd = _read_safetensors(path)
    else:
        sd = torch.load(path, map_location='cpu', weights_only=True)
    return load_wan_vae_decoder(sd, cfg, device)


# -------------------------------------------- the reference's trees

def _tree_from_jax(np_params: Dict, dev: torch.device, leaf) -> Any:
    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [conv(v) for v in tree]
        return leaf(torch.from_numpy(np.array(tree, np.float32))) \
            .contiguous().to(dev)
    return conv(np_params)


def _weight_from_jax(t: torch.Tensor) -> torch.Tensor:
    """DHWIO -> OIDHW, HWIO -> OIHW, [in, out] -> [out, in]; vectors as
    they are."""
    if t.ndim == 5:
        return t.permute(4, 3, 0, 1, 2)
    if t.ndim == 4:
        return t.permute(3, 2, 0, 1)
    return t.t() if t.ndim == 2 else t


def hunyuan_vae_params_from_jax(np_params: Dict,
                                device: DeviceLike = 'cuda') -> Dict:
    """The reference's HunyuanVideo VAE decoder tree (numpy leaves,
    channels-last: DHWIO convs, [in, out] linears) as the port's tree
    (OIDHW convs, [out, in] linears), float32 on ``device``."""
    return _tree_from_jax(np_params, resolve_device(device),
                          _weight_from_jax)


def wan_vae_params_from_jax(np_params: Dict,
                            device: DeviceLike = 'cuda') -> Dict:
    """The reference's Wan VAE decoder tree (numpy leaves, channels-last)
    as the port's tree: OIDHW 3-D and OIHW 2-D convs, the attention's
    [in, out] qkv / proj as the checkpoint's 1x1 conv weights [out, in,
    1, 1], float32 on ``device``."""
    def leaf(t):
        t = _weight_from_jax(t)
        return t[:, :, None, None] if t.ndim == 2 else t
    return _tree_from_jax(np_params, resolve_device(device), leaf)
