"""FLUX image generation from the command line on the port, the twin of
``examples/flux_generate.py`` (same flags and defaults, plus ``--device``):
load the chipmunk config, round the resolution to 128 pixels, load the
checkpoint (or draw random weights), run the 50-step denoise loop, write
the latents as float32 ``.npy`` and, with ``--ae``, the pixels.

    python -m chipmunk_torch.cli.flux_generate --ckpt flux1-dev.safetensors \\
        --chipmunk-config configs/flux-chipmunk.yml
    python -m chipmunk_torch.cli.flux_generate --device cpu --tiny \\
        --depth 1 --depth-single 1 --steps 4 --width 256 --height 256

Without ``--ckpt`` the weights are random (and say so); without prompts
the text is zeros.  ``--prompt`` needs ``--t5`` and ``--clip`` (local
checkpoint directories with their tokenizers; ``'|'`` separates the
prompts of a batch).  ``--profile``, or a config with ``should_profile``
and ``generation_index >= 3``, traces the denoise loop into
``./profiles`` with the program's spans on the host's row
(``utils/profiling.py``); the ``denoise`` line reads the tracer's record.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import (FluxModelConfig, FluxSampler, FluxSparse,
                      get_schedule, init_flux_params, load_flux_safetensors)
from ..utils.profiling import StepTimer, profile_region, span
from . import PROFILE_DIR, model_dtype, noise, read_config, save_latents, warn


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog='python -m chipmunk_torch.cli.'
                                      'flux_generate')
    ap.add_argument('--chipmunk-config', default=None)
    ap.add_argument('--width', type=int, default=1280)
    ap.add_argument('--height', type=int, default=768)
    ap.add_argument('--steps', type=int, default=50)
    ap.add_argument('--guidance', type=float, default=4.0)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--t5', default=None,
                    help='local T5-v1.1-XXL encoder dir (HF safetensors and '
                         'tokenizer)')
    ap.add_argument('--clip', default=None,
                    help='local CLIP-L text dir (HF safetensors and '
                         'tokenizer)')
    ap.add_argument('--ae', default=None,
                    help='local ae.safetensors for the pixel decode')
    ap.add_argument('--prompt', default=None)
    ap.add_argument('--ckpt', default=None,
                    help='flux1-dev.safetensors path (optional)')
    ap.add_argument('--depth', type=int, default=19)
    ap.add_argument('--depth-single', type=int, default=38)
    ap.add_argument('--batch', type=int, default=1,
                    help='images per generation, each with its own noise, '
                         'selections and caches')
    ap.add_argument('--profile', action='store_true')
    ap.add_argument('--tiny', action='store_true',
                    help='hidden 256, 2 heads, 128 text tokens (pipeline '
                         'demo; head_dim 128)')
    ap.add_argument('--out', default='flux_latents.npy')
    ap.add_argument('--loop', default='host', choices=['host', 'compiled'],
                    help='host = one eager step at a time; compiled = '
                         'skipped steps folded, each computed step a CUDA '
                         'graph replay on the card')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu' for the plain versions")
    return ap


def model_config(depth: int = 19, depth_single: int = 38, tiny: bool = False,
                 device: DeviceLike = 'cuda') -> FluxModelConfig:
    """FLUX.1-dev (or ``--tiny``'s cut) in the device's dtype."""
    kw = dict(hidden_size=256, num_heads=2, txt_len=128) if tiny else {}
    return FluxModelConfig(depth=depth, depth_single_blocks=depth_single,
                           dtype=model_dtype(resolve_device(device)), **kw)


def random_params(model: FluxModelConfig, ck, device: DeviceLike = 'cuda'
                  ) -> Dict:
    """Random weights from seed 1; under ``mlp.is_fp8`` stored as the
    checkpoint path stores them."""
    dev = resolve_device(device)
    params = init_flux_params(torch.Generator(dev).manual_seed(1), model,
                              dev)
    if ck.mlp.is_fp8:
        from ..modules.mlp_fp8 import quant_spec_for_is_fp8
        from ..utils.quant import quantize_flux_params
        params = quantize_flux_params(params, quant_spec_for_is_fp8())
    return params


def generate(params: Dict, model: FluxModelConfig, ck, *,
             width: int = 1280, height: int = 768, guidance: float = 4.0,
             seed: int = 0, batch: int = 1,
             txt: Optional[torch.Tensor] = None,
             y: Optional[torch.Tensor] = None,
             img: Optional[torch.Tensor] = None, loop: str = 'host',
             device: DeviceLike = 'cuda') -> torch.Tensor:
    """One generation over ``ck.steps`` steps: latent tokens [B, h*w, 64]
    (float32, patch order undone) for a width x height image (multiples
    of 16).  ``img`` (else a normal draw from ``seed``) is the noise,
    ``txt``/``y`` the text (else zeros); the random keeps are drawn from
    ``seed`` on the device.  The call is the span ``generate``, its
    set-up before the loop (here and in the sampler) ``generate.setup``."""
    with span('generate'):
        dev = resolve_device(device)
        with span('generate.setup'):
            h_img, w_img = height // 16, width // 16
            B = max(1, batch)
            sp = FluxSparse.build(ck, model, model.txt_len + h_img * w_img,
                                  batch=B)
            sampler = FluxSampler(cfg=model, ck=ck, sp=sp, h_img=h_img,
                                  w_img=w_img,
                                  use_patchify=ck.patchify.is_enabled,
                                  device=dev)
            if img is None:
                img = noise((B, h_img * w_img, 64), seed, model.dtype, dev)
            if txt is None:
                txt = torch.zeros((B, model.txt_len, model.context_in_dim),
                                  dtype=model.dtype, device=dev)
            if y is None:
                y = torch.zeros((B, model.vec_in_dim), dtype=model.dtype,
                                device=dev)
            ts = get_schedule(ck.steps, h_img * w_img)
            gen = torch.Generator(dev).manual_seed(seed)
        den = sampler.denoise_compiled if loop == 'compiled' \
            else sampler.denoise
        return den(params, img, txt, y, ts, guidance=guidance, generator=gen)


def encode_prompts(args, model: FluxModelConfig, B: int, dev):
    """(txt, y) of ``--prompt`` through T5 and CLIP; the last prompt fills
    the batch."""
    from ..models import TextEncoders
    enc = TextEncoders(t5_path=args.t5, clip_path=args.clip,
                       max_length=model.txt_len, dtype=model.dtype,
                       device=dev)
    prompts = [p.strip() for p in args.prompt.split('|')]
    if len(prompts) > B:
        warn(f'{len(prompts)} prompts but --batch {B}; dropping the last '
             f'{len(prompts) - B}')
    txt, y = enc.embed((prompts + [prompts[-1]] * B)[:B])
    enc.release()
    return txt, y


def decode_to_images(args, out: torch.Tensor, width: int, height: int,
                     dev) -> None:
    from ..models import decode, load_ae_decoder_safetensors, unpack
    ae = load_ae_decoder_safetensors(args.ae, device=dev)
    pix = decode(ae, unpack(out.float(), height, width)).float().cpu()
    stem = args.out.rsplit('.', 1)[0]
    for bi in range(pix.shape[0]):
        arr = ((pix[bi].permute(1, 2, 0) + 1) * 127.5).clamp(0, 255) \
            .to(torch.uint8).numpy()
        png = f'{stem}.png' if pix.shape[0] == 1 else f'{stem}_{bi}.png'
        try:
            from PIL import Image
            Image.fromarray(arr).save(png)
            print(f'image -> {png}')
        except ImportError:
            np.save(png + '.npy', arr)
            print(f'image array -> {png}.npy')


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.prompt and not (args.t5 and args.clip):
        raise SystemExit('--prompt needs --t5 and --clip (local encoder '
                         'checkpoints); without them the text would be '
                         'zeros')
    ck = read_config(args.chipmunk_config, args.steps)
    dev = resolve_device(args.device)
    width = args.width - args.width % 128
    height = args.height - args.height % 128
    model = model_config(args.depth, args.depth_single, args.tiny, dev)
    B = max(1, args.batch)
    t0 = time.perf_counter()
    if args.ckpt:
        params = load_flux_safetensors(args.ckpt, model, ck=ck, device=dev)
        print(f'loaded {args.ckpt} in {time.perf_counter() - t0:.1f} s')
    else:
        print('no --ckpt given: using random weights (pipeline demo mode)')
        params = random_params(model, ck, dev)
    txt = y = None
    if args.prompt:
        txt, y = encode_prompts(args, model, B, dev)
    # --profile traces this generation; the config's keys follow the
    # reference's gate (should_profile and generation_index >= 3)
    timer = StepTimer()
    with profile_region(PROFILE_DIR, enabled=args.profile or
                        ck.should_profile,
                        warmup_done=args.profile or
                        ck.generation_index >= 3) as prof:
        with timer.span('denoise', sync=dev):
            out = generate(params, model, ck, width=width, height=height,
                           guidance=args.guidance, seed=args.seed, batch=B,
                           txt=txt, y=y, loop=args.loop, device=dev)
    if prof is not None:
        print(f'profile trace -> {PROFILE_DIR}')
    print(f'denoise {timer.records["denoise"][0]:.3f} s ({args.loop} loop)')
    if args.ae:
        decode_to_images(args, out, width, height, dev)
    save_latents(out, args.out)
    print(f'latents -> {args.out}  ({width}x{height}, {args.steps} steps)')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
