"""Wan2.1 text-to-video generation from the command line on the port, the
twin of ``examples/wan_generate.py`` (same flags and defaults, plus
``--device``): load the chipmunk config (two model invocations a step),
run the classifier-free-guidance denoise loop, write the latents as
float32 ``.npy`` (or, with ``--vae``, the uint8 frames).

    python -m chipmunk_torch.cli.wan_generate --ckpt wan2.1.safetensors \\
        --chipmunk-config configs/wan-chipmunk.yml
    python -m chipmunk_torch.cli.wan_generate --device cpu --tiny --layers 2 \\
        --steps 4 --size 128 128 --frames 5

Wan has no streamed runner (the JAX package has none): offloading keys
in the config are reported and ignored, as the JAX CLI does.  With
``--umt5`` (the encoder's ``.pth`` or ``.safetensors``) and
``--tokenizer`` (a local tokenizer directory), ``--prompt`` and
``--neg-prompt`` are encoded (``WanTextEncoder``) and the encoder is
released before the loop; a prompt without them warns and the text is
zeros.  A config with ``should_profile`` and ``generation_index >= 3``
traces the loop into ``./profiles``.  ``--mesh dp=a,sp=b`` runs the
model sharded (``WanModel.sharded``) on a world of a*b ranks started by
torchrun or the multi-host flags, as the HunyuanVideo twin does; rank 0
alone prints and writes:

    torchrun --nproc-per-node 2 -m chipmunk_torch.cli.wan_generate \
        --mesh sp=2
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import torch

from ..config import config_from_dict
from ..device import DeviceLike, resolve_device
from ..models import (WanModel, WanModelConfig, WanTextEncoder,
                      get_schedule, init_wan_params, load_wan_safetensors,
                      wan_denoise, wan_denoise_compiled)
from ..utils.offload import OffloadPolicy
from ..utils.profiling import profile_region
from . import (PROFILE_DIR, finish, is_main, model_dtype, noise, read_config,
               save_frames, save_latents, say, setup_parallel, warn)
from .hunyuan_generate import add_parallel_flags

OFFLOAD_KEYS = ('attn_out_cache', 'attn_indices', 'attn_counts',
                'mlp_out_cache', 'mlp_act_cache')


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog='python -m chipmunk_torch.cli.'
                                      'wan_generate')
    ap.add_argument('--chipmunk-config', default=None)
    ap.add_argument('--size', nargs=2, type=int, default=[480, 832])
    ap.add_argument('--frames', type=int, default=81)
    ap.add_argument('--steps', type=int, default=50)
    ap.add_argument('--guide-scale', type=float, default=5.0)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--layers', type=int, default=30)
    ap.add_argument('--ckpt', default=None,
                    help='transformer .safetensors path (optional; random '
                         'weights otherwise)')
    ap.add_argument('--vae', default=None,
                    help='Wan VAE checkpoint (.pth/.safetensors); decodes '
                         'the latents to frames. "random" decodes with '
                         'random weights.')
    ap.add_argument('--umt5', default=None,
                    help='UMT5-XXL encoder checkpoint (.pth/.safetensors)')
    ap.add_argument('--tokenizer', default=None,
                    help='local UMT5 tokenizer directory')
    ap.add_argument('--prompt', default=None)
    ap.add_argument('--neg-prompt', default='')
    ap.add_argument('--tiny', action='store_true',
                    help='dim 256, 2 heads, ffn 1024, 32 text tokens '
                         '(pipeline demo; head_dim 128)')
    ap.add_argument('--out', default='wan_latents.npy')
    add_parallel_flags(ap)
    ap.add_argument('--loop', default='host', choices=['host', 'compiled'],
                    help='host = one eager step at a time; compiled = '
                         'skipped steps folded, each computed step a CUDA '
                         'graph replay on the card')
    ap.add_argument('--chunk', type=int, default=None,
                    help='with --loop compiled: computed steps per window '
                         '(None = the whole loop as one window)')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu' for the plain versions")
    return ap


def model_config(size=(480, 832), frames: int = 81, layers: int = 30,
                 tiny: bool = False, device: DeviceLike = 'cuda'
                 ) -> WanModelConfig:
    h, w = size
    kw = dict(dim=256, num_heads=2, ffn_dim=1024, txt_len=32) if tiny \
        else {}
    return WanModelConfig(latent_t=(frames - 1) // 4 + 1, latent_h=h // 8,
                          latent_w=w // 8, num_layers=layers,
                          dtype=model_dtype(resolve_device(device)), **kw)


def generate(model: WanModel, params: Dict, *, seed: int = 0,
             ctx_cond: Optional[torch.Tensor] = None,
             ctx_uncond: Optional[torch.Tensor] = None,
             latents: Optional[torch.Tensor] = None,
             guide_scale: float = 5.0, loop: str = 'host',
             chunk: Optional[int] = None) -> torch.Tensor:
    """One generation over ``model.ck.steps`` steps: the latent [1, C, T,
    H, W] (float32).  ``latents`` (else a normal draw from ``seed``) is
    the noise, ``ctx_cond``/``ctx_uncond`` the text (else zeros); both
    invocations' random keeps are drawn from ``seed`` on the model's
    device."""
    cfg, dev = model.cfg, model.device
    if latents is None:
        latents = noise((1, cfg.in_channels, cfg.latent_t, cfg.latent_h,
                         cfg.latent_w), seed, cfg.dtype, dev)
    zeros = torch.zeros((1, cfg.txt_len, cfg.text_dim), dtype=cfg.dtype,
                        device=dev)
    ctx_c = zeros if ctx_cond is None else ctx_cond
    ctx_u = zeros if ctx_uncond is None else ctx_uncond
    ts = get_schedule(model.ck.steps, cfg.seq_len, shift=False)
    gen = torch.Generator(dev).manual_seed(seed)
    if loop == 'compiled':
        return wan_denoise_compiled(model, params, latents, ctx_c, ctx_u, ts,
                                    guide_scale=guide_scale, generator=gen,
                                    chunk=chunk)
    return wan_denoise(model, params, latents, ctx_c, ctx_u, ts,
                       guide_scale=guide_scale, generator=gen)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    ck = read_config(args.chipmunk_config, args.steps, config_from_dict(
        {'num_model_invocations_per_inference_step': 2}))
    policy = OffloadPolicy.from_config(ck.offloading)
    wanted = [n for n in OFFLOAD_KEYS if policy.wants_host(n)]
    if wanted:
        warn(f'offloading keys {wanted} are ignored for Wan (no streamed '
             f'runner; see the configs/wan-chipmunk.yml note)')
    dev = resolve_device(args.device)
    cfg = model_config(args.size, args.frames, args.layers, args.tiny, dev)
    mesh = setup_parallel(args, dev, cfg.num_heads)
    model = WanModel(cfg=cfg, ck=ck, device=dev)
    if mesh is not None:
        model = model.sharded(mesh, sp='sp', dp='dp'
                              if 'dp' in mesh.mesh_dim_names else None)
        say(f'mesh {args.mesh}: Ulysses head-parallel self-attention over '
            f'sp, rank {mesh.get_rank()} of {mesh.size()}')
    if args.ckpt:
        params = load_wan_safetensors(args.ckpt, cfg, device=dev)
    else:
        say('no --ckpt given: using random weights (pipeline demo mode)')
        params = init_wan_params(torch.Generator(dev).manual_seed(1), cfg,
                                 dev)
    ctx_c = ctx_u = None
    if args.prompt and args.umt5 and args.tokenizer:
        enc = WanTextEncoder(args.umt5, args.tokenizer, text_len=cfg.txt_len,
                             dtype=cfg.dtype, device=dev)
        ctx = enc.embed([args.prompt, args.neg_prompt])
        enc.release()      # the encoder's weights go before the loop
        ctx_c, ctx_u = ctx[:1].to(cfg.dtype), ctx[1:].to(cfg.dtype)
    elif args.prompt:
        warn('--prompt given without --umt5/--tokenizer; using zero '
             'embeddings')
    t0 = time.perf_counter()
    # the reference's profiler gate: should_profile and generation_index
    # >= 3 (one generation per process)
    with profile_region(PROFILE_DIR, enabled=ck.should_profile,
                        warmup_done=ck.generation_index >= 3):
        out = generate(model, params, seed=args.seed, ctx_cond=ctx_c,
                       ctx_uncond=ctx_u, guide_scale=args.guide_scale,
                       loop=args.loop, chunk=args.chunk)
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
    say(f'done in {time.perf_counter() - t0:.1f}s')
    if not is_main():
        finish()
        return 0
    if args.vae:
        from ..models import (WanVaeConfig, init_wan_vae_decoder,
                              load_wan_vae, wan_vae_decode)
        vcfg = WanVaeConfig()
        vp = (init_wan_vae_decoder(torch.Generator(dev).manual_seed(7), vcfg,
                                   dev)
              if args.vae == 'random' else load_wan_vae(args.vae, vcfg, dev))
        save_frames(wan_vae_decode(vp, out, vcfg), args.out)
    else:
        save_latents(out, args.out)
        print(f'latents -> {args.out}')
    finish()
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
