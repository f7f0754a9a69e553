"""HunyuanVideo generation from the command line on the port, the twin of
``examples/hunyuan_generate.py`` (same flags and defaults, plus
``--device``): load the chipmunk config, build the model, denoise with
its full-step schedule and step caching, write the latents as float32
``.npy`` (or, with ``--vae``, the uint8 frames).

    python -m chipmunk_torch.cli.hunyuan_generate --ckpt hunyuan.safetensors \\
        --chipmunk-config configs/hunyuan-chipmunk.yml
    python -m chipmunk_torch.cli.hunyuan_generate --device cpu --tiny \\
        --depth 1 --depth-single 2 --steps 4 --video-size 128 128 \\
        --video-length 5

The config's ``offloading:`` block is honoured as the JAX CLI honours
it: when the policy offloads a cache the streamed runner
(``HunyuanModel.make_streamed``) runs, else the compiled loop.  With
``--llm`` and ``--clip`` (local LLaVA-LLaMA-3 and CLIP-L directories, each
with its tokenizer) ``--prompt`` and every ``--interactive`` prompt are
encoded (``HunyuanTextEncoders``, kept across prompts); a prompt without
them warns and the text is zeros.  A config with ``should_profile``
traces each generation from the fourth (its ``generation_index`` counts
up per generation) into ``./profiles``.

``--mesh dp=a,sp=b`` runs the model sharded (``HunyuanModel.sharded``:
Ulysses attention over ``sp``, the batch over ``dp``) on a world of a*b
ranks, one process a card, started by torchrun or by the multi-host
flags (``--multihost --coordinator host:port --num-processes N
--process-id i``); rank 0 alone prints and writes.  The streamed runner
has no mesh path: ``--mesh`` with a config that offloads exits non-zero,
and without ``--chipmunk-config`` the default config's offloading is
dropped.

    torchrun --nproc-per-node 2 -m chipmunk_torch.cli.hunyuan_generate \
        --mesh sp=2
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..models import (VIDEO_CROP_START, HunyuanModel, HunyuanModelConfig,
                      HunyuanTextEncoders, get_schedule, hunyuan_denoise,
                      hunyuan_denoise_compiled, init_hunyuan_params,
                      load_hunyuan_safetensors)
from ..models.sampling import STREAMED_NO_MESH
from ..utils.offload import OffloadPolicy
from ..utils.profiling import profile_region
from . import (PROFILE_DIR, finish, is_main, model_dtype, noise, read_config,
               save_frames, save_latents, say, setup_parallel, warn)

OFFLOADED = ('attn_out_cache', 'attn_indices', 'mlp_out_cache',
             'mlp_act_cache')


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog='python -m chipmunk_torch.cli.'
                                      'hunyuan_generate')
    ap.add_argument('--chipmunk-config', default=None)
    ap.add_argument('--video-size', nargs=2, type=int, default=[720, 1280])
    ap.add_argument('--video-length', type=int, default=129)
    ap.add_argument('--steps', type=int, default=50)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--depth', type=int, default=20)
    ap.add_argument('--depth-single', type=int, default=40)
    ap.add_argument('--ckpt', default=None,
                    help='transformer .safetensors path (optional; random '
                         'weights otherwise)')
    ap.add_argument('--vae', default=None,
                    help='causal-3D VAE .safetensors path; decodes the '
                         'latents to frames. "random" decodes with random '
                         'weights.')
    ap.add_argument('--llm', default=None,
                    help='local LLaVA-LLaMA-3-8B language-model directory '
                         '(config.json, safetensors, tokenizer)')
    ap.add_argument('--clip', default=None,
                    help='local CLIP-L text directory (safetensors, '
                         'tokenizer)')
    ap.add_argument('--prompt', default=None)
    ap.add_argument('--out', default='hunyuan_latents.npy')
    ap.add_argument('--tiny', action='store_true',
                    help='hidden 256, 2 heads, 32 text tokens (pipeline '
                         'demo; head_dim 128)')
    add_parallel_flags(ap)
    ap.add_argument('--interactive', action='store_true',
                    help='after the first generation, read prompts from '
                         'stdin (each needs the text encoders)')
    ap.add_argument('--chunk', type=int, default=None,
                    help='computed steps per window of the compiled loop '
                         '(None = the whole loop as one window)')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu' for the plain versions")
    return ap


def add_parallel_flags(ap: argparse.ArgumentParser) -> None:
    """The multi-host flags and ``--mesh``, as the JAX twins take them."""
    ap.add_argument('--multihost', action='store_true',
                    help='join a process group of --num-processes ranks '
                         'meeting at --coordinator (host:port of rank 0)')
    ap.add_argument('--coordinator', default=None)
    ap.add_argument('--num-processes', type=int, default=None)
    ap.add_argument('--process-id', type=int, default=None)
    ap.add_argument('--mesh', default=None,
                    help='"sp=N" or "dp=M,sp=N": Ulysses head-parallel '
                         'attention over sp (which must divide the '
                         'heads), the batch over dp; needs a world of '
                         'M*N ranks (torchrun or --multihost)')


def model_config(video_size=(720, 1280), video_length: int = 129,
                 depth: int = 20, depth_single: int = 40, tiny: bool = False,
                 device: DeviceLike = 'cuda') -> HunyuanModelConfig:
    h, w = video_size
    kw = dict(hidden_size=256, num_heads=2, txt_len=32) if tiny else {}
    return HunyuanModelConfig(
        latent_t=(video_length - 1) // 4 + 1, latent_h=h // 8,
        latent_w=w // 8, depth_double=depth, depth_single=depth_single,
        dtype=model_dtype(resolve_device(device)), **kw)


def wants_streamed(ck) -> bool:
    """Whether the config's offloading block keeps a cache in host
    memory, as the JAX CLI decides it."""
    policy = OffloadPolicy.from_config(ck.offloading)
    return policy.enabled and any(policy.wants_host(n) for n in OFFLOADED)


def generate(model: HunyuanModel, params: Dict, *, seed: int = 0,
             txt: Optional[torch.Tensor] = None,
             y: Optional[torch.Tensor] = None,
             txt_mask: Optional[torch.Tensor] = None,
             latents: Optional[torch.Tensor] = None, streamed=None,
             compiled: bool = True, chunk: Optional[int] = None
             ) -> torch.Tensor:
    """One generation over ``model.ck.steps`` steps: the latent [1, C, T,
    H, W] (float32).  ``latents`` (else a normal draw from ``seed``) is
    the noise, ``txt``/``y`` the text (else zeros) and ``txt_mask`` its
    valid rows (else all); the random keeps are
    drawn from ``seed`` on the model's device.  ``streamed`` =
    ``model.make_streamed()`` runs the host loop over host-offloaded
    caches; else the compiled loop (``compiled``) or the host loop."""
    cfg, dev = model.cfg, model.device
    if latents is None:
        latents = noise((1, cfg.in_channels, cfg.latent_t, cfg.latent_h,
                         cfg.latent_w), seed, cfg.dtype, dev)
    if txt is None:
        txt = torch.zeros((1, cfg.txt_len, cfg.text_dim), dtype=cfg.dtype,
                          device=dev)
    if y is None:
        y = torch.zeros((1, cfg.vec_in_dim), dtype=cfg.dtype, device=dev)
    ts = get_schedule(model.ck.steps, cfg.img_len, shift=False)
    gen = torch.Generator(dev).manual_seed(seed)
    if streamed is not None or not compiled:
        return hunyuan_denoise(model, params, latents, txt, y, ts,
                               generator=gen, streamed=streamed,
                               txt_mask=txt_mask)
    return hunyuan_denoise_compiled(model, params, latents, txt, y, ts,
                                    generator=gen, txt_mask=txt_mask,
                                    chunk=chunk)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    ck = read_config(args.chipmunk_config, args.steps)
    if args.mesh:
        if not args.chipmunk_config:
            # the implicit default offloads the attention caches; with a
            # mesh the caches shard over sp instead
            ck = ck.replace(offloading=dataclasses.replace(
                ck.offloading, global_disable_offloading=True))
        elif wants_streamed(ck):
            raise SystemExit(f'--mesh: {STREAMED_NO_MESH}')
    dev = resolve_device(args.device)
    cfg = model_config(args.video_size, args.video_length, args.depth,
                       args.depth_single, args.tiny, dev)
    mesh = setup_parallel(args, dev, cfg.num_heads)
    if args.interactive and mesh is not None and mesh.size() > 1:
        raise SystemExit('--interactive reads its prompts in one process: '
                         'run it on a mesh of one rank')
    model = HunyuanModel(cfg=cfg, ck=ck, device=dev)
    if mesh is not None:
        model = model.sharded(mesh, sp='sp', dp='dp'
                              if 'dp' in mesh.mesh_dim_names else None)
        say(f'mesh {args.mesh}: Ulysses head-parallel attention over sp, '
            f'rank {mesh.get_rank()} of {mesh.size()}')
    if args.ckpt:
        params = load_hunyuan_safetensors(args.ckpt, cfg, device=dev)
    else:
        say('no --ckpt given: using random weights (pipeline demo mode)')
        params = init_hunyuan_params(torch.Generator(dev).manual_seed(1),
                                     cfg, dev)
    # the text encoders stay loaded across --interactive prompts
    enc = None
    if args.llm and args.clip:
        enc = HunyuanTextEncoders(llm_path=args.llm, clip_path=args.clip,
                                  max_length=cfg.txt_len + VIDEO_CROP_START,
                                  dtype=cfg.dtype, device=dev)

    def encode(prompt):
        if prompt and enc is not None:
            txt, txt_mask, y = enc.embed([prompt])
            return (txt[:, :cfg.txt_len].to(cfg.dtype),
                    txt_mask[:, :cfg.txt_len], y.to(cfg.dtype))
        if prompt:
            warn('--prompt given without --llm/--clip; using zero '
                 'embeddings')
        return None, None, None

    streamed = None
    if wants_streamed(ck):
        say('offloading config active -> streamed (host-offload) runner')
        streamed = model.make_streamed()
    vp = vcfg = None
    if args.vae:
        from ..models import (HyVaeConfig, init_hunyuan_vae_decoder,
                              load_hunyuan_vae_safetensors)
        vcfg = HyVaeConfig()
        vp = (init_hunyuan_vae_decoder(torch.Generator(dev).manual_seed(7),
                                       vcfg, dev)
              if args.vae == 'random'
              else load_hunyuan_vae_safetensors(args.vae, vcfg, dev))
    # the reference's profiler gate: should_profile and a warmed-up
    # generation, the index counting up per generation
    gen_index = [ck.generation_index]

    def run(prompt, seed: int, out_path: str) -> None:
        txt, txt_mask, y = encode(prompt)
        t0 = time.perf_counter()
        with profile_region(PROFILE_DIR, enabled=ck.should_profile,
                            warmup_done=gen_index[0] >= 3):
            out = generate(model, params, seed=seed, txt=txt, y=y,
                           txt_mask=txt_mask, streamed=streamed,
                           chunk=args.chunk)
            if dev.type == 'cuda':
                torch.cuda.synchronize(dev)
        gen_index[0] += 1
        say(f'done in {time.perf_counter() - t0:.1f}s')
        if not is_main():
            return
        if vp is not None:
            from ..models import hunyuan_vae_decode
            save_frames(hunyuan_vae_decode(vp, out, vcfg), out_path)
        else:
            save_latents(out, out_path)
            print(f'latents -> {out_path}')

    run(args.prompt, args.seed, args.out)
    if args.interactive:
        gen_i = 1
        stem = args.out.rsplit('.npy', 1)[0]
        while True:
            try:
                prompt = input('prompt> ').strip()
            except EOFError:
                break
            if not prompt or prompt in ('exit', 'quit'):
                break
            run(prompt, args.seed + gen_i, f'{stem}_{gen_i}.npy')
            gen_i += 1
    finish()
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
