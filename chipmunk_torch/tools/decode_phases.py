"""The prompt-to-pixels phases of ``chip_smoke.py`` alone, on the tree at
ROOT (its ``chip_smoke.py`` and ``chipmunk_torch`` first on ``sys.path``),
for iterating on the encoders and decoders without the whole smoke run::

    python3 chipmunk_torch/tools/decode_phases.py ROOT [--probe] [--sweep]

Runs ``agree_small_decoders``; the two video decodes (``decode_hunyuan``,
``decode_wan``) on seeded random latents of the loops' shapes (bf16 [1,
16, 33, 68, 120] and float32 [1, 16, 21, 60, 104]); then loop (a) of the
FLUX path once (host sparse loop, for its launch counts) and
``flux_generation`` against it.  With ``--probe`` it first checks what
the time-split convolution works around, at Wan's last decoder stage:
one ``F.conv3d`` over a padded input beyond int32 indexing ([1, 128, 83,
482, 834], batch 1), reporting whether it runs, its time and its largest
difference from the port's ``causal_conv3d`` (pieces of at most
``PIECE_ELEMS``); and ``F.group_norm`` over [1, 128, 33, 544, 960] (2.2e9
elements, HunyuanVideo's last stage at 33 output frames) against float64
statistics of its first and last group.  With ``--sweep`` it decodes
the first N latent frames of each video latent for growing N, printing
seconds and the peaks allocated and reserved, up to the whole clip or the
first N the card cannot hold (out of memory), which sets the N of
``chip_smoke.HY_DECODE_N``.  Convolutions in TF32, as the decode phases
run them.
"""
import importlib
import os
import sys
import time


def probe(torch, tvv):
    F = torch.nn.functional
    gen = torch.Generator('cuda')
    gen.manual_seed(0)
    torch.backends.cudnn.allow_tf32 = True
    x = torch.randn((1, 128, 81, 480, 832), generator=gen, device='cuda')
    w = torch.randn((128, 128, 3, 3, 3), generator=gen, device='cuda') \
        * (128 * 27) ** -0.5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    split = tvv.causal_conv3d(x, w, None, 'constant')
    torch.cuda.synchronize()
    print(f'probe causal_conv3d (pieces of <= {tvv.PIECE_ELEMS} elements) '
          f'over {tuple(x.shape)} ({x.numel() / 2 ** 31:.2f} x 2^31 '
          f'elements): {time.perf_counter() - t0:.3f} s', flush=True)
    xp = F.pad(x, (1, 1, 1, 1, 2, 0))
    del x
    torch.cuda.empty_cache()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        whole = F.conv3d(xp, w)
        torch.cuda.synchronize()
        print(f'probe F.conv3d over the padded {tuple(xp.shape)} in one '
              f'call: ran in {time.perf_counter() - t0:.3f} s; largest '
              f'difference from the pieces '
              f'{(whole - split).abs().max().item():.3e}', flush=True)
        del whole
    except RuntimeError as e:
        print(f'probe F.conv3d over the padded {tuple(xp.shape)} in one '
              f'call: raised {str(e).splitlines()[0][:200]}', flush=True)
    del xp, split
    torch.cuda.empty_cache()
    x = torch.randn((1, 128, 33, 544, 960), generator=gen, device='cuda')
    x[:, :4] = x[:, :4] * 3 + 1
    g = torch.ones(128, device='cuda')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = tvv.group_norm(x, g, torch.zeros_like(g), 32)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    errs = []
    for c0 in (0, 124):
        xs = x[:, c0:c0 + 4].double()
        ref = (xs - xs.mean()) / torch.sqrt(xs.var(unbiased=False) + 1e-6)
        errs.append((y[:, c0:c0 + 4].double() - ref).abs().max().item())
    print(f'probe group_norm over {tuple(x.shape)} ({x.numel() / 2 ** 31:.2f}'
          f' x 2^31 elements): {secs:.3f} s; largest difference from float64 '
          f'statistics in the first / last group {errs[0]:.3e} / '
          f'{errs[1]:.3e}', flush=True)
    del x, y
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False


def sweep(torch, tm, cs, tag, lat, decode, ns):
    for n in ns:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        try:
            with cs.default_tf32(torch):
                out, secs = cs.synced(torch, lambda: decode(lat[:, :, :n]))
        except torch.cuda.OutOfMemoryError:
            print(f'sweep {tag}: N = {n} out of memory', flush=True)
            break
        print(f'sweep {tag}: N = {n} -> {out.shape[2]} frames, {secs:.3f} '
              f's, peak {(torch.cuda.max_memory_allocated() - base) / 2 ** 30:.2f} '
              f'GiB allocated, {torch.cuda.max_memory_reserved() / 2 ** 30:.2f} '
              f'GiB reserved', flush=True)
        del out
    torch.cuda.empty_cache()


def main():
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import torch
    cs = importlib.import_module('chip_smoke')
    kern = importlib.import_module('chipmunk_torch.kernels')
    cfgmod = importlib.import_module('chipmunk_torch.config')
    tm = importlib.import_module('chipmunk_torch.models')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(torch.__version__, torch.version.cuda,
          torch.backends.cudnn.version(), torch.cuda.get_device_name(0),
          flush=True)
    if '--probe' in sys.argv:
        probe(torch, importlib.import_module('chipmunk_torch.models.video_vae'))
    gen = torch.Generator('cuda')
    gen.manual_seed(cs.SEED + 4)
    if '--sweep' in sys.argv:
        lat = torch.randn((1, 16, 33, 68, 120), generator=gen, device='cuda')
        hcfg = tm.HyVaeConfig()
        hp = tm.init_hunyuan_vae_decoder(gen, hcfg, 'cuda')
        sweep(torch, tm, cs, 'hunyuan', lat,
              lambda z: tm.hunyuan_vae_decode(hp, z, hcfg),
              (2, 3, 6, 10, 14, 16, 18, 20, 22, 24, 26, 33))
        del hp
        lat = torch.randn((1, 16, 21, 60, 104), generator=gen, device='cuda')
        wcfg = tm.WanVaeConfig()
        wp = tm.init_wan_vae_decoder(gen, wcfg, 'cuda')
        sweep(torch, tm, cs, 'wan', lat,
              lambda z: tm.wan_vae_decode(wp, z, wcfg), (2, 3, 6, 11, 16, 21))
        del wp, lat
        return
    kern.build_all()
    cs.agree_small_decoders(torch, tm)
    cs.decode_hunyuan(torch, tm, torch.randn(
        (1, 16, 33, 68, 120), generator=gen, device='cuda').bfloat16())
    cs.decode_wan(torch, tm, torch.randn((1, 16, 21, 60, 104), generator=gen,
                                         device='cuda'))
    ck = cfgmod.load_config(os.path.join(root, 'configs',
                                         'flux-chipmunk.yml'))
    model = tm.FluxModelConfig()
    loops = cs.prepare_loop(torch, tm, ck, model, cs.H_IMG, cs.W_IMG,
                            'cuda')
    kern.reset_launches()
    _, secs = loops()
    launches = dict(kern.LAUNCHES)
    print(f'loop (a): {secs:.3f} s, launches '
          f'{ {k: n for k, n in launches.items() if n} }', flush=True)
    del loops
    torch.cuda.empty_cache()
    cs.flux_generation(torch, tm, kern, ck, model, launches)
    print('decode phases ok', flush=True)


if __name__ == '__main__':
    main()
