"""The host-offload phases of ``chip_smoke.py`` alone, on the tree at ROOT
(its ``chip_smoke.py`` and ``chipmunk_torch`` first on ``sys.path``), for
iterating on the streamed runner without the whole smoke run::

    python3 chipmunk_torch/tools/streamed_phases.py ROOT [--no-720p]

Builds the kernels, prints the host's memory, runs the 540p HunyuanVideo
loop of ``drive_video_path`` (depth 1+2, the shipped config, seeded
weights and inputs) resident once, then ``streamed_video_loop`` against
it (bit-equal latent, VIDEO_LAUNCHES, seconds, bytes by step kind, peak,
pinned GiB); then, unless ``--no-720p``, ``drive_streamed_720p``
(HunyuanVideo at 720x1280x129 frames and full depth, streamed, the first
STEPS_720 steps, with the link probe).
"""
import importlib
import os
import sys
import time


def main():
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else '.')
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs
    import chipmunk_torch.models as tm
    from chipmunk_torch.config import load_config
    kern = importlib.import_module('chipmunk_torch.kernels')
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    kern.build_all()
    print(f'kernels built in {time.perf_counter() - t0:.1f} s; host memory '
          f'{cs.meminfo()}', flush=True)
    ck = load_config(os.path.join(root, 'configs', 'hunyuan-chipmunk.yml'))
    cfg = tm.HunyuanModelConfig(**cs.V540, **cs.V_DEPTH)
    gen = torch.Generator('cuda')
    gen.manual_seed(cs.SEED)
    params = tm.init_hunyuan_params(gen, cfg, 'cuda')
    inputs = cs.video_inputs(torch, cfg, 'cuda')
    model = tm.HunyuanModel(cfg=cfg, ck=ck)
    torch.cuda.reset_peak_memory_stats()
    kern.reset_launches()
    out, secs = cs.run_video(torch, tm, model, params, inputs)
    print(f'video resident loop (540p): {secs:.3f} s, launches '
          f'{ {k: n for k, n in kern.LAUNCHES.items() if n} }, peak '
          f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB allocated',
          flush=True)
    cs.streamed_video_loop(torch, kern, tm, model, params, inputs, out, secs)
    del params, out, inputs, model
    torch.cuda.empty_cache()
    if '--no-720p' not in sys.argv:
        cs.drive_streamed_720p(torch, kern, tm, ck)


if __name__ == '__main__':
    main()
