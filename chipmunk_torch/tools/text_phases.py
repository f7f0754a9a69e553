"""The prompt phases of ``chip_smoke.py`` alone, on the tree at ROOT (its
``chip_smoke.py`` and ``chipmunk_torch`` first on ``sys.path``), for
iterating on the video prompt encoders without the whole smoke run::

    python3 chipmunk_torch/tools/text_phases.py ROOT [--no-twins] [--loop]

Builds the kernels, then runs ``encode_hunyuan_text`` (LLaVA-LLaMA-3-8B
and CLIP-L at full size through ``HunyuanTextEncoders.embed``, the
2-layer trunk against the CPU), ``encode_wan_text`` (UMT5-XXL through
``WanTextEncoder.embed``) and ``run_twins`` (the five twin runs, the
HunyuanVideo one from a prompt and the profiled FLUX one among them).
With ``--loop`` the 540p HunyuanVideo loop then runs from the encoder's
text (``drive_video_path``: launches VIDEO_LAUNCHES, its dense,
compiled and streamed loops).
"""
import importlib
import os
import sys
import time


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
          torch.cuda.get_device_name(0), flush=True)
    t0 = time.perf_counter()
    kern.build_all()
    print(f'kernels built in {time.perf_counter() - t0:.1f} s', flush=True)
    text = cs.encode_hunyuan_text(torch, tm)
    cs.encode_wan_text(torch, tm)
    if '--no-twins' not in sys.argv:
        cs.run_twins(torch, tm)
    if '--loop' in sys.argv:
        vck = cfgmod.load_config(os.path.join(root, 'configs',
                                              'hunyuan-chipmunk.yml'))
        cs.drive_video_path(torch, kern, tm, vck, text)
    print(f'text phases done in {time.perf_counter() - t0:.1f} s',
          flush=True)


if __name__ == '__main__':
    main()
