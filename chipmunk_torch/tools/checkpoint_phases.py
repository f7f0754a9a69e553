"""The checkpoint-to-latents phases of ``chip_smoke.py`` alone, on the tree
at ROOT (its ``chip_smoke.py`` and ``chipmunk_torch`` first on
``sys.path``), for iterating on the loaders, ``mlp_fp8`` and the generate
CLIs without the whole smoke run::

    python3 chipmunk_torch/tools/checkpoint_phases.py ROOT

Builds the kernels, then runs ``flux_from_checkpoint`` (FLUX.1-dev at full
width and depth from a state dict drawn on the card, loaded with
configs/flux-chipmunk.yml and ``mlp.is_fp8``, the CPU check of its first
blocks, the 50-step loop with exact launches), ``f8_input_matmul_phase``
and ``run_twins`` (the CLI twins as subprocesses), each with its
seconds.
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
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    kern.build_all()
    print(f'kernels built in {time.perf_counter() - t0:.1f} s', flush=True)
    ck = load_config(os.path.join(root, 'configs', 'flux-chipmunk.yml'))
    for name, fn in (('flux_from_checkpoint',
                      lambda: cs.flux_from_checkpoint(torch, tm, kern, ck)),
                     ('f8_input_matmul_phase',
                      lambda: cs.f8_input_matmul_phase(torch)),
                     ('run_twins', lambda: cs.run_twins(torch, tm))):
        t0 = time.perf_counter()
        fn()
        print(f'phase {name}: {time.perf_counter() - t0:.1f} s', flush=True)


if __name__ == '__main__':
    main()
