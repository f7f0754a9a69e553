"""The checkpoint-resume and host-library phases of ``chip_smoke.py``
alone, on the tree at ROOT (its ``chip_smoke.py`` and ``chipmunk_torch``
first on ``sys.path``), for iterating on ``utils/checkpoint.py``,
``utils/native.py`` and the a8 split-mode timing without the whole smoke
run::

    python3 chipmunk_torch/tools/resume_phases.py ROOT

Builds the kernels, then runs ``checkpoint_phase`` (the FLUX bf16 loop
at full width and CKPT_DEPTH, saved after a sparse step in mid-schedule
and resumed, torch.equal to the straight loop), ``native_phase`` (the
g++ build, ``quantize_rows_native`` on a FLUX fc1 weight, ``bitpack_host``
on a 720p mask) and the int8 quantized kernel phase (which times
``csp_mlp_mm1_a8``'s split mode at bn 512), each with its seconds.
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
    from chipmunk_torch.ops import fp8
    from chipmunk_torch.utils import quant
    kern = importlib.import_module('chipmunk_torch.kernels')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    kern.build_all()
    print(f'kernels built in {time.perf_counter() - t0:.1f} s', flush=True)
    ck = load_config(os.path.join(root, 'configs', 'flux-chipmunk.yml'))
    mods = [importlib.import_module(f'chipmunk_torch.kernels.{m}')
            for m in ('csp_mlp', 'csp_attention')]
    phases = [('checkpoint_phase',
               lambda: cs.checkpoint_phase(torch, tm, kern, ck)),
              ('native_phase', lambda: cs.native_phase(torch, quant, fp8)),
              ('quant_kernel_phases int8',
               lambda: cs.quant_kernel_phases(torch, *mods, fp8, quant,
                                              'int8'))]
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        print(f'phase {name}: {time.perf_counter() - t0:.1f} s', flush=True)


if __name__ == '__main__':
    main()
