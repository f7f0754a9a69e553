"""Same-card A/B of the kernel phases of ``chip_smoke.py``: the phases that
print the kernel rows (``kernel_phases``, ``quant_kernel_phases`` for int8
and int4, ``probe_phase``, ``video_kernel_phases``), called alone on the
tree at ROOT, which goes first on ``sys.path`` (its ``chip_smoke.py`` and
``chipmunk_torch``).  Prints one ``AB {json}`` line of times.  Run it for
the parent (``git archive <parent> | tar -x -C build/parent``) and this
tree in turns, in one call on the card::

    python3 chipmunk_torch/tools/ab_phases.py ROOT [--no-video]
"""
import importlib, json, sys, time


def main():
    root = sys.argv[1]
    sys.path.insert(0, root)
    import torch
    cs = importlib.import_module('chip_smoke')
    kern = importlib.import_module('chipmunk_torch.kernels')
    print('chip_smoke from', cs.__file__, 'kernels from', kern.__file__, flush=True)
    from chipmunk_torch import config as cfgmod
    from chipmunk_torch.ops import fp8
    from chipmunk_torch.utils import quant
    import chipmunk_torch.models as tm
    t0 = time.perf_counter()
    kern.build_all()
    print(f'built in {time.perf_counter() - t0:.1f} s', flush=True)
    mods = tuple(importlib.import_module(f'chipmunk_torch.kernels.{m}')
                 for m in ('flash_attention', 'csp_attention', 'csp_mlp'))
    rows = cs.kernel_phases(torch, mods + (fp8,))
    torch.cuda.empty_cache()
    for kind in ('int8', 'int4'):
        rows += cs.quant_kernel_phases(torch, mods[2], mods[1], fp8, quant, kind)
        torch.cuda.empty_cache()
    rows += cs.probe_phase(torch, importlib.import_module(
        'chipmunk_torch.kernels.int8_probe'))
    out = {}
    if '--no-video' not in sys.argv:
        import os
        vck = cfgmod.load_config(os.path.join(root, 'configs', 'hunyuan-chipmunk.yml'))
        vrow, out = cs.video_kernel_phases(torch, mods, tm, vck)
        rows.append(vrow)
    print('AB ' + json.dumps({'root': root, 'rows': [
        {k: r.get(k) for k in ('name', 'ms', 'device_ms', 'library_ms')} for r in rows],
        'video': out}), flush=True)


if __name__ == '__main__':
    main()
