"""Whole-loop device-busy share of the FLUX.1-dev host and compiled sparse
loops (1280x768, 50 steps, ``configs/flux-chipmunk.yml``), bf16 and
quantized weights, on the tree at ROOT (first on ``sys.path``)::

    python3 chipmunk_torch/tools/loop_busy.py ROOT

For each weight kind, in one process on one card, on one set of weights
and inputs (``chip_smoke.prepare_loop``, drawn outside every timing and
trace): the host loop and the compiled loop timed, host, compiled,
compiled, host, then each traced whole with
``chip_smoke.trace_whole_loop`` against its first time (busy share,
device time by group).  Each timed loop prints one ``BUSY {json}``
line with its seconds and, for a compiled loop, its graphs, replays,
eager steps and capture seconds.
"""
import importlib
import json
import os
import sys


def main():
    root = sys.argv[1]
    sys.path.insert(0, root)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    cs = importlib.import_module('chip_smoke')
    importlib.import_module('chipmunk_torch.kernels').build_all()
    from chipmunk_torch import config as cfgmod
    from chipmunk_torch.models.step_graphs import GRAPH_STATS
    from chipmunk_torch.utils import quant
    import chipmunk_torch.models as tm
    ck = cfgmod.load_config(os.path.join(root, 'configs',
                                         'flux-chipmunk.yml'))
    model = tm.FluxModelConfig()
    print(torch.cuda.get_device_name(0), flush=True)
    for kind in ('bf16', 'quantized'):
        params = None if kind == 'bf16' else \
            quant.synth_quantized_flux_params(
                cs.SEED, model, quant.QuantSpec(*cs.SPEC), device='cuda')
        run = cs.prepare_loop(torch, tm, ck, model, cs.H_IMG, cs.W_IMG,
                              'cuda', params=params)
        first = {}
        for compiled in (False, True, True, False):
            _, secs = run(compiled=compiled)
            loop = 'compiled' if compiled else 'host'
            first.setdefault(loop, secs)
            rec = {'weights': kind, 'loop': loop, 's': secs}
            if compiled:
                rec.update(GRAPH_STATS)
            print('BUSY ' + json.dumps(rec), flush=True)
            torch.cuda.empty_cache()
        for loop in ('host', 'compiled'):
            cs.trace_whole_loop(
                torch, lambda: run(compiled=loop == 'compiled'),
                first[loop] * 1e3, f'{kind} {loop}')
            torch.cuda.empty_cache()
        del params, run
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
