"""Same-card A/B of the kernel phases of ``chip_smoke.py``: the phases that
print the kernel rows (``kernel_phases``, ``quant_kernel_phases`` for int8
and int4, ``probe_phase``, ``video_kernel_phases``), called alone on the
tree at ROOT, which goes first on ``sys.path`` (its ``chip_smoke.py`` and
``chipmunk_torch``), and the quantized-weight pairs' device times on the
quantized phases' inputs.  Prints one ``AB {json}`` line of times.  Run it
for the parent (``git archive <parent> | tar -x -C build/parent``) and
this tree in turns, in one call on the card::

    python3 chipmunk_torch/tools/ab_phases.py ROOT \
        [--no-video | --wq | --w4 | --a8w4 | --probe | --groups]

With ``--wq`` (int8 weights), ``--w4`` (int4; both with bf16 activations)
or ``--a8w4`` (int4 weights, int8 activations) only that pair's device
times are taken (no other phase); with ``--probe`` only ``probe_phase``
runs, with ``--groups`` only the attention kernels at score blocks below
64 keys and at query groups other than 128 rows
(``colsum_small_block_phases``, ``query_group_phases``: the tree must
have them).
"""
import functools, importlib, inspect, json, sys, time


def quant_inputs(torch, cs, fp8, quant, kind='int4'):
    """The draws of ``quant_kernel_phases(..., kind)``: x, w1, b1, w2, act,
    out, inds, counts and the tile sizes bm, bn."""
    dev = 'cuda'
    gen = torch.Generator(dev)
    gen.manual_seed(cs.SEED + 1)
    bm, bn, jm, T, C, N = 512, 256, 22, cs.T_SINGLE, cs.C, cs.N
    M = T // bm

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    x = randn(T, C)
    w1, w2 = (quant.quantize(randn(N, C, scale=s), kind, keep_axes=(0,),
                             pack_axis=1 if kind == 'int4' else None)
              for s in (C ** -0.5, N ** -0.5))
    b1 = randn(N, scale=0.1)
    act = fp8.to_fp8(torch.randn((T, N), generator=gen, device=dev) * 0.3)
    out = fp8.to_fp8(torch.randn((T, C), generator=gen, device=dev))
    inds = torch.rand((M, N // bn), generator=gen, device=dev).topk(jm, -1) \
        .indices.sort(-1).values.to(torch.int32)
    counts = torch.randint(13, 18, (M,), generator=gen, device=dev,
                           dtype=torch.int32)
    counts[0], counts[1] = 1, jm
    return x, w1, b1, w2, act, out, inds, counts, bm, bn


def bf16x_device_ms(torch, cs, cm, fp8, quant, kind):
    """Device ms of csp_mlp_mm1 / csp_mlp_mm2 with int8 (``wq``) or int4
    (``w4``) weights on the inputs of ``quant_kernel_phases(..., kind)``,
    for trees whose chip_smoke.py does not time them on the device; for
    ``wq``, where the tree has it, also csp_mlp_fused's route (mm1 scales
    the delta, mm2 takes it prescaled: keys ending in "fused")."""
    x, w1, b1, w2, act, out, inds, counts, bm, bn = quant_inputs(
        torch, cs, fp8, quant, kind)
    tag = 'w4' if kind == 'int4' else 'wq'
    pk, _ = cm.csp_mlp_mm1(x, w1, b1, act.clone(), inds, counts, bn=bn, bm=bm)
    res = {
        f'csp_mlp_mm1_{tag}': cs.device_ms(torch, lambda: cm.csp_mlp_mm1(
            x, w1, b1, act, inds, counts, bn=bn, bm=bm), 20)[0],
        f'csp_mlp_mm2_{tag}': cs.device_ms(torch, lambda: cm.csp_mlp_mm2(
            pk, w2, out, inds, counts, bn=bn, bm=bm), 20)[0]}
    if 'prescaled' in inspect.signature(cm.csp_mlp_mm2).parameters \
            and tag == 'wq':
        # csp_mlp_fused's route: mm1 scales the delta, mm2 takes it so
        pk, _ = cm.csp_mlp_mm1(x, w1, b1, act.clone(), inds, counts, bn=bn,
                               bm=bm, w2=w2)
        res[f'csp_mlp_mm1_{tag} fused'] = cs.device_ms(
            torch, lambda: cm.csp_mlp_mm1(x, w1, b1, act, inds, counts, bn=bn,
                                          bm=bm, w2=w2), 20)[0]
        res[f'csp_mlp_mm2_{tag} fused'] = cs.device_ms(
            torch, lambda: cm.csp_mlp_mm2(pk, w2, out, inds, counts, bn=bn,
                                          bm=bm, prescaled=True), 20)[0]
    return res


def a8w4_device_ms(torch, cs, cm, fp8, quant):
    """Device ms of csp_mlp_mm1_a8 / csp_mlp_mm2_a8 with int4 weights on
    the same inputs (x8 and sx from quant_rows), for trees whose
    chip_smoke.py does not time them on the device."""
    x, w1, b1, w2, act, out, inds, counts, bm, bn = quant_inputs(
        torch, cs, fp8, quant)
    x8, sx = cm.quant_rows(x)
    d8, sd, _ = cm.csp_mlp_mm1_a8(x8, sx, w1, b1, w2.scale, act.clone(),
                                  inds, counts, bn=bn, bm=bm)
    return {
        'csp_mlp_mm1_a8w4': cs.device_ms(torch, lambda: cm.csp_mlp_mm1_a8(
            x8, sx, w1, b1, w2.scale, act, inds, counts, bn=bn, bm=bm),
            20)[0],
        'csp_mlp_mm2_a8w4': cs.device_ms(torch, lambda: cm.csp_mlp_mm2_a8(
            d8, sd, w2, out, inds, counts, bn=bn, bm=bm), 20)[0]}


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
    if '--probe' in sys.argv:
        rows = cs.probe_phase(torch, importlib.import_module(
            'chipmunk_torch.kernels.int8_probe'))
        print('AB ' + json.dumps({'root': root, 'rows': [
            {k: r.get(k) for k in ('name', 'ms', 'device_ms', 'library_ms')}
            for r in rows]}), flush=True)
        return
    if '--groups' in sys.argv:
        cs.colsum_small_block_phases(torch, mods[0])
        cs.query_group_phases(torch, mods[0], mods[1])
        return
    for flag, fn in (
            ('--wq', functools.partial(bf16x_device_ms, kind='int8')),
            ('--w4', functools.partial(bf16x_device_ms, kind='int4')),
            ('--a8w4', a8w4_device_ms)):
        if flag in sys.argv:
            print(f'{flag[2:].upper()} device ms ' + json.dumps(
                fn(torch, cs, mods[2], fp8, quant)), flush=True)
            return
    rows = cs.kernel_phases(torch, mods + (fp8,))
    torch.cuda.empty_cache()
    for kind in ('int8', 'int4'):
        rows += cs.quant_kernel_phases(torch, mods[2], mods[1], fp8, quant, kind)
        torch.cuda.empty_cache()
    rows += cs.probe_phase(torch, importlib.import_module(
        'chipmunk_torch.kernels.int8_probe'))
    w4 = bf16x_device_ms(torch, cs, mods[2], fp8, quant, 'int4')
    print('W4 device ms ' + json.dumps(w4), flush=True)
    a8w4 = a8w4_device_ms(torch, cs, mods[2], fp8, quant)
    print('A8W4 device ms ' + json.dumps(a8w4), flush=True)
    out = {}
    if '--no-video' not in sys.argv:
        import os
        vck = cfgmod.load_config(os.path.join(root, 'configs', 'hunyuan-chipmunk.yml'))
        vrow, out = cs.video_kernel_phases(torch, mods, tm, vck)
        rows.append(vrow)
    print('AB ' + json.dumps({'root': root, 'rows': [
        {k: r.get(k) for k in ('name', 'ms', 'device_ms', 'library_ms')} for r in rows],
        'video': out, 'w4_device_ms': w4, 'a8w4_device_ms': a8w4}),
        flush=True)


if __name__ == '__main__':
    main()
