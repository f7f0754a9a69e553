"""Wrapper and device times (profiler kernel records) of ``csp_mlp_mm1_a8``
and ``csp_mlp_mm2_a8`` at the FLUX single-block MLP shape, on the tree at
ROOT (first on ``sys.path``)::

    python3 chipmunk_torch/tools/a8_device_times.py ROOT
"""
import importlib, sys


def main():
    root = sys.argv[1]
    sys.path.insert(0, root)
    import torch
    cs = importlib.import_module('chip_smoke')
    kern = importlib.import_module('chipmunk_torch.kernels')
    cm = importlib.import_module('chipmunk_torch.kernels.csp_mlp')
    ca = importlib.import_module('chipmunk_torch.kernels.csp_attention')
    from chipmunk_torch.ops import fp8
    from chipmunk_torch.utils import quant
    kern.build_all()
    dev = 'cuda'
    gen = torch.Generator(dev); gen.manual_seed(1)
    T, C, N, bm, bn, jm = 4608, 3072, 12288, 512, 256, 22
    M = T // bm
    def randn(*s, scale=1.0):
        return (torch.randn(s, generator=gen, device=dev) * scale).to(torch.bfloat16)
    x = randn(T, C)
    w1, w2 = (quant.quantize(randn(N, C, scale=s), 'int8', keep_axes=(0,)) for s in (C ** -0.5, N ** -0.5))
    b1 = randn(N, scale=0.1)
    act = fp8.to_fp8(torch.randn((T, N), generator=gen, device=dev) * 0.3)
    out = fp8.to_fp8(torch.randn((T, C), generator=gen, device=dev))
    inds = torch.rand((M, N // bn), generator=gen, device=dev).topk(jm, -1).indices.sort(-1).values.to(torch.int32)
    counts = torch.randint(13, 18, (M,), generator=gen, device=dev, dtype=torch.int32)
    counts[0], counts[1] = 1, jm
    x8, sx = cm.quant_rows(x)
    d8, sd, _ = cm.csp_mlp_mm1_a8(x8, sx, w1, b1, w2.scale, act.clone(), inds, counts, bn=bn, bm=bm)
    a = act.clone(); o = out.clone()
    f1 = lambda: cm.csp_mlp_mm1_a8(x8, sx, w1, b1, w2.scale, a, inds, counts, bn=bn, bm=bm)
    f2 = lambda: cm.csp_mlp_mm2_a8(d8, sd, w2, o, inds, counts, bn=bn, bm=bm)
    for name, f in (('mm1_a8', f1), ('mm2_a8', f2)):
        dms, k = cs.device_ms(torch, f, 20)
        print(f'EXP {root} {name}: ms {cs.time_ms(torch, f, 20):.4f} device_ms {dms:.4f} ({k[:60]})', flush=True)


if __name__ == '__main__':
    main()
