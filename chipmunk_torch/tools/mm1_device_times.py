"""Wrapper and device times of the mm1 kernels ``a8w4`` (Mm1A8W4), ``wq``
(Mm1Wq) and bf16 (Mm1Bf16) at the FLUX single-block MLP shape, on the
tree at ROOT (first on ``sys.path``), with the act cache refreshed in
place across calls and fresh each call::

    python3 chipmunk_torch/tools/mm1_device_times.py ROOT
"""
import importlib, sys


def main():
    root = sys.argv[1]
    sys.path.insert(0, root)
    import torch
    cs = importlib.import_module('chip_smoke')
    kern = importlib.import_module('chipmunk_torch.kernels')
    cm = importlib.import_module('chipmunk_torch.kernels.csp_mlp')
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
    wb = randn(N, C, scale=C ** -0.5)
    w4 = quant.quantize(wb.float(), 'int4', keep_axes=(0,), pack_axis=1)
    w8 = quant.quantize(wb.float(), 'int8', keep_axes=(0,))
    b1 = randn(N, scale=0.1)
    act = fp8.to_fp8(torch.randn((T, N), generator=gen, device=dev) * 0.3)
    inds = torch.rand((M, N // bn), generator=gen, device=dev).topk(jm, -1).indices.sort(-1).values.to(torch.int32)
    counts = torch.randint(13, 18, (M,), generator=gen, device=dev, dtype=torch.int32)
    counts[0], counts[1] = 1, jm
    x8, sx = cm.quant_rows(x)
    fs = {'mm1_a8w4': lambda a: cm.csp_mlp_mm1_a8(x8, sx, w4, b1, w4.scale, a, inds, counts, bn=bn, bm=bm),
          'mm1_bf16': lambda a: cm.csp_mlp_mm1(x, wb, b1, a, inds, counts, bn=bn, bm=bm),
          'mm1_wq': lambda a: cm.csp_mlp_mm1(x, w8, b1, a, inds, counts, bn=bn, bm=bm)}
    for name, f in fs.items():
        for fresh in (False, True):
            a = act.clone()
            g = (lambda: f(act.clone())) if fresh else (lambda: f(a))
            dms, k = cs.device_ms(torch, g, 20)
            print(f'EXP {root} {name} fresh={fresh}: ms {cs.time_ms(torch, g, 20):.4f} device_ms {dms:.4f} ({k[:50]})', flush=True)


if __name__ == '__main__':
    main()
