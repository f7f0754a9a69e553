"""Host enqueue and wall time of one int8-activation sparse MLP step
(``csp_mlp_fused`` with ``a8``) at the FLUX single-block shape, and the
quantized FLUX.1-dev sparse loop (50 steps, shipped config) twice, on
the tree at ROOT (first on ``sys.path``)::

    python3 chipmunk_torch/tools/loop_ab.py ROOT
"""
import importlib, os, sys, time


def main():
    root = sys.argv[1]
    sys.path.insert(0, root)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    cs = importlib.import_module('chip_smoke')
    kern = importlib.import_module('chipmunk_torch.kernels'); kern.build_all()
    cm = importlib.import_module('chipmunk_torch.kernels.csp_mlp')
    from chipmunk_torch import config as cfgmod
    from chipmunk_torch.ops import fp8
    from chipmunk_torch.utils import quant
    import chipmunk_torch.models as tm
    dev = 'cuda'
    gen = torch.Generator(dev); gen.manual_seed(1)
    T, C, N, bm, bn, jm = 4608, 3072, 12288, 512, 256, 22
    M = T // bm
    def randn(*s, scale=1.0):
        return (torch.randn(s, generator=gen, device=dev) * scale).to(torch.bfloat16)
    x = randn(T, C)
    w1, w2 = (quant.quantize(randn(N, C, scale=s).float(), 'int8', keep_axes=(0,)) for s in (C ** -0.5, N ** -0.5))
    b1 = randn(N, scale=0.1)
    act = fp8.to_fp8(torch.randn((T, N), generator=gen, device=dev) * 0.3)
    out = fp8.to_fp8(torch.randn((T, C), generator=gen, device=dev))
    inds = torch.rand((M, N // bn), generator=gen, device=dev).topk(jm, -1).indices.sort(-1).values.to(torch.int32)
    counts = torch.randint(13, 18, (M,), generator=gen, device=dev, dtype=torch.int32)
    f = lambda: cm.csp_mlp_fused(x, w1, b1, w2, act, out, inds, counts, bn=bn, bm=bm, a8=True)
    for _ in range(3):
        f()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        f()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f'LOOPAB {root} a8 step: host enqueue {(t1 - t0) / 50 * 1e3:.4f} ms/call, wall {(t2 - t0) / 50 * 1e3:.4f} ms/call', flush=True)
    ck = cfgmod.load_config(os.path.join(root, 'configs', 'flux-chipmunk.yml'))
    model = tm.FluxModelConfig()
    qp = quant.synth_quantized_flux_params(0, model, quant.QuantSpec(*cs.SPEC), device='cuda')
    for r in range(2):
        _, s = cs.run_loop(torch, tm, ck, model, cs.H_IMG, cs.W_IMG, 'cuda', params=qp)
        print(f'LOOPAB {root} quantized sparse loop {r}: {s:.3f} s', flush=True)


if __name__ == '__main__':
    main()
