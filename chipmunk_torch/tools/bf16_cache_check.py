"""The bf16-cache phases of ``chip_smoke.py`` with each failed gate
printed instead of ending the run, and the bf16-weight mm1's act (bf16
cache) against a float64 reference, in bf16 ulps, for the kernel and for
the plain version, at the FLUX single-block MLP shape; run from the root
of a checkout::

    python3 chipmunk_torch/tools/bf16_cache_check.py
"""
import importlib, sys


def main():
    sys.path.insert(0, '.')
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    cs = importlib.import_module('chip_smoke')
    cs.fail = lambda msg: print('FAIL', msg, flush=True)
    kern = importlib.import_module('chipmunk_torch.kernels'); kern.build_all()
    cm = importlib.import_module('chipmunk_torch.kernels.csp_mlp')
    ca = importlib.import_module('chipmunk_torch.kernels.csp_attention')
    from chipmunk_torch.ops import fp8
    from chipmunk_torch.utils import quant
    dev = 'cuda'
    gen = torch.Generator(dev); gen.manual_seed(5)
    T, C, N, bm, bn, jm, R = 4608, 3072, 12288, 512, 256, 22, 1024
    M = T // bm
    def randn(*s, scale=1.0):
        return (torch.randn(s, generator=gen, device=dev) * scale).to(torch.bfloat16)
    x = randn(T, C); w1 = randn(N, C, scale=C ** -0.5); b1 = randn(N, scale=0.1)
    inds = torch.rand((M, N // bn), generator=gen, device=dev).topk(jm, -1).indices.sort(-1).values.to(torch.int32)
    counts = torch.randint(13, 18, (M,), generator=gen, device=dev, dtype=torch.int32); counts[0], counts[1] = 1, jm
    pinds = ca.pad_block_indices(inds, counts)
    act = (torch.randn((T, N), generator=gen, device=dev) * 0.3).to(torch.bfloat16)
    pk, act_k = cm.csp_mlp_mm1(x, w1, b1, act.clone(), inds, counts, bn=bn, bm=bm)
    pk_p, act_p = cm.csp_mlp_mm1_plain(x[:R], w1, b1, act[:R], pinds[:2], counts[:2], bn, bm)
    rows = (pinds[:2].long()[:, :, None] * bn + torch.arange(bn, device=dev)).reshape(2, -1)
    mid = x[:R].double().reshape(2, bm, C) @ w1.double()[rows].transpose(1, 2) + b1.double()[rows][:, None, :]
    g64 = mid * (0.5 * (1.0 + torch.tanh(0.7978845608028654 * (mid + 0.044715 * mid ** 3))))
    cols = rows.repeat_interleave(bm, 0)
    ak = act_k[:R].float().gather(1, cols).reshape(2, bm, -1).double()
    ap = act_p.float().gather(1, cols).reshape(2, bm, -1).double()
    valid = (torch.arange(jm, device=dev) < counts[:2, None]).repeat_interleave(bn, -1)[:, None, :].expand_as(ak)
    for name, a in (('kernel', ak), ('plain', ap)):
        ulp = torch.exp2(torch.floor(torch.log2(g64.abs().clamp(min=2.0 ** -13))) - 7)
        e = ((a - g64).abs() / ulp)[valid]
        print(f'{name}: act vs float64 in ulps: max {e.max().item():.3f}, >0.51: {int((e > 0.51).sum())} of {e.numel()}', flush=True)
    d = (ak != ap) & valid
    print('kernel != plain at', int(d.sum()), 'examples', [(ak[d][i].item(), ap[d][i].item(), g64[d][i].item()) for i in range(min(5, int(d.sum())))], flush=True)
    cs.bf16_cache_phases(torch, cm, ca, fp8, quant)


if __name__ == '__main__':
    main()
