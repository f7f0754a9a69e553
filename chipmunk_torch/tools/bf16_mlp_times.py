"""Wrapper and device times (profiler kernel records) of ``csp_mlp_mm1``
and ``csp_mlp_mm2`` with bf16 weights at the FLUX single-block MLP shape
(T = 4608, C = 3072, N = 12288, bm = 512, bn = 256, jmax 22, counts
13-17 with one at 1 and one at 22, fp8 caches), on the tree at ROOT
(first on ``sys.path``); with ``--ptxas``, also each ``gemm_sm90_kernel``
and ``attn_sm90_kernel`` instantiation's registers and spill bytes as
``nvcc -Xptxas -v`` gives them for that tree's sources::

    python3 chipmunk_torch/tools/bf16_mlp_times.py ROOT [--ptxas]
"""
import importlib, os, re, subprocess, sys


def ptxas(root, build):
    """One nvcc per source, all at once; prints a line per instantiation."""
    srcs = ('flash_attention', 'csp_attention', 'csp_mlp')
    procs = [(s, subprocess.Popen(
        [build.nvcc(), *build.NVCC_FLAGS, '-Xptxas', '-v', '-o',
         os.devnull, os.path.join(root, 'chipmunk_torch', 'csrc', s + '.cu')],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for s in srcs]
    for src, p in procs:
        name = None
        for line in p.communicate()[0].splitlines():
            m = re.search(r"entry function '(\w+)'", line)
            if m:
                name = m.group(1)
            elif name and ('sm90_kernel' in name) and (
                    'registers' in line or 'spill' in line):
                op = re.sub(r'.*(gemm|attn)_sm90_kernel', r'\1', name)
                print(f'PTXAS {root} {src} {op[:90]}: '
                      f'{line.split("info    :")[-1].strip()}')
        if p.returncode:
            raise SystemExit(f'nvcc failed for {src}.cu')


def main():
    root = sys.argv[1]
    sys.path.insert(0, root)
    import torch
    cs = importlib.import_module('chip_smoke')
    kern = importlib.import_module('chipmunk_torch.kernels')
    cm = importlib.import_module('chipmunk_torch.kernels.csp_mlp')
    from chipmunk_torch.ops import fp8
    if '--ptxas' in sys.argv:
        ptxas(root, importlib.import_module('chipmunk_torch.kernels._build'))
    kern.build_all()
    dev = 'cuda'
    gen = torch.Generator(dev); gen.manual_seed(1)
    T, C, N, bm, bn, jm = 4608, 3072, 12288, 512, 256, 22
    M = T // bm
    def randn(*s, scale=1.0):
        return (torch.randn(s, generator=gen, device=dev) * scale).to(torch.bfloat16)
    x = randn(T, C)
    w1, w2 = randn(N, C, scale=C ** -0.5), randn(N, C, scale=N ** -0.5)
    b1 = randn(N, scale=0.1)
    act = fp8.to_fp8(torch.randn((T, N), generator=gen, device=dev) * 0.3)
    out = fp8.to_fp8(torch.randn((T, C), generator=gen, device=dev))
    inds = torch.rand((M, N // bn), generator=gen, device=dev).topk(jm, -1).indices.sort(-1).values.to(torch.int32)
    counts = torch.randint(13, 18, (M,), generator=gen, device=dev, dtype=torch.int32)
    counts[0], counts[1] = 1, jm
    pk, _ = cm.csp_mlp_mm1(x, w1, b1, act.clone(), inds, counts, bn=bn, bm=bm)
    fs = {'csp_mlp_mm1': lambda: cm.csp_mlp_mm1(x, w1, b1, act, inds, counts, bn=bn, bm=bm),
          'csp_mlp_mm2': lambda: cm.csp_mlp_mm2(pk, w2, out, inds, counts, bn=bn, bm=bm)}
    for name, f in fs.items():
        dms, k = cs.device_ms(torch, f, 20)
        print(f'BF16MLP {root} {name}: ms {cs.time_ms(torch, f, 20):.4f} '
              f'device_ms {dms:.4f} ({k[:70]})', flush=True)


if __name__ == '__main__':
    main()
