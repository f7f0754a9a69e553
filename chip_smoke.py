#!/usr/bin/env python3
"""Smoke run of the chipmunk_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and builds the
   kernels from ``chipmunk_torch/csrc`` (nvcc, one process per source).
2. Holds every kernel against its plain PyTorch version on the same
   inputs at the FLUX.1-dev main-path shapes, with the tolerances stated
   in ``check_*`` below, and times kernel, plain version and (for dense
   attention) ``F.scaled_dot_product_attention``.
3. Drives the port's main path: ``FluxSampler.denoise`` over the
   50-step schedule of ``configs/flux-chipmunk.yml`` at 1280x768 with the
   full-width, full-depth FLUX.1-dev model (random bf16 weights from a
   seed), checks that the output is finite and that every kernel ran, then
   times a dense loop (sparsity and step caching off) on the same card.
   A small full-width model is also run through the same loop on the card
   and, with the plain versions, on the CPU, and the two must agree.
4. Prints the card line, one JSON line with the kernels' numbers, and as
   the last line ``{"ok": true, "device": {...}}``.

Any failed phase ends the script with a non-zero exit.  Without a CUDA
device, or without the ``chipmunk_torch`` package beside it, it exits
non-zero and prints no result.
"""
import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# published dense peaks of one H100 SXM (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
SEED = 0
OUR_KERNELS = ('dense_attn_kernel', 'dense_colsum_attn_kernel',
               'csp_attn_kernel', 'csp_mlp_mm1_kernel', 'csp_mlp_mm2_kernel')
GEMM_NAMES = ('nvjet', 'gemm', 'cutlass', 'xmma', 'gemv')

B, H, S, D = 1, 24, 4352, 128          # FLUX.1-dev at 1280x768
H_IMG, W_IMG = 48, 80                  # latent patch grid: 3840 img tokens
T_SINGLE, C, N = 4608, 3072, 12288     # single-block MLP tokens (padded to bm)


def fail(msg):
    print(f'chip_smoke: FAILED: {msg}', file=sys.stderr)
    sys.exit(1)


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops >= t_bytes
                                       else 'bytes')


def time_ms(torch, fn, n):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def fp8_ulp(torch, x):
    """Spacing of float8 e4m3 at |x| (2^-9 in the subnormal range)."""
    e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -6)))
    return torch.exp2(e - 3)


def check_close(name, got, ref, atol, rtol):
    """bf16/f32 outputs compared in f32: |got - ref| <= atol + rtol |ref|."""
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    if not bool((err <= atol + rtol * r.abs()).all()):
        fail(f'{name}: max abs err {err.max().item():.3e} exceeds '
             f'atol {atol} + rtol {rtol} * |ref|')
    return err.max().item()


def check_fp8(torch, name, got, ref):
    """fp8 caches: NaN at the same places, elsewhere within one e4m3 ulp
    (the kernel and the plain version sum in different orders, so a value
    near a rounding boundary may land on the neighbour)."""
    g, r = got.float(), ref.float()
    if not bool((g.isnan() == r.isnan()).all()):
        fail(f'{name}: NaN positions differ')
    ok = ~r.isnan()
    err = (g - r).abs()[ok]
    if not bool((err <= fp8_ulp(torch, r[ok])).all()):
        fail(f'{name}: fp8 values differ by more than one e4m3 ulp '
             f'(max abs err {err.max().item():.3e})')
    return err.max().item()


def kernel_phases(torch, mods):
    """Each kernel against its plain version at the main-path shapes."""
    fa, ca, cm, fp8 = mods
    dev = 'cuda'
    gen = torch.Generator(dev)
    gen.manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    rows = []
    qkv_bytes = 3 * B * H * S * D * 2
    q, k, v = randn(B, H, S, D), randn(B, H, S, D), randn(B, H, S, D)
    attn_flops = 4.0 * B * H * S * S * D

    # ---- dense_attn: o to 4e-3 + 2^-6 |ref| (a few bf16 ulps: the kernel
    # rounds p to bf16 against a running max), lse (log2 domain) to 1e-3
    o, lse = fa.dense_attn(q, k, v)
    torch.cuda.synchronize()
    o_p, lse_p = fa.dense_attn_plain(q, k, v)
    err = check_close('dense_attn o', o, o_p, 4e-3, 2 ** -6)
    check_close('dense_attn lse', lse, lse_p, 1e-3, 0.0)
    bnd, by = bound_ms(attn_flops, qkv_bytes + B * H * S * (D * 2 + 4))
    rows.append(dict(
        name='dense_attn', source='chipmunk_torch/csrc/flash_attention.cu',
        replaces='chipmunk_tpu/kernels/flash_attention.py:55',
        max_abs_err=err, ms=time_ms(torch, lambda: fa.dense_attn(q, k, v), 20),
        plain_ms=time_ms(torch, lambda: fa.dense_attn_plain(q, k, v), 3),
        bound_ms=bnd, bound_by=by,
        library_ms=time_ms(torch, lambda: torch.nn.functional
                           .scaled_dot_product_attention(q, k, v), 20)))

    # ---- dense_colsum_attn: as above, colsums to 1e-3 relative
    prev = lse_p
    o, cs, lse = fa.dense_colsum_attn(q, k, v, prev)
    torch.cuda.synchronize()
    o_p, cs_p, lse_p = fa.dense_colsum_attn_plain(q, k, v, prev)
    err = check_close('dense_colsum_attn o', o, o_p, 4e-3, 2 ** -6)
    check_close('dense_colsum_attn lse', lse, lse_p, 1e-3, 0.0)
    check_close('dense_colsum_attn colsums', cs, cs_p, 1e-4, 1e-3)
    G = S // 128
    bnd, by = bound_ms(attn_flops, qkv_bytes + B * H * S * (D * 2 + 8)
                       + cs.numel() * 4)
    rows.append(dict(
        name='dense_colsum_attn',
        source='chipmunk_torch/csrc/flash_attention.cu',
        replaces='chipmunk_tpu/kernels/flash_attention.py:100',
        max_abs_err=err,
        ms=time_ms(torch, lambda: fa.dense_colsum_attn(q, k, v, prev), 20),
        plain_ms=time_ms(torch, lambda: fa.dense_colsum_attn_plain(
            q, k, v, prev), 3),
        bound_ms=bnd, bound_by=by, library_ms=None))

    # ---- csp_attn: jmax = 6 blocks of 128 (top_keys 0.165), counts from
    # 1 to jmax; o as for dense_attn (online vs exact softmax rounding)
    jmax, nb = 6, S // 128
    scores = torch.rand((B, H, G, nb), generator=gen, device=dev)
    inds = scores.topk(jmax, -1).indices.sort(-1).values.to(torch.int32)
    counts = torch.randint(1, jmax + 1, (B, H, G), generator=gen,
                           device=dev, dtype=torch.int32)
    counts[..., 0], counts[..., 1] = 1, jmax
    o = ca.csp_attn(q, k, v, inds, counts)
    torch.cuda.synchronize()
    pinds = ca.pad_block_indices(inds, counts)
    o_p = ca.csp_attn_plain(q, k, v, pinds, counts)
    err = check_close('csp_attn o', o, o_p, 4e-3, 2 ** -6)
    sel = torch.zeros((B, H, nb), dtype=torch.bool, device=dev)
    sel.scatter_(-1, pinds.long().reshape(B, H, -1), True)
    kv_bytes = int(sel.sum().item()) * 128 * D * 2 * 2
    bnd, by = bound_ms(4.0 * 128 * 128 * D * counts.sum().item(),
                       kv_bytes + 2 * B * H * S * D * 2
                       + inds.numel() * 4 + counts.numel() * 4)
    rows.append(dict(
        name='csp_attn', source='chipmunk_torch/csrc/csp_attention.cu',
        replaces='chipmunk_tpu/kernels/csp_attention.py:102',
        max_abs_err=err,
        ms=time_ms(torch, lambda: ca.csp_attn(q, k, v, inds, counts), 20),
        plain_ms=time_ms(torch, lambda: ca.csp_attn_plain(
            q, k, v, pinds, counts), 3),
        bound_ms=bnd, bound_by=by, library_ms=None))
    del q, k, v, o, o_p, cs, cs_p

    # ---- csp_mlp_mm1 / csp_mlp_mm2 at the single-block MLP shape:
    # bm = 512, bn = 256, jmax = 22, counts 1 .. jmax (mostly ~15)
    bm, bn, jm = 512, 256, 22
    M, nbn = T_SINGLE // bm, N // bn
    x = randn(T_SINGLE, C)
    w1t, w2 = randn(N, C, scale=C ** -0.5), randn(N, C, scale=N ** -0.5)
    b1 = randn(N, scale=0.1)
    act = fp8.to_fp8(torch.randn((T_SINGLE, N), generator=gen, device=dev)
                     * 0.3)
    out = fp8.to_fp8(torch.randn((T_SINGLE, C), generator=gen, device=dev))
    minds = torch.rand((M, nbn), generator=gen, device=dev).topk(jm, -1) \
        .indices.sort(-1).values.to(torch.int32)
    mcounts = torch.randint(13, 18, (M,), generator=gen, device=dev,
                            dtype=torch.int32)
    mcounts[0], mcounts[1] = 1, jm
    pminds = ca.pad_block_indices(minds, mcounts)
    act_k = act.clone()
    pk, act_k = cm.csp_mlp_mm1(x, w1t, b1, act_k, minds, mcounts, bn=bn,
                               bm=bm)
    torch.cuda.synchronize()
    pk_p, act_p = cm.csp_mlp_mm1_plain(x, w1t, b1, act, pminds, mcounts,
                                       bn, bm)
    err = check_fp8(torch, 'csp_mlp_mm1 act_cache', act_k, act_p)
    # the packed delta takes the act's rounding: where the two acts agree
    # it must agree bit for bit, elsewhere within that act's ulp
    pos = torch.arange(jm * bn, device=dev)
    ncol = (minds.long()[:, :, None] * bn
            + torch.arange(bn, device=dev)).reshape(M, -1)
    ncol = ncol.repeat_interleave(bm, 0)
    a_p = act_p.float().gather(1, ncol)
    a_k = act_k.float().gather(1, ncol)
    live = (pos[None] < (mcounts.repeat_interleave(bm) * bn)[:, None])
    same = (a_p == a_k) | (a_p.isnan() & a_k.isnan()) | ~live
    pk_eq = (pk.float() == pk_p.float()) | (pk.float().isnan()
                                           & pk_p.float().isnan())
    if not bool(pk_eq[same].all()):
        fail('csp_mlp_mm1 packed: differs where the acts agree')
    dpk = (pk.float() - pk_p.float()).abs()[~same]
    if dpk.numel() and not bool(
            (dpk <= fp8_ulp(torch, a_p[~same]) * 1.01
             + pk_p.float().abs()[~same] * 2 ** -8).all()):
        fail('csp_mlp_mm1 packed: differs by more than the act ulp')
    nsel = int(mcounts.sum().item())
    mm_flops = 2.0 * bm * bn * C * nsel
    used = torch.zeros(nbn, dtype=torch.bool, device=dev)
    used[pminds.long().flatten()] = True
    w_bytes = int(used.sum().item()) * bn * C * 2
    bnd, by = bound_ms(mm_flops, T_SINGLE * C * 2 + w_bytes
                       + nsel * bm * bn * 2 + pk.numel() * 2)
    act_t = act.clone()
    rows.append(dict(
        name='csp_mlp_mm1', source='chipmunk_torch/csrc/csp_mlp.cu',
        replaces='chipmunk_tpu/kernels/csp_mlp.py:326',   # fc1 half
        max_abs_err=err,
        ms=time_ms(torch, lambda: cm.csp_mlp_mm1(
            x, w1t, b1, act_t, minds, mcounts, bn=bn, bm=bm), 20),
        plain_ms=time_ms(torch, lambda: cm.csp_mlp_mm1_plain(
            x, w1t, b1, act, pminds, mcounts, bn, bm), 3),
        bound_ms=bnd, bound_by=by, library_ms=None))

    out_k = cm.csp_mlp_mm2(pk_p, w2, out.clone(), minds, mcounts, bn=bn,
                           bm=bm)
    torch.cuda.synchronize()
    out_p = cm.csp_mlp_mm2_plain(pk_p, w2, out, pminds, mcounts, bn, bm)
    err = check_fp8(torch, 'csp_mlp_mm2 out_cache', out_k, out_p)
    bnd, by = bound_ms(mm_flops, nsel * bm * bn * 2 + w_bytes
                       + 2 * T_SINGLE * C)
    out_t = out.clone()
    rows.append(dict(
        name='csp_mlp_mm2', source='chipmunk_torch/csrc/csp_mlp.cu',
        replaces='chipmunk_tpu/kernels/csp_mlp.py:326',   # fc2 half
        max_abs_err=err,
        ms=time_ms(torch, lambda: cm.csp_mlp_mm2(
            pk_p, w2, out_t, minds, mcounts, bn=bn, bm=bm), 20),
        plain_ms=time_ms(torch, lambda: cm.csp_mlp_mm2_plain(
            pk_p, w2, out, pminds, mcounts, bn, bm), 3),
        bound_ms=bnd, bound_by=by, library_ms=None))
    for r in rows:
        print(f"kernel {r['name']}: max_abs_err {r['max_abs_err']:.3e} "
              f"ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
              f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}) "
              f"library_ms {r['library_ms']}", flush=True)
    return rows


def run_loop(torch, tm, ck, model, h_img, w_img, device, init_device=None,
             callback=None):
    """One FluxSampler.denoise; weights and inputs are drawn from a seeded
    generator on ``init_device`` (default: ``device``) and moved to
    ``device``.  Returns (latent, seconds)."""
    init_device = init_device or device
    gen = torch.Generator(init_device)
    gen.manual_seed(SEED)
    seq = model.txt_len + h_img * w_img
    sp = tm.FluxSparse.build(ck, model, seq)
    sampler = tm.FluxSampler(cfg=model, ck=ck, sp=sp, h_img=h_img,
                             w_img=w_img, device=device)
    params = tm.init_flux_params(gen, model, init_device)
    if init_device != device:
        def move(t):
            return ({k: move(v) for k, v in t.items()} if isinstance(t, dict)
                    else [move(v) for v in t] if isinstance(t, list)
                    else t.to(device))
        params = move(params)
    img, txt, y = (torch.randn(shape, generator=gen, device=init_device)
                   .to(device) for shape in (
                       (1, h_img * w_img, model.in_channels),
                       (1, model.txt_len, model.context_in_dim),
                       (1, model.vec_in_dim)))
    ts = tm.get_schedule(ck.steps, h_img * w_img)
    loop_gen = torch.Generator(device)
    loop_gen.manual_seed(SEED)
    if device != 'cpu':
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sampler.denoise(params, img, txt, y, ts, generator=loop_gen,
                          callback=callback)
    if device != 'cpu':
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def window_marks(torch, marks, then=None):
    """A denoise callback that records the host clock, synchronised, at
    the end of steps 1 and 9 (the window of trace_sparse_steps)."""
    def step_done(i, skipped):
        if i in (1, 9):
            torch.cuda.synchronize()
            marks[i] = time.perf_counter()
        if then is not None:
            then()
    return step_done


def trace_sparse_steps(torch, tm, ck, model, plain_window_ms):
    """torch.profiler over steps 2-9 of the sparse loop (seven computed
    sparse steps, one skipped): device time by kernel group, and the
    device-busy share of the same window timed without the profiler
    (plain_window_ms).  Device time is the sum of CUDA kernel durations;
    one stream, so kernels do not overlap."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    marks = {}

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=8)) as prof:
        run_loop(torch, tm, ck, model, H_IMG, W_IMG, 'cuda',
                 callback=window_marks(torch, marks, lambda: prof.step()))
    wall_ms = (marks[9] - marks[1]) * 1e3
    groups, names = {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key.startswith(
                'ProfilerStep'):
            continue
        us = e.self_device_time_total
        low = e.key.lower()
        g = ('chipmunk kernels' if any(k in low for k in OUR_KERNELS)
             else 'GEMM (cuBLAS)' if any(k in low for k in GEMM_NAMES)
             else 'other (elementwise, reductions, copies, top-k)')
        groups[g] = groups.get(g, 0.0) + us / 1e3
        names[e.key] = names.get(e.key, 0.0) + us / 1e3
    busy = sum(groups.values())
    print(f'trace, steps 2-9 (7 computed sparse steps): window '
          f'{plain_window_ms:.1f} ms unprofiled ({wall_ms:.1f} ms under the '
          f'profiler); device busy {busy:.1f} ms = '
          f'{100 * busy / plain_window_ms:.1f}% of the unprofiled window',
          flush=True)
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f'trace group {g}: {ms:.1f} ms '
              f'({100 * ms / plain_window_ms:.1f}% of the unprofiled window)')
    for n, ms in sorted(names.items(), key=lambda kv: -kv[1])[:12]:
        print(f'trace kernel {ms:9.2f} ms  {n[:110]}')


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        kern = importlib.import_module('chipmunk_torch.kernels')
    except ImportError as e:
        print(f'chip_smoke: chipmunk_torch not found beside the script: {e}',
              file=sys.stderr)
        return 2
    from chipmunk_torch import config as cfgmod
    from chipmunk_torch.ops import fp8
    import chipmunk_torch.models as tm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    kern.build_all()
    print(f'kernels built in {time.perf_counter() - t0:.1f} s', flush=True)

    mods = tuple(importlib.import_module(f'chipmunk_torch.kernels.{m}')
                 for m in ('flash_attention', 'csp_attention', 'csp_mlp'))
    rows = kernel_phases(torch, mods + (fp8,))
    torch.cuda.empty_cache()

    # ---- the main path: FLUX.1-dev sparse denoise loop, 50 steps
    ck = cfgmod.load_config(os.path.join(ROOT, 'configs',
                                         'flux-chipmunk.yml'))
    ck = ck.replace(mlp=dataclasses.replace(ck.mlp, int8_act=False))
    print('config: configs/flux-chipmunk.yml with mlp.int8_act=false (bf16 '
          'weights), attn/mlp first_n_dense_layers='
          f'{ck.attn.first_n_dense_layers}/{ck.mlp.first_n_dense_layers}',
          flush=True)
    model = tm.FluxModelConfig()          # full width and depth, bf16
    kern.reset_launches()
    marks = {}
    out, sparse_s = run_loop(torch, tm, ck, model, H_IMG, W_IMG, 'cuda',
                             callback=window_marks(torch, marks))
    launches = dict(kern.LAUNCHES)
    print(f'sparse loop: {ck.steps} steps, depth {model.depth}+'
          f'{model.depth_single_blocks}, {sparse_s:.3f} s', flush=True)
    print(json.dumps({'launches': launches}), flush=True)
    if out.shape != (1, H_IMG * W_IMG, model.in_channels):
        fail(f'output shape {tuple(out.shape)}')
    if not bool(torch.isfinite(out).all()):
        fail('non-finite values in the sparse loop output')
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f'kernels not launched on the main path: {missing}')
    del out
    torch.cuda.empty_cache()
    trace_sparse_steps(torch, tm, ck, model, (marks[9] - marks[1]) * 1e3)
    torch.cuda.empty_cache()

    dense_ck = ck.replace(
        attn=dataclasses.replace(ck.attn, is_enabled=False),
        mlp=dataclasses.replace(ck.mlp, is_enabled=False),
        step_caching=dataclasses.replace(ck.step_caching, is_enabled=False))
    out_d, dense_s = run_loop(torch, tm, dense_ck, model, H_IMG, W_IMG,
                              'cuda')
    if not bool(torch.isfinite(out_d).all()):
        fail('non-finite values in the dense loop output')
    print(f'dense loop: {ck.steps} steps, {dense_s:.3f} s; sparse speedup '
          f'{dense_s / sparse_s:.3f}x', flush=True)
    del out_d
    torch.cuda.empty_cache()

    # ---- agreement on a small input: full width, depth 1+1, 128 text +
    # 384 image tokens, 4 steps holding the first, colsum, sparse and plain
    # full kinds, no random keeps; the same weights (drawn on the CPU) run
    # through the kernels on the card and through the plain versions on
    # the CPU.  Mean relative difference of the outputs <= 2e-2 (bf16
    # model: the two sides round their matmuls differently).
    small_ck = cfgmod.config_from_dict(
        {'steps': 4,
         'attn': {'full_step_every': 3, 'first_n_dense_layers': 0,
                  'top_keys': 0.5, 'dense_fallback_frac': 1.0},
         'mlp': {'full_step_every': 3, 'first_n_dense_layers': 0,
                 'random_keys': 0.0},
         'step_caching': {'is_enabled': False}}, ck)
    small = dataclasses.replace(model, depth=1, depth_single_blocks=1,
                                txt_len=128)
    kern.reset_launches()
    gpu_out, _ = run_loop(torch, tm, small_ck, small, 16, 24, 'cuda', 'cpu')
    small_launches = dict(kern.LAUNCHES)
    cpu_out, cpu_s = run_loop(torch, tm, small_ck, small, 16, 24, 'cpu')
    rel = ((gpu_out.cpu() - cpu_out).abs().mean()
           / cpu_out.abs().mean()).item()
    print(f'small-input agreement (card kernels vs CPU plain versions): '
          f'mean relative difference {rel:.3e}, launches {small_launches}, '
          f'CPU run {cpu_s:.1f} s', flush=True)
    if not math.isfinite(rel) or rel > 2e-2:
        fail(f'small-input output differs from the plain versions: {rel}')

    for r in rows:
        r['route'] = 'cuda'
        r['launches'] = launches[r['name']]
    keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
            'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms')
    print(smi)
    print(json.dumps({'kernels': [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
