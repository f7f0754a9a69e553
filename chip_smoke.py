#!/usr/bin/env python3
"""Smoke run of the chipmunk_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and builds the
   kernels from ``chipmunk_torch/csrc`` (nvcc, one process per source).
2. Holds every kernel against its plain PyTorch version on the same
   inputs at the FLUX.1-dev main-path shapes, with the tolerances stated
   in ``check_*`` and the phases below, and times kernel, plain version
   and (where one PyTorch call computes the same function) that call:
   the bf16 kernels, the int8-weight (``wq``) and int8-activation (``a8``)
   sparse-MLP kernels, and the int8/bf16 tile GEMM probe.
3. Drives the port's two main paths, each with the launch counts set to 0
   just before and read just after: ``FluxSampler.denoise`` over the
   50-step schedule of ``configs/flux-chipmunk.yml`` at 1280x768 with the
   full-width, full-depth FLUX.1-dev model, (a) with random bf16 weights
   from a seed, (b) with the quantized weights the JAX package ships
   (``synth_quantized_flux_params``, int4 attention/modulation, int8
   sparse MLP, int4 text MLP) and the config unchanged, so every sparse
   MLP step takes the int8-activation kernels.  Each checks that the
   output is finite and which kernels ran, is traced over a window of
   sparse steps, and is timed against a dense loop (sparsity and step
   caching off) on the same weights.  A small full-width model is also run
   through each loop on the card and, with the plain versions, on the
   CPU, and the two must agree.
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
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12
SEED = 0
OUR_KERNELS = ('dense_attn_kernel', 'dense_colsum_attn_kernel',
               'csp_attn_kernel', 'csp_mlp_mm1', 'csp_mlp_mm2',
               'quant_rows_kernel')
BF16_PATH = ('dense_attn', 'dense_colsum_attn', 'csp_attn', 'csp_mlp_mm1',
             'csp_mlp_mm2')
QUANT_PATH = ('dense_attn', 'dense_colsum_attn', 'csp_attn', 'quant_rows',
              'csp_mlp_mm1_a8', 'csp_mlp_mm2_a8')
SPEC = ('int4', 'int4', 'int8', 'int4')    # QuantSpec of bench.py:62-67
GEMM_NAMES = ('nvjet', 'gemm', 'cutlass', 'xmma', 'gemv')

B, H, S, D = 1, 24, 4352, 128          # FLUX.1-dev at 1280x768
H_IMG, W_IMG = 48, 80                  # latent patch grid: 3840 img tokens
T_SINGLE, C, N = 4608, 3072, 12288     # single-block MLP tokens (padded to bm)


def fail(msg):
    print(f'chip_smoke: FAILED: {msg}', file=sys.stderr)
    sys.exit(1)


def bound_ms(flops, nbytes, peak=PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
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
    print_rows(rows)
    return rows


def print_rows(rows):
    for r in rows:
        print(f"kernel {r['name']}: max_abs_err {r['max_abs_err']:.3e} "
              f"ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
              f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}) "
              f"library_ms {r['library_ms']}", flush=True)


def quant_kernel_phases(torch, cm, ca, fp8, quant, kind):
    """The quantized-weight sparse-MLP kernels against their plain versions
    at the single-block MLP shape of the main path (T = 4608, C = 3072,
    N = 12288, bm = 512, bn = 256, jmax = 22, counts 13-17 with one at 1
    and one at 22), int8 (or int4, packed along C) QTensor weights from
    ``quantize``:
      quant_rows        x8 and sx bit-equal (int8 phase only);
      csp_mlp_mm1_a8    act cache within one e4m3 ulp; d8 and sd bit-equal
       (int4: _a8w4)    wherever the acts of that (row, block) agree;
      csp_mlp_mm2_a8    run on the plain d8/sd: out cache within one ulp;
      csp_mlp_mm1_wq    act cache within one ulp; packed delta bit-equal
       (int4: _w4)      where the acts agree, else within the act's ulp;
      csp_mlp_mm2_wq    run on the plain packed delta: within one ulp.
    No single PyTorch call computes these functions (library_ms null)."""
    dev = 'cuda'
    gen = torch.Generator(dev)
    gen.manual_seed(SEED + 1)
    w4 = kind == 'int4'
    a8, wq = ('a8w4', 'w4') if w4 else ('a8', 'wq')
    bm, bn, jm, T = 512, 256, 22, T_SINGLE
    M, nbn = T // bm, N // bn

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    x = randn(T, C)
    w1, w2 = (quant.quantize(randn(N, C, scale=s), kind, keep_axes=(0,),
                             pack_axis=1 if w4 else None)
              for s in (C ** -0.5, N ** -0.5))
    b1 = randn(N, scale=0.1)
    act = fp8.to_fp8(torch.randn((T, N), generator=gen, device=dev) * 0.3)
    out = fp8.to_fp8(torch.randn((T, C), generator=gen, device=dev))
    inds = torch.rand((M, nbn), generator=gen, device=dev).topk(jm, -1) \
        .indices.sort(-1).values.to(torch.int32)
    counts = torch.randint(13, 18, (M,), generator=gen, device=dev,
                           dtype=torch.int32)
    counts[0], counts[1] = 1, jm
    pinds = ca.pad_block_indices(inds, counts)
    nsel = int(counts.sum().item())
    used = torch.zeros(nbn, dtype=torch.bool, device=dev)
    used[pinds.long().flatten()] = True
    w_rows = int(used.sum().item()) * bn          # weight rows this run reads
    wC = C // 2 if w4 else C                      # bytes of a weight row
    ops = 2.0 * bm * bn * C * nsel                # per pass
    sel_bytes = nsel * bm * bn                    # selected cache/delta slots
    cols = (pinds.long()[:, :, None] * bn
            + torch.arange(bn, device=dev)).reshape(M, -1)
    cols = cols.repeat_interleave(bm, 0)          # [T, jmax*bn]
    rows = []

    def row(name, replaces, err, ms, plain_ms, ops_, nbytes, peak):
        bnd, by = bound_ms(ops_, nbytes, peak)
        rows.append(dict(name=name, source='chipmunk_torch/csrc/csp_mlp.cu',
                         replaces=replaces, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                         library_ms=None))

    # ---- quant_rows: bit-equal
    x8, sx = cm.quant_rows(x)
    torch.cuda.synchronize()
    x8_p, sx_p = cm.quant_rows_plain(x)
    if not (torch.equal(x8, x8_p) and torch.equal(sx, sx_p)):
        fail('quant_rows: x8/sx differ from the plain version')
    if not w4:
        row('quant_rows', 'chipmunk_tpu/kernels/csp_mlp.py:326', 0.0,
            time_ms(torch, lambda: cm.quant_rows(x), 20),
            time_ms(torch, lambda: cm.quant_rows_plain(x), 3),
            0.0, T * C * 2 + T * C + T * 4, PEAK_INT8_OPS)

    # ---- csp_mlp_mm1_a8
    d8, sd, act_k = cm.csp_mlp_mm1_a8(x8, sx, w1, b1, w2.scale, act.clone(),
                                      inds, counts, bn=bn, bm=bm)
    torch.cuda.synchronize()
    d8_p, sd_p, act_p = cm.csp_mlp_mm1_a8_plain(x8, sx, w1, b1, w2.scale,
                                                act, pinds, counts, bn, bm)
    err = check_fp8(torch, f'csp_mlp_mm1_{a8} act_cache', act_k, act_p)
    agree = (act_k.float().gather(1, cols) == act_p.float().gather(1, cols)
             ).reshape(T, jm, bn).all(-1)
    if not (torch.equal(sd[agree], sd_p[agree]) and torch.equal(
            d8.reshape(T, jm, bn)[agree], d8_p.reshape(T, jm, bn)[agree])):
        fail(f'csp_mlp_mm1_{a8}: d8/sd differ where the acts agree')
    print(f'csp_mlp_mm1_{a8}: acts agree in '
          f'{agree.float().mean().item():.4f} of (row, block) pairs',
          flush=True)
    act_t = act.clone()
    row(f'csp_mlp_mm1_{a8}', 'chipmunk_tpu/kernels/csp_mlp.py:326', err,
        time_ms(torch, lambda: cm.csp_mlp_mm1_a8(
            x8, sx, w1, b1, w2.scale, act_t, inds, counts, bn=bn, bm=bm), 20),
        time_ms(torch, lambda: cm.csp_mlp_mm1_a8_plain(
            x8, sx, w1, b1, w2.scale, act, pinds, counts, bn, bm), 3),
        ops, T * C + w_rows * wC + 2 * sel_bytes + sel_bytes + nsel * bm * 4
        + N * 10 + T * 4, PEAK_INT8_OPS)

    # ---- csp_mlp_mm2_a8 on the plain d8/sd
    out_k = cm.csp_mlp_mm2_a8(d8_p, sd_p, w2, out.clone(), inds, counts,
                              bn=bn, bm=bm)
    torch.cuda.synchronize()
    out_p = cm.csp_mlp_mm2_a8_plain(d8_p, sd_p, w2, out, pinds, counts, bn,
                                    bm)
    err = check_fp8(torch, f'csp_mlp_mm2_{a8} out_cache', out_k, out_p)
    out_t = out.clone()
    row(f'csp_mlp_mm2_{a8}', 'chipmunk_tpu/kernels/csp_mlp.py:326', err,
        time_ms(torch, lambda: cm.csp_mlp_mm2_a8(
            d8_p, sd_p, w2, out_t, inds, counts, bn=bn, bm=bm), 20),
        time_ms(torch, lambda: cm.csp_mlp_mm2_a8_plain(
            d8_p, sd_p, w2, out, pinds, counts, bn, bm), 3),
        ops, sel_bytes + nsel * bm * 4 + w_rows * wC + 2 * T * C,
        PEAK_INT8_OPS)
    del d8, sd, d8_p, sd_p, act_k, act_p, out_k, out_p

    # ---- csp_mlp_mm1_wq
    pk, act_k = cm.csp_mlp_mm1(x, w1, b1, act.clone(), inds, counts, bn=bn,
                               bm=bm)
    torch.cuda.synchronize()
    pk_p, act_p = cm.csp_mlp_mm1_plain(x, w1, b1, act, pinds, counts, bn, bm)
    err = check_fp8(torch, f'csp_mlp_mm1_{wq} act_cache', act_k, act_p)
    a_p, a_k = act_p.float().gather(1, cols), act_k.float().gather(1, cols)
    live = (torch.arange(jm * bn, device=dev)[None]
            < (counts.repeat_interleave(bm) * bn)[:, None])
    same = (a_p == a_k) | (a_p.isnan() & a_k.isnan()) | ~live
    g, r = pk.float(), pk_p.float()
    if not bool(((g == r) | (g.isnan() & r.isnan()))[same].all()):
        fail(f'csp_mlp_mm1_{wq} packed: differs where the acts agree')
    dpk = (g - r).abs()[~same]
    if dpk.numel() and not bool((dpk <= fp8_ulp(torch, a_p[~same]) * 1.01
                                 + r.abs()[~same] * 2 ** -8).all()):
        fail(f'csp_mlp_mm1_{wq} packed: differs by more than the act ulp')
    act_t = act.clone()
    row(f'csp_mlp_mm1_{wq}', 'chipmunk_tpu/kernels/csp_mlp.py:93', err,
        time_ms(torch, lambda: cm.csp_mlp_mm1(
            x, w1, b1, act_t, inds, counts, bn=bn, bm=bm), 20),
        time_ms(torch, lambda: cm.csp_mlp_mm1_plain(
            x, w1, b1, act, pinds, counts, bn, bm), 3),
        ops, T * C * 2 + w_rows * wC + 2 * sel_bytes + pk.numel() * 2
        + N * 6, PEAK_BF16_FLOPS)

    # ---- csp_mlp_mm2_wq on the plain packed delta
    out_k = cm.csp_mlp_mm2(pk_p, w2, out.clone(), inds, counts, bn=bn, bm=bm)
    torch.cuda.synchronize()
    out_p = cm.csp_mlp_mm2_plain(pk_p, w2, out, pinds, counts, bn, bm)
    err = check_fp8(torch, f'csp_mlp_mm2_{wq} out_cache', out_k, out_p)
    out_t = out.clone()
    row(f'csp_mlp_mm2_{wq}', 'chipmunk_tpu/kernels/csp_mlp.py:216', err,
        time_ms(torch, lambda: cm.csp_mlp_mm2(
            pk_p, w2, out_t, inds, counts, bn=bn, bm=bm), 20),
        time_ms(torch, lambda: cm.csp_mlp_mm2_plain(
            pk_p, w2, out, pinds, counts, bn, bm), 3),
        ops, sel_bytes * 2 + w_rows * wC + N * 4 + 2 * T * C,
        PEAK_BF16_FLOPS)
    print_rows(rows)
    return rows


def probe_phase(torch, probe):
    """The tile GEMM probe (port of _pk) at the reference's 4096 x 3072 x
    4096: int8 equal to torch._int_mm exactly, bf16 within f32-accumulation
    tolerance of the f32 product (1e-2 + 1e-3 relative at K = 3072), and
    within bf16 rounding of torch.matmul; times and rates of the probe and
    of both library calls."""
    Mp, Kp, Np = 4096, 3072, 4096
    gen = torch.Generator('cuda')
    gen.manual_seed(SEED + 2)
    a = torch.randint(-127, 128, (Mp, Kp), generator=gen, device='cuda',
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (Kp, Np), generator=gen, device='cuda',
                      dtype=torch.int8)
    af = torch.randn((Mp, Kp), generator=gen, device='cuda').to(
        torch.bfloat16)
    bf = torch.randn((Kp, Np), generator=gen, device='cuda').to(
        torch.bfloat16)
    ops = 2.0 * Mp * Kp * Np
    c = probe.int8_probe(a, b)
    torch.cuda.synchronize()
    if not torch.equal(c, torch._int_mm(a, b)):
        fail('int8_probe (int8): differs from torch._int_mm')
    cf = probe.int8_probe(af, bf)
    torch.cuda.synchronize()
    err = check_close('int8_probe (bf16)', cf, probe.int8_probe_plain(af, bf),
                      1e-2, 1e-3)
    check_close('int8_probe (bf16) vs torch.matmul', cf,
                torch.matmul(af, bf), 0.25, 2 ** -7)
    rows = []
    for name, x, y, peak, nbytes in (
            ('int8_probe_s8', a, b, PEAK_INT8_OPS,
             Mp * Kp + Kp * Np + Mp * Np * 4),
            ('int8_probe_bf16', af, bf, PEAK_BF16_FLOPS,
             (Mp * Kp + Kp * Np) * 2 + Mp * Np * 4)):
        ms = time_ms(torch, lambda: probe.int8_probe(x, y), 20)
        lib = (torch._int_mm if x.dtype == torch.int8 else torch.matmul)
        lib_ms = time_ms(torch, lambda: lib(x, y), 20)
        bnd, by = bound_ms(ops, nbytes, peak)
        rows.append(dict(
            name=name, source='chipmunk_torch/csrc/int8_probe.cu',
            replaces='scripts/bench_int8_mxu.py:48',
            max_abs_err=0.0 if x.dtype == torch.int8 else err, ms=ms,
            plain_ms=time_ms(torch, lambda: probe.int8_probe_plain(x, y), 3),
            bound_ms=bnd, bound_by=by, library_ms=lib_ms))
        print(f'probe {name}: {ms:.4f} ms = {ops / ms / 1e9:.1f} TOP/s; '
              f'library ({lib.__name__}) {lib_ms:.4f} ms = '
              f'{ops / lib_ms / 1e9:.1f} TOP/s', flush=True)
    s8, b16 = rows
    print(f'probe: hand-written int8/bf16 rate ratio '
          f'{b16["ms"] / s8["ms"]:.3f}, library '
          f'{b16["library_ms"] / s8["library_ms"]:.3f}', flush=True)
    print_rows(rows)
    return rows


def run_loop(torch, tm, ck, model, h_img, w_img, device, init_device=None,
             callback=None, params=None):
    """One FluxSampler.denoise; weights (unless ``params`` are given, on
    ``init_device``) and inputs are drawn from a seeded generator on
    ``init_device`` (default: ``device``) and moved to ``device``.
    Returns (latent, seconds)."""
    init_device = init_device or device
    gen = torch.Generator(init_device)
    gen.manual_seed(SEED)
    seq = model.txt_len + h_img * w_img
    sp = tm.FluxSparse.build(ck, model, seq)
    sampler = tm.FluxSampler(cfg=model, ck=ck, sp=sp, h_img=h_img,
                             w_img=w_img, device=device)
    if params is None:
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


def trace_sparse_steps(torch, tm, ck, model, plain_window_ms, tag,
                       params=None):
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
                 callback=window_marks(torch, marks, lambda: prof.step()),
                 params=params)
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
    print(f'{tag} trace, steps 2-9 (7 computed sparse steps): window '
          f'{plain_window_ms:.1f} ms unprofiled ({wall_ms:.1f} ms under the '
          f'profiler); device busy {busy:.1f} ms = '
          f'{100 * busy / plain_window_ms:.1f}% of the unprofiled window',
          flush=True)
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f'{tag} trace group {g}: {ms:.1f} ms '
              f'({100 * ms / plain_window_ms:.1f}% of the unprofiled window)')
    for n, ms in sorted(names.items(), key=lambda kv: -kv[1])[:12]:
        print(f'{tag} trace kernel {ms:9.2f} ms  {n[:110]}')


def drive_path(torch, kern, tm, ck, model, tag, expect, params=None):
    """One main path at full size: the sparse loop with every launch count
    set to 0 just before it and read just after (each kernel of
    ``expect`` must have launched, every other kernel not), the trace over
    a window of its sparse steps, and the dense loop (sparsity and step
    caching off) on the same weights.  Returns (launches, sparse s,
    dense s)."""
    kern.reset_launches()
    marks = {}
    out, sparse_s = run_loop(torch, tm, ck, model, H_IMG, W_IMG, 'cuda',
                             callback=window_marks(torch, marks),
                             params=params)
    launches = dict(kern.LAUNCHES)
    print(f'{tag} sparse loop: {ck.steps} steps, depth {model.depth}+'
          f'{model.depth_single_blocks}, {sparse_s:.3f} s', flush=True)
    print(json.dumps({'path': tag, 'launches': launches}), flush=True)
    if out.shape != (1, H_IMG * W_IMG, model.in_channels):
        fail(f'{tag}: output shape {tuple(out.shape)}')
    if not bool(torch.isfinite(out).all()):
        fail(f'{tag}: non-finite values in the sparse loop output')
    missing = [k for k in expect if launches[k] == 0]
    if missing:
        fail(f'{tag}: kernels not launched on the main path: {missing}')
    extra = [k for k, n in launches.items() if n and k not in expect]
    if extra:
        fail(f'{tag}: kernels of another path launched: {extra}')
    del out
    torch.cuda.empty_cache()
    trace_sparse_steps(torch, tm, ck, model, (marks[9] - marks[1]) * 1e3,
                       tag, params)
    torch.cuda.empty_cache()
    dense_ck = ck.replace(
        attn=dataclasses.replace(ck.attn, is_enabled=False),
        mlp=dataclasses.replace(ck.mlp, is_enabled=False),
        step_caching=dataclasses.replace(ck.step_caching, is_enabled=False))
    out_d, dense_s = run_loop(torch, tm, dense_ck, model, H_IMG, W_IMG,
                              'cuda', params=params)
    if not bool(torch.isfinite(out_d).all()):
        fail(f'{tag}: non-finite values in the dense loop output')
    print(f'{tag} dense loop: {ck.steps} steps, {dense_s:.3f} s; sparse '
          f'speedup {dense_s / sparse_s:.3f}x', flush=True)
    del out_d
    torch.cuda.empty_cache()
    return launches, sparse_s, dense_s


def agree_small(torch, tm, kern, ck, model, tag, expect, params_cpu=None):
    """A small full-width model (depth 1+1, 128 text + 384 image tokens)
    for 4 steps holding the first, colsum, sparse and plain full kinds,
    no random keeps: the same weights (drawn on the CPU) run through the
    kernels on the card and through the plain versions on the CPU.  Mean
    relative difference of the outputs <= 2e-2 (bf16 model: the two sides
    round their matmuls differently).  Each kernel of ``expect`` must have
    launched in the card run."""
    kern.reset_launches()
    gpu_out, _ = run_loop(torch, tm, ck, model, 16, 24, 'cuda', 'cpu',
                          params=params_cpu)
    launches = dict(kern.LAUNCHES)
    cpu_out, cpu_s = run_loop(torch, tm, ck, model, 16, 24, 'cpu',
                              params=params_cpu)
    rel = ((gpu_out.cpu() - cpu_out).abs().mean()
           / cpu_out.abs().mean()).item()
    print(f'{tag} small-input agreement (card kernels vs CPU plain '
          f'versions): mean relative difference {rel:.3e}, launches '
          f'{ {k: n for k, n in launches.items() if n} }, CPU run '
          f'{cpu_s:.1f} s', flush=True)
    if not math.isfinite(rel) or rel > 2e-2:
        fail(f'{tag} small-input output differs from the plain versions: '
             f'{rel}')
    missing = [k for k in expect if launches[k] == 0]
    if missing:
        fail(f'{tag} small run: kernels not launched: {missing}')


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
    from chipmunk_torch.utils import quant
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
    qrows = []
    for kind in ('int8', 'int4'):
        qrows += quant_kernel_phases(torch, mods[2], mods[1], fp8, quant,
                                     kind)
        torch.cuda.empty_cache()
    prows = probe_phase(torch, importlib.import_module(
        'chipmunk_torch.kernels.int8_probe'))
    torch.cuda.empty_cache()

    # ---- the main paths: FLUX.1-dev sparse denoise loop, 50 steps, the
    # shipped config unchanged (mlp.int8_act: true); with bf16 weights the
    # MLP says int8_act is ignored and runs the bf16 kernels, as the
    # reference does
    ck = cfgmod.load_config(os.path.join(ROOT, 'configs',
                                         'flux-chipmunk.yml'))
    print(f'config: configs/flux-chipmunk.yml unchanged (mlp.int8_act='
          f'{str(ck.mlp.int8_act).lower()}), attn/mlp first_n_dense_layers='
          f'{ck.attn.first_n_dense_layers}/{ck.mlp.first_n_dense_layers}',
          flush=True)
    model = tm.FluxModelConfig()          # full width and depth, bf16
    launches, bf16_sparse_s, bf16_dense_s = drive_path(
        torch, kern, tm, ck, model, 'bf16', BF16_PATH)

    # (b) quantized weights as bench.py builds them; the bf16 model of
    # (a) lives only inside its loops and is freed by now
    t0 = time.perf_counter()
    qparams = quant.synth_quantized_flux_params(
        SEED, model, quant.QuantSpec(*SPEC), device='cuda')
    torch.cuda.synchronize()
    print(f'quantized weights synthesized on the host and moved to the card '
          f'in {time.perf_counter() - t0:.1f} s: '
          f'{quant.param_bytes(qparams) / 2 ** 30:.2f} GiB, QuantSpec'
          f'{SPEC}', flush=True)
    qlaunches, q_sparse_s, q_dense_s = drive_path(
        torch, kern, tm, ck, model, 'quantized', QUANT_PATH, qparams)
    print(f'quantized sparse loop {q_sparse_s:.3f} s: '
          f'{q_dense_s / q_sparse_s:.3f}x against the quantized dense loop '
          f'({q_dense_s:.3f} s), {bf16_dense_s / q_sparse_s:.3f}x against '
          f'the bf16 dense loop ({bf16_dense_s:.3f} s); bf16 sparse loop '
          f'{bf16_sparse_s:.3f} s', flush=True)
    del qparams
    torch.cuda.empty_cache()

    # ---- agreement on small inputs, each path
    small_ck = cfgmod.config_from_dict(
        {'steps': 4,
         'attn': {'full_step_every': 3, 'first_n_dense_layers': 0,
                  'top_keys': 0.5, 'dense_fallback_frac': 1.0},
         'mlp': {'full_step_every': 3, 'first_n_dense_layers': 0,
                 'random_keys': 0.0},
         'step_caching': {'is_enabled': False}}, ck)
    small = dataclasses.replace(model, depth=1, depth_single_blocks=1,
                                txt_len=128)
    agree_small(torch, tm, kern, small_ck, small, 'bf16', BF16_PATH)
    # the quantized path, then the other weight/activation variants
    # through the same model: int8_act off (wq), int4 sparse MLP weights
    # with (a8w4) and without (w4) int8 activations
    no_a8 = small_ck.replace(mlp=dataclasses.replace(small_ck.mlp,
                                                     int8_act=False))
    for tag, cfg, spec, kernels in (
            ('quantized', small_ck, SPEC, QUANT_PATH),
            ('quantized int8_act off', no_a8, SPEC,
             ('csp_mlp_mm1_wq', 'csp_mlp_mm2_wq')),
            ('int4 MLP', small_ck, ('int4',) * 4,
             ('quant_rows', 'csp_mlp_mm1_a8w4', 'csp_mlp_mm2_a8w4')),
            ('int4 MLP int8_act off', no_a8, ('int4',) * 4,
             ('csp_mlp_mm1_w4', 'csp_mlp_mm2_w4'))):
        agree_small(torch, tm, kern, cfg, small, tag, kernels,
                    quant.synth_quantized_flux_params(
                        SEED, small, quant.QuantSpec(*spec), device='cpu'))

    for r in rows:
        r['route'] = 'cuda'
        r['launches'] = launches[r['name']]
    for r in qrows + prows:             # this slice's path (wq, probe: 0)
        r['route'] = 'cuda'
        r['launches'] = qlaunches[r['name']]
    rows += qrows + prows
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
