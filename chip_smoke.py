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
   sparse-MLP kernels (their yardstick: the dense layer's torch.matmul or
   torch._int_mm scaled by the selected share), every sparse-MLP variant
   with bf16 caches, the bf16 pair and both int4-weight pairs also at
   bn = 128 and with bf16 caches, the a8 pair at bn = 512 (int8 and int4
   weights), both csp modes at kv_block 1, 2, 4, 8 and 16,
   ``dense_colsum_attn`` at score blocks of 1-32 keys (FLUX; 8, 16 and 32
   at 540p and 720p), the three kernels that take a query-group size at
   qg 64 and 256 (FLUX) and 192 (540p), and the int8/bf16 GEMM probe
   (on ``gemm_sm90_kernel``).  For the short rows
   (``csp_attn`` at FLUX, ``quant_rows``) and the MLP rows of the
   Hopper-template pairs it also gives the kernel's own device time from
   torch.profiler's kernel records (``device_ms``), since their ``ms``
   includes the wrappers' host work.
3. Drives the port's two main paths, each with the launch counts set to 0
   just before and read just after: ``FluxSampler.denoise`` over the
   50-step schedule of ``configs/flux-chipmunk.yml`` at 1280x768 with the
   full-width, full-depth FLUX.1-dev model, (a) with random bf16 weights
   from a seed, (b) with the quantized weights the JAX package ships
   (``synth_quantized_flux_params``, int4 attention/modulation, int8
   sparse MLP, int4 text MLP) and the config unchanged, so every sparse
   MLP step takes the int8-activation kernels, (c) with the same
   quantized weights and ``mlp.int8_act`` off, so every sparse MLP step
   takes the int8-weight, bf16-activation pair (``wq``); (b) and (c) at
   the first QUANT_DEPTH blocks.  Each checks that the output is finite
   and that each kernel ran exactly as often as ``flux_launches``
   counts, is traced over a window of sparse steps, and is timed against
   a dense loop (sparsity and step caching off) on the same weights ((c)
   against (b)'s: the dense path does not read ``int8_act``).  Each loop
   is then run compiled
   (``FluxSampler.denoise_compiled``: skipped steps folded, each
   computed step after a kind's first a CUDA graph replay), the sparse
   loop against the host sparse loop, the dense loop (for (a) and (b))
   against the host dense loop: launches equal kernel by kernel, output
   finite, its graphs, replays, capture time and graph pool printed, the
   compiled sparse loops of (a) and (b) traced whole.  A small
   full-width model is also run through each loop on the card and, with
   the plain versions, on the CPU, and the two must agree: each
   weight/activation variant, and the MLP with no cache dtype in the
   config (bf16 caches); with random keeps on, its compiled loop must
   match its host loop on the card (bf16 and quantized weights).
4. The HunyuanVideo slice: the csp kernels and the dense kernels at the
   video shapes (544x960x129 frames: 67,584 tokens, keys cut at 67,576,
   the 384-row dense tail, PAD_LSE rows; and 720p, 119,168 tokens, where
   a head's K+V exceeds the L2), each against its plain version on a
   slice, with bounds, TFLOP/s and the time of one
   ``scaled_dot_product_attention`` call computing the same function (for
   the csp kernels with a boolean block mask on a few heads, scaled to
   all 24: the mask of all heads does not fit the card); then
   HunyuanVideo's prompt encoders at full size in bf16 (random weights
   from a seed): LLaVA-LLaMA-3-8B's language model and CLIP-L through
   ``HunyuanTextEncoders.embed`` with stand-in tokenizers (the card's
   machine has no tokenizer package), one prompt under the video
   template (parameters, GB, draw seconds, encode ms, peak GiB; shapes,
   finite values, the pooled row the first EOT's; the first 2 layers on
   the card in bf16 against the CPU in float32 within LLAMA_TOL), the
   encoders released; then
   the main path ``hunyuan_denoise`` over the 50-step
   schedule of ``configs/hunyuan-chipmunk.yml`` (unchanged) at 540p with
   the full-width model cut to 1 double + 2 single blocks, random bf16
   weights from a seed, that prompt's (txt, txt_mask, vec), with its
   launch counts, a trace of a window of
   sparse steps, its dense loop and its compiled sparse loop
   (``hunyuan_denoise_compiled``, launches VIDEO_LAUNCHES too) and its
   streamed loop (``hunyuan_denoise(..., streamed=model.make_streamed(1,
   2))``: the config's offloading, attention caches in pinned host
   memory, one layer a chunk, every chunk streamed; equal to the host
   loop bit for bit,
   launches VIDEO_LAUNCHES; seconds, GB moved each way by step kind,
   device peak, pinned GiB); a small full-width video model on the card
   (csp mode 'auto' and 'hbm') against the plain versions on the CPU,
   and its compiled loop against its host loop with random keeps on;
   then HunyuanVideo as ``HunyuanModelConfig()`` stands (720x1280x129
   frames, 119,168 tokens, 20 + 40 blocks), random bf16 weights from a
   seed, the config as read, streamed one layer a chunk for the first
   STEPS_720 steps of its plan (the cut): output finite, launches the
   plan's count (``plan_launches``); the host's memory, the host link
   (``link_probe``), each step's seconds and bytes, the device peak,
   the pinned GiB and a labelled projection of the 50-step loop.
5. The Wan2.1 slice: ``dense_attn`` (self-attention over the keys cut at
   32,760, the 128-row dense tail, and the cross-attention of 32,768
   queries over 512 text keys), ``dense_colsum_attn`` and ``csp_attn``
   (the 'vmem' kernel, jmax 62, a count of 1 and of jmax on the cut last
   block) at Wan's shapes (12 heads), each against its plain version,
   with device times, bounds and the matching
   ``scaled_dot_product_attention`` call; the UMT5-XXL encoder at full
   size in bf16 (random weights from a seed) through
   ``WanTextEncoder.embed`` with a stand-in tokenizer on two prompts
   (cond, uncond), zeroed past each prompt; then the main path
   ``wan_denoise`` over the 50-step schedule of
   ``configs/wan-chipmunk.yml`` (as read) at 480x832x81 frames with
   Wan2.1-T2V-1.3B at full width and depth (30 layers), random bf16
   weights from a seed, two invocations a step, with its exact launch
   counts, a trace of a window of sparse steps, its dense loop and its
   compiled sparse loop (``wan_denoise_compiled``, launches WAN_LAUNCHES
   too); and a small full-width Wan on the card (csp mode 'auto' and
   'hbm') and a small UMT5 against the plain versions on the CPU, and the
   small Wan's compiled loop against its host loop with random keeps
   on.
6. Prompt to pixels.  After the FLUX loops, one FLUX.1-dev generation
   at 1280x768: T5-v1.1-XXL and CLIP-L at full size in bf16 (random
   weights from a seed) encode one prompt's ids and are released, then
   ``FluxSampler.denoise`` over configs/flux-chipmunk.yml on loop (a)'s
   weights, noise and keep seed with their txt / vec (launches equal to
   loop (a)'s, kernel by kernel; the encoders launch none of the port's
   kernels), then ``unpack`` and the FLUX autoencoder's ``decode`` at
   full size in float32 to a [1, 3, 768, 1280] image: one synchronised
   span from the ids on the card to the pixels, the encoders' release
   included, each stage timed within it (weights drawn and each stage
   called once before it).
   After each video path's loops its sparse loop's latent is decoded in
   float32 by its VAE (random weights from a seed): Wan's whole clip
   (its first 3 latent frames decoded alone must give its first 9
   frames: the decoder is prefix-closed), and HunyuanVideo's first
   HY_DECODE_N of 33 latent frames (a shorter video).  The decoders run
   PyTorch's default TF32 convolutions (DECODE_SETTING).  Then small T5,
   CLIP, FLUX autoencoder and video VAEs on the card against the CPU.
7. Checkpoint to latents (after the FLUX generation).  (a) FLUX.1-dev
   at full width and depth from a BFL state dict (the keys and shapes of
   tests/test_loaders.py's ``synth_state_dict``, drawn on the card one
   tensor at a time from a seed by a lazy mapping, bf16, weights at
   fan-in^-0.5) through ``load_flux_params`` with configs/flux-chipmunk.yml
   as read and ``mlp.is_fp8`` set: int8 sparse-MLP and fp8 text-MLP
   weights quantized on the card; the first double and single block
   torch.equal to the same loader on the CPU over the same tensors; the
   50-step host loop through ``cli.flux_generate.generate``, finite, with
   exact launch counts (``flux_launches``, which also gates loops (a) and
   (b) of 3); the loader's seconds, the GiB resident and the loop's
   seconds printed.  (b) ``mlp_fp8.f8_input_matmul`` (``torch._scaled_mm``)
   against its plain version at the FLUX dense-step shape, timed beside
   ``torch.matmul`` on the dequantized weight (its own line).  (c) The
   three generate CLIs run at once as subprocesses from .safetensors
   files written by ``safetensors_io.save_file``: FLUX at full width and
   depth 1 + 1, HunyuanVideo (streamed, as its config asks) and Wan at
   ``--tiny``; beside them HunyuanVideo with ``--prompt`` and tiny local
   ``--llm`` / ``--clip`` directories (stand-in tokenizers), and FLUX at
   ``--tiny`` with ``--profile`` in a temporary working directory; each
   must exit 0 with finite latents of their shape, the prompt's latents
   must differ from the zero-text run's and the trace must name the
   port's attention kernel.
8. Multi-card sampling (``parallel/``) on a world of one NCCL rank
   (``initialize_multihost`` on 127.0.0.1; the card's machine has one
   card and NCCL takes one rank a card): FLUX.1-dev at full width and
   depth, 1280x768, configs/flux-chipmunk.yml for 4 steps (first,
   colsum, two sparse) through ``FluxSampler.sharded(make_mesh({'sp':
   1}))``, with and without FSDP, each step's prediction torch.equal to
   the unsharded sampler's and the launches equal to its
   (``flux_launches``); HunyuanVideo at 540p, depth 1+2, the host and
   compiled loops of ``model.sharded(make_mesh({'dp': 1, 'sp': 1}))``
   for 4 steps torch.equal to the unsharded loops, launches the plan's
   (the compiled loop's collectives captured in its CUDA graphs); the
   ring's hop merge (``ring_hops``) over 4 key chunks of a FLUX-shaped
   q, k, v through ``dense_attn`` within its tolerance of
   ``dense_attn_plain`` over the whole keys, and ``ring_attention`` and
   ``usp_attention`` at world 1 equal to ``dense_attn``.  Seconds of
   each sharded run beside the unsharded one, the merge's ms beside one
   ``dense_attn`` call, the peak GiB allocated.
9. Prints the card line, one JSON line with the kernels' numbers, and as
   the last line ``{"ok": true, "device": {...}}``.

Any failed phase ends the script with a non-zero exit.  Without a CUDA
device, or without the ``chipmunk_torch`` package beside it, it exits
non-zero and prints no result.
"""
import collections.abc
import contextlib
import dataclasses
import importlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
# published dense peaks of one H100 SXM (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12
SEED = 0
# the port's kernels in a profiler trace: (label, part of the demangled
# name), first match wins; each gemm_sm90_kernel instantiation by its Op,
# so that the bf16 pair and the a8 pair are told apart
OUR_KERNELS = (
    ('attention (attn_sm90_kernel)', 'attn_sm90_kernel'),
    ('bf16 MLP mm1 (gemm_sm90_kernel<Mm1Bf16>)', 'mm1bf16<'),
    ('bf16 MLP mm2 (gemm_sm90_kernel<Mm2Bf16>)', 'mm2bf16<'),
    ('a8 MLP mm1 (gemm_sm90_kernel<Mm1A8>)', 'mm1a8<'),
    ('a8 MLP mm2 (gemm_sm90_kernel<Mm2A8>)', 'mm2a8<'),
    ('w4 MLP mm1 (gemm_sm90_kernel<Mm1W4>)', 'mm1w4<'),
    ('w4 MLP mm2 (gemm_sm90_kernel<Mm2W4>)', 'mm2w4<'),
    ('a8w4 MLP mm1 (gemm_sm90_kernel<Mm1A8W4>)', 'mm1a8w4<'),
    ('a8w4 MLP mm2 (gemm_sm90_kernel<Mm2A8W4>)', 'mm2a8w4<'),
    ('wq MLP mm1 (gemm_sm90_kernel<Mm1Wq>)', 'mm1wq<'),
    ('wq MLP mm2 (gemm_sm90_kernel<Mm2Wq>)', 'mm2wq<'),
    ('quant_rows', 'quant_rows_kernel'),
    ('int8/bf16 probe (gemm_sm90_kernel<ProbeS8|ProbeBf16>)', 'probe'))
BF16_PATH = ('dense_attn', 'dense_colsum_attn', 'csp_attn', 'csp_mlp_mm1',
             'csp_mlp_mm2')
QUANT_PATH = ('dense_attn', 'dense_colsum_attn', 'csp_attn', 'quant_rows',
              'csp_mlp_mm1_a8', 'csp_mlp_mm2_a8')
WQ_PATH = ('dense_attn', 'dense_colsum_attn', 'csp_attn', 'csp_mlp_mm1_wq',
           'csp_mlp_mm2_wq')
SPEC = ('int4', 'int4', 'int8', 'int4')    # QuantSpec of bench.py:62-67
# the quantized loops (b) and (c) run the first 10 + 19 of the 19 + 38
# blocks: the cut that made room for the checkpoint phase, whose is_fp8
# loop runs the a8 pair of (b) at full depth
QUANT_DEPTH = dict(depth=10, depth_single_blocks=19)
GEMM_NAMES = ('nvjet', 'gemm', 'cutlass', 'xmma', 'gemv')

B, H, S, D = 1, 24, 4352, 128          # FLUX.1-dev at 1280x768
H_IMG, W_IMG = 48, 80                  # latent patch grid: 3840 img tokens
T_SINGLE, C, N = 4608, 3072, 12288     # single-block MLP tokens (padded to bm)
# HunyuanVideo: latent (t, h, w) of 544x960 and 720x1280 at 129 frames,
# depth cut to 1 double + 2 single blocks (scripts/bench_hunyuan.py cuts
# to 2 + 4; 1 + 2 since the 720p full-depth phase took the room: the
# whole script ran 1112 s of its 1200 s at 2 + 4 on an H100 80GB HBM3
# host)
V540 = dict(latent_t=33, latent_h=68, latent_w=120)
V720 = dict(latent_t=33, latent_h=90, latent_w=160)
V_DEPTH = dict(depth_double=1, depth_single=2)
# HunyuanModelConfig() as it stands: 720x1280x129 frames, 20 + 40 blocks,
# streamed; the cut is the number of steps (the first STEPS_720 of 50:
# step 0 full, step 1 colsum, steps 2-3 sparse).  720p, not 544x960: the
# H100 host read MemTotal 101.00 GiB, MemAvailable 96.56 GiB, and 53.69
# GiB stayed available with the 41.06 GiB of caches page-locked
V_FULL = {}
STEPS_720 = 4
LIB_HEADS = 4     # heads of the 540p scaled_dot_product_attention yardstick
VIDEO_PATH = ('dense_attn', 'dense_colsum_attn', 'csp_attn_hbm')
# the schedule's count (plan_launches): 25 computed steps; step 0 runs 3
# dense layers; steps 1, 10, 40 run 2 dense (first_n_dense_layers) + 1
# colsum (+ 1 csp); the 21 sparse steps run 2 dense layers, 1 csp and 1
# dense tail
VIDEO_LAUNCHES = {'dense_attn': 72, 'dense_colsum_attn': 3,
                  'csp_attn_hbm': 24}
# Wan2.1-T2V-1.3B at 480x832x81 frames: latent (21, 60, 104), 32,760
# tokens padded to 32,768, 12 heads, 30 layers (scripts/bench_wan.py)
WAN_LATENT = dict(latent_t=21, latent_h=60, latent_w=104)
WAN_H = 12
WAN_PATH = ('dense_attn', 'dense_colsum_attn', 'csp_attn')
# per generation, two invocations a computed step: 25 computed steps x 2
# x 30 cross-attentions (1500) + 2 dense layers (100) + step 0's 28 sparse
# layers (56) + the 21 sparse steps' 28 dense tails (1176); colsum steps
# 1, 10, 40: 28 x 2 colsums and csp each; 21 sparse steps: 28 x 2 csp
WAN_LAUNCHES = {'dense_attn': 2832, 'dense_colsum_attn': 168,
                'csp_attn': 1344}
WAN_DENSE_LAUNCHES = {'dense_attn': 6000}
# UMT5-XXL prompts: two rows of 512 ids, valid prefixes of these lengths
# (cond, uncond)
UMT5_VALID = (93, 27)
# the prompts the stand-in tokenizers encode (one id a character)
WAN_PROMPT = 'A red fox runs through deep snow at dawn, cinematic. '
HY_PROMPT = 'A cat walks on the grass, realistic style.'
# LLaVA-LLaMA-3-8B against the CPU: a 2-layer full-width trunk in bf16 on
# the card, float32 on the CPU, every hidden state within a mean relative
# difference of LLAMA_TOL and a largest difference of LLAMA_TOL of its
# largest magnitude (the bf16 tolerance of tests/test_torch_llama.py)
LLAMA_TOL = 2e-2
# HunyuanVideo's VAE decodes the first HY_DECODE_N of the 540p loop's 33
# latent frames (4 * 19 + 1 = 77 of 129 frames): the largest N whose
# reserved peak left at least 8 GiB of an 80 GB H100's 79.2 GiB in a sweep
# of chipmunk_torch/tools/decode_phases.py --sweep (N = 20: 61.04 GiB
# allocated, 68.83 reserved; 22: 74.75 reserved; 26 out of memory; about
# 3 GiB a latent frame); its group norms span the clip, so this is a
# shorter video, not a prefix
HY_DECODE_N = 20


def fail(msg):
    print(f'chip_smoke: FAILED: {msg}', file=sys.stderr)
    sys.exit(1)


class StandInTokenizer:
    """A tokenizer's call as the prompt holders make it (the card's
    machine has no tokenizer package): one id a character (its code point
    folded below ``vocab - 1``), then ``eot`` where given, padded with
    ``pad`` to max_length and cut there; a text that starts with
    ``prefix`` takes ``prefix_len`` ids for it, as LLaMA-3's tokenizer
    cuts HunyuanVideo's instruction template into 95."""

    def __init__(self, vocab, pad, eot=None, prefix=None, prefix_len=0):
        self.vocab, self.pad, self.eot = vocab, pad, eot
        self.prefix, self.prefix_len = prefix, prefix_len

    def __call__(self, texts, max_length, padding='max_length',
                 truncation=True, return_tensors='np'):
        import numpy as np
        ids = np.full((len(texts), max_length), self.pad, np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for b, t in enumerate(texts):
            row = []
            if self.prefix and t.startswith(self.prefix):
                row = [(7 * i + 3) % (self.vocab - 1)
                       for i in range(self.prefix_len)]
                t = t[len(self.prefix):]
            row += [ord(ch) % (self.vocab - 1) for ch in t]
            if self.eot is not None:
                row.append(self.eot)
            row = row[:max_length]
            ids[b, :len(row)], mask[b, :len(row)] = row, 1
        return {'input_ids': ids, 'attention_mask': mask}


def llm_tokenizer(vocab):
    from chipmunk_torch.models import (PROMPT_TEMPLATE_ENCODE_VIDEO,
                                       VIDEO_CROP_START)
    return StandInTokenizer(vocab, vocab - 1,
                            prefix=PROMPT_TEMPLATE_ENCODE_VIDEO.split('{}')[0],
                            prefix_len=VIDEO_CROP_START)


def local_tokenizer(path, who):
    """``video_encoders.load_tokenizer``'s stand-in for a twin run on the
    card's machine: the stand-in of the directory's model (its
    config.json: a LLaMA, a CLIP text tower, else UMT5's ids)."""
    cfg_file = os.path.join(path, 'config.json')
    with open(cfg_file) as f:
        d = json.load(f)
    if d.get('model_type') == 'llama':
        return llm_tokenizer(d['vocab_size'])
    return StandInTokenizer(d['vocab_size'], d['vocab_size'] - 1,
                            eot=d['vocab_size'] - 1)


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


def device_ms(torch, fn, n):
    """(ms, kernel name): device time per call of the longest-running CUDA
    kernel that ``fn`` launches, from torch.profiler's kernel records over
    ``n`` calls; the wrapper's host work and any small torch kernels it
    launches are left out.  The profiler has been seen to drop one record
    of a long kernel (~10 ms, at Wan's shapes): the mean is then taken
    over the records it kept, and said so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    top = max((e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA),
              key=lambda e: e.self_device_time_total, default=None)
    if top is None:
        fail('device_ms: the profiler recorded no CUDA kernel')
    if top.count > n:
        fail(f'device_ms: {top.key} ran {top.count} times in {n} calls')
    if top.count < n:
        print(f'device_ms: the profiler kept {top.count} records of '
              f'{top.key[:80]} in {n} calls; their mean', flush=True)
    return top.self_device_time_total / 1e3 / top.count, top.key


def kernel_names(torch, fn, n=5):
    """The set of names (without namespace and template arguments) of the
    CUDA kernels that ``n`` calls of ``fn`` launch, from torch.profiler's
    kernel records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key.split('<')[0].split()[-1].split('::')[-1]
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def fp8_ulp(torch, x, dtype=None):
    """Spacing of float8 e4m3 at |x| (2^-9 in the subnormal range), or
    with dtype bf16 of bf16, taken at 2^-8 at least (3.1e-5): an entry
    below that comes out of cancellation, in gelu's 1 + tanh or in sums of
    thousands of products (fc1 over C = 3072, the out cache's old + delta
    @ w2 over up to 5632 rows), where the kernels' tensor-core sums and
    the plain versions' float32 sums, in another order, differ by up to
    ~1.5e-5 (measured at the FLUX shape, NVIDIA H100 80GB HBM3, 700.00 W;
    the fp8 floor, 2^-9, is coarser still)."""
    if dtype == torch.bfloat16:
        e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -8)))
        return torch.exp2(e - 7)
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
    """Caches (fp8 e4m3 or bf16): NaN at the same places, elsewhere within
    one ulp of their type (the kernel and the plain version sum in
    different orders, so a value near a rounding boundary may land on the
    neighbour)."""
    if got.dtype != ref.dtype:
        fail(f'{name}: dtype {got.dtype}, plain version {ref.dtype}')
    g, r = got.float(), ref.float()
    if not bool((g.isnan() == r.isnan()).all()):
        fail(f'{name}: NaN positions differ')
    ok = ~r.isnan()
    err = (g - r).abs()[ok]
    bad = err > fp8_ulp(torch, r[ok], got.dtype)
    if bool(bad.any()):
        i = int(bad.nonzero()[0, 0])
        fail(f'{name}: {got.dtype} values differ by more than one ulp at '
             f'{int(bad.sum())} of {bad.numel()} entries (first: '
             f'{g[ok][i].item()!r} against {r[ok][i].item()!r}; max abs err '
             f'{err.max().item():.3e})')
    return err.max().item()


def dense_library_ms(torch, tag, fn, share):
    """library_ms of a sparse-MLP row: one PyTorch call over the dense
    layer's products at the same shape, scaled by the selected share of
    (token block, neuron block) pairs; the unscaled time (what the dense
    step pays for the whole layer) is printed."""
    ms = time_ms(torch, fn, 10)
    print(f'{tag}: dense {ms:.4f} ms for the whole layer; x selected share '
          f'{share:.4f} = {ms * share:.4f} ms', flush=True)
    return ms * share


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
    for r in rows:
        print(f"{r['name']} (FLUX): {attn_flops / r['ms'] / 1e9:.1f} TFLOP/s",
              flush=True)

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
    mask = block_mask(torch, pinds, counts, 128, nb)
    dev_ms, dev_name = device_ms(
        torch, lambda: ca.csp_attn(q, k, v, inds, counts), 20)
    rows.append(dict(
        name='csp_attn', source='chipmunk_torch/csrc/csp_attention.cu',
        replaces='chipmunk_tpu/kernels/csp_attention.py:102',
        max_abs_err=err,
        ms=time_ms(torch, lambda: ca.csp_attn(q, k, v, inds, counts), 20),
        plain_ms=time_ms(torch, lambda: ca.csp_attn_plain(
            q, k, v, pinds, counts), 3),
        bound_ms=bnd, bound_by=by,
        library_ms=time_ms(torch, lambda: torch.nn.functional
                           .scaled_dot_product_attention(
                               q, k, v, attn_mask=mask), 5),
        device_ms=dev_ms))
    flops = csp_flops(counts)
    print(f"csp_attn (FLUX): {flops / 1e9:.2f} GFLOP; "
          f"{flops / rows[-1]['ms'] / 1e9:.1f} TFLOP/s with the wrapper "
          f"({rows[-1]['ms']:.4f} ms), {flops / dev_ms / 1e9:.1f} TFLOP/s "
          f"on the device ({dev_ms:.4f} ms, {dev_name[:90]})", flush=True)
    del q, k, v, o, o_p, cs, cs_p, mask

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
    share = nsel * bm * bn / (T_SINGLE * N)
    dense = randn(T_SINGLE, N)              # a dense delta, for fc2

    def mm1():
        return cm.csp_mlp_mm1(x, w1t, b1, act_t, minds, mcounts, bn=bn,
                              bm=bm)

    rows.append(dict(
        name='csp_mlp_mm1', source='chipmunk_torch/csrc/csp_mlp.cu',
        replaces='chipmunk_tpu/kernels/csp_mlp.py:326',   # fc1 half
        max_abs_err=err, ms=time_ms(torch, mm1, 20),
        device_ms=device_ms(torch, mm1, 20)[0],
        plain_ms=time_ms(torch, lambda: cm.csp_mlp_mm1_plain(
            x, w1t, b1, act, pminds, mcounts, bn, bm), 3),
        bound_ms=bnd, bound_by=by,
        library_ms=dense_library_ms(
            torch, 'csp_mlp_mm1 yardstick torch.matmul [4608, 3072] x '
            '[3072, 12288] (bf16)', lambda: torch.matmul(x, w1t.t()),
            share)))

    out_k = cm.csp_mlp_mm2(pk_p, w2, out.clone(), minds, mcounts, bn=bn,
                           bm=bm)
    torch.cuda.synchronize()
    out_p = cm.csp_mlp_mm2_plain(pk_p, w2, out, pminds, mcounts, bn, bm)
    err = check_fp8(torch, 'csp_mlp_mm2 out_cache', out_k, out_p)
    bnd, by = bound_ms(mm_flops, nsel * bm * bn * 2 + w_bytes
                       + 2 * T_SINGLE * C)
    out_t = out.clone()

    def mm2():
        return cm.csp_mlp_mm2(pk_p, w2, out_t, minds, mcounts, bn=bn, bm=bm)

    rows.append(dict(
        name='csp_mlp_mm2', source='chipmunk_torch/csrc/csp_mlp.cu',
        replaces='chipmunk_tpu/kernels/csp_mlp.py:326',   # fc2 half
        max_abs_err=err, ms=time_ms(torch, mm2, 20),
        device_ms=device_ms(torch, mm2, 20)[0],
        plain_ms=time_ms(torch, lambda: cm.csp_mlp_mm2_plain(
            pk_p, w2, out, pminds, mcounts, bn, bm), 3),
        bound_ms=bnd, bound_by=by,
        library_ms=dense_library_ms(
            torch, 'csp_mlp_mm2 yardstick torch.matmul [4608, 12288] x '
            '[12288, 3072] (bf16)', lambda: torch.matmul(dense, w2),
            share)))
    del dense
    for r in rows[-2:]:
        print(f"{r['name']} (FLUX, bf16 weights): "
              f"{mm_flops / r['device_ms'] / 1e9:.1f} TFLOP/s on the device "
              f"({r['device_ms']:.4f} ms)", flush=True)
    bf16_mlp_variants(torch, cm, ca, fp8, x, w1t, b1, w2, gen)
    print_rows(rows)
    return rows


def block_mask(torch, pinds, counts, kv_block, nb, kv_valid=None):
    """bool [B,H,Sq,Sk]: true where a query's group selected the key's
    block (and the key lies before kv_valid): the mask with which one
    scaled_dot_product_attention call computes csp_attn's function."""
    from chipmunk_torch.ops.attn_ref import gather_mask_from_indices
    m = gather_mask_from_indices(pinds, counts, nb)
    m = m.repeat_interleave(128, 2).repeat_interleave(kv_block, 3)
    if kv_valid is not None:
        m[..., kv_valid:] = False
    return m


def csp_flops(counts, D=D, kv_block=128, qg=128):
    """4 * qg * kv_block * D FLOP per selected (group, block)."""
    return 4.0 * qg * kv_block * D * counts.sum().item()


def csp_library_ms(torch, q, k, v, pinds, counts, nb, kv_valid, heads, n):
    """ms of one scaled_dot_product_attention call with the boolean block
    mask over the first ``heads`` heads: the mask of all heads does not
    fit the card (4.6 GB a head at 540p, 14.2 GB at 720p, and the call
    makes a bf16 bias of twice that)."""
    torch.cuda.empty_cache()
    mask = block_mask(torch, pinds[:, :heads], counts[:, :heads], 128, nb,
                      kv_valid)
    q1, k1, v1 = (x[:, :heads] for x in (q, k, v))
    ms = time_ms(torch, lambda: torch.nn.functional
                 .scaled_dot_product_attention(q1, k1, v1, attn_mask=mask),
                 n)
    del mask, q1, k1, v1
    torch.cuda.empty_cache()
    return ms


def csp_bound(torch, pinds, counts, q, kv_block=128, qg=128):
    """(bound ms, by) of a csp call: 4*qg*kv_block*D FLOP per selected
    (group, block); bytes: q and o once, each block some group of its
    head selected once (K and V), the index lists."""
    B, H, Sq, D = q.shape
    nb = int(pinds.max().item()) + 1
    sel = torch.zeros((B, H, nb), dtype=torch.bool, device=q.device)
    sel.scatter_(-1, pinds.long().reshape(B, H, -1), True)
    nbytes = (int(sel.sum().item()) * kv_block * D * 2 * 2
              + 2 * B * H * Sq * D * 2 + pinds.numel() * 4
              + counts.numel() * 4)
    return bound_ms(csp_flops(counts, D, kv_block, qg), nbytes)


def video_selection(torch, mod, H, gen):
    """The main path's selection (SparseDiffAttn._select_mask and
    _mask_to_inds: top-k, random keep, static text blocks, dense tail)
    over random column sums: padded block ids and counts [1,H,G,jmax]."""
    from chipmunk_torch.kernels.csp_attention import pad_block_indices
    G, nb = mod.seq_len // 128, mod.seq_len // mod.cfg.kv_block
    cs = torch.rand((1, H, G, nb), generator=gen, device='cuda')
    inds, counts = mod._mask_to_inds(mod._select_mask(cs, generator=gen))
    return pad_block_indices(inds, counts).to(torch.int32), counts


def video_kernel_phases(torch, mods, tm, ck):
    """The kernels of the video path at its shapes, against their plain
    versions on slices (a full-shape plain version would need tens of GB):
      540p (67,584 tokens, valid 67,576, jmax 44, selection as the main
        path makes it from random column sums): csp_attn_hbm on all 24
        heads, held against csp_attn_hbm_plain on head 0; dense_attn with
        the cut keys (rows 0-127 and the last 256, pad rows included), the
        384-row dense tail as a view of q, dense_colsum_attn with PAD_LSE
        on the pad rows (groups 0-1 and the tail groups), each to the
        tolerances of kernel_phases; csp_attn (the 'vmem' kernel) on the
        same inputs, and the pack;
      720p (119,168 tokens, valid 119,056, jmax 77): csp_attn_hbm against
        the 'vmem' kernel on all heads and against the plain version on
        head 0, groups 0-511; times of csp_attn_hbm, the pack, csp_attn
        and dense_attn.
    library_ms of the csp_attn_hbm row: scaled_dot_product_attention with
    the boolean block mask on LIB_HEADS heads (a [67584, 67584] mask is
    4.6 GB per head, and the call makes a bf16 bias of it, 9.1 GB; all 24
    heads would not fit); plain_ms on head 0.  Both csp kernels compute
    the same function on the same inputs, so one library time serves
    both, scaled to 24 heads (540p: heads 0-3 x 6; 720p: head 0 x 24).
    TFLOP/s of each csp time: csp_flops over it."""
    fa, ca = mods[0], mods[1]
    gen = torch.Generator('cuda')
    gen.manual_seed(SEED + 3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device='cuda').to(
            torch.bfloat16)

    out = {}
    # ------------------------------------------------------------- 540p
    m540 = tm.HunyuanModel(cfg=tm.HunyuanModelConfig(**V540, **V_DEPTH),
                           ck=ck)
    mod = m540.sp.attn_s
    S, n, jmax = mod.seq_len, mod.valid_len, mod.jmax
    t0, nb = mod.dense_tail_g * 128, S // 128
    q, k, v = randn(B, H, S, D), randn(B, H, S, D), randn(B, H, S, D)
    pinds, counts = video_selection(torch, mod, H, gen)
    mode = ca.auto_mode(S, S, D, jmax, 128, 2)
    print(f'video 540p: seq {S} (valid {n}), jmax {jmax}, dense tail from '
          f'row {t0}, auto csp mode {mode!r}, selected blocks per group '
          f'mean {counts.float().mean().item():.2f} max '
          f'{counts.max().item()}', flush=True)
    if (S, n, jmax, t0, mode) != (67584, 67576, 44, 67200, 'hbm'):
        fail(f'540p shape is not the expected one: {(S, n, jmax, t0, mode)}')
    kv = ca.pack_kv(k, v, 128)
    o = ca.csp_attn_hbm(q, kv, pinds, counts, kv_valid=n)
    torch.cuda.synchronize()
    o_p = ca.csp_attn_hbm_plain(q[:, :1], kv[:1], pinds[:, :1],
                                counts[:, :1], kv_valid=n)
    err = check_close('csp_attn_hbm o (540p, head 0)', o[:, :1], o_p, 4e-3,
                      2 ** -6)
    del o_p
    o_v = ca.csp_attn(q, k, v, pinds, counts, kv_valid=n, mode='vmem')
    torch.cuda.synchronize()
    check_close('csp_attn_hbm vs csp_attn (540p)', o, o_v, 4e-3, 2 ** -6)
    del o_v
    bnd, by = csp_bound(torch, pinds, counts, q)
    flops = csp_flops(counts)
    plain_ms = time_ms(torch, lambda: ca.csp_attn_hbm_plain(
        q[:, :1], kv[:1], pinds[:, :1], counts[:, :1], kv_valid=n), 1)
    lib_ms = csp_library_ms(torch, q, k, v, pinds, counts, nb, n, LIB_HEADS,
                            3)
    row = dict(name='csp_attn_hbm',
               source='chipmunk_torch/csrc/csp_attention.cu',
               replaces='chipmunk_tpu/kernels/csp_attention.py:193',
               max_abs_err=err,
               ms=time_ms(torch, lambda: ca.csp_attn_hbm(
                   q, kv, pinds, counts, kv_valid=n), 10),
               plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
               library_ms=lib_ms, plain_scope='head 0 of 24',
               library_scope=f'heads 0-{LIB_HEADS - 1} of 24')
    out['540 csp_attn_hbm TFLOP/s'] = flops / row['ms'] / 1e9
    out['540 pack_kv ms'] = time_ms(torch, lambda: ca.pack_kv(k, v, 128), 10)
    out['540 csp_attn (vmem kernel) ms'] = time_ms(
        torch, lambda: ca.csp_attn(q, k, v, pinds, counts, kv_valid=n,
                                   mode='vmem'), 10)
    out['540 csp_attn (vmem kernel) TFLOP/s'] = \
        flops / out['540 csp_attn (vmem kernel) ms'] / 1e9
    out['540 csp_attn (vmem kernel) bound ms'] = bnd
    out[f'540 csp library ms (SDPA, block mask, heads 0-{LIB_HEADS - 1} '
        f'x {H // LIB_HEADS})'] = lib_ms * H / LIB_HEADS
    del kv

    kc, vc = k[..., :n, :], v[..., :n, :]      # views: no copy
    od, lse = fa.dense_attn(q, kc, vc)
    torch.cuda.synchronize()
    for r in (slice(0, 128), slice(S - 256, S)):
        o_p, lse_p = fa.dense_attn_plain(q[..., r, :], kc, vc)
        err_d = check_close('dense_attn o (540p)', od[..., r, :], o_p, 4e-3,
                            2 ** -6)
        check_close('dense_attn lse (540p)', lse[..., r], lse_p, 1e-3, 0.0)
    ot, _ = fa.dense_attn(q[..., t0:, :], kc, vc)
    torch.cuda.synchronize()
    if not torch.equal(ot, od[..., t0:, :]):
        fail('dense_attn: the 384-row tail differs from the same rows of '
             'the full call')
    o_p, _ = fa.dense_attn_plain(q[..., t0:, :], kc, vc)
    check_close('dense_attn tail o (540p)', ot, o_p, 4e-3, 2 ** -6)
    out['540 dense_attn max_abs_err'] = err_d
    flops = 4.0 * B * H * S * n * D
    attn_bytes = B * H * (2 * S + 2 * n) * D * 2
    out['540 dense_attn ms'] = time_ms(torch, lambda: fa.dense_attn(
        q, kc, vc), 3)
    out['540 dense_attn TFLOP/s'] = flops / out['540 dense_attn ms'] / 1e9
    out['540 dense_attn bound ms'] = bound_ms(flops, attn_bytes
                                              + B * H * S * 4)[0]
    out['540 dense_attn library ms (SDPA, keys cut)'] = time_ms(
        torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kc, vc), 3)
    tail_flops = 4.0 * B * H * (S - t0) * n * D
    out['540 dense tail (384 rows) ms'] = time_ms(
        torch, lambda: fa.dense_attn(q[..., t0:, :], kc, vc), 10)
    out['540 dense tail (384 rows) TFLOP/s'] = \
        tail_flops / out['540 dense tail (384 rows) ms'] / 1e9
    out['540 dense tail (384 rows) bound ms'] = bound_ms(
        tail_flops, B * H * (2 * (S - t0) + 2 * n) * D * 2
        + B * H * (S - t0) * 4)[0]
    from chipmunk_torch.ops.attn_ref import PAD_LSE
    prev = lse.clone()
    prev[..., n:] = PAD_LSE
    oc, cs, lc = fa.dense_colsum_attn(q, kc, vc, prev)
    torch.cuda.synchronize()
    for r in (slice(0, 256), slice(t0, S)):
        o_p, cs_p, lse_p = fa.dense_colsum_attn_plain(q[..., r, :], kc, vc,
                                                      prev[..., r])
        check_close('dense_colsum_attn o (540p)', oc[..., r, :], o_p, 4e-3,
                    2 ** -6)
        check_close('dense_colsum_attn lse (540p)', lc[..., r], lse_p, 1e-3,
                    0.0)
        check_close('dense_colsum_attn colsums (540p)',
                    cs[:, :, r.start // 128:r.stop // 128], cs_p, 1e-4, 1e-3)
    out['540 dense_colsum_attn ms'] = time_ms(
        torch, lambda: fa.dense_colsum_attn(q, kc, vc, prev), 3)
    out['540 dense_colsum_attn TFLOP/s'] = \
        flops / out['540 dense_colsum_attn ms'] / 1e9
    out['540 dense_colsum_attn bound ms'] = bound_ms(
        flops, attn_bytes + B * H * S * 8 + cs.numel() * 4)[0]
    del q, k, v, kc, vc, o, od, ot, o_p, oc, cs, lc, lse, prev, m540
    torch.cuda.empty_cache()

    # ------------------------------------------------------------- 720p
    m720 = tm.HunyuanModel(cfg=tm.HunyuanModelConfig(**V720, **V_DEPTH),
                           ck=ck)
    mod = m720.sp.attn_s
    S, n, jmax = mod.seq_len, mod.valid_len, mod.jmax
    print(f'video 720p: seq {S} (valid {n}), jmax {jmax}', flush=True)
    if (S, n, jmax) != (119168, 119056, 77):
        fail(f'720p shape is not the expected one: {(S, n, jmax)}')
    q, k, v = randn(B, H, S, D), randn(B, H, S, D), randn(B, H, S, D)
    pinds, counts = video_selection(torch, mod, H, gen)
    kv = ca.pack_kv(k, v, 128)
    o = ca.csp_attn_hbm(q, kv, pinds, counts, kv_valid=n)
    o_v = ca.csp_attn(q, k, v, pinds, counts, kv_valid=n, mode='vmem')
    torch.cuda.synchronize()
    check_close('csp_attn_hbm vs csp_attn (720p)', o, o_v, 4e-3, 2 ** -6)
    del o_v
    R = 512 * 128
    o_p = ca.csp_attn_hbm_plain(q[:, :1, :R], kv[:1], pinds[:, :1, :512],
                                counts[:, :1, :512], kv_valid=n)
    out['720 csp_attn_hbm max_abs_err (head 0, groups 0-511)'] = \
        check_close('csp_attn_hbm o (720p)', o[:, :1, :R], o_p, 4e-3,
                    2 ** -6)
    del o_p
    out['720 csp_attn_hbm bound ms'] = csp_bound(torch, pinds, counts, q)[0]
    flops = csp_flops(counts)
    out['720 csp_attn_hbm ms'] = time_ms(torch, lambda: ca.csp_attn_hbm(
        q, kv, pinds, counts, kv_valid=n), 5)
    out['720 csp_attn_hbm TFLOP/s'] = flops / out['720 csp_attn_hbm ms'] / 1e9
    out['720 pack_kv ms'] = time_ms(torch, lambda: ca.pack_kv(k, v, 128), 5)
    out['720 csp_attn (vmem kernel) ms'] = time_ms(
        torch, lambda: ca.csp_attn(q, k, v, pinds, counts, kv_valid=n,
                                   mode='vmem'), 5)
    out['720 csp_attn (vmem kernel) TFLOP/s'] = \
        flops / out['720 csp_attn (vmem kernel) ms'] / 1e9
    out['720 csp_attn (vmem kernel) bound ms'] = \
        out['720 csp_attn_hbm bound ms']
    del kv
    kc, vc = k[..., :n, :], v[..., :n, :]
    flops = 4.0 * B * H * S * n * D
    out['720 dense_attn ms'] = time_ms(torch, lambda: fa.dense_attn(
        q, kc, vc), 2)
    out['720 dense_attn TFLOP/s'] = flops / out['720 dense_attn ms'] / 1e9
    out['720 dense_attn bound ms'] = bound_ms(
        flops, B * H * (2 * S + 2 * n) * D * 2 + B * H * S * 4)[0]
    out['720 dense_attn library ms (SDPA, keys cut)'] = time_ms(
        torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kc, vc), 2)
    del kc, vc, o
    torch.cuda.empty_cache()
    for key, val in out.items():
        print(f'video kernels: {key} {val:.4f}', flush=True)
    key = f'720 csp library ms (SDPA, block mask, head 0 x {H})'
    out[key] = csp_library_ms(torch, q, k, v, pinds, counts, S // 128, n, 1,
                              2) * H
    print(f'video kernels: {key} {out[key]:.4f}', flush=True)
    del q, k, v, m720
    torch.cuda.empty_cache()
    print_rows([row])
    return row, out


def print_json(rows):
    keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
            'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms',
            'device_ms', 'plain_scope', 'library_scope')
    print(json.dumps({'kernels': [{k: r[k] for k in keys if k in r}
                                  for r in rows]}), flush=True)


def print_rows(rows):
    for r in rows:
        print(f"kernel {r['name']}: max_abs_err {r['max_abs_err']:.3e} "
              f"ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
              f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}) "
              f"library_ms {r['library_ms']}"
              + (f" device_ms {r['device_ms']:.4f}" if 'device_ms' in r
                 else ''), flush=True)


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
    The wq pair runs as csp_mlp_fused calls it (mm1 multiplies the delta
    by bf16(w2s), mm2 takes it prescaled); its device times alone (mm2
    scaling in place) are printed too.
    library_ms: torch._int_mm (a8, on the int8 codes) or torch.matmul
    (wq/w4, on the dequantized bf16 weights) over the dense layer's
    products, scaled by the selected share (dense_library_ms); null for
    quant_rows.  The a8w4 rows also carry device_ms, taken from the
    Mm1A8W4 / Mm2A8W4 instantiations of gemm_sm90_kernel (their trace
    labels), as do the wq and w4 rows, and the a8w4 pair runs once more at
    bn = 128 with bf16 caches (a8w4_bn128)."""
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

    def row(name, replaces, err, ms, plain_ms, ops_, nbytes, peak,
            lib=None):
        bnd, by = bound_ms(ops_, nbytes, peak)
        rows.append(dict(name=name, source='chipmunk_torch/csrc/csp_mlp.cu',
                         replaces=replaces, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                         library_ms=lib))

    share = nsel * bm * bn / (T * N)
    codes = importlib.import_module('chipmunk_torch.kernels.csp_mlp')._codes
    # B column-major ([K, N] as the transpose of a contiguous [N, K]): the
    # layout torch._int_mm's cuBLASLt int8 kernels take fastest
    c1t, c2 = codes(w1).t(), codes(w2).t().contiguous().t()
    d1, d2 = (quant.dequant(w, torch.bfloat16) for w in (w1, w2))
    dense8 = torch.randint(-127, 128, (T, N), generator=gen, device=dev,
                           dtype=torch.int8)
    dense16 = randn(T, N)
    shape1, shape2 = ('[4608, 3072] x [3072, 12288]',
                      '[4608, 12288] x [12288, 3072]')

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
        rows[-1]['device_ms'], name = device_ms(
            torch, lambda: cm.quant_rows(x), 20)
        print(f"quant_rows: {rows[-1]['device_ms']:.4f} ms on the device "
              f"({name[:90]}), {rows[-1]['ms']:.4f} ms with the wrapper",
              flush=True)

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
        + N * 10 + T * 4, PEAK_INT8_OPS,
        dense_library_ms(torch, f'csp_mlp_mm1_{a8} yardstick torch._int_mm '
                         f'{shape1}', lambda: torch._int_mm(x8, c1t), share))
    if w4:
        rows[-1]['device_ms'] = kernel_device_ms(
            torch, 'csp_mlp_mm1_a8w4 (FLUX)', 'mm1a8w4<',
            lambda: cm.csp_mlp_mm1_a8(x8, sx, w1, b1, w2.scale, act_t, inds,
                                      counts, bn=bn, bm=bm))

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
        PEAK_INT8_OPS,
        dense_library_ms(torch, f'csp_mlp_mm2_{a8} yardstick torch._int_mm '
                         f'{shape2}', lambda: torch._int_mm(dense8, c2),
                         share))
    if w4:
        rows[-1]['device_ms'] = kernel_device_ms(
            torch, 'csp_mlp_mm2_a8w4 (FLUX)', 'mm2a8w4<',
            lambda: cm.csp_mlp_mm2_a8(d8_p, sd_p, w2, out_t, inds, counts,
                                      bn=bn, bm=bm))
    del d8, sd, d8_p, sd_p, act_k, act_p, out_k, out_p

    # ---- csp_mlp_mm1_wq, as the main path calls it (csp_mlp_fused): with
    # int8 weights mm1 multiplies the packed delta by bf16(w2s) for mm2
    s2, pre = ({}, {}) if w4 else ({'w2': w2}, {'prescaled': True})
    pk, act_k = cm.csp_mlp_mm1(x, w1, b1, act.clone(), inds, counts, bn=bn,
                               bm=bm, **s2)
    torch.cuda.synchronize()
    pk_u, act_p = cm.csp_mlp_mm1_plain(x, w1, b1, act, pinds, counts, bn, bm)
    pk_p = pk_u if w4 else cm._prescale(pk_u, w2, pinds, bn)
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
            x, w1, b1, act_t, inds, counts, bn=bn, bm=bm, **s2), 20),
        time_ms(torch, lambda: cm.csp_mlp_mm1_plain(
            x, w1, b1, act, pinds, counts, bn, bm), 3),
        ops, T * C * 2 + w_rows * wC + 2 * sel_bytes + pk.numel() * 2
        + N * 6, PEAK_BF16_FLOPS,
        dense_library_ms(torch, f'csp_mlp_mm1_{wq} yardstick torch.matmul '
                         f'{shape1} (dequantized bf16)',
                         lambda: torch.matmul(x, d1.t()), share))
    rows[-1]['device_ms'] = kernel_device_ms(
        torch, f'csp_mlp_mm1_{wq} (FLUX)', f'mm1{wq}<',
        lambda: cm.csp_mlp_mm1(x, w1, b1, act_t, inds, counts, bn=bn, bm=bm,
                               **s2))

    # ---- csp_mlp_mm2_wq on the plain packed delta (scaled as mm1 gives
    # it), against the plain version on the unscaled one
    out_k = cm.csp_mlp_mm2(pk_p, w2, out.clone(), inds, counts, bn=bn, bm=bm,
                           **pre)
    torch.cuda.synchronize()
    out_p = cm.csp_mlp_mm2_plain(pk_u, w2, out, pinds, counts, bn, bm)
    err = check_fp8(torch, f'csp_mlp_mm2_{wq} out_cache', out_k, out_p)
    out_t = out.clone()
    row(f'csp_mlp_mm2_{wq}', 'chipmunk_tpu/kernels/csp_mlp.py:216', err,
        time_ms(torch, lambda: cm.csp_mlp_mm2(
            pk_p, w2, out_t, inds, counts, bn=bn, bm=bm, **pre), 20),
        time_ms(torch, lambda: cm.csp_mlp_mm2_plain(
            pk_u, w2, out, pinds, counts, bn, bm), 3),
        ops, sel_bytes * 2 + w_rows * wC + N * 4 + 2 * T * C,
        PEAK_BF16_FLOPS,
        dense_library_ms(torch, f'csp_mlp_mm2_{wq} yardstick torch.matmul '
                         f'{shape2} (dequantized bf16)',
                         lambda: torch.matmul(dense16, d2), share))
    rows[-1]['device_ms'] = kernel_device_ms(
        torch, f'csp_mlp_mm2_{wq} (FLUX)', f'mm2{wq}<',
        lambda: cm.csp_mlp_mm2(pk_p, w2, out_t, inds, counts, bn=bn, bm=bm,
                               **pre))
    if not w4:                 # the pair called alone: mm2 scales in place
        kernel_device_ms(torch, 'csp_mlp_mm1_wq alone (FLUX)', 'mm1wq<',
                         lambda: cm.csp_mlp_mm1(x, w1, b1, act_t, inds,
                                                counts, bn=bn, bm=bm))
        kernel_device_ms(torch, 'csp_mlp_mm2_wq alone (FLUX)', 'mm2wq<',
                         lambda: cm.csp_mlp_mm2(pk_u, w2, out_t, inds,
                                                counts, bn=bn, bm=bm))
    for r in rows[-2:]:
        print(f"{r['name']} (FLUX): {ops / r['device_ms'] / 1e9:.1f} TFLOP/s "
              f"on the device ({r['device_ms']:.4f} ms), "
              f"{r['device_ms'] / r['library_ms']:.2f}x the library call on "
              f"the selected share ({r['library_ms']:.4f} ms), bound "
              f"{r['bound_ms']:.4f} ms", flush=True)
    del c1t, c2, d1, d2, dense8, dense16
    if w4:
        bf16_mlp_variants(torch, cm, ca, fp8, x, w1, b1, w2, gen, 'w4')
        a8w4_bn128(torch, cm, ca, fp8, x8, sx, w1, b1, w2, gen)
    print_rows(rows)
    return rows


def kernel_device_ms(torch, tag, label, fn):
    """Device ms of the kernel that ``fn`` launches, which must be the
    gemm_sm90_kernel instantiation whose trace label (OUR_KERNELS) matches
    ``label``."""
    ms, name = device_ms(torch, fn, 20)
    if label not in name.lower():
        fail(f'{tag}: the longest kernel is {name[:120]}, not {label}')
    print(f'{tag}: {ms:.4f} ms on the device ({name[:120]})', flush=True)
    return ms


def a8w4_bn128(torch, cm, ca, fp8, x8, sx, w1, b1, w2, gen):
    """The int4-weight, int8-activation pair at bn = 128 (jmax 44, counts
    26-34: about the same selected share as bn 256) with bf16 caches, at
    the FLUX shape.  Each kernel runs whole; its plain version on the
    first two 512-token blocks (rows 0-1023, counts 1 and jmax), where the
    two are compared under the gates of the bn 256 rows: the act cache
    within one ulp; d8 and sd bit-equal where the acts of the (row, block)
    agree, zero past the count; mm2 on the kernel's own d8/sd of those
    rows within one ulp.  Prints both kernels' device times."""
    dev, bm, bn, jm, T, R = 'cuda', 512, 128, 44, T_SINGLE, 1024
    M = T // bm
    tag = 'csp_mlp a8w4 bn 128, bfloat16 caches'
    inds = torch.rand((M, N // bn), generator=gen, device=dev).topk(
        jm, -1).indices.sort(-1).values.to(torch.int32)
    counts = torch.randint(26, 35, (M,), generator=gen, device=dev,
                           dtype=torch.int32)
    counts[0], counts[1] = 1, jm
    pi, pc = ca.pad_block_indices(inds, counts)[:R // bm], counts[:R // bm]
    act = fp8.cast(torch.randn((T, N), generator=gen, device=dev) * 0.3,
                   torch.bfloat16)
    out = fp8.cast(torch.randn((T, C), generator=gen, device=dev),
                   torch.bfloat16)
    d8, sd, act_k = cm.csp_mlp_mm1_a8(x8, sx, w1, b1, w2.scale, act.clone(),
                                      inds, counts, bn=bn, bm=bm)
    torch.cuda.synchronize()
    d8_p, sd_p, act_p = cm.csp_mlp_mm1_a8_plain(
        x8[:R], sx[:R], w1, b1, w2.scale, act[:R], pi, pc, bn, bm)
    err = check_fp8(torch, f'{tag} act_cache', act_k[:R], act_p)
    agree = mlp_agree(torch, act_k[:R], act_p, pi, bm, bn)
    d8r = d8[:R].reshape(R, jm, bn)
    if not (torch.equal(sd[:R][agree], sd_p[agree]) and torch.equal(
            d8r[agree], d8_p.reshape(R, jm, bn)[agree])):
        fail(f'{tag}: d8/sd differ where the acts agree')
    live = (torch.arange(jm, device=dev)[None]
            < pc.repeat_interleave(bm)[:, None])
    if bool(sd[:R][~live].any()) or bool(d8r[~live].any()):
        fail(f'{tag}: d8/sd not zero past the count')
    out_k = cm.csp_mlp_mm2_a8(d8, sd, w2, out.clone(), inds, counts, bn=bn,
                              bm=bm)
    torch.cuda.synchronize()
    out_p = cm.csp_mlp_mm2_a8_plain(d8[:R], sd[:R], w2, out[:R], pi, pc, bn,
                                    bm)
    err_o = check_fp8(torch, f'{tag} out_cache', out_k[:R], out_p)
    a_t, o_t = act.clone(), out.clone()
    ms1 = kernel_device_ms(torch, f'{tag}: csp_mlp_mm1_a8w4', 'mm1a8w4<',
                         lambda: cm.csp_mlp_mm1_a8(
                             x8, sx, w1, b1, w2.scale, a_t, inds, counts,
                             bn=bn, bm=bm))
    ms2 = kernel_device_ms(torch, f'{tag}: csp_mlp_mm2_a8w4', 'mm2a8w4<',
                         lambda: cm.csp_mlp_mm2_a8(
                             d8, sd, w2, o_t, inds, counts, bn=bn, bm=bm))
    print(f'{tag} (FLUX): act max abs err {err:.3e}, acts agree in '
          f'{agree.float().mean().item():.4f} of (row, block) pairs, out max '
          f'abs err {err_o:.3e}; device ms {ms1:.4f} + {ms2:.4f}', flush=True)
    del act, out, d8, sd, act_k, out_k, a_t, o_t


def a8_wide_blocks(torch, cm, ca, fp8, quant):
    """The int8-activation pair at bn = 512 (mm1's split mode: two
    256-neuron sub-blocks, then the pass that forms sd and d8 over the
    whole block), int8 and int4 weights, fp8 caches, at a small shape (T =
    1024, C = 768, N = 3072, bm = 128, jmax 3 with counts of 1 and jmax):
    the act cache within one ulp; d8 and sd bit-equal where the acts of
    the (row, block) agree, zero past the count; mm2 on the plain d8/sd
    within one ulp."""
    dev, T, C, N, bm, bn, jm = 'cuda', 1024, 768, 3072, 128, 512, 3
    M = T // bm
    gen = torch.Generator(dev)
    gen.manual_seed(SEED + 5)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    x, b1 = randn(T, C), randn(N, scale=0.1)
    inds = torch.rand((M, N // bn), generator=gen, device=dev).argsort(
        -1)[:, :jm].to(torch.int32)
    counts = torch.arange(M, device=dev, dtype=torch.int32) % jm + 1
    pinds = ca.pad_block_indices(inds, counts)
    act = fp8.to_fp8(torch.randn((T, N), generator=gen, device=dev) * 0.3)
    out = fp8.to_fp8(torch.randn((T, C), generator=gen, device=dev))
    live = (torch.arange(jm, device=dev)[None]
            < counts.repeat_interleave(bm)[:, None])
    x8, sx = cm.quant_rows(x)
    for kind in ('int8', 'int4'):
        tag = f'csp_mlp a8 bn 512, {kind} weights'
        w1, w2 = (quant.quantize(randn(N, C, scale=s), kind, keep_axes=(0,),
                                 pack_axis=1 if kind == 'int4' else None)
                  for s in (C ** -0.5, N ** -0.5))
        d8, sd, act_k = cm.csp_mlp_mm1_a8(x8, sx, w1, b1, w2.scale,
                                          act.clone(), inds, counts, bn=bn,
                                          bm=bm)
        torch.cuda.synchronize()
        d8_p, sd_p, act_p = cm.csp_mlp_mm1_a8_plain(
            x8, sx, w1, b1, w2.scale, act, pinds, counts, bn, bm)
        err = check_fp8(torch, f'{tag} act_cache', act_k, act_p)
        agree = mlp_agree(torch, act_k, act_p, pinds, bm, bn)
        d8r = d8.reshape(T, jm, bn)
        if not (torch.equal(sd[agree], sd_p[agree]) and torch.equal(
                d8r[agree], d8_p.reshape(T, jm, bn)[agree])):
            fail(f'{tag}: d8/sd differ where the acts agree')
        if bool(sd[~live].any()) or bool(d8r[~live].any()):
            fail(f'{tag}: d8/sd not zero past the count')
        out_k = cm.csp_mlp_mm2_a8(d8_p, sd_p, w2, out.clone(), inds, counts,
                                  bn=bn, bm=bm)
        torch.cuda.synchronize()
        err_o = check_fp8(torch, f'{tag} out_cache', out_k,
                          cm.csp_mlp_mm2_a8_plain(d8_p, sd_p, w2, out, pinds,
                                                  counts, bn, bm))
        print(f'{tag}: act max abs err {err:.3e}, acts agree in '
              f'{agree.float().mean().item():.4f} of (row, block) pairs, '
              f'out max abs err {err_o:.3e}', flush=True)


def mlp_agree(torch, act_k, act_p, pinds, bm, bn):
    """[R, jmax] bool: the two act caches (R rows) agree, NaN for NaN, on
    every neuron of the (row, selected block)."""
    M, jmax = pinds.shape
    cols = (pinds.long()[:, :, None] * bn + torch.arange(
        bn, device=pinds.device)).reshape(M, -1).repeat_interleave(bm, 0)
    a, b = act_k.float().gather(1, cols), act_p.float().gather(1, cols)
    return ((a == b) | (a.isnan() & b.isnan())).reshape(-1, jmax, bn).all(-1)


def check_packed(torch, tag, pk, pk_p, act_k, act_p, pinds, bm, bn, adt):
    """The packed delta of a bf16-activation mm1 (R rows) against its
    plain version: bit-equal where the acts of the (row, block) agree,
    elsewhere within the act's ulp (cache type adt) plus the delta's own
    bf16 rounding.  Returns the [R, jmax] agreement."""
    agree = mlp_agree(torch, act_k, act_p, pinds, bm, bn)
    same = agree.repeat_interleave(bn, 1)
    g, r = pk.float(), pk_p.float()
    if not bool(((g == r) | (g.isnan() & r.isnan()))[same].all()):
        fail(f'{tag} packed: differs where the acts agree')
    cols = (pinds.long()[:, :, None] * bn + torch.arange(
        bn, device=pk.device)).reshape(len(pinds), -1) \
        .repeat_interleave(bm, 0)
    a_p = act_p.float().gather(1, cols)
    rnd = 2.0 ** -7 if adt == torch.bfloat16 else 2.0 ** -8
    d = (g - r).abs()[~same]
    if d.numel() and not bool((d <= fp8_ulp(
            torch, a_p[~same], adt) * 1.01 + torch.maximum(
            g.abs(), r.abs())[~same] * rnd).all()):
        fail(f'{tag} packed: differs by more than the act ulp')
    return agree


def bf16_mlp_variants(torch, cm, ca, fp8, x, w1t, b1, w2, gen,
                      weights='bf16'):
    """The bf16-activation pair (bf16 weights, or int4 ones: ``weights``
    'w4') beside its main-path row, at the FLUX shape: bn = 128
    (jmax 44, counts 26-34: about the same selected share; mm1 in
    128-neuron sub-blocks) with fp8 caches, and bn = 256 with bf16 caches.
    Each kernel runs whole; its plain version on the first two 512-token
    blocks (rows 0-1023, counts 1 and jmax), where the two are compared:
    the act cache within one ulp of its type, the packed delta as
    check_packed, mm2 on the kernel's own delta within one ulp.  Prints
    both kernels' times."""
    dev, bm, T, R = 'cuda', 512, T_SINGLE, 1024
    M = T // bm
    for bn, jm, lo, hi, cdt in ((128, 44, 26, 35, fp8.FP8),
                                (256, 22, 13, 18, torch.bfloat16)):
        tag = f'csp_mlp {weights} bn {bn}, {str(cdt)[6:]} caches'
        inds = torch.rand((M, N // bn), generator=gen, device=dev).topk(
            jm, -1).indices.sort(-1).values.to(torch.int32)
        counts = torch.randint(lo, hi, (M,), generator=gen, device=dev,
                               dtype=torch.int32)
        counts[0], counts[1] = 1, jm
        pi = ca.pad_block_indices(inds, counts)[:R // bm]
        pc = counts[:R // bm]
        act = fp8.cast(torch.randn((T, N), generator=gen, device=dev) * 0.3,
                       cdt)
        out = fp8.cast(torch.randn((T, C), generator=gen, device=dev), cdt)
        pk, act_k = cm.csp_mlp_mm1(x, w1t, b1, act.clone(), inds, counts,
                                   bn=bn, bm=bm)
        torch.cuda.synchronize()
        pk_p, act_p = cm.csp_mlp_mm1_plain(x[:R], w1t, b1, act[:R], pi, pc,
                                           bn, bm)
        err = check_fp8(torch, f'{tag} act_cache', act_k[:R], act_p)
        agree = check_packed(torch, tag, pk[:R], pk_p, act_k[:R], act_p, pi,
                             bm, bn, cdt)
        out_k = cm.csp_mlp_mm2(pk, w2, out.clone(), inds, counts, bn=bn,
                               bm=bm)
        torch.cuda.synchronize()
        out_p = cm.csp_mlp_mm2_plain(pk[:R], w2, out[:R], pi, pc, bn, bm)
        err_o = check_fp8(torch, f'{tag} out_cache', out_k[:R], out_p)
        a_t, o_t = act.clone(), out.clone()
        ms1 = time_ms(torch, lambda: cm.csp_mlp_mm1(
            x, w1t, b1, a_t, inds, counts, bn=bn, bm=bm), 20)
        ms2 = time_ms(torch, lambda: cm.csp_mlp_mm2(
            pk, w2, o_t, inds, counts, bn=bn, bm=bm), 20)
        print(f'{tag} (FLUX): act max abs err {err:.3e}, acts agree in '
              f'{agree.float().mean().item():.4f} of (row, block) pairs, '
              f'out max abs err {err_o:.3e}; csp_mlp_mm1 {ms1:.4f} ms, '
              f'csp_mlp_mm2 {ms2:.4f} ms', flush=True)
        del act, out, pk, act_k, out_k, a_t, o_t


def bf16_cache_phases(torch, cm, ca, fp8, quant):
    """Every sparse-MLP variant (bf16, wq, w4, a8, a8w4 weights) with bf16
    caches at the main-path MLP shape (T = 4608, C = 3072, N = 12288,
    bm = 512, bn = 256, jmax = 22, counts 13-17 with one at 1 and one at
    22): both caches bf16, and an fp8 act cache with a bf16 out cache.
    Each kernel runs whole; its plain version on the first two 512-token
    blocks (rows 0-1023, counts 1 and 22), where the two are compared:
    the act cache within one ulp of its type; the packed delta (a8: d8 and
    sd) bit-equal where the acts of the (row, block) agree, elsewhere (the
    packed delta) within the act's ulp plus its own bf16 rounding; mm2 on
    the kernel's own delta of those rows within one ulp."""
    dev = 'cuda'
    gen = torch.Generator(dev)
    gen.manual_seed(SEED + 5)
    bm, bn, jm, T, R = 512, 256, 22, T_SINGLE, 1024
    M, nbn = T // bm, N // bn

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    x = randn(T, C)
    w1b, w2b = randn(N, C, scale=C ** -0.5), randn(N, C, scale=N ** -0.5)
    b1 = randn(N, scale=0.1)
    weights = {'bf16': (w1b, w2b)}
    for kind, tag in (('int8', 'wq'), ('int4', 'w4')):
        weights[tag] = tuple(quant.quantize(w.float(), kind, keep_axes=(0,),
                                            pack_axis=1 if kind == 'int4'
                                            else None) for w in (w1b, w2b))
    weights['a8'], weights['a8w4'] = weights['wq'], weights['w4']
    inds = torch.rand((M, nbn), generator=gen, device=dev).topk(jm, -1) \
        .indices.sort(-1).values.to(torch.int32)
    counts = torch.randint(13, 18, (M,), generator=gen, device=dev,
                           dtype=torch.int32)
    counts[0], counts[1] = 1, jm
    pinds = ca.pad_block_indices(inds, counts)
    pi, pc = pinds[:R // bm], counts[:R // bm]
    x8, sx = cm.quant_rows(x)
    for variant, (w1, w2) in weights.items():
        for adt, odt in ((torch.bfloat16, torch.bfloat16),
                         (fp8.FP8, torch.bfloat16)):
            tag = (f'bf16 caches {variant} (act {str(adt)[6:]}, out '
                   f'{str(odt)[6:]})')
            act = fp8.cast(torch.randn((T, N), generator=gen, device=dev)
                           * 0.3, adt)
            out = fp8.cast(torch.randn((T, C), generator=gen, device=dev),
                           odt)
            if variant.startswith('a8'):
                d8, sd, act_k = cm.csp_mlp_mm1_a8(
                    x8, sx, w1, b1, w2.scale, act.clone(), inds, counts,
                    bn=bn, bm=bm)
                torch.cuda.synchronize()
                d8_p, sd_p, act_p = cm.csp_mlp_mm1_a8_plain(
                    x8[:R], sx[:R], w1, b1, w2.scale, act[:R], pi, pc, bn,
                    bm)
                err = check_fp8(torch, f'{tag} act_cache', act_k[:R], act_p)
                agree = mlp_agree(torch, act_k[:R], act_p, pi, bm, bn)
                if not (torch.equal(sd[:R][agree], sd_p[agree])
                        and torch.equal(d8[:R].reshape(R, jm, bn)[agree],
                                        d8_p.reshape(R, jm, bn)[agree])):
                    fail(f'{tag}: d8/sd differ where the acts agree')
                out_k = cm.csp_mlp_mm2_a8(d8, sd, w2, out.clone(), inds,
                                          counts, bn=bn, bm=bm)
                torch.cuda.synchronize()
                out_p = cm.csp_mlp_mm2_a8_plain(d8[:R], sd[:R], w2, out[:R],
                                                pi, pc, bn, bm)
            else:
                pk, act_k = cm.csp_mlp_mm1(x, w1, b1, act.clone(), inds,
                                           counts, bn=bn, bm=bm)
                torch.cuda.synchronize()
                pk_p, act_p = cm.csp_mlp_mm1_plain(x[:R], w1, b1, act[:R],
                                                   pi, pc, bn, bm)
                err = check_fp8(torch, f'{tag} act_cache', act_k[:R], act_p)
                agree = check_packed(torch, tag, pk[:R], pk_p, act_k[:R],
                                     act_p, pi, bm, bn, adt)
                out_k = cm.csp_mlp_mm2(pk, w2, out.clone(), inds, counts,
                                       bn=bn, bm=bm)
                torch.cuda.synchronize()
                out_p = cm.csp_mlp_mm2_plain(pk[:R], w2, out[:R], pi, pc, bn,
                                             bm)
            err_o = check_fp8(torch, f'{tag} out_cache', out_k[:R], out_p)
            print(f'{tag}: act max abs err {err:.3e}, acts agree in '
                  f'{agree.float().mean().item():.4f} of (row, block) '
                  f'pairs, out max abs err {err_o:.3e}', flush=True)
    torch.cuda.empty_cache()


def small_block_csp_phases(torch, ca):
    """csp_attn ('vmem') and csp_attn_hbm at kv_block 1, 2, 4, 8 and 16 at
    the FLUX shape (B = 1, H = 24, 4352 tokens, 34 query groups; jmax 768
    down to 48 blocks, i.e. six 128-key blocks' worth of keys; counts from
    1 to jmax with one group at 1 and one at jmax; kv_valid 4347 cuts the
    last block at kv_block 8 and 16, and masks it whole below, where it
    cuts the one before at kv_block 4; group 2 selects the last block
    first) against csp_attn_plain on the same inputs, o to 4e-3 + 2^-6
    |ref|, with NaN in every K/V block that no group of its head selects
    (a read of one would show).  Below kv_block 8 both modes run the
    packed kernel on pack_kv's 16-row slots.  Prints each kernel's time."""
    gen = torch.Generator('cuda')
    gen.manual_seed(SEED + 6)
    q, k, v = (torch.randn((B, H, S, D), generator=gen, device='cuda').to(
        torch.bfloat16) for _ in range(3))
    G, n_valid = S // 128, S - 5
    for kv_block in (1, 2, 4, 8, 16):
        nb, jmax = S // kv_block, 6 * 128 // kv_block
        inds = torch.rand((B, H, G, nb), generator=gen, device='cuda') \
            .topk(jmax, -1).indices.to(torch.int32)
        row = inds[..., 2, :]                  # group 2: the last block first
        last = row == nb - 1
        row[last] = row[..., :1].expand_as(row)[last]
        row[..., 0] = nb - 1
        counts = torch.randint(1, jmax + 1, (B, H, G), generator=gen,
                               device='cuda', dtype=torch.int32)
        counts[..., 0], counts[..., 1] = 1, jmax
        pinds = ca.pad_block_indices(inds, counts)
        sel = torch.zeros((B, H, nb), dtype=torch.bool, device='cuda')
        sel.scatter_(-1, pinds.long().reshape(B, H, -1), True)
        off = (~sel).repeat_interleave(kv_block, -1)[..., None]
        kp, vp = (t.masked_fill(off, float('nan')) for t in (k, v))
        o_p = ca.csp_attn_plain(q, kp, vp, pinds, counts, kv_block=kv_block,
                                kv_valid=n_valid)
        kv = ca.pack_kv(kp, vp, kv_block)
        for mode, fn in (
                ('vmem', lambda: ca.csp_attn(q, kp, vp, inds, counts,
                                             kv_block=kv_block,
                                             kv_valid=n_valid, mode='vmem')),
                ('hbm', lambda: ca.csp_attn_hbm(q, kv, inds, counts,
                                                kv_block=kv_block,
                                                kv_valid=n_valid))):
            o = fn()
            torch.cuda.synchronize()
            if not bool(o.isfinite().all()):
                fail(f'csp {mode} kv_block {kv_block}: non-finite output')
            err = check_close(f'csp {mode} kv_block {kv_block} o', o, o_p,
                              4e-3, 2 ** -6)
            print(f'csp {mode} kv_block {kv_block} (FLUX, jmax {jmax}): '
                  f'max abs err {err:.3e}, {time_ms(torch, fn, 10):.4f} ms',
                  flush=True)
        del kp, vp, kv, o, o_p
    del q, k, v
    torch.cuda.empty_cache()


def colsum_small_block_phases(torch, fa):
    """dense_colsum_attn at score blocks below 64 keys: 1, 2, 4, 8, 16 and
    32 at the FLUX shape (4352 keys: up to 4352 blocks, past the slots
    that 64-key blocks have), 8, 16 and 32 at 540p (67,584 queries, keys
    cut at 67,576) and 720p (119,168, keys cut at 119,056), PAD_LSE on
    the pad rows.  Each against dense_colsum_attn_plain: at FLUX whole, at
    the video shapes on heads 0-1, query groups 0-1 and the last two; o
    and lse as kernel_phases, colsums to 1e-4 + 1e-3 |ref|; a second call
    bit-equal.  Prints the time, the bound (that of the 128-key form:
    the sums add under 1% of the bytes) and the time at 128-key blocks on
    the same inputs."""
    from chipmunk_torch.ops.attn_ref import PAD_LSE
    gen = torch.Generator('cuda')
    gen.manual_seed(SEED + 7)
    for tag, Sq, n, sbs in (('FLUX', S, S, (1, 2, 4, 8, 16, 32)),
                            ('540p', 67584, 67576, (8, 16, 32)),
                            ('720p', 119168, 119056, (8, 16, 32))):
        q, k, v = (torch.randn((B, H, Sq, D), generator=gen,
                               device='cuda').to(torch.bfloat16)
                   for _ in range(3))
        kc, vc = k[..., :n, :], v[..., :n, :]
        prev = fa.dense_attn(q, kc, vc)[1]
        prev[..., n:] = PAD_LSE
        hs = slice(0, H) if tag == 'FLUX' else slice(0, 2)
        rows = [slice(0, Sq)] if tag == 'FLUX' else [
            slice(0, 256), slice(Sq - 256, Sq)]
        flops = 4.0 * B * H * Sq * n * D
        bnd, by = bound_ms(flops, B * H * (2 * Sq + 2 * n) * D * 2
                           + B * H * Sq * 8)
        reps = 10 if tag == 'FLUX' else 2
        ms128 = time_ms(torch, lambda: fa.dense_colsum_attn(q, kc, vc, prev),
                        reps)
        for sb in sbs:
            got = fa.dense_colsum_attn(q, kc, vc, prev, score_block=sb)
            again = fa.dense_colsum_attn(q, kc, vc, prev, score_block=sb)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f'dense_colsum_attn score_block {sb} ({tag}): two '
                     f'calls differ')
            if got[1].shape[-1] != -(-n // sb):
                fail(f'dense_colsum_attn score_block {sb} ({tag}): '
                     f'{got[1].shape[-1]} blocks')
            err = 0.0
            for r in rows:
                o_p, cs_p, lse_p = fa.dense_colsum_attn_plain(
                    q[:, hs, r], kc[:, hs], vc[:, hs], prev[:, hs, r],
                    score_block=sb)
                name = f'dense_colsum_attn score_block {sb} ({tag})'
                err = max(err, check_close(f'{name} o', got[0][:, hs, r],
                                           o_p, 4e-3, 2 ** -6))
                check_close(f'{name} lse', got[2][:, hs, r], lse_p, 1e-3,
                            0.0)
                check_close(f'{name} colsums', got[1][
                    :, hs, r.start // 128:r.stop // 128], cs_p, 1e-4, 1e-3)
                del o_p, cs_p, lse_p
            del got, again
            ms = time_ms(torch, lambda: fa.dense_colsum_attn(
                q, kc, vc, prev, score_block=sb), reps)
            print(f'dense_colsum_attn score_block {sb} ({tag}): max abs err '
                  f'{err:.3e}, {ms:.4f} ms = {flops / ms / 1e9:.1f} TFLOP/s, '
                  f'bound {bnd:.4f} ms ({by}); score_block 128 on the same '
                  f'inputs {ms128:.4f} ms', flush=True)
        del q, k, v, kc, vc, prev
        torch.cuda.empty_cache()


def random_selection(torch, gen, G, nb, jmax):
    """Distinct random block ids [B,H,G,jmax] and counts 1 .. jmax (one
    group at 1, one at jmax), padded as the module passes them."""
    from chipmunk_torch.kernels.csp_attention import pad_block_indices
    inds = torch.rand((B, H, G, nb), generator=gen, device='cuda') \
        .topk(jmax, -1).indices.sort(-1).values.to(torch.int32)
    counts = torch.randint(1, jmax + 1, (B, H, G), generator=gen,
                           device='cuda', dtype=torch.int32)
    counts[..., 0], counts[..., 1] = 1, jmax
    return pad_block_indices(inds, counts), counts


def query_group_phases(torch, fa, ca):
    """The three kernels that take a query-group size (dense_colsum_attn,
    csp_attn, csp_attn_hbm) at qg 64 and 256 at the FLUX shape and at qg
    192 at 540p, each against its plain version (FLUX whole; 540p on head
    0 and, for the column sums, query groups 0-1 and the last two), with
    its time, its bound (the work of the qg-row groups: rows past a
    group's end that a CTA computes are not counted) and its time at qg
    128 on inputs drawn the same way.  csp: kv_block 128, jmax 6 (FLUX)
    or 44 (540p, kv_valid 67,576), counts from 1 to jmax."""
    gen = torch.Generator('cuda')
    gen.manual_seed(SEED + 8)
    for tag, Sq, n, jmax, qgs in (('FLUX', S, S, 6, (64, 256)),
                                  ('540p', 67584, 67576, 44, (192,))):
        q, k, v = (torch.randn((B, H, Sq, D), generator=gen,
                               device='cuda').to(torch.bfloat16)
                   for _ in range(3))
        kc, vc = k[..., :n, :], v[..., :n, :]
        prev = fa.dense_attn(q, kc, vc)[1]
        hs = slice(0, H) if tag == 'FLUX' else slice(0, 1)
        reps = 10 if tag == 'FLUX' else 3
        kv = ca.pack_kv(k, v, 128)
        flops = 4.0 * B * H * Sq * n * D
        cbnd = bound_ms(flops, B * H * (2 * Sq + 2 * n) * D * 2
                        + B * H * Sq * 8)[0]
        nb = Sq // 128
        for qg in (128,) + qgs:
            G = Sq // qg
            name = f'qg {qg} ({tag})'
            cs_fn = lambda: fa.dense_colsum_attn(q, kc, vc, prev, qg=qg)
            pinds, counts = random_selection(torch, gen, G, nb, jmax)
            csp_fns = (
                ('csp_attn', lambda: ca.csp_attn(
                    q, k, v, pinds, counts, qg=qg, kv_valid=n,
                    mode='vmem')),
                ('csp_attn_hbm', lambda: ca.csp_attn_hbm(
                    q, kv, pinds, counts, qg=qg, kv_valid=n)))
            if qg != 128:
                got = cs_fn()
                torch.cuda.synchronize()
                rows = [slice(0, Sq)] if tag == 'FLUX' else [
                    slice(0, 2 * qg), slice(Sq - 2 * qg, Sq)]
                for r in rows:
                    o_p, cs_p, lse_p = fa.dense_colsum_attn_plain(
                        q[:, hs, r], kc[:, hs], vc[:, hs], prev[:, hs, r],
                        qg=qg)
                    err = check_close(f'dense_colsum_attn {name} o',
                                      got[0][:, hs, r], o_p, 4e-3, 2 ** -6)
                    check_close(f'dense_colsum_attn {name} lse',
                                got[2][:, hs, r], lse_p, 1e-3, 0.0)
                    check_close(f'dense_colsum_attn {name} colsums', got[1][
                        :, hs, r.start // qg:r.stop // qg], cs_p, 1e-4, 1e-3)
                    del o_p, cs_p, lse_p
                del got
                ms = time_ms(torch, cs_fn, reps)
                print(f'dense_colsum_attn {name}: max abs err {err:.3e}, '
                      f'{ms:.4f} ms = {flops / ms / 1e9:.1f} TFLOP/s, bound '
                      f'{cbnd:.4f} ms', flush=True)
                o_p = ca.csp_attn_plain(q[:, hs], k[:, hs], v[:, hs],
                                        pinds[:, hs], counts[:, hs], qg=qg,
                                        kv_valid=n)
            else:
                print(f'dense_colsum_attn {name}: '
                      f'{time_ms(torch, cs_fn, reps):.4f} ms', flush=True)
            bnd = csp_bound(torch, pinds, counts, q, qg=qg)
            for kname, fn in csp_fns:
                o = fn()
                torch.cuda.synchronize()
                msg = ''
                if qg != 128:
                    err = check_close(f'{kname} {name} o', o[:, hs], o_p,
                                      4e-3, 2 ** -6)
                    msg = f'max abs err {err:.3e}, '
                ms = time_ms(torch, fn, reps)
                print(f'{kname} {name}: {msg}{ms:.4f} ms, bound '
                      f'{bnd[0]:.4f} ms ({bnd[1]})', flush=True)
                del o
        del q, k, v, kc, vc, prev, kv
        torch.cuda.empty_cache()


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
        ran = kernel_names(torch, lambda: probe.int8_probe(x, y))
        if ran != {'gemm_sm90_kernel'}:
            fail(f'{name}: the probe launched {ran}, not gemm_sm90_kernel '
                 f'alone')
        lib = (torch._int_mm if x.dtype == torch.int8 else torch.matmul)
        lib_ms = time_ms(torch, lambda: lib(x, y), 20)
        bnd, by = bound_ms(ops, nbytes, peak)
        rows.append(dict(
            name=name, source='chipmunk_torch/csrc/int8_probe.cu',
            replaces='scripts/bench_int8_mxu.py:48',
            max_abs_err=0.0 if x.dtype == torch.int8 else err, ms=ms,
            plain_ms=time_ms(torch, lambda: probe.int8_probe_plain(x, y), 3),
            bound_ms=bnd, bound_by=by, library_ms=lib_ms))
        print(f'probe {name}: {ms:.4f} ms = {ops / ms / 1e9:.1f} TOP/s '
              f'(gemm_sm90_kernel); library ({lib.__name__}) {lib_ms:.4f} '
              f'ms = {ops / lib_ms / 1e9:.1f} TOP/s', flush=True)
    s8, b16 = rows
    print(f'probe: hand-written int8/bf16 rate ratio '
          f'{b16["ms"] / s8["ms"]:.3f}, library '
          f'{b16["library_ms"] / s8["library_ms"]:.3f}', flush=True)
    print_rows(rows)
    return rows


def to_device(tree, device):
    """A nest of dicts and lists of tensors, moved to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def run_loop(torch, tm, ck, model, h_img, w_img, device, init_device=None,
             callback=None, params=None, compiled=False):
    """One FluxSampler.denoise (``compiled``: denoise_compiled, which
    takes no callback), set up by prepare_loop.  Returns (latent,
    seconds)."""
    return prepare_loop(torch, tm, ck, model, h_img, w_img, device,
                        init_device, params)(callback, compiled)


def prepare_loop(torch, tm, ck, model, h_img, w_img, device,
                 init_device=None, params=None):
    """Weights (unless ``params`` are given, on ``init_device``) and
    inputs drawn from a seeded generator on ``init_device`` (default:
    ``device``) and moved to ``device``; returns ``run(callback=None,
    compiled=False, ck_=None)``, which runs one loop on them (with
    ``ck_`` in place of the config given here) and returns (latent, seconds),
    the set-up outside both."""
    init_device = init_device or device
    gen = torch.Generator(init_device)
    gen.manual_seed(SEED)
    seq = model.txt_len + h_img * w_img
    samplers = {}

    def sampler_for(ck_):
        if ck_ not in samplers:
            samplers[ck_] = tm.FluxSampler(
                cfg=model, ck=ck_, sp=tm.FluxSparse.build(ck_, model, seq),
                h_img=h_img, w_img=w_img, device=device)
        return samplers[ck_]

    if params is None:
        params = tm.init_flux_params(gen, model, init_device)
    if init_device != device:
        params = to_device(params, device)
    img, txt, y = (torch.randn(shape, generator=gen, device=init_device)
                   .to(device) for shape in (
                       (1, h_img * w_img, model.in_channels),
                       (1, model.txt_len, model.context_in_dim),
                       (1, model.vec_in_dim)))
    ts = tm.get_schedule(ck.steps, h_img * w_img)

    def run(callback=None, compiled=False, ck_=None):
        sampler = sampler_for(ck_ or ck)
        loop_gen = torch.Generator(device)
        loop_gen.manual_seed(SEED)
        if device != 'cpu':
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if compiled:
            out = sampler.denoise_compiled(params, img, txt, y, ts,
                                           generator=loop_gen)
        else:
            out = sampler.denoise(params, img, txt, y, ts,
                                  generator=loop_gen, callback=callback)
        if device != 'cpu':
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    return run


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


def trace_sparse_steps(torch, run, plain_window_ms, tag):
    """torch.profiler over steps 2-9 of a sparse loop (seven computed
    sparse steps, one skipped, on both schedules): device time by kernel
    group, and the device-busy share of the same window timed without the
    profiler (plain_window_ms).  ``run(callback)`` runs the loop (at least
    its first ten steps).  Kernel records only, as trace_whole_loop."""
    from torch.profiler import ProfilerActivity, profile, schedule
    marks = {}

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=8)) as prof:
        run(window_marks(torch, marks, lambda: prof.step()))
    report_trace(prof, plain_window_ms, (marks[9] - marks[1]) * 1e3,
                 f'{tag} trace', 'steps 2-9 (7 computed sparse steps)')


def trace_whole_loop(torch, run, plain_ms, tag):
    """torch.profiler over a whole loop (``run()``, which runs the loop
    and nothing else; a compiled loop takes no callback, and its
    replays' kernels are recorded as the eager ones): device time by
    kernel group, and the device-busy share of the loop's wall time
    measured without the profiler (plain_ms)."""
    from torch.profiler import ProfilerActivity, profile
    # kernel records only: the host ops of a loop are 10^4-10^5 events,
    # which cost the profiler up to a minute to fold and which no line
    # reads
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return report_trace(prof, plain_ms, wall_ms, f'{tag} trace',
                        'whole loop')


def report_trace(prof, plain_ms, wall_ms, tag, window):
    """Print a trace's device time by kernel group, by chipmunk kernel and
    the largest kernels, and the busy share of ``plain_ms`` (``window``
    timed without the profiler).  Device time is the sum of CUDA kernel
    durations; one stream, so kernels do not overlap.  Returns the busy
    share in percent."""
    from torch.autograd import DeviceType
    groups, names, ours = {}, {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key.startswith(
                'ProfilerStep'):
            continue
        us = e.self_device_time_total
        low = e.key.lower()
        label = next((lb for lb, k in OUR_KERNELS if k in low), None)
        g = ('chipmunk kernels' if label
             else 'GEMM (cuBLAS)' if any(k in low for k in GEMM_NAMES)
             else 'other (elementwise, reductions, copies, top-k)')
        groups[g] = groups.get(g, 0.0) + us / 1e3
        names[e.key] = names.get(e.key, 0.0) + us / 1e3
        if label:
            ours[label] = ours.get(label, 0.0) + us / 1e3
    busy = sum(groups.values())
    print(f'{tag}, {window}: window {plain_ms:.1f} ms unprofiled '
          f'({wall_ms:.1f} ms under the profiler); device busy {busy:.1f} '
          f'ms = {100 * busy / plain_ms:.1f}% of the unprofiled window',
          flush=True)
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f'{tag} group {g}: {ms:.1f} ms '
              f'({100 * ms / plain_ms:.1f}% of the unprofiled window)')
    for lb, ms in sorted(ours.items(), key=lambda kv: -kv[1]):
        print(f'{tag} chipmunk {lb}: {ms:.1f} ms', flush=True)
    for n, ms in sorted(names.items(), key=lambda kv: -kv[1])[:12]:
        print(f'{tag} kernel {ms:9.2f} ms  {n[:110]}')
    return 100 * busy / plain_ms


def drive_path(torch, kern, tm, ck, model, tag, expect, params=None,
               dense=True, trace_compiled=False):
    """One main path at full size: the sparse loop with every launch count
    set to 0 just before it and read just after (each kernel of
    ``expect`` must have launched, every other kernel not), the trace over
    a window of its sparse steps, and (with ``dense``) the dense loop
    (sparsity and step caching off) on the same weights; then the same
    loops compiled (``compiled_loops``).  Returns (launches, sparse s,
    dense s or None, compiled sparse s, compiled dense s or None)."""
    loops = prepare_loop(torch, tm, ck, model, H_IMG, W_IMG, 'cuda',
                         params=params)
    kern.reset_launches()
    marks = {}
    out, sparse_s = loops(callback=window_marks(torch, marks))
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
    torch.cuda.empty_cache()
    trace_sparse_steps(torch, lambda cb: loops(callback=cb),
                       (marks[9] - marks[1]) * 1e3, tag)
    torch.cuda.empty_cache()
    dense_s = d_launches = None
    dense_ck = dense_config(ck)
    if dense:
        kern.reset_launches()
        out_d, dense_s = loops(ck_=dense_ck)
        d_launches = dict(kern.LAUNCHES)
        if not bool(torch.isfinite(out_d).all()):
            fail(f'{tag}: non-finite values in the dense loop output')
        print(f'{tag} dense loop: {ck.steps} steps, {dense_s:.3f} s; sparse '
              f'speedup {dense_s / sparse_s:.3f}x', flush=True)
        del out_d
        torch.cuda.empty_cache()

    c_s, c_d = compiled_loops(
        torch, kern, tag, lambda: lambda: loops(compiled=True), out,
        launches, sparse_s,
        (lambda: lambda: loops(compiled=True, ck_=dense_ck)) if dense
        else None, d_launches, dense_s, trace_compiled)
    del out, loops
    torch.cuda.empty_cache()
    return launches, sparse_s, dense_s, c_s, c_d


def compiled_loops(torch, kern, tag, prepare, host_out, host_launches,
                   host_s, prepare_dense=None, dense_launches=None,
                   dense_s=None, trace=False):
    """A path's compiled sparse loop (``prepare()`` returns ``run()`` ->
    (latent, s), which runs the loop and nothing else), the launch counts
    set to 0 just before it and read just after: output
    finite and of the host loop's shape, launches equal to the host
    loop's (``host_launches``) kernel by kernel; prints its time beside
    the host loop's (``host_s``), its graphs, replays, eager steps,
    capture time and graph pool, and the mean relative difference from
    the host loop's latent (skipped steps folded).  With ``trace``, a
    profiler trace of the whole compiled loop.  With ``prepare_dense``, the compiled dense loop likewise
    against the host dense loop
    (``dense_launches``, ``dense_s``) and the speedup compiled dense /
    compiled sparse.  Returns (compiled sparse s, compiled dense s or
    None)."""
    from chipmunk_torch.models.step_graphs import GRAPH_STATS
    results = []
    for kind, prep, want, ref_s in (
            ('sparse', prepare, host_launches, host_s),
            ('dense', prepare_dense, dense_launches, dense_s)):
        if prep is None:
            results.append(None)
            continue
        loop = prep()
        torch.cuda.reset_peak_memory_stats()
        kern.reset_launches()
        out, secs = loop()
        got = dict(kern.LAUNCHES)
        st = dict(GRAPH_STATS)
        if out.shape != host_out.shape:
            fail(f'{tag} compiled {kind} loop: output shape '
                 f'{tuple(out.shape)}, the host loop '
                 f'{tuple(host_out.shape)}')
        if not bool(torch.isfinite(out).all()):
            fail(f'{tag}: non-finite values in the compiled {kind} loop '
                 f'output')
        if got != want:
            fail(f'{tag} compiled {kind} loop: launches '
                 f'{ {k: n for k, n in got.items() if n} } differ from '
                 f'the host loop\'s {({k: n for k, n in want.items() if n})}')
        msg = (f'{tag} compiled {kind} loop: {secs:.3f} s (host loop '
               f'{ref_s:.3f} s: {ref_s / secs:.3f}x); {st["graphs"]} '
               f'graphs, {st["replays"]} replays, {st["eager"]} eager '
               f'steps, capture {st["capture_s"]:.3f} s, graph pool '
               f'{st["pool_bytes"] / 2 ** 30:.2f} GiB, peak '
               f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB '
               f'allocated; launches equal to the host loop\'s')
        if kind == 'sparse':
            rel = ((out - host_out).abs().mean()
                   / host_out.abs().mean()).item()
            msg += (f'; latent vs the host loop: mean relative difference '
                    f'{rel:.3e} (skipped steps folded)')
        print(msg, flush=True)
        del out
        torch.cuda.empty_cache()
        if kind == 'sparse' and trace:
            trace_whole_loop(torch, loop, secs * 1e3, f'{tag} compiled')
            torch.cuda.empty_cache()
        results.append(secs)
    if results[1] is not None:
        print(f'{tag} compiled dense loop / compiled sparse loop: sparse '
              f'speedup {results[1] / results[0]:.3f}x (both loops '
              f'compiled, as bench.py --loop compiled times them)',
              flush=True)
    return tuple(results)


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


def check_compiled_agreement(torch, tag, outs, launches):
    """Host loop and compiled loop (``outs``, ``launches``: host first) of
    a small model on the card, same seed, random keeps on, no skipped
    step: launches equal kernel by kernel, graphs replayed, mean relative
    difference <= 1e-3."""
    from chipmunk_torch.models.step_graphs import GRAPH_STATS
    st = dict(GRAPH_STATS)
    rel = ((outs[1] - outs[0]).abs().mean() / outs[0].abs().mean()).item()
    print(f'{tag} small compiled vs host loop (card, random keeps on): mean '
          f'relative difference {rel:.3e}, {st["graphs"]} graphs, '
          f'{st["replays"]} replays, {st["eager"]} eager steps, launches '
          f'{ {k: n for k, n in launches[1].items() if n} }', flush=True)
    if launches[0] != launches[1]:
        fail(f'{tag} small compiled loop: launches differ from the host '
             f'loop\'s {({k: n for k, n in launches[0].items() if n})}')
    if not st['replays']:
        fail(f'{tag} small compiled loop: no graph was replayed')
    if not math.isfinite(rel) or rel > 1e-3:
        fail(f'{tag} small compiled loop differs from the host loop: {rel}')


def agree_compiled_small(torch, tm, kern, ck, model, tag, params_cpu=None):
    """agree_small's model for 8 steps (each sparse kind and the full kind
    recur, so graphs are captured and replayed) with the MLP's random
    keeps on (random_keys 0.05) on the card: the compiled loop against
    the host loop (check_compiled_agreement)."""
    ck = ck.replace(steps=8, mlp=dataclasses.replace(ck.mlp,
                                                     random_keys=0.05))
    outs, launches = [], []
    for compiled in (False, True):
        kern.reset_launches()
        out, _ = run_loop(torch, tm, ck, model, 16, 24, 'cuda', 'cpu',
                          params=params_cpu, compiled=compiled)
        outs.append(out)
        launches.append(dict(kern.LAUNCHES))
    check_compiled_agreement(torch, tag, outs, launches)


def run_video(torch, tm, model, params, inputs, steps=None, callback=None,
              compiled=False, streamed=None):
    """One hunyuan_denoise (``compiled``: hunyuan_denoise_compiled, no
    callback; ``streamed``: (runner, state) of ``model.make_streamed``)
    over the config's schedule (unshifted, as the reference's video
    bench), the first ``steps`` steps only if given, guidance 6.0, random
    keeps from a seeded generator on the model's device.  ``inputs``:
    (latent, txt, vec) or (latent, txt, vec, txt_mask).  Returns
    (latent, seconds)."""
    mask = inputs[3] if len(inputs) > 3 else None
    inputs = inputs[:3]
    dev = model.device
    ts = tm.get_schedule(model.ck.steps, model.cfg.img_len, shift=False)
    if steps is not None:
        ts = ts[:steps + 1]
    gen = torch.Generator(dev)
    gen.manual_seed(SEED)
    if dev.type == 'cuda':
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    if compiled:
        out = tm.hunyuan_denoise_compiled(model, params, *inputs, ts,
                                          guidance=6.0, generator=gen,
                                          txt_mask=mask)
    else:
        out = tm.hunyuan_denoise(model, params, *inputs, ts, guidance=6.0,
                                 generator=gen, callback=callback,
                                 streamed=streamed, txt_mask=mask)
    if dev.type == 'cuda':
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def video_inputs(torch, cfg, device):
    """Latent noise, random text states [1,256,4096] and pooled text
    [1,768] (as scripts/bench_hunyuan.py:100-106 draws them), bf16, from
    a seeded generator on ``device``."""
    gen = torch.Generator(device)
    gen.manual_seed(SEED + 4)
    shapes = ((1, cfg.in_channels, cfg.latent_t, cfg.latent_h, cfg.latent_w),
              (1, cfg.txt_len, cfg.text_dim), (1, cfg.vec_in_dim))
    return tuple(torch.randn(sh, generator=gen, device=device).to(cfg.dtype)
                 for sh in shapes)


def dense_config(ck):
    return ck.replace(
        attn=dataclasses.replace(ck.attn, is_enabled=False),
        mlp=dataclasses.replace(ck.mlp, is_enabled=False),
        step_caching=dataclasses.replace(ck.step_caching, is_enabled=False))


def llama_agreement(torch, tm, params, cfg, ids, mask):
    """The first 2 layers of ``params`` at full width: the card in bf16
    against the CPU in float32 on the same weights (the embedding rows of
    ``ids`` only), every hidden state within LLAMA_TOL."""
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2)
    p2 = {'embed': params['embed'], 'layers': params['layers'][:2],
          'norm': params['norm']}
    got = tm.llama_hidden_states(p2, ids, mask, cfg2)
    rows, inv = torch.unique(ids, return_inverse=True)
    cpu = {'embed': p2['embed'][rows].float().cpu(),
           'layers': [{k: v.float().cpu() for k, v in lp.items()}
                      for lp in p2['layers']],
           'norm': p2['norm'].float().cpu()}
    t0 = time.perf_counter()
    ref = tm.llama_hidden_states(
        cpu, inv.cpu(), mask.cpu(),
        dataclasses.replace(cfg2, dtype=torch.float32))
    cpu_s = time.perf_counter() - t0
    errs = []
    for g, r in zip(got, ref):
        d = (g.float().cpu() - r).abs()
        errs.append(((d.mean() / r.abs().mean()).item(),
                     (d.max() / r.abs().max()).item()))
    print(f'LLaMA-3 2-layer full-width trunk, card bf16 vs CPU float32 '
          f'(CPU {cpu_s:.1f} s): (mean relative, largest / largest '
          f'magnitude) per hidden state '
          f'{[(float(f"{a:.3e}"), float(f"{b:.3e}")) for a, b in errs]}; '
          f'tolerance {LLAMA_TOL}', flush=True)
    bad = [e for e in errs if not (e[0] <= LLAMA_TOL and e[1] <= LLAMA_TOL)]
    if bad:
        fail(f'LLaMA-3 trunk on the card differs from the CPU: {errs}')


def encode_hunyuan_text(torch, tm):
    """HunyuanVideo's prompt encoders at full size in bf16, weights drawn
    on the card from a seed: LLaVA-LLaMA-3-8B's language model
    (``LlamaConfig()``: 32 layers, hidden 4096, 32 heads over 8 key/value
    heads, vocab 128,256, theta 500,000) and CLIP-L (``ClipTextConfig()``,
    its EOT id 49,407 the largest id and the pad), through
    ``HunyuanTextEncoders.embed`` with stand-in tokenizers set on the
    holder: HY_PROMPT under the video template, 95 + 256 rows.  Prints the
    parameters, GB, draw seconds, encode ms and peak GiB; checks finite
    values, the shapes [1, 256, 4096] / [1, 256] / [1, 768], that the
    pooled row is the first EOT's and that the text rows are the prompt's;
    holds the first 2 layers against the CPU (``llama_agreement``);
    releases the encoders.  Returns (txt, txt_mask, vec)."""
    cfg = tm.LlamaConfig(dtype=torch.bfloat16)
    ccfg = tm.ClipTextConfig(dtype=torch.bfloat16, eos_token_id=49407)
    gen = torch.Generator('cuda')
    gen.manual_seed(SEED + 8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = tm.init_llama_params(gen, cfg, 'cuda')
    cparams = tm.init_clip_params(gen, ccfg, 'cuda')
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    leaves = tensors(params)
    n_par = sum(t.numel() for t in leaves)
    gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    del leaves
    enc = tm.HunyuanTextEncoders(dtype=torch.bfloat16)
    enc._llm, enc._clip = (params, cfg), (cparams, ccfg)
    enc._llm_tok = llm_tokenizer(cfg.vocab_size)
    enc._clip_tok = StandInTokenizer(ccfg.vocab_size, 49407, eot=49407)
    print(f'LLaVA-LLaMA-3-8B trunk: {cfg.num_hidden_layers} layers, hidden '
          f'{cfg.hidden_size}, {cfg.num_attention_heads} heads over '
          f'{cfg.num_key_value_heads} kv heads, vocab {cfg.vocab_size}, '
          f'theta {cfg.rope_theta:g}: {n_par / 1e9:.3f}B parameters, '
          f'{gb:.2f} GB bf16; with CLIP-L drawn on the card in '
          f'{draw_s:.2f} s', flush=True)
    enc.embed([HY_PROMPT])                        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    txt, txt_mask, y = enc.embed([HY_PROMPT])
    torch.cuda.synchronize()
    enc_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_valid = int(txt_mask.sum())
    print(f'HunyuanTextEncoders.embed: 1 prompt, {enc.max_length} rows '
          f'(95 template + {txt.shape[1]}; {n_valid} prompt rows valid), '
          f'the LLM to its layer {cfg.num_hidden_layers - 2} of '
          f'{cfg.num_hidden_layers} and CLIP-L: {enc_ms:.1f} ms, peak '
          f'{peak:.2f} GiB allocated', flush=True)
    if (tuple(txt.shape) != (1, 256, 4096) or tuple(txt_mask.shape)
            != (1, 256) or tuple(y.shape) != (1, 768)):
        fail(f'HunyuanTextEncoders: shapes {tuple(txt.shape)} '
             f'{tuple(txt_mask.shape)} {tuple(y.shape)}')
    if not (bool(torch.isfinite(txt).all()) and bool(
            torch.isfinite(y).all())):
        fail('HunyuanTextEncoders: non-finite values')
    want = len(HY_PROMPT) + len('<|eot_id|>')
    if n_valid != want or not bool(txt_mask[0, :want].all()):
        fail(f'HunyuanTextEncoders: {n_valid} valid rows, expected {want}')
    ct = enc._clip_tok([HY_PROMPT], 77)
    cids = torch.as_tensor(ct['input_ids'], device='cuda')
    hidden, pooled = tm.clip_text_encode(cparams, cids, ccfg)
    eot = len(HY_PROMPT)
    if not torch.equal(pooled, y) or not torch.equal(y[0], hidden[0, eot]):
        fail('CLIP-L: the pooled row is not the first EOT\'s')
    tt = enc._llm_tok([tm.PROMPT_TEMPLATE_ENCODE_VIDEO.format(HY_PROMPT)],
                      enc.max_length)
    llama_agreement(torch, tm, params, cfg,
                    torch.as_tensor(tt['input_ids'], device='cuda'),
                    torch.as_tensor(tt['attention_mask'], device='cuda'))
    enc.release()
    del params, cparams, hidden, pooled
    torch.cuda.empty_cache()
    print(f'prompt encoders released: '
          f'{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated on '
          f'the card', flush=True)
    return txt, txt_mask, y


def drive_video_path(torch, kern, tm, ck, text):
    """The video main path: hunyuan_denoise at 544x960x129 frames (67,584
    tokens), full width, 1 double + 2 single blocks, random bf16 weights
    from a seed, the shipped config unchanged, the prompt's (txt,
    txt_mask, vec) of encode_hunyuan_text: launch counts set to 0 just
    before and read just after (each must equal the schedule's count,
    VIDEO_LAUNCHES, and no other kernel may run), output finite and of
    the latent's shape; a trace of steps 2-9; the dense loop on the same
    weights; the compiled sparse loop (``compiled_loops``: launches
    VIDEO_LAUNCHES too).  Returns (launches, sparse s, dense s, compiled
    sparse s, the sparse host loop's latent)."""
    cfg = tm.HunyuanModelConfig(**V540, **V_DEPTH)
    t0 = time.perf_counter()
    gen = torch.Generator('cuda')
    gen.manual_seed(SEED)
    params = tm.init_hunyuan_params(gen, cfg, 'cuda')
    txt, txt_mask, y = text
    inputs = (video_inputs(torch, cfg, 'cuda')[0], txt, y, txt_mask)
    model = tm.HunyuanModel(cfg=cfg, ck=ck)
    a = model.sp.attn_s
    print(f'video model: latent {tuple(inputs[0].shape)}, {cfg.img_len} '
          f'image + {cfg.txt_len} text + {cfg.seq_pad} pad = '
          f'{model.seq_padded} tokens, depth {cfg.depth_double}+'
          f'{cfg.depth_single}, jmax {a.jmax}, dense tail from group '
          f'{a.dense_tail_g}, materialize_indices '
          f'{model.ck.attn.materialize_indices}; weights and model built in '
          f'{time.perf_counter() - t0:.1f} s; text from the prompt encoder '
          f'({int(txt_mask.sum())} of {txt_mask.shape[1]} rows valid)',
          flush=True)
    kern.reset_launches()
    marks = {}
    out, sparse_s = run_video(torch, tm, model, params, inputs,
                              callback=window_marks(torch, marks))
    launches = dict(kern.LAUNCHES)
    print(f'video sparse loop: {ck.steps} steps, {sparse_s:.3f} s',
          flush=True)
    print(json.dumps({'path': 'video', 'launches': launches}), flush=True)
    if out.shape != inputs[0].shape:
        fail(f'video: output shape {tuple(out.shape)}')
    if not bool(torch.isfinite(out).all()):
        fail('video: non-finite values in the sparse loop output')
    missing = [k for k in VIDEO_PATH if launches[k] == 0]
    if missing:
        fail(f'video: kernels not launched on the main path: {missing}')
    if plan_launches(model) != VIDEO_LAUNCHES:
        fail(f'video: the plan\'s count {plan_launches(model)} is not '
             f'VIDEO_LAUNCHES')
    wrong = {k: n for k, n in launches.items()
             if n != VIDEO_LAUNCHES.get(k, 0)}
    if wrong:
        fail(f'video: launches differ from the schedule\'s count '
             f'{VIDEO_LAUNCHES}: {wrong}')
    torch.cuda.empty_cache()
    trace_sparse_steps(
        torch, lambda cb: run_video(torch, tm, model, params, inputs,
                                    steps=10, callback=cb),
        (marks[9] - marks[1]) * 1e3, 'video')
    torch.cuda.empty_cache()
    dmodel = tm.HunyuanModel(cfg=cfg, ck=dense_config(ck))
    kern.reset_launches()
    out_d, dense_s = run_video(torch, tm, dmodel, params, inputs)
    if not bool(torch.isfinite(out_d).all()):
        fail('video: non-finite values in the dense loop output')
    depth = cfg.depth_double + cfg.depth_single
    if kern.LAUNCHES['dense_attn'] != depth * ck.steps:
        fail(f'video dense loop: {kern.LAUNCHES["dense_attn"]} dense_attn '
             f'launches, expected {depth * ck.steps}')
    print(f'video dense loop: {ck.steps} steps, {dense_s:.3f} s; sparse '
          f'{sparse_s:.3f} s; sparse speedup {dense_s / sparse_s:.3f}x',
          flush=True)
    del out_d
    torch.cuda.empty_cache()
    c_s, _ = compiled_loops(
        torch, kern, 'video', lambda: lambda: run_video(
            torch, tm, model, params, inputs, compiled=True),
        out, launches, sparse_s)
    print(f'video compiled sparse loop: host dense loop / compiled sparse '
          f'loop {dense_s / c_s:.3f}x', flush=True)
    torch.cuda.empty_cache()
    streamed_video_loop(torch, kern, tm, model, params, inputs, out,
                        sparse_s)
    del params
    torch.cuda.empty_cache()
    return launches, sparse_s, dense_s, c_s, out


def plan_launches(model, steps=None):
    """Each video kernel's launches over the computed steps of the model's
    plan (its first ``steps`` only if given), from the layers' roles: a
    dense layer runs dense_attn every step; a sparse layer dense_attn on
    step 0, dense_colsum_attn + csp on a colsum step, dense_attn + csp on
    a plain full step, csp (+ dense_attn on the dense tail) on a sparse
    step; a skipped step runs nothing."""
    from chipmunk_torch.schedule import step_plan
    sp = model.sp
    n = model.cfg.depth_double + model.cfg.depth_single
    dense = sp.n_dense_attn_double + sp.n_dense_attn_single
    tail = sp.attn_s.dense_tail_g is not None
    c = dict.fromkeys(VIDEO_PATH, 0)
    computed = False
    for i, kind in enumerate(step_plan(model.ck)[:steps]):
        if kind.skip and computed:
            continue
        computed, k = True, n - dense
        c['dense_attn'] += dense
        if i == 0:
            c['dense_attn'] += k
        elif kind.full_attn:
            c['dense_colsum_attn' if kind.colsum else 'dense_attn'] += k
            c['csp_attn_hbm'] += k
        else:
            c['csp_attn_hbm'] += k
            c['dense_attn'] += k if tail else 0
    return c


def step_label(kind, i, skipped):
    return ('skipped' if skipped else 'first' if i == 0 else 'colsum'
            if kind.colsum else 'full' if kind.full_attn else 'sparse')


def copy_marks(torch, recs, sync_at=()):
    """A denoise callback that records, after each step, the step's label
    inputs and the bytes the offload copies issued each way during it (and
    the host clock, synchronised, after the steps in ``sync_at``, or after
    every step if ``sync_at`` is None)."""
    from chipmunk_torch.utils import offload
    offload.reset_copy_stats()

    def step_done(i, skipped):
        if sync_at is None or i in sync_at:
            torch.cuda.synchronize()
        recs.append((i, skipped, time.perf_counter(),
                     offload.COPY_STATS['h2d_bytes'],
                     offload.COPY_STATS['d2h_bytes']))
        offload.reset_copy_stats()
    return step_done


def bytes_by_kind(ck, recs):
    """Mean GB moved H2D and D2H a step, by step kind."""
    from chipmunk_torch.schedule import step_plan
    plan, by = step_plan(ck), {}
    for i, skipped, _, h2d, d2h in recs:
        by.setdefault(step_label(plan[i], i, skipped), []).append((h2d, d2h))
    return {k: (sum(h for h, _ in v) / len(v) / 1e9,
                sum(d for _, d in v) / len(v) / 1e9, len(v))
            for k, v in by.items()}


def streamed_video_loop(torch, kern, tm, model, params, inputs, ref, ref_s):
    """The 540p loop of drive_video_path streamed: the same weights,
    inputs and keep seed, the config's offloading (attention out_cache
    and packed indices in pinned host memory), one layer a chunk, every
    chunk streamed (no resident chunk: each layer's caches cross the link
    every step), launch counts set to 0 just before and read just after:
    the latent must equal the resident loop's (``ref``) bit for bit, with
    VIDEO_LAUNCHES.  Prints its seconds beside the resident loop's, the
    GB moved each way a step by step kind, the device peak and the pinned
    GiB."""
    t0 = time.perf_counter()
    runner, sst = model.make_streamed(model.cfg.depth_double,
                                      model.cfg.depth_single)
    streamed = (dataclasses.replace(runner, resident_chunks=0), sst)
    torch.cuda.synchronize()
    pin_s = time.perf_counter() - t0
    recs = []
    torch.cuda.reset_peak_memory_stats()
    kern.reset_launches()
    out, secs = run_video(torch, tm, model, params, inputs,
                          callback=copy_marks(torch, recs, (1, 9)),
                          streamed=streamed)
    launches = dict(kern.LAUNCHES)
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30,
            torch.cuda.max_memory_reserved() / 2 ** 30)
    print(json.dumps({'path': 'video streamed', 'launches': launches}),
          flush=True)
    kinds = bytes_by_kind(model.ck, recs)
    print(f'video streamed loop (540p, one layer a chunk): {secs:.3f} s, '
          f'resident loop {ref_s:.3f} s ({secs / ref_s:.4f}x); pinned '
          f'{streamed[1].host_bytes() / 2 ** 30:.3f} GiB (state built and '
          f'page-locked in {pin_s:.2f} s); peak {peak[0]:.2f} GiB '
          f'allocated, {peak[1]:.2f} reserved; GB a step H2D / D2H: '
          + '; '.join(f'{k} {h:.4f} / {d:.4f} (x{n})'
                      for k, (h, d, n) in kinds.items()), flush=True)
    if launches != {k: VIDEO_LAUNCHES.get(k, 0) for k in launches}:
        fail(f'video streamed loop: launches {launches} differ from '
             f'{VIDEO_LAUNCHES}')
    if not torch.equal(out, ref):
        fail(f'video streamed loop differs from the resident loop: max '
             f'abs {(out - ref).abs().max().item()}')
    print('video streamed loop: latent equal to the resident loop\'s bit '
          'for bit', flush=True)
    del streamed, out
    torch.cuda.empty_cache()


def meminfo():
    """MemTotal and MemAvailable of the host in GiB."""
    got = {}
    with open('/proc/meminfo') as f:
        for line in f:
            k, v = line.split(':')
            if k in ('MemTotal', 'MemAvailable'):
                got[k] = int(v.split()[0]) * 1024 / 2 ** 30
    return got


def link_probe(torch, nbytes=2 ** 30):
    """The host link: one page-locked 1 GiB buffer (offload.HostSlab)
    copied to and from the card, 3 times each way, timed with CUDA
    events; and what PyTorch's own pinned allocator reserves for one
    request of the 720p out_cache's size.  Returns (H2D GB/s, D2H GB/s),
    the best of 3."""
    from chipmunk_torch.utils import offload
    host = offload.HostSlab(nbytes, torch.device('cuda')).take(
        (nbytes,), torch.uint8)
    dev = torch.empty(nbytes, dtype=torch.uint8, device='cuda')
    rates = {}
    for name, dst, src in (('H2D', dev, host), ('D2H', host, dev)):
        best = math.inf
        for _ in range(3):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            dst.copy_(src, non_blocking=True)
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b) / 1e3)
        rates[name] = nbytes / best / 1e9
    del host, dev
    req = 24 * 119168 * 128 * 2            # one 720p bf16 out_cache
    msg = 'PyTorch pinned allocator: not probed (no host_memory_stats)'
    if hasattr(torch.cuda, 'host_memory_stats'):
        before = torch.cuda.host_memory_stats()
        t = torch.empty(req, dtype=torch.uint8, pin_memory=True)
        after = torch.cuda.host_memory_stats()
        grown = {k: after[k] - before.get(k, 0) for k in after
                 if 'bytes' in k and k.endswith('current')
                 and after[k] != before.get(k, 0)}
        msg = (f'PyTorch pinned allocator: {req} bytes requested, counters '
               f'grown {grown}')
        del t
    print(f'host link (page-locked 1 GiB, best of 3): H2D '
          f'{rates["H2D"]:.2f} GB/s, D2H {rates["D2H"]:.2f} GB/s; {msg}',
          flush=True)
    return rates['H2D'], rates['D2H']


def drive_streamed_720p(torch, kern, tm, ck):
    """HunyuanVideo as ``HunyuanModelConfig()`` stands (720x1280x129
    frames: 118,800 image + 256 text + 112 pad = 119,168 tokens; 20 + 40
    blocks, width 3072, 24 heads, bf16), random weights from a seed,
    inputs as video_inputs draws them, the shipped config as read,
    streamed with one layer a chunk: its attention caches (44 GB) in
    pinned host memory.  The cut: the first STEPS_720 steps of its
    50-step plan.  Gates: output finite and of its shape, launches equal
    to the plan's count for those steps kernel by kernel.  Prints the
    host's memory, the link, each step's seconds, kind and GB moved each
    way, the device peak, the pinned GiB, and a projection of the 50-step
    loop from the step times."""
    from chipmunk_torch.schedule import step_plan
    torch.cuda.empty_cache()
    mem = meminfo()
    print(f'host memory: MemTotal {mem["MemTotal"]:.2f} GiB, MemAvailable '
          f'{mem["MemAvailable"]:.2f} GiB', flush=True)
    link = link_probe(torch)
    cfg = tm.HunyuanModelConfig(**V_FULL)
    t0 = time.perf_counter()
    gen = torch.Generator('cuda')
    gen.manual_seed(SEED)
    params = tm.init_hunyuan_params(gen, cfg, 'cuda')
    inputs = video_inputs(torch, cfg, 'cuda')
    model = tm.HunyuanModel(cfg=cfg, ck=ck)
    torch.cuda.synchronize()
    w_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    runner, sst = model.make_streamed(cfg.depth_double, cfg.depth_single)
    torch.cuda.synchronize()
    pin_s = time.perf_counter() - t0
    expect = plan_launches(model, STEPS_720)
    print(f'video 720p full depth: latent {tuple(inputs[0].shape)}, '
          f'{cfg.img_len} image + {cfg.txt_len} text + {cfg.seq_pad} pad = '
          f'{model.seq_padded} tokens, depth {cfg.depth_double}+'
          f'{cfg.depth_single}, jmax {model.sp.attn_s.jmax}; weights '
          f'{sum(x.numel() * x.element_size() for x in tensors(params)) / 1e9:.2f}'
          f' GB drawn in {w_s:.1f} s; streamed state {sst.host_bytes() / 2 ** 30:.2f}'
          f' GiB pinned, built in {pin_s:.1f} s; host MemAvailable now '
          f'{meminfo()["MemAvailable"]:.2f} GiB; expected launches {expect}',
          flush=True)
    recs = []
    torch.cuda.reset_peak_memory_stats()
    kern.reset_launches()
    t_start = time.perf_counter()
    out, secs = run_video(torch, tm, model, params, inputs, steps=STEPS_720,
                          callback=copy_marks(torch, recs, None),
                          streamed=(runner, sst))
    launches = dict(kern.LAUNCHES)
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30,
            torch.cuda.max_memory_reserved() / 2 ** 30)
    print(json.dumps({'path': 'video 720p streamed', 'launches': launches}),
          flush=True)
    plan, prev, times = step_plan(ck), t_start, {}
    for i, skipped, t, h2d, d2h in recs:
        label = step_label(plan[i], i, skipped)
        times[i] = (label, t - prev)
        print(f'video 720p step {i} ({label}): {t - prev:.3f} s, H2D '
              f'{h2d / 1e9:.3f} GB, D2H {d2h / 1e9:.3f} GB', flush=True)
        prev = t
    sparse = [s for lb, s in times.values() if lb == 'sparse']
    proj = times[0][1] + 3 * times[1][1] + 21 * sum(sparse) / len(sparse)
    print(f'video 720p full depth streamed: {STEPS_720} steps {secs:.3f} '
          f's; peak {peak[0]:.2f} GiB allocated, {peak[1]:.2f} reserved; '
          f'pinned {sst.host_bytes() / 2 ** 30:.2f} GiB; link H2D '
          f'{link[0]:.2f} / D2H {link[1]:.2f} GB/s; PROJECTION (not a '
          f'measurement) of the 50-step loop: step 0 + 3 x step 1 + 21 x '
          f'the mean sparse step = {proj:.1f} s (25 steps skipped)',
          flush=True)
    if out.shape != inputs[0].shape:
        fail(f'video 720p: output shape {tuple(out.shape)}')
    if not bool(torch.isfinite(out).all()):
        fail('video 720p: non-finite values in the streamed output')
    if launches != {k: expect.get(k, 0) for k in launches}:
        fail(f'video 720p: launches {launches} differ from the plan\'s '
             f'count {expect}')
    del params, runner, sst, out, inputs
    torch.cuda.empty_cache()


def agree_small_video(torch, tm, kern, ck):
    """A small full-width video model (depth 1+2, latent (5, 16, 30): 600
    image + 256 text + 40 pad tokens, voxel tails on t and w) for 4 steps
    (first, colsum, two sparse), random_keys 0: the same weights (drawn on
    the CPU) through the kernels on the card, once with csp mode 'auto'
    (the 'vmem' kernel at this size) and once 'hbm', each against the
    plain versions on the CPU.  Mean relative difference <= 2e-2 (bf16
    model) and the mode's csp kernel must have launched."""
    from chipmunk_torch.config import config_from_dict
    small_ck = config_from_dict({
        'steps': 4,
        'attn': {'full_step_schedule': [0, 1], 'first_n_dense_layers': 1,
                 'top_keys': 0.3, 'random_keys': 0.0,
                 'dense_fallback_frac': 1.0},
        'step_caching': {'is_enabled': False}}, ck)
    cfg = tm.HunyuanModelConfig(latent_t=5, latent_h=16, latent_w=30,
                                depth_double=1, depth_single=2)
    gen = torch.Generator()
    gen.manual_seed(SEED)
    params_cpu = tm.init_hunyuan_params(gen, cfg, 'cpu')
    inputs = video_inputs(torch, cfg, 'cpu')
    cpu_model = tm.HunyuanModel(cfg=cfg, ck=small_ck, device='cpu')
    cpu_out, cpu_s = run_video(torch, tm, cpu_model, params_cpu, inputs)

    params = to_device(params_cpu, 'cuda')
    for mode, csp in (('auto', 'csp_attn'), ('hbm', 'csp_attn_hbm')):
        model = tm.HunyuanModel(cfg=cfg, ck=small_ck, csp_mode=mode)
        kern.reset_launches()
        out, _ = run_video(torch, tm, model, params,
                           tuple(x.to('cuda') for x in inputs))
        launches = {k: n for k, n in kern.LAUNCHES.items() if n}
        rel = ((out.cpu() - cpu_out).abs().mean()
               / cpu_out.abs().mean()).item()
        print(f'video small-input agreement, csp mode {mode!r} (card '
              f'kernels vs CPU plain versions): mean relative difference '
              f'{rel:.3e}, launches {launches}, CPU run {cpu_s:.1f} s',
              flush=True)
        if not math.isfinite(rel) or rel > 2e-2:
            fail(f'video small-input output (csp mode {mode!r}) differs '
                 f'from the plain versions: {rel}')
        missing = [k for k in ('dense_attn', 'dense_colsum_attn', csp)
                   if not launches.get(k)]
        if missing:
            fail(f'video small run (csp mode {mode!r}): kernels not '
                 f'launched: {missing}')
    # compiled vs host on the card: random keeps on, 6 steps with the
    # colsum and the sparse kinds recurring
    rk_ck = config_from_dict({'steps': 6, 'attn': {
        'random_keys': 0.05, 'full_step_schedule': [0, 1, 3, 5]}}, small_ck)
    model = tm.HunyuanModel(cfg=cfg, ck=rk_ck)
    outs, launches = [], []
    for compiled in (False, True):
        kern.reset_launches()
        outs.append(run_video(torch, tm, model, params,
                              tuple(x.to('cuda') for x in inputs),
                              compiled=compiled)[0])
        launches.append(dict(kern.LAUNCHES))
    check_compiled_agreement(torch, 'video', outs, launches)


def wan_kernel_phases(torch, mods, tm, ck):
    """The kernels of the Wan path at its shapes (B 1, 12 heads, D 128,
    32,768 query rows, keys cut at 32,760, jmax 62, the selection as the
    main path makes it from random column sums), each against its plain
    version:
      dense_attn, self-attention (full steps, dense layers): rows 0-127
        and the last 256 (pad rows included), all heads; the 128-row dense
        tail as a view of q, equal to the same rows of the full call;
      dense_attn, cross-attention over 512 text keys: every row and head;
      dense_colsum_attn (qg 128, score block 128) with PAD_LSE on the pad
        rows: groups 0-1 and the tail group;
      csp_attn in the mode 'auto' picks here ('vmem', keys read in place):
        head 0, with group 1 of every head re-pointed at jmax blocks that
        include the last one, which kv_valid cuts to 120 rows, and group
        2 at that block alone (a count of 1).
    For each it prints ms (CUDA events, wrapper included), device_ms (the
    kernel's own time from profiler records), the bound and the time of
    one scaled_dot_product_attention call that computes the same function
    (for csp_attn with the boolean block mask on LIB_HEADS heads, scaled
    to 12; none for the column sums).  Returns the numbers."""
    from chipmunk_torch.ops.attn_ref import PAD_LSE
    fa, ca = mods[0], mods[1]
    gen = torch.Generator('cuda')
    gen.manual_seed(SEED + 5)
    Hw = WAN_H

    def randn(*shape):
        return torch.randn(shape, generator=gen, device='cuda').to(
            torch.bfloat16)

    model = tm.WanModel(cfg=tm.WanModelConfig(**WAN_LATENT, num_layers=2),
                        ck=ck)
    mod = model.attn_mod
    S, n, jmax = mod.seq_len, mod.valid_len, mod.jmax
    t0, nb = mod.dense_tail_g * 128, S // 128
    mode = ca.auto_mode(S, S, D, jmax, 128, 2)
    q, k, v = randn(B, Hw, S, D), randn(B, Hw, S, D), randn(B, Hw, S, D)
    pinds, counts = video_selection(torch, mod, Hw, gen)
    print(f'wan kernels: seq {S} (valid {n}), jmax {jmax}, dense tail from '
          f'row {t0}, auto csp mode {mode!r}, selected blocks per group '
          f'mean {counts.float().mean().item():.2f} max '
          f'{counts.max().item()}', flush=True)
    if (S, n, jmax, t0, mode) != (32768, 32760, 62, 32640, 'vmem'):
        fail(f'Wan shape is not the expected one: {(S, n, jmax, t0, mode)}')
    out = {}

    def record(tag, fn, flops, nbytes=None, lib=None, reps=5, bound=None):
        out[f'{tag} ms'] = time_ms(torch, fn, reps)
        out[f'{tag} device_ms'] = device_ms(torch, fn, reps)[0]
        out[f'{tag} bound ms'], by = bound or bound_ms(flops, nbytes)
        out[f'{tag} TFLOP/s (device)'] = flops / out[f'{tag} device_ms'] / 1e9
        if lib is not None:
            out[f'{tag} library ms (SDPA)'] = time_ms(torch, lib, reps)
        print(f'wan kernels: {tag}: ms {out[f"{tag} ms"]:.4f} device_ms '
              f'{out[f"{tag} device_ms"]:.4f} bound '
              f'{out[f"{tag} bound ms"]:.4f} ({by}) SDPA '
              f'{out.get(f"{tag} library ms (SDPA)")}', flush=True)

    # ---- dense_attn, self-attention over the cut keys
    kc, vc = k[..., :n, :], v[..., :n, :]      # views: no copy
    od, lse = fa.dense_attn(q, kc, vc)
    torch.cuda.synchronize()
    for r in (slice(0, 128), slice(S - 256, S)):
        o_p, lse_p = fa.dense_attn_plain(q[..., r, :], kc, vc)
        out['dense_attn self max_abs_err'] = check_close(
            'dense_attn o (Wan)', od[..., r, :], o_p, 4e-3, 2 ** -6)
        check_close('dense_attn lse (Wan)', lse[..., r], lse_p, 1e-3, 0.0)
    ot, _ = fa.dense_attn(q[..., t0:, :], kc, vc)
    torch.cuda.synchronize()
    if not torch.equal(ot, od[..., t0:, :]):
        fail('dense_attn: the 128-row tail differs from the same rows of '
             'the full call (Wan)')
    flops = 4.0 * B * Hw * S * n * D
    attn_bytes = B * Hw * (2 * S + 2 * n) * D * 2
    record('dense_attn self', lambda: fa.dense_attn(q, kc, vc), flops,
           attn_bytes + B * Hw * S * 4,
           lambda: torch.nn.functional.scaled_dot_product_attention(
               q, kc, vc))
    tail = S - t0
    record('dense_attn tail (128 rows)',
           lambda: fa.dense_attn(q[..., t0:, :], kc, vc),
           4.0 * B * Hw * tail * n * D,
           B * Hw * (2 * tail + 2 * n) * D * 2 + B * Hw * tail * 4, reps=20)

    # ---- dense_attn, cross-attention: 32,768 queries over 512 text keys
    ck_, cv = randn(B, Hw, 512, D), randn(B, Hw, 512, D)
    oc, lc = fa.dense_attn(q, ck_, cv)
    torch.cuda.synchronize()
    o_p, lse_p = fa.dense_attn_plain(q, ck_, cv)
    out['dense_attn cross max_abs_err'] = check_close(
        'dense_attn cross o (Wan)', oc, o_p, 4e-3, 2 ** -6)
    check_close('dense_attn cross lse (Wan)', lc, lse_p, 1e-3, 0.0)
    del o_p, lse_p, oc, lc
    record('dense_attn cross (Sk 512)', lambda: fa.dense_attn(q, ck_, cv),
           4.0 * B * Hw * S * 512 * D,
           B * Hw * (2 * S + 2 * 512) * D * 2 + B * Hw * S * 4,
           lambda: torch.nn.functional.scaled_dot_product_attention(
               q, ck_, cv), reps=20)

    # ---- dense_colsum_attn (colsum steps 1, 10, 40)
    prev = lse.clone()
    prev[..., n:] = PAD_LSE
    o, cs, lc = fa.dense_colsum_attn(q, kc, vc, prev)
    torch.cuda.synchronize()
    for r in (slice(0, 256), slice(t0, S)):
        o_p, cs_p, lse_p = fa.dense_colsum_attn_plain(q[..., r, :], kc, vc,
                                                      prev[..., r])
        out['dense_colsum_attn max_abs_err'] = check_close(
            'dense_colsum_attn o (Wan)', o[..., r, :], o_p, 4e-3, 2 ** -6)
        check_close('dense_colsum_attn lse (Wan)', lc[..., r], lse_p, 1e-3,
                    0.0)
        check_close('dense_colsum_attn colsums (Wan)',
                    cs[:, :, r.start // 128:r.stop // 128], cs_p, 1e-4, 1e-3)
    record('dense_colsum_attn', lambda: fa.dense_colsum_attn(
        q, kc, vc, prev), flops,
        attn_bytes + B * Hw * S * 8 + cs.numel() * 4)
    del o, cs, lc, o_p, cs_p, lse_p, od, ot, lse, prev

    # ---- csp_attn ('vmem'): head 0 against the plain version, groups 1
    # and 2 re-pointed at the cut last block (counts jmax and 1)
    ci, cc = pinds.clone(), counts.clone()
    for h in range(Hw):
        pick = torch.randperm(nb - 1, generator=gen, device='cuda')[
            :jmax - 1]
        ci[0, h, 1] = torch.cat([pick, pick.new_tensor([nb - 1])]).sort()[0]
    ci[..., 2, :] = nb - 1
    cc[..., 1], cc[..., 2] = jmax, 1
    o = ca.csp_attn(q, k, v, ci, cc, kv_valid=n)
    torch.cuda.synchronize()
    o_p = ca.csp_attn_plain(q[:, :1], k[:, :1], v[:, :1], ci[:, :1],
                            cc[:, :1], kv_valid=n)
    out['csp_attn max_abs_err'] = check_close(
        'csp_attn o (Wan, head 0)', o[:, :1], o_p, 4e-3, 2 ** -6)
    del o, o_p, ci, cc
    record('csp_attn (vmem)', lambda: ca.csp_attn(
        q, k, v, pinds, counts, kv_valid=n), csp_flops(counts),
        bound=csp_bound(torch, pinds, counts, q))
    out['csp_attn (vmem) plain ms (head 0 of 12)'] = time_ms(
        torch, lambda: ca.csp_attn_plain(q[:, :1], k[:, :1], v[:, :1],
                                         pinds[:, :1], counts[:, :1],
                                         kv_valid=n), 1)
    out[f'csp_attn (vmem) library ms (SDPA, block mask, heads 0-'
        f'{LIB_HEADS - 1} x {Hw // LIB_HEADS})'] = csp_library_ms(
            torch, q, k, v, pinds, counts, nb, n, LIB_HEADS, 3) \
        * Hw / LIB_HEADS
    del q, k, v, kc, vc, ck_, cv, model
    torch.cuda.empty_cache()
    for key, val in out.items():
        print(f'wan kernels: {key} {val:.4f}', flush=True)
    return out


def tensors(tree):
    """The tensors of a nest of dicts, lists and tuples (None skipped)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensors(x)]
    return [] if tree is None else [tree]


def encode_wan_text(torch, tm):
    """UMT5-XXL at full size in bf16 (24 layers, dim 4096, 64 heads, vocab
    256,384; weights from init_umt5_params on a seed) through
    ``WanTextEncoder.embed``, a stand-in tokenizer set on the holder: two
    prompts (cond, uncond) of UMT5_VALID tokens padded to 512, each row
    zeroed past its prompt.  Checks: finite, [2, 512, 4096], the rows past
    each prompt exactly 0, and the tokenizer's ids with those past each
    prompt redrawn, through ``umt5_encode``, agree on the valid rows
    (mean relative difference <= 1e-3: masked keys add exactly 0).  The
    encoder is released before returning (ctx_cond, ctx_uncond), each
    [1, 512, 4096] bf16."""
    cfg = tm.UMT5Config(dtype=torch.bfloat16)
    gen = torch.Generator('cuda')
    gen.manual_seed(SEED + 6)
    enc = tm.WanTextEncoder(text_len=512, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    enc._params, enc._cfg = tm.init_umt5_params(gen, cfg, 'cuda'), cfg
    enc._tok = StandInTokenizer(cfg.vocab_size, 0, eot=1)
    torch.cuda.synchronize()
    leaves = tensors(enc._params)
    n_par = sum(t.numel() for t in leaves)
    print(f'UMT5-XXL: {cfg.num_layers} layers, dim {cfg.dim}, '
          f'{cfg.num_heads} heads, vocab {cfg.vocab_size}: '
          f'{n_par / 1e9:.3f}B parameters, '
          f'{sum(t.numel() * t.element_size() for t in leaves) / 1e9:.2f} '
          f'GB bf16, drawn on the card in {time.perf_counter() - t0:.2f} s',
          flush=True)
    L = 512
    prompts = [(WAN_PROMPT * 4)[:n - 1] for n in UMT5_VALID]
    enc.embed(prompts)                            # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx = enc.embed(prompts)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    tt = enc._tok(prompts, L)
    ids = torch.as_tensor(tt['input_ids'], device='cuda')
    mask = torch.as_tensor(tt['attention_mask'], device='cuda')
    if tuple(mask.sum(1).tolist()) != UMT5_VALID:
        fail(f'UMT5: the stand-in gave {mask.sum(1).tolist()} tokens')
    ids2 = torch.where(mask.bool(), ids, torch.randint(
        0, cfg.vocab_size, (2, L), generator=gen, device='cuda'))
    ctx2 = tm.umt5_encode(enc._params, ids2, mask, cfg)
    if ctx.shape != (2, L, cfg.dim) or ctx.dtype != torch.bfloat16:
        fail(f'UMT5: output {tuple(ctx.shape)} {ctx.dtype}')
    if not bool(torch.isfinite(ctx).all()):
        fail('UMT5: non-finite values')
    if bool((ctx * (1 - mask[..., None]).to(ctx.dtype)).any()):
        fail('UMT5: WanTextEncoder.embed left rows past a prompt non-zero')
    ctx2 = ctx2 * mask[..., None].to(ctx2.dtype)
    rel = ((ctx.float() - ctx2.float()).abs().mean()
           / ctx.float().abs().mean()).item()
    print(f'UMT5-XXL: WanTextEncoder.embed of 2 prompts ({UMT5_VALID} '
          f'tokens of {L}) in {enc_s * 1e3:.1f} ms; the ids past the '
          f'prompts redrawn: mean relative difference {rel:.3e} on the '
          f'valid rows', flush=True)
    if not rel <= 1e-3:
        fail(f'UMT5: the padded ids change the valid rows: {rel}')
    enc.release()
    del leaves, ctx2
    torch.cuda.empty_cache()
    print(f'UMT5-XXL released: {torch.cuda.memory_allocated() / 1e9:.2f} GB '
          f'allocated on the card', flush=True)
    return ctx[:1].contiguous(), ctx[1:].contiguous()


def run_wan(torch, tm, model, params, lat, ctx, steps=None, callback=None,
            compiled=False):
    """One wan_denoise (``compiled``: wan_denoise_compiled, no callback)
    over the config's schedule (unshifted, as scripts/bench_wan.py:109
    has it), the first ``steps`` steps only if given, guide_scale 5.0,
    random keeps from a seeded generator on the model's device.  Returns
    (latent, seconds)."""
    dev = model.device
    ts = tm.get_schedule(model.ck.steps, model.cfg.seq_len, shift=False)
    if steps is not None:
        ts = ts[:steps + 1]
    gen = torch.Generator(dev)
    gen.manual_seed(SEED)
    if dev.type == 'cuda':
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    if compiled:
        out = tm.wan_denoise_compiled(model, params, lat, *ctx, ts,
                                      guide_scale=5.0, generator=gen)
    else:
        out = tm.wan_denoise(model, params, lat, *ctx, ts, guide_scale=5.0,
                             generator=gen, callback=callback)
    if dev.type == 'cuda':
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def drive_wan_path(torch, kern, tm, ck, ctx):
    """The Wan main path: wan_denoise at 480x832x81 frames (latent (16,
    21, 60, 104): 32,760 tokens padded to 32,768), full width and depth
    (30 layers), random bf16 weights from a seed, the UMT5 contexts of
    encode_wan_text, configs/wan-chipmunk.yml as read: launch counts set
    to 0 just before and read just after (each must equal WAN_LAUNCHES,
    no other kernel may run), output finite and of the latent's shape; a
    trace of steps 2-9; the dense loop on the same weights (attention
    sparsity and step caching off; launches WAN_DENSE_LAUNCHES); the
    compiled sparse loop (``compiled_loops``: launches WAN_LAUNCHES too).
    Returns (launches, sparse s, dense s, compiled sparse s, the sparse
    host loop's latent)."""
    cfg = tm.WanModelConfig(**WAN_LATENT)
    t0 = time.perf_counter()
    gen = torch.Generator('cuda')
    gen.manual_seed(SEED)
    params = tm.init_wan_params(gen, cfg, 'cuda')
    lat = torch.randn((1, cfg.in_channels, cfg.latent_t, cfg.latent_h,
                       cfg.latent_w), generator=gen, device='cuda')
    model = tm.WanModel(cfg=cfg, ck=ck)
    a = model.attn_mod
    n_par = sum(t.numel() for t in tensors(params))
    st_gb = sum(t.numel() * t.element_size()
                for t in tensors(model.init_state(1))) / 1e9
    print(f'wan model: latent {tuple(lat.shape)}, {cfg.seq_len} tokens + '
          f'{model.seq_padded - cfg.seq_len} pad = {model.seq_padded}, '
          f'{cfg.num_layers} layers, dim {cfg.dim}, {cfg.num_heads} heads, '
          f'{n_par / 1e9:.3f}B parameters, jmax {a.jmax}, sel_blocks '
          f'{a.sel_blocks}, dense tail from group {a.dense_tail_g}, '
          f'materialize_indices {model.ck.attn.materialize_indices}; one '
          f'invocation state {st_gb:.3f} GB (MLP caches: none, the MLP is '
          f'off); weights and model built in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    torch.cuda.reset_peak_memory_stats()
    kern.reset_launches()
    marks = {}
    out, sparse_s = run_wan(torch, tm, model, params, lat, ctx,
                            callback=window_marks(torch, marks))
    launches = dict(kern.LAUNCHES)
    print(f'wan sparse loop: {ck.steps} steps, {sparse_s:.3f} s; peak '
          f'{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated',
          flush=True)
    print(json.dumps({'path': 'wan', 'launches': launches}), flush=True)
    if out.shape != lat.shape:
        fail(f'wan: output shape {tuple(out.shape)}')
    if not bool(torch.isfinite(out).all()):
        fail('wan: non-finite values in the sparse loop output')
    missing = [k for k in WAN_PATH if launches[k] == 0]
    if missing:
        fail(f'wan: kernels not launched on the main path: {missing}')
    wrong = {k: n for k, n in launches.items()
             if n != WAN_LAUNCHES.get(k, 0)}
    if wrong:
        fail(f'wan: launches differ from the schedule\'s count '
             f'{WAN_LAUNCHES}: {wrong}')
    torch.cuda.empty_cache()
    trace_sparse_steps(
        torch, lambda cb: run_wan(torch, tm, model, params, lat, ctx,
                                  steps=10, callback=cb),
        (marks[9] - marks[1]) * 1e3, 'wan')
    torch.cuda.empty_cache()
    dmodel = tm.WanModel(cfg=cfg, ck=dense_config(ck))
    kern.reset_launches()
    out_d, dense_s = run_wan(torch, tm, dmodel, params, lat, ctx)
    if not bool(torch.isfinite(out_d).all()):
        fail('wan: non-finite values in the dense loop output')
    dl = {k: n for k, n in kern.LAUNCHES.items() if n}
    if dl != WAN_DENSE_LAUNCHES:
        fail(f'wan dense loop: launches {dl}, expected {WAN_DENSE_LAUNCHES}')
    rel = ((out - out_d).abs().mean() / out_d.abs().mean()).item()
    print(f'wan dense loop: {ck.steps} steps, {dense_s:.3f} s; sparse '
          f'{sparse_s:.3f} s; sparse speedup {dense_s / sparse_s:.3f}x; '
          f'sparse vs dense latent: mean relative difference {rel:.4f} '
          f'(random weights)', flush=True)
    del out_d
    torch.cuda.empty_cache()
    c_s, _ = compiled_loops(
        torch, kern, 'wan', lambda: lambda: run_wan(
            torch, tm, model, params, lat, ctx, compiled=True),
        out, launches, sparse_s)
    print(f'wan compiled sparse loop: host dense loop / compiled sparse '
          f'loop {dense_s / c_s:.3f}x', flush=True)
    del params
    torch.cuda.empty_cache()
    return launches, sparse_s, dense_s, c_s, out


def agree_small_wan(torch, tm, kern, ck):
    """A small Wan with full-width heads (dim 1536, 12 heads of 128, FFN
    8960), 2 layers, latent (5, 16, 30): 600 tokens + 40 pad (voxel tails
    on t and w), 512 text rows, for 4 steps (first, colsum, two sparse),
    local_voxels 1 (the shipped cube of 3 covers this grid whole),
    random_keys 0: the same weights and inputs (drawn on the CPU) through
    the kernels on the card, once with csp mode 'auto' (the 'vmem'
    kernel) and once 'hbm', each against the plain versions on the CPU.
    Mean relative difference <= 2e-2 (bf16 model) and dense_attn,
    dense_colsum_attn and the mode's csp kernel must have launched.  Then
    a small float32 UMT5 (2 layers, dim 256, 4 heads) with a partial mask
    on the card against the CPU: mean relative difference <= 1e-4."""
    from chipmunk_torch.config import config_from_dict
    small_ck = config_from_dict({
        'steps': 4,
        'attn': {'full_step_schedule': [0, 1], 'first_n_dense_layers': 1,
                 'top_keys': 0.3, 'random_keys': 0.0, 'local_voxels': 1,
                 'dense_fallback_frac': 1.0},
        'step_caching': {'is_enabled': False}}, ck)
    cfg = tm.WanModelConfig(latent_t=5, latent_h=16, latent_w=30,
                            num_layers=2)
    gen = torch.Generator()
    gen.manual_seed(SEED)
    params_cpu = tm.init_wan_params(gen, cfg, 'cpu')
    lat = torch.randn((1, cfg.in_channels, 5, 16, 30), generator=gen)
    ctx = torch.randn((2, 1, cfg.txt_len, cfg.text_dim), generator=gen).to(
        cfg.dtype)
    for i, n in enumerate(UMT5_VALID):
        ctx[i, :, n:] = 0
    cpu_model = tm.WanModel(cfg=cfg, ck=small_ck, device='cpu')
    a = cpu_model.attn_mod
    if (a.valid_len, a.dense_tail_g) != (600, 4):
        fail(f'small Wan: valid_len {a.valid_len}, dense tail '
             f'{a.dense_tail_g}, expected 600 and 4')
    cpu_out, cpu_s = run_wan(torch, tm, cpu_model, params_cpu, lat,
                             (ctx[0], ctx[1]))

    params = to_device(params_cpu, 'cuda')
    for mode, csp in (('auto', 'csp_attn'), ('hbm', 'csp_attn_hbm')):
        model = tm.WanModel(cfg=cfg, ck=small_ck, csp_mode=mode)
        kern.reset_launches()
        out, _ = run_wan(torch, tm, model, params, lat.cuda(),
                         (ctx[0].cuda(), ctx[1].cuda()))
        launches = {k: n for k, n in kern.LAUNCHES.items() if n}
        rel = ((out.cpu() - cpu_out).abs().mean()
               / cpu_out.abs().mean()).item()
        print(f'wan small-input agreement, csp mode {mode!r} (card kernels '
              f'vs CPU plain versions): mean relative difference '
              f'{rel:.3e}, launches {launches}, CPU run {cpu_s:.1f} s',
              flush=True)
        if not math.isfinite(rel) or rel > 2e-2:
            fail(f'wan small-input output (csp mode {mode!r}) differs from '
                 f'the plain versions: {rel}')
        missing = [k for k in ('dense_attn', 'dense_colsum_attn', csp)
                   if not launches.get(k)]
        if missing:
            fail(f'wan small run (csp mode {mode!r}): kernels not '
                 f'launched: {missing}')
    # compiled vs host on the card, as agree_small_video's
    rk_ck = config_from_dict({'steps': 6, 'attn': {
        'random_keys': 0.05, 'full_step_schedule': [0, 1, 3, 5]}}, small_ck)
    model = tm.WanModel(cfg=cfg, ck=rk_ck)
    outs, launches = [], []
    for compiled in (False, True):
        kern.reset_launches()
        outs.append(run_wan(torch, tm, model, params, lat.cuda(),
                            (ctx[0].cuda(), ctx[1].cuda()),
                            compiled=compiled)[0])
        launches.append(dict(kern.LAUNCHES))
    check_compiled_agreement(torch, 'wan', outs, launches)
    del params
    torch.cuda.empty_cache()

    t5 = tm.UMT5Config(vocab_size=512, dim=256, dim_attn=256, dim_ffn=512,
                       num_heads=4, num_layers=2)
    tp = tm.init_umt5_params(gen, t5, 'cpu')
    ids = torch.randint(0, 512, (2, 64), generator=gen)
    mask = (torch.arange(64)[None] < torch.tensor([[64], [21]])).int()
    o_cpu = tm.umt5_encode(tp, ids, mask, t5)
    o_gpu = tm.umt5_encode(to_device(tp, 'cuda'), ids.cuda(), mask.cuda(),
                           t5).cpu()
    rel = ((o_gpu - o_cpu).abs().mean() / o_cpu.abs().mean()).item()
    print(f'UMT5 small-input agreement (card vs CPU, float32): mean '
          f'relative difference {rel:.3e}', flush=True)
    if not rel <= 1e-4:
        fail(f'UMT5 small-input output differs between card and CPU: {rel}')


# ---------------------------------------------------------------- prompt to
# pixels: the FLUX encoders and the three decoders

# the FLUX prompt: 512 T5 ids, the first FLUX_T5_VALID valid (the rest pad
# id 0, masked out); 77 CLIP ids with the EOT id (49,407, the vocabulary's
# largest) at FLUX_CLIP_EOT_AT and EOT-valued padding after it, as CLIP's
# tokenizer pads for FLUX
FLUX_T5_LEN = 512
FLUX_T5_VALID = 93
FLUX_CLIP_EOT_AT = 24
DECODE_SETTING = ('convolutions in TF32 (torch.backends.cudnn.allow_tf32 '
                  '= True, PyTorch\'s default), matmuls in float32')


@contextlib.contextmanager
def default_tf32(torch):
    """The decode phases run PyTorch's default: cuDNN convolutions in TF32
    (the rest of the script turns TF32 off), float32 matmuls in float32."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def perturbed(torch, tree, gen):
    """A nest of tensors, each plus noise from ``gen`` (on the CPU) of a
    tenth of its mean magnitude (0.05 where it is all zeros): the
    initialisers zero every bias and Wan's attention projection, which
    would hide a fault on those paths."""
    if isinstance(tree, dict):
        return {k: perturbed(torch, v, gen) for k, v in tree.items()}
    if isinstance(tree, list):
        return [perturbed(torch, v, gen) for v in tree]
    mag = tree.float().abs().mean().item() or 0.5
    return (tree.float() + torch.randn(tree.shape, generator=gen)
            * 0.1 * mag).to(tree.dtype)


def synced(torch, fn):
    """(fn(), seconds), synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def draw_flux_encoders(torch, tm):
    """T5-v1.1-XXL (24 layers, dim 4096, 64 heads, FFN 10240, vocab
    32,128) and CLIP-L (12 layers, width 768) at full size in bf16,
    random weights from a seed drawn on the card, and the FLUX prompt's
    ids (FLUX_T5_VALID, FLUX_CLIP_EOT_AT) on the card: a function of no
    arguments per encoder (T5 -> txt; CLIP -> (hidden, pooled)), and the
    two weight trees (to release)."""
    t5cfg = tm.T5Config(dtype=torch.bfloat16)
    ccfg = tm.ClipTextConfig(dtype=torch.bfloat16)
    gen = torch.Generator('cuda')
    gen.manual_seed(SEED + 7)
    t5p = tm.init_t5_params(gen, t5cfg, 'cuda')
    clipp = tm.init_clip_params(gen, ccfg, 'cuda')
    for name, tree in (('T5-v1.1-XXL', t5p), ('CLIP-L', clipp)):
        leaves = tensors(tree)
        print(f'{name}: {sum(t.numel() for t in leaves) / 1e9:.3f}B '
              f'parameters, {sum(t.numel() * t.element_size() for t in leaves) / 1e9:.2f} '
              f'GB bf16', flush=True)
    mask = (torch.arange(FLUX_T5_LEN, device='cuda')[None]
            < FLUX_T5_VALID).long()
    ids = torch.randint(2, t5cfg.vocab_size, (1, FLUX_T5_LEN), generator=gen,
                        device='cuda') * mask
    eot = ccfg.vocab_size - 1
    cids = torch.randint(0, eot, (1, ccfg.ctx_len), generator=gen,
                         device='cuda')
    cids[:, FLUX_CLIP_EOT_AT:] = eot
    return ((lambda: tm.t5_encode(t5p, ids, mask, t5cfg)),
            (lambda: tm.clip_text_encode(clipp, cids, ccfg)), [t5p, clipp])


def flux_generation(torch, tm, kern, ck, model, want):
    """One FLUX.1-dev generation at 1280x768 from prompt ids on the card to
    pixels.  Before the span: the encoders (draw_flux_encoders), loop
    (a)'s bf16 weights, latent noise and keep seed, and the FLUX
    autoencoder at AutoEncoderParams() in float32 (random weights from a
    seed) drawn; each encoder and the decode called once (the decode on a
    random latent of the decode's shape, timed as its first call).  The
    span, synchronised at both ends and between stages: T5, CLIP, the
    encoders released (their weights dropped and the cache emptied),
    FluxSampler.denoise over ``ck`` (the shipped config) with their txt /
    vec, ``unpack`` and the decode (DECODE_SETTING).  The launch counts
    are set to 0 just before T5 and just before the loop and read after
    each: the encoders launch none of the port's kernels, the loop what
    loop (a) did (``want``), kernel by kernel.  Checks after the span:
    txt [1, 512, 4096] and vec [1, 768] bf16, the pooled row the first EOT
    row, finite latent and image, image [1, 3, 768, 1280].  Prints the
    span's wall time, each stage's, the first decode call's, the peak and
    the pixel range; returns the wall time."""
    torch.cuda.reset_peak_memory_stats()
    t5_fn, clip_fn, enc = draw_flux_encoders(torch, tm)
    gen = torch.Generator('cuda')
    gen.manual_seed(SEED)
    params = tm.init_flux_params(gen, model, 'cuda')
    img = torch.randn((1, H_IMG * W_IMG, model.in_channels), generator=gen,
                      device='cuda')
    sampler = tm.FluxSampler(
        cfg=model, ck=ck, sp=tm.FluxSparse.build(
            ck, model, model.txt_len + H_IMG * W_IMG),
        h_img=H_IMG, w_img=W_IMG)
    ts = tm.get_schedule(ck.steps, H_IMG * W_IMG)
    loop_gen = torch.Generator('cuda')
    loop_gen.manual_seed(SEED)
    acfg = tm.AutoEncoderParams()
    gen.manual_seed(SEED + 8)
    ae = tm.init_decoder_params(gen, acfg, torch.float32, 'cuda')
    t5_fn()
    clip_fn()
    with default_tf32(torch):
        _, cold_s = synced(torch, lambda: tm.decode(ae, torch.randn(
            (1, acfg.z_channels, 2 * H_IMG, 2 * W_IMG), generator=gen,
            device='cuda'), acfg))

    def release():
        enc.clear()
        torch.cuda.empty_cache()

    kern.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    txt, t5_s = synced(torch, t5_fn)
    (hid, vec), clip_s = synced(torch, clip_fn)
    enc_launches = {k: n for k, n in kern.LAUNCHES.items() if n}
    del t5_fn, clip_fn
    _, release_s = synced(torch, release)
    kern.reset_launches()
    lat, denoise_s = synced(torch, lambda: sampler.denoise(
        params, img, txt, vec, ts, generator=loop_gen))
    launches = dict(kern.LAUNCHES)
    with default_tf32(torch):
        pix, decode_s = synced(torch, lambda: tm.decode(
            ae, tm.unpack(lat.float(), 16 * H_IMG, 16 * W_IMG), acfg))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(json.dumps({'path': 'generation', 'launches': launches}),
          flush=True)
    for name, t, shape in (('T5', txt, (1, FLUX_T5_LEN, 4096)),
                           ('CLIP', vec, (1, 768))):
        if t.shape != shape or t.dtype != torch.bfloat16:
            fail(f'{name}: output {tuple(t.shape)} {t.dtype}')
        if not bool(torch.isfinite(t).all()):
            fail(f'{name}: non-finite values')
    if not torch.equal(vec, hid[:, FLUX_CLIP_EOT_AT]):
        fail('CLIP: the pooled row is not the first EOT row')
    if enc_launches:
        fail(f'the prompt encoders launched the port\'s kernels: '
             f'{enc_launches}')
    if launches != want:
        fail(f'generation: launches differ from loop (a)\'s '
             f'{ {k: n for k, n in want.items() if n} }')
    if not bool(torch.isfinite(lat).all()):
        fail('generation: non-finite values in the latent')
    if pix.shape != (1, 3, 16 * H_IMG, 16 * W_IMG):
        fail(f'generation: image {tuple(pix.shape)}')
    if not bool(torch.isfinite(pix).all()):
        fail('generation: non-finite pixels')
    print(f'generation 1280x768, prompt ids to pixels: wall time '
          f'{wall:.3f} s in one synchronised span (weights drawn and each '
          f'stage called once before it) = T5 {t5_s * 1e3:.1f} ms '
          f'({FLUX_T5_LEN} ids, {FLUX_T5_VALID} valid) + CLIP '
          f'{clip_s * 1e3:.1f} ms (77 ids, EOT at {FLUX_CLIP_EOT_AT}) + '
          f'encoders released {release_s * 1e3:.1f} ms + denoise '
          f'{denoise_s:.3f} s ({ck.steps} steps) + unpack and decode '
          f'{decode_s:.3f} s ({DECODE_SETTING}); the decode\'s first call '
          f'{cold_s:.3f} s, outside the span; launches of the port\'s '
          f'kernels in the encoders {enc_launches or "none"}; peak '
          f'{peak:.2f} GiB allocated; image {tuple(pix.shape)}, pixels in '
          f'[{pix.min().item():.4f}, {pix.max().item():.4f}]', flush=True)
    del params, sampler, ae, pix, lat, txt, vec, hid
    torch.cuda.empty_cache()
    return wall


def decode_run(torch, fn):
    """(fn(), seconds, peak GiB allocated above what was allocated before,
    peak GiB reserved) on the card."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, secs = synced(torch, fn)
    return (out, secs, (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
            torch.cuda.max_memory_reserved() / 2 ** 30)


def decode_video(torch, tag, lat, decode, n, prefix_closed):
    """A video decode on the card in float32 (DECODE_SETTING) of the first
    ``n`` latent frames of the loop's latent ``lat`` [1, 16, T, h, w]
    (``decode(z)`` -> pixels).  A prefix-closed decoder's decode of the
    first 3 latent frames must equal the first 9 frames of the longer
    decode (mean relative difference <= 2e-2); a decoder that is not
    prefix-closed decodes n < T frames to a shorter video.  Checks: finite
    and [1, 3, 4(n-1)+1, 8h, 8w].  Prints the frames, seconds and peaks."""
    T, h, w = lat.shape[2:]
    torch.cuda.empty_cache()
    free, total = (m / 2 ** 30 for m in torch.cuda.mem_get_info())
    with default_tf32(torch):
        if prefix_closed:
            pre, pre_s, _, _ = decode_run(torch, lambda: decode(lat[:, :, :3]))
        out, secs, peak, reserved = decode_run(torch,
                                               lambda: decode(lat[:, :, :n]))
    frames = 4 * (n - 1) + 1
    if out.shape != (1, 3, frames, 8 * h, 8 * w):
        fail(f'{tag} decode: output {tuple(out.shape)}')
    if not bool(torch.isfinite(out).all()):
        fail(f'{tag} decode: non-finite pixels')
    cut = ('the whole clip' if n == T else
           f'the first {n} of {T} latent frames (' +
           ('exact: the first frames of the whole clip, the decoder is '
            'prefix-closed)' if prefix_closed else
            'a cut: a shorter video, not a prefix of the whole one, since '
            'the group norms span the clip)'))
    msg = (f'{tag} decode: {cut}, {n} latent frames -> {frames} frames at '
           f'{8 * h}x{8 * w} in {secs:.3f} s; peak {peak:.2f} GiB allocated '
           f'above the latent, {reserved:.2f} GiB reserved ({free:.2f} GiB '
           f'free before, of {total:.2f} GiB); {DECODE_SETTING}; pixels in '
           f'[{out.min().item():.4f}, {out.max().item():.4f}]')
    if prefix_closed:
        rel = ((out[:, :, :9] - pre).abs().mean()
               / pre.abs().mean()).item()
        msg += (f'; the decode of the first 3 latent frames ({pre_s:.3f} s) '
                f'against the first 9 frames: mean relative difference '
                f'{rel:.3e}')
        if not rel <= 2e-2:
            fail(f'{tag} decode: the prefix decode differs from the first '
                 f'frames of the longer decode: {rel}')
        del pre
    print(msg, flush=True)
    del out
    torch.cuda.empty_cache()
    return secs


def decode_hunyuan(torch, tm, lat):
    """HunyuanVideo's causal-3D VAE decoder at HyVaeConfig(), random
    float32 weights from a seed, on the first HY_DECODE_N latent frames of
    the 540p loop's latent [1, 16, 33, 68, 120] (decode_video)."""
    cfg = tm.HyVaeConfig()
    gen = torch.Generator('cuda')
    gen.manual_seed(SEED + 9)
    params = tm.init_hunyuan_vae_decoder(gen, cfg, 'cuda')
    secs = decode_video(torch, 'hunyuan VAE', lat, lambda z:
                        tm.hunyuan_vae_decode(params, z, cfg), HY_DECODE_N,
                        False)
    del params
    torch.cuda.empty_cache()
    return secs


def decode_wan(torch, tm, lat):
    """The Wan2.1 VAE decoder at WanVaeConfig(), random float32 weights
    from a seed, on the whole of the 480x832x81 loop's latent [1, 16, 21,
    60, 104] (decode_video)."""
    cfg = tm.WanVaeConfig()
    gen = torch.Generator('cuda')
    gen.manual_seed(SEED + 10)
    params = tm.init_wan_vae_decoder(gen, cfg, 'cuda')
    secs = decode_video(torch, 'wan VAE', lat, lambda z:
                        tm.wan_vae_decode(params, z, cfg), lat.shape[2], True)
    del params
    torch.cuda.empty_cache()
    return secs


def agree_small_decoders(torch, tm):
    """The plain versions of this slice on the card against the CPU, on
    the same weights (drawn on the CPU from a seed, every leaf perturbed)
    and inputs: a 2-layer T5 (dim 256, 4 heads) with a partial mask and a
    2-layer CLIP (width 256) with EOT-valued padding, float32; the FLUX
    autoencoder at ch 32, ch_mult (1, 2) on a 16x16 latent, and the two
    video VAEs at the JAX tests' tiny configs on 4 latent frames, float32
    under DECODE_SETTING, and Wan's 2-frame decode on the card against
    the first 5 frames of its 4-frame decode.  Each mean relative
    difference within its tolerance, some ten to fifty times the
    readings on an H100: 1e-4 for the float32 encoders (2e-6 read), 5e-3
    for the TF32 decoders (7e-4 to 1.1e-3 read), 1e-3 for the prefix
    (9e-5 read; another cuDNN algorithm at the shorter length)."""
    gen = torch.Generator()
    gen.manual_seed(SEED + 11)

    def held(tag, ref, card, tol, what='card vs CPU'):
        rel = ((card.cpu() - ref.cpu()).abs().mean()
               / ref.cpu().abs().mean()).item()
        print(f'{tag} small-input agreement ({what}): mean relative '
              f'difference {rel:.3e} (tolerance {tol:.0e})', flush=True)
        if not rel <= tol:
            fail(f'{tag} small-input output differs ({what}): {rel}')

    def both(tree, fn, *args):
        """fn on the CPU and on the card, with ``tree`` (CPU) and
        ``args`` moved there."""
        return (fn(tree, *args),
                fn(to_device(tree, 'cuda'),
                   *(a.cuda() if hasattr(a, 'cuda') else a for a in args)))

    t5 = tm.T5Config(vocab_size=512, dim=256, d_kv=64, dim_ffn=512,
                     num_heads=4, num_layers=2)
    tp = perturbed(torch, tm.init_t5_params(gen, t5, 'cpu'), gen)
    ids = torch.randint(0, 512, (2, 64), generator=gen)
    mask = (torch.arange(64)[None] < torch.tensor([[64], [21]])).long()
    held('T5', *both(tp, lambda p, i, m: tm.t5_encode(p, i, m, t5), ids,
                     mask), 1e-4)
    clip = tm.ClipTextConfig(vocab_size=512, width=256, num_heads=4,
                             num_layers=2)
    cp = perturbed(torch, tm.init_clip_params(gen, clip, 'cpu'), gen)
    cids = torch.randint(0, 511, (2, 77), generator=gen)
    cids[0, 30:], cids[1, 9:] = 511, 511
    (h0, p0), (h1, p1) = both(cp, lambda p, i: tm.clip_text_encode(p, i,
                                                                   clip),
                              cids)
    held('CLIP hidden', h0, h1, 1e-4)
    held('CLIP pooled', p0, p1, 1e-4)
    with default_tf32(torch):
        acfg = tm.AutoEncoderParams(ch=32, ch_mult=(1, 2))
        ap = perturbed(torch, tm.init_decoder_params(gen, acfg, device='cpu'),
                       gen)
        z = torch.randn((1, 16, 16, 16), generator=gen)
        held('FLUX autoencoder', *both(ap, lambda p, x: tm.decode(p, x, acfg),
                                       z), 5e-3)
        hcfg = tm.HyVaeConfig(block_out_channels=(8, 8, 16, 16),
                              layers_per_block=1, latent_channels=4,
                              norm_groups=4)
        hp = perturbed(torch, tm.init_hunyuan_vae_decoder(gen, hcfg, 'cpu'),
                       gen)
        z = torch.randn((1, 4, 4, 8, 8), generator=gen)
        held('hunyuan VAE', *both(hp, lambda p, x: tm.hunyuan_vae_decode(
            p, x, hcfg), z), 5e-3)
        wcfg = tm.WanVaeConfig(dim=8, z_dim=4, num_res_blocks=1)
        wp = perturbed(torch, tm.init_wan_vae_decoder(gen, wcfg, 'cpu'), gen)
        cpu, card = both(wp, lambda p, x: tm.wan_vae_decode(p, x, wcfg), z)
        held('wan VAE', cpu, card, 5e-3)
        pre = tm.wan_vae_decode(to_device(wp, 'cuda'), z[:, :, :2].cuda(),
                                wcfg)
        held('wan VAE 2-frame prefix', card[:, :, :5], pre, 1e-3,
             'on the card, against the first 5 frames of the 4-frame '
             'decode')


# ------------------------------------------------- checkpoint to latents

def _lin_shapes(out, name, d_in, d_out):
    """A torch Linear's state-dict entries: weight [out, in] at scale
    d_in^-0.5, bias [out] at 0.02."""
    out[f'{name}.weight'] = ((d_out, d_in), d_in ** -0.5)
    out[f'{name}.bias'] = ((d_out,), 0.02)


def flux_bfl_shapes(cfg):
    """name -> (shape, scale) of a BFL FLUX state dict: the keys and shapes
    of ``synth_state_dict`` (tests/test_loaders.py) at ``cfg``, weights at
    fan-in^-0.5, biases at 0.02, norm scales ones (scale None)."""
    h, mh, hd = cfg.hidden_size, cfg.mlp_hidden, cfg.head_dim
    out = {}
    _lin_shapes(out, 'img_in', cfg.in_channels, h)
    _lin_shapes(out, 'txt_in', cfg.context_in_dim, h)
    for e in ('time_in', 'vector_in', 'guidance_in'):
        _lin_shapes(out, f'{e}.in_layer',
                    cfg.vec_in_dim if e == 'vector_in' else 256, h)
        _lin_shapes(out, f'{e}.out_layer', h, h)
    for i in range(cfg.depth):
        p = f'double_blocks.{i}'
        for s in ('img', 'txt'):
            _lin_shapes(out, f'{p}.{s}_mod.lin', h, 6 * h)
            _lin_shapes(out, f'{p}.{s}_attn.qkv', h, 3 * h)
            out[f'{p}.{s}_attn.norm.query_norm.scale'] = ((hd,), None)
            out[f'{p}.{s}_attn.norm.key_norm.scale'] = ((hd,), None)
            _lin_shapes(out, f'{p}.{s}_attn.proj', h, h)
            _lin_shapes(out, f'{p}.{s}_mlp.0', h, mh)
            _lin_shapes(out, f'{p}.{s}_mlp.2', mh, h)
    for i in range(cfg.depth_single_blocks):
        p = f'single_blocks.{i}'
        _lin_shapes(out, f'{p}.modulation.lin', h, 3 * h)
        _lin_shapes(out, f'{p}.linear1', h, 3 * h + mh)
        _lin_shapes(out, f'{p}.linear2', h + mh, h)
        out[f'{p}.norm.query_norm.scale'] = ((hd,), None)
        out[f'{p}.norm.key_norm.scale'] = ((hd,), None)
    _lin_shapes(out, 'final_layer.adaLN_modulation.1', h, 2 * h)
    _lin_shapes(out, 'final_layer.linear', h, cfg.in_channels)
    return out


def hunyuan_shapes(cfg):
    """The hyvideo transformer layout of ``synth_hunyuan_state_dict``
    (tests/test_loaders.py) at ``cfg``, scaled as flux_bfl_shapes."""
    core = cfg.core()
    h, mh, hd = core.hidden_size, core.mlp_hidden, core.head_dim
    pt, ph, pw = cfg.patch_size
    patch = cfg.in_channels * pt * ph * pw
    out = {'img_in.proj.weight': ((h, cfg.in_channels, pt, ph, pw),
                                  patch ** -0.5),
           'img_in.proj.bias': ((h,), 0.02)}
    _lin_shapes(out, 'txt_in.input_embedder', cfg.text_dim, h)
    _lin_shapes(out, 'txt_in.t_embedder.mlp.0', 256, h)
    _lin_shapes(out, 'txt_in.t_embedder.mlp.2', h, h)
    _lin_shapes(out, 'txt_in.c_embedder.linear_1', cfg.text_dim, h)
    _lin_shapes(out, 'txt_in.c_embedder.linear_2', h, h)
    for i in range(2):
        p = f'txt_in.individual_token_refiner.blocks.{i}'
        _lin_shapes(out, f'{p}.self_attn_qkv', h, 3 * h)
        _lin_shapes(out, f'{p}.self_attn_proj', h, h)
        _lin_shapes(out, f'{p}.mlp.fc1', h, 4 * h)
        _lin_shapes(out, f'{p}.mlp.fc2', 4 * h, h)
        _lin_shapes(out, f'{p}.adaLN_modulation.1', h, 2 * h)
        for n in ('norm1', 'norm2'):
            out[f'{p}.{n}.weight'] = ((h,), None)
            out[f'{p}.{n}.bias'] = ((h,), 0.02)
    _lin_shapes(out, 'time_in.mlp.0', 256, h)
    _lin_shapes(out, 'time_in.mlp.2', h, h)
    _lin_shapes(out, 'vector_in.in_layer', cfg.vec_in_dim, h)
    _lin_shapes(out, 'vector_in.out_layer', h, h)
    _lin_shapes(out, 'guidance_in.mlp.0', 256, h)
    _lin_shapes(out, 'guidance_in.mlp.2', h, h)
    for i in range(cfg.depth_double):
        p = f'double_blocks.{i}'
        for s in ('img', 'txt'):
            _lin_shapes(out, f'{p}.{s}_mod.linear', h, 6 * h)
            _lin_shapes(out, f'{p}.{s}_attn_qkv', h, 3 * h)
            out[f'{p}.{s}_attn_q_norm.weight'] = ((hd,), None)
            out[f'{p}.{s}_attn_k_norm.weight'] = ((hd,), None)
            _lin_shapes(out, f'{p}.{s}_attn_proj', h, h)
            _lin_shapes(out, f'{p}.{s}_mlp.fc1', h, mh)
            _lin_shapes(out, f'{p}.{s}_mlp.fc2', mh, h)
    for i in range(cfg.depth_single):
        p = f'single_blocks.{i}'
        _lin_shapes(out, f'{p}.modulation.linear', h, 3 * h)
        _lin_shapes(out, f'{p}.linear1', h, 3 * h + mh)
        _lin_shapes(out, f'{p}.linear2', h + mh, h)
        out[f'{p}.q_norm.weight'] = ((hd,), None)
        out[f'{p}.k_norm.weight'] = ((hd,), None)
    _lin_shapes(out, 'final_layer.adaLN_modulation.1', h, 2 * h)
    _lin_shapes(out, 'final_layer.linear', h, patch)
    return out


def wan_shapes(cfg):
    """The wan/modules/model.py layout of ``synth_wan_state_dict``
    (tests/test_loaders.py) at ``cfg``, scaled as flux_bfl_shapes."""
    d, f = cfg.dim, cfg.ffn_dim
    pt, ph, pw = cfg.patch_size
    patch = cfg.in_channels * pt * ph * pw
    out = {'patch_embedding.weight': ((d, cfg.in_channels, pt, ph, pw),
                                      patch ** -0.5),
           'patch_embedding.bias': ((d,), 0.02)}
    _lin_shapes(out, 'text_embedding.0', cfg.text_dim, d)
    _lin_shapes(out, 'text_embedding.2', d, d)
    _lin_shapes(out, 'time_embedding.0', cfg.freq_dim, d)
    _lin_shapes(out, 'time_embedding.2', d, d)
    _lin_shapes(out, 'time_projection.1', d, 6 * d)
    for i in range(cfg.num_layers):
        p = f'blocks.{i}'
        out[f'{p}.modulation'] = ((1, 6, d), 0.02)
        for a in ('self_attn', 'cross_attn'):
            for n in ('q', 'k', 'v', 'o'):
                _lin_shapes(out, f'{p}.{a}.{n}', d, d)
            out[f'{p}.{a}.norm_q.weight'] = ((d,), None)
            out[f'{p}.{a}.norm_k.weight'] = ((d,), None)
        out[f'{p}.norm3.weight'] = ((d,), None)
        out[f'{p}.norm3.bias'] = ((d,), 0.02)
        _lin_shapes(out, f'{p}.ffn.0', d, f)
        _lin_shapes(out, f'{p}.ffn.2', f, d)
    out['head.modulation'] = ((1, 2, d), 0.02)
    _lin_shapes(out, 'head.head', d, patch)
    return out


class SeededStateDict(collections.abc.Mapping):
    """A lazy state dict: each value drawn when read, from its own
    generator seeded by (seed, the key's position), on ``device``, normal
    times its scale (ones where the scale is None), in ``dtype``; the
    same key gives the same tensor on every read.  Membership draws
    nothing."""

    def __init__(self, torch, shapes, seed, device='cuda', dtype=None):
        self.torch, self.shapes, self.device = torch, shapes, device
        self.dtype = dtype or torch.bfloat16
        self.index = {k: i for i, k in enumerate(shapes)}
        self.seed = seed

    def __getitem__(self, key):
        torch = self.torch
        shape, scale = self.shapes[key]
        if scale is None:
            return torch.ones(shape, dtype=self.dtype, device=self.device)
        g = torch.Generator(self.device).manual_seed(
            self.seed * 1_000_003 + self.index[key])
        return (torch.randn(shape, generator=g, device=self.device)
                * scale).to(self.dtype)

    def __contains__(self, key):
        return key in self.shapes

    def __iter__(self):
        return iter(self.shapes)

    def __len__(self):
        return len(self.shapes)


def flux_launches(ck, model, mlp_kernels):
    """Every kernel's launches in one host loop of FluxSampler.denoise over
    the plan of ``ck`` at ``model``'s depth, counted from the modules'
    rules: a dense layer (first_n_dense_layers) runs ``dense_attn`` on
    every computed step; a sparse one runs ``dense_attn`` on step 0,
    ``dense_colsum_attn`` + ``csp_attn`` on a colsum step, ``dense_attn``
    + ``csp_attn`` on another full step and ``csp_attn`` on a sparse step;
    a sparse MLP layer runs each of ``mlp_kernels`` once on each step that
    is not an MLP full step.  FLUX has no static mask, so no dense tail."""
    from chipmunk_torch.schedule import step_plan
    depth, single = model.depth, model.depth_single_blocks

    def sparse_layers(n_dense):
        return (depth - min(n_dense, depth)
                + single - max(0, min(n_dense - depth, single)))

    la = sparse_layers(ck.attn.first_n_dense_layers)
    lm = sparse_layers(ck.mlp.first_n_dense_layers) \
        if ck.mlp.is_enabled else 0
    n = {'dense_attn': 0, 'dense_colsum_attn': 0, 'csp_attn': 0}
    n.update({k: 0 for k in mlp_kernels})
    for i, kind in enumerate(step_plan(ck)):
        if kind.skip and i > 0:
            continue
        n['dense_attn'] += depth + single - la
        if kind.full_attn and i == 0:
            n['dense_attn'] += la
        elif kind.full_attn:
            n['dense_colsum_attn' if kind.colsum else 'dense_attn'] += la
            n['csp_attn'] += la
        else:
            n['csp_attn'] += la
        if not kind.full_mlp:
            for k in mlp_kernels:
                n[k] += lm
    return n


def check_launches(tag, launches, want):
    """Exact counts: each kernel of ``want`` as often as it says, every
    other kernel never."""
    bad = {k: (v, want.get(k, 0)) for k, v in launches.items()
           if v != want.get(k, 0)}
    if bad:
        fail(f'{tag}: launches (got, want) {bad}')


def same_tree(torch, tag, got, want, path=''):
    """Leaf for leaf torch.equal (QTensors by q, scale and pack_axis),
    ``got`` moved to the host."""
    if isinstance(want, dict):
        if sorted(got) != sorted(want):
            fail(f'{tag}{path}: keys {sorted(got)} against {sorted(want)}')
        for k in want:
            same_tree(torch, tag, got[k], want[k], f'{path}/{k}')
    elif hasattr(want, 'q'):
        if got.pack_axis != want.pack_axis:
            fail(f'{tag}{path}: pack_axis {got.pack_axis} against '
                 f'{want.pack_axis}')
        same_tree(torch, tag, got.q, want.q, path + '.q')
        same_tree(torch, tag, got.scale, want.scale, path + '.scale')
    else:
        g = got.cpu()
        if g.dtype != want.dtype or not torch.equal(g, want):
            fail(f'{tag}{path}: differs from the loader on the CPU '
                 f'({g.dtype} against {want.dtype})')


def flux_from_checkpoint(torch, tm, kern, ck):
    """(a) FLUX.1-dev at full width and depth from a checkpoint: the BFL
    state dict drawn on the card one tensor at a time (SeededStateDict,
    bf16 as checkpoints store it), loaded by ``load_flux_params`` with
    the config as read and ``mlp.is_fp8`` set (int8 sparse-MLP weights,
    fp8 text-MLP weights, quantized on the card); its first double and
    single block torch.equal to the same loader on the CPU over the same
    tensors; then the 50-step host loop through the FLUX twin's
    ``generate``, with exact launch counts (``flux_launches``: the a8 pair
    on every sparse MLP step, no bf16 or wq MLP kernel)."""
    from chipmunk_torch.cli import flux_generate
    from chipmunk_torch.models import loaders
    from chipmunk_torch.utils import quant
    ck8 = ck.replace(mlp=dataclasses.replace(ck.mlp, is_fp8=True))
    model = tm.FluxModelConfig()
    sd = SeededStateDict(torch, flux_bfl_shapes(model), SEED, 'cuda')
    params, load_s = synced(torch, lambda: loaders.load_flux_params(
        sd, model, ck=ck8, device='cuda'))
    gib = quant.param_bytes(params) / 2 ** 30
    blk = params['double'][0]
    kinds = (blk['img_w1t'].q.dtype, blk['txt_w1t'].q.dtype,
             params['single'][0]['w2'].q.dtype, blk['img_qkv']['w'].dtype)
    if kinds != (torch.int8, torch.float8_e4m3fn, torch.int8,
                 torch.bfloat16):
        fail(f'checkpoint: is_fp8 storage {kinds}')
    first = dataclasses.replace(model, depth=1, depth_single_blocks=1)
    host = {k: sd[k].cpu() for k in flux_bfl_shapes(first)}
    t0 = time.perf_counter()
    cpu = loaders.load_flux_params(host, first, ck=ck8, device='cpu')
    cpu_s = time.perf_counter() - t0
    for part in ('double', 'single'):
        same_tree(torch, f'checkpoint {part} block 0', params[part][0],
                  cpu[part][0])
    del host, cpu
    print(f'checkpoint: FLUX.1-dev state dict ({len(sd)} tensors, bf16, '
          f'drawn on the card) loaded with mlp.is_fp8 in {load_s:.3f} s: '
          f'{gib:.2f} GiB of weights resident (int8 sparse MLP, fp8 text '
          f'MLP, the rest bf16); first double and single block equal to '
          f'the loader on the CPU ({cpu_s:.1f} s there)', flush=True)
    kern.reset_launches()
    out, loop_s = synced(torch, lambda: flux_generate.generate(
        params, model, ck8, width=W_IMG * 16, height=H_IMG * 16, seed=SEED,
        device='cuda'))
    launches = dict(kern.LAUNCHES)
    check_launches('checkpoint is_fp8 loop', launches, flux_launches(
        ck8, model, ('quant_rows', 'csp_mlp_mm1_a8', 'csp_mlp_mm2_a8')))
    if out.shape != (1, H_IMG * W_IMG, 64) or not bool(
            torch.isfinite(out).all()):
        fail(f'checkpoint is_fp8 loop: output {tuple(out.shape)}, finite '
             f'{bool(torch.isfinite(out).all())}')
    print(f'checkpoint is_fp8 loop: {ck8.steps} steps, depth {model.depth}+'
          f'{model.depth_single_blocks}, {loop_s:.3f} s through '
          f'cli.flux_generate.generate; launches {json.dumps(launches)}',
          flush=True)
    del params, out
    torch.cuda.empty_cache()
    return launches, loop_s


def f8_input_matmul_phase(torch):
    """(b) ``mlp_fp8.f8_input_matmul`` on the card (``torch._scaled_mm``
    on the fp8 operands) against its plain version (both operands upcast
    to float32, ``torch.matmul``, TF32 off) on the same inputs at the
    FLUX dense-step shape: x [4608, 3072] bf16, w1t an fp8 QTensor
    [12288, 3072] with per-row scales.  The products are exact on both
    sides, but Hopper's fp8 tensor cores sum them in less than float32
    precision (on an H100 80GB HBM3, 700 W: 0.9% of the outputs 2 bf16
    ulps away, the largest error 3.1e-2 at outputs of RMS ~1); tolerance:
    one e4m3 ulp at the larger of the plain value and the outputs' RMS
    (fp8_ulp), the precision the fp8 operands carry.  Times it against
    ``torch.matmul`` on the dequantized bf16 weight.  Not a port of a
    Pallas kernel: a line of its own, no row in the kernels JSON."""
    from chipmunk_torch.modules import mlp_fp8
    from chipmunk_torch.utils.quant import dequant, quantize
    gen = torch.Generator('cuda').manual_seed(SEED)
    x = torch.randn((T_SINGLE, C), generator=gen, device='cuda').to(
        torch.bfloat16)
    wq = quantize(torch.randn((N, C), generator=gen, device='cuda')
                  * C ** -0.5, 'fp8', keep_axes=(0,))
    b1 = (torch.randn((N,), generator=gen, device='cuda') * 0.02).to(
        torch.bfloat16)
    got = mlp_fp8.f8_input_matmul(x, wq, b1)
    x8, sx = mlp_fp8.quantize_input(x, None)
    plain = ((x8.float() @ wq.q.float().t()) * (sx * wq.scale.reshape(1, -1))
             + b1.float()).to(torch.bfloat16)
    if got.shape != (T_SINGLE, N) or got.dtype != torch.bfloat16:
        fail(f'f8_input_matmul: {tuple(got.shape)} {got.dtype}')
    g, r = got.float(), plain.float()
    rms = r.pow(2).mean().sqrt()
    diff = (g - r).abs()
    err = diff.max().item()
    bad = diff > fp8_ulp(torch, torch.maximum(r.abs(), rms))
    if not bool(torch.isfinite(g).all()) or bool(bad.any()):
        fail(f'f8_input_matmul: {int(bad.sum())} outputs beyond one e4m3 '
             f'ulp of the plain version (max abs err {err:.3e})')
    past = (diff > fp8_ulp(torch, r, torch.bfloat16)).float().mean().item()
    w_bf16 = dequant(wq, torch.bfloat16)
    ms = time_ms(torch, lambda: mlp_fp8.f8_input_matmul(x, wq, b1), 20)
    plain_ms = time_ms(torch, lambda: (x8.float() @ wq.q.float().t()), 5)
    lib_ms = time_ms(torch, lambda: x @ w_bf16.t(), 20)
    flops = 2 * T_SINGLE * C * N
    print(f'f8_input_matmul [{T_SINGLE}, {C}] x fp8 [{N}, {C}]: {ms:.4f} ms '
          f'({flops / ms / 1e9:.0f} TFLOP/s, with the input quantization '
          f'and scaling), plain version {plain_ms:.4f} ms, torch.matmul on '
          f'the dequantized bf16 weight {lib_ms:.4f} ms; max abs err '
          f'{err:.3e} at output RMS {rms.item():.3f}, {past:.2%} of the '
          f'outputs beyond one bf16 ulp (tolerance: one e4m3 ulp at '
          f'max(|plain|, RMS))', flush=True)


def write_tiny_video_encoders(torch, tm, d):
    """Local encoder directories for the HunyuanVideo twin's --llm and
    --clip, at the widths the model reads (text 4096, pooled 768): a
    LLaMA of 3 layers (the skip-2 selection runs one), 32 heads over 1
    key/value head, SwiGLU 64, vocab 512, theta 500,000, bf16, its names
    under ``model.`` with an lm_head; a 1-layer CLIP text tower of width
    768, vocab 512 (the EOT 511 also the pad).  config.json and one
    safetensors file each, written by ``save_file``; weights from a
    seed."""
    from chipmunk_torch.utils.safetensors_io import save_file
    gen = torch.Generator()
    gen.manual_seed(SEED + 9)
    lcfg = tm.LlamaConfig(vocab_size=512, num_hidden_layers=3,
                          num_key_value_heads=1, intermediate_size=64)
    p = tm.init_llama_params(gen, lcfg, 'cpu')
    sd = {'model.embed_tokens.weight': p['embed'],
          'model.norm.weight': p['norm'], 'lm_head.weight': p['embed']}
    names = {'q': 'self_attn.q_proj', 'k': 'self_attn.k_proj',
             'v': 'self_attn.v_proj', 'o': 'self_attn.o_proj',
             'gate': 'mlp.gate_proj', 'up': 'mlp.up_proj',
             'down': 'mlp.down_proj'}
    for i, lp in enumerate(p['layers']):
        pre = f'model.layers.{i}.'
        sd[pre + 'input_layernorm.weight'] = lp['ln1']
        sd[pre + 'post_attention_layernorm.weight'] = lp['ln2']
        for n, hf in names.items():
            sd[f'{pre}{hf}.weight'] = lp[n].t()
    llm = os.path.join(d, 'llm')
    os.makedirs(llm)
    save_file({k: v.to(torch.bfloat16) for k, v in sd.items()},
              os.path.join(llm, 'model.safetensors'))
    with open(os.path.join(llm, 'config.json'), 'w') as f:
        json.dump({'model_type': 'llama', 'hidden_act': 'silu',
                   'vocab_size': 512, 'hidden_size': 4096,
                   'num_hidden_layers': 3, 'num_attention_heads': 32,
                   'num_key_value_heads': 1, 'intermediate_size': 64,
                   'rms_norm_eps': 1e-5, 'rope_theta': 500000.0}, f)
    ccfg = tm.ClipTextConfig(vocab_size=512, num_layers=1, eos_token_id=511)
    c = tm.init_clip_params(gen, ccfg, 'cpu')
    sd = {'text_model.embeddings.token_embedding.weight':
          c['token_embedding'],
          'text_model.embeddings.position_embedding.weight':
          c['pos_embedding'],
          'text_model.final_layer_norm.weight': c['lnf_w'],
          'text_model.final_layer_norm.bias': c['lnf_b']}
    for i, b in enumerate(c['blocks']):
        pre = f'text_model.encoder.layers.{i}.'
        for n, src in (('q', 'self_attn.q_proj'), ('k', 'self_attn.k_proj'),
                       ('v', 'self_attn.v_proj'),
                       ('o', 'self_attn.out_proj'), ('fc1', 'mlp.fc1'),
                       ('fc2', 'mlp.fc2')):
            sd[f'{pre}{src}.weight'] = b[n].t()
            sd[f'{pre}{src}.bias'] = b[n + '_b']
        for n in ('1', '2'):
            sd[f'{pre}layer_norm{n}.weight'] = b[f'ln{n}_w']
            sd[f'{pre}layer_norm{n}.bias'] = b[f'ln{n}_b']
    clip = os.path.join(d, 'clip')
    os.makedirs(clip)
    save_file(sd, os.path.join(clip, 'model.safetensors'))
    with open(os.path.join(clip, 'config.json'), 'w') as f:
        json.dump({'model_type': 'clip_text_model', 'vocab_size': 512,
                   'hidden_size': 768, 'num_attention_heads': 12,
                   'num_hidden_layers': 1, 'max_position_embeddings': 77,
                   'hidden_act': 'quick_gelu', 'layer_norm_eps': 1e-5,
                   'eos_token_id': 511}, f)
    return llm, clip


# a twin run with the stand-in tokenizers in place of transformers'
# (video_encoders.load_tokenizer), as a user without the package would
# hand the holders their own
PROMPT_DRIVER = (
    'import sys; sys.path.insert(0, {root!r}); import chip_smoke; '
    'import chipmunk_torch.models.video_encoders as ve; '
    've.load_tokenizer = chip_smoke.local_tokenizer; '
    'from chipmunk_torch.cli.hunyuan_generate import main; '
    'sys.exit(main(sys.argv[1:]))')


def run_twins(torch, tm):
    """(c) the three twins as a user runs them, each as ``python -m
    chipmunk_torch.cli.<name> --ckpt <file>`` from .safetensors files
    written by ``safetensors_io.save_file`` (state dicts drawn as in (a)):
    FLUX.1-dev at full width, depth 1 + 1, 4 steps, configs/flux-chipmunk.yml;
    HunyuanVideo (configs/hunyuan-chipmunk.yml: the streamed runner) and
    Wan (configs/wan-chipmunk.yml) at --tiny, 4 steps, 128x128, 5 frames.
    Beside them: the same HunyuanVideo run with --prompt HY_PROMPT and
    --llm / --clip, tiny local encoders in a temporary directory
    (``write_tiny_video_encoders``; the stand-in tokenizers replace
    transformers', which the card's machine lacks); and the FLUX twin at
    --tiny with --profile in a temporary working directory.  The five run
    at once; each must exit 0, say what it loaded, and write finite
    latents of their shape; the prompt's latents must differ from the
    zero-text run's, and the profiled run must leave a trace under
    ./profiles that names the port's attention kernel."""
    import numpy as np
    from chipmunk_torch.utils.safetensors_io import save_file
    d = os.path.join(ROOT, 'build', 'smoke_cli')
    os.makedirs(d, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix='chip_smoke_twins_')
    video = ['--tiny', '--steps', '4', '--seed', '1']
    hcfg = tm.HunyuanModelConfig(latent_t=2, latent_h=16, latent_w=16,
                                 depth_double=1, depth_single=2,
                                 hidden_size=256, num_heads=2, txt_len=32)
    wcfg = tm.WanModelConfig(latent_t=2, latent_h=16, latent_w=16,
                             num_layers=2, dim=256, num_heads=2,
                             ffn_dim=1024, txt_len=32)
    hy_args = video + ['--depth', '1', '--depth-single', '2',
                       '--video-size', '128', '128', '--video-length', '5']
    runs = {
        'flux_generate': (flux_bfl_shapes(tm.FluxModelConfig(
            depth=1, depth_single_blocks=1)), (1, H_IMG * W_IMG, 64),
            ['--depth', '1', '--depth-single', '1', '--steps', '4'],
            'flux-chipmunk.yml', 'loaded'),
        'hunyuan_generate': (hunyuan_shapes(hcfg), (1, 16, 2, 16, 16),
                             hy_args, 'hunyuan-chipmunk.yml', 'streamed'),
        'wan_generate': (wan_shapes(wcfg), (1, 16, 2, 16, 16),
                         video + ['--layers', '2', '--size', '128', '128',
                                  '--frames', '5'], 'wan-chipmunk.yml',
                         'done'),
    }
    procs = {}
    t0 = time.perf_counter()

    def start(name, cmd, out, size, cwd=ROOT):
        if os.path.exists(out):
            os.remove(out)
        procs[name] = (subprocess.Popen(
            cmd, cwd=cwd, env=dict(os.environ, PYTHONPATH=ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), out,
            size)

    for i, (name, (shapes, _, args, cfg, _)) in enumerate(runs.items()):
        sd = SeededStateDict(torch, shapes, SEED + 1 + i, 'cuda')
        ckpt = os.path.join(d, f'{name}.safetensors')
        save_file({k: sd[k] for k in sd}, ckpt)
        start(name, [sys.executable, '-m', f'chipmunk_torch.cli.{name}',
                     '--ckpt', ckpt, '--chipmunk-config',
                     os.path.join(ROOT, 'configs', cfg), '--out',
                     os.path.join(d, f'{name}.npy'), *args],
              os.path.join(d, f'{name}.npy'), os.path.getsize(ckpt))
    llm, clip = write_tiny_video_encoders(torch, tm, tmp)
    hy_ckpt = os.path.join(d, 'hunyuan_generate.safetensors')
    start('hunyuan_generate --prompt',
          [sys.executable, '-c', PROMPT_DRIVER.format(root=ROOT), '--ckpt',
           hy_ckpt, '--chipmunk-config',
           os.path.join(ROOT, 'configs', 'hunyuan-chipmunk.yml'), '--out',
           os.path.join(d, 'hunyuan_prompt.npy'), *hy_args, '--llm', llm,
           '--clip', clip, '--prompt', HY_PROMPT],
          os.path.join(d, 'hunyuan_prompt.npy'), os.path.getsize(hy_ckpt))
    prof_dir = os.path.join(tmp, 'profiled')
    os.makedirs(prof_dir)
    start('flux_generate --profile',
          [sys.executable, '-m', 'chipmunk_torch.cli.flux_generate',
           '--tiny', '--depth', '1', '--depth-single', '1', '--steps', '4',
           '--width', '256', '--height', '256', '--profile', '--out',
           'flux_tiny.npy'], os.path.join(prof_dir, 'flux_tiny.npy'), 0,
          cwd=prof_dir)
    runs['hunyuan_generate --prompt'] = (None, (1, 16, 2, 16, 16), None,
                                         None, 'streamed')
    runs['flux_generate --profile'] = (None, (1, 256, 64), None, None,
                                       'profile trace')
    torch.cuda.empty_cache()
    lats = {}
    for name, (p, out, size) in procs.items():
        try:
            so, se = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q, _, _ in procs.values():
                q.kill()
            fail(f'cli {name}: no exit within 600 s')
        shape, word = runs[name][1], runs[name][4]
        if p.returncode != 0 or word not in so or 'zero embeddings' in se:
            fail(f'cli {name}: exit {p.returncode}; stdout {so[-1500:]!r}; '
                 f'stderr {se[-1500:]!r}')
        lat = lats[name] = np.load(out)
        if lat.shape != shape or lat.dtype != np.float32 or not bool(
                np.isfinite(lat).all()):
            fail(f'cli {name}: latents {lat.shape} {lat.dtype}, finite '
                 f'{bool(np.isfinite(lat).all())}')
        src = (f'a {size / 2 ** 30:.2f} GiB checkpoint' if size
               else 'random weights')
        print(f'cli {name}: exit 0 from {src}, latents {lat.shape} finite; '
              f'its output: {" | ".join(so.strip().splitlines())}',
              flush=True)
    if np.array_equal(lats['hunyuan_generate'],
                      lats['hunyuan_generate --prompt']):
        fail('cli hunyuan_generate --prompt: the latents equal the '
             'zero-text run\'s')
    traces = [f for f in os.listdir(os.path.join(prof_dir, 'profiles'))
              if f.endswith('.json')]
    if len(traces) != 1:
        fail(f'cli flux_generate --profile: traces {traces}')
    with open(os.path.join(prof_dir, 'profiles', traces[0])) as f:
        events = json.load(f)['traceEvents']
    ours = sorted({e['name'][:60] for e in events
                   if e.get('cat') == 'kernel'
                   and 'attn_sm90_kernel' in e.get('name', '')})
    print(f'cli flux_generate --profile: trace {traces[0]}, '
          f'{len(events)} events, {len(ours)} of the port\'s attention '
          f'kernels by name: {ours[:2]}', flush=True)
    if not ours:
        fail('cli flux_generate --profile: the trace names none of the '
             'port\'s kernels')
    shutil.rmtree(tmp)
    print(f'cli: five twin runs in {time.perf_counter() - t0:.1f} s '
          f'(run at once)', flush=True)


@contextlib.contextmanager
def recorded_predictions(preds):
    """Within: every ``flux_forward`` call of the FLUX sampler appends a
    copy of its prediction to ``preds``."""
    smod = importlib.import_module('chipmunk_torch.models.sampling')
    forward = smod.flux_forward

    def recording(*args, **kwargs):
        pred, state = forward(*args, **kwargs)
        preds.append(pred.clone())
        return pred, state

    smod.flux_forward = recording
    try:
        yield preds
    finally:
        smod.flux_forward = forward


def timed(torch, fn):
    """(fn(), seconds), synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def parallel_phase(torch, tm, kern, ck, vck, smi):
    """Multi-card sampling on a world of one NCCL rank (point 8 of the
    module docstring).  The sharded runs must equal the unsharded ones
    bit for bit, launch for launch."""
    import torch.distributed as dist
    from chipmunk_torch import parallel
    from chipmunk_torch.kernels.flash_attention import dense_attn_plain
    from chipmunk_torch.models.step_graphs import GRAPH_STATS
    from chipmunk_torch.parallel.ring import ring_hops
    torch.cuda.reset_peak_memory_stats()
    parallel.initialize_multihost(device='cuda')
    if dist.get_backend() != 'nccl' or dist.get_world_size() != 1:
        fail(f'parallel: a world of {dist.get_world_size()} '
             f'{dist.get_backend()} ranks, not one NCCL rank')

    # FLUX.1-dev, full width and depth, 4 steps of the shipped config
    ck4 = ck.replace(steps=4)
    model = tm.FluxModelConfig()
    gen = torch.Generator('cuda')
    gen.manual_seed(SEED)
    params = tm.init_flux_params(gen, model, 'cuda')
    img, txt, y = (torch.randn(shape, generator=gen, device='cuda')
                   for shape in ((1, H_IMG * W_IMG, model.in_channels),
                                 (1, model.txt_len, model.context_in_dim),
                                 (1, model.vec_in_dim)))
    ts = tm.get_schedule(4, H_IMG * W_IMG)
    base = tm.FluxSampler(cfg=model, ck=ck4, sp=tm.FluxSparse.build(
        ck4, model, model.txt_len + H_IMG * W_IMG), h_img=H_IMG,
        w_img=W_IMG)
    want_launches = flux_launches(ck4, model, ('csp_mlp_mm1', 'csp_mlp_mm2'))
    runs = {}
    for tag, sampler in (
            ('resident', base),
            ('sharded', base.sharded(parallel.make_mesh({'sp': 1}))),
            ('sharded fsdp', base.sharded(parallel.make_mesh({'sp': 1}),
                                          fsdp=True))):
        loop_gen = torch.Generator('cuda')
        loop_gen.manual_seed(SEED)
        kern.reset_launches()
        with recorded_predictions([]) as preds:
            out, secs = timed(torch, lambda: sampler.denoise(
                params, img, txt, y, ts, generator=loop_gen))
        launches = dict(kern.LAUNCHES)
        check_launches(f'parallel FLUX {tag}', launches, want_launches)
        runs[tag] = (preds, out, secs)
        if tag != 'resident':
            ref_preds, ref_out, ref_s = runs['resident']
            same = [bool(torch.equal(a, b))
                    for a, b in zip(preds, ref_preds)]
            if len(preds) != 4 or not all(same) \
                    or not torch.equal(out, ref_out):
                fail(f'parallel FLUX {tag}: predictions equal to the '
                     f'unsharded sampler\'s step by step: {same}')
            print(f'parallel FLUX {tag} (sp=1, 1280x768, depth '
                  f'{model.depth}+{model.depth_single_blocks}, 4 steps): '
                  f'{secs:.3f} s, unsharded {ref_s:.3f} s; 4 predictions '
                  f'and the latent torch.equal, launches equal '
                  f'({ {k: n for k, n in launches.items() if n} })',
                  flush=True)
    del params, runs, preds, out
    torch.cuda.empty_cache()

    # HunyuanVideo 540p, depth 1+2, host and compiled loops, 4 steps
    cfg = tm.HunyuanModelConfig(**V540, **V_DEPTH)
    gen.manual_seed(SEED)
    vparams = tm.init_hunyuan_params(gen, cfg, 'cuda')
    inputs = video_inputs(torch, cfg, 'cuda')
    vmodel = tm.HunyuanModel(cfg=cfg, ck=vck)
    vsharded = vmodel.sharded(parallel.make_mesh({'dp': 1, 'sp': 1}),
                              dp='dp')
    want = plan_launches(vmodel, steps=4)
    for compiled in (False, True):
        outs = {}
        for tag, m in (('resident', vmodel), ('sharded', vsharded)):
            torch.cuda.empty_cache()     # a graph pool takes no cached
            kern.reset_launches()       # block of the default pool
            outs[tag] = run_video(torch, tm, m, vparams, inputs, steps=4,
                                  compiled=compiled)
            check_launches(f'parallel video {tag}', dict(kern.LAUNCHES),
                           want)
        loop = 'compiled' if compiled else 'host'
        if not torch.equal(outs['sharded'][0], outs['resident'][0]):
            fail(f'parallel video {loop} loop: the sharded latent differs '
                 f'from the unsharded one')
        graphs = ''
        if compiled:
            st = dict(GRAPH_STATS)     # the sharded loop's, the last run
            if not st['replays']:
                fail('parallel video compiled loop: no graph replayed, so '
                     'no collective was captured')
            graphs = (f'; {st["graphs"]} graph(s) captured with their '
                      f'collectives, {st["replays"]} replay(s)')
        print(f'parallel video {loop} loop (dp=1 x sp=1, 540p, depth '
              f'{cfg.depth_double}+{cfg.depth_single}, 4 steps): '
              f'{outs["sharded"][1]:.3f} s, unsharded '
              f'{outs["resident"][1]:.3f} s; latent torch.equal, launches '
              f'the plan\'s ({ {k: n for k, n in want.items() if n} })'
              f'{graphs}', flush=True)
    del vparams, outs, inputs
    torch.cuda.empty_cache()

    # the ring's merge through dense_attn, in one process over key chunks
    gen.manual_seed(SEED + 9)
    q, k, v = (torch.randn((1, 24, 4352, D), generator=gen, device='cuda'
                           ).to(torch.bfloat16) for _ in range(3))
    chunks = [(k[:, :, i * 1088:(i + 1) * 1088],
               v[:, :, i * 1088:(i + 1) * 1088]) for i in range(4)]
    o, lse = ring_hops(q, chunks)
    o_p, lse_p = dense_attn_plain(q, k, v)
    err = check_close('ring merge o', o, o_p, 4e-3, 2 ** -6)
    check_close('ring merge lse', lse, lse_p, 1e-3, 0.0)
    o1 = kern.dense_attn(q, k, v)[0]
    for tag, got in (
            ('ring_attention', parallel.ring_attention(
                parallel.make_mesh({'sp': 1}), 'sp', q, k, v)),
            ('usp_attention', parallel.usp_attention(
                parallel.make_mesh({'sp': 1, 'ring': 1}), 'sp', 'ring', q,
                k, v))):
        if not torch.equal(got, o1):
            fail(f'parallel: {tag} at world 1 differs from dense_attn')
    merge_ms = time_ms(torch, lambda: ring_hops(q, chunks), 10)
    one_ms = time_ms(torch, lambda: kern.dense_attn(q, k, v), 10)
    print(f'parallel ring merge (4 key chunks of 1088, [1, 24, 4352, 128] '
          f'bf16): max abs err {err:.3e} against dense_attn_plain; '
          f'{merge_ms:.3f} ms, one dense_attn over all keys {one_ms:.3f} '
          f'ms; ring_attention and usp_attention at world 1 equal to '
          f'dense_attn', flush=True)
    print(f'parallel phase: peak '
          f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB '
          f'allocated; {smi}', flush=True)
    dist.destroy_process_group()
    del q, k, v, o, o_p, o1, chunks
    torch.cuda.empty_cache()


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

    def stamp(label):
        print(f'time: {label} done {time.perf_counter() - T_START:.1f} s '
              f'after the process started', flush=True)

    mods = tuple(importlib.import_module(f'chipmunk_torch.kernels.{m}')
                 for m in ('flash_attention', 'csp_attention', 'csp_mlp'))
    rows = kernel_phases(torch, mods + (fp8,))
    torch.cuda.empty_cache()
    qrows = []
    for kind in ('int8', 'int4'):
        qrows += quant_kernel_phases(torch, mods[2], mods[1], fp8, quant,
                                     kind)
        torch.cuda.empty_cache()
    bf16_cache_phases(torch, mods[2], mods[1], fp8, quant)
    a8_wide_blocks(torch, mods[2], mods[1], fp8, quant)
    small_block_csp_phases(torch, mods[1])
    colsum_small_block_phases(torch, mods[0])
    query_group_phases(torch, mods[0], mods[1])
    prows = probe_phase(torch, importlib.import_module(
        'chipmunk_torch.kernels.int8_probe'))
    torch.cuda.empty_cache()
    stamp('FLUX kernel phases')
    # the Wan kernels before the video kernels: placed after the traced
    # loops (scheduled torch.profiler sessions), device_ms's plain profile
    # recorded no CUDA kernel on the H100; and the FLUX loops follow the
    # video kernel phase, which runs no profiler, as before
    wck = cfgmod.load_config(os.path.join(ROOT, 'configs',
                                          'wan-chipmunk.yml'))
    wan_kernel_phases(torch, mods, tm, wck)
    stamp('Wan kernel phases')
    vck = cfgmod.load_config(os.path.join(ROOT, 'configs',
                                          'hunyuan-chipmunk.yml'))
    vrow, _ = video_kernel_phases(torch, mods, tm, vck)
    stamp('video kernel phases')

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
    launches = drive_path(torch, kern, tm, ck, model, 'bf16', BF16_PATH,
                          trace_compiled=True)[0]
    check_launches('bf16', launches, flux_launches(
        ck, model, ('csp_mlp_mm1', 'csp_mlp_mm2')))

    # (b) quantized weights as bench.py builds them, at the first
    # QUANT_DEPTH blocks; the bf16 model of (a) lives only inside its loops
    # and is freed by now
    model_q = dataclasses.replace(model, **QUANT_DEPTH)
    t0 = time.perf_counter()
    qparams = quant.synth_quantized_flux_params(
        SEED, model_q, quant.QuantSpec(*SPEC), device='cuda')
    torch.cuda.synchronize()
    print(f'quantized weights synthesized on the host and moved to the card '
          f'in {time.perf_counter() - t0:.1f} s: '
          f'{quant.param_bytes(qparams) / 2 ** 30:.2f} GiB at depth '
          f'{model_q.depth}+{model_q.depth_single_blocks}, QuantSpec{SPEC}',
          flush=True)
    qlaunches, q_sparse_s, q_dense_s, _, _ = drive_path(
        torch, kern, tm, ck, model_q, 'quantized', QUANT_PATH, qparams,
        trace_compiled=True)
    check_launches('quantized', qlaunches, flux_launches(
        ck, model_q, ('quant_rows', 'csp_mlp_mm1_a8', 'csp_mlp_mm2_a8')))
    print(f'quantized sparse loop {q_sparse_s:.3f} s: '
          f'{q_dense_s / q_sparse_s:.3f}x against the quantized dense loop '
          f'({q_dense_s:.3f} s), both at depth {model_q.depth}+'
          f'{model_q.depth_single_blocks}', flush=True)

    # (c) the same weights with mlp.int8_act off: every sparse MLP step
    # takes the wq pair, as often as flux_launches counts; the dense
    # yardstick is (b)'s dense loop (the dense path does not read
    # int8_act)
    no_a8 = ck.replace(mlp=dataclasses.replace(ck.mlp, int8_act=False))
    wlaunches, w_sparse_s, _, _, _ = drive_path(
        torch, kern, tm, no_a8, model_q, 'quantized int8_act off', WQ_PATH,
        qparams, dense=False)
    check_launches('quantized int8_act off', wlaunches, flux_launches(
        no_a8, model_q, ('csp_mlp_mm1_wq', 'csp_mlp_mm2_wq')))
    print(f'quantized int8_act off sparse loop {w_sparse_s:.3f} s: '
          f'{q_dense_s / w_sparse_s:.3f}x against the quantized dense loop '
          f'({q_dense_s:.3f} s); int8_act on {q_sparse_s:.3f} s', flush=True)
    del qparams
    torch.cuda.empty_cache()
    stamp('FLUX loops')

    # ---- prompt to pixels: one FLUX.1-dev generation at 1280x768 through
    # the encoders, loop (a)'s weights and schedule, and the autoencoder
    flux_generation(torch, tm, kern, ck, model, launches)
    stamp('FLUX generation')

    # ---- checkpoint to latents: FLUX.1-dev from a BFL state dict through
    # load_flux_params with mlp.is_fp8, the fp8 product, the three twins
    flaunches, _ = flux_from_checkpoint(torch, tm, kern, ck)
    f8_input_matmul_phase(torch)
    run_twins(torch, tm)
    stamp('checkpoint to latents')

    # ---- the video path: HunyuanVideo 540p, configs/hunyuan-chipmunk.yml
    # unchanged (compressed indices, packed-only states as its offloading
    # block decides, top_keys 0.05, random_keys 0.01)
    print(f'config: configs/hunyuan-chipmunk.yml unchanged (attn.top_keys='
          f'{vck.attn.top_keys}, random_keys={vck.attn.random_keys}, '
          f'should_compress_indices='
          f'{str(vck.attn.should_compress_indices).lower()}, '
          f'first_n_dense_layers={vck.attn.first_n_dense_layers}, mlp '
          f'{"on" if vck.mlp.is_enabled else "off"})', flush=True)
    text = encode_hunyuan_text(torch, tm)
    stamp('LLaVA-LLaMA-3-8B and CLIP-L')
    vlaunches, v_sparse_s, v_dense_s, _, vlat = drive_video_path(
        torch, kern, tm, vck, text)
    del text
    decode_hunyuan(torch, tm, vlat)
    del vlat
    stamp('HunyuanVideo VAE')
    agree_small_video(torch, tm, kern, vck)
    stamp('video path')
    drive_streamed_720p(torch, kern, tm, vck)
    stamp('HunyuanVideo 720p streamed')

    # ---- the Wan path: Wan2.1-T2V-1.3B at 480x832x81 frames, full width
    # and depth, configs/wan-chipmunk.yml as read (attention only, the MLP
    # off, local_voxels 3, compressed indices, random_keys 0.01)
    print(f'config: configs/wan-chipmunk.yml as read (attn.top_keys='
          f'{wck.attn.top_keys}, random_keys={wck.attn.random_keys}, '
          f'local_voxels={wck.attn.local_voxels}, first_n_dense_layers='
          f'{wck.attn.first_n_dense_layers}, full steps '
          f'{sorted(wck.attn.full_step_schedule)}, mlp '
          f'{"on" if wck.mlp.is_enabled else "off"}, step caching '
          f'{len(wck.step_caching.skip_step_schedule)} skipped steps)',
          flush=True)
    ctx = encode_wan_text(torch, tm)
    stamp('UMT5-XXL')
    wlat = drive_wan_path(torch, kern, tm, wck, ctx)[-1]
    del ctx
    stamp('Wan loops')
    decode_wan(torch, tm, wlat)
    del wlat
    stamp('Wan VAE')
    agree_small_wan(torch, tm, kern, wck)
    stamp('Wan agreement')
    agree_small_decoders(torch, tm)
    stamp('encoder and decoder agreement')

    # ---- multi-card sampling on a world of one NCCL rank
    parallel_phase(torch, tm, kern, ck, vck, smi)
    stamp('parallel')

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
    agree_compiled_small(torch, tm, kern, small_ck, small, 'bf16')
    small_q = quant.synth_quantized_flux_params(
        SEED, small, quant.QuantSpec(*SPEC), device='cpu')
    agree_compiled_small(torch, tm, kern, small_ck, small, 'quantized',
                         small_q)
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
                    small_q if spec == SPEC else
                    quant.synth_quantized_flux_params(
                        SEED, small, quant.QuantSpec(*spec), device='cpu'))
    # the MLP with the cache dtypes unset: bf16 caches (the reference's
    # default), bf16 and quantized weights
    bf16_caches = small_ck.replace(mlp=dataclasses.replace(
        small_ck.mlp, act_cache_dtype=None, out_cache_dtype=None))
    agree_small(torch, tm, kern, bf16_caches, small, 'bf16 caches',
                BF16_PATH)
    agree_small(torch, tm, kern, bf16_caches, small, 'quantized bf16 caches',
                QUANT_PATH, small_q)

    stamp('FLUX agreement')
    for r in rows:
        r['route'] = 'cuda'
        r['launches'] = launches[r['name']]
    for r in qrows + prows:             # the quantized paths (probe: 0)
        r['route'] = 'cuda'             # a8: the full-depth is_fp8 loop
        r['launches'] = (wlaunches if r['name'] in WQ_PATH
                         else flaunches)[r['name']]
    vrow['route'] = 'cuda'
    vrow['launches'] = vlaunches[vrow['name']]
    rows += qrows + prows + [vrow]
    print(smi)
    print_json(rows)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
