"""Dense tile GEMM probe, a wrapper over ``csrc/int8_probe.cu`` with its
plain PyTorch version.

Counterpart of ``_pk`` in ``scripts/bench_int8_mxu.py``: C = A @ B for
A [M, K], B [K, N] row-major, int8 x int8 -> int32 or bf16 x bf16 ->
float32.  It is off the sparse loop's path: it measures whether s8
``wgmma`` on the template the sparse-MLP kernels run on
(``csrc/gemm_sm90.cuh``) reaches twice the bf16 rate on the card
(``chip_smoke.py`` times it beside ``torch._int_mm`` and
``torch.matmul``).
"""
from __future__ import annotations

import torch

from . import _build
from .flash_attention import _stream


def int8_probe_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8: the exact int32 product (sums in float64, exact for int8
    operands at K < 2^38); bf16: the float32 product."""
    if a.dtype == torch.int8:
        return (a.double() @ b.double()).to(torch.int32)
    return a.float() @ b.float()


def int8_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A @ B with int32 (int8 inputs) or float32 (bf16 inputs) output."""
    M, K = a.shape
    if b.shape[0] != K or a.dtype != b.dtype \
            or a.dtype not in (torch.int8, torch.bfloat16):
        raise ValueError('int8_probe: A [M, K] and B [K, N], both int8 or '
                         'both bf16')
    N = b.shape[1]
    if a.device.type == 'cpu' and b.device.type == 'cpu':
        return int8_probe_plain(a, b)
    for t in (a, b):
        if t.device.type != 'cuda' or not t.is_contiguous():
            raise ValueError('int8_probe: tensors must be contiguous, on one '
                             'CUDA device or all on the CPU')
    s8 = a.dtype == torch.int8
    if M % 128 or N % 128 or K % (16 if s8 else 8):
        raise ValueError('int8_probe: M and N must be multiples of 128, K of '
                         '16 (int8) or 8 (bf16)')
    c = torch.empty((M, N), dtype=torch.int32 if s8 else torch.float32,
                    device=a.device)
    name = 'int8_probe_s8' if s8 else 'int8_probe_bf16'
    lib = _build.library('int8_probe')
    fn = lib.chipmunk_int8_probe_s8 if s8 else lib.chipmunk_int8_probe_bf16
    _build.check(fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), M, K, N,
                    _stream(a)), name)
    _build.LAUNCHES[name] += 1
    return c
