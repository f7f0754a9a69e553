"""The CUDA kernels of chipmunk_torch against their plain PyTorch versions
on the card, at small shapes that reach the paths the FLUX shapes do not
(ragged Sq/Sk, kv_block 32 and 64, kv_valid, bm/bn of 256).  The kernels
have no CPU mode, so every test here skips without a GPU.  This file
imports neither jax nor chipmunk_tpu, so it runs on a machine without
them:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerances: bf16 attention outputs to 4e-3 + 2^-6 |ref| (the kernel
rounds p to bf16 against a running max, the plain version against the
row max), the log2-domain lse to 1e-3, column sums to 1e-4 + 1e-3 |ref|,
fp8 caches within one e4m3 ulp (sums in another order may round a value
at a boundary to its neighbour)."""
import importlib

import pytest
import torch

from chipmunk_torch.ops import fp8
from chipmunk_torch.ops.attn_ref import PAD_LSE

FA = importlib.import_module('chipmunk_torch.kernels.flash_attention')
CA = importlib.import_module('chipmunk_torch.kernels.csp_attention')
CM = importlib.import_module('chipmunk_torch.kernels.csp_mlp')
ATOL, RTOL = 4e-3, 2 ** -6


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernels have no CPU mode')
    return torch.Generator('cuda').manual_seed(0)


def randn(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device='cuda') * scale).to(
        torch.bfloat16)


def assert_fp8_close(got, ref, slack=None):
    """Equal NaNs; elsewhere within one e4m3 ulp of the larger magnitude
    (plus ``slack``), and almost all equal."""
    g, r = got.float(), ref.float()
    assert torch.equal(g.isnan(), r.isnan())
    ok = ~r.isnan()
    mag = torch.maximum(g.abs(), r.abs()).clamp(min=2.0 ** -6)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 3)
    if slack is not None:
        ulp = ulp + slack * 1.001
    assert bool(((g - r).abs() <= ulp)[ok].all())
    assert (g[ok] == r[ok]).float().mean().item() > 0.99


@pytest.mark.cuda
@pytest.mark.parametrize('sq,sk', [(384, 384), (300, 333)])
def test_cuda_dense_attn_matches_plain(gen, sq, sk):
    q = randn(gen, 1, 2, sq, 128)
    k, v = randn(gen, 1, 2, sk, 128), randn(gen, 1, 2, sk, 128)
    n0 = FA._build.LAUNCHES['dense_attn']
    o, lse = FA.dense_attn(q, k, v)
    torch.cuda.synchronize()
    assert FA._build.LAUNCHES['dense_attn'] == n0 + 1
    o_p, lse_p = FA.dense_attn_plain(q, k, v)
    torch.testing.assert_close(o.float(), o_p.float(), atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(lse, lse_p, atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize('sk,score_block', [(384, 128), (333, 64)])
def test_cuda_dense_colsum_attn_matches_plain(gen, sk, score_block):
    q = randn(gen, 1, 2, 256, 128)
    k, v = randn(gen, 1, 2, sk, 128), randn(gen, 1, 2, sk, 128)
    prev = FA.dense_attn_plain(randn(gen, 1, 2, 256, 128), k, v)[1]
    prev[..., -5:] = PAD_LSE            # padded rows add exactly 0
    o, cs, lse = FA.dense_colsum_attn(q, k, v, prev,
                                      score_block=score_block)
    torch.cuda.synchronize()
    o_p, cs_p, lse_p = FA.dense_colsum_attn_plain(q, k, v, prev,
                                                  score_block=score_block)
    torch.testing.assert_close(o.float(), o_p.float(), atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(lse, lse_p, atol=1e-3, rtol=0)
    torch.testing.assert_close(cs, cs_p, atol=1e-4, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize('kv_block,kv_valid', [(128, None), (32, None),
                                               (64, 300)])
def test_cuda_csp_attn_matches_plain(gen, kv_block, kv_valid):
    q, k, v = (randn(gen, 1, 2, 512, 128) for _ in range(3))
    nb, jmax = 512 // kv_block, 3
    inds = torch.rand((1, 2, 4, nb), generator=gen, device='cuda') \
        .argsort(-1)[..., :jmax].to(torch.int32)
    counts = torch.tensor([1, jmax, 2, jmax], device='cuda',
                          dtype=torch.int32).expand(1, 2, 4).contiguous()
    o = CA.csp_attn(q, k, v, inds, counts, kv_block=kv_block,
                    kv_valid=kv_valid)
    torch.cuda.synchronize()
    o_p = CA.csp_attn_plain(q, k, v, CA.pad_block_indices(inds, counts),
                            counts, kv_block=kv_block, kv_valid=kv_valid)
    torch.testing.assert_close(o.float(), o_p.float(), atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize('bm,bn', [(128, 128), (256, 256)])
def test_cuda_csp_mlp_fused_matches_plain(gen, bm, bn):
    T, C, N = 512, 256, 1024
    x = randn(gen, T, C)
    w1t, w2 = randn(gen, N, C, scale=C ** -0.5), randn(gen, N, C,
                                                        scale=N ** -0.5)
    b1 = randn(gen, N, scale=0.1)
    act = fp8.to_fp8(torch.randn((T, N), generator=gen, device='cuda') * 0.3)
    out = fp8.to_fp8(torch.randn((T, C), generator=gen, device='cuda'))
    M, jmax = T // bm, 3
    inds = torch.rand((M, N // bn), generator=gen, device='cuda') \
        .argsort(-1)[:, :jmax].to(torch.int32)
    counts = torch.arange(M, device='cuda', dtype=torch.int32) % jmax + 1
    out_k, act_k = CM.csp_mlp_fused(x, w1t, b1, w2, act.clone(), out.clone(),
                                    inds, counts, bn=bn, bm=bm)
    torch.cuda.synchronize()
    pinds = CA.pad_block_indices(inds, counts)
    pk, act_p = CM.csp_mlp_mm1_plain(x, w1t, b1, act, pinds, counts, bn, bm)
    out_p = CM.csp_mlp_mm2_plain(pk, w2, out, pinds, counts, bn, bm)
    assert_fp8_close(act_k, act_p)
    # an act-cache entry one ulp apart moves the output by |d act| @ |w2|
    dact = torch.nan_to_num((act_k.float() - act_p.float()).abs())
    assert_fp8_close(out_k, out_p, dact @ w2.float().abs())
