"""chipmunk_torch kernels (plain versions, CPU) against the chipmunk_tpu
Pallas kernels in interpret mode, on the same numpy inputs.

The CUDA kernels themselves run only on the card: ``test_torch_cuda.py``
holds them against the plain versions there.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from chipmunk_tpu.kernels import csp_attn as j_csp_attn
from chipmunk_tpu.kernels import dense_attn as j_dense_attn
from chipmunk_tpu.kernels import dense_colsum_attn as j_colsum
from chipmunk_tpu.kernels.csp_mlp import csp_mlp_fused as j_csp_mlp_fused
from chipmunk_tpu.kernels.csp_mlp import csp_mlp_mm1 as j_csp_mlp_mm1
from chipmunk_tpu.kernels.csp_mlp import csp_mlp_mm2 as j_csp_mlp_mm2
from chipmunk_torch.kernels import (csp_attn, csp_mlp_fused, csp_mlp_mm1,
                                    csp_mlp_mm2, dense_attn,
                                    dense_colsum_attn)
from chipmunk_torch.ops import fp8
from chipmunk_torch.ops.attn_ref import PAD_LSE


def to_torch(a):
    """numpy (incl. ml_dtypes bf16/fp8) -> torch, bit for bit."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(fp8.FP8)
    return torch.from_numpy(a.copy())


def qkv(seed, sq, sk, d=64, h=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, h, sq, d)).astype(np.float32),
            rng.standard_normal((1, h, sk, d)).astype(np.float32),
            rng.standard_normal((1, h, sk, d)).astype(np.float32))


def random_blocks(rng, lead, nb, jmax):
    """Unique block ids per row and counts from 1 to jmax."""
    inds = np.stack([rng.permutation(nb)[:jmax]
                     for _ in range(int(np.prod(lead)))]).reshape(*lead, jmax)
    counts = rng.integers(1, jmax + 1, size=lead)
    counts.reshape(-1)[:2] = (1, jmax)
    return inds.astype(np.int32), counts.astype(np.int32)


# f32 on both sides; the two differ only in summation order and in the
# online (reference) vs one-shot (plain) softmax: 1e-5.
@pytest.mark.parametrize('sq,sk,bk', [(256, 256, 128), (300, 333, 128),
                                      (256, 256, 32), (300, 333, 32)])
def test_dense_attn_matches_reference(sq, sk, bk):
    q, k, v = qkv(0, sq, sk)
    o_j, lse_j = j_dense_attn(*map(jnp.asarray, (q, k, v)), bq=128, bk=bk,
                              interpret=True)
    o_t, lse_t = dense_attn(*map(to_torch, (q, k, v)))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize('sk,score_block', [(256, 128), (256, 32),
                                            (300, 32), (333, 128)])
def test_dense_colsum_attn_matches_reference(sk, score_block):
    q, k, v = qkv(1, 256, sk)
    _, lse = j_dense_attn(*map(jnp.asarray, qkv(2, 256, sk)), bq=128,
                          bk=128, interpret=True)
    prev = np.asarray(lse).copy()
    prev[:, :, -5:] = PAD_LSE            # padded rows add exactly 0
    o_j, cs_j, lse_j = j_colsum(*map(jnp.asarray, (q, k, v, prev)), qg=128,
                                bk=128, score_block=score_block,
                                interpret=True)
    o_t, cs_t, lse_t = dense_colsum_attn(*map(to_torch, (q, k, v, prev)),
                                         qg=128, score_block=score_block)
    assert cs_t.shape == cs_j.shape
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(cs_t.numpy(), np.asarray(cs_j), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize('kv_block,kv_valid', [(128, None), (32, None),
                                               (32, 470)])
def test_csp_attn_matches_reference(kv_block, kv_valid):
    q, k, v = qkv(3, 512, 512)
    rng = np.random.default_rng(4)
    jmax = 6 if kv_block == 32 else 3
    inds, counts = random_blocks(rng, (1, 2, 4), 512 // kv_block, jmax)
    o_j = j_csp_attn(*map(jnp.asarray, (q, k, v, inds, counts)), qg=128,
                     kv_block=kv_block, mode='vmem', kv_valid=kv_valid,
                     interpret=True)
    o_t = csp_attn(*map(to_torch, (q, k, v, inds, counts)), qg=128,
                   kv_block=kv_block, kv_valid=kv_valid)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5,
                               rtol=1e-5)


def _fp8_close(got, ref, extra=0.0):
    """Equal NaNs; elsewhere at most one e4m3 ulp (at the larger of the
    two) plus ``extra`` apart, and mostly equal.  The sums run in
    different orders on the two sides, so a value at a rounding boundary
    may take the neighbouring code; ``extra`` carries such a flip of an
    act-cache entry on into the output cache."""
    g, r = got.float().cpu().numpy(), np.asarray(ref, dtype=np.float32)
    assert (np.isnan(g) == np.isnan(r)).all()
    ok = ~np.isnan(r)
    mag = np.maximum(np.maximum(np.abs(r), np.abs(g)), 2.0 ** -6)
    ulp = np.exp2(np.floor(np.log2(mag)) - 3)
    extra = np.broadcast_to(extra, r.shape)
    assert (np.abs(g - r)[ok] <= (ulp + extra * 1.001)[ok]).all()
    assert (g[ok] == r[ok]).mean() > 0.99


def _out_slack(act_got, act_ref, w2):
    """|delta act| @ |w2|: how far act-cache flips may move the output."""
    dact = np.abs(act_got.float().cpu().numpy()
                  - np.asarray(act_ref, dtype=np.float32))
    return np.nan_to_num(dact) @ np.abs(np.asarray(w2, dtype=np.float32))


def mlp_inputs(seed, T=256, C=256, N=512, bm=128, bn=128, jmax=3):
    """bf16 weights and activations, fp8 e4m3 act/out caches."""
    rng = np.random.default_rng(seed)
    bf, f8 = ml_dtypes.bfloat16, ml_dtypes.float8_e4m3fn
    x = rng.standard_normal((T, C)).astype(bf)
    w1t = (rng.standard_normal((N, C)) * C ** -0.5).astype(bf)
    b1 = (rng.standard_normal(N) * 0.1).astype(bf)
    w2 = (rng.standard_normal((N, C)) * N ** -0.5).astype(bf)
    act = (rng.standard_normal((T, N)) * 0.3).astype(np.float32).astype(f8)
    out = rng.standard_normal((T, C)).astype(np.float32).astype(f8)
    inds, counts = random_blocks(rng, (T // bm,), N // bn, jmax)
    return x, w1t, b1, w2, act, out, inds, counts


def test_csp_mlp_fused_matches_reference():
    """bf16 weights and activations, fp8 e4m3 act/out caches, bm = bn = 128."""
    bm = bn = 128
    x, w1t, b1, w2, act, out, inds, counts = mlp_inputs(5)
    out_j, act_j = j_csp_mlp_fused(*map(jnp.asarray, (x, w1t, b1, w2, act,
                                                      out, inds, counts)),
                                   bn=bn, bm=bm, interpret=True)
    out_t, act_t = csp_mlp_fused(*map(to_torch, (x, w1t, b1, w2, act, out,
                                                 inds, counts)), bn=bn, bm=bm)
    assert act_t.dtype == fp8.FP8 and out_t.dtype == fp8.FP8
    _fp8_close(act_t, act_j)
    _fp8_close(out_t, out_j, _out_slack(act_t, act_j, w2))


def test_csp_mlp_mm1_mm2_match_reference():
    """The two passes behind csp_mlp_fused against the reference's unfused
    kernels (_mm1_kernel, _mm2_kernel), which compute the same functions.
    The packed delta bf16(act - cache) is bit-equal where the two acts are,
    elsewhere apart by the acts' difference plus bf16 rounding."""
    bm = bn = 128
    x, w1t, b1, w2, act, out, inds, counts = mlp_inputs(7)
    pk_j, act_j = j_csp_mlp_mm1(*map(jnp.asarray, (x, w1t, b1, act, inds,
                                                   counts)),
                                bn=bn, bm=bm, interpret=True)
    pk_t, act_t = csp_mlp_mm1(*map(to_torch, (x, w1t, b1, act, inds, counts)),
                              bn=bn, bm=bm)
    _fp8_close(act_t, act_j)
    M, jmax = inds.shape
    cols = np.repeat((inds[..., None] * bn + np.arange(bn)).reshape(M, -1),
                     bm, 0)                                 # [T, jmax*bn]
    live = np.repeat(np.repeat(np.arange(jmax) < counts[:, None], bn, 1),
                     bm, 0)
    a_t = np.take_along_axis(act_t.float().numpy(), cols, 1)
    a_j = np.take_along_axis(np.asarray(act_j, np.float32), cols, 1)
    g, r = pk_t.float().numpy(), np.asarray(pk_j, np.float32)
    assert not g[~live].any() and not r[~live].any()       # zeroed slots
    same = (a_t == a_j) | ~live
    np.testing.assert_array_equal(g[same], r[same])
    d = ~same
    assert (np.abs(g - r)[d] <= np.abs(a_t - a_j)[d] * 1.001
            + np.maximum(np.abs(g), np.abs(r))[d] * 2.0 ** -8).all()
    # mm2 on the same packed delta: summation order only
    out_j = j_csp_mlp_mm2(*map(jnp.asarray, (pk_j, w2, out, inds, counts)),
                          bn=bn, bm=bm, interpret=True)
    out_t = csp_mlp_mm2(*map(to_torch, (pk_j, w2, out, inds, counts)), bn=bn,
                        bm=bm)
    _fp8_close(out_t, out_j)


def test_fp8_rounding_matches_jax():
    v = np.array([0.0, 1e-9, 2.0 ** -10, 2.0 ** -9, 3 * 2.0 ** -10, 1.0625,
                  447.0, 448.0, -448.0, 449.0, 460.0, 464.0, -464.0,
                  464.0001, 465.0, 470.0, -470.0, 1e4, -1e4, np.inf, -np.inf,
                  np.nan], np.float32)
    v = np.concatenate([v, np.random.default_rng(6).standard_normal(4096)
                        .astype(np.float32) * 100])
    ref = np.asarray(jnp.asarray(v).astype(jnp.float8_e4m3fn)).astype(
        np.float32)
    got = fp8.to_fp8(torch.from_numpy(v)).float().numpy()
    assert (np.isnan(got) == np.isnan(ref)).all()
    ok = ~np.isnan(ref)
    np.testing.assert_array_equal(got[ok], ref[ok])
    assert np.isnan(got[v.tolist().index(470.0)])       # not saturated
