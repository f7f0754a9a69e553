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
from chipmunk_tpu.utils import quant as jq
from chipmunk_torch.kernels.csp_mlp import _codes, gelu_tanh
from chipmunk_torch.kernels.csp_attention import auto_mode
from chipmunk_torch.kernels import (csp_attn, csp_mlp_fused, csp_mlp_mm1,
                                    csp_mlp_mm1_a8, csp_mlp_mm2,
                                    csp_mlp_mm2_a8, dense_attn,
                                    dense_colsum_attn, int8_probe,
                                    pack_kv, quant_rows)
from chipmunk_torch.ops import fp8
from chipmunk_torch.ops.attn_ref import PAD_LSE
from chipmunk_torch.utils.quant import QTensor


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


def sq_for(qg):
    """Query rows for a test at query-group size qg: 256, or 384 where
    qg does not divide 256 (192, 96)."""
    return 256 if 256 % qg == 0 else 384


@pytest.mark.parametrize('sk,score_block,qg', [
    pytest.param(256, 128, 128, id='256-128'),
    pytest.param(256, 32, 128, id='256-32'),
    pytest.param(300, 32, 128, id='300-32'),
    pytest.param(333, 128, 128, id='333-128'),
    (256, 8, 128), (333, 16, 128), (256, 128, 64), (300, 32, 192),
    (333, 128, 256), (333, 8, 96), (256, 16, 32)])
def test_dense_colsum_attn_matches_reference(sk, score_block, qg):
    sq = sq_for(qg)
    q, k, v = qkv(1, sq, sk)
    _, lse = j_dense_attn(*map(jnp.asarray, qkv(2, sq, sk)), bq=128,
                          bk=128, interpret=True)
    prev = np.asarray(lse).copy()
    prev[:, :, -5:] = PAD_LSE            # padded rows add exactly 0
    o_j, cs_j, lse_j = j_colsum(*map(jnp.asarray, (q, k, v, prev)), qg=qg,
                                bk=128, score_block=score_block,
                                interpret=True)
    o_t, cs_t, lse_t = dense_colsum_attn(*map(to_torch, (q, k, v, prev)),
                                         qg=qg, score_block=score_block)
    assert cs_t.shape == cs_j.shape
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(cs_t.numpy(), np.asarray(cs_j), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize('kv_block,kv_valid,qg', [
    pytest.param(128, None, 128, id='128-None'),
    pytest.param(32, None, 128, id='32-None'),
    pytest.param(32, 470, 128, id='32-470'),
    pytest.param(8, None, 128, id='8-None'),
    pytest.param(16, None, 128, id='16-None'),
    (128, None, 64), (32, 470, 192), (16, None, 256), (8, 470, 96),
    (32, None, 32)])
def test_csp_attn_matches_reference(kv_block, kv_valid, qg):
    sq = 2 * sq_for(qg)
    q, k, v = qkv(3, sq, 512)
    rng = np.random.default_rng(4)
    jmax = 6 if kv_block == 32 else 3
    inds, counts = random_blocks(rng, (1, 2, sq // qg), 512 // kv_block,
                                 jmax)
    if kv_valid is not None and qg != 128:
        # as in the hbm test: every group keeps a block before kv_valid (a
        # row with no key at all gives 0 here and the masked V's mean in
        # the reference)
        inds[..., 0] = rng.integers(0, kv_valid // kv_block, (1, 2, sq // qg))
    o_j = j_csp_attn(*map(jnp.asarray, (q, k, v, inds, counts)), qg=qg,
                     kv_block=kv_block, mode='vmem', kv_valid=kv_valid,
                     interpret=True)
    o_t = csp_attn(*map(to_torch, (q, k, v, inds, counts)), qg=qg,
                   kv_block=kv_block, kv_valid=kv_valid)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize('kv_block,kv_valid,jmax,qg', [
    pytest.param(128, None, 3, 128, id='128-None-3'),
    pytest.param(32, None, 6, 128, id='32-None-6'),
    pytest.param(32, 470, 6, 128, id='32-470-6'),
    pytest.param(64, 300, 4, 128, id='64-300-4'),
    pytest.param(8, 470, 6, 128, id='8-470-6'),
    pytest.param(16, 470, 6, 128, id='16-470-6'),
    pytest.param(8, 300, 12, 128, id='8-300-12'),
    pytest.param(16, 300, 4, 128, id='16-300-4'),
    (32, 470, 6, 64), (16, 300, 4, 192), (128, None, 3, 256),
    (8, 470, 6, 96), (64, 300, 4, 32)])
def test_csp_attn_hbm_matches_reference(kv_block, kv_valid, jmax, qg):
    """The packed-KV mode against the reference's _csp_hbm_packed_kernel in
    interpret mode: counts from 1 to jmax (positions past the count never
    visited), kv_valid cutting a block; the port's pack is the reference's
    layout, and the mode is the same function as 'vmem'."""
    sq = 2 * sq_for(qg)
    G = sq // qg
    q, k, v = qkv(14, sq, 512)
    rng = np.random.default_rng(15)
    inds, counts = random_blocks(rng, (1, 2, G), 512 // kv_block, jmax)
    if kv_valid is not None:
        # every group keeps a block before kv_valid: no row without keys
        inds[..., 0] = rng.integers(0, kv_valid // kv_block, (1, 2, G))
        inds[..., 1] = kv_valid // kv_block      # the block kv_valid cuts
        counts = np.maximum(counts, 2)
    o_j = j_csp_attn(*map(jnp.asarray, (q, k, v, inds, counts)), qg=qg,
                     kv_block=kv_block, mode='hbm', kv_valid=kv_valid,
                     interpret=True)
    args = [to_torch(a) for a in (q, k, v, inds, counts)]
    o_t = csp_attn(*args, qg=qg, kv_block=kv_block, kv_valid=kv_valid,
                   mode='hbm')
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(
        csp_attn(*args, qg=qg, kv_block=kv_block, kv_valid=kv_valid,
                 mode='vmem').numpy(), o_t.numpy())
    # the reference's pack (csp_attention.py:410-413)
    nb = 512 // kv_block
    ref_pack = jnp.concatenate(
        [jnp.asarray(k).reshape(2, nb, kv_block, 64),
         jnp.asarray(v).reshape(2, nb, kv_block, 64)], axis=2)
    np.testing.assert_array_equal(
        pack_kv(to_torch(k), to_torch(v), kv_block).numpy(),
        np.asarray(ref_pack))


@pytest.mark.parametrize('mode', ['vmem', 'hbm'])
@pytest.mark.parametrize('kv_block,jmax,kv_valid', [
    (4, 24, 470), (2, 40, 301), (1, 48, 300)])
def test_csp_attn_small_blocks_match_reference(kv_block, jmax, kv_valid,
                                               mode):
    """kv_block 4, 2 and 1 (read from the padded pack's 16-row slots on
    the card) in both modes against the reference's _csp_vmem_kernel /
    _csp_hbm_packed_kernel in interpret mode: counts of 1 and jmax, the
    block that kv_valid cuts (kv_block 2 and 4) selected by every group,
    one block before kv_valid in every group."""
    q, k, v = qkv(16, 512, 512)
    rng = np.random.default_rng(17 + kv_block)
    inds, counts = random_blocks(rng, (1, 2, 4), 512 // kv_block, jmax)
    inds[..., 0] = rng.integers(0, kv_valid // kv_block, (1, 2, 4))
    inds[..., 1] = kv_valid // kv_block          # cut, or just past kv_valid
    counts = np.maximum(counts, 2)
    counts.reshape(-1)[:2] = (2, jmax)
    o_j = j_csp_attn(*map(jnp.asarray, (q, k, v, inds, counts)), qg=128,
                     kv_block=kv_block, mode=mode, kv_valid=kv_valid,
                     interpret=True)
    o_t = csp_attn(*map(to_torch, (q, k, v, inds, counts)), qg=128,
                   kv_block=kv_block, kv_valid=kv_valid, mode=mode)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize('kv_block', [1, 2, 4])
def test_pack_kv_pads_small_blocks(kv_block):
    """Below 8 rows pack_kv gives each block a 16-row slot: its K rows at
    0.., its V rows at 8.., equal to the reference's pack (csp_attention.py
    :410-413) on those rows, zeros elsewhere."""
    _, k, v = qkv(18, 128, 256)
    nb = 256 // kv_block
    ref = np.asarray(jnp.concatenate(
        [jnp.asarray(k).reshape(2, nb, kv_block, 64),
         jnp.asarray(v).reshape(2, nb, kv_block, 64)], axis=2))
    got = pack_kv(to_torch(k), to_torch(v), kv_block).numpy()
    assert got.shape == (2, nb, 16, 64)
    np.testing.assert_array_equal(got[:, :, :kv_block], ref[:, :, :kv_block])
    np.testing.assert_array_equal(got[:, :, 8:8 + kv_block],
                                  ref[:, :, kv_block:])
    pad = np.ones(16, bool)
    pad[:kv_block] = pad[8:8 + kv_block] = False
    assert not got[:, :, pad].any()


def test_csp_attn_auto_mode_follows_the_reference_rule():
    """'auto' applies the reference's footprint rule with its constants:
    the FLUX shape takes 'vmem', HunyuanVideo at 540p 'hbm' (the switch
    is near 47k tokens at D = 128 in bf16)."""
    assert auto_mode(4352, 4352, 128, 6, 128, 2) == 'vmem'
    assert auto_mode(67584, 67584, 128, 44, 128, 2) == 'hbm'
    assert auto_mode(46080, 46080, 128, 40, 128, 2) == 'vmem'
    assert auto_mode(48128, 48128, 128, 40, 128, 2) == 'hbm'
    q, k, v = (torch.zeros(1, 1, 256, 64) for _ in range(3))
    inds = torch.zeros(1, 1, 2, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match='mode'):
        csp_attn(q, k, v, inds, torch.ones(1, 1, 2, dtype=torch.int32),
                 mode='direct')


def test_dense_kernels_take_sliced_views():
    """The video path hands dense_attn/dense_colsum_attn keys cut at
    valid_len and the query rows of the dense tail as views (no copy);
    the result equals that of the same data made contiguous, and the
    reference's at those shapes (Sq != Sk, Sk not a tile multiple, pad
    queries at PAD_LSE)."""
    q, k, v = qkv(16, 512, 512)
    tq, tk, tv = map(to_torch, (q, k, v))
    n, t0 = 470, 384
    o_t, lse_t = dense_attn(tq[..., t0:, :], tk[..., :n, :], tv[..., :n, :])
    o_j, lse_j = j_dense_attn(jnp.asarray(q[..., t0:, :]),
                              jnp.asarray(k[..., :n, :]),
                              jnp.asarray(v[..., :n, :]), bq=128, bk=128,
                              interpret=True)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=1e-5,
                               rtol=1e-5)
    prev = np.asarray(lse_j)
    prev = np.concatenate([np.full((1, 2, 384), 9.0, np.float32), prev], -1)
    prev[..., n:] = PAD_LSE
    o_t, cs_t, _ = dense_colsum_attn(tq, tk[..., :n, :], tv[..., :n, :],
                                     to_torch(prev), qg=128, score_block=128)
    o_j, cs_j, _ = j_colsum(jnp.asarray(q), jnp.asarray(k[..., :n, :]),
                            jnp.asarray(v[..., :n, :]), jnp.asarray(prev),
                            qg=128, bk=128, score_block=128, interpret=True)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(cs_t.numpy(), np.asarray(cs_j), atol=1e-5,
                               rtol=1e-5)
    assert not cs_t[:, :, 3].sum().item() == 0      # group 3 holds rows < n
    # strides the kernels refuse: rows not contiguous
    from chipmunk_torch.kernels.flash_attention import head_stride
    assert head_stride('x', tk[..., :n, :]) == 512 * 64
    with pytest.raises(ValueError, match='contiguous'):
        head_stride('x', tk.transpose(2, 3))


def _fp8_close(got, ref, extra=0.0):
    """Equal NaNs; elsewhere at most one ulp of the cache's type (fp8
    e4m3, or bf16: the bf16 ulp), at the larger of the two, plus
    ``extra`` apart, and mostly equal.  The sums run in different orders
    on the two sides, so a value at a rounding boundary may take the
    neighbouring code; ``extra`` carries such a flip of an act-cache entry
    on into the output cache.  The bf16 ulp is taken at 2^-13 at least:
    an act below that is gelu's 1 + tanh cancelling in float32, where the
    two sides' tanh, a float32 ulp apart, differ by ~1e-7 |mid|."""
    g, r = got.float().cpu().numpy(), np.asarray(ref, dtype=np.float32)
    assert (np.isnan(g) == np.isnan(r)).all()
    ok = ~np.isnan(r)
    if got.dtype == torch.bfloat16:
        mag = np.maximum(np.maximum(np.abs(r), np.abs(g)), 2.0 ** -13)
        ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    else:
        mag = np.maximum(np.maximum(np.abs(r), np.abs(g)), 2.0 ** -6)
        ulp = np.exp2(np.floor(np.log2(mag)) - 3)
    extra = np.broadcast_to(extra, r.shape)
    assert (np.abs(g - r)[ok] <= (ulp + extra * 1.001)[ok]).all()
    assert (g[ok] == r[ok]).mean() > 0.99


def _out_slack(act_got, act_ref, w2, old=None):
    """|delta act| @ |w2|: how far act-cache flips may move the output.
    With the old cache ``old`` (bf16 caches), a flipped entry's delta
    act - old, rounded to bf16, may also move by its own bf16 rounding."""
    dact = np.abs(act_got.float().cpu().numpy()
                  - np.asarray(act_ref, dtype=np.float32))
    if old is not None:
        delta = np.abs(np.asarray(act_ref, np.float32)
                       - np.asarray(old, np.float32))
        dact = dact + (dact > 0) * delta * 2.0 ** -8
    return np.nan_to_num(dact) @ np.abs(np.asarray(w2, dtype=np.float32))


def mlp_inputs(seed, T=256, C=256, N=512, bm=128, bn=128, jmax=3,
               cache=ml_dtypes.float8_e4m3fn):
    """bf16 weights and activations, act/out caches of type ``cache``
    (fp8 e4m3 by default, or bf16)."""
    rng = np.random.default_rng(seed)
    bf, f8 = ml_dtypes.bfloat16, cache
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


def _qt(w, kind='int8'):
    """The reference's int8 or int4 (packed along C) QTensor of an [N, C]
    weight, and the port's copy of it."""
    qj = jq.quantize(jnp.asarray(np.asarray(w, np.float32)), kind,
                     keep_axes=(0,), pack_axis=1 if kind == 'int4' else None)
    return qj, QTensor(to_torch(qj.q), to_torch(qj.scale), qj.pack_axis)


def _mm1_mm2_against_reference(seed, kind, cache=ml_dtypes.float8_e4m3fn,
                               T=256, C=256, N=512, bm=128, bn=128, jmax=3):
    """The two passes behind csp_mlp_fused against the reference's unfused
    kernels (_mm1_kernel, _mm2_kernel), which compute the same functions,
    with bf16 (kind None), int8 or int4 QTensor weights.  The packed delta
    bf16(act - cache) is bit-equal where the two acts are, elsewhere apart
    by the acts' difference plus bf16 rounding."""
    x, w1t, b1, w2, act, out, inds, counts = mlp_inputs(
        seed, T=T, C=C, N=N, bm=bm, bn=bn, jmax=jmax, cache=cache)
    if kind:
        (w1_j, w1_t), (w2_j, w2_t) = _qt(w1t, kind), _qt(w2, kind)
    else:
        w1_j, w2_j = jnp.asarray(w1t), jnp.asarray(w2)
        w1_t, w2_t = to_torch(w1t), to_torch(w2)
    pk_j, act_j = j_csp_mlp_mm1(jnp.asarray(x), w1_j,
                                *map(jnp.asarray, (b1, act, inds, counts)),
                                bn=bn, bm=bm, interpret=True)
    pk_t, act_t = csp_mlp_mm1(to_torch(x), w1_t,
                              *map(to_torch, (b1, act, inds, counts)),
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
    # the delta's own bf16 rounding: half an ulp of an exact fp8 difference,
    # up to one ulp where act - old needs more bits than bf16 has
    rnd = 2.0 ** -7 if cache == ml_dtypes.bfloat16 else 2.0 ** -8
    assert (np.abs(g - r)[d] <= np.abs(a_t - a_j)[d] * 1.001
            + np.maximum(np.abs(g), np.abs(r))[d] * rnd).all()
    # mm2 on the same packed delta: summation order only
    out_j = j_csp_mlp_mm2(pk_j, w2_j,
                          *map(jnp.asarray, (out, inds, counts)),
                          bn=bn, bm=bm, interpret=True)
    out_t = csp_mlp_mm2(to_torch(np.asarray(pk_j)), w2_t,
                        *map(to_torch, (out, inds, counts)), bn=bn, bm=bm)
    _fp8_close(out_t, out_j)


def test_csp_mlp_mm1_mm2_match_reference():
    """bf16 weights."""
    _mm1_mm2_against_reference(7, None)


def test_csp_mlp_mm1_mm2_wq_match_reference():
    """int8 QTensor weights with bf16 activations (the ``wq`` variants):
    mm1 folds the row scale in after the product, mm2 scales the delta
    in bf16 before it."""
    _mm1_mm2_against_reference(8, 'int8')


def test_csp_mlp_mm1_mm2_w4_match_reference():
    """int4 QTensor weights (plane-packed along C) with bf16 activations
    (the ``w4`` variants); the reference contracts each nibble plane with
    its half of x (mm1) or writes its half of the output (mm2)."""
    _mm1_mm2_against_reference(13, 'int4')


EDGE_SHAPES = [
    (256, 512, 1152, 128, 384, 2, 'fp8'),
    (256, 768, 512, 128, 128, 3, 'bf16'),
    (1024, 256, 1024, 512, 256, 3, 'fp8'),
    (1024, 768, 768, 512, 384, 2, 'bf16'),
]


def _edge_shapes_against_reference(kind, T, C, N, bm, bn, jmax, cache):
    """The quantized-weight plain pair with bf16 activations (int8 or
    int4 QTensors) at the card's tile edges, against _mm1_kernel /
    _mm2_kernel as in _mm1_mm2_against_reference, and the fused step
    against _fused_kernel's branch for the kind: the act cache within one
    ulp of its type, the out cache within one ulp plus what act flips
    move."""
    cdt = {'fp8': ml_dtypes.float8_e4m3fn, 'bf16': ml_dtypes.bfloat16}[cache]
    seed = 40 + C // 256 + bn // 128 + bm // 128
    _mm1_mm2_against_reference(seed, kind, cache=cdt, T=T, C=C, N=N,
                               bm=bm, bn=bn, jmax=jmax)
    x, w1t, b1, w2, act, out, inds, counts = mlp_inputs(
        seed, T=T, C=C, N=N, bm=bm, bn=bn, jmax=jmax, cache=cdt)
    (w1_j, w1_t), (w2_j, w2_t) = _qt(w1t, kind), _qt(w2, kind)
    out_j, act_j = j_csp_mlp_fused(
        jnp.asarray(x), w1_j, jnp.asarray(b1), w2_j,
        *map(jnp.asarray, (act, out, inds, counts)), bn=bn, bm=bm,
        interpret=True)
    out_t, act_t = csp_mlp_fused(to_torch(x), w1_t, to_torch(b1), w2_t,
                                 *map(to_torch, (act, out, inds, counts)),
                                 bn=bn, bm=bm)
    _fp8_close(act_t, act_j)
    _fp8_close(out_t, out_j, _out_slack(
        act_t, act_j, jq_dequant(w2_t),
        act if cache == 'bf16' else None))


@pytest.mark.parametrize('T,C,N,bm,bn,jmax,cache', EDGE_SHAPES)
def test_csp_mlp_w4_edge_shapes_match_reference(T, C, N, bm, bn, jmax,
                                                cache):
    """The int4-weight plain pair at the shapes the card's w4 kernels take
    at their edges (bn 384, C 512 and 768: a nibble plane of 256 and 384
    columns, bm 512; counts of 1 and jmax; fp8 or bf16 caches), as
    _edge_shapes_against_reference."""
    _edge_shapes_against_reference('int4', T, C, N, bm, bn, jmax, cache)


@pytest.mark.parametrize('T,C,N,bm,bn,jmax,cache', EDGE_SHAPES)
def test_csp_mlp_wq_edge_shapes_match_reference(T, C, N, bm, bn, jmax,
                                                cache):
    """The int8-weight plain pair at the shapes the card's wq kernels take
    at their edges (bn 384, bm 512: 256 tokens an mm1 tile; C 512 and 768:
    two and three 256-column mm2 tiles, C 256 one; counts of 1 and jmax;
    fp8 or bf16 caches), against _mm1_kernel / _mm2_kernel and
    _fused_kernel's wq branch, as _edge_shapes_against_reference."""
    _edge_shapes_against_reference('int8', T, C, N, bm, bn, jmax, cache)


def test_csp_mlp_wq_scaled_delta_route_is_bit_equal():
    """csp_mlp_fused with int8 weights lets mm1 multiply the packed delta
    by bf16(w2's row scale) and mm2 take it as it is (``w2=`` /
    ``prescaled=``); that is the reference's multiply moved from one pass
    to the other, so both caches come out bit-equal to the two passes
    called on their own."""
    x, w1t, b1, w2, act, out, inds, counts = mlp_inputs(
        31, T=512, C=512, N=1024, bm=256, bn=256, jmax=3)
    w1_t, w2_t = _qt(w1t)[1], _qt(w2)[1]
    xt, bt, it, ct = map(to_torch, (x, b1, inds, counts))
    pk, act_a = csp_mlp_mm1(xt, w1_t, bt, to_torch(act), it, ct, bn=256,
                            bm=256)
    out_a = csp_mlp_mm2(pk, w2_t, to_torch(out), it, ct, bn=256, bm=256)
    pk_s, _ = csp_mlp_mm1(xt, w1_t, bt, to_torch(act), it, ct, bn=256,
                          bm=256, w2=w2_t)
    assert not torch.equal(pk_s, pk)
    out_f, act_f = csp_mlp_fused(xt, w1_t, bt, w2_t, to_torch(act),
                                 to_torch(out), it, ct, bn=256, bm=256)
    np.testing.assert_array_equal(raw(out_f), raw(out_a))
    np.testing.assert_array_equal(raw(act_f), raw(act_a))
    with pytest.raises(ValueError, match='int8'):
        csp_mlp_mm2(pk, _qt(w2, 'int4')[1], to_torch(out), it, ct, bn=256,
                    bm=256, prescaled=True)


def _a8_chain_against_reference(kind, cases, C=256, N=512, jmax=3,
                                cache=ml_dtypes.float8_e4m3fn):
    """quant_rows, csp_mlp_mm1_a8 and csp_mlp_mm2_a8 (plain versions)
    against the reference's ``csp_mlp_fused(..., a8=True)`` in interpret
    mode.  Integer products are exact on both sides and every scalar step
    runs in the same order, so on tie-free inputs (seeded; checked below)
    the act cache is bit-equal; x8/sx and d8/sd match the kernel's
    formulas (csp_mlp.py:362-368, 413-419) applied to the reference's acts
    bit for bit; the out cache is within one e4m3 ulp.  With bf16 caches
    (``cache``) a bf16 rounding tie lies within two float32 ulps of about
    one act in 16,000, too many for tie-free seeds: the act cache is then
    within one bf16 ulp, d8/sd bit-equal wherever the acts of the (row,
    block) agree, the out cache within one ulp on the rows whose acts all
    agree."""
    for T, bm, bn, seed in cases:
        x, w1t, b1, w2, act, out, inds, counts = mlp_inputs(
            seed, T=T, C=C, N=N, bm=bm, bn=bn, jmax=jmax, cache=cache)
        (w1_j, w1_t), (w2_j, w2_t) = _qt(w1t, kind), _qt(w2, kind)
        out_j, act_j = j_csp_mlp_fused(
            jnp.asarray(x), w1_j, jnp.asarray(b1), w2_j,
            *map(jnp.asarray, (act, out, inds, counts)), bn=bn, bm=bm,
            interpret=True, a8=True)
        xt = to_torch(x)
        x8, sx = quant_rows(xt)
        fp8_cache = cache == ml_dtypes.float8_e4m3fn
        if fp8_cache:
            _assert_no_fp8_ties(x8, sx, w1_t, b1, inds, counts, bn, bm)
        d8, sd, act_t = csp_mlp_mm1_a8(
            x8, sx, w1_t, to_torch(b1), w2_t.scale, to_torch(act),
            *map(to_torch, (inds, counts)), bn=bn, bm=bm)
        out_t = csp_mlp_mm2_a8(d8, sd, w2_t, to_torch(out),
                               *map(to_torch, (inds, counts)), bn=bn, bm=bm)
        # the reference's formulas, in jnp
        xf = jnp.asarray(x).astype(jnp.float32)
        sx_r = jnp.maximum(jnp.max(jnp.abs(xf), axis=1, keepdims=True),
                           1e-6) * (1.0 / 127.0)
        x8_r = jnp.clip(jnp.round(xf / sx_r), -127, 127).astype(jnp.int8)
        np.testing.assert_array_equal(sx.numpy(), np.asarray(sx_r)[:, 0])
        np.testing.assert_array_equal(x8.numpy(), np.asarray(x8_r))
        act_r = np.asarray(act_j, np.float32)
        if fp8_cache:
            np.testing.assert_array_equal(act_t.float().numpy(), act_r)
        else:
            _fp8_close(act_t, act_j)
        M, jmax = inds.shape
        T = x.shape[0]
        cols = np.repeat((inds[..., None] * bn + np.arange(bn))
                         .reshape(M, -1), bm, 0)            # [T, jmax*bn]
        old = np.take_along_axis(np.asarray(act, np.float32), cols, 1)
        new = np.take_along_axis(act_r, cols, 1)
        agree = (np.take_along_axis(act_t.float().numpy(), cols, 1) == new
                 ).reshape(T, jmax, bn).all(-1)
        w2s = np.asarray(w2_j.scale, np.float32)[:, 0][cols]
        ds = jnp.asarray(new - old) * jnp.asarray(w2s)
        ds = ds.reshape(T, jmax, bn)
        sd_r = jnp.maximum(jnp.max(jnp.abs(ds), axis=-1, keepdims=True),
                           1e-12) * (1.0 / 127.0)
        d8_r = np.asarray(jnp.clip(jnp.round(ds / sd_r), -127, 127)
                          .astype(jnp.int8))
        live = np.repeat(np.arange(jmax) < counts[:, None], bm, 0)
        ok = agree & live
        assert ok.sum() > 0.9 * live.sum()
        np.testing.assert_array_equal(sd.numpy()[ok],
                                      np.asarray(sd_r)[..., 0][ok])
        np.testing.assert_array_equal(d8.numpy().reshape(T, jmax, bn)[ok],
                                      d8_r[ok])
        assert not d8.numpy().reshape(T, jmax, bn)[~live].any()
        assert not sd.numpy()[~live].any()
        rows = (agree | ~live).all(-1)
        _fp8_close(out_t[torch.from_numpy(rows)], np.asarray(out_j)[rows])
        # the wrapper runs the same chain
        out_f, act_f = csp_mlp_fused(xt, w1_t, to_torch(b1), w2_t,
                                     to_torch(act), to_torch(out),
                                     *map(to_torch, (inds, counts)), bn=bn,
                                     bm=bm, a8=True)
        np.testing.assert_array_equal(raw(out_f), raw(out_t))
        np.testing.assert_array_equal(raw(act_f), raw(act_t))


def test_csp_mlp_a8_chain_matches_reference():
    """int8 weights and int8 activations, bm = bn = 128 and bm = 256,
    bn = 128 (T = 512)."""
    _a8_chain_against_reference('int8', ((256, 128, 128, 10),
                                         (512, 256, 128, 9)))


def test_csp_mlp_a8w4_chain_matches_reference():
    """int4 weights (plane-packed along C) and int8 activations; the
    reference widens each nibble plane to int8 and sums the planes'
    int32 products (exactly the product with the unpacked codes)."""
    _a8_chain_against_reference('int4', ((256, 128, 128, A8W4_SEEDS[0]),
                                         (512, 256, 128, A8W4_SEEDS[1])))


A8W4_SEEDS = (11, 12)    # tie-free inputs for the int4 a8 chain
A8_WIDE_SEEDS = (70, 71, 83)   # and for the bn 384 / 512 fp8 cases


@pytest.mark.parametrize('T,C,N,bm,bn,jmax,cache,seed', [
    (256, 512, 1024, 64, 256, 3, 'fp8', 60),
    (256, 768, 512, 64, 128, 3, 'bf16', 61),
    (512, 768, 512, 128, 256, 2, 'fp8', 62),
    (1024, 768, 768, 512, 256, 3, 'bf16', 63),
    (256, 512, 1536, 64, 384, 2, 'fp8', A8_WIDE_SEEDS[0]),
    (512, 512, 2048, 128, 512, 2, 'bf16', 65),
])
def test_csp_mlp_a8w4_edge_shapes_match_reference(T, C, N, bm, bn, jmax,
                                                  cache, seed):
    """The int4-weight, int8-activation plain chain at the shapes the
    card's a8w4 kernels take at their edges (bn 256, bm 64 and 512: a
    64-token tile; C 512 and 768: a nibble plane of 256 and 384 columns;
    bn 384 and 512: a neuron block split into sub-blocks; counts of 1 and
    jmax; fp8 or bf16 caches), against _fused_kernel's a8 + w4 branch as
    in _a8_chain_against_reference (tie-free seeds for the fp8 caches; at
    bm 512 the selected acts are too many for one, so that case takes
    bf16 caches)."""
    cdt = {'fp8': ml_dtypes.float8_e4m3fn, 'bf16': ml_dtypes.bfloat16}[cache]
    _a8_chain_against_reference('int4', ((T, bm, bn, seed),), C=C, N=N,
                                jmax=jmax, cache=cdt)


@pytest.mark.parametrize('T,C,N,bm,bn,jmax,cache,seed', [
    (256, 256, 1536, 128, 384, 2, 'fp8', A8_WIDE_SEEDS[1]),
    (512, 512, 2048, 128, 512, 2, 'fp8', A8_WIDE_SEEDS[2]),
    (1024, 256, 1536, 512, 384, 3, 'bf16', 68),
    (1024, 256, 2048, 512, 512, 2, 'bf16', 69),
])
def test_csp_mlp_a8_wide_blocks_match_reference(T, C, N, bm, bn, jmax,
                                                cache, seed):
    """The int8-weight, int8-activation plain chain at neuron blocks wider
    than 256 (bn 384 and 512, which the card's a8 mm1 splits into
    sub-blocks of 128 and 256 neurons; bm 128 and 512; counts of 1 and
    jmax; fp8 or bf16 caches), against _fused_kernel's a8 branch as in
    _a8_chain_against_reference: sd spans the whole block on both sides."""
    cdt = {'fp8': ml_dtypes.float8_e4m3fn, 'bf16': ml_dtypes.bfloat16}[cache]
    _a8_chain_against_reference('int8', ((T, bm, bn, seed),), C=C, N=N,
                                jmax=jmax, cache=cdt)


def raw(t):
    return t.view(torch.uint8).numpy()


def _assert_no_fp8_ties(x8, sx, w1, b1, inds, counts, bn, bm):
    """Tie-free inputs: no act of a selected block lies within 2^-22
    (relative, two float32 ulps) of an e4m3 rounding boundary, where the
    two sides' tanh, a float32 ulp apart, could round to different fp8
    codes."""
    M, jmax = inds.shape
    rows = (inds[..., None] * bn + np.arange(bn)).reshape(M, -1)
    prod = x8.numpy().reshape(M, bm, -1).astype(np.float64) @ \
        _codes(w1).numpy()[rows].astype(np.float64).transpose(0, 2, 1)
    s = sx.numpy().reshape(M, bm, 1) * w1.scale.numpy()[rows][:, None, :, 0]
    g = torch.from_numpy((prod * s + np.asarray(b1, np.float32)[rows][
        :, None, :]).astype(np.float32))
    g = gelu_tanh(g)
    lo, hi = fp8.to_fp8(g * (1 - 2.0 ** -22)), fp8.to_fp8(g * (1 + 2.0 ** -22))
    live = torch.from_numpy(np.repeat(np.arange(jmax) < counts[:, None], bn,
                                      1))[:, None, :].expand_as(g)
    assert torch.equal(lo.view(torch.uint8)[live], hi.view(torch.uint8)[live]
                       ), 'inputs at an fp8 rounding tie'


def test_csp_mlp_refuses_what_the_reference_refuses():
    """fp8 QTensor weights (both sides: ValueError), a8 with bf16 weights
    (reference: assertion; port: ValueError), int4 weights packed along N
    instead of C, one weight quantized and the other not, one int4 and
    the other int8."""
    x, w1t, b1, w2, act, out, inds, counts = mlp_inputs(11)
    f1 = jq.quantize(jnp.asarray(np.asarray(w1t, np.float32)), 'fp8',
                     keep_axes=(0,))
    f2 = jq.quantize(jnp.asarray(np.asarray(w2, np.float32)), 'fp8',
                     keep_axes=(0,))
    jargs = (jnp.asarray(b1),)
    with pytest.raises(ValueError, match='fp8'):
        j_csp_mlp_fused(jnp.asarray(x), f1, *jargs, f2,
                        *map(jnp.asarray, (act, out, inds, counts)),
                        interpret=True)
    with pytest.raises(AssertionError, match='a8'):
        j_csp_mlp_fused(*map(jnp.asarray, (x, w1t, b1, w2, act, out, inds,
                                           counts)), interpret=True, a8=True)
    targs = [to_torch(a) for a in (x, w1t, b1, w2, act, out, inds, counts)]
    t1 = QTensor(to_torch(f1.q), to_torch(f1.scale))
    t2 = QTensor(to_torch(f2.q), to_torch(f2.scale))
    for a8 in (False, True):
        with pytest.raises(ValueError, match='fp8'):
            csp_mlp_fused(targs[0], t1, targs[2], t2, *targs[4:], a8=a8)
    with pytest.raises(ValueError, match='a8'):
        csp_mlp_fused(*targs, a8=True)
    q4n = QTensor(torch.zeros((256, 256), dtype=torch.uint8),
                  torch.ones((512, 1)), -2)          # packed along N
    with pytest.raises(ValueError, match='packed along C'):
        csp_mlp_fused(targs[0], q4n, targs[2], q4n, *targs[4:], a8=True)
    with pytest.raises(ValueError, match='both'):
        csp_mlp_fused(targs[0], _qt(w1t)[1], *targs[2:])
    with pytest.raises(ValueError, match='int4-pack both'):
        csp_mlp_fused(targs[0], _qt(w1t, 'int4')[1], targs[2],
                      _qt(w2)[1], *targs[4:])


BF16_CACHE_SEEDS = {'bf16': 21, 'wq': 22, 'w4': 23, 'a8': 24, 'a8w4': 25}


@pytest.mark.parametrize('variant', ['bf16', 'wq', 'w4', 'a8', 'a8w4'])
def test_csp_mlp_bf16_caches_match_reference(variant):
    """bf16 act and out caches (the reference's default: no cache dtype in
    the config) through csp_mlp_fused against the reference's fused kernel
    in interpret mode, for each weight/activation variant, with
    _fp8_close read with the bf16 ulp.  bf16/wq/w4: the out cache within
    one ulp plus what act flips move, and the mm1/mm2 pair against
    _mm1_kernel/_mm2_kernel.  a8/a8w4: x8/sx bit-equal; d8/sd bit-equal
    to the reference's formulas on its acts wherever the acts of that
    (row, block) agree; the out cache within one ulp on the rows whose
    acts all agree."""
    bm = bn = 128
    seed = BF16_CACHE_SEEDS[variant]
    x, w1t, b1, w2, act, out, inds, counts = mlp_inputs(
        seed, cache=ml_dtypes.bfloat16)
    kind = {'wq': 'int8', 'a8': 'int8', 'w4': 'int4', 'a8w4': 'int4'}.get(
        variant)
    a8 = variant.startswith('a8')
    if kind:
        (w1_j, w1_t), (w2_j, w2_t) = _qt(w1t, kind), _qt(w2, kind)
    else:
        w1_j, w2_j = jnp.asarray(w1t), jnp.asarray(w2)
        w1_t, w2_t = to_torch(w1t), to_torch(w2)
    out_j, act_j = j_csp_mlp_fused(
        jnp.asarray(x), w1_j, jnp.asarray(b1), w2_j,
        *map(jnp.asarray, (act, out, inds, counts)), bn=bn, bm=bm,
        interpret=True, a8=a8)
    xt = to_torch(x)
    out_t, act_t = csp_mlp_fused(xt, w1_t, to_torch(b1), w2_t,
                                 *map(to_torch, (act, out, inds, counts)),
                                 bn=bn, bm=bm, a8=a8)
    assert act_t.dtype == out_t.dtype == torch.bfloat16
    _fp8_close(act_t, act_j)
    if not a8:
        w2f = (jq_dequant(w2_t) if kind else w2)
        _fp8_close(out_t, out_j, _out_slack(act_t, act_j, w2f, act))
        _mm1_mm2_against_reference(seed, kind, cache=ml_dtypes.bfloat16)
        return
    x8, sx = quant_rows(xt)
    xf = jnp.asarray(x).astype(jnp.float32)
    sx_r = jnp.maximum(jnp.max(jnp.abs(xf), axis=1, keepdims=True),
                       1e-6) * (1.0 / 127.0)
    np.testing.assert_array_equal(sx.numpy(), np.asarray(sx_r)[:, 0])
    np.testing.assert_array_equal(
        x8.numpy(), np.asarray(jnp.clip(jnp.round(xf / sx_r), -127, 127)
                               .astype(jnp.int8)))
    d8, sd, _ = csp_mlp_mm1_a8(x8, sx, w1_t, to_torch(b1), w2_t.scale,
                               to_torch(act), *map(to_torch, (inds, counts)),
                               bn=bn, bm=bm)
    M, jmax = inds.shape
    T = x.shape[0]
    cols = np.repeat((inds[..., None] * bn + np.arange(bn)).reshape(M, -1),
                     bm, 0)
    act_r = np.asarray(act_j, np.float32)
    old = np.take_along_axis(np.asarray(act, np.float32), cols, 1)
    new = np.take_along_axis(act_r, cols, 1)
    agree = (np.take_along_axis(act_t.float().numpy(), cols, 1) == new
             ).reshape(T, jmax, bn).all(-1)
    w2s = np.asarray(w2_j.scale, np.float32)[:, 0][cols]
    ds = (jnp.asarray(new - old) * jnp.asarray(w2s)).reshape(T, jmax, bn)
    sd_r = jnp.maximum(jnp.max(jnp.abs(ds), axis=-1, keepdims=True),
                       1e-12) * (1.0 / 127.0)
    d8_r = np.asarray(jnp.clip(jnp.round(ds / sd_r), -127, 127)
                      .astype(jnp.int8))
    live = np.repeat(np.arange(jmax) < counts[:, None], bm, 0)
    ok = agree & live
    assert ok.sum() > 0.9 * live.sum()
    np.testing.assert_array_equal(sd.numpy()[ok], np.asarray(sd_r)[..., 0][ok])
    np.testing.assert_array_equal(d8.numpy().reshape(T, jmax, bn)[ok],
                                  d8_r[ok])
    rows = (agree | ~live).all(-1)
    _fp8_close(out_t[torch.from_numpy(rows)], np.asarray(out_j)[rows])


def jq_dequant(w):
    """float32 weights of a port QTensor (codes times scales)."""
    return _codes(w).float().numpy() * w.scale.float().numpy()


def test_int8_probe_plain_is_the_product():
    """The probe's plain version is the exact product (int8 -> int32) or
    the float32 product (bf16), as the reference's _pk computes."""
    rng = np.random.default_rng(12)
    a = rng.integers(-127, 128, (128, 192)).astype(np.int8)
    b = rng.integers(-127, 128, (192, 256)).astype(np.int8)
    got = int8_probe(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))
    af, bf = (rng.standard_normal(s).astype(ml_dtypes.bfloat16)
              for s in ((128, 64), (64, 128)))
    got = int8_probe(to_torch(af), to_torch(bf))
    np.testing.assert_allclose(got.numpy(), af.astype(np.float32)
                               @ bf.astype(np.float32), rtol=1e-6, atol=1e-5)
    with pytest.raises(ValueError):
        int8_probe(torch.from_numpy(a), to_torch(bf))


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


def test_dense_wrappers_check_before_the_kernel():
    """What the CUDA kernels refuse is refused by the wrappers on any
    device: mismatched q/k/v, a query count that is no multiple of qg."""
    from chipmunk_torch.kernels import flash_attention as fa
    q = torch.zeros((1, 2, 130, 128))
    with pytest.raises(ValueError, match='not \\[B,H,S,D\\] alike'):
        fa.dense_attn(q, torch.zeros((1, 2, 9, 64)), torch.zeros((1, 2, 9, 64)))
    with pytest.raises(ValueError, match='multiple of qg'):
        fa.dense_colsum_attn(q, q, q, torch.zeros((1, 2, 130)))
