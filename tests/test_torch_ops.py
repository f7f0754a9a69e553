"""chipmunk_torch eager oracles and index ops against chipmunk_tpu.ops on
the same numpy inputs (float32 on both sides)."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chipmunk_tpu.ops import attn_ref as jref
from chipmunk_tpu.ops import indexing as jidx
from chipmunk_tpu.ops import mlp_ref as jmlp
from chipmunk_torch.kernels.csp_mlp import gelu_tanh
from chipmunk_torch.ops import attn_ref, bitpack, indexing, mlp_ref

# the module (chipmunk_tpu.ops re-exports a function of the same name)
jbit = importlib.import_module('chipmunk_tpu.ops.bitpack')

# float32 on both sides: the two differ in summation order only
TOL = dict(atol=1e-5, rtol=1e-5)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize('sk_valid', [None, 200])
def test_dense_and_colsum_refs_match_reference(sk_valid):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 2, 256, 64)).astype(np.float32)
               for _ in range(3))
    prev = rng.standard_normal((1, 2, 256)).astype(np.float32) + 8.0
    prev[..., -7:] = attn_ref.PAD_LSE
    kv_mask = None if sk_valid is None else np.arange(256) < sk_valid
    jm = None if kv_mask is None else jnp.asarray(kv_mask)
    tm = None if kv_mask is None else t(kv_mask)
    o_j, lse_j = jref.dense_attn_ref(*map(jnp.asarray, (q, k, v)), kv_mask=jm)
    o_t, lse_t = attn_ref.dense_attn_ref(t(q), t(k), t(v), kv_mask=tm)
    close(o_t, o_j)
    close(lse_t, lse_j)
    o_j, cs_j, lse_j = jref.dense_colsum_attn_ref(
        *map(jnp.asarray, (q, k, v, prev)), 128, kv_mask=jm)
    o_t, cs_t, lse_t = attn_ref.dense_colsum_attn_ref(
        t(q), t(k), t(v), t(prev), 128, kv_mask=tm)
    for got, ref in ((o_t, o_j), (cs_t, cs_j), (lse_t, lse_j)):
        close(got, ref)
    assert attn_ref.attn_scale(64) == jref.attn_scale(64)
    assert attn_ref.PAD_LSE == jref.PAD_LSE


@pytest.mark.parametrize('kv_block,kv_valid', [(32, None), (64, 450)])
def test_csp_block_attn_ref_matches_reference(kv_block, kv_valid):
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((1, 2, 512, 64)).astype(np.float32)
               for _ in range(3))
    nb, jmax = 512 // kv_block, 5
    inds = np.stack([rng.permutation(nb)[:jmax] for _ in range(8)]) \
        .reshape(1, 2, 4, jmax).astype(np.int32)
    counts = rng.integers(1, jmax + 1, (1, 2, 4)).astype(np.int32)
    o_j = jref.csp_block_attn_ref(*map(jnp.asarray, (q, k, v, inds, counts)),
                                  128, kv_block, kv_valid=kv_valid)
    o_t = attn_ref.csp_block_attn_ref(t(q), t(k), t(v), t(inds), t(counts),
                                      128, kv_block, kv_valid=kv_valid)
    close(o_t, o_j)


def test_csp_mlp_ref_and_block_mean_match_reference():
    T, C, N, bm, jmax = 256, 64, 512, 128, 200
    rng = np.random.default_rng(2)
    x = rng.standard_normal((T, C)).astype(np.float32)
    w1 = (rng.standard_normal((C, N)) * 0.2).astype(np.float32)
    b1 = (rng.standard_normal(N) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((N, C)) * 0.1).astype(np.float32)
    act = rng.standard_normal((T, N)).astype(np.float32)
    out = rng.standard_normal((T, C)).astype(np.float32)
    inds = np.stack([rng.permutation(N)[:jmax] for _ in range(T // bm)]) \
        .astype(np.int32)
    counts = np.array([37, jmax], np.int32)
    out_j, act_j = jmlp.csp_mlp_ref(*map(jnp.asarray, (x, w1, b1, w2, inds,
                                                       counts, act, out)),
                                    bm, act=jax.nn.gelu)
    out_t, act_t = mlp_ref.csp_mlp_ref(*map(t, (x, w1, b1, w2, inds, counts,
                                                act, out)), bm, gelu_tanh)
    close(out_t, out_j)
    close(act_t, act_j)
    close(mlp_ref.block_mean(t(x)[None], 32),
          jmlp.block_mean(jnp.asarray(x)[None], 32))


def test_indexing_matches_reference():
    rng = np.random.default_rng(3)
    scores = rng.random((2, 3, 64)).astype(np.float32)
    assert all(len(np.unique(r)) == 64 for r in scores.reshape(-1, 64))
    mask_j = np.asarray(jidx.topk_mask(jnp.asarray(scores), 9))
    mask_t = indexing.topk_mask(t(scores), 9)
    np.testing.assert_array_equal(mask_t.numpy(), mask_j)
    assert not indexing.topk_mask(t(scores), 0).any()
    mask = rng.random((2, 3, 64)) < 0.2
    mask[0, 0] = False                     # an empty row
    for mult, jmax in ((1, 16), (4, 16), (8, 70)):
        inds_j, counts_j = jidx.mask_to_indices_limited(jnp.asarray(mask),
                                                        mult, jmax)
        inds_t, counts_t = indexing.mask_to_indices_limited(t(mask), mult,
                                                            jmax)
        np.testing.assert_array_equal(inds_t.numpy(), np.asarray(inds_j))
        np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts_j))
        full, _ = jidx.mask_to_indices(jnp.asarray(mask), mult)
        np.testing.assert_array_equal(inds_t.numpy(),
                                      np.asarray(full)[..., :min(jmax, 64)])
    close(indexing.blockify_scores(t(scores), 8),
          jidx.blockify_scores(jnp.asarray(scores), 8))
    np.testing.assert_array_equal(
        indexing.blockify_mask(t(mask), 8).numpy(),
        np.asarray(jidx.blockify_mask(jnp.asarray(mask), 8)))
    new, cache = scores, scores[::-1].copy()
    np.testing.assert_array_equal(
        indexing.copy_indices(t(new), t(cache), t(mask)).numpy(),
        np.asarray(jidx.copy_indices(*map(jnp.asarray, (new, cache, mask)))))


@pytest.mark.parametrize('shape', [(3, 16), (1, 2, 5, 528), (2, 7),
                                   (4, 1), (2, 3, 931)])
def test_bitpack_rows_matches_reference(shape):
    """Byte for byte the reference's little-endian packing, with and
    without a partial last byte, and the inverse."""
    rng = np.random.default_rng(sum(shape))
    mask = rng.random(shape) < 0.3
    got = bitpack.bitpack_rows(t(mask))
    ref = np.asarray(jbit.bitpack_rows(jnp.asarray(mask)))
    assert got.dtype == torch.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        bitpack.bitunpack_rows(got, shape[-1]).numpy(), mask)
    np.testing.assert_array_equal(
        np.asarray(jbit.bitunpack_rows(jnp.asarray(ref), shape[-1])), mask)
