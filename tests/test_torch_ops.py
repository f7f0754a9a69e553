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
from chipmunk_torch.ops import attn_ref, indexing, mlp_ref

# the modules (each ops package re-exports a function of the same name)
jbit = importlib.import_module('chipmunk_tpu.ops.bitpack')
bitpack = importlib.import_module('chipmunk_torch.ops.bitpack')

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


# ------------------------------------------- the rest of the op surface

def tie_free(rng, shape):
    """Scores with no two equal in a row (torch.topk and lax.top_k order
    ties differently)."""
    a = rng.permutation(int(np.prod(shape))).reshape(shape)
    return (a.astype(np.float32) + 0.5) / a.size


@pytest.mark.parametrize('multiple_of,n', [(1, 37), (8, 64), (16, 200)])
def test_mask_to_indices_matches_reference(multiple_of, n):
    mask = np.random.default_rng(n).random((2, 3, n)) < 0.3
    mask[0, 0] = False
    mask[1, 2] = True
    inds_j, counts_j = jidx.mask_to_indices(jnp.asarray(mask), multiple_of)
    inds_t, counts_t = indexing.mask_to_indices(t(mask), multiple_of)
    assert inds_t.dtype == counts_t.dtype == torch.int32
    np.testing.assert_array_equal(inds_t.numpy(), np.asarray(inds_j))
    np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts_j))


@pytest.mark.parametrize('sparsity,multiple_of', [(0.7, 8), (0.95, 1),
                                                  (0.0, 16)])
def test_topk_indices_matches_reference(sparsity, multiple_of):
    """Without the random keep the two agree exactly; a keep drawn by the
    reference and injected here gives the reference's selection too."""
    rng = np.random.default_rng(1)
    scores = tie_free(rng, (4, 96))
    ref = jidx.topk_indices(jnp.asarray(scores), sparsity, multiple_of, 0.0,
                            jax.random.PRNGKey(0))
    got = indexing.topk_indices(t(scores), sparsity, multiple_of, 0.0)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    ref = jidx.topk_indices(jnp.asarray(scores), sparsity, multiple_of, 0.1,
                            jax.random.PRNGKey(2))
    keep = np.asarray(ref[2]) & ~np.asarray(jidx.topk_mask(
        jnp.asarray(scores), int(round((1 - sparsity) * 96))))
    got = indexing.topk_indices(t(scores), sparsity, multiple_of, 0.1,
                                keep_mask=t(keep))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    with pytest.raises(ValueError, match='generator'):
        indexing.topk_indices(t(scores), sparsity, multiple_of, 0.1)
    drawn = indexing.topk_indices(t(scores), sparsity, multiple_of, 0.1,
                                  generator=torch.Generator().manual_seed(0))
    assert drawn[2].sum() >= got[2].sum() - keep.sum()


@pytest.mark.parametrize('n_cols', [16, 50])
def test_merge_indices_matches_reference(n_cols):
    rng = np.random.default_rng(n_cols)
    a = rng.integers(0, n_cols, (2, 3, 5)).astype(np.int32)
    b = rng.integers(0, n_cols, (2, 3, 7)).astype(np.int32)
    b[0, 0, 0] = n_cols + 3             # out of range: dropped
    ref = jidx.merge_indices(jnp.asarray(a), jnp.asarray(b), n_cols)
    got = indexing.merge_indices(t(a), t(b), n_cols)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize('block,bm', [(1, 4), (8, 2), (16, 8)])
def test_scatter_add_matches_reference(block, bm):
    rng = np.random.default_rng(block)
    M, jmax, nb = 3, 4, 6
    inds = np.stack([rng.permutation(nb)[:jmax] for _ in range(M)]
                    ).astype(np.int32)
    counts = np.array([1, jmax, 2], np.int32)
    packed = rng.standard_normal((M * bm, jmax * block)).astype(np.float32)
    unpacked = rng.standard_normal((M * bm, nb * block)).astype(np.float32)
    ref = jidx.scatter_add(*map(jnp.asarray, (packed, unpacked, inds,
                                              counts)), block=block)
    got = indexing.scatter_add(t(packed), t(unpacked), t(inds), t(counts),
                               block=block)
    close(got, ref)


@pytest.mark.parametrize('counts', [(5, 0, 13), (1, 16, 8)])
def test_csp_attn_ref_matches_reference(counts):
    """Token-granular indices, an empty group, junk past the counts."""
    rng = np.random.default_rng(sum(counts))
    q = rng.standard_normal((1, 3, 48, 32)).astype(np.float32)
    k, v = (rng.standard_normal((1, 3, 40, 32)).astype(np.float32)
            for _ in range(2))
    inds = np.stack([rng.permutation(40)[:16] for _ in range(9)]
                    ).reshape(1, 3, 3, 16).astype(np.int32)
    cnt = np.array(counts, np.int32).reshape(1, 1, 3).repeat(3, 1)
    ref = jref.csp_attn_ref(*map(jnp.asarray, (q, k, v, inds, cnt)), 16)
    got = attn_ref.csp_attn_ref(t(q), t(k), t(v), t(inds), t(cnt), 16)
    close(got, ref)


@pytest.mark.parametrize('act', ['gelu', 'relu'])
def test_dense_mlp_ref_matches_reference(act):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((32, 24)).astype(np.float32)
    w1 = rng.standard_normal((24, 40)).astype(np.float32) * 0.2
    b1 = rng.standard_normal(40).astype(np.float32)
    w2 = rng.standard_normal((40, 24)).astype(np.float32) * 0.2
    b2 = rng.standard_normal(24).astype(np.float32)
    jact = {} if act == 'gelu' else {'act': jax.nn.relu}
    tact = {} if act == 'gelu' else {'act': torch.relu}
    ref = jmlp.dense_mlp_ref(*map(jnp.asarray, (x, w1, b1, w2, b2)), **jact)
    got = mlp_ref.dense_mlp_ref(t(x), t(w1), t(b1), t(w2), t(b2), **tact)
    for g, r in zip(got, ref):
        close(g, r)


@pytest.mark.parametrize('shape', [(3, 16), (2, 3, 5), (13,)])
def test_flat_bitpack_matches_reference(shape):
    mask = np.random.default_rng(len(shape)).random(shape) < 0.4
    pk_j, shape_j = jbit.bitpack(jnp.asarray(mask))
    pk_t, shape_t = bitpack.bitpack(t(mask))
    assert shape_t == shape_j == shape and pk_t.dtype == torch.uint8
    np.testing.assert_array_equal(pk_t.numpy(), np.asarray(pk_j))
    np.testing.assert_array_equal(bitpack.bitunpack(pk_t, shape).numpy(),
                                  mask)


@pytest.mark.parametrize('h,w,c1,c2', [(16, 24, 8, 4), (8, 8, 4, 2)])
def test_patch_ops_match_reference(h, w, c1, c2):
    from chipmunk_tpu.ops import patch as jpatch
    from chipmunk_torch.ops import patch
    rng = np.random.default_rng(h)
    x = rng.standard_normal((2, h, w)).astype(np.float32)
    flat_j = jpatch.patchify(jnp.asarray(x), c1, c2)
    flat_t = patch.patchify(t(x), c1, c2)
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    np.testing.assert_array_equal(
        patch.unpatchify(flat_t, x.shape, c1, c2).numpy(), x)
    tok = rng.standard_normal((2, 5, h * w, 3)).astype(np.float32)
    for axis in (2, -2):
        got = patch.patchify_tokens(t(tok), h, w, axis, c1, c2)
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jpatch.patchify_tokens(jnp.asarray(tok), h, w, axis, c1, c2)))
        np.testing.assert_array_equal(
            patch.unpatchify_tokens(got, h, w, axis, c1, c2).numpy(), tok)
    pe = rng.standard_normal((1, 1, 7 + h * w, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        patch.patchify_rope(t(pe), h * w, h, w, 2, c1, c2).numpy(),
        np.asarray(jpatch.patchify_rope(jnp.asarray(pe), h * w, h, w, 2, c1,
                                        c2)))


def test_ops_package_exports_the_reference_list():
    import chipmunk_torch.ops as tops
    import chipmunk_tpu.ops as jops
    assert tops.__all__ == jops.__all__
    assert all(callable(getattr(tops, n)) for n in tops.__all__
               if n != 'LOG2E')
