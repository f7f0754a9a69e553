"""SparseDiffAttn / SparseDiffMlp of chipmunk_torch against chipmunk_tpu
(Pallas kernels in interpret mode) over every step kind, on the same
numpy inputs; the port is fed the Bernoulli keep mask that JAX drew."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chipmunk_tpu.config import AttnConfig as JAttnConfig
from chipmunk_tpu.config import MlpConfig as JMlpConfig
from chipmunk_tpu.modules import SparseDiffAttn as JAttn
from chipmunk_tpu.modules import SparseDiffMlp as JMlp
from chipmunk_tpu.utils import quant as jq
from chipmunk_torch.config import AttnConfig, MlpConfig
from chipmunk_torch.kernels import csp_mlp_fused
from chipmunk_torch.modules import SparseDiffAttn, SparseDiffMlp
from chipmunk_torch.ops.attn_ref import PAD_LSE
from chipmunk_torch.utils.quant import QTensor, quantize

mlp_mod = importlib.import_module('chipmunk_torch.modules.mlp')

# float32 on both sides: differences are summation order only
TOL = dict(atol=2e-5, rtol=2e-5)


def t(a):
    return torch.from_numpy(np.array(a))


def assert_tie_free(scores):
    s = np.asarray(scores).reshape(-1, np.asarray(scores).shape[-1])
    assert all(len(np.unique(r)) == len(r) for r in s), 'tied scores'


def test_sparse_attn_matches_reference_over_step_kinds():
    attn_over_step_kinds(mbm=128, kv_block=32)


@pytest.mark.parametrize('mbm,kv_block', [(64, 32), (256, 32), (128, 8)])
def test_sparse_attn_matches_reference_at_other_groups_and_blocks(mbm,
                                                                  kv_block):
    """The same five step kinds at query groups of 64 and 256 rows and at
    8-key blocks (the card's kernels take them all)."""
    attn_over_step_kinds(mbm=mbm, kv_block=kv_block)


def attn_over_step_kinds(mbm, kv_block):
    B, H, S, D = 1, 2, 512, 64
    kw = dict(top_keys=0.4, kv_block=kv_block, counts_multiple_of=32,
              random_keys=0.0, should_compress_indices=False,
              max_selected_frac=1.0, mbm=mbm)
    jmod = JAttn.build(JAttnConfig(**kw), S, use_kernels=True,
                       interpret=True)
    tmod = SparseDiffAttn.build(AttnConfig(**kw), S)
    assert (tmod.jmax, tmod.sel_blocks, tmod.fully_dense) == \
        (jmod.jmax, jmod.sel_blocks, jmod.fully_dense)
    rng = np.random.default_rng(0)
    base = [rng.standard_normal((B, H, S, D)).astype(np.float32)
            for _ in range(3)]
    jst = jmod.init_state(B, H, D, jnp.float32)
    tst = tmod.init_state(B, H, D, torch.float32, device='cpu')
    # step: (index, is_full, is_colsum): first, colsum, sparse, plain
    # full, sparse; the inputs drift a little every step
    for step, full, colsum in [(0, True, False), (1, True, True),
                               (2, False, False), (3, True, False),
                               (4, False, False)]:
        q, k, v = (x + 0.05 * step * rng.standard_normal(x.shape)
                   .astype(np.float32) for x in base)
        if colsum:
            cs = jmod._colsum(*map(jnp.asarray, (q, k, v)), jst.lse)[1]
            assert_tie_free(cs)
        o_j, jst = jmod(*map(jnp.asarray, (q, k, v)), jst, step_index=step,
                        is_full=full, is_colsum=colsum, layer_is_dense=False,
                        key=jax.random.PRNGKey(step))
        o_t, tst = tmod(t(q), t(k), t(v), tst, step_index=step, is_full=full,
                        is_colsum=colsum, layer_is_dense=False)
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
        np.testing.assert_array_equal(tst.inds.numpy(), np.asarray(jst.inds))
        np.testing.assert_array_equal(tst.counts.numpy(),
                                      np.asarray(jst.counts))
        np.testing.assert_allclose(tst.lse.numpy(), np.asarray(jst.lse),
                                   **TOL)
        np.testing.assert_allclose(tst.out_cache.numpy(),
                                   np.asarray(jst.out_cache), **TOL)
    # a layer in the dense prefix: dense attention, state untouched
    o_t, st2 = tmod(t(q), t(k), t(v), tst, step_index=5, is_full=False,
                    is_colsum=False, layer_is_dense=True)
    assert st2 is tst
    o_j, _ = jmod(*map(jnp.asarray, (q, k, v)), jst, step_index=5,
                  is_full=False, is_colsum=False, layer_is_dense=True)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)


@pytest.mark.parametrize('materialize', [True, False])
def test_compressed_static_mask_attn_matches_reference(materialize):
    """Compressed indices (materialized, or packed-only and rebuilt on
    every consuming step), a static mask whose last query group covers
    every key (the exact-dense tail), valid_len 470 of 512 (pad keys cut
    inside a block, pad queries' lse = PAD_LSE) and a random keep: the
    port is fed the Bernoulli mask jax.random drew for the reference."""
    B, H, S, D, kvb = 1, 2, 512, 64, 32
    kw = dict(top_keys=0.25, kv_block=kvb, counts_multiple_of=32,
              random_keys=0.1, should_compress_indices=True,
              materialize_indices=materialize, max_selected_frac=1.0,
              dense_fallback_frac=1.0)
    rng = np.random.default_rng(5)
    static = np.repeat(rng.random((S // 128, S // kvb)) < 0.1, kvb, 1)
    static[:, 440:470] = True            # the text columns
    static[-1, :] = True                  # the dense tail
    jmod = JAttn.build(JAttnConfig(**kw), S,
                       static_mask_tokens=jnp.asarray(static),
                       use_kernels=True, valid_len=470, interpret=True)
    tmod = SparseDiffAttn.build(AttnConfig(**kw), S,
                                static_mask_tokens=static, valid_len=470)
    assert (tmod.jmax, tmod.sel_blocks, tmod.dense_tail_g, tmod.valid_len) \
        == (jmod.jmax, jmod.sel_blocks, jmod.dense_tail_g, jmod.valid_len)
    assert tmod.dense_tail_g == 3 and tmod.materialized == materialize
    base = [rng.standard_normal((B, H, S, D)).astype(np.float32)
            for _ in range(3)]
    jst = jmod.init_state(B, H, D, jnp.float32)
    tst = tmod.init_state(B, H, D, torch.float32, device='cpu')
    nb = S // kvb
    for step, full, colsum in [(0, True, False), (1, True, True),
                               (2, False, False), (3, True, False),
                               (4, False, False), (5, True, True),
                               (6, False, False)]:
        q, k, v = (x + 0.05 * step * rng.standard_normal(x.shape)
                   .astype(np.float32) for x in base)
        key = jax.random.PRNGKey(step)
        keep = None
        if colsum:
            cs = jmod._colsum(*map(jnp.asarray, (q, k, v)), jst.lse)[1]
            assert_tie_free(cs)
            keep = t(np.asarray(jax.random.bernoulli(key, 0.1,
                                                     (B, H, S // 128, nb))))
        o_j, jst = jmod(*map(jnp.asarray, (q, k, v)), jst, step_index=step,
                        is_full=full, is_colsum=colsum, layer_is_dense=False,
                        key=key)
        o_t, tst = tmod(t(q), t(k), t(v), tst, step_index=step, is_full=full,
                        is_colsum=colsum, layer_is_dense=False,
                        keep_mask=keep)
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
        np.testing.assert_array_equal(tst.packed.numpy(),
                                      np.asarray(jst.packed))
        if materialize:
            np.testing.assert_array_equal(tst.inds.numpy(),
                                          np.asarray(jst.inds))
            np.testing.assert_array_equal(tst.counts.numpy(),
                                          np.asarray(jst.counts))
        else:
            assert tst.inds is None and tst.counts is None
        # the rebuild from the packed mask gives the reference's lists
        np.testing.assert_array_equal(
            tmod._stored_inds(tst)[0].numpy(),
            np.asarray(jmod._stored_inds(jst)[0]))
        np.testing.assert_allclose(tst.lse.numpy(), np.asarray(jst.lse),
                                   **TOL)
        assert (tst.lse.numpy()[..., 470:] == PAD_LSE).all()
        np.testing.assert_allclose(tst.out_cache.numpy(),
                                   np.asarray(jst.out_cache), **TOL)


def test_random_and_topk_mask_matches_reference():
    """With the keep mask jax.random drew injected: equal masks, with and
    without the per-group gate and the static mask; a generator draws a
    keep of the same rate."""
    from chipmunk_tpu.ops import indexing as jidx
    from chipmunk_torch.ops import indexing
    rng = np.random.default_rng(4)
    cs = rng.random((1, 2, 4, 64)).astype(np.float32)
    assert_tie_free(cs)
    sqg = np.array([[True], [True], [False], [True]])
    static = rng.random((4, 64)) < 0.1
    key = jax.random.PRNGKey(9)
    keep = np.asarray(jax.random.bernoulli(key, 0.05, cs.shape))
    for g, sm in ((None, None), (sqg, None), (sqg, static)):
        ref = jidx.random_and_topk_mask(
            jnp.asarray(cs), 7, key,
            sparse_query_groups=None if g is None else jnp.asarray(g),
            static_mask=None if sm is None else jnp.asarray(sm),
            random_frac=0.05)
        got = indexing.random_and_topk_mask(
            t(cs), 7, keep_mask=t(keep),
            sparse_query_groups=None if g is None else t(g),
            static_mask=None if sm is None else t(sm), random_frac=0.05)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    drawn = indexing.random_and_topk_mask(
        t(np.zeros((8, 4, 64, 64), np.float32) + np.arange(64)), 0,
        generator=torch.Generator().manual_seed(0), random_frac=0.05)
    assert abs(drawn.float().mean().item() - 0.05) < 5e-3
    assert not indexing.random_and_topk_mask(t(cs), 0,
                                             random_frac=0.0).any()
    with pytest.raises(ValueError, match='generator'):
        indexing.random_and_topk_mask(t(cs), 7, random_frac=0.05)


def test_sparse_mlp_matches_reference_over_step_kinds():
    T, C, N = 256, 64, 512
    kw = dict(top_keys=0.5, random_keys=0.25, neuron_block=128, bm=128,
              mbm=128, counts_multiple_of=128, max_selected_frac=1.0)
    jmod = JMlp.build(JMlpConfig(**kw), T, C, N, use_kernels=True,
                      interpret=True)
    tmod = SparseDiffMlp.build(MlpConfig(**kw), T, C, N)
    assert (tmod.jmax, tmod.sel_blocks, tmod.n_tokens) == \
        (jmod.jmax, jmod.sel_blocks, jmod.n_tokens)
    rng = np.random.default_rng(1)
    w1t = (rng.standard_normal((N, C)) * 0.1).astype(np.float32)
    b1 = (rng.standard_normal(N) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((N, C)) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(C) * 0.1).astype(np.float32)
    W = (w1t, b1, w2, b2)
    jst = jmod.init_state(jnp.float32)
    tst = tmod.init_state(torch.float32, device='cpu')
    x0 = rng.standard_normal((T, C)).astype(np.float32) * 0.5
    M, nb = T // kw['bm'], N // kw['neuron_block']
    # full, sparse+reselect, sparse (cached selection), sparse+reselect
    for step, (full, recompute) in enumerate([(True, False), (False, True),
                                              (False, False), (False, True)]):
        x = x0 + 0.1 * step * rng.standard_normal(x0.shape).astype(np.float32)
        key = jax.random.PRNGKey(10 + step)
        # the draw the reference module makes inside _recompute_indices
        keep = np.asarray(jax.random.bernoulli(key, kw['random_keys'],
                                               (M, nb)))
        if recompute:   # the selection scores of _recompute_indices
            bmx = x.reshape(M, kw['bm'], C).mean(1)       # mbm == bm
            mdiff = np.abs(bmx @ w1t.T + b1 - np.asarray(jst.bm_mid))
            assert_tie_free(mdiff.reshape(M, nb, -1).sum(-1))
        o_j, jst = jmod(jnp.asarray(x), *map(jnp.asarray, W), jst,
                        is_full=full, recompute_mask=recompute,
                        layer_is_dense=False, key=key)
        o_t, tst = tmod(t(x), *map(t, W), tst, is_full=full,
                        recompute_mask=recompute, layer_is_dense=False,
                        keep_mask=t(keep))
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
        np.testing.assert_array_equal(tst.inds.numpy(), np.asarray(jst.inds))
        np.testing.assert_array_equal(tst.counts.numpy(),
                                      np.asarray(jst.counts))
        for name in ('out_cache', 'act_cache', 'bm_mid'):
            np.testing.assert_allclose(getattr(tst, name).numpy(),
                                       np.asarray(getattr(jst, name)), **TOL)
    np.testing.assert_allclose(
        tmod(t(x), *map(t, W), tst, is_full=False, recompute_mask=False,
             layer_is_dense=True)[0].numpy(),
        np.asarray(jmod(jnp.asarray(x), *map(jnp.asarray, W), jst,
                        is_full=False, recompute_mask=False,
                        layer_is_dense=True)[0]), **TOL)


def _qt(w, kind):
    """The reference's int8 or int4 QTensor of an [N, C] weight and the
    port's."""
    qj = jq.quantize(jnp.asarray(w), kind, keep_axes=(0,),
                     pack_axis=1 if kind == 'int4' else None)
    return qj, QTensor(t(qj.q), t(qj.scale), qj.pack_axis)


@pytest.mark.parametrize('kind', ['int8', 'int4'])
@pytest.mark.parametrize('int8_act', [False, True])
def test_sparse_mlp_quantized_weights_match_reference(int8_act, kind):
    """int8 or int4 QTensor weights over every step kind: full steps and
    the selection dequantize (the scale applied in x's dtype), sparse steps
    take the ``wq``/``w4`` path or, with ``int8_act``, the int8-activation
    path.
    inds/counts are equal.  Without int8_act outputs and caches agree to
    2e-5 (float32 on both sides, summation order only).  With it a
    last-bit difference of a float32 cache left by the full step can move
    one quantized delta d8 by one step, which moves that row's outputs by
    sd * |w2q| (measured: largest difference 5.4e-4 on outputs of order
    1, from step 1 on), so the bound is 1e-3 absolute + 2e-5 relative."""
    T, C, N = 256, 128, 512
    kw = dict(top_keys=0.5, random_keys=0.25, neuron_block=128, bm=128,
              mbm=128, counts_multiple_of=128, max_selected_frac=1.0,
              int8_act=int8_act)
    jmod = JMlp.build(JMlpConfig(**kw), T, C, N, use_kernels=True,
                      interpret=True)
    tmod = SparseDiffMlp.build(MlpConfig(**kw), T, C, N)
    rng = np.random.default_rng(2)
    w1t = (rng.standard_normal((N, C)) * 0.1).astype(np.float32)
    b1 = (rng.standard_normal(N) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((N, C)) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(C) * 0.1).astype(np.float32)
    (q1j, q1t), (q2j, q2t) = _qt(w1t, kind), _qt(w2, kind)
    JW = (q1j, jnp.asarray(b1), q2j, jnp.asarray(b2))
    TW = (q1t, t(b1), q2t, t(b2))
    tol = dict(atol=1e-3, rtol=2e-5) if int8_act else TOL
    jst = jmod.init_state(jnp.float32)
    tst = tmod.init_state(torch.float32, device='cpu')
    x0 = rng.standard_normal((T, C)).astype(np.float32) * 0.5
    M, nb = T // kw['bm'], N // kw['neuron_block']
    w1d = np.asarray(jq.dequant(q1j, jnp.float32))
    for step, (full, recompute) in enumerate([(True, False), (False, True),
                                              (False, False), (False, True)]):
        x = x0 + 0.1 * step * rng.standard_normal(x0.shape).astype(np.float32)
        key = jax.random.PRNGKey(20 + step)
        keep = np.asarray(jax.random.bernoulli(key, kw['random_keys'],
                                               (M, nb)))
        if recompute:
            bmx = x.reshape(M, kw['bm'], C).mean(1)
            mdiff = np.abs(bmx @ w1d.T + b1 - np.asarray(jst.bm_mid))
            assert_tie_free(mdiff.reshape(M, nb, -1).sum(-1))
        o_j, jst = jmod(jnp.asarray(x), *JW, jst, is_full=full,
                        recompute_mask=recompute, layer_is_dense=False,
                        key=key)
        o_t, tst = tmod(t(x), *TW, tst, is_full=full,
                        recompute_mask=recompute, layer_is_dense=False,
                        keep_mask=t(keep))
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **tol)
        np.testing.assert_array_equal(tst.inds.numpy(), np.asarray(jst.inds))
        np.testing.assert_array_equal(tst.counts.numpy(),
                                      np.asarray(jst.counts))
        for name in ('out_cache', 'act_cache', 'bm_mid'):
            np.testing.assert_allclose(getattr(tst, name).numpy(),
                                       np.asarray(getattr(jst, name)), **tol)
    np.testing.assert_allclose(
        tmod(t(x), *TW, tst, is_full=False, recompute_mask=False,
             layer_is_dense=True)[0].numpy(),
        np.asarray(jmod(jnp.asarray(x), *JW, jst, is_full=False,
                        recompute_mask=False, layer_is_dense=True)[0]), **TOL)


def test_int8_act_is_decided_per_call_from_the_weights(capsys):
    """As the reference (modules/mlp.py:165-182): with tensor weights the
    module says int8_act is ignored and runs the bf16 path; with int8 or
    int4 QTensors it runs the int8-activation chain; with fp8 QTensors it
    says int8_act is ignored and hands them on, where the kernels refuse
    them."""
    T, C, N = 256, 128, 512
    kw = dict(top_keys=0.5, random_keys=0.0, neuron_block=128, bm=128,
              mbm=128, counts_multiple_of=128, max_selected_frac=1.0)
    on = SparseDiffMlp.build(MlpConfig(**kw, int8_act=True), T, C, N)
    off = SparseDiffMlp.build(MlpConfig(**kw, int8_act=False), T, C, N)
    rng = np.random.default_rng(3)
    x = t(rng.standard_normal((T, C)).astype(np.float32))
    w1t, w2 = (t(rng.standard_normal((N, C)).astype(np.float32) * 0.1)
               for _ in range(2))
    b1 = t(rng.standard_normal(N).astype(np.float32) * 0.1)
    q1, q2 = (quantize(w, 'int8', keep_axes=(0,)) for w in (w1t, w2))
    st = off.init_state(torch.float32, device='cpu')._replace(
        inds=torch.tensor([[0, 2], [1, 3]], dtype=torch.int32),
        counts=torch.tensor([2, 1], dtype=torch.int32))

    def sparse(mod, a, b):
        return mod.sparse_step(x, a, b1, b, st._replace(
            out_cache=st.out_cache.clone(), act_cache=st.act_cache.clone()),
            recompute=False)[0]

    mlp_mod._SAID.clear()
    assert torch.equal(sparse(on, w1t, w2), sparse(off, w1t, w2))
    assert 'mlp.int8_act ignored - MLP weights are Tensor' in \
        capsys.readouterr().out
    q4a, q4b = (quantize(w, 'int4', keep_axes=(0,), pack_axis=1)
                for w in (w1t, w2))
    for a, b in ((q1, q2), (q4a, q4b)):
        got = sparse(on, a, b)
        assert capsys.readouterr().out == ''
        out, _ = csp_mlp_fused(x, a, b1, b, st.act_cache.clone(),
                               st.out_cache.clone(), st.inds, st.counts,
                               bn=128, bm=128, a8=True)
        assert torch.equal(got, out)
        assert not torch.equal(got, sparse(off, a, b))
    f1, f2 = (quantize(w, 'fp8', keep_axes=(0,)) for w in (w1t, w2))
    with pytest.raises(ValueError, match='fp8'):
        sparse(on, f1, f2)
    assert 'int8_act ignored - MLP weights are QTensor' in \
        capsys.readouterr().out
