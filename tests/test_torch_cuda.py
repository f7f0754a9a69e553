"""The CUDA kernels of chipmunk_torch against their plain PyTorch versions
on the card, at small shapes that reach the paths the FLUX shapes do not
(ragged Sq/Sk at the dense kernels' tile edges, B = 2, score blocks of
1-32 and 64/128/256 keys with PAD_LSE rows, query groups other than 128
rows, the attention module over every step kind, large
scores, repeat calls bit-equal, kv_block 1, 2, 4 (16-row packed
slots), 8, 16, 32, 64, 128 and 256, kv_valid inside a group's last or an
earlier block, counts ending inside a tile, clipped counts, NaN in unselected K/V
blocks, bm/bn of 256, bm 64 and 512, fp8 and bf16 caches in every sparse-MLP
kernel, NaN in unselected MLP weight blocks, int8 weights holding all
256 codes, a8 neuron blocks of 384 and 512, the packed-KV csp kernel,
keys and query rows passed as sliced views); and the plain versions of
the FLUX prompt encoders and the three VAE decoders on the card against
the CPU, with a causal conv and a group norm beyond int32 indexing; the
LLaMA-3 trunk and the video prompt wrappers (stand-in tokenizers) on
the card against the CPU; the
checkpoint loaders on the card against the CPU, ``f8_input_matmul``
(``torch._scaled_mm``) against its plain version and ``load_file`` to
the card; the collectives, the sharded FLUX sampler (with and without
FSDP) and HunyuanVideo loops on a world of one NCCL rank against the
unsharded ones, and the ring's hop merge through ``dense_attn``.  The
kernels have no CPU mode, so every test here skips without a GPU.  This file
imports neither jax nor chipmunk_tpu, so it runs on a machine without
them:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerances: bf16 attention outputs to 4e-3 + 2^-6 |ref| (the kernel
rounds p to bf16 against a running max, the plain version against the
row max), the log2-domain lse to 1e-3, column sums to 1e-4 + 1e-3 |ref|,
caches within one ulp of their type, fp8 e4m3 or bf16 (sums in another
order may round a value at a boundary to its neighbour); the
int8-activation kernels' row quantization and quantized deltas bit-equal
where their inputs agree, the probe's int8 product exact."""
import importlib
import os

import pytest
import torch

from chip_smoke import StandInTokenizer, llm_tokenizer, perturbed
from chipmunk_torch.ops import fp8
from chipmunk_torch.ops.attn_ref import PAD_LSE

FA = importlib.import_module('chipmunk_torch.kernels.flash_attention')
CA = importlib.import_module('chipmunk_torch.kernels.csp_attention')
CM = importlib.import_module('chipmunk_torch.kernels.csp_mlp')
PR = importlib.import_module('chipmunk_torch.kernels.int8_probe')
QT = importlib.import_module('chipmunk_torch.utils.quant')
ATOL, RTOL = 4e-3, 2 ** -6


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernels have no CPU mode')
    return torch.Generator('cuda').manual_seed(0)


def randn(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device='cuda') * scale).to(
        torch.bfloat16)


def cache_ulp(mag, dtype):
    """Spacing of the cache type at mag >= 0: fp8 e4m3 (2^-9 below 2^-6)
    or bf16, taken at 2^-13 at least (an act below that is gelu's 1 + tanh
    cancelling in float32, where two tanh a float32 ulp apart differ by
    ~1e-7 |mid|)."""
    if dtype == fp8.FP8:
        return torch.exp2(torch.floor(torch.log2(mag.clamp(min=2.0 ** -6)))
                          - 3)
    return torch.exp2(torch.floor(torch.log2(mag.clamp(min=2.0 ** -13)))
                      - 7)


def assert_fp8_close(got, ref, slack=None):
    """Caches (fp8 e4m3 or bf16): equal NaNs; elsewhere within one ulp of
    their type at the larger magnitude (plus ``slack``), and almost all
    equal."""
    assert got.dtype == ref.dtype
    g, r = got.float(), ref.float()
    assert torch.equal(g.isnan(), r.isnan())
    ok = ~r.isnan()
    ulp = cache_ulp(torch.maximum(g.abs(), r.abs()), got.dtype)
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
                                               (64, 300), (8, None),
                                               (16, 300)])
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
@pytest.mark.parametrize('kv_block,kv_valid', [(128, None), (32, None),
                                               (64, 300), (128, 470),
                                               (8, 470), (16, None)])
def test_cuda_csp_attn_hbm_matches_plain(gen, kv_block, kv_valid):
    """The packed-KV kernel against its plain version on the same packed
    tensor, and through csp_attn(mode='hbm') against the 'vmem' kernel."""
    q, k, v = (randn(gen, 1, 2, 512, 128) for _ in range(3))
    nb, jmax = 512 // kv_block, 3
    inds = torch.rand((1, 2, 4, nb), generator=gen, device='cuda') \
        .argsort(-1)[..., :jmax].to(torch.int32)
    inds[..., 0] = 0                     # a block before kv_valid
    counts = torch.tensor([1, jmax, 2, jmax], device='cuda',
                          dtype=torch.int32).expand(1, 2, 4).contiguous()
    pinds = CA.pad_block_indices(inds, counts)
    kv = CA.pack_kv(k, v, kv_block)
    n0 = CA._build.LAUNCHES['csp_attn_hbm']
    o = CA.csp_attn_hbm(q, kv, pinds, counts, kv_block=kv_block,
                        kv_valid=kv_valid)
    torch.cuda.synchronize()
    assert CA._build.LAUNCHES['csp_attn_hbm'] == n0 + 1
    o_p = CA.csp_attn_hbm_plain(q, kv, pinds, counts, kv_block=kv_block,
                                kv_valid=kv_valid)
    torch.testing.assert_close(o.float(), o_p.float(), atol=ATOL, rtol=RTOL)
    o_h = CA.csp_attn(q, k, v, inds, counts, kv_block=kv_block,
                      kv_valid=kv_valid, mode='hbm')
    o_v = CA.csp_attn(q, k, v, inds, counts, kv_block=kv_block,
                      kv_valid=kv_valid, mode='vmem')
    torch.cuda.synchronize()
    assert torch.equal(o_h, o)
    torch.testing.assert_close(o_h.float(), o_v.float(), atol=ATOL,
                               rtol=RTOL)


def csp_case(gen, kv_block, B=2, H=2, Sq=512, Sk=1024, jmax=None):
    """Distinct random block ids per group and counts of 1, jmax and
    counts whose keys end inside a 128-key tile (3 blocks of 32 or 64,
    jmax blocks of 32); groups 1 and 3 hold the sequence's last block at
    their last and their first position."""
    nb = Sk // kv_block
    jmax = jmax or min(nb, 7)
    G = Sq // 128
    inds = torch.rand((B, H, G, nb), generator=gen, device='cuda') \
        .argsort(-1)[..., :jmax].to(torch.int32)
    counts = torch.tensor([1, jmax, 3, jmax], device='cuda',
                          dtype=torch.int32)[:G].repeat(B, H, 1).contiguous()

    def put_last_at(g, pos):
        row = inds[:, :, g]
        row[row == nb - 1] = row[..., pos:pos + 1].expand_as(row)[
            row == nb - 1]
        row[..., pos] = nb - 1

    put_last_at(1, jmax - 1)
    put_last_at(3, 0)
    return inds, counts


def poison_unselected(k, v, inds, counts, kv_block):
    """NaN in every K/V block that no group of its head selects."""
    B, H, Sk, D = k.shape
    nb = Sk // kv_block
    pinds = CA.pad_block_indices(inds, counts).long()
    sel = torch.zeros((B, H, nb), dtype=torch.bool, device=k.device)
    sel.scatter_(-1, pinds.reshape(B, H, -1), True)
    off = (~sel).repeat_interleave(kv_block, -1)[..., None]
    return k.masked_fill(off, float('nan')), v.masked_fill(off, float('nan'))


@pytest.mark.cuda
@pytest.mark.parametrize('cut', [False, True])
@pytest.mark.parametrize('kv_block', [8, 16, 32, 64, 128, 256])
def test_cuda_csp_kernels_gather(gen, kv_block, cut):
    """Both column-sparse kernels against their plain versions, B = 2:
    kv_block 8, 16, 32, 64, 128 (and 256 for the in-place kernel: from
    16 boxes of 8 rows to one of 128 per key tile), counts of 1
    and jmax and counts ending inside a 128-key tile; with ``cut``,
    kv_valid inside the sequence's last block, which is the last selected
    block of group 1 and the first of group 3; NaN in every block that no
    group selects, and the output finite; two calls bit-equal."""
    Sk = 1024
    q = randn(gen, 2, 2, 512, 128)
    inds, counts = csp_case(gen, kv_block, Sk=Sk)
    k, v = poison_unselected(randn(gen, 2, 2, Sk, 128),
                             randn(gen, 2, 2, Sk, 128), inds, counts,
                             kv_block)
    kv_valid = Sk - kv_block // 2 - 3 if cut else None
    pinds = CA.pad_block_indices(inds, counts)
    pairs = [([CA.csp_attn(q, k, v, inds, counts, kv_block=kv_block,
                           kv_valid=kv_valid, mode='vmem')
               for _ in range(2)],
              CA.csp_attn_plain(q, k, v, pinds, counts, kv_block=kv_block,
                                kv_valid=kv_valid))]
    if kv_block <= 128:
        kv = CA.pack_kv(k, v, kv_block)
        pairs.append(([CA.csp_attn_hbm(q, kv, inds, counts,
                                       kv_block=kv_block, kv_valid=kv_valid)
                       for _ in range(2)],
                      CA.csp_attn_hbm_plain(q, kv, pinds, counts,
                                            kv_block=kv_block,
                                            kv_valid=kv_valid)))
    torch.cuda.synchronize()
    for (a, b), ref in pairs:
        assert bool(ref.isfinite().all()) and bool(a.isfinite().all())
        assert torch.equal(a, b)
        torch.testing.assert_close(a.float(), ref.float(), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.cuda
def test_cuda_csp_kernels_clip_counts_and_ignore_padding(gen):
    """The kernels clip counts to [1, jmax] and never read an index past
    the count, so raw selections (count 0, count above jmax, garbage ids
    past the count) give what the padded, clipped ones give."""
    q, k, v = (randn(gen, 1, 2, 512, 128) for _ in range(3))
    inds, _ = csp_case(gen, 128, B=1, Sk=512, jmax=3)
    raw = torch.tensor([0, 3, 9, 2], device='cuda', dtype=torch.int32) \
        .repeat(1, 2, 1).contiguous()
    clipped = raw.clamp(1, 3)
    pinds = CA.pad_block_indices(inds, clipped)
    junk = inds.clone()
    junk[..., 1:][torch.arange(1, 3, device='cuda') >= clipped[..., None]] \
        = 1 << 20
    kv = CA.pack_kv(k, v, 128)
    for o in (CA.csp_attn(q, k, v, junk, raw, mode='vmem'),
              CA.csp_attn_hbm(q, kv, junk, raw)):
        torch.cuda.synchronize()
        assert torch.equal(o, CA.csp_attn(q, k, v, pinds, clipped,
                                          mode='vmem'))
        torch.testing.assert_close(
            o.float(), CA.csp_attn_plain(q, k, v, pinds, clipped).float(),
            atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_cuda_csp_attn_takes_head_strided_views(gen):
    """q, k and v as slices along S of larger tensors (NaN past the cut):
    the in-place kernel reads them at their head strides and gives what
    it gives on contiguous copies."""
    qf, kf, vf = (randn(gen, 2, 2, 768, 128) for _ in range(3))
    kf[..., 512:, :] = float('nan')
    vf[..., 512:, :] = float('nan')
    q, k, v = qf[..., 256:, :], kf[..., :512, :], vf[..., :512, :]
    inds, counts = csp_case(gen, 64, Sk=512)
    o = CA.csp_attn(q, k, v, inds, counts, kv_block=64, kv_valid=500,
                    mode='vmem')
    o_c = CA.csp_attn(q.contiguous(), k.contiguous(), v.contiguous(), inds,
                      counts, kv_block=64, kv_valid=500, mode='vmem')
    torch.cuda.synchronize()
    assert torch.equal(o, o_c)
    o_p = CA.csp_attn_plain(q, k, v, CA.pad_block_indices(inds, counts),
                            counts, kv_block=64, kv_valid=500)
    torch.testing.assert_close(o.float(), o_p.float(), atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_cuda_csp_kernels_raise_on_what_they_do_not_take(gen):
    """kv_block outside each kernel's set, and mixed dtypes or devices
    raise; nothing falls back to a plain version.  Query groups other than
    128 rows (64, 192, 96) are taken, in both modes, and agree with the
    plain version."""
    q, k, v = (randn(gen, 1, 2, 512, 128) for _ in range(3))
    inds, counts = csp_case(gen, 128, B=1, Sk=512, jmax=3)
    q768 = randn(gen, 1, 2, 768, 128)
    for qg in (64, 192, 96):
        qq = q if 512 % qg == 0 else q768
        G = qq.shape[2] // qg
        gi = torch.rand((1, 2, G, 4), generator=gen, device='cuda') \
            .argsort(-1)[..., :3].to(torch.int32)
        gc = torch.randint(1, 4, (1, 2, G), generator=gen, device='cuda',
                           dtype=torch.int32)
        ref = CA.csp_attn_plain(qq, k, v, CA.pad_block_indices(gi, gc), gc,
                                qg=qg)
        for mode in ('vmem', 'hbm'):
            got = CA.csp_attn(qq, k, v, gi, gc, qg=qg, mode=mode)
            torch.testing.assert_close(got.float(), ref.float(), atol=ATOL,
                                       rtol=RTOL)
    n0 = dict(CA._build.LAUNCHES)
    i96 = torch.zeros((1, 2, 4, 3), dtype=torch.int32, device='cuda')
    kk, vv = k[..., :480, :], v[..., :480, :]
    with pytest.raises(ValueError, match='kv_block'):
        CA.csp_attn(q, kk, vv, i96, counts, kv_block=96, mode='vmem')
    i256 = torch.zeros((1, 2, 4, 1), dtype=torch.int32, device='cuda')
    with pytest.raises(ValueError, match='kv_block'):
        CA.csp_attn_hbm(q, CA.pack_kv(k, v, 256), i256, counts,
                        kv_block=256)
    with pytest.raises(ValueError):
        CA.csp_attn(q, k.float(), v.float(), inds, counts, mode='vmem')
    with pytest.raises(ValueError):
        CA.csp_attn(q, k.cpu(), v.cpu(), inds, counts, mode='vmem')
    with pytest.raises(ValueError):
        CA.csp_attn_hbm(q, CA.pack_kv(k, v, 128).float(), inds, counts)
    assert CA._build.LAUNCHES == n0


@pytest.mark.cuda
@pytest.mark.parametrize('cut', [False, True])
@pytest.mark.parametrize('kv_block', [1, 2, 4])
def test_cuda_csp_kernels_small_blocks(gen, kv_block, cut):
    """kv_block 1, 2 and 4 in both modes (the packed kernel over pack_kv's
    16-row slots, one 8-row box per selected block), B = 2: counts of 1,
    jmax = 40 (three tiles of 16 blocks, the last ragged) and 3; the
    sequence's last block last in group 1 and first in group 3; with
    ``cut``, kv_valid inside that block (kv_block 2 and 4) or just before
    it (1); NaN in every block that no group selects; two calls
    bit-equal; against csp_attn_plain."""
    Sk = 1024
    q = randn(gen, 2, 2, 512, 128)
    inds, counts = csp_case(gen, kv_block, Sk=Sk, jmax=40)
    k, v = poison_unselected(randn(gen, 2, 2, Sk, 128),
                             randn(gen, 2, 2, Sk, 128), inds, counts,
                             kv_block)
    kv_valid = (Sk - max(kv_block // 2, 1)) if cut else None
    pinds = CA.pad_block_indices(inds, counts)
    ref = CA.csp_attn_plain(q, k, v, pinds, counts, kv_block=kv_block,
                            kv_valid=kv_valid)
    kv = CA.pack_kv(k, v, kv_block)
    n0 = dict(CA._build.LAUNCHES)
    runs = [[CA.csp_attn(q, k, v, inds, counts, kv_block=kv_block,
                         kv_valid=kv_valid, mode='vmem') for _ in range(2)],
            [CA.csp_attn_hbm(q, kv, inds, counts, kv_block=kv_block,
                             kv_valid=kv_valid) for _ in range(2)]]
    torch.cuda.synchronize()
    assert CA._build.LAUNCHES['csp_attn_hbm'] == n0['csp_attn_hbm'] + 4
    torch.testing.assert_close(
        CA.csp_attn_hbm_plain(q, kv, pinds, counts, kv_block=kv_block,
                              kv_valid=kv_valid).float(), ref.float(),
        atol=1e-6, rtol=0.0)
    assert bool(ref.isfinite().all())
    for a, b in runs:
        assert bool(a.isfinite().all()) and torch.equal(a, b)
        torch.testing.assert_close(a.float(), ref.float(), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.cuda
def test_cuda_dense_kernels_take_sliced_views(gen):
    """Keys cut at a valid length and the query rows of a dense tail,
    passed as views: the kernels read them at their head strides and give
    what they give on contiguous copies."""
    q, k, v = (randn(gen, 1, 2, 640, 128) for _ in range(3))
    n, t0 = 600, 384
    o, lse = FA.dense_attn(q[..., t0:, :], k[..., :n, :], v[..., :n, :])
    o_c, lse_c = FA.dense_attn(q[..., t0:, :].contiguous(),
                               k[..., :n, :].contiguous(),
                               v[..., :n, :].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(o, o_c) and torch.equal(lse, lse_c)
    o_p, lse_p = FA.dense_attn_plain(q[..., t0:, :], k[..., :n, :],
                                     v[..., :n, :])
    torch.testing.assert_close(o.float(), o_p.float(), atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(lse, lse_p, atol=1e-3, rtol=0)
    prev = lse_c.new_full((1, 2, 640), 9.0)
    prev[..., n:] = PAD_LSE
    out = FA.dense_colsum_attn(q, k[..., :n, :], v[..., :n, :], prev)
    out_c = FA.dense_colsum_attn(q, k[..., :n, :].contiguous(),
                                 v[..., :n, :].contiguous(), prev)
    torch.cuda.synchronize()
    for a, b in zip(out, out_c):
        assert torch.equal(a, b)
    ref = FA.dense_colsum_attn_plain(q, k[..., :n, :], v[..., :n, :], prev)
    torch.testing.assert_close(out[1], ref[1], atol=1e-4, rtol=1e-3)


def assert_attn_close(got, ref):
    """(o, lse) or (o, cs, lse) against the plain version."""
    torch.testing.assert_close(got[0].float(), ref[0].float(), atol=ATOL,
                               rtol=RTOL)
    torch.testing.assert_close(got[-1], ref[-1], atol=1e-3, rtol=0)
    if len(got) == 3:
        torch.testing.assert_close(got[1], ref[1], atol=1e-4, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize('sk', [1, 127, 128, 129, 333])
@pytest.mark.parametrize('sq', [1, 64, 65, 127, 129, 384])
def test_cuda_dense_attn_ragged_edges(gen, sq, sk):
    """Sq and Sk around the 128-row and 128-key tile edges and the 64-row
    halves that each consumer warpgroup owns, B = 2 (heads spaced across
    batch): rows past Sq come in as zeros and are not written, keys past
    Sk are masked."""
    q = randn(gen, 2, 3, sq, 128)
    k, v = randn(gen, 2, 3, sk, 128), randn(gen, 2, 3, sk, 128)
    assert_attn_close(FA.dense_attn(q, k, v), FA.dense_attn_plain(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize('sk', [333, 600])
@pytest.mark.parametrize('score_block', [1, 2, 4, 8, 16, 32, 64, 128, 256])
def test_cuda_dense_colsum_score_blocks(gen, score_block, sk):
    """Score blocks of 1-32 keys (each block's sum stored once by the
    reducers into the CTA's row in global memory), of one half tile, one
    tile and two tiles, B = 2, Sk ragged past the last tile, with PAD_LSE
    rows in both groups (they add exactly 0); a second call bit-equal."""
    q = randn(gen, 2, 2, 256, 128)
    k, v = randn(gen, 2, 2, sk, 128), randn(gen, 2, 2, sk, 128)
    prev = FA.dense_attn_plain(randn(gen, 2, 2, 256, 128), k, v)[1]
    prev[..., 120:128] = PAD_LSE
    prev[..., -9:] = PAD_LSE
    got, again = (FA.dense_colsum_attn(q, k, v, prev,
                                       score_block=score_block)
                  for _ in range(2))
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    assert got[1].shape[-1] == -(-sk // score_block)
    ref = FA.dense_colsum_attn_plain(q, k, v, prev, score_block=score_block)
    assert_attn_close(got, ref)
    pad = prev.clone()
    pad[..., :128] = PAD_LSE             # a group of pad rows only
    cs = FA.dense_colsum_attn(q, k, v, pad, score_block=score_block)[1]
    assert torch.equal(cs[:, :, 0], torch.zeros_like(cs[:, :, 0]))


@pytest.mark.cuda
def test_cuda_dense_kernels_large_scores(gen):
    """Scores of large magnitude that grow along the keys, so the running
    max moves a lot from tile to tile; the column sums against the same
    inputs' lse."""
    q = randn(gen, 1, 2, 256, 128, scale=4.0)
    ramp = torch.linspace(0.2, 3.0, 700, device='cuda')[:, None]
    k = (randn(gen, 1, 2, 700, 128).float() * ramp).to(torch.bfloat16)
    v = randn(gen, 1, 2, 700, 128)
    ref = FA.dense_attn_plain(q, k, v)
    assert_attn_close(FA.dense_attn(q, k, v), ref)
    prev = ref[1]
    assert_attn_close(FA.dense_colsum_attn(q, k, v, prev),
                      FA.dense_colsum_attn_plain(q, k, v, prev))


@pytest.mark.cuda
def test_cuda_dense_kernels_repeat_bit_equal(gen):
    """Two calls on the same inputs give the same bits (the column sums
    too: fixed-order sums, no atomics)."""
    q, k, v = (randn(gen, 1, 2, 384, 128) for _ in range(3))
    kc, vc = k[..., :333, :], v[..., :333, :]
    a, b = FA.dense_attn(q, kc, vc), FA.dense_attn(q, kc, vc)
    prev = a[1].clone()
    c, d = (FA.dense_colsum_attn(q, kc, vc, prev, score_block=64)
            for _ in range(2))
    torch.cuda.synchronize()
    for x, y in zip(a + c, b + d):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_cuda_dense_colsum_raises_past_its_slots(gen):
    """Sk whose column-sum slots would not fit shared memory (score blocks
    of 64 keys or more): the wrapper raises and names the limit."""
    nb_max = FA._build.library('flash_attention').chipmunk_colsum_max_blocks(
        64)
    q = randn(gen, 1, 1, 128, 128)
    k = torch.zeros((1, 1, 64 * nb_max + 1, 128), dtype=torch.bfloat16,
                    device='cuda')
    with pytest.raises(ValueError, match=f'at most {nb_max}'):
        FA.dense_colsum_attn(q, k, k, torch.zeros((1, 1, 128), device='cuda'),
                             score_block=64)


@pytest.mark.cuda
@pytest.mark.parametrize('score_block', [1, 2])
def test_cuda_dense_colsum_small_blocks_past_the_slots(gen, score_block):
    """More score blocks than shared memory has slots for at 64 keys (the
    sums go to global memory below 64): no raise, and the plain version's
    sums."""
    nb = FA._build.library('flash_attention').chipmunk_colsum_max_blocks(
        64) + 77
    sk = nb * score_block - score_block // 2      # the last block ragged
    q = randn(gen, 1, 1, 128, 128)
    k, v = randn(gen, 1, 1, sk, 128), randn(gen, 1, 1, sk, 128)
    prev = FA.dense_attn_plain(randn(gen, 1, 1, 128, 128), k, v)[1]
    prev[..., -3:] = PAD_LSE
    got = FA.dense_colsum_attn(q, k, v, prev, score_block=score_block)
    assert got[1].shape[-1] == nb
    assert_attn_close(got, FA.dense_colsum_attn_plain(
        q, k, v, prev, score_block=score_block))


@pytest.mark.cuda
@pytest.mark.parametrize('qg,score_block', [(64, 128), (192, 64),
                                            (256, 128), (96, 32), (32, 8),
                                            (256, 16), (768, 1)])
def test_cuda_dense_colsum_query_groups(gen, qg, score_block):
    """Query groups other than 128 rows: one CTA a group with rows past
    its end (64, 96, 32), several CTAs a group whose rows are summed by
    colsum_fold_kernel (192, 256, 768); PAD_LSE rows at the end and
    inside a group; two calls bit-equal."""
    q = randn(gen, 1, 2, 768, 128)
    k, v = randn(gen, 1, 2, 333, 128), randn(gen, 1, 2, 333, 128)
    prev = FA.dense_attn_plain(randn(gen, 1, 2, 768, 128), k, v)[1]
    prev[..., 100:110] = PAD_LSE
    prev[..., -9:] = PAD_LSE
    got, again = (FA.dense_colsum_attn(q, k, v, prev, qg=qg,
                                       score_block=score_block)
                  for _ in range(2))
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    assert got[1].shape[2] == 768 // qg
    assert_attn_close(got, FA.dense_colsum_attn_plain(
        q, k, v, prev, qg=qg, score_block=score_block))


@pytest.mark.cuda
@pytest.mark.parametrize('mode', ['vmem', 'hbm'])
@pytest.mark.parametrize('qg,kv_block', [(64, 128), (192, 32), (256, 16),
                                         (96, 64), (32, 2), (384, 8)])
def test_cuda_csp_kernels_query_groups(gen, qg, kv_block, mode):
    """Query groups other than 128 rows in both modes, B = 2: counts of 1
    and jmax, kv_valid inside the last block, NaN in every block no group
    selects; two calls bit-equal; against csp_attn_plain."""
    Sq, Sk = 768, 1024
    G, nb = Sq // qg, Sk // kv_block
    jmax = min(nb, 9)
    q = randn(gen, 2, 2, Sq, 128)
    inds = torch.rand((2, 2, G, nb), generator=gen, device='cuda') \
        .argsort(-1)[..., :jmax].to(torch.int32)
    inds[..., 0, 0] = nb - 1               # the cut block, first
    counts = torch.randint(1, jmax + 1, (2, 2, G), generator=gen,
                           device='cuda', dtype=torch.int32)
    counts[..., 0] = jmax
    counts[..., -1] = 1
    k, v = poison_unselected(randn(gen, 2, 2, Sk, 128),
                             randn(gen, 2, 2, Sk, 128), inds, counts,
                             kv_block)
    kv_valid = Sk - max(kv_block // 2, 1)
    ref = CA.csp_attn_plain(q, k, v, CA.pad_block_indices(inds, counts),
                            counts, qg=qg, kv_block=kv_block,
                            kv_valid=kv_valid)
    a, b = (CA.csp_attn(q, k, v, inds, counts, qg=qg, kv_block=kv_block,
                        kv_valid=kv_valid, mode=mode) for _ in range(2))
    torch.cuda.synchronize()
    assert bool(a.isfinite().all()) and torch.equal(a, b)
    torch.testing.assert_close(a.float(), ref.float(), atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize('mbm,kv_block', [(128, 8), (128, 32), (192, 32)])
def test_cuda_sparse_attn_step_kinds_match_cpu(gen, mbm, kv_block):
    """SparseDiffAttn over every step kind (first full, colsum, sparse,
    plain full, sparse) on the card against the same module on the CPU
    (the plain versions), on the same bf16 inputs: the same selection, o,
    lse and delta cache within the kernels' tolerances."""
    from chipmunk_torch.config import AttnConfig
    from chipmunk_torch.modules import SparseDiffAttn
    B, H, S, D = 1, 2, 768, 128
    mod = SparseDiffAttn.build(AttnConfig(
        top_keys=0.4, kv_block=kv_block, counts_multiple_of=32,
        random_keys=0.0, should_compress_indices=False,
        max_selected_frac=1.0, mbm=mbm), S)
    base = [randn(gen, B, H, S, D) for _ in range(3)]
    st_c = mod.init_state(B, H, D, torch.bfloat16, device='cuda')
    st_p = mod.init_state(B, H, D, torch.bfloat16, device='cpu')
    n0 = dict(FA._build.LAUNCHES)
    for step, full, colsum in [(0, True, False), (1, True, True),
                               (2, False, False), (3, True, False),
                               (4, False, False)]:
        q, k, v = ((x.float() + 0.05 * step * torch.randn(
            x.shape, generator=gen, device='cuda')).to(torch.bfloat16)
            for x in base)
        kw = dict(step_index=step, is_full=full, is_colsum=colsum,
                  layer_is_dense=False)
        o_c, st_c = mod(q, k, v, st_c, **kw)
        o_p, st_p = mod(q.cpu(), k.cpu(), v.cpu(), st_p, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(o_c.float().cpu(), o_p.float(),
                                   atol=ATOL, rtol=RTOL)
        assert torch.equal(st_c.inds.cpu(), st_p.inds)
        assert torch.equal(st_c.counts.cpu(), st_p.counts)
        torch.testing.assert_close(st_c.lse.cpu(), st_p.lse, atol=1e-3,
                                   rtol=0)
        torch.testing.assert_close(st_c.out_cache.float().cpu(),
                                   st_p.out_cache.float(), atol=2 * ATOL,
                                   rtol=RTOL)
    assert FA._build.LAUNCHES['dense_colsum_attn'] == \
        n0['dense_colsum_attn'] + 1
    assert FA._build.LAUNCHES['csp_attn'] > n0['csp_attn']


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


def int8_qt(gen, N, C, scale, kind='int8'):
    """An int8 (or int4, packed along C) QTensor [N, C] with per-row
    scales, as quantize makes."""
    return QT.quantize(randn(gen, N, C, scale=scale).float(), kind,
                       keep_axes=(0,), pack_axis=1 if kind == 'int4' else None)


def mlp_case(gen, T, C, N, bm, bn, jmax=3):
    x = randn(gen, T, C)
    b1 = randn(gen, N, scale=0.1)
    act = fp8.to_fp8(torch.randn((T, N), generator=gen, device='cuda') * 0.3)
    out = fp8.to_fp8(torch.randn((T, C), generator=gen, device='cuda'))
    M = T // bm
    inds = torch.rand((M, N // bn), generator=gen, device='cuda') \
        .argsort(-1)[:, :jmax].to(torch.int32)
    counts = torch.arange(M, device='cuda', dtype=torch.int32) % jmax + 1
    return x, b1, act, out, inds, counts


@pytest.mark.cuda
def test_cuda_quant_rows_matches_plain(gen):
    x = randn(gen, 384, 3072)
    x[5] = 0.0                           # the 1e-6 floor of the scale
    n0 = CM._build.LAUNCHES['quant_rows']
    x8, sx = CM.quant_rows(x)
    torch.cuda.synchronize()
    assert CM._build.LAUNCHES['quant_rows'] == n0 + 1
    x8_p, sx_p = CM.quant_rows_plain(x)
    assert torch.equal(sx, sx_p) and torch.equal(x8, x8_p)


@pytest.mark.cuda
@pytest.mark.parametrize('kind,bm,bn', [
    ('int8', 128, 128), ('int8', 256, 256), ('int8', 512, 256),
    ('int4', 128, 128), ('int4', 256, 256), ('int4', 64, 256)])
def test_cuda_csp_mlp_a8_matches_plain(gen, bm, bn, kind):
    """The int8-activation chain: x8/sx bit-equal; the act cache within
    one e4m3 ulp; d8/sd bit-equal wherever the acts of that (row, block)
    agree; mm2 on the same d8/sd within one e4m3 ulp.  int8 weights take
    the Mm1A8/Mm2A8 pair (bm a multiple of 128), int4 the Mm1A8W4/Mm2A8W4
    one (bm a multiple of 64)."""
    T, C, N = 512, 256, 1024
    x, b1, act, out, inds, counts = mlp_case(gen, T, C, N, bm, bn)
    w1 = int8_qt(gen, N, C, C ** -0.5, kind)
    w2 = int8_qt(gen, N, C, N ** -0.5, kind)
    x8, sx = CM.quant_rows(x)
    d8, sd, act_k = CM.csp_mlp_mm1_a8(x8, sx, w1, b1, w2.scale, act.clone(),
                                      inds, counts, bn=bn, bm=bm)
    torch.cuda.synchronize()
    pinds = CA.pad_block_indices(inds, counts)
    d8_p, sd_p, act_p = CM.csp_mlp_mm1_a8_plain(x8, sx, w1, b1, w2.scale,
                                                act, pinds, counts, bn, bm)
    assert_fp8_close(act_k, act_p)
    M, jmax = inds.shape
    cols = (pinds.long()[:, :, None] * bn
            + torch.arange(bn, device='cuda')).reshape(M, -1)
    cols = cols.repeat_interleave(bm, 0)
    agree = (act_k.float().gather(1, cols) == act_p.float().gather(1, cols)
             ).reshape(T, jmax, bn).all(-1)              # [T, jmax]
    assert agree.float().mean().item() > 0.9
    assert torch.equal(sd[agree], sd_p[agree])
    assert torch.equal(d8.reshape(T, jmax, bn)[agree],
                       d8_p.reshape(T, jmax, bn)[agree])
    out_k = CM.csp_mlp_mm2_a8(d8_p, sd_p, w2, out.clone(), inds, counts,
                              bn=bn, bm=bm)
    torch.cuda.synchronize()
    out_p = CM.csp_mlp_mm2_a8_plain(d8_p, sd_p, w2, out, pinds, counts, bn,
                                    bm)
    assert_fp8_close(out_k, out_p)


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['int8', 'int4'])
@pytest.mark.parametrize('bm,bn', [(128, 128), (256, 256)])
def test_cuda_csp_mlp_wq_matches_plain(gen, bm, bn, kind):
    """int8 or int4 QTensor weights with bf16 activations: the act cache
    within one e4m3 ulp; the out cache within one ulp plus what act flips
    move."""
    T, C, N = 512, 256, 1024
    x, b1, act, out, inds, counts = mlp_case(gen, T, C, N, bm, bn)
    w1 = int8_qt(gen, N, C, C ** -0.5, kind)
    w2 = int8_qt(gen, N, C, N ** -0.5, kind)
    n0 = dict(CM._build.LAUNCHES)
    out_k, act_k = CM.csp_mlp_fused(x, w1, b1, w2, act.clone(), out.clone(),
                                    inds, counts, bn=bn, bm=bm)
    torch.cuda.synchronize()
    tag = 'w4' if kind == 'int4' else 'wq'
    for k in (f'csp_mlp_mm1_{tag}', f'csp_mlp_mm2_{tag}'):
        assert CM._build.LAUNCHES[k] == n0[k] + 1
    assert CM._build.LAUNCHES['csp_mlp_mm1'] == n0['csp_mlp_mm1']
    pinds = CA.pad_block_indices(inds, counts)
    pk, act_p = CM.csp_mlp_mm1_plain(x, w1, b1, act, pinds, counts, bn, bm)
    out_p = CM.csp_mlp_mm2_plain(pk, w2, out, pinds, counts, bn, bm)
    assert_fp8_close(act_k, act_p)
    dact = torch.nan_to_num((act_k.float() - act_p.float()).abs())
    assert_fp8_close(out_k, out_p,
                     dact @ QT.dequant(w2, torch.float32).abs())


@pytest.mark.cuda
@pytest.mark.parametrize('M,K,N', [(256, 512, 384), (384, 208, 640)])
def test_cuda_int8_probe_matches_plain(gen, M, K, N):
    """Both halves on gemm_sm90_kernel: int8 exact, bf16 to its tolerance;
    the second shape is neither square nor a multiple of the tiles (M of
    the s8 CTA's 256 rows, N of the bf16 CTA's 256 columns, K of either
    k slice)."""
    a = torch.randint(-128, 128, (M, K), generator=gen, device='cuda',
                      dtype=torch.int8)
    b = torch.randint(-128, 128, (K, N), generator=gen, device='cuda',
                      dtype=torch.int8)
    c = PR.int8_probe(a, b)
    torch.cuda.synchronize()
    assert torch.equal(c, PR.int8_probe_plain(a, b))
    if K % 8 == 0:
        assert torch.equal(c, torch._int_mm(a, b))
    af, bf = randn(gen, M, K), randn(gen, K, N)
    torch.testing.assert_close(PR.int8_probe(af, bf),
                               PR.int8_probe_plain(af, bf), atol=1e-3,
                               rtol=1e-4)


def agree_blocks(act_k, act_p, pinds, bm, bn):
    """[T, jmax] bool: the two act caches agree on every neuron of the
    (row, selected block)."""
    M, jmax = pinds.shape
    cols = (pinds.long()[:, :, None] * bn
            + torch.arange(bn, device='cuda')).reshape(M, -1)
    cols = cols.repeat_interleave(bm, 0)
    a, b = act_k.float().gather(1, cols), act_p.float().gather(1, cols)
    return ((a == b) | (a.isnan() & b.isnan())).reshape(
        -1, jmax, bn).all(-1)


def check_a8_pair(gen, x, w1, b1, w2, act, out, inds, counts, bm, bn):
    """quant_rows and the a8 pair against their plain versions: act cache
    within one ulp of its type; d8/sd bit-equal where the acts agree (and
    zero past the count); mm2 on the plain d8/sd within one ulp; a second
    call on the same inputs gives the same bits."""
    x8, sx = CM.quant_rows(x)
    runs = [CM.csp_mlp_mm1_a8(x8, sx, w1, b1, w2.scale, act.clone(), inds,
                              counts, bn=bn, bm=bm) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.uint8) if a.dtype == fp8.FP8 else a,
                           b.view(torch.uint8) if b.dtype == fp8.FP8 else b)
    d8, sd, act_k = runs[0]
    pinds = CA.pad_block_indices(inds, counts)
    d8_p, sd_p, act_p = CM.csp_mlp_mm1_a8_plain(x8, sx, w1, b1, w2.scale,
                                                act, pinds, counts, bn, bm)
    assert_fp8_close(act_k, act_p)
    T, jmax = sd.shape
    agree = agree_blocks(act_k, act_p, pinds, bm, bn)
    assert agree.float().mean().item() > 0.9
    assert torch.equal(sd[agree], sd_p[agree])
    assert torch.equal(d8.reshape(T, jmax, bn)[agree],
                       d8_p.reshape(T, jmax, bn)[agree])
    live = (torch.arange(jmax, device='cuda')[None]
            < counts.repeat_interleave(bm)[:, None])
    assert not bool(sd[~live].any())
    assert not bool(d8.reshape(T, jmax, bn)[~live].any())
    outs = [CM.csp_mlp_mm2_a8(d8_p, sd_p, w2, out.clone(), inds, counts,
                              bn=bn, bm=bm) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0].float().nan_to_num(7.0),
                       outs[1].float().nan_to_num(7.0))
    assert_fp8_close(outs[0], CM.csp_mlp_mm2_a8_plain(
        d8_p, sd_p, w2, out, pinds, counts, bn, bm))


CACHES = {'fp8': fp8.FP8, 'bf16': torch.bfloat16}


def cache_pair(gen, T, C, N, act_dt, out_dt):
    act = fp8.cast(torch.randn((T, N), generator=gen, device='cuda') * 0.3,
                   CACHES[act_dt])
    out = fp8.cast(torch.randn((T, C), generator=gen, device='cuda'),
                   CACHES[out_dt])
    return act, out


@pytest.mark.cuda
@pytest.mark.parametrize('cache', ['fp8', 'bf16'])
@pytest.mark.parametrize('bm,bn', [(128, 128), (128, 256), (512, 128),
                                   (512, 256)])
def test_cuda_csp_mlp_a8_hopper(gen, bm, bn, cache):
    """The wgmma/TMA a8 pair: T = 1024, C = 384 (three k stages, three
    column tiles), N = 2048, jmax 4 with counts of 1 and jmax; fp8 or bf16
    caches (both of the type); NaN in the scales and bias of every neuron
    block that no token block selects and 127 in its codes, so a read of
    an unselected block shows.  Gates of check_a8_pair; the launches are
    counted once per call."""
    T, C, N, jmax = 1024, 384, 2048, 4
    M = T // bm
    x = randn(gen, T, C)
    w1 = int8_qt(gen, N, C, C ** -0.5)
    w2 = int8_qt(gen, N, C, N ** -0.5)
    b1 = randn(gen, N, scale=0.1)
    act, out = cache_pair(gen, T, C, N, cache, cache)
    inds = torch.rand((M, N // bn), generator=gen, device='cuda') \
        .argsort(-1)[:, :jmax].to(torch.int32)
    counts = torch.arange(M, device='cuda', dtype=torch.int32) % jmax + 1
    counts[0], counts[-1] = 1, jmax
    used = torch.zeros(N // bn, dtype=torch.bool, device='cuda')
    used[CA.pad_block_indices(inds, counts).long().flatten()] = True
    off = (~used).repeat_interleave(bn)[:, None]
    w1 = QT.QTensor(w1.q.masked_fill(off, 127),
                    w1.scale.masked_fill(off, float('nan')))
    w2 = QT.QTensor(w2.q.masked_fill(off, 127),
                    w2.scale.masked_fill(off, float('nan')))
    b1 = b1.masked_fill(off[:, 0], float('nan'))
    n0 = dict(CM._build.LAUNCHES)
    check_a8_pair(gen, x, w1, b1, w2, act, out, inds, counts, bm, bn)
    for k in ('quant_rows', 'csp_mlp_mm1_a8', 'csp_mlp_mm2_a8'):
        assert CM._build.LAUNCHES[k] == n0[k] + (1 if k == 'quant_rows'
                                                 else 2)


@pytest.mark.cuda
@pytest.mark.parametrize('cache', ['fp8', 'bf16'])
@pytest.mark.parametrize('bm,bn,C', [(64, 256, 256), (64, 128, 512),
                                     (128, 256, 768), (128, 128, 256),
                                     (512, 128, 768), (512, 256, 512)])
def test_cuda_csp_mlp_a8w4_hopper(gen, bm, bn, C, cache):
    """The wgmma/TMA pair of int4 weights and int8 activations
    (csp_mlp_mm1_a8w4: the whole neuron block a CTA, 64 or 128 tokens;
    csp_mlp_mm2_a8w4: 64 tokens x 256 columns of both nibble planes; the
    codes widened to s8 in registers): T = 1024, C = 256, 512 or 768 (a
    nibble plane of 128, 256 or 384 columns), N = 2048, jmax 4 with counts
    of 1 and jmax; fp8 or bf16 caches (both of the type); NaN in the
    scales and bias of every neuron block that no token block selects and
    code 0xFF in its bytes, so a read of one shows.  Gates of
    check_a8_pair; quant_rows launched once, each kernel of the pair
    twice, and no other kernel."""
    T, N, jmax = 1024, 2048, 4
    M = T // bm
    x = randn(gen, T, C)
    w1 = int8_qt(gen, N, C, C ** -0.5, 'int4')
    w2 = int8_qt(gen, N, C, N ** -0.5, 'int4')
    b1 = randn(gen, N, scale=0.1)
    act, out = cache_pair(gen, T, C, N, cache, cache)
    inds = torch.rand((M, N // bn), generator=gen, device='cuda') \
        .argsort(-1)[:, :jmax].to(torch.int32)
    counts = torch.arange(M, device='cuda', dtype=torch.int32) % jmax + 1
    counts[0], counts[-1] = 1, jmax
    used = torch.zeros(N // bn, dtype=torch.bool, device='cuda')
    used[CA.pad_block_indices(inds, counts).long().flatten()] = True
    off = (~used).repeat_interleave(bn)[:, None]
    w1, w2 = (QT.QTensor(w.q.masked_fill(off, 0xFF),
                         w.scale.masked_fill(off, float('nan')), w.pack_axis)
              for w in (w1, w2))
    b1 = b1.masked_fill(off[:, 0], float('nan'))
    n0 = dict(CM._build.LAUNCHES)
    check_a8_pair(gen, x, w1, b1, w2, act, out, inds, counts, bm, bn)
    for k, v in CM._build.LAUNCHES.items():
        want = {'quant_rows': 1, 'csp_mlp_mm1_a8w4': 2,
                'csp_mlp_mm2_a8w4': 2}.get(k, 0)
        assert v == n0[k] + want, k


def bits(t):
    """The raw bits of a tensor of 1- or 2-byte elements (NaN == NaN)."""
    return t.view(torch.uint8 if t.element_size() == 1 else torch.int16)


def check_bf16_pair(x, w1, b1, w2, act, out, inds, counts, bm, bn):
    """The bf16-weight pair against its plain versions: act cache within
    one ulp of its type; the packed delta bit-equal where the acts of the
    (row, block) agree, elsewhere within the act's ulp plus its own bf16
    rounding, zero past the count; mm2 on the plain delta within one ulp
    plus the f32 sum-order slack below; two calls on the same inputs give
    the same bits.

    mm2's kernel and plain version add the same K = jmax * bn products to
    the old entry in f32, in different orders; the two sums differ by
    about sqrt(K) 2^-24 times the sum of the terms' magnitudes, which for
    a tiny bf16 cache entry exceeds its ulp: an entry may differ by twice
    that more."""
    T = x.shape[0]
    jmax = inds.shape[1]
    runs = [CM.csp_mlp_mm1(x, w1, b1, act.clone(), inds, counts, bn=bn,
                           bm=bm) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(bits(a), bits(b))
    pk, act_k = runs[0]
    pinds = CA.pad_block_indices(inds, counts)
    pk_p, act_p = CM.csp_mlp_mm1_plain(x, w1, b1, act, pinds, counts, bn, bm)
    assert_fp8_close(act_k, act_p)
    agree = agree_blocks(act_k, act_p, pinds, bm, bn)
    assert agree.float().mean().item() > 0.9
    same = agree.repeat_interleave(bn, 1)
    g, r = pk.float(), pk_p.float()
    assert torch.equal(g[same], r[same])
    cols = (pinds.long()[:, :, None] * bn + torch.arange(bn, device='cuda')
            ).reshape(T // bm, -1).repeat_interleave(bm, 0)
    a_p = act_p.float().gather(1, cols)
    rnd = 2.0 ** -7 if act.dtype == torch.bfloat16 else 2.0 ** -8
    assert bool(((g - r).abs()[~same]
                 <= cache_ulp(a_p.abs()[~same], act.dtype) * 1.01
                 + torch.maximum(g.abs(), r.abs())[~same] * rnd).all())
    live = (torch.arange(jmax, device='cuda')[None]
            < counts.repeat_interleave(bm)[:, None]).repeat_interleave(bn, 1)
    assert not bool(pk[~live].any())
    outs = [CM.csp_mlp_mm2(pk_p, w2, out.clone(), inds, counts, bn=bn,
                           bm=bm) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(bits(outs[0]), bits(outs[1]))
    M, C = T // bm, out.shape[1]
    rows = CM._rows(pinds, bn)
    pkm = pk_p.reshape(M, bm, -1)
    if isinstance(w2, QT.QTensor):      # the terms: bf16(delta * s) * code
        pkm = pkm * CM._scale(w2)[rows].to(pkm.dtype)[:, None, :]
        w2m = CM._codes(w2).float().abs()[rows]
    else:
        w2m = w2.float().abs()[rows]
    mag = out.float().abs().reshape(M, bm, C) + pkm.float().abs() @ w2m
    slack = 2 * (jmax * bn) ** 0.5 * 2.0 ** -24 * mag.reshape(T, C)
    assert_fp8_close(outs[0], CM.csp_mlp_mm2_plain(pk_p, w2, out, pinds,
                                                   counts, bn, bm), slack)


@pytest.mark.cuda
@pytest.mark.parametrize('cache', ['fp8', 'bf16'])
@pytest.mark.parametrize('bm,bn,C', [(128, 128, 384), (128, 256, 512),
                                     (512, 384, 384), (512, 256, 384),
                                     (512, 128, 512)])
def test_cuda_csp_mlp_bf16_hopper(gen, bm, bn, C, cache):
    """The wgmma/TMA bf16 pair (mm1 in 256- or 128-neuron sub-blocks, mm2
    reading w2 MN-major in 256- or 128-column tiles): T = 1024, C = 384
    (six k stages, three 128-column tiles) or 512, N = 3072, jmax 4 with
    counts of 1 and jmax; fp8 or bf16 caches (both of the type); NaN in
    the weights and bias of every neuron block that no token block
    selects, so a read of one shows.  Gates of check_bf16_pair; the
    launches are counted once per call."""
    T, N, jmax = 1024, 3072, 4
    M = T // bm
    x = randn(gen, T, C)
    w1, w2 = randn(gen, N, C, scale=C ** -0.5), randn(gen, N, C,
                                                      scale=N ** -0.5)
    b1 = randn(gen, N, scale=0.1)
    act, out = cache_pair(gen, T, C, N, cache, cache)
    inds = torch.rand((M, N // bn), generator=gen, device='cuda') \
        .argsort(-1)[:, :jmax].to(torch.int32)
    counts = torch.arange(M, device='cuda', dtype=torch.int32) % jmax + 1
    counts[0], counts[-1] = 1, jmax
    used = torch.zeros(N // bn, dtype=torch.bool, device='cuda')
    used[CA.pad_block_indices(inds, counts).long().flatten()] = True
    off = (~used).repeat_interleave(bn)[:, None]
    w1, w2 = (w.masked_fill(off, float('nan')) for w in (w1, w2))
    b1 = b1.masked_fill(off[:, 0], float('nan'))
    n0 = dict(CM._build.LAUNCHES)
    check_bf16_pair(x, w1, b1, w2, act, out, inds, counts, bm, bn)
    for k in ('csp_mlp_mm1', 'csp_mlp_mm2'):
        assert CM._build.LAUNCHES[k] == n0[k] + 2


@pytest.mark.cuda
@pytest.mark.parametrize('cache', ['fp8', 'bf16'])
@pytest.mark.parametrize('bm,bn,C', [(128, 128, 256), (128, 256, 512),
                                     (512, 384, 768), (512, 256, 768),
                                     (512, 128, 512)])
def test_cuda_csp_mlp_w4_hopper(gen, bm, bn, C, cache):
    """The wgmma/TMA int4-weight pair (csp_mlp_mm1_w4 in 256- or
    128-neuron sub-blocks, csp_mlp_mm2_w4 in 256-column tiles of both
    nibble planes; the packed codes converted to bf16 in shared memory):
    T = 1024, C = 256, 512 or 768 (a nibble plane of 128, 256 or 384
    columns: one mm2 tile's half, two, three), N = 3072, jmax 4 with
    counts of 1 and jmax; fp8 or bf16 caches (both of the type); NaN in
    the scales and bias of every neuron block that no token block selects
    and code 0xFF in its bytes, so a read of one shows.  Gates of
    check_bf16_pair (mm2's sum-order slack over the terms bf16(delta *
    w2s) * code); each kernel is launched twice and no other kernel."""
    T, N, jmax = 1024, 3072, 4
    M = T // bm
    x = randn(gen, T, C)
    w1 = int8_qt(gen, N, C, C ** -0.5, 'int4')
    w2 = int8_qt(gen, N, C, N ** -0.5, 'int4')
    b1 = randn(gen, N, scale=0.1)
    act, out = cache_pair(gen, T, C, N, cache, cache)
    inds = torch.rand((M, N // bn), generator=gen, device='cuda') \
        .argsort(-1)[:, :jmax].to(torch.int32)
    counts = torch.arange(M, device='cuda', dtype=torch.int32) % jmax + 1
    counts[0], counts[-1] = 1, jmax
    used = torch.zeros(N // bn, dtype=torch.bool, device='cuda')
    used[CA.pad_block_indices(inds, counts).long().flatten()] = True
    off = (~used).repeat_interleave(bn)[:, None]
    w1, w2 = (QT.QTensor(w.q.masked_fill(off, 0xFF),
                         w.scale.masked_fill(off, float('nan')), w.pack_axis)
              for w in (w1, w2))
    b1 = b1.masked_fill(off[:, 0], float('nan'))
    n0 = dict(CM._build.LAUNCHES)
    check_bf16_pair(x, w1, b1, w2, act, out, inds, counts, bm, bn)
    for k, v in CM._build.LAUNCHES.items():
        assert v == n0[k] + (2 if k in ('csp_mlp_mm1_w4', 'csp_mlp_mm2_w4')
                             else 0), k


def unselected(inds, counts, N, bn):
    """[N, 1] bool: the rows of the neuron blocks that no token block
    selects."""
    used = torch.zeros(N // bn, dtype=torch.bool, device='cuda')
    used[CA.pad_block_indices(inds, counts).long().flatten()] = True
    return (~used).repeat_interleave(bn)[:, None]


@pytest.mark.cuda
@pytest.mark.parametrize('cache', ['fp8', 'bf16'])
@pytest.mark.parametrize('bm,bn,C', [(128, 128, 256), (128, 256, 384),
                                     (512, 384, 768), (512, 256, 640),
                                     (256, 128, 512)])
def test_cuda_csp_mlp_wq_hopper(gen, bm, bn, C, cache):
    """The wgmma/TMA int8-weight pair with bf16 activations
    (csp_mlp_mm1_wq: 128 neurons x 256 tokens a CTA where bm allows, else
    128; csp_mlp_mm2_wq: 256 output columns a CTA where C allows, else 128;
    the codes converted to bf16 in registers): T = 1024, C = 256 to 768
    (mm2 in one to three 256-column tiles, or three and five of 128),
    N = 3072, jmax 4 with counts of 1 and jmax; fp8 or bf16 caches (both
    of the type); NaN in the scales and bias of every neuron block that
    no token block selects and code 127 in its bytes, so a read of one
    shows.  Gates of check_bf16_pair; each kernel is launched twice and no
    other kernel.  Then csp_mlp_fused, whose mm1 scales the delta for its
    mm2, gives the bits of the two calls alone."""
    T, N, jmax = 1024, 3072, 4
    M = T // bm
    x = randn(gen, T, C)
    w1 = int8_qt(gen, N, C, C ** -0.5)
    w2 = int8_qt(gen, N, C, N ** -0.5)
    b1 = randn(gen, N, scale=0.1)
    act, out = cache_pair(gen, T, C, N, cache, cache)
    inds = torch.rand((M, N // bn), generator=gen, device='cuda') \
        .argsort(-1)[:, :jmax].to(torch.int32)
    counts = torch.arange(M, device='cuda', dtype=torch.int32) % jmax + 1
    counts[0], counts[-1] = 1, jmax
    off = unselected(inds, counts, N, bn)
    w1, w2 = (QT.QTensor(w.q.masked_fill(off, 127),
                         w.scale.masked_fill(off, float('nan')))
              for w in (w1, w2))
    b1 = b1.masked_fill(off[:, 0], float('nan'))
    n0 = dict(CM._build.LAUNCHES)
    check_bf16_pair(x, w1, b1, w2, act, out, inds, counts, bm, bn)
    for k, v in CM._build.LAUNCHES.items():
        assert v == n0[k] + (2 if k in ('csp_mlp_mm1_wq', 'csp_mlp_mm2_wq')
                             else 0), k
    # csp_mlp_fused: mm1 multiplies the delta by bf16(w2s) for mm2, the
    # multiply mm2 makes in place when called alone: the same bits
    pk, act_k = CM.csp_mlp_mm1(x, w1, b1, act.clone(), inds, counts, bn=bn,
                               bm=bm)
    out_k = CM.csp_mlp_mm2(pk, w2, out.clone(), inds, counts, bn=bn, bm=bm)
    out_f, act_f = CM.csp_mlp_fused(x, w1, b1, w2, act.clone(), out.clone(),
                                    inds, counts, bn=bn, bm=bm)
    torch.cuda.synchronize()
    assert torch.equal(bits(act_f), bits(act_k))
    assert torch.equal(bits(out_f), bits(out_k))


@pytest.mark.cuda
@pytest.mark.parametrize('cache', ['fp8', 'bf16'])
def test_cuda_csp_mlp_wq_all_codes(gen, cache):
    """The int8-weight pair on codes that hold every byte value, -128
    (which quantize never emits) included, in each weight row: the
    conversion of a code to bf16 in the kernels' registers is exact for
    all 256.  Gates of check_bf16_pair."""
    T, C, N, bm, bn, jmax = 512, 512, 1024, 256, 256, 3
    x, b1, _, _, inds, counts = mlp_case(gen, T, C, N, bm, bn, jmax)
    act, out = cache_pair(gen, T, C, N, cache, cache)
    codes = (torch.arange(N * C, device='cuda') * 7 % 256 - 128).to(
        torch.int8).reshape(N, C)          # 7 k mod 256: all 256 a row
    assert all(len(torch.unique(r)) == 256 for r in codes[::97])
    w1, w2 = (QT.QTensor(codes, (torch.rand((N, 1), generator=gen,
                                            device='cuda') + 0.5) * s)
              for s in (1 / (74 * C ** 0.5), 1 / (74 * N ** 0.5)))
    check_bf16_pair(x, w1, b1, w2, act, out, inds, counts, bm, bn)


@pytest.mark.cuda
@pytest.mark.parametrize('cache', ['fp8', 'bf16'])
@pytest.mark.parametrize('bn', [384, 512])
@pytest.mark.parametrize('kind,bm', [('int8', 128), ('int8', 512),
                                     ('int4', 64), ('int4', 128)])
def test_cuda_csp_mlp_a8_wide_blocks(gen, kind, bm, bn, cache):
    """The int8-activation pair at neuron blocks wider than 256: mm1 in
    its split mode (sub-blocks of 128 neurons at bn 384, of 256 at bn 512,
    then the pass that forms sd and d8 over the whole block), mm2 flushing
    per block of bn / 128 stages; int8 (Mm1A8Part / Mm2A8) and int4
    (Mm1A8W4Part / Mm2A8W4) weights.  T = 1024, C = 512, N = 3072, jmax 3
    with counts of 1 and jmax; fp8 or bf16 caches; NaN scales and bias
    and code 127 (int4: 0xFF) in every unselected block.  Gates of
    check_a8_pair (d8/sd bit-equal where the acts agree, zero past the
    count); quant_rows launched once, each kernel of the pair twice, and
    no other kernel."""
    T, C, N, jmax = 1024, 512, 3072, 3
    M = T // bm
    x = randn(gen, T, C)
    w1 = int8_qt(gen, N, C, C ** -0.5, kind)
    w2 = int8_qt(gen, N, C, N ** -0.5, kind)
    b1 = randn(gen, N, scale=0.1)
    act, out = cache_pair(gen, T, C, N, cache, cache)
    inds = torch.rand((M, N // bn), generator=gen, device='cuda') \
        .argsort(-1)[:, :jmax].to(torch.int32)
    counts = torch.arange(M, device='cuda', dtype=torch.int32) % jmax + 1
    counts[0], counts[-1] = 1, jmax
    off = unselected(inds, counts, N, bn)
    code = 0xFF if kind == 'int4' else 127
    w1, w2 = (QT.QTensor(w.q.masked_fill(off, code),
                         w.scale.masked_fill(off, float('nan')), w.pack_axis)
              for w in (w1, w2))
    b1 = b1.masked_fill(off[:, 0], float('nan'))
    n0 = dict(CM._build.LAUNCHES)
    check_a8_pair(gen, x, w1, b1, w2, act, out, inds, counts, bm, bn)
    tag = 'a8w4' if kind == 'int4' else 'a8'
    for k, v in CM._build.LAUNCHES.items():
        want = {'quant_rows': 1, f'csp_mlp_mm1_{tag}': 2,
                f'csp_mlp_mm2_{tag}': 2}.get(k, 0)
        assert v == n0[k] + want, k


@pytest.mark.cuda
@pytest.mark.parametrize('caches', [('bf16', 'bf16'), ('fp8', 'bf16')])
@pytest.mark.parametrize('variant', ['bf16', 'int8', 'int4', 'a8w4'])
def test_cuda_csp_mlp_bf16_caches(gen, variant, caches):
    """The other sparse-MLP kernels with a bf16 out cache and a bf16 or fp8
    act cache: the act cache within one ulp of its type; the packed delta
    bit-equal where the acts agree (a8w4: d8/sd), elsewhere within the
    act's ulp; mm2 on the plain delta within one ulp."""
    T, C, N, bm, bn = 512, 256, 1024, 128, 128
    x, b1, _, _, inds, counts = mlp_case(gen, T, C, N, bm, bn)
    act, out = cache_pair(gen, T, C, N, *caches)
    if variant == 'bf16':
        w1, w2 = randn(gen, N, C, scale=C ** -0.5), randn(gen, N, C,
                                                          scale=N ** -0.5)
    else:
        kind = 'int8' if variant == 'int8' else 'int4'
        w1 = int8_qt(gen, N, C, C ** -0.5, kind)
        w2 = int8_qt(gen, N, C, N ** -0.5, kind)
    if variant == 'a8w4':
        check_a8_pair(gen, x, w1, b1, w2, act, out, inds, counts, bm, bn)
        return
    pinds = CA.pad_block_indices(inds, counts)
    pk, act_k = CM.csp_mlp_mm1(x, w1, b1, act.clone(), inds, counts, bn=bn,
                               bm=bm)
    torch.cuda.synchronize()
    pk_p, act_p = CM.csp_mlp_mm1_plain(x, w1, b1, act, pinds, counts, bn, bm)
    assert_fp8_close(act_k, act_p)
    same = agree_blocks(act_k, act_p, pinds, bm, bn).repeat_interleave(bn, 1)
    g, r = pk.float(), pk_p.float()
    assert torch.equal(g[same], r[same])
    cols = (pinds.long()[:, :, None] * bn + torch.arange(bn, device='cuda')
            ).reshape(T // bm, -1).repeat_interleave(bm, 0)
    a_p = act_p.float().gather(1, cols)
    rnd = 2.0 ** -7 if act.dtype == torch.bfloat16 else 2.0 ** -8
    assert bool(((g - r).abs()[~same]
                 <= cache_ulp(a_p.abs()[~same], act.dtype) * 1.01
                 + torch.maximum(g.abs(), r.abs())[~same] * rnd).all())
    out_k = CM.csp_mlp_mm2(pk_p, w2, out.clone(), inds, counts, bn=bn, bm=bm)
    torch.cuda.synchronize()
    assert_fp8_close(out_k, CM.csp_mlp_mm2_plain(pk_p, w2, out, pinds, counts,
                                                 bn, bm))


@pytest.mark.cuda
def test_cuda_fp8_writes_keep_the_reference_overflow_rule(gen):
    """An fp8 cache write on the card rounds as the reference's astype:
    to nearest even up to 464 (448 for 448 < |x| <= 464, the tie at 464
    included), NaN past 464 (bit-equal to the plain version elsewhere,
    NaN at the same places); here through
    csp_mlp_mm2, whose out cache is old + delta @ w2 with w2 the identity
    on the selected block, so each entry is old + one delta."""
    T, C, N, bn = 128, 256, 256, 128
    deltas = torch.tensor([0.0, 10.0, 15.0, 16.0, 17.0, 30.0, -900.0,
                           -1.0, 1e30, -17.0, 2.0 ** -12], device='cuda')
    old = torch.full((T, C), 448.0, device='cuda')
    old[1::2] = -448.0                  # odd rows: the negative side
    packed = torch.zeros((T, bn), device='cuda')
    packed[:, :len(deltas)] = deltas
    packed[1::2] *= -1
    packed = packed.to(torch.bfloat16)
    w2 = torch.zeros((N, C), device='cuda')
    w2[torch.arange(bn), torch.arange(bn)] = 1.0
    w2 = w2.to(torch.bfloat16)
    inds = torch.zeros((1, 1), dtype=torch.int32, device='cuda')
    counts = torch.ones((1,), dtype=torch.int32, device='cuda')
    out = fp8.to_fp8(old)
    got = CM.csp_mlp_mm2(packed, w2, out.clone(), inds, counts, bn=bn, bm=T)
    torch.cuda.synchronize()
    ref = CM.csp_mlp_mm2_plain(packed, w2, out, inds, counts, bn, T)
    g, r = got.float(), ref.float()
    assert torch.equal(g.isnan(), r.isnan())
    ok = ~r.isnan()
    assert torch.equal(got.view(torch.uint8)[ok], ref.view(torch.uint8)[ok])
    assert bool(g[:, 5].isnan().all())                  # 448 + 30 > 464
    assert bool((g[:, 3].abs() == 448).all())           # 448 + 16: the tie


@pytest.mark.cuda
@pytest.mark.parametrize('mode', ['vmem', 'hbm'])
def test_cuda_csp_kernels_wan_heads_cut_last_block(gen, mode):
    """Wan's geometry on a shorter sequence: 12 heads, kv_block 128, jmax
    62, keys cut at 8 rows before the end (120 valid rows in the last
    block).  Group 1 of every head selects jmax blocks including the cut
    one, group 2 that block alone (a count of 1), the other groups
    random counts (the first of 62 sorted blocks of 64 lies before the
    cut).  Against the plain version, and repeat calls bit-equal."""
    H, S, jmax = 12, 8192, 62
    nb, n = S // 128, S - 8
    q, k, v = (randn(gen, 1, H, S, 128) for _ in range(3))
    G = S // 128
    inds = torch.rand((1, H, G, nb), generator=gen, device='cuda') \
        .argsort(-1)[..., :jmax].sort(-1)[0].to(torch.int32)
    counts = torch.randint(1, jmax + 1, (1, H, G), generator=gen,
                           device='cuda', dtype=torch.int32)
    for h in range(H):
        pick = torch.randperm(nb - 1, generator=gen, device='cuda')[
            :jmax - 1]
        inds[0, h, 1] = torch.cat([pick, pick.new_tensor([nb - 1])]) \
            .sort()[0].to(torch.int32)
    inds[..., 2, :] = nb - 1
    counts[..., 1], counts[..., 2] = jmax, 1
    a, b = (CA.csp_attn(q, k, v, inds, counts, kv_valid=n, mode=mode)
            for _ in range(2))
    torch.cuda.synchronize()
    assert bool(a.isfinite().all()) and torch.equal(a, b)
    ref = CA.csp_attn_plain(q, k, v, CA.pad_block_indices(inds, counts),
                            counts, kv_valid=n)
    torch.testing.assert_close(a.float(), ref.float(), atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_cuda_dense_attn_wan_cross_attention(gen):
    """Wan's cross-attention: 32,768 queries over 512 text keys, 12
    heads (256 query tiles a head over a 4-tile key loop), against the
    plain version on head 0; repeat calls bit-equal."""
    q = randn(gen, 1, 12, 32768, 128)
    k, v = randn(gen, 1, 12, 512, 128), randn(gen, 1, 12, 512, 128)
    (o, lse), (o2, lse2) = (FA.dense_attn(q, k, v) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    o_p, lse_p = FA.dense_attn_plain(q[:, :1], k[:, :1], v[:, :1])
    torch.testing.assert_close(o[:, :1].float(), o_p.float(), atol=ATOL,
                               rtol=RTOL)
    torch.testing.assert_close(lse[:, :1], lse_p, atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize('mode', ['auto', 'hbm'])
def test_cuda_wan_small_matches_cpu(gen, mode):
    """A small Wan with full-width heads (dim 1536, 12 heads of 128), 2
    layers, latent (5, 16, 30): 600 tokens + 40 pad, for 4 steps of
    wan_denoise (first, colsum, two sparse) on the card against the same
    weights and inputs on the CPU (the plain versions), bf16: mean
    relative difference <= 2e-2; the mode's csp kernel launched."""
    import chipmunk_torch.models as tm
    from chipmunk_torch.config import config_from_dict, load_config
    ck = config_from_dict({
        'steps': 4,
        'attn': {'full_step_schedule': [0, 1], 'first_n_dense_layers': 1,
                 'top_keys': 0.3, 'random_keys': 0.0, 'local_voxels': 1,
                 'dense_fallback_frac': 1.0},
        'step_caching': {'is_enabled': False}},
        load_config(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), 'configs', 'wan-chipmunk.yml')))
    cfg = tm.WanModelConfig(latent_t=5, latent_h=16, latent_w=30,
                            num_layers=2)
    g = torch.Generator().manual_seed(0)
    params = tm.init_wan_params(g, cfg, 'cpu')
    lat = torch.randn((1, 16, 5, 16, 30), generator=g)
    ctx = torch.randn((2, 1, 512, 4096), generator=g).to(torch.bfloat16)
    ctx[1, :, 27:] = 0
    ts = tm.get_schedule(4, cfg.seq_len, shift=False)
    out_p = tm.wan_denoise(tm.WanModel(cfg=cfg, ck=ck, device='cpu'),
                           params, lat, ctx[0], ctx[1], ts)

    def move(t):
        return ({k: move(v) for k, v in t.items()} if isinstance(t, dict)
                else [move(v) for v in t] if isinstance(t, list)
                else t.cuda())

    n0 = dict(FA._build.LAUNCHES)
    out = tm.wan_denoise(tm.WanModel(cfg=cfg, ck=ck, csp_mode=mode),
                         move(params), lat.cuda(), ctx[0].cuda(),
                         ctx[1].cuda(), ts)
    rel = ((out.cpu() - out_p).abs().mean() / out_p.abs().mean()).item()
    assert rel <= 2e-2, rel
    csp = 'csp_attn_hbm' if mode == 'hbm' else 'csp_attn'
    assert FA._build.LAUNCHES[csp] > n0[csp]
    assert FA._build.LAUNCHES['dense_colsum_attn'] > n0['dense_colsum_attn']


# ------------------------------------------------- compiled loops (graphs)

def _small_flux(steps=8):
    """A narrow FLUX (hidden 256, 2 heads of 128, depth 1+1, no dense
    layer, 128 text + 384 image tokens) with random keeps in both modules
    (compressed attention indices, MLP re-selection) and a skipped step,
    bf16 weights drawn on the CPU; returns (model, ck, params_cpu, img,
    txt, y)."""
    import chipmunk_torch.models as tm
    from chipmunk_torch.config import config_from_dict
    model = tm.FluxModelConfig(
        in_channels=16, vec_in_dim=32, context_in_dim=32, hidden_size=256,
        num_heads=2, depth=1, depth_single_blocks=1, axes_dim=(16, 56, 56),
        guidance_embed=False, txt_len=128)
    ck = config_from_dict({
        'steps': steps,
        'attn': {'top_keys': 0.4, 'random_keys': 0.1, 'full_step_every': 3,
                 'first_n_dense_layers': 0, 'should_compress_indices': True,
                 'dense_fallback_frac': 1.0},
        'mlp': {'top_keys': 0.5, 'random_keys': 0.1, 'full_step_every': 3,
                'first_n_dense_layers': 0, 'counts_multiple_of': 128},
        'patchify': {'chunk_size_1': 4, 'chunk_size_2': 2},
        'step_caching': {'is_enabled': True, 'skip_step_schedule': {4}}})
    g = torch.Generator().manual_seed(0)
    params = tm.init_flux_params(g, model, 'cpu')
    img, txt, y = (torch.randn(s, generator=g)
                   for s in ((1, 384, 16), (1, 128, 32), (1, 32)))
    return model, ck, params, img, txt, y


def _to_cuda(t):
    return ({k: _to_cuda(v) for k, v in t.items()} if isinstance(t, dict)
            else [_to_cuda(v) for v in t] if isinstance(t, list)
            else t.cuda())


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['sparse', 'colsum'])
def test_cuda_step_graph_replay_is_bit_equal_to_eager(gen, kind):
    """One step of the small FLUX from the same state, inputs and seed:
    eagerly, and as StepGraphs' replay (its first occurrence eager, the
    second captured and replayed): the prediction and every state leaf
    bit-equal.  The colsum step draws attention keeps, the sparse step
    re-selects MLP neurons (MLP keeps)."""
    import chipmunk_torch.models as tm
    from chipmunk_torch.models.step_graphs import (StepGraphs, _leaves,
                                                   carry_state)
    model, ck, params, img, txt, y = _small_flux()
    params, txt, y = _to_cuda(params), txt.cuda(), y.cuda()
    sp = tm.FluxSparse.build(ck, model, 512)
    sampler = tm.FluxSampler(cfg=model, ck=ck, sp=sp, h_img=16, w_img=24)
    pe = sampler.rope(1)
    lat = sampler.patchify_img(img.cuda()).float()
    t_vec = torch.full((1,), 0.7, device='cuda')
    state = sp.init_state(model, 1, 'cuda')
    loop_gen = torch.Generator('cuda').manual_seed(1)

    def forward(step):
        pred, new = tm.flux_forward(params, model, sp, lat, txt, t_vec, y,
                                    pe, state, step, generator=loop_gen)
        carry_state(state, new)
        return pred

    for step in (tm.FluxStep(0, True, True, False, False),
                 tm.FluxStep(1, True, False, True, True)):
        forward(step)
    step = (tm.FluxStep(2, False, False, False, True) if kind == 'sparse'
            else tm.FluxStep(2, True, False, True, False))
    leaves = [t for t in _leaves(state) if t is not None]
    saved = [t.clone() for t in leaves]

    def restore():
        for t, s in zip(leaves, saved):
            t.copy_(s)
        loop_gen.manual_seed(5)

    restore()
    want = forward(step).clone()
    want_state = [t.clone() for t in leaves]
    out = torch.empty_like(want)
    graphs = StepGraphs(torch.device('cuda'), loop_gen, keeps=True)
    restore()
    graphs.run(step, lambda: out.copy_(forward(step)))      # eager
    restore()
    graphs.run(step, lambda: out.copy_(forward(step)))      # capture
    torch.cuda.synchronize()
    assert (len(graphs.graphs), graphs.replays, graphs.eager) == (1, 1, 1)
    assert torch.equal(out, want)
    for a, b in zip(leaves, want_state):
        assert torch.equal(fp8.raw(a), fp8.raw(b))


@pytest.mark.cuda
def test_cuda_registered_generator_draws_fresh_keeps_in_replays(gen):
    """random_and_topk_mask from a registered generator: the eager draw
    and then two replays of its graph give the masks three eager draws
    from the same seed give, and the two replays differ."""
    from chipmunk_torch.models.step_graphs import StepGraphs
    from chipmunk_torch.ops import indexing
    cs = torch.rand((1, 2, 4, 32), generator=gen, device='cuda')
    g = torch.Generator('cuda').manual_seed(7)
    want = [indexing.random_and_topk_mask(cs, 4, generator=g,
                                          random_frac=0.3)
            for _ in range(3)]
    out = torch.zeros_like(want[0])
    graphs = StepGraphs(torch.device('cuda'), g, keeps=True)
    g.manual_seed(7)
    got = []
    for _ in range(3):
        graphs.run('draw', lambda: out.copy_(indexing.random_and_topk_mask(
            cs, 4, generator=g, random_frac=0.3)))
        got.append(out.clone())
    assert graphs.replays == 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not torch.equal(got[1], got[2])


@pytest.mark.cuda
def test_cuda_failed_capture_raises(gen):
    """A step that syncs with the host (``.item()``) runs eagerly at its
    first occurrence, and its capture raises, every time: the runner never
    falls back to eager on the card, and counts no launch for it."""
    from chipmunk_torch.models.step_graphs import StepGraphs
    x = torch.ones(4, device='cuda')
    seen = []
    graphs = StepGraphs(torch.device('cuda'))
    n0 = dict(FA._build.LAUNCHES)
    graphs.run('sync', lambda: seen.append(x.sum().item()))
    for _ in range(2):
        with pytest.raises(RuntimeError):
            graphs.run('sync', lambda: seen.append(x.sum().item()))
    assert seen == [4.0] and not graphs.graphs and graphs.replays == 0
    assert dict(FA._build.LAUNCHES) == n0
    torch.cuda.synchronize()
    assert x.sum().item() == 4.0            # the card still works


@pytest.mark.cuda
@pytest.mark.parametrize('skip', [False, True])
@pytest.mark.parametrize('model', ['flux', 'wan'])
def test_cuda_compiled_loop_matches_host_loop(gen, model, skip):
    """The small FLUX (8 steps) and a small Wan (2 layers, 6 steps) with
    random keeps: the compiled loop against the host loop on the card,
    same seed: the same launches, kernel by kernel, and graphs replayed.
    With no skipped step the two compute the same thing and agree bit for
    bit.  With one (folded into the step before it) the latent's float32
    Euler sums round differently, which the bf16 model input and the
    top-k selections downstream amplify: mean relative difference <=
    1e-2."""
    import chipmunk_torch.models as tm
    from chipmunk_torch.config import config_from_dict, load_config
    from chipmunk_torch.models.step_graphs import GRAPH_STATS
    caching = {'is_enabled': skip, 'skip_step_schedule': [3]}
    if model == 'flux':
        cfg, ck, params, img, txt, y = _small_flux()
        ck = config_from_dict({'step_caching': caching}, ck)
        sampler = tm.FluxSampler(cfg=cfg, ck=ck,
                                 sp=tm.FluxSparse.build(ck, cfg, 512),
                                 h_img=16, w_img=24)
        args = (_to_cuda(params), img.cuda(), txt.cuda(), y.cuda(),
                tm.get_schedule(8, 384))
        loops = (sampler.denoise, sampler.denoise_compiled)
    else:
        ck = config_from_dict({
            'steps': 6,
            'attn': {'full_step_schedule': [0, 1, 4],
                     'first_n_dense_layers': 1, 'top_keys': 0.3,
                     'random_keys': 0.05, 'local_voxels': 1,
                     'dense_fallback_frac': 1.0},
            'step_caching': caching},
            load_config(os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), 'configs', 'wan-chipmunk.yml')))
        cfg = tm.WanModelConfig(latent_t=5, latent_h=16, latent_w=30,
                                num_layers=2)
        g = torch.Generator().manual_seed(0)
        params = tm.init_wan_params(g, cfg, 'cpu')
        lat = torch.randn((1, 16, 5, 16, 30), generator=g)
        ctx = torch.randn((2, 1, 512, 4096), generator=g).to(torch.bfloat16)
        m = tm.WanModel(cfg=cfg, ck=ck)
        args = (m, _to_cuda(params), lat.cuda(), ctx[0].cuda(),
                ctx[1].cuda(), tm.get_schedule(6, cfg.seq_len, shift=False))
        loops = (tm.wan_denoise, tm.wan_denoise_compiled)
    outs, launches = [], []
    for loop in loops:
        FA._build.reset_launches()
        outs.append(loop(*args, generator=torch.Generator(
            'cuda').manual_seed(3)))
        launches.append(dict(FA._build.LAUNCHES))
    assert launches[0] == launches[1]
    assert launches[0]['csp_attn'] > 0 and launches[0]['dense_colsum_attn']
    assert GRAPH_STATS['replays'] > 0 and GRAPH_STATS['graphs'] > 0
    assert torch.isfinite(outs[1]).all()
    if not skip:
        assert torch.equal(outs[0], outs[1])
    rel = ((outs[1] - outs[0]).abs().mean() / outs[0].abs().mean()).item()
    assert rel <= 1e-2, rel


@pytest.mark.cuda
def test_cuda_flux_encoders_match_cpu(gen):
    """A 2-layer T5-v1.1 (dim 256, 4 heads) with a partial mask and a
    2-layer CLIP text model (width 256) with EOT-valued padding, float32,
    perturbed weights: the card against the CPU to 1e-4 (float32 matmuls,
    summed in another order)."""
    import chipmunk_torch.models as tm
    g = torch.Generator().manual_seed(0)
    t5 = tm.T5Config(vocab_size=512, dim=256, d_kv=64, dim_ffn=512,
                     num_heads=4, num_layers=2)
    tp = perturbed(torch, tm.init_t5_params(g, t5, 'cpu'), g)
    ids = torch.randint(0, 512, (2, 64), generator=g)
    mask = (torch.arange(64)[None] < torch.tensor([[64], [21]])).long()
    ref = tm.t5_encode(tp, ids, mask, t5)
    got = tm.t5_encode(_to_cuda(tp), ids.cuda(), mask.cuda(), t5)
    torch.testing.assert_close(got.cpu(), ref, atol=1e-4, rtol=1e-4)
    clip = tm.ClipTextConfig(vocab_size=512, width=256, num_heads=4,
                             num_layers=2)
    cp = perturbed(torch, tm.init_clip_params(g, clip, 'cpu'), g)
    cids = torch.randint(0, 511, (2, 77), generator=g)
    cids[0, 30:], cids[1, 9:] = 511, 511
    ref = tm.clip_text_encode(cp, cids, clip)
    got = tm.clip_text_encode(_to_cuda(cp), cids.cuda(), clip)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_llama_trunk_matches_cpu(gen):
    """A 2-layer LLaMA-3 trunk (hidden 1024, 8 heads over 2 key/value
    heads, SwiGLU 2816, theta 500,000, a right-padded batch), perturbed
    weights: float32 on the card against the CPU to 1e-4; bf16 on the
    card against float32 on the CPU within a mean relative difference of
    2e-2 and a largest difference of 2e-2 of the largest magnitude."""
    import dataclasses
    import chipmunk_torch.models as tm
    g = torch.Generator().manual_seed(2)
    cfg = tm.LlamaConfig(vocab_size=1000, hidden_size=1024,
                         num_hidden_layers=2, num_attention_heads=8,
                         num_key_value_heads=2, intermediate_size=2816)
    p = perturbed(torch, tm.init_llama_params(g, cfg, 'cpu'), g)
    ids = torch.randint(0, 1000, (2, 96), generator=g)
    mask = (torch.arange(96)[None] < torch.tensor([[96], [41]])).int()
    ref = tm.llama_hidden_states(p, ids, mask, cfg)
    got = tm.llama_hidden_states(_to_cuda(p), ids.cuda(), mask.cuda(), cfg)
    assert len(got) == 3
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)
    b16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    pb = {'embed': p['embed'].to('cuda', torch.bfloat16),
          'layers': [{k: v.to('cuda', torch.bfloat16) for k, v in l.items()}
                     for l in p['layers']],
          'norm': p['norm'].to('cuda', torch.bfloat16)}
    got = tm.llama_hidden_states(pb, ids.cuda(), mask.cuda(), b16)
    for a, b in zip(got, ref):
        d = (a.float().cpu() - b).abs()
        assert d.mean() <= 2e-2 * b.abs().mean()
        assert d.max() <= 2e-2 * b.abs().max()


@pytest.mark.cuda
def test_cuda_prompt_wrappers_match_cpu(gen):
    """HunyuanTextEncoders.embed (a 3-layer LLaMA of width 256 under the
    video template, a 2-layer CLIP of width 256) and WanTextEncoder.embed
    (a 2-layer UMT5 of width 256), float32, the same weights and stand-in
    tokenizers: the card against the CPU to 1e-4, the mask equal, the
    pooled row the first EOT's."""
    import dataclasses
    import chipmunk_torch.models as tm
    g = torch.Generator().manual_seed(3)
    lcfg = tm.LlamaConfig(vocab_size=500, hidden_size=256,
                          num_hidden_layers=3, num_attention_heads=2,
                          num_key_value_heads=1, intermediate_size=512)
    ccfg = tm.ClipTextConfig(vocab_size=500, width=256, num_heads=4,
                             num_layers=2, eos_token_id=499)
    lp = perturbed(torch, tm.init_llama_params(g, lcfg, 'cpu'), g)
    cp = perturbed(torch, tm.init_clip_params(g, ccfg, 'cpu'), g)
    outs = []
    for dev, conv in (('cpu', lambda t: t), ('cuda', _to_cuda)):
        h = tm.HunyuanTextEncoders(max_length=95 + 64, dtype=torch.float32,
                                   device=dev)
        h._llm, h._clip = (conv(lp), lcfg), (conv(cp), ccfg)
        h._llm_tok = llm_tokenizer(500)
        h._clip_tok = StandInTokenizer(500, 499, eot=499)
        outs.append(h.embed(['a cat on the grass', 'a red fox']))
    for a, b in zip(outs[1], outs[0]):
        assert a.device.type == 'cuda'
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)
    assert outs[1][1].sum(1).tolist() == [28, 19]
    ucfg = tm.UMT5Config(vocab_size=500, dim=256, dim_attn=256, dim_ffn=512,
                         num_heads=4, num_layers=2)
    up = perturbed(torch, tm.init_umt5_params(g, ucfg, 'cpu'), g)
    ctx = []
    for dev, conv in (('cpu', lambda t: t), ('cuda', _to_cuda)):
        w = tm.WanTextEncoder(text_len=48, dtype=torch.float32, device=dev)
        w._params, w._cfg = conv(up), dataclasses.replace(ucfg)
        w._tok = StandInTokenizer(500, 0, eot=1)
        ctx.append(w.embed(['a cat', 'a much longer prompt than that']))
    torch.testing.assert_close(ctx[1].cpu(), ctx[0], atol=1e-4, rtol=1e-4)
    assert not ctx[1][0, 6:].any() and ctx[1][0, :6].abs().sum(-1).all()


@pytest.mark.cuda
@pytest.mark.parametrize('which', ['flux_ae', 'hunyuan', 'wan'])
def test_cuda_decoders_match_cpu(gen, which):
    """The FLUX autoencoder (ch 32, ch_mult (1, 2), 16x16 latent) and the
    two video VAEs at the JAX tests' tiny configs on 4 latent frames,
    float32 with TF32 off, perturbed weights: the card against the CPU to
    1e-4; Wan's 2-frame decode on the card equals the first 5 frames of
    its 4-frame decode to 1e-5."""
    import chipmunk_torch.models as tm
    g = torch.Generator().manual_seed(1)
    if which == 'flux_ae':
        cfg = tm.AutoEncoderParams(ch=32, ch_mult=(1, 2))
        p = tm.init_decoder_params(g, cfg, device='cpu')
        z = torch.randn((1, 16, 16, 16), generator=g)
        fn = tm.decode
    elif which == 'hunyuan':
        cfg = tm.HyVaeConfig(block_out_channels=(8, 8, 16, 16),
                             layers_per_block=1, latent_channels=4,
                             norm_groups=4)
        p = tm.init_hunyuan_vae_decoder(g, cfg, 'cpu')
        z = torch.randn((1, 4, 4, 8, 8), generator=g)
        fn = tm.hunyuan_vae_decode
    else:
        cfg = tm.WanVaeConfig(dim=8, z_dim=4, num_res_blocks=1)
        p = tm.init_wan_vae_decoder(g, cfg, 'cpu')
        z = torch.randn((1, 4, 4, 8, 8), generator=g)
        fn = tm.wan_vae_decode
    p = perturbed(torch, p, g)
    ref = fn(p, z, cfg)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        pc = _to_cuda(p)
        got = fn(pc, z.cuda(), cfg)
        torch.testing.assert_close(got.cpu(), ref, atol=1e-4, rtol=1e-4)
        if which == 'wan':
            pre = fn(pc, z[:, :, :2].cuda(), cfg)
            torch.testing.assert_close(pre, got[:, :, :5], atol=1e-5,
                                       rtol=1e-5)


@pytest.mark.cuda
def test_cuda_causal_conv3d_beyond_int32_indexing(gen):
    """A causal conv over an input of more than 2^31 elements with batch 1
    ([1, 64, 86, 480, 832], Wan's last-stage geometry): the port splits
    the time axis into pieces, each with its own halo; every output frame
    checked here equals one F.conv3d over that frame's three input frames
    (zero frames before the first), to 1e-4 with TF32 off."""
    import torch.nn.functional as F
    from chipmunk_torch.models import video_vae as tvv
    x = torch.randn((1, 64, 86, 480, 832), generator=gen, device='cuda')
    assert x.numel() > 2 ** 31
    w = torch.randn((64, 64, 3, 3, 3), generator=gen, device='cuda') \
        * (64 * 27) ** -0.5
    b = torch.randn(64, generator=gen, device='cuda')
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = tvv.causal_conv3d(x, w, b, 'constant')
        assert y.shape == x.shape
        for t in (0, 1, 2, 43, 85):
            xs = F.pad(x[:, :, max(0, t - 2):t + 1],
                       (1, 1, 1, 1, max(0, 2 - t), 0))
            torch.testing.assert_close(y[:, :, t:t + 1], F.conv3d(xs, w, b),
                                       atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_group_norm_beyond_int32_indexing(gen):
    """HunyuanVideo's group norm over [1, 128, 33, 544, 960] (2.2e9
    elements, its last stage at 33 output frames): the first and last
    group against float64 statistics, to 1e-4."""
    from chipmunk_torch.models import video_vae as tvv
    x = torch.randn((1, 128, 33, 544, 960), generator=gen, device='cuda')
    assert x.numel() > 2 ** 31
    x[:, :4] = x[:, :4] * 3 + 1
    gamma = torch.rand(128, generator=gen, device='cuda') + 0.5
    beta = torch.randn(128, generator=gen, device='cuda')
    y = tvv.group_norm(x, gamma, beta, 32)
    for c0 in (0, 124):
        xs = x[:, c0:c0 + 4].double()
        ref = (xs - xs.mean()) / torch.sqrt(xs.var(unbiased=False) + 1e-6)
        ref = ref * gamma[c0:c0 + 4, None, None, None].double() \
            + beta[c0:c0 + 4, None, None, None].double()
        assert (y[:, c0:c0 + 4].double() - ref).abs().max().item() < 1e-4


# ------------------------------------------- host offload (streamed runner)

@pytest.mark.cuda
def test_cuda_offload_pinned_buffers_and_side_streams(gen, tmp_path):
    """Host buffers are one page-locked slab of the exact size; a fetch
    and a writeback run on the two side streams, not on the compute
    stream, as copies from and into pinned memory (the profiler's memcpy
    records), and give back what was stored."""
    import json
    from torch.profiler import ProfilerActivity, profile
    from chipmunk_torch.utils import offload
    tree = {'a': torch.randn((3, 1 << 20), generator=gen, device='cuda'),
            'b': [None, torch.arange(1000, device='cuda', dtype=torch.int32)]}
    host = offload.offload_to_host(tree)
    leaves = offload.tree_leaves(host)
    assert all(x.device.type == 'cpu' and x.is_pinned() for x in leaves)
    assert offload.pinned_bytes(host) == 3 * 4 * (1 << 20) + 4096
    side = offload.side_streams('cuda')
    cur = torch.cuda.current_stream()
    assert cur.cuda_stream not in (side.h2d.cuda_stream,
                                   side.d2h.cuda_stream)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        dev = offload.fetch_to_device(host)
        dev['a'].mul_(2)
        offload.offload_to_host(dev, out=host)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / 'trace.json'))
    events = json.load(open(tmp_path / 'trace.json'))['traceEvents']
    copies = [e for e in events if e.get('cat') == 'gpu_memcpy']
    kernels = {e['args']['stream'] for e in events
               if e.get('cat') == 'kernel'}
    assert len(copies) == 4, [e['name'] for e in copies]
    assert all('Pinned' in e['name'] for e in copies)
    assert kernels and not kernels & {e['args']['stream'] for e in copies}
    assert len({e['args']['stream'] for e in copies}) == 2
    assert torch.equal(host['a'], 2 * tree['a'].cpu())
    assert torch.equal(host['b'][1], tree['b'][1].cpu())


@pytest.mark.cuda
def test_cuda_failed_pinned_allocation_raises(gen):
    """A host slab that cannot be allocated, or memory that cannot be
    page-locked (already registered), raises; the card still works."""
    from chipmunk_torch.utils import offload
    with pytest.raises(RuntimeError):
        offload.HostSlab(1 << 50, torch.device('cuda'))
    slab = offload.HostSlab(1 << 20, torch.device('cuda'))
    assert slab.take((256,), torch.float32).is_pinned()
    with pytest.raises(RuntimeError, match='page-locked'):
        offload.page_lock(slab.base, torch.device('cuda'))
    x = torch.ones(4, device='cuda')
    assert (x * 2).sum().item() == 8.0


@pytest.mark.cuda
@pytest.mark.parametrize('model', ['flux', 'video'])
def test_cuda_streamed_loop_matches_resident(gen, model):
    """A small FLUX (depth 2+2, every cache host-side) and a small
    full-width HunyuanVideo (latent (5, 16, 30), depth 2+2, the shipped
    config's offloading: attention out_cache and indices), with random
    keeps, streamed on the card one layer a chunk: equal bit for bit to
    the resident loop on the card, with the same launches; the host
    caches pinned, and copies issued each way."""
    import dataclasses
    import chipmunk_torch.models as tm
    from chipmunk_torch.config import config_from_dict, load_config
    from chipmunk_torch.utils import offload
    if model == 'flux':
        cfg, ck, _, img, txt, y = _small_flux()
        cfg = dataclasses.replace(cfg, depth=2, depth_single_blocks=2)
        params = _to_cuda(tm.init_flux_params(
            torch.Generator().manual_seed(0), cfg, 'cpu'))
        sampler = tm.FluxSampler(cfg=cfg, ck=ck,
                                 sp=tm.FluxSparse.build(ck, cfg, 512),
                                 h_img=16, w_img=24)
        args = (params, img.cuda(), txt.cuda(), y.cuda(),
                tm.get_schedule(8, 384))
        streamed = sampler.make_streamed(2, 2, policy=offload.OffloadPolicy(
            *(True,) * 9))

        def loop(s=None):
            g = torch.Generator('cuda').manual_seed(3)
            if s is None:
                return sampler.denoise(*args, generator=g)
            return sampler.denoise_streamed(*args, s, generator=g)
    else:
        ck = config_from_dict({
            'steps': 6,
            'attn': {'full_step_schedule': [0, 1, 4],
                     'first_n_dense_layers': 1, 'top_keys': 0.3,
                     'random_keys': 0.05, 'dense_fallback_frac': 1.0},
            'step_caching': {'is_enabled': True, 'skip_step_schedule': [3]}},
            load_config(os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), 'configs',
                'hunyuan-chipmunk.yml')))
        cfg = tm.HunyuanModelConfig(latent_t=5, latent_h=16, latent_w=30,
                                    depth_double=2, depth_single=2)
        g0 = torch.Generator().manual_seed(0)
        params = _to_cuda(tm.init_hunyuan_params(g0, cfg, 'cpu'))
        inputs = tuple(torch.randn(s, generator=g0).to(torch.bfloat16).cuda()
                       for s in ((1, 16, 5, 16, 30), (1, 256, 4096),
                                 (1, 768)))
        m = tm.HunyuanModel(cfg=cfg, ck=ck)
        streamed = m.make_streamed(2, 2)
        ts = tm.get_schedule(6, cfg.img_len, shift=False)

        def loop(s=None):
            return tm.hunyuan_denoise(m, params, *inputs, ts, streamed=s,
                                      generator=torch.Generator(
                                          'cuda').manual_seed(3))
    host = [x for x in offload.tree_leaves(
        [streamed[1].double, streamed[1].single]) if x.device.type == 'cpu']
    assert host and all(x.is_pinned() for x in host)
    outs, launches = [], []
    for s in (None, streamed):
        FA._build.reset_launches()
        offload.reset_copy_stats()
        outs.append(loop(s))
        torch.cuda.synchronize()
        launches.append(dict(FA._build.LAUNCHES))
    assert offload.COPY_STATS['h2d'] > 0 and offload.COPY_STATS['d2h'] > 0
    assert launches[0] == launches[1] and launches[0]['dense_colsum_attn']
    assert torch.isfinite(outs[0]).all()
    assert torch.equal(outs[0], outs[1])


def _same_tree(got, want, path=''):
    """Leaf for leaf torch.equal, ``got`` moved to the host."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _same_tree(got[k], want[k], f'{path}/{k}')
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f'{path}/{i}')
    elif isinstance(want, QT.QTensor):
        assert got.pack_axis == want.pack_axis, path
        _same_tree(got.q, want.q, path + '.q')
        _same_tree(got.scale, want.scale, path + '.scale')
    else:
        assert got.device.type == 'cuda', path
        assert got.dtype == want.dtype and torch.equal(got.cpu(), want), path


@pytest.mark.cuda
@pytest.mark.parametrize('model', ['flux', 'flux_fp8', 'hunyuan', 'wan'])
def test_cuda_loaders_match_cpu(gen, model):
    """The loaders on device='cuda' over a state dict on the card equal
    the loaders on the CPU over the same tensors (is_fp8: the int8 and
    fp8 quantization on the card byte for byte the CPU's)."""
    import chipmunk_torch.models as tm
    from chip_smoke import (SeededStateDict, flux_bfl_shapes, hunyuan_shapes,
                            wan_shapes)
    from chipmunk_torch.config import config_from_dict
    from chipmunk_torch.models import loaders
    if model.startswith('flux'):
        cfg = tm.FluxModelConfig(depth=2, depth_single_blocks=2,
                                 hidden_size=256, num_heads=2)
        shapes = flux_bfl_shapes(cfg)
        ck = config_from_dict({'mlp': {'is_fp8': model == 'flux_fp8'}})

        def load(sd, dev):
            return loaders.load_flux_params(sd, cfg, ck=ck, device=dev)
    elif model == 'hunyuan':
        cfg = tm.HunyuanModelConfig(latent_t=2, latent_h=16, latent_w=16,
                                    depth_double=2, depth_single=2,
                                    hidden_size=256, num_heads=2, txt_len=32)
        shapes = hunyuan_shapes(cfg)

        def load(sd, dev):
            return loaders.load_hunyuan_params(sd, cfg, device=dev)
    else:
        cfg = tm.WanModelConfig(latent_t=2, latent_h=16, latent_w=16,
                                num_layers=2, dim=256, num_heads=2,
                                ffn_dim=1024, txt_len=32)
        shapes = wan_shapes(cfg)

        def load(sd, dev):
            return loaders.load_wan_params(sd, cfg, device=dev)
    sd = SeededStateDict(torch, shapes, 5, 'cuda', torch.float32)
    host = {k: sd[k].cpu() for k in sd}
    _same_tree(load(sd, 'cuda'), load(host, 'cpu'))


@pytest.mark.cuda
def test_cuda_f8_input_matmul_matches_plain(gen):
    """torch._scaled_mm on the card against the plain version on the CPU
    (exact fp8 products; the card's fp8 tensor cores sum them in less
    than float32 precision, 1e-3 absolute at K = 512 and outputs of RMS
    ~1): float32 outputs within one e4m3 ulp at the larger of the value
    and the outputs' RMS, the largest error below 1% of the RMS; a K or N
    that is not a multiple of 16 raises on the card."""
    from chipmunk_torch.modules import mlp_fp8
    x = torch.randn((300, 512), generator=gen, device='cuda')
    wq = QT.quantize(torch.randn((1024, 512), generator=gen, device='cuda')
                     * 512 ** -0.5, 'fp8', keep_axes=(0,))
    b = torch.randn((1024,), generator=gen, device='cuda') * 0.02
    got = mlp_fp8.f8_input_matmul(x, wq, b)
    want = mlp_fp8.f8_input_matmul(x.cpu(), wq.to('cpu'), b.cpu())
    assert got.dtype == torch.float32 and got.is_cuda
    rms = want.pow(2).mean().sqrt()
    mag = torch.maximum(want.abs(), rms)
    e4m3_ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(min=2 ** -6))) - 3)
    diff = (got.cpu() - want).abs()
    assert bool((diff <= e4m3_ulp).all()), diff.max()
    assert diff.max() < 1e-2 * rms
    bf = mlp_fp8.f8_input_matmul(x.to(torch.bfloat16), wq, b)
    assert bf.dtype == torch.bfloat16
    odd = QT.quantize(torch.randn((40, 24), generator=gen, device='cuda'),
                      'fp8', keep_axes=(0,))
    with pytest.raises(ValueError, match='multiples of 16'):
        mlp_fp8.f8_input_matmul(torch.ones((8, 24), device='cuda'), odd)


@pytest.mark.cuda
def test_cuda_load_file_to_the_card(gen, tmp_path):
    from chipmunk_torch.utils.safetensors_io import load_file, save_file
    ts = {'a': torch.randn((64, 32), generator=gen, device='cuda'),
          'b': torch.randn((7,), generator=gen, device='cuda').to(
              torch.bfloat16),
          'c': fp8.to_fp8(torch.randn((16, 16), generator=gen,
                                      device='cuda'))}
    f = str(tmp_path / 'x.safetensors')
    save_file(ts, f)
    got = load_file(f, device='cuda')
    for k, v in ts.items():
        assert got[k].is_cuda and got[k].dtype == v.dtype
        assert torch.equal(got[k].view(torch.uint8) if v.dtype == fp8.FP8
                           else got[k], v.view(torch.uint8)
                           if v.dtype == fp8.FP8 else v)


# ------------------------------------- multi-card sampling at world one

@pytest.fixture(scope='module')
def nccl_mesh():
    """A world of one NCCL rank (the card's machine has one card, and NCCL
    takes one rank a card); left at the module's end."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernels have no CPU mode')
    import torch.distributed as dist
    from chipmunk_torch import parallel
    parallel.initialize_multihost(device='cuda')
    assert dist.get_backend() == 'nccl' and dist.get_world_size() == 1
    yield parallel.make_mesh
    dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_collectives_round_trip_at_world_one(gen, nccl_mesh):
    """collect_tokens / collect_heads (with and without token sizes) and
    the token gather over NCCL give back what they were given."""
    from chipmunk_torch import parallel
    from chipmunk_torch.parallel.comm import gather_tokens
    mesh = nccl_mesh({'dp': 1, 'sp': 1})
    x = randn(gen, 2, 4, 320, 128)
    for sizes in (None, (320,)):
        ct = parallel.collect_tokens(x, mesh, 'sp', sizes)
        assert torch.equal(ct, x)
        assert torch.equal(parallel.collect_heads(ct, mesh, 'sp', sizes), x)
    assert torch.equal(gather_tokens(x, mesh, 'sp', (320,), dim=2), x)


@pytest.mark.cuda
@pytest.mark.parametrize('fsdp', [False, True])
def test_cuda_sharded_flux_sampler_equals_resident(gen, nccl_mesh, fsdp):
    """The small FLUX (8 steps, random keeps, a skipped step) through
    FluxSampler.sharded on sp=1, with and without FSDP: the latent equal
    bit for bit to the unsharded sampler's, the same launches, host and
    compiled loops."""
    import chipmunk_torch.models as tm
    cfg, ck, params, img, txt, y = _small_flux()
    base = tm.FluxSampler(cfg=cfg, ck=ck, sp=tm.FluxSparse.build(ck, cfg, 512),
                          h_img=16, w_img=24)
    shd = base.sharded(nccl_mesh({'sp': 1}), fsdp=fsdp)
    args = (_to_cuda(params), img.cuda(), txt.cuda(), y.cuda(),
            tm.get_schedule(8, 384))
    for loop in ('denoise', 'denoise_compiled'):
        outs, launches = [], []
        for s in (base, shd):
            FA._build.reset_launches()
            outs.append(getattr(s, loop)(*args, generator=torch.Generator(
                'cuda').manual_seed(3)))
            launches.append(dict(FA._build.LAUNCHES))
        assert launches[0] == launches[1] and launches[0]['csp_mlp_mm1']
        assert torch.equal(outs[0], outs[1]), loop


@pytest.mark.cuda
@pytest.mark.parametrize('loop', ['host', 'compiled'])
def test_cuda_sharded_video_loops_equal_resident(gen, nccl_mesh, loop):
    """A small full-width HunyuanVideo (latent (5, 16, 30), depth 1+1,
    the shipped config without offloading, random keeps) sharded on
    dp=1 x sp=1: equal bit for bit to the unsharded loop, the same
    launches; the compiled loop replays graphs that hold its
    collectives."""
    import dataclasses
    import chipmunk_torch.models as tm
    from chipmunk_torch.config import config_from_dict, load_config
    from chipmunk_torch.models.step_graphs import GRAPH_STATS
    ck = load_config(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'configs', 'hunyuan-chipmunk.yml'))
    ck = config_from_dict({
        'steps': 6,
        'attn': {'full_step_schedule': [0, 1, 4], 'first_n_dense_layers': 1,
                 'top_keys': 0.3, 'random_keys': 0.05,
                 'dense_fallback_frac': 1.0},
        'step_caching': {'is_enabled': False}}, ck)
    ck = ck.replace(offloading=dataclasses.replace(
        ck.offloading, global_disable_offloading=True))
    cfg = tm.HunyuanModelConfig(latent_t=5, latent_h=16, latent_w=30,
                                depth_double=1, depth_single=1)
    g0 = torch.Generator().manual_seed(0)
    params = _to_cuda(tm.init_hunyuan_params(g0, cfg, 'cpu'))
    inputs = tuple(torch.randn(s, generator=g0).to(torch.bfloat16).cuda()
                   for s in ((1, 16, 5, 16, 30), (1, 256, 4096), (1, 768)))
    base = tm.HunyuanModel(cfg=cfg, ck=ck)
    fn = tm.hunyuan_denoise if loop == 'host' \
        else tm.hunyuan_denoise_compiled
    outs, launches = [], []
    for m in (base, base.sharded(nccl_mesh({'dp': 1, 'sp': 1}), dp='dp')):
        FA._build.reset_launches()
        outs.append(fn(m, params, *inputs,
                       tm.get_schedule(6, cfg.img_len, shift=False),
                       generator=torch.Generator('cuda').manual_seed(3)))
        launches.append(dict(FA._build.LAUNCHES))
    assert launches[0] == launches[1] and launches[0]['dense_colsum_attn']
    assert torch.isfinite(outs[0]).all() and torch.equal(outs[0], outs[1])
    if loop == 'compiled':
        assert GRAPH_STATS['replays'] > 0


@pytest.mark.cuda
def test_cuda_ring_merge_matches_dense(gen, nccl_mesh):
    """ring_hops over 4 key chunks through dense_attn within its
    tolerance of dense_attn_plain over all keys (lse to 1e-3); the ring
    and USP at world 1 equal to one dense_attn."""
    from chipmunk_torch import kernels, parallel
    from chipmunk_torch.parallel.ring import ring_hops
    q, k, v = (randn(gen, 1, 4, 1024, 128) for _ in range(3))
    o, lse = ring_hops(q, [(k[:, :, i:i + 256], v[:, :, i:i + 256])
                           for i in range(0, 1024, 256)])
    o_p, lse_p = FA.dense_attn_plain(q, k, v)
    assert ((o.float() - o_p.float()).abs()
            <= ATOL + RTOL * o_p.float().abs()).all()
    assert ((lse - lse_p).abs() <= 1e-3).all()
    o1 = kernels.dense_attn(q, k, v)[0]
    assert torch.equal(parallel.ring_attention(nccl_mesh({'sp': 1}), 'sp',
                                               q, k, v), o1)
    assert torch.equal(parallel.usp_attention(
        nccl_mesh({'sp': 1, 'ring': 1}), 'sp', 'ring', q, k, v), o1)
