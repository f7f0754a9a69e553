"""``kernels.qkv_prologue`` on the CPU (its plain version) against the op
chain the FLUX blocks ran before it, bit for bit: ``linear``'s bias add,
the head split, ``rmsnorm`` of q and k, the streams' ``torch.cat`` in
sequence order, ``apply_rope`` of q and k and ``v.contiguous()``.  The
card's kernel is held against the plain version in
``tests/test_torch_cuda.py``."""
import pytest
import torch

from chipmunk_torch.kernels import QkvStream, qkv_prologue
from chipmunk_torch.models.flux import _qkv_stream, _split_heads
from chipmunk_torch.models.layers import (apply_rope, build_rope, linear,
                                          rmsnorm)

H, D, C = 2, 128, 192
AXES = (16, 56, 56)


def _stream_params(g, dtype, bias, prefix):
    p = {f'{prefix}qkv': {'w': (torch.randn((C, 3 * H * D), generator=g)
                                * C ** -0.5).to(dtype)},
         f'{prefix}qnorm': (1 + 0.1 * torch.randn(D, generator=g)).to(dtype),
         f'{prefix}knorm': (1 + 0.1 * torch.randn(D, generator=g)).to(dtype)}
    if bias:
        p[f'{prefix}qkv']['b'] = (0.1 * torch.randn(3 * H * D, generator=g)
                                  ).to(dtype)
    return p


def _eager_chain(p, prefix, x):
    """One stream as the blocks had it: (q, k, v) split and normed."""
    q, k, v = (_split_heads(z, H)
               for z in linear(p[f'{prefix}qkv'], x).chunk(3, -1))
    return rmsnorm(q, p[f'{prefix}qnorm']), rmsnorm(k, p[f'{prefix}knorm']), v


# (streams in sequence order as (prefix, tokens), B, cos batch, bias, dtype)
CASES = [
    ((('txt_', 128), ('img_', 384)), 1, 1, True, torch.bfloat16),
    ((('img_', 384), ('txt_', 128)), 1, 1, True, torch.bfloat16),
    ((('txt_', 128), ('img_', 384)), 2, 2, False, torch.bfloat16),
    ((('img_', 157), ('txt_', 100)), 2, 1, True, torch.bfloat16),
    ((('txt_', 0), ('img_', 200)), 1, 1, True, torch.bfloat16),
    ((('img_', 77), ('txt_', 0)), 2, 2, True, torch.bfloat16),
    ((('txt_', 64), ('img_', 131)), 1, 1, True, torch.float32),
    ((('', 300),), 1, 1, True, torch.bfloat16),
    ((('', 257),), 2, 2, False, torch.bfloat16),
    ((('', 0),), 2, 1, True, torch.bfloat16),
    ((('', 96),), 1, 1, True, torch.float32),
]


@pytest.mark.parametrize('streams,B,cos_b,bias,dtype', CASES)
def test_qkv_prologue_plain_equals_eager_chain(streams, B, cos_b, bias,
                                               dtype):
    g = torch.Generator().manual_seed(sum(n for _, n in streams) + B)
    p, xs = {}, []
    for prefix, n in streams:
        p.update(_stream_params(g, dtype, bias, prefix))
        xs.append(torch.randn((B, n, C), generator=g).to(dtype))
    S = sum(n for _, n in streams)
    ids = torch.randint(0, 64, (cos_b, S, len(AXES)), generator=g)
    cos, sin = build_rope(ids, AXES, 10_000)

    parts = [_eager_chain(p, prefix, x) for (prefix, _), x in zip(streams, xs)]
    if len(parts) == 2:
        want = [torch.cat([a, b], 2) for a, b in zip(*parts)]
    else:
        want = list(parts[0])
    want = (apply_rope(want[0], cos, sin), apply_rope(want[1], cos, sin),
            want[2].contiguous())

    got = qkv_prologue([_qkv_stream(p, prefix, x)
                        for (prefix, _), x in zip(streams, xs)], cos, sin, H)
    for a, b in zip(got, want):
        assert a.shape == (B, H, S, D) and a.dtype == dtype
        assert a.is_contiguous()
        assert torch.equal(a, b)


def test_qkv_prologue_takes_one_or_two_streams():
    y = torch.zeros((1, 4, 3 * H * D))
    s = QkvStream(y, None, torch.ones(D), torch.ones(D))
    cos = torch.ones((1, 1, 12, D // 2))
    with pytest.raises(ValueError, match='one or two streams'):
        qkv_prologue([s, s, s], cos, cos, H)
    with pytest.raises(ValueError, match='one or two streams'):
        qkv_prologue([], cos, cos, H)
