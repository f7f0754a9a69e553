"""chipmunk_torch/utils/native.py, the port's host C++ library
(chipmunk_torch/csrc/host.cpp), against chipmunk_tpu/utils/native.py and
the port's own numpy and torch paths."""
import numpy as np
import pytest
import torch

from chipmunk_tpu.utils import native as jn
from chipmunk_tpu.utils import quant as jq
from chipmunk_torch.kernels import _build
from chipmunk_torch.ops import bitpack as t_bitpack  # the function
from chipmunk_torch.utils import native as tn
from chipmunk_torch.utils import quant as tq


def tie_free(rows, cols, seed):
    """Seeded weights with no value on a rounding tie of any format
    (|w / scale| never a half-integer), the row maxima set apart."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(-1.0, 1.0, (rows, cols)).astype(np.float32)
    w[:, 0] = np.where(rng.random(rows) < 0.5, -1.0, 1.0) * rng.uniform(
        1.5, 2.0, rows).astype(np.float32)
    amax = np.abs(w).max(1, keepdims=True)
    for levels in (127.0, 7.0):
        x = np.abs(w / (amax / np.float32(levels)))
        assert not (x - np.floor(x) == 0.5).any()
    return w


def test_the_library_builds_into_the_build_dir():
    lib = tn.get_lib()
    assert lib is tn.get_lib()
    path = _build.compile_host()
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert path.name.startswith('host-') and path.suffix == '.so'


def test_host_buffer_round_trip():
    buf = tn.HostBuffer(1 << 16)
    arr = np.random.default_rng(0).standard_normal((64, 64)).astype(
        np.float32)
    buf.write(arr)
    np.testing.assert_array_equal(buf.view(np.float32, (64, 64)), arr)
    assert buf.view(np.uint8, (1,)).ctypes.data % 4096 == 0
    with pytest.raises(ValueError):
        buf.view(np.float32, (1 << 15,))


@pytest.mark.parametrize('shape', [(3, 1000), (16, 257), (8,)])
def test_bitpack_host_matches_ops_and_the_reference(shape):
    mask = np.random.default_rng(1).random(shape) < 0.3
    packed = tn.bitpack_host(mask)
    np.testing.assert_array_equal(packed, jn.bitpack_host(mask))
    ops_packed, _ = t_bitpack(torch.from_numpy(mask))
    np.testing.assert_array_equal(packed, ops_packed.numpy().reshape(-1))
    np.testing.assert_array_equal(tn.bitunpack_host(packed, shape), mask)


@pytest.mark.parametrize('kind', ['fp8', 'int8', 'int4'])
def test_quantize_rows_native_equals_the_reference(kind):
    """The native codes and scales, the port's quantize_host (native
    route) and its numpy path (a 3-D weight takes it; the same rows),
    each bit-equal to the reference's quantize_host."""
    w = tie_free(96, 256, 2)
    q, scale = tn.quantize_rows_native(w, kind)
    ref = jq.quantize_host(w, kind, keep_axes=0,
                           pack_axis=1 if kind == 'int4' else None)
    ref_q = np.asarray(ref.q).view(np.uint8 if kind != 'int8' else np.int8)
    np.testing.assert_array_equal(q, ref_q)
    np.testing.assert_array_equal(scale, np.asarray(ref.scale)[:, 0])
    host = tq.quantize_host(w, kind, keep_axes=0,
                            pack_axis=1 if kind == 'int4' else None)
    assert host.pack_axis == ref.pack_axis
    codes = host.q.view(torch.uint8) if kind == 'fp8' else host.q
    np.testing.assert_array_equal(codes.numpy(), ref_q)
    np.testing.assert_array_equal(host.scale.numpy(), np.asarray(ref.scale))
    # the numpy path: the same rows as a [1, rows, cols] weight
    plain = tq.quantize_host(w[None], kind, keep_axes=(0, 1),
                             pack_axis=2 if kind == 'int4' else None)
    pcodes = plain.q.view(torch.uint8) if kind == 'fp8' else plain.q
    np.testing.assert_array_equal(pcodes.numpy()[0], ref_q)
    np.testing.assert_array_equal(plain.scale.numpy()[0], scale[:, None])


@pytest.mark.parametrize('kind', ['fp8', 'int8', 'int4'])
def test_quantize_host_native_equals_quantize(kind):
    """The host route against the port's torch ``quantize`` (the card's
    function, here on the CPU), code for code."""
    w = tie_free(64, 128, 3)
    host = tq.quantize_host(w, kind, keep_axes=0,
                            pack_axis=-1 if kind == 'int4' else None)
    dev = tq.quantize(torch.from_numpy(w), kind, keep_axes=0,
                      pack_axis=-1 if kind == 'int4' else None)
    assert host.pack_axis == dev.pack_axis
    if kind == 'fp8':
        assert torch.equal(host.q.view(torch.uint8), dev.q.view(torch.uint8))
    else:
        assert torch.equal(host.q, dev.q)
    assert torch.equal(host.scale, dev.scale)


def test_bad_inputs_raise():
    with pytest.raises(ValueError):
        tn.quantize_rows_native(np.zeros((2, 3, 4), np.float32), 'int8')
    with pytest.raises(ValueError):
        tn.quantize_rows_native(np.zeros((2, 3), np.float32), 'int4')
    with pytest.raises(ValueError):
        tn.quantize_rows_native(np.zeros((2, 4), np.float32), 'int2')
    with pytest.raises(ValueError):
        tn.bitunpack_host(np.zeros(1, np.uint8), (9,))


def test_a_failed_build_raises_with_the_compilers_output(tmp_path):
    """No fallback: g++ pointed at a source that is not there raises, and
    the message carries what the compiler said."""
    with pytest.raises(RuntimeError, match='g\\+\\+ failed') as e:
        _build.compile_host(tmp_path / 'missing.cpp', tmp_path / 'out')
    assert 'missing.cpp' in str(e.value)
    assert not list((tmp_path / 'out').glob('*.so'))
