"""ctypes bindings of the port's host C++ library (``csrc/host.cpp``),
the counterpart of ``chipmunk_tpu/utils/native.py``.

The library is built by ``g++`` at first use into ``build/`` and cached
there (``kernels/_build.compile_host``).  Nothing falls back: where the
compiler or the library is missing, ``get_lib`` raises with the
compiler's output.

``HostBuffer`` is a page-aligned, pre-faulted host staging buffer in
pageable memory; it is not the page-locked ``HostSlab`` of
``utils/offload.py``, and neither replaces the other.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def get_lib() -> ctypes.CDLL:
    """The loaded host library, built first if needed (RuntimeError with
    the compiler's output where that fails)."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        from ..kernels._build import compile_host
        lib = ctypes.CDLL(str(compile_host()))
        lib.chipmunk_host_alloc.restype = ctypes.c_int64
        lib.chipmunk_host_alloc.argtypes = [ctypes.c_uint64]
        lib.chipmunk_host_ptr.restype = ctypes.c_void_p
        lib.chipmunk_host_ptr.argtypes = [ctypes.c_int64]
        for fn in ('chipmunk_memcpy', 'chipmunk_bitpack',
                   'chipmunk_bitunpack'):
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_uint64]
        for fn in ('chipmunk_quantize_fp8_rows', 'chipmunk_quantize_int8_rows',
                   'chipmunk_quantize_int4_rows'):
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_void_p, ctypes.c_uint64,
                                         ctypes.c_uint64]
        _LIB = lib
        return _LIB


class HostBuffer:
    """Page-aligned, pre-faulted host staging buffer of ``nbytes`` (kept
    for the life of the process, as the library's pool keeps it)."""

    def __init__(self, nbytes: int):
        lib = get_lib()
        self.nbytes = nbytes
        self._id = lib.chipmunk_host_alloc(nbytes)
        if self._id < 0:
            raise MemoryError(f'no page-aligned host buffer of {nbytes} '
                              f'bytes')
        ptr = lib.chipmunk_host_ptr(self._id)
        self._np = np.ctypeslib.as_array(
            ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
            shape=(nbytes,))

    def view(self, dtype, shape) -> np.ndarray:
        """The buffer's first bytes as a ``dtype`` array of ``shape``."""
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        if n > self.nbytes:
            raise ValueError(f'{n} bytes do not fit a buffer of '
                             f'{self.nbytes}')
        return self._np[:n].view(dtype).reshape(shape)

    def write(self, arr: np.ndarray) -> None:
        """Copy ``arr`` to the start of the buffer (the library's
        multi-threaded memcpy)."""
        src = np.ascontiguousarray(arr)
        dst = self.view(src.dtype, src.shape)
        get_lib().chipmunk_memcpy(dst.ctypes.data, src.ctypes.data,
                                  src.nbytes)


def quantize_rows_native(w: np.ndarray, kind: str
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-threaded row-wise weight quantization: ``w`` [rows, cols]
    float32 -> (q, scale [rows] float32), bit-equal to the numpy path of
    ``utils/quant.quantize_host`` with ``keep_axes=0``.  ``kind`` 'fp8'
    gives the e4m3 codes as uint8 (numpy has no fp8 type; a tensor of
    them views as ``torch.float8_e4m3fn``), 'int8' int8 codes, 'int4'
    [rows, cols / 2] uint8 planes packed along the columns."""
    if w.ndim != 2:
        raise ValueError(f'a [rows, cols] weight, not {w.shape}')
    if kind not in ('fp8', 'int8', 'int4'):
        raise ValueError(f'unknown kind {kind!r}')
    lib = get_lib()
    w = np.ascontiguousarray(w, np.float32)
    rows, cols = w.shape
    if kind == 'int4' and cols % 2:
        raise ValueError(f'int4 packs an even number of columns, not {cols}')
    scale = np.empty((rows,), np.float32)
    q = np.empty((rows, cols // 2 if kind == 'int4' else cols),
                 np.int8 if kind == 'int8' else np.uint8)
    getattr(lib, f'chipmunk_quantize_{kind}_rows')(
        w.ctypes.data, q.ctypes.data, scale.ctypes.data, rows, cols)
    return q, scale


def bitpack_host(mask: np.ndarray) -> np.ndarray:
    """A bool mask packed 8 entries a byte, little-endian bit order (that
    of ``ops.bitpack``), at memory bandwidth on the host."""
    flat = np.ascontiguousarray(np.asarray(mask).reshape(-1).astype(np.uint8))
    out = np.empty((len(flat) + 7) // 8, np.uint8)
    get_lib().chipmunk_bitpack(flat.ctypes.data, out.ctypes.data, flat.size)
    return out


def bitunpack_host(packed: np.ndarray, shape) -> np.ndarray:
    """The inverse of ``bitpack_host``: a bool array of ``shape``."""
    n = int(np.prod(shape))
    packed = np.ascontiguousarray(packed, np.uint8)
    if packed.size < (n + 7) // 8:
        raise ValueError(f'{packed.size} bytes do not hold {n} bits')
    out = np.empty(n, np.uint8)
    get_lib().chipmunk_bitunpack(packed.ctypes.data, out.ctypes.data, n)
    return out.astype(bool).reshape(shape)

