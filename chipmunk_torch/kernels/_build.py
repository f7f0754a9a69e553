"""Build and load the CUDA kernels of ``chipmunk_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, placed in
``build/chipmunk_torch/`` at the repository root and loaded with
``ctypes``.  The library's file name carries a hash of the sources (the
``.cu`` and every shared ``.cuh``), so a library is rebuilt only when its
sources change.  Nothing here runs at import time.

The port's host C++ library (``csrc/host.cpp``, no CUDA) is built the
same way by ``g++`` (``compile_host``), cached by the same hash rule.

Each wrapper that launches a kernel adds one to ``LAUNCHES[name]``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'chipmunk_torch'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC']
LIBRARIES = ('flash_attention', 'csp_attention', 'csp_mlp', 'int8_probe',
             'qkv_prologue')
GXX_FLAGS = ['-O3', '-shared', '-fPIC', '-pthread', '-std=c++17']

# kernel launches per wrapper since the last reset
LAUNCHES: Dict[str, int] = {
    'dense_attn': 0, 'dense_colsum_attn': 0, 'csp_attn': 0,
    'csp_attn_hbm': 0,
    'csp_mlp_mm1': 0, 'csp_mlp_mm2': 0,              # bf16 weights
    'csp_mlp_mm1_wq': 0, 'csp_mlp_mm2_wq': 0,        # int8 weights, bf16 x
    'csp_mlp_mm1_w4': 0, 'csp_mlp_mm2_w4': 0,        # int4 weights, bf16 x
    'quant_rows': 0, 'csp_mlp_mm1_a8': 0,            # int8 weights and x
    'csp_mlp_mm2_a8': 0,
    'csp_mlp_mm1_a8w4': 0, 'csp_mlp_mm2_a8w4': 0,    # int4 weights, int8 x
    'int8_probe_s8': 0, 'int8_probe_bf16': 0,
    'qkv_prologue': 0}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    'chipmunk_dense_attn': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                            _P],
    'chipmunk_colsum_max_blocks': [_I],
    'chipmunk_dense_colsum_attn': [_P] * 8 + [_I] * 7 + [_F, _P],
    'chipmunk_csp_attn': [_P] * 6 + [_I] * 9 + [_F, _P],
    'chipmunk_csp_hbm_attn': [_P] * 5 + [_I] * 7 + [_F, _P],
    'chipmunk_csp_mlp_mm1': [_P] * 7 + [_I] * 7 + [_P],
    'chipmunk_csp_mlp_mm2': [_P] * 5 + [_I] * 7 + [_P],
    'chipmunk_csp_mlp_mm1_wq': [_P] * 9 + [_I] * 8 + [_P],
    'chipmunk_csp_mlp_mm2_wq': [_P] * 6 + [_I] * 9 + [_P],
    'chipmunk_quant_rows': [_P] * 3 + [_I] * 2 + [_P],
    'chipmunk_csp_mlp_mm1_a8': [_P] * 13 + [_I] * 8 + [_P],
    'chipmunk_csp_mlp_mm2_a8': [_P] * 6 + [_I] * 8 + [_P],
    'chipmunk_int8_probe_s8': [_P] * 3 + [_I] * 3 + [_P],
    'chipmunk_int8_probe_bf16': [_P] * 3 + [_I] * 3 + [_P],
    'chipmunk_qkv_prologue': [_P] * 13 + [_I] * 5 + [_P],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the chipmunk_torch CUDA kernels '
                           'are built on first use on a machine with the '
                           'CUDA toolkit')
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f'{name}.cu'] + sorted(CSRC.glob('*.cuh')):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'{name}-{h.hexdigest()[:16]}.so'


def _compile(names: Iterable[str]) -> None:
    """Compile the missing libraries, one nvcc per source, all at once."""
    todo = [(n, _lib_path(n)) for n in names]
    todo = [(n, p) for n, p in todo if not p.exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f'nvcc failed for {name}.cu:\n{log}')
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError('\n'.join(errors))


def build_all() -> None:
    """Compile every kernel library that is not built yet, in parallel."""
    with _lock:
        _compile(LIBRARIES)


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``csrc/<name>.cu``, built first if needed."""
    lib: Optional[ctypes.CDLL] = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _compile([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in _SIGNATURES.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


def compile_host(src: Path = CSRC / 'host.cpp', out_dir: Path = BUILD_DIR
                 ) -> Path:
    """The shared library of the host C++ source ``src``, compiled by
    ``g++`` into ``out_dir`` unless a library of the same source and
    flags is there; raises RuntimeError with the compiler's output when
    it fails."""
    h = hashlib.sha256(' '.join(GXX_FLAGS).encode())
    h.update(src.read_bytes() if src.exists() else b'')
    out = Path(out_dir) / f'{src.stem}-{h.hexdigest()[:16]}.so'
    if out.exists():
        return out
    gxx = shutil.which('g++')
    if gxx is None:
        raise RuntimeError(f'g++ not found: {src.name} is built on first '
                           f'use with the C++ compiler')
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    p = subprocess.run([gxx, *GXX_FLAGS, str(src), '-o', str(tmp)],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if p.returncode != 0:
        raise RuntimeError(f'g++ failed for {src}:\n{p.stdout}')
    os.replace(tmp, out)
    return out


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f'{what}: CUDA launch failed with cudaError {err}')
