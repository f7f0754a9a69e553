"""The safetensors file format, read and written with torch alone.

A file is an 8-byte little-endian header length, a JSON header mapping
each tensor name to its ``dtype``, ``shape`` and ``data_offsets`` (begin,
end; relative to the bytes after the header) plus an optional
``__metadata__`` of strings, then the raw little-endian bytes.  The
port's checkpoint readers go through this module, so that reading a
checkpoint needs no package beyond torch.

``load_file`` maps the file and returns tensors that view the mapping
(copy-on-write: a write to one never reaches the file), so a large
checkpoint is paged in as its tensors are read; with ``device`` set,
each tensor is copied there.
"""
from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Mapping, Optional

import torch

from ..device import DeviceLike, resolve_device

DTYPES = {
    'BF16': torch.bfloat16, 'F16': torch.float16, 'F32': torch.float32,
    'F64': torch.float64, 'F8_E4M3': torch.float8_e4m3fn, 'I8': torch.int8,
    'U8': torch.uint8, 'I16': torch.int16, 'I32': torch.int32,
    'I64': torch.int64, 'BOOL': torch.bool}
NAMES = {v: k for k, v in DTYPES.items()}
# a header longer than this is not a safetensors file (the format's limit)
MAX_HEADER = 100_000_000


def _header(buf, path: str):
    if len(buf) < 8:
        raise ValueError(f'{path}: too short for a safetensors file')
    n, = struct.unpack('<Q', buf[:8])
    if n > MAX_HEADER or 8 + n > len(buf):
        raise ValueError(f'{path}: header length {n} does not fit the file')
    return json.loads(bytes(buf[8:8 + n]).decode('utf-8')), 8 + n


def _tensor(buf, start: int, info: Dict, name: str, path: str
            ) -> torch.Tensor:
    dt = DTYPES.get(info['dtype'])
    if dt is None:
        raise ValueError(f'{path}: tensor {name!r} has dtype '
                         f'{info["dtype"]!r}, which this reader does not take')
    shape = [int(s) for s in info['shape']]
    b, e = (int(o) for o in info['data_offsets'])
    numel = 1
    for s in shape:
        numel *= s
    size = torch.empty((), dtype=dt).element_size()
    if e - b != numel * size or start + e > len(buf):
        raise ValueError(f'{path}: tensor {name!r} has {e - b} bytes for '
                         f'shape {shape} of {info["dtype"]}')
    if numel == 0:
        return torch.empty(shape, dtype=dt)
    off = start + b
    if off % size:          # unaligned: copy the bytes out first
        raw = torch.frombuffer(buf, dtype=torch.uint8, count=e - b,
                               offset=off).clone()
        return raw.view(dt).reshape(shape)
    return torch.frombuffer(buf, dtype=dt, count=numel,
                            offset=off).reshape(shape)


def load_file(path: str, prefix: str = '', device: DeviceLike = 'cpu'
              ) -> Dict[str, torch.Tensor]:
    """The tensors of a ``.safetensors`` file whose names start with
    ``prefix`` (names kept as stored), or of every ``*.safetensors`` file
    of a directory of shards (in file-name order).  With ``device`` other
    than the CPU each tensor is copied there; on the CPU they view the
    mapped file."""
    dev = resolve_device(device)
    if os.path.isdir(path):
        out: Dict[str, torch.Tensor] = {}
        for f in sorted(os.listdir(path)):
            if f.endswith('.safetensors'):
                out.update(load_file(os.path.join(path, f), prefix, dev))
        return out
    with open(path, 'rb') as f:
        size = os.fstat(f.fileno()).st_size
        buf = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size
               else b'')
    header, start = _header(buf, path)
    out = {}
    for name, info in header.items():
        if name == '__metadata__' or not name.startswith(prefix):
            continue
        t = _tensor(buf, start, info, name, path)
        out[name] = t if dev.type == 'cpu' else t.to(dev)
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (any device; copied to the host) as a
    ``.safetensors`` file, laid out as the ``safetensors`` package lays
    it out: the header padded with spaces to 8 bytes, the tensors by
    falling alignment then name, each at an offset aligned to its
    element size."""
    items = []
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f'{name!r} is a {type(t).__name__}, not a tensor')
        if t.dtype not in NAMES:
            raise ValueError(f'{name!r}: dtype {t.dtype} has no safetensors '
                             f'name here')
        items.append((name, t.detach().to('cpu').contiguous()))
    items.sort(key=lambda kv: (-kv[1].element_size(), kv[0]))
    header: Dict = {}
    if metadata:
        header['__metadata__'] = {str(k): str(v) for k, v in metadata.items()}
    pos = 0
    for name, t in items:
        n = t.numel() * t.element_size()
        header[name] = {'dtype': NAMES[t.dtype], 'shape': list(t.shape),
                        'data_offsets': [pos, pos + n]}
        pos += n
    text = json.dumps(header, separators=(',', ':')).encode('utf-8')
    text += b' ' * (-len(text) % 8)
    with open(path, 'wb') as f:
        f.write(struct.pack('<Q', len(text)))
        f.write(text)
        for _, t in items:
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
