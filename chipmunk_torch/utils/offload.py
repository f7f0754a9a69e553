"""Host-memory cache offload (torch), the counterpart of
``chipmunk_tpu/utils/offload.py``: which caches live in host memory
(``OffloadPolicy``), host buffers, the copies between host and device,
and a windowed prefetcher (``DoubleBufferedLoader``).

The reference's design (``offloaded_tensor.py:90-178``): pinned host
buffers, one copy stream for each direction, and events that order the
copies against the compute stream.  Here:

  * host buffers are allocated once and page-locked at their exact size:
    each ``offload_to_host`` that allocates carves its buffers out of one
    host slab, registered with ``cuMemHostRegister`` of libcuda.
    PyTorch's pinned allocator would round a block up to a power of two,
    a 732 MB cache to 1 GiB.  A failed registration raises; nothing
    falls back to pageable memory;
  * copies are ``non_blocking`` on two side streams a device, H2D and
    D2H.  A fetch copies into blocks of the H2D stream's pool after the
    last D2H into its host buffer; the consumer's stream waits for the
    fetch (``Pending.wait``); a D2H waits for the producer's stream;
    ``record_stream`` keeps the caching allocator from reusing a block
    that another stream still reads or writes;
  * on the CPU host and device are the same memory, but every placement
    and writeback still copies, so that the CPU runs exercise each one.

``chunked_device_put`` has no counterpart: it works around a transfer
cliff of the TPU's host link; the port fills its host buffers in place.

A tree is a tensor, None, or a list, tuple, NamedTuple or dict of trees.
``COPY_STATS`` counts the copies and bytes issued each way.
"""
from __future__ import annotations

import ctypes
import mmap
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch

from ..config import OffloadingConfig

# copies and bytes issued each way since the last reset
COPY_STATS: Dict[str, int] = {'h2d': 0, 'd2h': 0, 'h2d_bytes': 0,
                              'd2h_bytes': 0}
_ALIGN = 4096          # bytes between the starts of a slab's buffers


def reset_copy_stats() -> None:
    for k in COPY_STATS:
        COPY_STATS[k] = 0


# ------------------------------------------------------------------- trees

def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensor leaves of ``tree`` (and the matching nodes of
    ``rest``); None stays None."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, tuple) and hasattr(tree, '_fields'):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    raise TypeError(f'not a tree of tensors: {type(tree).__name__}')


def tree_leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def _selected(tree, where) -> List[bool]:
    """Per leaf of ``tree``: its flag in ``where`` (every leaf if None)."""
    if where is None:
        return [True] * len(tree_leaves(tree))
    flags: List[bool] = []
    tree_map(lambda x, f: flags.append(bool(f)), tree, where)
    return flags


def _rebuild(tree, leaves: List[torch.Tensor]):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


# ------------------------------------------------------ page-locked slabs

_LIBCUDA = None


def _libcuda():
    global _LIBCUDA
    if _LIBCUDA is None:
        lib = ctypes.CDLL('libcuda.so.1')
        lib.cuMemHostRegister_v2.argtypes = [ctypes.c_void_p,
                                             ctypes.c_size_t, ctypes.c_uint]
        lib.cuMemHostUnregister.argtypes = [ctypes.c_void_p]
        lib.cuMemHostRegister_v2.restype = ctypes.c_int     # CUresult
        lib.cuMemHostUnregister.restype = ctypes.c_int
        _LIBCUDA = lib
    return _LIBCUDA


def page_lock(t: torch.Tensor, device: torch.device) -> None:
    """Page-lock a contiguous CPU tensor's memory for ``device``'s
    context, exactly its size (``cuMemHostRegister``, portable).
    Raises if the registration fails."""
    if t.device.type != 'cpu' or not t.is_contiguous():
        raise ValueError('page_lock takes a contiguous CPU tensor')
    with torch.cuda.device(device):
        torch.cuda.synchronize()        # the context is current here
        r = _libcuda().cuMemHostRegister_v2(
            t.data_ptr(), t.numel() * t.element_size(), 1)
    if r != 0:
        raise RuntimeError(f'cuMemHostRegister of {t.numel() * t.element_size()} '
                           f'bytes failed (CUresult {r}): the host buffers '
                           f'cannot be page-locked')


def _unlock(base: torch.Tensor, device: torch.device) -> None:
    side = _SIDE.get(device)
    if side is not None:             # no copy may still touch the slab
        side.h2d.synchronize()
        side.d2h.synchronize()
    _libcuda().cuMemHostUnregister(base.data_ptr())


class HostSlab:
    """One host allocation that buffers are carved from; on a CUDA device
    it is page-locked while it lives (each buffer keeps it alive)."""

    def __init__(self, nbytes: int, device: torch.device):
        self.nbytes = -(-max(nbytes, 1) // _ALIGN) * _ALIGN
        try:    # whole pages of its own; a tensor's storage starts there
            self.base = torch.frombuffer(mmap.mmap(-1, self.nbytes),
                                         dtype=torch.uint8)
        except (OSError, OverflowError) as e:
            raise RuntimeError(f'cannot allocate {self.nbytes} bytes of '
                               f'host memory: {e}') from e
        if device.type == 'cuda':
            device = _indexed(device)
            page_lock(self.base, device)
            weakref.finalize(self, _unlock, self.base, device)
        self._off = 0

    def take(self, shape, dtype: torch.dtype) -> torch.Tensor:
        n = torch.Size(shape).numel() * dtype.itemsize
        buf = self.base[self._off:self._off + n].view(dtype).view(shape)
        self._off += -(-n // _ALIGN) * _ALIGN
        buf._slab = self             # the slab lives while a buffer does
        return buf


def host_empty_like(tree, device: torch.device):
    """Host buffers shaped and typed like the leaves of ``tree``, carved
    from one slab (page-locked when ``device`` is a CUDA device)."""
    leaves = tree_leaves(tree)
    total = sum(-(-x.numel() * x.element_size() // _ALIGN) * _ALIGN
                for x in leaves)
    slab = HostSlab(total, torch.device(device))
    return _rebuild(tree, [slab.take(x.shape, x.dtype) for x in leaves])


def slab_of(x: torch.Tensor) -> Optional[HostSlab]:
    """The slab that a host buffer was carved from (None for any other
    tensor)."""
    return getattr(x, '_slab', None)


def pinned_bytes(tree) -> int:
    """Bytes of the distinct slabs that the leaves of ``tree`` lie in."""
    slabs = {id(s): s.nbytes for s in map(slab_of, tree_leaves(tree))
             if s is not None}
    return sum(slabs.values())


# ----------------------------------------------------------------- copies

class _Side:
    """A CUDA device's copy streams and the last copy touching each host
    buffer (by address)."""

    def __init__(self, device: torch.device):
        self.h2d = torch.cuda.Stream(device)
        self.d2h = torch.cuda.Stream(device)
        self.written: Dict[int, torch.cuda.Event] = {}   # last D2H into
        self.read: Dict[int, torch.cuda.Event] = {}      # last H2D out of


_SIDE: Dict[torch.device, _Side] = {}


def _indexed(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', torch.cuda.current_device())
    return dev


def side_streams(device) -> _Side:
    dev = _indexed(device)
    if dev not in _SIDE:
        _SIDE[dev] = _Side(dev)
    return _SIDE[dev]


def _count(kind: str, x: torch.Tensor) -> None:
    COPY_STATS[kind] += 1
    COPY_STATS[f'{kind}_bytes'] += x.numel() * x.element_size()


def _check_pinned(x: torch.Tensor) -> None:
    if not x.is_pinned():
        raise RuntimeError('host buffer is not page-locked: a copy from '
                           'or into pageable memory is not asynchronous')


@dataclass
class Pending:
    """A tree being fetched: ``wait()`` makes the current stream wait for
    the copies and returns the tree on the device."""
    tree: Any
    event: Optional[torch.cuda.Event] = None
    copies: tuple = ()
    device: Optional[torch.device] = None

    def wait(self):
        if self.event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(self.event)
            for x in self.copies:       # freed only after this stream's use
                x.record_stream(cur)
            self.event = None
        return self.tree


def start_fetch(tree, device='cuda', where=None) -> Pending:
    """Begin the H2D copy of the leaves of ``tree`` that ``where`` selects
    (every leaf if None); unselected leaves pass as they are.  On a CUDA
    device the copies run on its H2D stream, after the last D2H into each
    host buffer."""
    dev = torch.device(device)
    leaves, sel = tree_leaves(tree), _selected(tree, where)
    out = list(leaves)
    if dev.type != 'cuda':
        for j, (x, s) in enumerate(zip(leaves, sel)):
            if s:
                out[j] = x.to(dev, copy=True)
                _count('h2d', x)
        return Pending(_rebuild(tree, out))
    side = side_streams(dev)
    picked = [j for j, s in enumerate(sel) if s and leaves[j].device.type
              == 'cpu']
    if not picked:
        return Pending(_rebuild(tree, out))
    for j in picked:
        _check_pinned(leaves[j])
        ev = side.written.get(leaves[j].data_ptr())
        if ev is not None:
            side.h2d.wait_event(ev)
    # the destinations come from the H2D stream's pool, so a copy waits
    # for nothing on the compute stream
    with torch.cuda.stream(side.h2d):
        for j in picked:
            out[j] = torch.empty_like(leaves[j], device=dev)
            out[j].copy_(leaves[j], non_blocking=True)
            _count('h2d', leaves[j])
        ev = torch.cuda.Event()
        ev.record(side.h2d)
    for j in picked:
        side.read[leaves[j].data_ptr()] = ev
    return Pending(_rebuild(tree, out), ev, tuple(out[j] for j in picked),
                   dev)


def fetch_to_device(tree, device='cuda'):
    """Copy a tree's host leaves to ``device`` (H2D); the current stream
    may use the result at once."""
    return start_fetch(tree, device).wait()


def offload_to_host(tree, out=None, where=None):
    """Copy the leaves of ``tree`` that ``where`` selects to host memory
    (D2H): into the matching leaves of ``out`` when given (in place;
    host buffers are allocated once), else into new buffers of one slab.
    Unselected leaves pass as they are.  On a CUDA device the copies run
    on its D2H stream after the work queued so far on the current stream,
    and return at once."""
    leaves, sel = tree_leaves(tree), _selected(tree, where)
    picked = [j for j, s in enumerate(sel) if s]
    if out is None:
        dev = next((leaves[j].device for j in picked), torch.device('cpu'))
        bufs = host_empty_like([leaves[j] for j in picked], dev)
        dst = list(leaves)
        for j, b in zip(picked, bufs):
            dst[j] = b
    else:
        dst = tree_leaves(out)
        if len(dst) != len(leaves):
            raise ValueError('offload_to_host: out does not match the tree')
    res = list(leaves)
    cuda = [j for j in picked if leaves[j].device.type == 'cuda']
    for j in picked:
        x, h = leaves[j], dst[j]
        if h.shape != x.shape or h.dtype != x.dtype or h.device.type != 'cpu':
            raise ValueError(f'host buffer {tuple(h.shape)} {h.dtype} on '
                             f'{h.device} does not take {tuple(x.shape)} '
                             f'{x.dtype}')
        res[j] = h
        if x.device.type != 'cuda':
            h.copy_(x)
            _count('d2h', x)
    if cuda:
        dev = leaves[cuda[0]].device
        side = side_streams(dev)
        side.d2h.wait_stream(torch.cuda.current_stream(dev))
        for j in cuda:
            _check_pinned(dst[j])
            ev = side.read.get(dst[j].data_ptr())
            if ev is not None:
                side.d2h.wait_event(ev)
        with torch.cuda.stream(side.d2h):
            for j in cuda:
                dst[j].copy_(leaves[j], non_blocking=True)
                leaves[j].record_stream(side.d2h)
                _count('d2h', leaves[j])
            ev = torch.cuda.Event()
            ev.record(side.d2h)
        for j in cuda:
            side.written[dst[j].data_ptr()] = ev
    return _rebuild(tree, res)


# ----------------------------------------------------------------- policy

@dataclass(frozen=True)
class OffloadPolicy:
    """Which cache names live host-side (the config's ``offloading`` keys)."""
    attn_out_cache: bool = True
    attn_indices: bool = True
    attn_counts: bool = False
    attn_lse: bool = False
    mlp_out_cache: bool = False
    mlp_act_cache: bool = False
    mlp_indices: bool = False
    mlp_counts: bool = False
    mlp_bm_mid: bool = False
    enabled: bool = True

    @staticmethod
    def from_config(c: OffloadingConfig) -> "OffloadPolicy":
        return OffloadPolicy(
            attn_out_cache=c.attn_out_cache, attn_indices=c.attn_indices,
            attn_counts=c.attn_counts, attn_lse=c.attn_lse_constants,
            mlp_out_cache=c.mlp_out_cache,
            mlp_act_cache=c.mlp_sparse_act_T,
            mlp_indices=c.mlp_indices, mlp_counts=c.mlp_counts,
            mlp_bm_mid=c.mlp_blockmean_mid_cache,
            enabled=not c.global_disable_offloading)

    def wants_host(self, name: str) -> bool:
        return self.enabled and bool(getattr(self, name, False))


class DoubleBufferedLoader:
    """Sliding-window prefetcher over per-layer host-resident slices (the
    reference's PIPELINE_DEPTH=2 flow): ``prefetch(i)`` starts the H2D
    copy of slice i, ``get(i)`` returns it on the device (the current
    stream waits for its copy), ``store(i, value)`` writes an updated
    slice back into slice i's host buffers.  At most ``depth`` fetches are
    in flight; the oldest is dropped beyond that."""

    def __init__(self, host_slices, depth: int = 2, device='cuda'):
        self._host = list(host_slices)
        self._depth = depth
        self._device = torch.device(device)
        self._inflight: Dict[int, Pending] = {}

    def __len__(self):
        return len(self._host)

    def prefetch(self, i: int) -> None:
        if 0 <= i < len(self._host) and i not in self._inflight:
            self._inflight[i] = start_fetch(self._host[i], self._device)
            while len(self._inflight) > self._depth:
                oldest = min(self._inflight)
                if oldest == i:
                    break
                self._inflight.pop(oldest)

    def get(self, i: int):
        if i not in self._inflight:
            self.prefetch(i)
        return self._inflight.pop(i).wait()

    def store(self, i: int, value) -> None:
        self._inflight.pop(i, None)         # its copy would be stale
        self._host[i] = offload_to_host(value, out=self._host[i])

    def host_slices(self):
        return list(self._host)
