"""Layer-chunked execution with host-offloaded state (torch), the
counterpart of ``chipmunk_tpu/utils/streaming.py`` (the reference's
per-layer offload pipeline: fetch the next layers' caches while the
current ones compute, PIPELINE_DEPTH=2).

The port keeps per-layer state as lists, not stacked leaves, so a chunk
is a list of consecutive layers: ``chunk_tree`` cuts a per-layer list into
equal chunks, ``unchunk_tree`` joins them, and ``StreamedScan`` runs a
chunk function over the chunks with their params and state in host
memory between calls, the next chunk's copy in flight while one
computes.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence

from .offload import fetch_to_device, offload_to_host, start_fetch


def chunk_tree(layers: Sequence, n_chunks: int) -> List[List]:
    """Split a per-layer list into ``n_chunks`` lists of equal length."""
    L = len(layers)
    assert L % n_chunks == 0, (L, n_chunks)
    c = L // n_chunks
    return [list(layers[i * c:(i + 1) * c]) for i in range(n_chunks)]


def unchunk_tree(chunks: Sequence[Sequence]) -> List:
    return [layer for chunk in chunks for layer in chunk]


class StreamedScan:
    """``carry = chunk_fn(carry, params_chunk, state_chunk, idx_chunk)``
    over the chunks in order, returning (carry, new_state_chunk), with the
    params (``offload_params``) and state (``offload_state``) chunks in
    host memory between calls: the next ``depth - 1`` chunks' copies are
    in flight while one computes, and each new state chunk is written back
    into its host buffers."""

    def __init__(self, chunk_fn: Callable, params_chunks: Sequence,
                 state_chunks: Sequence, offload_params: bool = False,
                 offload_state: bool = True, depth: int = 2,
                 device='cuda'):
        self.chunk_fn = chunk_fn
        self.offload_params = offload_params
        self.offload_state = offload_state
        self.depth = depth
        self.device = device
        self.params = [offload_to_host(p) if offload_params else p
                       for p in params_chunks]
        self.state = [offload_to_host(s) if offload_state else s
                      for s in state_chunks]
        self.n = len(self.params)
        assert len(self.state) == self.n

    def _fetch(self, i):
        """Chunk i's params and state: their fetches in flight (None for
        a family kept on the device)."""
        return tuple(start_fetch(t, self.device) if hosted else None
                     for t, hosted in ((self.params[i], self.offload_params),
                                       (self.state[i], self.offload_state)))

    def __call__(self, carry, idx_chunks: Sequence):
        window = {i: self._fetch(i) for i in range(min(self.depth, self.n))}
        for i in range(self.n):
            pp, ps = window.pop(i)
            nxt = i + self.depth - 1
            if nxt < self.n and nxt not in window:
                window[nxt] = self._fetch(nxt)
            p = pp.wait() if pp is not None else self.params[i]
            s = ps.wait() if ps is not None else self.state[i]
            carry, new_s = self.chunk_fn(carry, p, s, idx_chunks[i])
            self.state[i] = (offload_to_host(new_s, out=self.state[i])
                             if self.offload_state else new_s)
        return carry

    def gathered_state(self) -> List[Any]:
        return unchunk_tree([fetch_to_device(s, self.device)
                             if self.offload_state else s
                             for s in self.state])
