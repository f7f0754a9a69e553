"""Ring attention over a mesh axis, and USP (Ulysses x ring), on
``torch.distributed``: the counterparts of
``chipmunk_tpu/parallel/ring.py``.

Dense only, as in the reference (its xDiT USP path never combines ring
with chipmunk sparsity: the column-sparse delta caches are keyed to a
stationary KV layout while the ring rotates KV shards).

Each rank holds a token shard of q, k and v.  The KV shards travel
around the ring with ``batch_isend_irecv``; the next hop's send and
receive are posted before this hop's attention runs.  Each hop is one
``kernels.dense_attn`` (on the card the port of ``_flash_kernel``, on the
CPU its plain version), which returns the hop's output and its log2 lse;
the hops merge in float32: ``lse = log2 sum_i 2^lse_i`` and
``o = sum_i 2^(lse_i - lse) o_i``, a row that no key reaches keeping 0
(the reference's ``l == 0 -> 1``).  ``ring_hops`` takes any sequence of
KV chunks, so one process can run the same merge over key chunks.
"""
from __future__ import annotations

from typing import Iterable, Iterator, Tuple

import torch
import torch.distributed as dist

from .. import kernels
from .comm import axis_rank, axis_size, collect_heads, collect_tokens


def merge_hop(acc, o: torch.Tensor, lse: torch.Tensor):
    """Fold one hop's (o, lse) into the running (o float32, lse) pair
    ``acc`` (None before the first hop)."""
    o = o.float()
    if acc is None:
        return o, lse
    o_a, lse_a = acc
    m = torch.maximum(lse_a, lse)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w_a, w_b = torch.exp2(lse_a - m), torch.exp2(lse - m)
    l = w_a + w_b
    o = (o_a * w_a[..., None] + o * w_b[..., None]) \
        / torch.where(l == 0, torch.ones_like(l), l)[..., None]
    return o, m + torch.log2(l)


def ring_hops(q: torch.Tensor,
              kvs: Iterable[Tuple[torch.Tensor, torch.Tensor]]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention of q over the keys of every (k, v) chunk in ``kvs``, one
    ``dense_attn`` a chunk, merged by lse.  Returns (o in q's dtype, lse
    float32 in log2)."""
    acc = None
    for k, v in kvs:
        acc = merge_hop(acc, *kernels.dense_attn(q, k, v))
    return acc[0].to(q.dtype), acc[1]


def ring_kv(mesh, axis: str, k: torch.Tensor, v: torch.Tensor
            ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Yield the KV shard of every rank of ``axis``, this rank's first,
    then the one before it on the ring, and so on; the transfer of the
    next shard is posted before the current one is yielded.  Every rank
    must hold shards of one shape."""
    n = axis_size(mesh, axis)
    kv = torch.stack([k, v])
    if n == 1:
        yield kv[0], kv[1]
        return
    group, r = mesh.get_group(axis), axis_rank(mesh, axis)
    send_to = dist.get_global_rank(group, (r + 1) % n)
    recv_from = dist.get_global_rank(group, (r - 1) % n)
    for i in range(n):
        reqs = nxt = None
        if i + 1 < n:
            nxt = torch.empty_like(kv)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, kv, send_to, group),
                dist.P2POp(dist.irecv, nxt, recv_from, group)])
        yield kv[0], kv[1]
        if reqs is not None:
            for w in reqs:
                w.wait()
            kv = nxt


def ring_attention(mesh, axis: str, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Dense ring attention: q, k, v [B, H, S_local, D] are this rank's
    equal token shards over ``axis``; returns this rank's rows of the
    exact attention over every rank's keys."""
    return ring_hops(q, ring_kv(mesh, axis, k, v))[0]


def usp_attention(mesh, ulysses_axis: str, ring_axis: str,
                  q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                  ) -> torch.Tensor:
    """USP: heads spread over ``ulysses_axis`` by all-to-all, the ring
    over ``ring_axis`` inside each head shard (the reference's
    xFuserLongContextAttention composition).  q, k, v [B, H, S_local, D]
    are this rank's equal token shards of the sequence split over both
    axes, ulysses-major; dense only."""
    q, k, v = (collect_tokens(t, mesh, ulysses_axis) for t in (q, k, v))
    o = ring_attention(mesh, ring_axis, q, k, v)
    return collect_heads(o, mesh, ulysses_axis)
