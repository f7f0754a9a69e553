"""Distributed communication for head-parallel (Ulysses) attention on
``torch.distributed``, the counterpart of ``chipmunk_tpu/parallel/comm.py``.

One process per card.  Each rank holds a contiguous shard of the token
sequence through the whole block stack; around each self-attention an
all-to-all over the mesh axis gives every rank the whole sequence for its
share of the heads, and a second one returns the outputs to token shards
(the reference's ``head_parallel.py`` collect_tokens / collect_heads):

  * ``collect_tokens``: [B, H, S_local, D] -> [B, H/n, S, D];
  * ``collect_heads``: the inverse, for the attention outputs.

Token shards may be uneven (``sizes``: the tokens of every rank along the
axis, in rank order), so that a shard boundary never cuts a sparse-MLP
token group.  Sparsity state is per head and stays local to its rank.

Collectives run on the process group's backend: NCCL on the card, gloo
for ``device='cpu'``.  Nothing here creates a process group at import;
``initialize_multihost`` does, and every sharded entry point raises
without one.
"""
from __future__ import annotations

import os
import socket
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device

# all_gather_into_tensor under its newer name where torch has it
_all_gather = getattr(dist, 'all_gather_single', None) \
    or dist.all_gather_into_tensor


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device: DeviceLike = 'cuda') -> int:
    """Start this process's rank of the default process group and return
    the rank.  With ``coordinator_address`` (host:port of rank 0),
    ``num_processes`` and ``process_id`` the group meets there over TCP;
    without them it reads torchrun's variables (``env://``) when they are
    set, else it is a world of one rank on a free localhost port.  The
    backend is NCCL for a CUDA ``device`` (the rank's card is
    ``LOCAL_RANK``, else ``process_id`` modulo the cards) and gloo for
    the CPU.  Idempotent: a second call returns the rank."""
    if dist.is_initialized():
        return dist.get_rank()
    dev = resolve_device(device)
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError('a coordinator needs num_processes and '
                             'process_id')
        if not 0 <= process_id < num_processes:
            raise ValueError(f'process_id {process_id} is not in [0, '
                             f'{num_processes})')
        init, world, rank = (f'tcp://{coordinator_address}', num_processes,
                             process_id)
    elif 'MASTER_ADDR' in os.environ and 'WORLD_SIZE' in os.environ:
        init = 'env://'
        world, rank = int(os.environ['WORLD_SIZE']), int(os.environ['RANK'])
    else:
        init, world, rank = f'tcp://127.0.0.1:{_free_port()}', 1, 0
    if dev.type == 'cuda':
        local = int(os.environ.get('LOCAL_RANK',
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group('nccl' if dev.type == 'cuda' else 'gloo',
                            init_method=init, world_size=world, rank=rank)
    return dist.get_rank()


def make_mesh(axis_sizes: Dict[str, int]):
    """A ``DeviceMesh`` over the whole world from {'axis': size}, ``dp``
    outermost, the other axes in the order given.  Its device type
    follows the default group's backend.  Raises without a process group
    or when the sizes do not multiply to the world size."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError('make_mesh needs a process group: call '
                           'parallel.initialize_multihost first')
    names = tuple(['dp'] if 'dp' in axis_sizes else []) + tuple(
        n for n in axis_sizes if n != 'dp')
    shape = tuple(int(axis_sizes[n]) for n in names)
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f'mesh {dict(zip(names, shape))} needs '
                         f'{int(np.prod(shape))} ranks, the world has '
                         f'{world}')
    dev = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    return init_device_mesh(dev, shape, mesh_dim_names=names)


def axis_size(mesh, axis: Optional[str]) -> int:
    return 1 if axis is None else mesh[axis].size()


def axis_rank(mesh, axis: Optional[str]) -> int:
    return 0 if axis is None else mesh.get_local_rank(axis)


def rank_generator(generator: torch.Generator, mesh) -> torch.Generator:
    """The generator that draws this rank's random keeps: ``generator``
    itself on the mesh's rank 0 (so a world of one draws what an unsharded
    run draws), on every other rank a generator on the same device seeded
    from ``generator``'s seed and the rank, so that ranks draw different
    keeps, the same ones on every run."""
    r = mesh.get_rank()
    if r == 0:
        return generator
    seed = np.random.SeedSequence([generator.initial_seed(), r]
                                  ).generate_state(2, np.uint32)
    return torch.Generator(generator.device).manual_seed(
        int(seed[0]) << 31 | int(seed[1]) >> 1)


def _sizes(sizes: Optional[Sequence[int]], n: int, local: int, rank: int
           ) -> Tuple[int, ...]:
    sizes = tuple(sizes) if sizes is not None else (local,) * n
    if len(sizes) != n or sizes[rank] != local:
        raise ValueError(f'token sizes {sizes} do not fit {n} ranks with '
                         f'{local} tokens on rank {rank}')
    return sizes


def collect_tokens(x: torch.Tensor, mesh, axis: str,
                   sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """[B, H, S_local, D] (all heads, this rank's tokens) -> [B, H/n, S, D]
    (this rank's heads, every token in rank order).  ``sizes``: every
    rank's token count (None: all equal)."""
    n, rank, group = axis_size(mesh, axis), axis_rank(mesh, axis), \
        mesh.get_group(axis)
    B, H, S_l, D = x.shape
    if H % n:
        raise ValueError(f'{H} heads do not split over {n} ranks')
    sizes = _sizes(sizes, n, S_l, rank)
    h = H // n
    inp = x.reshape(B, n, h, S_l, D).transpose(0, 1).contiguous()
    row = B * h * D
    out = x.new_empty(row * sum(sizes))
    dist.all_to_all_single(out, inp.reshape(-1), [row * s for s in sizes],
                           [row * S_l] * n, group=group)
    parts = out.split([row * s for s in sizes])
    return torch.cat([p.view(B, h, s, D) for p, s in zip(parts, sizes)], 2)


def collect_heads(x: torch.Tensor, mesh, axis: str,
                  sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """[B, H/n, S, D] -> [B, H, S_local, D], the inverse of
    ``collect_tokens`` with the same ``sizes``."""
    n, rank, group = axis_size(mesh, axis), axis_rank(mesh, axis), \
        mesh.get_group(axis)
    B, h, S, D = x.shape
    if sizes is None:
        if S % n:
            raise ValueError(f'{S} tokens do not split evenly over {n} '
                             f'ranks: pass sizes')
        sizes = (S // n,) * n
    if sum(sizes) != S or len(sizes) != n:
        raise ValueError(f'token sizes {tuple(sizes)} do not cover {S} '
                         f'tokens over {n} ranks')
    S_l, row = sizes[rank], B * h * D
    inp = torch.cat([c.reshape(-1) for c in x.split(list(sizes), 2)])
    out = x.new_empty(n * row * S_l)
    dist.all_to_all_single(out, inp, [row * S_l] * n,
                           [row * s for s in sizes], group=group)
    return out.view(n, B, h, S_l, D).transpose(0, 1).reshape(
        B, n * h, S_l, D)


def gather_tokens(x: torch.Tensor, mesh, axis: str, sizes: Sequence[int],
                  dim: int = 1) -> torch.Tensor:
    """The whole tensor from every rank's token shard along ``dim``
    (shards of ``sizes`` in rank order; uneven shards are padded to the
    largest for the all-gather and cut again)."""
    n = axis_size(mesh, axis)
    m = max(sizes)
    pad = m - x.shape[dim]
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:dim] + (pad,)
                                      + x.shape[dim + 1:])], dim)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + x.shape[1:])
    _all_gather(out, x, group=mesh.get_group(axis))
    out = out.view((n,) + x.shape)
    return torch.cat([out[j].narrow(dim, 0, s) for j, s in enumerate(sizes)],
                     dim)


def ulysses_attention(mesh, axis: str, attn_fn: Callable[..., Tuple],
                      q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      state, *attn_args, batch_axis: Optional[str] = None,
                      sizes: Optional[Sequence[int]] = None, **attn_kwargs):
    """Run ``attn_fn(q, k, v, state, ...) -> (o, state')`` head-parallel.

    q, k, v [B, H, S_local, D] are this rank's token shard (``sizes``:
    every rank's token count along ``axis``); ``state`` is this rank's,
    for H/n heads.  The batch is the rank's own: with ``batch_axis`` the
    caller has placed this rank's slice of a batch sharded over it (or
    the whole batch where it does not divide), and the state must hold
    the same batch.  Returns (o [B, H, S_local, D], new state)."""
    leaves = [t for t in (state or ()) if isinstance(t, torch.Tensor)]
    if leaves and leaves[0].shape[0] != q.shape[0]:
        raise ValueError(f'the state holds a batch of '
                         f'{leaves[0].shape[0]}, the rank\'s q of '
                         f'{q.shape[0]} (batch axis {batch_axis})')
    q, k, v = (collect_tokens(t, mesh, axis, sizes) for t in (q, k, v))
    o, state = attn_fn(q, k, v, state, *attn_args, **attn_kwargs)
    return collect_heads(o, mesh, axis, sizes), state
