"""Weight, token and state placement for the sharded samplers, the
counterparts of ``chipmunk_tpu/parallel/sharding.py``.

* FSDP: every weight leaf keeps only this rank's slice of its largest
  dim that the axis size divides (replicated where none does), the rule
  of the reference's ``fsdp_shardings``; a model gathers each layer's
  weights (``gathered``, an all-gather) just before the layer and drops
  them after it.  QTensor code planes and scales shard as leaves of
  their own; the gathered bytes equal the original ones.
* Tokens: ``TokenShards`` splits the joint sequence over the ``sp`` axis
  in whole sparse-MLP token groups (``mlp.bm`` rows share one neuron
  set, so a boundary inside a group would change the selection), uneven
  where the group count asks for it.  Where no such split keeps every
  MLP token stream's groups whole, the tokens split as evenly as they
  allow and each stream that split cuts gets an ``MlpRoute``: its rows
  move to a whole-group split of their own (over ``sp``, or ``dp`` x
  ``sp`` where a group crosses two ``dp`` ranks' batch rows) before the
  MLP and back after it, each group computed once, on one rank, from the
  rows the unsharded MLP sees (the JAX package runs the MLP on the
  global token axis, so it runs every split).
* State: created at the rank's size (``H/n`` heads of the rank's batch,
  the MLP caches of the rank's rows of each MLP split; None where it
  holds none), which is what the reference's ``chipmunk_state_shardings``
  places on each device.
* Inputs: ``place_flux_inputs`` / ``place_video_inputs`` give this
  rank's slice of a batch sharded over ``dp`` (the whole batch where it
  does not divide), its state and the weights, whole or FSDP-sharded.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.quant import QTensor
from .comm import _all_gather, axis_rank, axis_size, gather_tokens


# --------------------------------------------------------------------- FSDP

def _fsdp_dim(shape: Sequence[int], size: int) -> Optional[int]:
    """The largest dim that ``size`` divides (the first of equals), else
    None (replicated)."""
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[d] % size == 0 and shape[d] >= size:
            return d
    return None


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if isinstance(tree, QTensor):
        return QTensor(fn(tree.q), fn(tree.scale), tree.pack_axis)
    return fn(tree)


def fsdp_shardings(params, mesh, axis: str = 'sp'):
    """The tree of ``params`` with each tensor leaf (QTensor planes and
    scales apart) replaced by the dim it shards over ``axis``, or None
    where it stays whole."""
    size = axis_size(mesh, axis)
    return _map(lambda x: None if x is None else _fsdp_dim(x.shape, size),
                params)


@dataclass(frozen=True)
class Shard:
    """This rank's slice of a weight sharded along ``dim`` over ``axis``
    of ``mesh``; ``gather()`` rebuilds the whole weight."""
    local: torch.Tensor          # [n_local, ...] with dim moved first
    dim: int
    mesh: object
    axis: str

    def gather(self) -> torch.Tensor:
        n = axis_size(self.mesh, self.axis)
        out = self.local.new_empty((n * self.local.shape[0],)
                                   + self.local.shape[1:])
        _all_gather(out, self.local, group=self.mesh.get_group(self.axis))
        return out if self.dim == 0 else \
            out.movedim(0, self.dim).contiguous()


def shard_params(params, mesh, axis: str = 'sp'):
    """``params`` with every leaf that ``fsdp_shardings`` shards replaced
    by this rank's ``Shard``; the others stay whole."""
    size, rank = axis_size(mesh, axis), axis_rank(mesh, axis)

    def cut(x):
        d = None if x is None else _fsdp_dim(x.shape, size)
        if d is None:
            return x
        local = x.movedim(d, 0).chunk(size)[rank].contiguous()
        return Shard(local, d, mesh, axis)

    return _map(cut, params)


def gathered(tree):
    """``tree`` with every ``Shard`` gathered whole (a tree without one
    comes back as it is, leaf for leaf)."""
    return _map(lambda x: x.gather() if isinstance(x, Shard) else x, tree)


def gathered_top(params: Dict) -> Dict:
    """The params with everything but the per-layer lists (``double``,
    ``single``, ``blocks``) gathered: the layers gather their own."""
    return {k: v if k in ('double', 'single', 'blocks') else gathered(v)
            for k, v in params.items()}


# ------------------------------------------------------------------- tokens

def token_split(seq_len: int, n: int, unit: int) -> Tuple[int, ...]:
    """Tokens of each of ``n`` ranks: the ceil(seq_len / unit) groups of
    ``unit`` tokens dealt out in rank order, rank r taking groups
    [floor(r G / n), floor((r + 1) G / n)); the last group may be
    short."""
    G = -(-seq_len // unit)
    bounds = [min(seq_len, (r * G // n) * unit) for r in range(n + 1)]
    bounds[-1] = seq_len
    return tuple(b - a for a, b in zip(bounds, bounds[1:]))


def stream_counts(sizes: Sequence[int], offset: int, length: int
                  ) -> Tuple[int, ...]:
    """Tokens of the stream [offset, offset + length) on each shard."""
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return tuple(int(max(0, min(s + z, offset + length) - max(s, offset)))
                 for s, z in zip(starts, sizes))


def fold_rows(batch_rows: range, length: int, start: int, stop: int
              ) -> np.ndarray:
    """The rows of the batch-folded stream (``[B*T]``, row b * length +
    t) that a rank holding ``batch_rows`` and the stream's tokens [start,
    stop) holds, in its own fold order (batch row major)."""
    return (np.asarray(batch_rows)[:, None] * length
            + np.arange(start, stop)[None]).reshape(-1)


def whole_groups(sizes: Sequence[int], offset: int, length: int,
                 batch: int, local_batch: int, bm: int) -> bool:
    """Whether the MLP token groups of every rank's part of the stream
    [offset, offset + length) are whole groups of the unsharded stream.
    The MLP folds the batch into its token axis (``[B*T]``, B =
    ``batch``) and groups ``bm`` consecutive rows; each rank holds
    ``local_batch`` consecutive batch rows and its shard of the tokens of
    each."""
    counts = stream_counts(sizes, offset, length)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    T = batch * length
    for b0 in range(0, batch, local_batch):
        for a, z in zip(starts, counts):
            rows = fold_rows(range(b0, b0 + local_batch), length, a, a + z)
            for g0 in range(0, rows.size, bm):
                grp = rows[g0:g0 + bm]
                if not (grp[0] % bm == 0
                        and (grp.size == bm or grp[-1] == T - 1)
                        and grp[-1] - grp[0] == grp.size - 1):
                    return False
    return True


_GROUPS: Dict[Tuple[int, Tuple[Tuple[int, ...], ...]], tuple] = {}


def _joint_group(mesh, axes: Tuple[str, ...]):
    """This rank's process group over the ranks of ``mesh`` that differ
    only along ``axes``: one group per slice, every slice made on every
    rank in the same order (``new_subgroups_by_enumeration``), once per
    set of slices in each world.  The cache holds the world's default
    group beside the groups, so a world started after
    ``destroy_process_group`` (a new default group, never of the same
    id while the old one is held) makes its own."""
    names = list(mesh.mesh_dim_names)
    dims = [names.index(a) for a in axes]
    other = [d for d in range(len(names)) if d not in dims]
    ranks = mesh.mesh.permute(*other, *dims).reshape(
        -1, int(np.prod([mesh.mesh.shape[d] for d in dims])))
    world = dist.group.WORLD
    key = (id(world), tuple(tuple(sorted(r.tolist())) for r in ranks))
    if key not in _GROUPS:
        _GROUPS[key] = (world, dist.new_subgroups_by_enumeration(
            [list(k) for k in key[1]])[0])
    return _GROUPS[key][1]


class MlpRoute:
    """How one sparse-MLP token stream moves between this rank's token
    shard (the attention's split) and the MLP's own whole-group split.

    The MLP folds the batch into its token axis and groups ``bm``
    consecutive rows, so a shard boundary inside a group would change
    the group's neuron selection.  Where the attention's split cuts a
    group, the stream's folded rows are dealt out again in whole groups
    over the ranks that hold it (``sp``, or ``dp`` x ``sp`` where a group
    crosses batch rows of different ``dp`` ranks): ``to_mlp`` moves this
    rank's rows there by one ``all_to_all_single`` with uneven sizes
    and puts them in fold order, ``back`` returns the MLP's output the
    same way.  Each group is then computed once, on one rank, from the
    rows the unsharded MLP sees.  ``n_rows`` is this rank's share (0: it
    holds no group, but still takes part in both exchanges)."""

    def __init__(self, group, send, recv, perm, n_rows, device):
        self.group, self.send, self.recv = group, list(send), list(recv)
        self.n_rows = int(n_rows)
        self.perm = self.inv = None
        if perm is not None:
            self.perm = torch.as_tensor(perm, device=device)
            self.inv = torch.as_tensor(np.argsort(perm), device=device)

    @staticmethod
    def plan(mesh, axis: str, batch_axis: Optional[str],
             sizes: Sequence[int], offset: int, length: int, batch: int,
             lb: int, bm: int) -> "MlpRoute":
        """The route of the stream [offset, offset + length) of a batch
        of ``batch`` whose tokens are split by ``sizes`` over ``axis``
        and whose rows are split over ``batch_axis``, ``lb`` a rank
        (``local_batch``), for this rank."""
        # a group crosses the batch rows of two dp ranks
        cross = lb < batch and (lb * length) % bm != 0
        axes = (batch_axis, axis) if cross else (axis,)
        group = _joint_group(mesh, axes) if cross else mesh.get_group(axis)
        members = dist.get_process_group_ranks(group)
        counts = stream_counts(sizes, offset, length)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        names = list(mesh.mesh_dim_names)

        def held(rank):
            coord = (mesh.mesh == rank).nonzero()[0].tolist()
            s = coord[names.index(axis)]
            d = coord[names.index(batch_axis)] if lb < batch else 0
            return fold_rows(range(d * lb, (d + 1) * lb), length,
                             starts[s], starts[s] + counts[s])

        rows = [held(r) for r in members]
        # the stream's rows that these ranks hold, whole groups of it
        lo = min(int(r.min()) for r in rows if r.size)
        total = sum(r.size for r in rows)
        bounds = lo + np.concatenate([[0], np.cumsum(
            token_split(total, len(members), bm))])
        me = members.index(dist.get_rank())
        send = [int(((rows[me] >= a) & (rows[me] < b)).sum())
                for a, b in zip(bounds, bounds[1:])]
        a, b = bounds[me], bounds[me + 1]
        got = [r[(r >= a) & (r < b)] for r in rows]
        order = np.concatenate(got)
        perm = np.argsort(order, kind='stable')
        device = (torch.device('cuda', torch.cuda.current_device())
                  if mesh.device_type == 'cuda' else torch.device('cpu'))
        return MlpRoute(group, send, [g.size for g in got],
                        None if (perm == np.arange(perm.size)).all()
                        else perm, b - a, device)

    def to_mlp(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows [n_local, C] (its fold order) -> its rows of
        the MLP split [n_rows, C] (the stream's fold order)."""
        out = x.new_empty((sum(self.recv),) + x.shape[1:])
        dist.all_to_all_single(out, x.contiguous(), self.recv, self.send,
                               group=self.group)
        return out if self.perm is None else out[self.perm]

    def back(self, y: torch.Tensor) -> torch.Tensor:
        """The inverse of ``to_mlp``, for the MLP's output."""
        if self.inv is not None:
            y = y[self.inv]
        out = y.new_empty((sum(self.send),) + y.shape[1:])
        dist.all_to_all_single(out, y.contiguous(), self.send, self.recv,
                               group=self.group)
        return out


@dataclass(frozen=True)
class TokenShards:
    """How the joint sequence is split over ``axis`` of ``mesh``:
    ``sizes[r]`` tokens on rank r, in order; ``batch_axis`` is the axis
    the batch is sharded over (or None).  ``routes[i]`` is the
    ``MlpRoute`` of the i-th MLP token stream given to ``plan`` (None
    where its MLP runs on the rank's own tokens) and ``mlp_rows[i]`` the
    rows of that stream's MLP on this rank."""
    mesh: object
    axis: str
    batch_axis: Optional[str]
    sizes: Tuple[int, ...]
    routes: Tuple[Optional[MlpRoute], ...] = ()
    mlp_rows: Tuple[int, ...] = ()

    @property
    def rank(self) -> int:
        return axis_rank(self.mesh, self.axis)

    @property
    def n(self) -> int:
        return len(self.sizes)

    @property
    def start(self) -> int:
        return sum(self.sizes[:self.rank])

    @property
    def stop(self) -> int:
        return self.start + self.sizes[self.rank]

    def local(self, x: torch.Tensor, offset: int = 0, dim: int = 1
              ) -> torch.Tensor:
        """This rank's tokens of ``x``, a stream that starts at joint
        position ``offset``."""
        n = x.shape[dim]
        a = min(max(self.start - offset, 0), n)
        b = min(max(self.stop - offset, a), n)
        return x.narrow(dim, a, b - a)

    def gather(self, x: torch.Tensor, offset: int, length: int,
               dim: int = 1) -> torch.Tensor:
        """The whole stream [offset, offset + length) from every rank's
        ``local`` part of it."""
        return gather_tokens(x, self.mesh, self.axis,
                             stream_counts(self.sizes, offset, length), dim)

    def rows(self, B: int) -> int:
        """The batch rows this rank holds of a batch of B."""
        sl = local_batch(self.mesh, self.batch_axis, B)
        return sl.stop - sl.start

    def stream(self, offset: int, length: int) -> int:
        """This rank's tokens of the stream [offset, offset + length)."""
        return stream_counts(self.sizes, offset, length)[self.rank]

    @staticmethod
    def plan(mesh, axis: str, batch_axis: Optional[str], seq_len: int,
             mlp_cfg, streams=(), batch: int = 1) -> "TokenShards":
        """The split of ``seq_len`` tokens over ``axis`` and the MLP
        routes of each of the sparse MLP's token streams (offset, length)
        in ``streams``, for a batch of ``batch``.  Where the MLP is on
        and a split in whole groups of ``mlp_cfg.bm`` tokens keeps every
        stream's groups whole on their ranks (``whole_groups``), that
        split, and every MLP runs on the rank's own tokens.  Else the
        tokens split as evenly as they allow, and each stream whose
        groups that split cuts gets an ``MlpRoute``."""
        n = axis_size(mesh, axis)
        sl = local_batch(mesh, batch_axis, batch)
        lb = sl.stop - sl.start
        bm = mlp_cfg.bm if mlp_cfg.is_enabled else 1

        def wholes(sizes):
            return [bm == 1 or whole_groups(sizes, off, length, batch, lb,
                                            bm) for off, length in streams]

        sizes = token_split(seq_len, n, bm)
        whole = wholes(sizes)
        if not (-(-seq_len // bm) >= n and all(whole)):
            sizes = token_split(seq_len, n, 1)
            whole = wholes(sizes)
        shards = TokenShards(mesh, axis, batch_axis, sizes)
        routes, rows = [], []
        for (off, length), w in zip(streams, whole):
            route = None if w else MlpRoute.plan(
                mesh, axis, batch_axis, sizes, off, length, batch, lb, bm)
            routes.append(route)
            rows.append(route.n_rows if route is not None
                        else lb * shards.stream(off, length))
        return TokenShards(mesh, axis, batch_axis, sizes, tuple(routes),
                           tuple(rows))


# -------------------------------------------------------------------- batch

def local_batch(mesh, dp: Optional[str], B: int) -> slice:
    """This rank's rows of a batch of B sharded over ``dp`` (all of them
    when dp is None or does not divide B)."""
    n = axis_size(mesh, dp)
    if n == 1 or B % n:
        return slice(0, B)
    r = axis_rank(mesh, dp)
    return slice(r * B // n, (r + 1) * B // n)


def gather_batch(x: torch.Tensor, mesh, dp: Optional[str], B: int
                 ) -> torch.Tensor:
    """The whole batch of B rows from every rank's ``local_batch``."""
    n = axis_size(mesh, dp)
    if n == 1 or B % n:
        return x
    out = x.new_empty((B,) + x.shape[1:])
    _all_gather(out, x.contiguous(), group=mesh.get_group(dp))
    return out


def _place_params(params, mesh, sp, fsdp):
    if not dist.is_initialized():
        raise RuntimeError('a sharded model needs a process group')
    return shard_params(params, mesh, sp) if fsdp else params


def place_video_inputs(mesh, params, arrays, state, sp: str = 'sp',
                       dp: Optional[str] = None, fsdp: bool = False):
    """(params, arrays, state) for this rank: the params whole or
    FSDP-sharded over ``sp``, each batch-leading array of ``arrays`` cut
    to this rank's batch (None stays None), and ``state``, which the
    sharded model created at this rank's size."""
    params = _place_params(params, mesh, sp, fsdp)
    placed = tuple(None if a is None
                   else a[local_batch(mesh, dp, a.shape[0])]
                   for a in arrays)
    return params, placed, state


def place_flux_inputs(mesh, params, img, txt, y, state, sp: str = 'sp',
                      dp: Optional[str] = None, fsdp: bool = False):
    """``place_video_inputs`` for a FLUX denoise: the placed (params,
    img, txt, y, state)."""
    params, (img, txt, y), state = place_video_inputs(
        mesh, params, (img, txt, y), state, sp, dp, fsdp)
    return params, img, txt, y, state
