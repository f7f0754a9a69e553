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
  where the group count asks for it, and refuses a geometry where a
  boundary must cut a group of one of the MLP's token streams.
* State: created at the rank's size (``H/n`` heads of the rank's batch,
  the MLP caches of the rank's token groups), which is what the
  reference's ``chipmunk_state_shardings`` places on each device.
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


def check_groups(sizes: Sequence[int], offset: int, length: int,
                 batch: int, local_batch: int, bm: int, what: str) -> None:
    """Raise ValueError unless the MLP token groups of every rank's part
    of the stream [offset, offset + length) are whole groups of the
    unsharded stream.  The MLP folds the batch into its token axis
    (``[B*T]``, B = ``batch``) and groups ``bm`` consecutive rows; each
    rank holds ``local_batch`` consecutive batch rows and its shard of
    the tokens of each."""
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    T = batch * length
    for b0 in range(0, batch, local_batch):
        for r, (s, z) in enumerate(zip(starts, sizes)):
            a = max(s, offset) - offset
            b = min(s + z, offset + length) - offset
            if b <= a:
                continue
            # the rank's rows of the global fold, in its local fold order
            rows = ((b0 + np.arange(local_batch))[:, None] * length
                    + np.arange(a, b)[None]).reshape(-1)
            for g0 in range(0, rows.size, bm):
                grp = rows[g0:g0 + bm]
                if not (grp[0] % bm == 0
                        and (grp.size == bm or grp[-1] == T - 1)
                        and grp[-1] - grp[0] == grp.size - 1):
                    raise ValueError(
                        f'no whole-group split: {what} of {length} tokens '
                        f'(batch {batch}, {local_batch} a rank) over '
                        f'shards {tuple(sizes)} cuts an MLP token group of '
                        f'bm {bm} on rank {r}')


@dataclass(frozen=True)
class TokenShards:
    """How the joint sequence is split over ``axis`` of ``mesh``:
    ``sizes[r]`` tokens on rank r, in order; ``batch_axis`` is the axis
    the batch is sharded over (or None)."""
    mesh: object
    axis: str
    batch_axis: Optional[str]
    sizes: Tuple[int, ...]

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
        """The split of ``seq_len`` tokens over ``axis``: in whole groups
        of ``mlp_cfg.bm`` tokens where the sparse MLP is on, checked
        against each of its token streams (name, offset, length) in
        ``streams`` with the batch of ``batch`` (``check_groups``), else
        as even as tokens allow.  Raises ValueError naming the sizes where
        no such split exists."""
        n = axis_size(mesh, axis)
        unit = mlp_cfg.bm if mlp_cfg.is_enabled else 1
        if -(-seq_len // unit) < n:
            raise ValueError(
                f'no whole-group split: {seq_len} tokens in groups of '
                f'{unit} are fewer groups than the {n} ranks of {axis}')
        sizes = token_split(seq_len, n, unit)
        if mlp_cfg.is_enabled:
            sl = local_batch(mesh, batch_axis, batch)
            for what, off, length in streams:
                check_groups(sizes, off, length, batch, sl.stop - sl.start,
                             unit, what)
        return TokenShards(mesh, axis, batch_axis, sizes)


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
