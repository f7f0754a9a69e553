"""State and params checkpoints, the port's counterpart of
``chipmunk_tpu/utils/checkpoint.py``, in the reference's ``.npz`` format.

Format v2: every leaf is stored under ``path:`` plus the key that
``jax.tree_util.keystr`` gives its place in the tree (``['k']`` for a
dict key, ``[i]`` for a list or tuple item, ``.name`` for a NamedTuple
field or a QTensor's ``q`` / ``scale``), computed here by the port's own
walker; None is an empty subtree and dicts are walked in sorted key
order, as in JAX.  So a port tree shaped like a reference tree writes
the same keys, and bf16 and fp8 leaves, which numpy has no type for, are
written as their raw bytes under the void type numpy gives them
(``<V2``, ``<V1``): the file is byte for byte what the reference
writes.  Loading matches leaves by path: a path of ``like`` that the file
lacks keeps ``like``'s value, a shape or dtype that differs raises, and a
void leaf is read back as ``like``'s dtype where the item sizes match.
v1 files (positional ``leaf_i``) load by position, strictly.

A mid-generation resume saves the loop's whole state: the latent, the
last prediction (a skipped step reuses it), the ``FluxState`` /
``WanState`` (per-layer lists, None entries skipped) and the loop's
``torch.Generator`` state as a uint8 leaf, since the random keeps come
from that generator::

    save_pytree(path, {'img': img, 'pred': pred, 'state': state,
                       'generator': generator.get_state()})
    ck = load_pytree(path, {'img': img0, 'pred': pred0, 'state': fresh,
                            'generator': generator.get_state()})
    generator.set_state(ck['generator'])

``flux_state_from_jax`` / ``wan_state_from_jax`` turn the reference's
stacked ``[L, ...]`` state (a tree of arrays, such as ``load_pytree(path)``
of a file that the reference's ``save_pytree`` wrote) into the port's
per-layer lists::

    tree = load_pytree(path)                   # nested dicts of arrays
    state = flux_state_from_jax(tree['state'], sp.init_state(cfg, B))
"""
from __future__ import annotations

import os
import re
import zipfile
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

from .quant import QTensor

# torch dtypes that numpy has no type for: stored as raw bytes
_RAW = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8,
        torch.float8_e5m2: torch.uint8}
_INT = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, '_fields')


def _paths(tree, prefix: str = '') -> Iterator[Tuple[str, Any]]:
    """(keystr, leaf) of every leaf, in JAX's flattening order."""
    if tree is None:
        return
    if isinstance(tree, QTensor):
        yield from _paths(tree.q, prefix + '.q')
        yield from _paths(tree.scale, prefix + '.scale')
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from _paths(getattr(tree, f), f'{prefix}.{f}')
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f'{prefix}[{k!r}]')
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f'{prefix}[{i}]')
    else:
        yield prefix, tree


def _rebuild(tree, leaves: Iterator):
    """``tree`` with its leaves replaced, in ``_paths`` order."""
    if tree is None:
        return None
    if isinstance(tree, QTensor):
        return QTensor(_rebuild(tree.q, leaves), _rebuild(tree.scale, leaves),
                       tree.pack_axis)
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, f), leaves)
                            for f in tree._fields))
    if isinstance(tree, dict):
        new = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _host(x) -> Tuple[np.ndarray, str]:
    """(C-ordered numpy array, npy descr) of a tensor or array leaf."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype in _RAW:
            a = x.view(_RAW[x.dtype]).numpy()
            return a, f'<V{a.dtype.itemsize}'
        x = x.numpy()
    a = np.asarray(x, order='C')
    return a, np.lib.format.dtype_to_descr(a.dtype)


def save_pytree(path: str, tree: Any) -> None:
    """Write every leaf of ``tree`` (tensors on any device, numpy arrays)
    under its path, as ``np.savez`` does (``.npz`` appended to a name
    without it)."""
    items = list(_paths(tree))
    keys = [k for k, _ in items]
    if len(set(keys)) != len(keys):
        raise ValueError('duplicate tree paths')
    path = os.fspath(path)
    if not path.endswith('.npz'):
        path += '.npz'
    with zipfile.ZipFile(path, mode='w', compression=zipfile.ZIP_STORED,
                         allowZip64=True) as z:
        for k, x in items:
            a, descr = _host(x)
            with z.open(f'path:{k}.npy', 'w', force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(f, {
                    'descr': descr, 'fortran_order': False,
                    'shape': a.shape})
                f.write(a.tobytes())


def _as_like(a: np.ndarray, like: torch.Tensor, where: str
             ) -> torch.Tensor:
    """The file's array ``a`` as a tensor like ``like``: the same shape
    and dtype (a void array read as ``like``'s dtype of the same item
    size), on ``like``'s device."""
    if tuple(a.shape) != tuple(like.shape):
        raise ValueError(f'{where}: the file holds shape {tuple(a.shape)}, '
                         f'the tree {tuple(like.shape)}')
    size = like.element_size()
    if a.dtype.kind == 'V':
        if a.dtype.itemsize != size:
            raise ValueError(f'{where}: the file holds {a.dtype.itemsize}-'
                             f'byte raw items, the tree {like.dtype}')
        t = torch.from_numpy(a.view(_INT[size]).copy()).view(like.dtype)
    else:
        t = torch.from_numpy(a.copy())
        if t.dtype != like.dtype:
            raise ValueError(f'{where}: the file holds {a.dtype}, the tree '
                             f'{like.dtype}')
    return t.to(like.device)


def load_pytree(path: str, like: Any = None) -> Any:
    """The leaves that ``save_pytree`` wrote, in the structure of
    ``like``.  Path-keyed (v2) files match leaves by path: a path of
    ``like`` that the file lacks keeps ``like``'s value (a field added
    since the save); a matched leaf must have ``like``'s shape and dtype
    (ValueError naming the path).  Positional (v1) files need exactly
    ``like``'s leaves.  ``like``'s leaves are tensors, and each loads onto
    its device.  Without
    ``like``, a v2 file's numpy arrays as nested dicts along their paths
    (a field, a dict key or an index each a key; bf16 and fp8 leaves as
    numpy's raw void arrays), as a file the reference wrote is read for
    ``flux_state_from_jax``."""
    if like is None:
        return _read_tree(path)
    items = list(_paths(like))
    with np.load(path) as data:
        keys = set(data.files)
        if any(k.startswith('path:') for k in keys):
            out = [_as_like(data[f'path:{k}'], leaf, k)
                   if f'path:{k}' in keys else leaf for k, leaf in items]
        else:
            n = sum(k.startswith('leaf_') for k in keys)
            if n != len(items):
                raise ValueError(f'a positional checkpoint of {n} leaves, '
                                 f'the tree has {len(items)}')
            out = [_as_like(data[f'leaf_{i}'], leaf, f'leaf_{i}')
                   for i, (_, leaf) in enumerate(items)]
    return _rebuild(like, iter(out))


# -------------------------------------------- the reference's stacked state

_KEY = re.compile(r"\.(\w+)|\['([^']*)'\]|\[(\d+)\]")


def _read_tree(path: str) -> Dict:
    """The arrays of a v2 file as nested dicts along their paths."""
    tree: Dict = {}
    with np.load(path) as data:
        for name in data.files:
            if not name.startswith('path:'):
                raise ValueError(f'{path} is not a path-keyed checkpoint')
            parts = [a or b or int(c) for a, b, c in
                     _KEY.findall(name[len('path:'):])]
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[name]
    return tree


def _field(tree, name: str):
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def _state_from_jax(np_state, like):
    fields = {}
    for name in like._fields:
        stacked, layers = _field(np_state, name), getattr(like, name)
        out: List = []
        for i, lk in enumerate(layers):
            if lk is None:
                out.append(None)
                continue
            out.append(type(lk)(**{
                f: None if getattr(lk, f) is None else _as_like(
                    np.asarray(_field(stacked, f))[i], getattr(lk, f),
                    f'.{name}.{f}[{i}]')
                for f in lk._fields}))
        fields[name] = out
    return type(like)(**fields)


def flux_state_from_jax(np_state, like):
    """The reference's FLUX or HunyuanVideo ``FluxState`` (its fields
    stacked ``[L, ...]``; a tree of numpy arrays with attribute or key
    access, such as ``load_pytree(path)`` of a file that its
    ``save_pytree`` wrote) as the port's ``FluxState`` in
    the structure of ``like``: per-layer lists, None where ``like`` keeps
    no cache (the reference keeps a placeholder there), each leaf of
    ``like``'s shape, dtype and device."""
    return _state_from_jax(np_state, like)


def wan_state_from_jax(np_state, like):
    """``flux_state_from_jax`` for the reference's ``WanState``."""
    return _state_from_jax(np_state, like)
