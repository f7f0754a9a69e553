"""Weights drawn from a seed on the device in one call: one flat buffer
of normal draws in the served dtype, carved into leaves and scaled leaf
by leaf in place.  The same seed, layout and device give the same bytes,
so the reference can draw them again once the program's copy is gone."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import torch

Path = Tuple[Union[str, int], ...]
# (path into the nested tree, shape, mean, std)
Leaf = Tuple[Path, Tuple[int, ...], float, float]
ALIGN = 128           # leaf offsets in elements: TMA wants 16-byte bases


def numel(spec: Sequence[Leaf]) -> int:
    n = 0
    for _, shape, _, _ in spec:
        k = 1
        for d in shape:
            k *= d
        n += -(-k // ALIGN) * ALIGN
    return n


def _put(tree, path: Path, leaf):
    """Set ``tree[path]``; an int key makes the level a list."""
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append(None)
            if node[key] is None:
                node[key] = [] if isinstance(nxt, int) else {}
            node = node[key]
        else:
            if key not in node:
                node[key] = [] if isinstance(nxt, int) else {}
            node = node[key]
    last = path[-1]
    if isinstance(node, list):
        while len(node) <= last:
            node.append(None)
    node[last] = leaf


def draw(spec: List[Leaf], seed: int, dtype: torch.dtype,
         device: torch.device) -> Dict:
    """The nested tree of ``spec``'s leaves, each ``mean + std * N(0, 1)``
    in ``dtype`` on ``device``, all from one normal draw of a generator on
    ``device`` seeded with ``seed``."""
    gen = torch.Generator(device).manual_seed(seed)
    flat = torch.randn(numel(spec), generator=gen, device=device,
                       dtype=dtype)
    tree: Dict = {}
    off = 0
    for path, shape, mean, std in spec:
        k = 1
        for d in shape:
            k *= d
        leaf = flat[off:off + k].view(shape)
        leaf.mul_(std)
        if mean:
            leaf.add_(mean)
        _put(tree, path, leaf)
        off += -(-k // ALIGN) * ALIGN
    return tree
