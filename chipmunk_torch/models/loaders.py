"""Checkpoint loaders (torch), the counterpart of
``chipmunk_tpu/models/loaders.py``.  It holds the FLUX autoencoder's
decoder loader; the FLUX, HunyuanVideo and Wan model loaders are not
ported yet.  ``safetensors`` is imported inside the loader: the package
does not depend on it.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..device import DeviceLike, resolve_device


def load_ae_decoder_safetensors(path: str,
                                dtype: torch.dtype = torch.float32,
                                device: DeviceLike = 'cuda') -> Dict:
    """The ``decoder.*`` subtree of BFL's ``ae.safetensors`` as the
    ``autoencoder.decode`` tree, weights as stored (OIHW), in ``dtype``
    on ``device``: dotted keys become nested dicts, the ``block``
    sequences lists, ``up`` a dict of level -> subtree."""
    from safetensors import safe_open
    dev = resolve_device(device)
    tree: Dict = {}
    with safe_open(path, framework='pt') as f:
        for k in f.keys():
            if not k.startswith('decoder.'):
                continue
            parts = k[len('decoder.'):].split('.')
            cur = tree
            for p in parts[:-1]:
                cur = cur.setdefault(int(p) if p.isdigit() else p, {})
            cur[parts[-1]] = f.get_tensor(k).to(device=dev, dtype=dtype)

    def listify(d):
        if isinstance(d, dict):
            if d and all(isinstance(x, int) for x in d) \
                    and set(d) == set(range(len(d))):
                return [listify(d[i]) for i in range(len(d))]
            return {k: listify(v) for k, v in d.items()}
        return d

    tree = {k: listify(v) for k, v in tree.items()}
    if isinstance(tree.get('up'), list):
        tree['up'] = dict(enumerate(tree['up']))
    return {'decoder': tree}
