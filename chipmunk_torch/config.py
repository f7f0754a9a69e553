"""Chipmunk configuration (the port's copy of ``chipmunk_tpu/config.py``).

Same dataclasses, keys and defaults as the reference, immutable and passed
explicitly.  ``load_config`` reads ``configs/*.yml`` with a small parser of
its own (:func:`parse_yaml`), because pyyaml is not installed on every
machine the port runs on.
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Any, Dict, FrozenSet, List, Optional, Tuple


def _freeze(x):
    if isinstance(x, (set, frozenset)):
        return frozenset(x)
    if isinstance(x, list):
        return tuple(x)
    return x


@dataclass(frozen=True)
class MlpConfig:
    is_enabled: bool = True
    is_fp8: bool = False
    top_keys: float = 0.3
    random_keys: float = 0.05
    full_step_every: int = 10
    block_mask_cache: int = 2
    first_n_dense_layers: int = 2
    counts_multiple_of: int = 256
    bm: int = 128                  # token block sharing one neuron set
    mbm: int = 128                 # block-mean group size
    neuron_block: int = 128        # neurons per gathered weight block
    max_selected_frac: float = 0.5
    act_cache_dtype: Optional[str] = None   # [T, N] cache dtype name
    out_cache_dtype: Optional[str] = None   # [T, C] cache dtype name
    int8_act: bool = False


@dataclass(frozen=True)
class AttnConfig:
    is_enabled: bool = True
    top_keys: float = 0.05
    random_keys: float = 0.01
    local_voxels: int = 0
    local_1d_window: float = 0.0
    first_n_dense_layers: int = 2
    full_step_every: int = 10
    full_step_schedule: Optional[FrozenSet[int]] = None
    recompute_mask: bool = True
    should_compress_indices: bool = True
    materialize_indices: Optional[bool] = None
    counts_multiple_of: int = 128
    pad_qkv_before_kernel: bool = True
    mbm: int = 128                 # query-group size
    kv_block: int = 128            # keys per gathered KV block
    max_selected_frac: float = 0.5
    # when the per-group selection capacity reaches this fraction of the KV
    # blocks the layer runs dense every step (1.0 disables the gate)
    dense_fallback_frac: float = 0.45
    out_cache_dtype: Optional[str] = None   # [B,H,S,D] cache dtype name


@dataclass(frozen=True)
class PatchifyConfig:
    is_enabled: bool = True
    chunk_size_1: int = 8
    chunk_size_2: int = 4


@dataclass(frozen=True)
class OffloadingConfig:
    global_disable_offloading: bool = False
    mlp_out_cache: bool = False
    mlp_indices: bool = False
    mlp_counts: bool = False
    mlp_sparse_act_T: bool = False
    mlp_blockmean_mid_cache: bool = False
    attn_out_cache: bool = True
    attn_indices: bool = True
    attn_counts: bool = False
    attn_lse_constants: bool = False
    text_encoders: bool = True


@dataclass(frozen=True)
class StepCachingConfig:
    is_enabled: bool = True
    skip_step_schedule: FrozenSet[int] = frozenset(
        {7, 11, 13, 14, 15, 17, 18, 19, 21, 22, 23, 25, 26, 27, 29,
         31, 33, 34, 35, 37, 38, 39, 41, 42, 43})


@dataclass(frozen=True)
class ChipmunkConfig:
    num_model_invocations_per_inference_step: int = 1
    should_profile: bool = False
    generation_index: int = 0
    steps: int = 50
    world_size: int = 1
    mlp: MlpConfig = field(default_factory=MlpConfig)
    attn: AttnConfig = field(default_factory=AttnConfig)
    patchify: PatchifyConfig = field(default_factory=PatchifyConfig)
    offloading: OffloadingConfig = field(default_factory=OffloadingConfig)
    step_caching: StepCachingConfig = field(default_factory=StepCachingConfig)

    def replace(self, **kw) -> "ChipmunkConfig":
        return dataclasses.replace(self, **kw)


_DOTTED = {  # offloading keys use dots; dataclass fields use underscores
    'mlp.out_cache': 'mlp_out_cache', 'mlp.indices': 'mlp_indices',
    'mlp.counts': 'mlp_counts', 'mlp.sparse_act_T': 'mlp_sparse_act_T',
    'mlp.blockmean_mid_cache': 'mlp_blockmean_mid_cache',
    'attn.out_cache': 'attn_out_cache', 'attn.indices': 'attn_indices',
    'attn.counts': 'attn_counts', 'attn.lse_constants': 'attn_lse_constants',
}


def _merge_dataclass(dc, updates: Dict[str, Any]):
    kw = {}
    names = {f.name for f in dataclasses.fields(dc)}
    for k, v in updates.items():
        k = _DOTTED.get(k, k)
        if k not in names:
            raise KeyError(f"unknown config key {k!r} for {type(dc).__name__}")
        cur = getattr(dc, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            kw[k] = _merge_dataclass(cur, v)
        else:
            kw[k] = _freeze(v)
    return dataclasses.replace(dc, **kw)


def config_from_dict(d: Dict[str, Any],
                     base: Optional[ChipmunkConfig] = None) -> ChipmunkConfig:
    """Deep-merge a (possibly partial, YAML-shaped) dict onto ``base``."""
    return _merge_dataclass(base or ChipmunkConfig(), d or {})


def load_config(path: str, base: Optional[ChipmunkConfig] = None
                ) -> ChipmunkConfig:
    """Load a chipmunk config file (``configs/*.yml``)."""
    with open(path) as f:
        return config_from_dict(parse_yaml(f.read()) or {}, base)


# ---------------------------------------------------------------- YAML

_INT = re.compile(r'^[-+]?[0-9]+$')
_FLOAT = re.compile(r'^[-+]?(?:[0-9][0-9_]*)?\.[0-9_]*(?:[eE][-+]?[0-9]+)?$')
_BOOL = {'true': True, 'True': True, 'TRUE': True, 'yes': True,
         'Yes': True, 'on': True, 'On': True,
         'false': False, 'False': False, 'FALSE': False, 'no': False,
         'No': False, 'off': False, 'Off': False}


def _scalar(s: str) -> Any:
    if s in ('~', 'null', 'Null', 'NULL', ''):
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        return int(s)
    if _FLOAT.match(s) and s not in ('.', '+.', '-.'):
        return float(s.replace('_', ''))
    if len(s) >= 2 and s[0] == s[-1] and s[0] in '\'"':
        return s[1:-1]
    return s


def _strip_comment(line: str) -> str:
    """Drop a '#' comment (at line start or after a space, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in '\'"':
            quote = ch
        elif ch == '#' and (i == 0 or line[i - 1].isspace()):
            return line[:i].rstrip()
    return line.rstrip()


def parse_yaml(text: str) -> Any:
    """Parse the YAML subset that ``configs/*.yml`` use: nested block
    mappings, flow sequences ``[a, b]`` (also across lines), ``!!set``
    blocks of ``? item`` lines, and scalars (``~``, bools, ints, floats,
    plain or quoted strings).  Returns what ``yaml.safe_load`` returns for
    those files."""
    lines: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if line.strip():
            lines.append((len(line) - len(line.lstrip(' ')), line.strip()))
    value, pos = _block(lines, 0, 0)
    if pos != len(lines):
        raise ValueError(f'unparsed YAML from line: {lines[pos][1]!r}')
    return value


def _block(lines, pos: int, indent: int):
    """Parse the mapping or '? ' set whose entries sit at ``indent``."""
    if pos < len(lines) and lines[pos][1].startswith('? '):
        items = set()
        while pos < len(lines) and lines[pos][0] == indent \
                and lines[pos][1].startswith('? '):
            items.add(_scalar(lines[pos][1][2:].strip()))
            pos += 1
        return items, pos
    out: Dict[str, Any] = {}
    while pos < len(lines) and lines[pos][0] == indent:
        text = lines[pos][1]
        key, sep, rest = text.partition(':')
        if not sep:
            raise ValueError(f'expected "key: value", got {text!r}')
        key, rest = key.strip(), rest.strip()
        pos += 1
        if rest.startswith('['):
            while not rest.endswith(']'):
                rest += ' ' + lines[pos][1]
                pos += 1
            inner = rest[1:-1].strip()
            out[key] = [_scalar(x.strip()) for x in inner.split(',')] \
                if inner else []
        elif rest in ('', '!!set'):
            if pos < len(lines) and lines[pos][0] > indent:
                val, pos = _block(lines, pos, lines[pos][0])
                out[key] = set(val) if rest == '!!set' else val
            else:
                out[key] = None
        else:
            out[key] = _scalar(rest)
    return out, pos
