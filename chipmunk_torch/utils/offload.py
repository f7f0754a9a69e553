"""Which caches a configuration keeps in host memory: the port's copy of
``OffloadPolicy`` from ``chipmunk_tpu/utils/offload.py``.  Nothing here
moves memory yet; ``HunyuanModel`` reads the policy to decide whether
compressed attention states also keep their index lists
(``materialize_indices``)."""
from __future__ import annotations

from dataclasses import dataclass

from ..config import OffloadingConfig


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
