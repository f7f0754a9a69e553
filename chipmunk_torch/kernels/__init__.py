"""Hand-written CUDA kernels for Hopper (sm_90a) with their wrappers and
plain PyTorch versions.  Importing this package builds nothing: each
library is compiled by nvcc on the first launch (or by
``_build.build_all``)."""
from .flash_attention import dense_attn, dense_colsum_attn
from .csp_attention import (csp_attn, csp_attn_hbm, csp_attn_hbm_plain,
                            pack_kv, pad_block_indices)
from .csp_mlp import (csp_mlp, csp_mlp_fused, csp_mlp_mm1, csp_mlp_mm1_a8,
                      csp_mlp_mm2, csp_mlp_mm2_a8, quant_rows)
from .int8_probe import int8_probe
from .qkv_prologue import QkvStream, qkv_prologue
from ._build import LAUNCHES, build_all, reset_launches

__all__ = ['dense_attn', 'dense_colsum_attn', 'csp_attn', 'csp_attn_hbm',
           'csp_attn_hbm_plain', 'pack_kv', 'pad_block_indices', 'csp_mlp',
           'csp_mlp_fused', 'csp_mlp_mm1', 'csp_mlp_mm2', 'quant_rows', 'csp_mlp_mm1_a8', 'csp_mlp_mm2_a8',
           'int8_probe', 'QkvStream', 'qkv_prologue', 'LAUNCHES', 'build_all', 'reset_launches']
