"""Hand-written CUDA kernels for Hopper (sm_90a) with their wrappers and
plain PyTorch versions.  Importing this package builds nothing: each
library is compiled by nvcc on the first launch (or by
``_build.build_all``)."""
from .flash_attention import dense_attn, dense_colsum_attn
from .csp_attention import csp_attn, pad_block_indices
from .csp_mlp import csp_mlp, csp_mlp_fused, csp_mlp_mm1, csp_mlp_mm2
from ._build import LAUNCHES, build_all, reset_launches

__all__ = ['dense_attn', 'dense_colsum_attn', 'csp_attn',
           'pad_block_indices', 'csp_mlp', 'csp_mlp_fused', 'csp_mlp_mm1',
           'csp_mlp_mm2', 'LAUNCHES', 'build_all', 'reset_launches']
