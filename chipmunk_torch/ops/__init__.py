"""Eager torch ops: attention/MLP references, index ops, bit packing, the
fp8 rule and the token reorders.  Exports the JAX package's op surface
(``chipmunk_tpu/ops/__init__.py``)."""
from .attn_ref import (LOG2E, attn_scale, csp_attn_ref, csp_block_attn_ref,
                       dense_attn_ref, dense_colsum_attn_ref)
from .bitpack import bitpack, bitpack_rows, bitunpack, bitunpack_rows
from .indexing import (blockify_scores, copy_indices, mask_to_indices,
                       merge_indices, random_and_topk_mask, scatter_add,
                       topk_indices, topk_mask)
from .mlp_ref import block_mean, csp_mlp_ref, dense_mlp_ref
from .patch import patchify, patchify_rope, unpatchify
from .voxel import (get_local_indices_with_text, get_local_voxel_indices,
                    local_1d_window_mask, reverse_voxel_chunk_no_padding,
                    voxel_chunk_no_padding)

__all__ = [
    'dense_attn_ref', 'dense_colsum_attn_ref', 'csp_attn_ref',
    'csp_block_attn_ref', 'attn_scale', 'LOG2E',
    'block_mean', 'csp_mlp_ref', 'dense_mlp_ref',
    'merge_indices', 'scatter_add', 'topk_mask', 'random_and_topk_mask',
    'mask_to_indices', 'topk_indices', 'copy_indices', 'blockify_scores',
    'bitpack', 'bitunpack', 'bitpack_rows', 'bitunpack_rows',
    'patchify', 'unpatchify', 'patchify_rope',
    'voxel_chunk_no_padding', 'reverse_voxel_chunk_no_padding',
    'get_local_voxel_indices', 'get_local_indices_with_text',
    'local_1d_window_mask',
]
