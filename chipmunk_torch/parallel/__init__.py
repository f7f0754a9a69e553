"""Multi-card sampling on ``torch.distributed``: Ulysses all-to-all, ring
and USP attention, FSDP and state placement (the counterpart of
``chipmunk_tpu/parallel``).  Importing creates no process group."""
from .comm import (collect_tokens, collect_heads, ulysses_attention,
                   make_mesh, initialize_multihost, rank_generator)
from .ring import ring_attention, usp_attention
from .sharding import fsdp_shardings, shard_params

__all__ = ['collect_tokens', 'collect_heads', 'ulysses_attention',
           'make_mesh', 'ring_attention', 'usp_attention',
           'fsdp_shardings', 'shard_params', 'initialize_multihost',
           'rank_generator']
