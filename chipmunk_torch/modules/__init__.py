from .attn import AttnState, SparseDiffAttn, init_attn_state
from .mlp import MlpState, SparseDiffMlp

__all__ = ['SparseDiffAttn', 'AttnState', 'init_attn_state',
           'SparseDiffMlp', 'MlpState']
