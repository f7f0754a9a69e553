"""chipmunk_torch: the PyTorch/CUDA port of chipmunk for NVIDIA Hopper.

Training-free dynamic sparsity for diffusion transformers: column-sparse
delta attention and MLP with step caching, run by hand-written sm_90a
kernels (``chipmunk_torch/csrc``).  The JAX package ``chipmunk_tpu`` is
the reference; this package imports nothing of it.

Importing builds nothing: the kernels are compiled by nvcc on first use.
Entry points run on the card and raise without one unless the caller
passes ``device='cpu'``, where the kernels' plain PyTorch versions run.
"""
from . import config, schedule
from .config import ChipmunkConfig, config_from_dict, load_config

__version__ = "0.1.0"
