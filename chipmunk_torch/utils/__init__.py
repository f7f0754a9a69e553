"""Utilities of the port: quantized weight residency (``quant``), host
offload (``offload``), layer-chunked streaming (``streaming``), the
tracer, profiler region and step timer (``profiling``), checkpoints
(``checkpoint``) and the host C++ library (``native``)."""
from .checkpoint import load_pytree, save_pytree
from .offload import (DoubleBufferedLoader, OffloadPolicy, fetch_to_device,
                      offload_to_host)
from .profiling import StepTimer, profile_region
from .streaming import StreamedScan, chunk_tree, unchunk_tree

__all__ = ['offload_to_host', 'fetch_to_device', 'OffloadPolicy',
           'DoubleBufferedLoader', 'chunk_tree', 'unchunk_tree',
           'StreamedScan', 'profile_region', 'StepTimer', 'save_pytree',
           'load_pytree']
