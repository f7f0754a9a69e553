"""Utilities of the port: quantized weight residency (``quant``), host
offload (``offload``) and layer-chunked streaming (``streaming``)."""
from .offload import (DoubleBufferedLoader, OffloadPolicy, fetch_to_device,
                      offload_to_host)
from .streaming import StreamedScan, chunk_tree, unchunk_tree

__all__ = ['offload_to_host', 'fetch_to_device', 'OffloadPolicy',
           'DoubleBufferedLoader', 'chunk_tree', 'unchunk_tree',
           'StreamedScan']
