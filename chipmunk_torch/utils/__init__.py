"""Utilities of the port: quantized weight residency (``quant``)."""
