"""block_glue_ms: glue device milliseconds per generation
(``core.trace.is_glue``: neither the port's kernels nor GEMMs) launched
in a ``block.double`` or ``block.single`` span but outside its ``attn``
and ``mlp`` spans (``core/spans.py``): the blocks' norms, modulation,
RoPE and residuals."""
from benchmarks.core.spans import device_us, placed
from benchmarks.core.trace import is_glue


def _block_glue(name, path):
    return is_glue(name) and 'attn' not in path and 'mlp' not in path \
        and any(s.startswith('block.') for s in path)


def read(run):
    us = device_us(placed(run.trace), _block_glue)
    return None if us is None else us / 1e3 / run.trace.generations
