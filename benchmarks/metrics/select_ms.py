"""select_ms: device milliseconds per generation in the kernels, copies
and memsets launched in the ``attn.select`` and ``mlp.select`` spans
(``core/spans.py``): the selection ops, from column sums or MLP scores
to stored indices."""
from benchmarks.core.spans import device_us, placed


def _selection(name, path):
    return 'attn.select' in path or 'mlp.select' in path


def read(run):
    us = device_us(placed(run.trace), _selection)
    return None if us is None else us / 1e3 / run.trace.generations
