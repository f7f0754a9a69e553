"""sparse_step_device_ms: the median over the traced generation's
``step.sparse`` spans of the union of the intervals of the kernels,
copies and memsets launched in the span (``core/spans.py``), in ms: the
device time a sparse step needs."""
from benchmarks.core.spans import median_over, placed


def read(run):
    p = placed(run.trace)
    if p is None or p.device is None:
        return None
    us = median_over(p, 'step.sparse', p.device_in)
    return None if us is None else us / 1e3
