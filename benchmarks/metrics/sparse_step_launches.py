"""sparse_step_launches: the median over the traced generation's
``step.sparse`` spans of the CUDA launches (kernels, copies, memsets)
whose host start lies in the span (``core/spans.py``)."""
from benchmarks.core.spans import median_over, placed


def read(run):
    p = placed(run.trace)
    return median_over(p, 'step.sparse', p.launches_in) if p else None
