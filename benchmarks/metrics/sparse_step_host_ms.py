"""sparse_step_host_ms: the median over the traced generation's
``step.sparse`` spans (the program's tracer,
``chipmunk_torch.utils.profiling``) of their host length, in ms: how
long the host takes to issue a sparse step.  Above
``sparse_step_device_ms`` the step is launch-bound."""
import statistics

from benchmarks.core.spans import program_spans


def read(run):
    spans = program_spans() if run.trace is not None else None
    ms = [(e - s) / 1e6 for n, s, e, _ in spans or ()
          if n == 'step.sparse']
    return statistics.median(ms) if ms else None
