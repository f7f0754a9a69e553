"""device_idle_pct: the share of the traced window (one generation, from
the first to the last CUDA event of the trace) in which no kernel, copy
or memset runs: the window minus the union of their intervals."""


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    return run.trace.idle_pct()
