"""glue_ms: device milliseconds per generation in kernels that are
neither the port's (core.trace.OUR_KERNELS) nor GEMMs (cuBLAS, CUTLASS,
cuDNN: core.trace.GEMM_NAMES): torch's eager ops, copies and memsets."""
from benchmarks.core.trace import is_glue


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    return 1e3 * run.trace.device_s(is_glue) / run.trace.generations
