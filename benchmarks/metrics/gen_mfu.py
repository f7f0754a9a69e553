"""gen_mfu: the operations a generation needs (counts/<config>.py, from
the configuration alone) over its time (denoise and decode spans) at the
bf16 peak of 989 TFLOP/s, in percent."""

PEAK_BF16_FLOPS = 989e12


def read(run):
    d, e = run.span('denoise'), run.span('decode')
    if d is None or e is None or not run.counts.get('flops'):
        return None
    return 100.0 * run.counts['flops'] / ((d + e) * PEAK_BF16_FLOPS)
