"""decode_s: the decoder's span per generation (unpack and decode,
synchronised at its end), the median over the untraced generations of
the run."""


def read(run):
    return run.span('decode')
