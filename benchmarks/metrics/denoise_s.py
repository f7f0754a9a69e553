"""denoise_s: the sampler's span per generation (the program's generate
call, synchronised at its end), the median over the untraced
generations of the run."""


def read(run):
    return run.span('denoise')
