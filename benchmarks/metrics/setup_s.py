"""setup_s: seconds from the process's start to the window's start:
imports, weights drawn on the card, the kernels' build or load, the
warm-up generation and decode."""


def read(run):
    return run.setup_s
