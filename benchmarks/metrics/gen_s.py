"""gen_s: seconds of the window over the generations it finished (host
clock around synchronised work, untraced run)."""


def read(run):
    return run.window_s / run.generations if run.generations else None
