"""Set-up: process start until the traffic's lead begins (imports, the
kernels' load or build, weights, slabs, warm-up)."""


def read(run):
    return run.setup_s
