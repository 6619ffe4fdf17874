"""setup_s: from the process's start to the window's start: imports, the
kernels' build or load, the weights, the bundle, the warm-up image."""


def read(run):
    return run.setup_s
