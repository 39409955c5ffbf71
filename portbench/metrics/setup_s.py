"""setup_s: seconds from the process's start to the window's: imports, the
kernels' load (or build), the model, weights, scans and the warm-up."""


def read(run):
    return run.setup_s
