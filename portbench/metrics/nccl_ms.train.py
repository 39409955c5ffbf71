"""nccl_ms: device ms a step in NCCL's kernels (the gradient all-reduce,
BatchNorm's global moments, the losses' sums) on rank 0."""


def read(run):
    tr = run.trace
    t = sum(e - s for s, e, name in tr["kernels"] if "nccl" in name.lower())
    return t / 1e3 / tr["requests"] if t > 0 else None
