"""eager_ms: device ms a batch in PyTorch's own elementwise, index,
copy, reduction and concatenation kernels."""

from portbench import trace


def read(run):
    return trace.eager_ms(run.trace)
