"""syncs: host-blocking CUDA calls a batch (stream, device or event
synchronisations, synchronous copies) inside the program's `ssd3d.infer`
span."""

from portbench import spans


def read(run):
    return spans.calls(run.trace, "ssd3d.infer", spans.SYNC)
