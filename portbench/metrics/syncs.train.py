"""syncs: host-blocking CUDA calls a step (stream, device or event
synchronisations, synchronous copies) inside the program's
`ssd3d.train.step` span, the autograd engine's thread included."""

from portbench import spans


def read(run):
    return spans.calls(run.trace, "ssd3d.train.step", spans.SYNC)
