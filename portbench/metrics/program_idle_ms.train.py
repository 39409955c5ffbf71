"""program_idle_ms: ms a step in which the card is idle while the host is
inside the program's `ssd3d.train.step` span (the train step's Python,
dispatch, allocator and syncs), in the host-op stretch, whose host runs
slower than an untraced run's."""

from portbench import spans


def read(run):
    return spans.idle_ms(run.trace, "ssd3d.train.step")
