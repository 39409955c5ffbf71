"""program_idle_ms: ms a batch in which the card is idle while the host is
inside the program's `ssd3d.infer` span (Python, dispatch, the allocator
and syncs in `Pipeline.infer`), in the host-op stretch, whose host runs
slower than an untraced run's."""

from portbench import spans


def read(run):
    return spans.idle_ms(run.trace, "ssd3d.infer")
