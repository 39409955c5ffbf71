"""launches: kernel launches a batch or step, counted in the trace."""

from portbench import trace


def read(run):
    return trace.launches(run.trace)
