"""launches: kernel launches a batch, counted in the trace."""

from portbench import trace


def read(run):
    return trace.launches(run.trace)
