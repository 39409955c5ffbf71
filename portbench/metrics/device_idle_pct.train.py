"""device_idle_pct: the share of the traced stretch in which no kernel,
memcpy or memset ran on the card (the union of the device intervals)."""

from portbench import trace


def read(run):
    return trace.idle_pct(run.trace)
