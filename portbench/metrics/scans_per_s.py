"""scans_per_s: scans whose detections reached the host in the window over
the window's seconds (host clock; the window ends with its last request)."""


def read(run):
    return sum(run.window.scans) / run.window.seconds
