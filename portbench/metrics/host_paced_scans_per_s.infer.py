"""host_paced_scans_per_s.infer: `scans_per_s` of a cell whose host paces
the forward (3DSSD inference), read per layer: scans whose detections
reached the host in the window over the window's seconds (host clock, the
traced run's window, its profiled requests included). Its runs spread with
the host's speed from process to process, past what an end-to-end bound
can hold."""


def read(run):
    return sum(run.window.scans) / run.window.seconds
