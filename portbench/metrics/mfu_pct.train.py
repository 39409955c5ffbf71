"""mfu_pct: the FLOPs of the traced stretch's steps (three times the forward's), counted from the
configuration's layer spec, over the stretch's seconds times the card's
peak for the configuration's compute dtype."""


def read(run):
    tr = run.trace
    return 100.0 * run.flops_per_request * tr["requests"] / (tr["window_s"] * run.matmul_peak)
