"""update_launches: kernel launches a step inside the program's
`ssd3d.train.update` span (`apply_update`: the zero gradients, the clip by
global norm and the optimizer's step)."""

from portbench import spans


def read(run):
    return spans.calls(run.trace, "ssd3d.train.update", spans.LAUNCH)
