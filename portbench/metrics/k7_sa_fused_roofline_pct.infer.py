"""k7_sa_fused_roofline_pct: the least time of the fused SA launches a
batch needs, from the configuration's shapes (portbench.rooflines), over
the device time of the kernels launched inside the op ssd3d::sa_fused."""

from portbench import rooflines, trace


def read(run):
    bound = sum(rooflines.sa_fused_bound_s(*k)
                for k in rooflines.shapes(run.cfg, run.batch)["sa_fused"])
    return trace.op_roofline_pct(run.trace, "ssd3d::sa_fused", bound)
