"""k1_fps_roofline_pct: the least time of the D-FPS launches a batch needs,
from the configuration's shapes (portbench.rooflines), over the device time
of the kernels launched inside the op ssd3d::fps."""

from portbench import rooflines, trace


def read(run):
    bound = sum(rooflines.fps_bound_s(*d) for d in rooflines.shapes(run.cfg, run.batch)["dfps"])
    return trace.op_roofline_pct(run.trace, "ssd3d::fps", bound)
