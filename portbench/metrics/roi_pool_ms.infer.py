"""roi_pool_ms: device ms a batch under the program's `ssd3d.rcnn.pool`
span (the RoI pooler: the points-in-boxes first-k, the gathers, the align
MLP and, for a pooler that has them, its voxel and VFE steps), summed over
the RCNN's chunks of proposals."""

from portbench import spans


def read(run):
    return spans.device_ms(run.trace, "ssd3d.rcnn.pool")
