"""Point ops: sampling, grouping, interpolation, NMS (counterpart of
`ssd3d/ops/__init__.py`, the names the port has). The CUDA kernels are built
at their first launch by `ssd3d_torch.ops._build`, which also keeps their
launch counts."""

from ssd3d_torch.ops.grouping import (
    ball_query,
    ball_query_attention,
    ball_query_dilated,
    ball_query_withidx,
    group_points,
    knn_points,
    query_boxes_3d_mask,
    query_boxes_3d_points,
    query_points_iou,
)
from ssd3d_torch.ops.interpolate import k_interpolate, three_interpolate, three_nn
from ssd3d_torch.ops.nms import (
    batched_class_nms,
    class_unaware_nms,
    iou_guided_nms,
    nms_bev,
    points_mask_nms,
    soft_nms_bev,
)
from ssd3d_torch.ops.sampling import (
    farthest_point_sample,
    farthest_point_sample_features,
    farthest_point_sample_from_dist,
    gather_by_mask,
    gather_points,
)

__all__ = [
    "farthest_point_sample",
    "farthest_point_sample_features",
    "farthest_point_sample_from_dist",
    "gather_points",
    "gather_by_mask",
    "ball_query",
    "ball_query_dilated",
    "ball_query_attention",
    "ball_query_withidx",
    "group_points",
    "knn_points",
    "query_boxes_3d_mask",
    "query_boxes_3d_points",
    "query_points_iou",
    "three_nn",
    "three_interpolate",
    "k_interpolate",
    "nms_bev",
    "batched_class_nms",
    "class_unaware_nms",
    "soft_nms_bev",
    "iou_guided_nms",
    "points_mask_nms",
]
