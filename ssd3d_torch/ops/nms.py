"""Fixed-shape BEV NMS (counterpart of `ssd3d/ops/nms.py`).

The same greedy score-ordered suppression as the JAX package: a stable sort
by score, the K x K IoU matrix, a sequential keep sweep, then the first
`max_output` kept entries in score order. Every sort is stable, as
`jnp.argsort` is, so equal scores keep their index order. All classes and
batch elements sweep together in one loop of K steps, on the host: the
proposal NMS of PointRCNN (`class_unaware_nms`, 2,048 candidates after the
top-k prefilter) runs 2,048 such steps for a batch.
"""

from __future__ import annotations

import torch

from ssd3d_torch.core.geometry import boxes_to_bev_aabb
from ssd3d_torch.core.iou import aabb_iou
from ssd3d_torch.ops.topk import top_k_set


def _nms_rows(bev_boxes: torch.Tensor, scores: torch.Tensor, max_output: int,
              iou_threshold: float):
    """Greedy NMS over rows: bev_boxes [r, k, 4], scores [r, k]
    -> (idx int32 [r, max_output], valid bool [r, max_output])."""
    r, k = scores.shape
    dev = scores.device
    order = torch.argsort(-scores, dim=-1, stable=True)
    boxes_sorted = bev_boxes.gather(1, order[..., None].expand(r, k, 4))
    iou = aabb_iou(boxes_sorted, boxes_sorted)
    later = torch.ones(k, k, dtype=torch.bool, device=dev).triu(1)
    suppress = (iou > iou_threshold) & later  # [r, k, k]: i kills later j
    keep = torch.ones(r, k, dtype=torch.bool, device=dev)
    for i in range(k):
        keep &= ~(suppress[:, i] & keep[:, i:i + 1])
    iota = torch.arange(k, device=dev)
    sel = torch.argsort(torch.where(keep, iota, k + iota), dim=-1, stable=True)
    picked = order.gather(1, sel)
    if max_output <= k:
        picked = picked[:, :max_output]
    else:
        picked = torch.nn.functional.pad(picked, (0, max_output - k))
    cnt = keep.sum(-1, keepdim=True)
    valid = torch.arange(max_output, device=dev) < cnt.clamp(max=max_output)
    idx = torch.where(valid, picked, torch.zeros_like(picked)).to(torch.int32)
    return idx, valid


def nms_bev(bev_boxes: torch.Tensor, scores: torch.Tensor, max_output: int,
            iou_threshold: float):
    """Greedy NMS on axis-aligned BEV rectangles.

    bev_boxes: [k, 4] (x1, z1, x2, z2); scores: [k]
    -> (idx int32 [max_output] into the input, valid bool [max_output])."""
    idx, valid = _nms_rows(bev_boxes[None], scores[None], max_output, iou_threshold)
    return idx[0], valid[0]


def class_unaware_nms(boxes_3d: torch.Tensor, scores: torch.Tensor, max_output: int,
                      iou_threshold: float, pre_topk: int = 0):
    """Class-agnostic proposal NMS (the RPN's). boxes_3d: [b, n, cls, 7];
    scores: [b, n, cls]. Each candidate keeps its best class's score and box.
    With pre_topk > 0 and n > pre_topk, only the pre_topk best candidates
    (`top_k_set`) enter the suppression, in index order; the stable sort in
    `_nms_rows` then orders them exactly as an unfiltered run would.

    -> (boxes [b, max_output, 7], scores [b, max_output] (0 where not
    valid), valid bool [b, max_output])."""
    b, n, _ = scores.shape
    best_score = scores.amax(-1)
    if boxes_3d.shape[2] == 1:
        boxes = boxes_3d[:, :, 0]
    else:
        best_cls = scores.argmax(-1)
        boxes = boxes_3d.gather(2, best_cls[..., None, None].expand(b, n, 1, 7))[:, :, 0]
    if pre_topk and n > pre_topk:
        top_i = top_k_set(best_score, pre_topk)[0].long()
        boxes = boxes.gather(1, top_i[..., None].expand(-1, -1, 7))
        best_score = best_score.gather(1, top_i)
    idx, valid = _nms_rows(boxes_to_bev_aabb(boxes), best_score, max_output, iou_threshold)
    gidx = idx.long()
    out_boxes = boxes.gather(1, gidx[..., None].expand(-1, -1, 7))
    out_scores = torch.where(valid, best_score.gather(1, gidx), torch.zeros_like(best_score[:, :1]))
    return out_boxes, out_scores, valid


def batched_class_nms(boxes_3d: torch.Tensor, bev_boxes: torch.Tensor,
                      scores: torch.Tensor, max_output: int,
                      iou_threshold: float) -> dict:
    """Per-class NMS over a batch.

    boxes_3d: [b, n, reg_cls, 7]; bev_boxes: [b, n, reg_cls, 4];
    scores: [b, n, cls] -> dict of boxes [b, cls*max_output, 7],
    scores, classes (int32), valid (bool), index (int32), each
    [b, cls*max_output]."""
    b, n, cls_num = scores.shape
    reg_idx = torch.clamp(torch.arange(cls_num), max=boxes_3d.shape[2] - 1)
    box_pc = boxes_3d.permute(0, 2, 1, 3)[:, reg_idx]  # [b, cls, n, 7]
    bev_pc = bev_boxes.permute(0, 2, 1, 3)[:, reg_idx]  # [b, cls, n, 4]
    sc_pc = scores.permute(0, 2, 1)  # [b, cls, n]
    idx, valid = _nms_rows(bev_pc.reshape(b * cls_num, n, 4),
                           sc_pc.reshape(b * cls_num, n), max_output, iou_threshold)
    idx = idx.reshape(b, cls_num, max_output)
    valid = valid.reshape(b, cls_num, max_output)
    gidx = idx.long()
    boxes = box_pc.gather(2, gidx[..., None].expand(-1, -1, -1, 7))
    s_out = torch.where(valid, sc_pc.gather(2, gidx), torch.full_like(sc_pc[..., :1], -1.0))
    cat = torch.arange(cls_num, dtype=torch.int32, device=scores.device)
    cat = cat[None, :, None].expand(b, cls_num, max_output)
    return {
        "boxes": boxes.reshape(b, cls_num * max_output, 7),
        "scores": s_out.reshape(b, -1),
        "classes": cat.reshape(b, -1),
        "valid": valid.reshape(b, -1),
        "index": idx.reshape(b, -1),
    }
