"""Fixed-shape BEV NMS (counterpart of `ssd3d/ops/nms.py`).

The same greedy score-ordered suppression as the JAX package: a stable sort
by score, the K x K IoU matrix, a sequential keep sweep, then the first
`max_output` kept entries in score order. Every sort is stable, as
`jnp.argsort` is, so equal scores keep their index order. All classes and
batch elements sweep together: the keep sweep is the custom op
`torch.ops.ssd3d.nms_keep` (`ops/library.py`), which on a CUDA tensor
launches the hand-written kernel `csrc/nms_keep.cu` (K8, the counterpart of
the JAX package's `fori_loop`, so a forward runs with no host-driven loop
and an export holds one node a sweep) and on a CPU tensor runs the plain
loop of K steps (`nms_keep_plain`). The IoU matrix, the threshold test, the
sorts and the `max_output` compaction stay in PyTorch, as the JAX package
keeps them outside its loop. The soft-NMS, the IoU-guided NMS and the
point-mask NMS of the reference's legacy paths are here too, for one set of
candidates each; the last two sweep through K8 as well.
"""

from __future__ import annotations

import torch

from ssd3d_torch.core.geometry import boxes_to_bev_aabb
from ssd3d_torch.ops import _build
from ssd3d_torch.core.iou import aabb_iou
from ssd3d_torch.ops.topk import top_k_set


def nms_keep_plain(suppress: torch.Tensor) -> torch.Tensor:
    """The keep sweep's plain version: suppress bool [r, k, k] in visiting
    order -> keep bool [r, k]; candidate j is dropped iff some kept i < j
    has suppress[:, i, j] (entries on and below the diagonal are ignored).
    A loop of k steps, every row at once."""
    r, k = suppress.shape[:2]
    dev = suppress.device
    suppress = suppress & torch.ones(k, k, dtype=torch.bool, device=dev).triu(1)
    keep = torch.ones(r, k, dtype=torch.bool, device=dev)
    for i in range(k):
        keep &= ~(suppress[:, i] & keep[:, i:i + 1])
    return keep


# Tests only: the shared bytes a K8 sweep block may take (the H100's 232,448).
# Tests lower it to stage a tile's rows in column chunks and to keep the
# removed words in the scratch; the package never sets it.
_NMS_SMEM_BUDGET = 232448
_NMS_GRID_MAX = 65535  # the sweep's blocks (csrc/nms_keep.cu kGridMax)


@_build.on_input_device
def _nms_keep_cuda(suppress: torch.Tensor) -> torch.Tensor:
    """K8: the upper triangle packed into 64-bit words in tiles of 64
    candidates (scratch), then one block a row sweeping the tiles from shared
    memory -> keep bool [r, k]."""
    if suppress.dtype != torch.bool or suppress.dim() != 3 or suppress.shape[1] != suppress.shape[2]:
        raise ValueError(f"nms_keep: suppress must be bool [r, k, k], got {suppress.dtype} "
                         f"{tuple(suppress.shape)}")
    r, k = suppress.shape[:2]
    words = (k + 63) // 64
    suppress = suppress.contiguous()
    keep = torch.empty(r, k, dtype=torch.bool, device=suppress.device)
    # the packed words [r, W, W, 64], then each sweep block's removed words
    scratch = torch.empty(r * words * words * 64 + min(r, _NMS_GRID_MAX) * words,
                          dtype=torch.int64, device=suppress.device)
    if keep.numel():
        _build.NMS_KEEP(suppress.data_ptr(), scratch.data_ptr(), keep.data_ptr(), r, k,
                        _NMS_SMEM_BUDGET)
    return keep


def nms_keep(suppress: torch.Tensor) -> torch.Tensor:
    """The greedy keep sweep (`torch.ops.ssd3d.nms_keep`): K8 on a CUDA
    tensor, `nms_keep_plain` on a CPU tensor."""
    _build.require_cuda("nms_keep", suppress)
    return torch.ops.ssd3d.nms_keep(suppress)


def _greedy_keep(order: torch.Tensor, suppress: torch.Tensor, max_output: int):
    """The greedy sweep over rows: candidates visited in `order` [r, k]
    (indices into the input), suppress [r, k, k] in visiting order (entry
    i kills a later j where true) -> (idx int32 [r, max_output], the first
    `max_output` kept in visiting order, padded with 0; valid bool)."""
    k = order.shape[1]
    dev = order.device
    keep = nms_keep(suppress)
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


def _nms_rows(bev_boxes: torch.Tensor, scores: torch.Tensor, max_output: int,
              iou_threshold: float):
    """Greedy NMS over rows: bev_boxes [r, k, 4], scores [r, k]
    -> (idx int32 [r, max_output], valid bool [r, max_output])."""
    r, k = scores.shape
    order = torch.argsort(-scores, dim=-1, stable=True)
    boxes_sorted = bev_boxes.gather(1, order[..., None].expand(r, k, 4))
    iou = aabb_iou(boxes_sorted, boxes_sorted)
    return _greedy_keep(order, iou > iou_threshold, max_output)


def nms_bev(bev_boxes: torch.Tensor, scores: torch.Tensor, max_output: int,
            iou_threshold: float):
    """Greedy NMS on axis-aligned BEV rectangles.

    bev_boxes: [k, 4] (x1, z1, x2, z2); scores: [k]
    -> (idx int32 [max_output] into the input, valid bool [max_output])."""
    idx, valid = _nms_rows(bev_boxes[None], scores[None], max_output, iou_threshold)
    return idx[0], valid[0]


def soft_nms_bev(bev_boxes: torch.Tensor, scores: torch.Tensor, max_output: int,
                 sigma: float = 0.5, score_thresh: float = 1e-3):
    """Gaussian soft-NMS on BEV rectangles (reference cython_nms.pyx
    soft_nms): pick the highest live score (the first on ties), then decay
    every score not yet picked by exp(-iou^2 / sigma) against the pick,
    min(max_output, k) times. bev_boxes: [k, 4]; scores: [k] -> (idx int32
    [max_output] in pick order, scores at their pick [max_output], valid
    bool [max_output]: picked with a score above score_thresh); padded
    with 0 / 0 / False past k."""
    k = scores.shape[0]
    iou = aabb_iou(bev_boxes, bev_boxes)
    scores = scores.clone()
    taken = torch.zeros(k, dtype=torch.bool, device=scores.device)
    picks, picked = [], []
    for _ in range(min(max_output, k)):
        live = torch.where(taken, -torch.inf, scores)
        i = live.argmax()
        s_i = live[i]
        scores = torch.where(taken, scores, scores * torch.exp(-(iou[i] ** 2) / sigma))
        scores[i] = s_i  # the pick keeps its score undecayed
        taken[i] = True
        picks.append(i)
        picked.append(s_i)
    idx = torch.stack(picks).to(torch.int32)
    sel = torch.stack(picked)
    valid = sel > score_thresh
    pad = max(0, max_output - k)
    if pad:
        idx = torch.nn.functional.pad(idx, (0, pad))
        sel = torch.nn.functional.pad(sel, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    return idx, sel, valid


def iou_guided_nms(iou_matrix: torch.Tensor, scores: torch.Tensor, iou_3d: torch.Tensor,
                   max_output: int, iou_threshold: float = 0.1):
    """IoU-branch-guided greedy NMS (reference np_functions/gt_sampler.py:8-24,
    cython_nms.pyx matrix_iou_guided_nms): candidates visited in descending
    ensemble score = scores * iou_3d (a stable sort: equal scores keep index
    order), each kept one suppressing every later candidate whose given IoU
    with it is >= iou_threshold. iou_matrix: [k, k]; scores, iou_3d: [k]
    -> (idx int32 [max_output] in visiting order, their ensemble scores (0
    where not valid), valid bool [max_output])."""
    ensemble = scores * iou_3d
    order = torch.argsort(-ensemble, stable=True)
    iou_sorted = iou_matrix[order][:, order]
    idx, valid = _greedy_keep(order[None], (iou_sorted >= iou_threshold)[None], max_output)
    idx, valid = idx[0], valid[0]
    return idx, torch.where(valid, ensemble[idx.long()], torch.zeros_like(ensemble[:1])), valid


def points_mask_nms(points_iou: torch.Tensor, scores: torch.Tensor, max_output: int,
                    iou_threshold: float):
    """NMS where the overlap is the IoU of point-membership masks (reference
    nms_kernel.cu PointsNms; compose the matrix with `query_points_iou`):
    the greedy sweep of `iou_guided_nms` in score order, suppressing at
    >= iou_threshold. points_iou: [k, k]; scores: [k] -> (idx int32
    [max_output], valid bool [max_output])."""
    idx, _, valid = iou_guided_nms(points_iou, scores, torch.ones_like(scores), max_output,
                                   iou_threshold)
    return idx, valid


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
    reg_idx = torch.arange(cls_num, device=scores.device).clamp(max=boxes_3d.shape[2] - 1)
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
