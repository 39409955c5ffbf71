"""Detection losses (counterpart of `ssd3d/train/losses.py`).

The reference's masking and normalisation are kept exactly:
- classification: Is-Not / Focal / Center-ness over the (pmask + nmask)
  points, normalised by their count;
- regression: huber over positive points, normalised by the positive count
  (Bin-Anchor: softmax CE on the x and z bins, huber on the selected
  residuals, masked inside the huber, and on y and the sizes);
- angle: softmax CE on the bin + huber on the selected residual, masked
  inside the huber as the reference does;
- corner loss on the predicted box decoded under the GT angle bin;
- vote loss against the vote targets;
- the IoU branch: huber against the targets' 3D IoU, rescaled to [-1, 1];
- nuScenes' attributes (sigmoid CE over 8, where the GT has one) and
  velocities (huber, where the GT's is finite), over the positive points.
"""

from __future__ import annotations

import dataclasses

import torch

from ssd3d_torch.core.geometry import boxes_to_corners, centerness
from ssd3d_torch.core.iou import boxes_iou_matched
from ssd3d_torch.train.assigner import vote_targets


def huber(error: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    abs_e = error.abs()
    quad = torch.minimum(abs_e, abs_e.new_tensor(delta))  # a tie splits the gradient, as in JAX
    return 0.5 * quad * quad + delta * (abs_e - quad)


def sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    # |x| as a select, whose gradient at 0 is +1 as JAX's abs has it
    # (torch's abs has 0 there); max(x, 0) splits a tie as JAX's does
    abs_x = torch.where(logits >= 0, logits, -logits)
    return (torch.maximum(logits, logits.new_zeros(())) - logits * labels
            + torch.log1p(torch.exp(-abs_x)))


def softmax_ce(logits: torch.Tensor, label_idx: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, label_idx.long()[..., None])[..., 0]


def focal_loss(logits: torch.Tensor, targets: torch.Tensor, gamma: float = 2.0,
               alpha: float = 0.25) -> torch.Tensor:
    """Per-entry sigmoid focal loss."""
    ce = sigmoid_ce(logits, targets)
    p = torch.sigmoid(logits)
    p_t = targets * p + (1 - targets) * (1 - p)
    alpha_t = targets * alpha + (1 - targets) * (1 - alpha)
    return (1.0 - p_t).pow(gamma) * alpha_t * ce


def softmax_focal_loss(logits: torch.Tensor, label_idx: torch.Tensor, gamma: float = 2.0,
                       alpha: float = 0.25) -> torch.Tensor:
    """-alpha_t (1 - p_t)^gamma log p_t over a softmax head; background
    (class 0) weighs 1 - alpha, foreground alpha."""
    logp_t = torch.log_softmax(logits, dim=-1).gather(-1, label_idx.long()[..., None])[..., 0]
    alpha_t = torch.where(label_idx > 0, alpha, 1.0 - alpha)
    return -alpha_t * (1.0 - logp_t.exp()).pow(gamma) * logp_t


def one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """jax.nn.one_hot: an index outside [0, n) gives an all-zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


@dataclasses.dataclass(frozen=True)
class LossConfig:
    cls_loss_type: str  # 'Center-ness' | 'Is-Not' | 'Focal-loss'
    cls_activation: str  # 'Sigmoid' | 'Softmax'
    num_classes: int
    num_angle_cls: int
    centerness_range: tuple = (0.0, 1.0)
    corner_loss: bool = False
    vote_loss: bool = False
    iou_loss: bool = False
    attr_velo_loss: bool = False
    reg_type: str = "Dist-Anchor-free"
    reg_bin_cls_num: int = 12
    expand_dims_length: float = 0.1  # vote-target box expansion

    @classmethod
    def from_cfg(cls, cfg, stage: str = "FIRST_STAGE", vote: bool = False, iou: bool = False):
        sc = cfg.MODEL[stage]
        cls_list = (cfg.DATASET.NUSCENES.CLS_LIST if cfg.DATASET.TYPE.upper() == "NUSCENES"
                    else cfg.DATASET.KITTI.CLS_LIST)
        return cls(
            cls_loss_type=sc.CLASSIFICATION_LOSS.TYPE,
            cls_activation=sc.CLS_ACTIVATION,
            num_classes=len(cls_list),
            num_angle_cls=cfg.MODEL.ANGLE_CLS_NUM,
            centerness_range=tuple(sc.CLASSIFICATION_LOSS.CENTER_NESS_LABEL_RANGE),
            corner_loss=sc.CORNER_LOSS,
            vote_loss=vote,
            iou_loss=iou,
            attr_velo_loss=sc.PREDICT_ATTRIBUTE_AND_VELOCITY,
            reg_type=sc.REGRESSION_METHOD.TYPE,
            reg_bin_cls_num=sc.REGRESSION_METHOD.BIN_CLASS_NUM,
            expand_dims_length=cfg.TRAIN.AUGMENTATIONS.EXPAND_DIMS_LENGTH,
        )


def classification_loss(cfg: LossConfig, outputs: dict, targets: dict) -> torch.Tensor:
    pmask, nmask = targets["pmask"], targets["nmask"]
    cls_mask = (pmask + nmask).amax(-1)  # [bs, pts]
    norm = cls_mask.sum().clamp(min=1.0)
    logits = outputs["cls"]  # [bs, pts, c]
    gt_cls = targets["gt_cls"]  # [bs, pts], 0 = background
    softmax = cfg.cls_activation == "Softmax"
    if not softmax:
        # sigmoid: num_classes channels, background is the all-zero row
        onehot = one_hot(gt_cls - 1, cfg.num_classes, logits.dtype)
    if cfg.cls_loss_type == "Is-Not":
        per_pt = softmax_ce(logits, gt_cls) if softmax else sigmoid_ce(logits, onehot).mean(-1)
    elif cfg.cls_loss_type == "Focal-loss":
        per_pt = (softmax_focal_loss(logits, gt_cls) if softmax
                  else focal_loss(logits, onehot).mean(-1))
    else:  # Center-ness
        base_xyz = outputs["base_xyz"].detach()
        box_per_pt = (targets["gt_boxes"] * pmask[..., None]).sum(2)
        ctr = centerness(base_xyz, box_per_pt) * pmask.amax(-1)
        lo, hi = cfg.centerness_range
        ctr = ctr * (hi - lo) + lo
        if softmax:
            # soft-label CE: centre-ness mass on the true class, the rest on
            # background
            c = ctr[..., None]
            target = (one_hot(gt_cls, cfg.num_classes + 1, logits.dtype) * c
                      + one_hot(torch.zeros_like(gt_cls), cfg.num_classes + 1, logits.dtype)
                      * (1.0 - c))
            per_pt = -(target * torch.log_softmax(logits, dim=-1)).sum(-1)
        else:
            per_pt = sigmoid_ce(logits, onehot * ctr[..., None]).mean(-1)
    return (per_pt * cls_mask).sum() / norm


def offset_loss_res(cfg: LossConfig, outputs: dict, targets: dict) -> torch.Tensor:
    pmask = targets["pmask"]
    norm = pmask.sum().clamp(min=1.0)
    err = outputs["offset"] - targets["gt_offset"]
    return (huber(err).sum(-1) * pmask).sum() / norm


def offset_loss_bin(cfg: LossConfig, outputs: dict, targets: dict) -> torch.Tensor:
    """Bin-Anchor offsets: x and z bin CE plus the selected residual, then
    y and the sizes. gt_offset [..., 8] = x bin, x res, z bin, z res, y res,
    dl, dh, dw; the prediction [..., 4 nb + 4]."""
    pmask = targets["pmask"]
    norm = pmask.sum().clamp(min=1.0)
    nb = cfg.reg_bin_cls_num
    gt, pred = targets["gt_offset"], outputs["offset"]

    def bin_res(gt_bin, gt_res, pred_bin, pred_res):
        gt_bin = gt_bin.to(torch.int32)
        bin_l = (softmax_ce(pred_bin, gt_bin) * pmask).sum() / norm
        sel = (pred_res * one_hot(gt_bin, nb, pred_res.dtype)).sum(-1)
        return bin_l + huber((sel - gt_res) * pmask).sum() / norm

    total = bin_res(gt[..., 0], gt[..., 1], pred[..., 0:nb], pred[..., nb:2 * nb])
    total = total + bin_res(gt[..., 2], gt[..., 3], pred[..., 2 * nb:3 * nb],
                            pred[..., 3 * nb:4 * nb])
    other = huber(pred[..., 4 * nb:] - gt[..., 4:]).sum(-1) * pmask
    return total + other.sum() / norm


def angle_loss(cfg: LossConfig, outputs: dict, targets: dict) -> torch.Tensor:
    pmask = targets["pmask"]
    norm = pmask.sum().clamp(min=1.0)
    gt_bin = targets["gt_angle_cls"]
    bin_l = (softmax_ce(outputs["angle_cls"], gt_bin) * pmask).sum() / norm
    onehot = one_hot(gt_bin, cfg.num_angle_cls, outputs["angle_res"].dtype)
    sel = (outputs["angle_res"] * onehot).sum(-1)
    res_l = huber((sel - targets["gt_angle_res"]) * pmask).sum() / norm
    return bin_l + res_l


def corner_loss(cfg: LossConfig, pred_boxes_gt_angle: torch.Tensor, targets: dict) -> torch.Tensor:
    """pred_boxes_gt_angle: [bs, pts, cls, 7] decoded with the GT angle bin."""
    pmask = targets["pmask"]
    norm = pmask.sum().clamp(min=1.0)
    diff = boxes_to_corners(pred_boxes_gt_angle) - boxes_to_corners(targets["gt_boxes"])
    return (huber(diff).sum((-2, -1)) * pmask).sum() / norm


def vote_loss(vote_offset: torch.Tensor, vote_mask: torch.Tensor,
              vote_target: torch.Tensor) -> torch.Tensor:
    per = huber(vote_target - vote_offset).sum(-1) * vote_mask
    return per.sum() / vote_mask.sum().clamp(min=1.0)


def iou_branch_loss(cfg: LossConfig, outputs: dict, targets: dict,
                    anchors: torch.Tensor) -> torch.Tensor:
    """The IoU branch (sparse-to-dense rescoring): huber of the predicted
    IoU [bs, pts, cls] against 2 x (3D IoU of each anchor box with its
    assigned GT box) - 1 on the GT's class (0 on the others), averaged over
    the classes, over the positive points. anchors: [bs, pts, cls, 7]; an
    anchor-free stage has no anchor boxes, and raises (the JAX package's
    reshape to boxes fails or misreads there)."""
    if anchors.shape[-1] != 7:
        raise ValueError("iou_branch_loss: the IoU branch needs anchor boxes [bs, pts, cls, 7], "
                         f"got {tuple(anchors.shape)} (an anchor-free regression method)")
    pmask = targets["pmask"].amax(-1)
    norm = pmask.sum().clamp(min=1.0)
    onehot = one_hot(targets["gt_cls"] - 1, cfg.num_classes)
    cls_num = anchors.shape[2]
    with torch.no_grad():
        _, iou_3d = boxes_iou_matched(anchors.reshape(-1, 7),
                                      targets["gt_boxes"][:, :, :cls_num].reshape(-1, 7))
    tgt = (iou_3d.reshape(anchors.shape[:3]) * 2.0 - 1.0) * onehot[..., :cls_num]
    per = huber(outputs["iou"] - tgt).mean(-1) * pmask
    return per.sum() / norm


def attr_velo_loss(cfg: LossConfig, outputs: dict, targets: dict):
    """nuScenes' auxiliary losses -> (attribute, velocity). Attribute: sigmoid
    CE of the 8 logits [bs, pts, cls, 8] against the one-hot GT attribute,
    over the positive entries whose GT has one (>= 0), normalised by their
    count times 8. Velocity: huber of (vx, vz) [bs, pts, cls, 2] over the
    positive entries whose GT velocity is finite (an isolated annotation's
    is NaN), normalised by their count; the NaNs are replaced before the
    difference, so none reaches the gradient."""
    pmask = targets["pmask"]
    gt_attr = targets["gt_attribute"]  # [bs, pts, cls]
    attr_mask = (gt_attr >= 0).to(pmask.dtype) * pmask
    a = sigmoid_ce(outputs["attribute"], one_hot(gt_attr, 8, outputs["attribute"].dtype))
    attr_l = (a * attr_mask[..., None]).sum() / (attr_mask.sum().clamp(min=1.0) * 8.0)
    gt_velo = targets["gt_velocity"]  # [bs, pts, cls, 2]
    velo_mask = (~torch.isnan(gt_velo.sum(-1))).to(pmask.dtype) * pmask
    gt_velo = torch.where(torch.isnan(gt_velo), 0.0, gt_velo)
    v = huber(outputs["velocity"] - gt_velo).sum(-1) * velo_mask
    return attr_l, v.sum() / velo_mask.sum().clamp(min=1.0)


def compute_stage_losses(cfg: LossConfig, coder, outputs: dict, targets: dict,
                         anchors: torch.Tensor, base_xyz: torch.Tensor,
                         gt_boxes_scene: torch.Tensor | None = None) -> dict:
    """Every loss of one detection stage. `targets` holds the assigner's
    outputs; this adds the encoded regression targets. anchors: [bs, n, cls,
    7] (anchor-free: [bs, n, 1, 3]); base_xyz: [bs, n, 3]; gt_boxes_scene:
    [bs, g, 7], the raw scene GTs (vote loss only). With `attr_velo_loss`
    the targets hold the assigner's gt_velocity and gt_attribute."""
    gt_offset, gt_angle_cls, gt_angle_res = coder.encode(base_xyz, targets["gt_boxes"], anchors)
    targets = dict(targets, gt_offset=gt_offset, gt_angle_cls=gt_angle_cls,
                   gt_angle_res=gt_angle_res)
    loss_dict = {
        "cls": classification_loss(cfg, outputs, targets),
        "offset": (offset_loss_bin if cfg.reg_type == "Bin-Anchor" else offset_loss_res)(
            cfg, outputs, targets),
        "angle": angle_loss(cfg, outputs, targets),
    }
    if cfg.corner_loss:
        # the predicted boxes decoded under the GT angle bin
        gt_bin_onehot = one_hot(gt_angle_cls, cfg.num_angle_cls, outputs["angle_res"].dtype)
        pred_boxes = coder.decode(base_xyz, outputs["offset"], gt_bin_onehot,
                                  outputs["angle_res"], anchors)
        loss_dict["corner"] = corner_loss(cfg, pred_boxes, targets)
    if cfg.vote_loss and outputs.get("vote_base"):
        vmask, vtarget = vote_targets(outputs["vote_base"][0], gt_boxes_scene,
                                      expand=cfg.expand_dims_length)
        loss_dict["vote"] = vote_loss(outputs["vote_offset"][0], vmask, vtarget)
    if cfg.iou_loss:
        loss_dict["iou"] = iou_branch_loss(cfg, outputs, targets, anchors)
    if cfg.attr_velo_loss:
        loss_dict["attribute"], loss_dict["velocity"] = attr_velo_loss(cfg, outputs, targets)
    return loss_dict
