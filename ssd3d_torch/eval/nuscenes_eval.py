"""Native nuScenes-style detection metrics, centre-distance mAP and NDS (the
port's copy of `ssd3d/eval/nuscenes_eval.py`, numpy only).

A self-contained implementation of the published CVPR-2019 protocol,
matching the devkit's algo.py semantics exactly:

- matching by BEV center distance at thresholds {0.5, 1, 2, 4} m, greedy
  over score-sorted detections, closest untaken same-class GT per frame
- precision/recall interpolated onto 101 recall points (np.interp,
  right=0, NO monotone smoothing — the devkit does none either);
  AP = mean over recall points 11..100 of max(precision - 0.1, 0) / 0.9
- TP errors at the 2 m threshold: per-match errors -> nan-aware cumulative
  mean as a function of confidence, interpolated onto the 101-point
  confidence curve; the reported error is the mean over recall points
  11..max_achieved (1.0 when max recall < 11%): ATE (center distance),
  ASE (1 - size-aligned 3D IoU), AOE (yaw delta; period pi for barriers),
  AVE (velocity L2), AAE (1 - attribute accuracy; nan when the GT carries
  no attribute)
- class exceptions applied at aggregation (devkit detection/evaluate.py):
  traffic_cone has no orientation/velocity/attribute, barrier no
  velocity/attribute
- NDS = (5*mAP + sum over the 5 TP metrics of max(0, 1 - err)) / 10

Boxes here use the framework-wide camera-style box_3d convention; the BEV
plane is (x, z).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
N_REC = 101
TP_METRICS = ("trans", "scale", "orient", "vel", "attr")

# aggregation-stage class exceptions (devkit evaluate.py)
METRIC_EXCEPTIONS = {
    "traffic_cone": {"orient", "vel", "attr"},
    "barrier": {"vel", "attr"},
}
PERIOD_PI = {"barrier"}


@dataclasses.dataclass
class NuscBox:
    cls: str
    center: np.ndarray  # (x, y_bottom, z)
    size: np.ndarray  # (l, h, w)
    ry: float
    velocity: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(2)
    )
    attribute: int = -1
    score: float = -1.0

    @property
    def bev_center(self):
        return np.array([self.center[0], self.center[2]])


def _angle_diff(a, b, period):
    d = (a - b) % period
    return min(d, period - d)


def _aligned_iou_3d(det: NuscBox, gt: NuscBox) -> float:
    """IoU of the two boxes translated/rotated onto each other (size-only;
    devkit scale_iou)."""
    inter = np.prod(np.minimum(det.size, gt.size))
    union = np.prod(det.size) + np.prod(gt.size) - inter
    return float(inter / max(union, 1e-9))


def _cummean(x: np.ndarray) -> np.ndarray:
    """nan-aware cumulative mean (devkit utils.cummean): nan entries carry
    the previous mean forward and don't count."""
    if len(x) == 0:
        return x
    ok = ~np.isnan(x)
    cnt = np.cumsum(ok)
    s = np.nancumsum(x)
    return s / np.maximum(cnt, 1)


@dataclasses.dataclass
class MetricData:
    """101-point curves for one (class, threshold) accumulation."""

    recall: np.ndarray
    precision: np.ndarray
    confidence: np.ndarray
    errs: dict  # metric -> [101] curves (cummean over conf)

    @property
    def max_recall_ind(self) -> int:
        nz = np.nonzero(self.confidence)[0]
        return int(nz[-1]) if len(nz) else 0

    @classmethod
    def empty(cls):
        z = np.zeros(N_REC)
        return cls(np.linspace(0, 1, N_REC), z, z,
                   {k: np.ones(N_REC) for k in TP_METRICS})


def _accumulate(gts, dets, cls: str, dist_th: float):
    """One class, one threshold over the whole split (devkit accumulate).
    Returns (MetricData, npos)."""
    gt_cls = [[g for g in frame if g.cls == cls] for frame in gts]
    npos = sum(len(f) for f in gt_cls)
    all_dets = []
    for i, frame in enumerate(dets):
        for d in frame:
            if d.cls == cls:
                all_dets.append((i, d))
    all_dets.sort(key=lambda x: -x[1].score)

    taken = [set() for _ in gts]
    tp, fp, conf = [], [], []
    match = {k: [] for k in TP_METRICS}
    match_conf = []
    for frame_i, det in all_dets:
        best, best_j = np.inf, -1
        for j, gt in enumerate(gt_cls[frame_i]):
            if j in taken[frame_i]:
                continue
            dist = np.linalg.norm(det.bev_center - gt.bev_center)
            if dist < best:
                best, best_j = dist, j
        if best < dist_th:
            taken[frame_i].add(best_j)
            tp.append(1.0)
            fp.append(0.0)
            conf.append(det.score)
            gt = gt_cls[frame_i][best_j]
            match["trans"].append(best)
            match["scale"].append(1.0 - _aligned_iou_3d(det, gt))
            period = math.pi if cls in PERIOD_PI else 2 * math.pi
            match["orient"].append(_angle_diff(det.ry, gt.ry, period))
            match["vel"].append(
                float(np.linalg.norm(det.velocity - gt.velocity))
            )
            match["attr"].append(
                float(det.attribute != gt.attribute)
                if gt.attribute >= 0 else np.nan
            )
            match_conf.append(det.score)
        else:
            tp.append(0.0)
            fp.append(1.0)
            conf.append(det.score)

    if npos == 0 or not match_conf:
        return MetricData.empty(), npos

    tp = np.cumsum(tp)
    fp = np.cumsum(fp)
    conf = np.asarray(conf, float)
    recall = tp / npos
    precision = tp / np.maximum(tp + fp, 1e-9)

    rec_interp = np.linspace(0, 1, N_REC)
    prec_i = np.interp(rec_interp, recall, precision, right=0)
    conf_i = np.interp(rec_interp, recall, conf, right=0)
    errs = {}
    mconf = np.asarray(match_conf, float)
    for key in TP_METRICS:
        tmp = _cummean(np.asarray(match[key], float))
        # error as a function of confidence, evaluated at the 101-point
        # confidence curve (devkit: interp over reversed/ascending conf)
        errs[key] = np.interp(conf_i[::-1], mconf[::-1], tmp[::-1])[::-1]
    return MetricData(rec_interp, prec_i, conf_i, errs), npos


def calc_ap(md: MetricData) -> float:
    """devkit calc_ap: mean over recall points 11..100 of the 10%-floored
    precision, normalized."""
    prec = np.copy(md.precision)[round(100 * MIN_RECALL) + 1:]
    prec -= MIN_PRECISION
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - MIN_PRECISION)


def calc_tp(md: MetricData, metric: str) -> float:
    """devkit calc_tp: mean of the cummean-error curve over recall points
    11..max_achieved; 1.0 when the detector never reaches 11% recall."""
    first = round(100 * MIN_RECALL) + 1
    last = md.max_recall_ind
    if last < first:
        return 1.0
    return float(np.mean(md.errs[metric][first:last + 1]))


def evaluate_nuscenes(gts, dets, cls_list) -> dict:
    """gts/dets: per-frame lists of NuscBox. Returns per-class APs, TP
    errors, mAP, and NDS."""
    results: dict = {"per_class": {}}
    aps_all = []
    tp_errs_all = {k: [] for k in TP_METRICS}
    for cls in cls_list:
        aps = []
        tp_md = None
        for th in DIST_THRESHOLDS:
            md, npos = _accumulate(gts, dets, cls, th)
            aps.append(calc_ap(md) if npos else 0.0)
            if th == TP_THRESHOLD:
                tp_md = md
        mean_ap = float(np.mean(aps))
        entry = {"ap": aps, "mean_ap": mean_ap}
        for key in TP_METRICS:
            if key in METRIC_EXCEPTIONS.get(cls, ()):
                continue
            err = calc_tp(tp_md, key)
            entry[key] = err
            tp_errs_all[key].append(err)
        results["per_class"][cls] = entry
        aps_all.append(mean_ap)

    mAP = float(np.mean(aps_all)) if aps_all else 0.0
    # NDS: fixed /10 — 5*mAP + one score per TP metric; a metric with no
    # applicable class (degenerate class list) contributes 0
    tp_scores = [
        max(0.0, 1.0 - float(np.mean(v))) if v else 0.0
        for v in tp_errs_all.values()
    ]
    results["tp_errors"] = {
        k: (float(np.mean(v)) if v else None) for k, v in tp_errs_all.items()
    }
    results["mAP"] = mAP
    results["NDS"] = float((5.0 * mAP + sum(tp_scores)) / 10.0)
    return results
