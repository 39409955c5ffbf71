"""KITTI 41-point AP evaluator (image / BEV("ground") / 3D metrics + AOS).

The port's copy of `ssd3d/eval/kitti_ap.py`, its C++ core taken from the
port's `native` (tests/test_torch_eval.py holds the two to the same AP).

Reimplements the official KITTI devkit protocol exactly as the reference's
in-process C++ evaluator does (lib/utils/tf_ops/evaluation/evaluate.cpp):

- difficulty gates: min box height {40, 25, 25}px, max occlusion {0, 1, 2},
  max truncation {0.15, 0.3, 0.5} (evaluate.cpp:37-40)
- neighbor classes (Van for Car, Person_sitting for Pedestrian) and
  difficulty-ignored GTs count neither as TP nor FN; DontCare areas absorb
  otherwise-FP detections (cleanData, evaluate.cpp:574-651)
- min overlap 0.7 Car / 0.5 Ped/Cyc for every metric (evaluate.cpp:52)
- 41 recall sample points; thresholds from TP scores via the devkit's
  left/right recall rule (getThresholds, evaluate.cpp:538); precision is
  right-max filtered; the reported AP averages every 4th point / 11
  (printAp, evaluate.cpp:935)
- greedy per-GT assignment identical to computeStatistics (evaluate.cpp:652)

Speed: rotated-BEV overlap matrices are computed ONCE per image with a
vectorized convex polygon clip (the C++ recomputes them per threshold —
41x redundant); the per-threshold assignment loop is tiny.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

MIN_HEIGHT = (40.0, 25.0, 25.0)
MAX_OCCLUSION = (0, 1, 2)
MAX_TRUNCATION = (0.15, 0.3, 0.5)
N_SAMPLE_PTS = 41
CLASS_NAMES = ("car", "pedestrian", "cyclist")
MIN_OVERLAP = {  # metric -> per-class
    "image": (0.7, 0.5, 0.5),
    "ground": (0.7, 0.5, 0.5),
    "3d": (0.7, 0.5, 0.5),
}
NEIGHBORS = {"car": ("van",), "pedestrian": ("person_sitting",)}


@dataclasses.dataclass
class EvalObject:
    """One GT or detection row. Boxes are KITTI-label style:
    t = bottom-center in rect coords, (l, h, w), ry; box2d = [x1, y1, x2, y2].
    """

    type: str
    box2d: np.ndarray
    t: np.ndarray
    l: float  # noqa: E741
    h: float
    w: float
    ry: float
    alpha: float = -10.0
    truncation: float = -1.0
    occlusion: int = -1
    score: float = -1000.0


# ---------------------------------------------------------------------------
# overlaps (vectorized per image)
# ---------------------------------------------------------------------------

def _bev_poly(objs) -> np.ndarray:
    """[n, 4, 2] BEV footprints in (x, z); devkit corner order."""
    out = np.zeros((len(objs), 4, 2))
    for i, o in enumerate(objs):
        c, s = math.cos(o.ry), math.sin(o.ry)
        lx = np.array([o.l / 2, o.l / 2, -o.l / 2, -o.l / 2])
        lz = np.array([o.w / 2, -o.w / 2, -o.w / 2, o.w / 2])
        out[i, :, 0] = c * lx + s * lz + o.t[0]
        out[i, :, 1] = -s * lx + c * lz + o.t[2]
    return out


def _poly_area(p: np.ndarray) -> float:
    x, z = p[:, 0], p[:, 1]
    return abs(np.dot(x, np.roll(z, -1)) - np.dot(z, np.roll(x, -1))) / 2.0


def _clip_convex(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland–Hodgman: clip convex polygon by convex quad (CCW)."""
    # ensure CCW clip orientation
    if _signed_area(clip) < 0:
        clip = clip[::-1]
    poly = list(subject if _signed_area(subject) > 0 else subject[::-1])
    for k in range(len(clip)):
        if not poly:
            return np.zeros((0, 2))
        p0, p1 = clip[k], clip[(k + 1) % len(clip)]
        edge = p1 - p0
        out = []
        n = len(poly)
        for i in range(n):
            a, b = poly[i], poly[(i + 1) % n]
            sa = edge[0] * (a[1] - p0[1]) - edge[1] * (a[0] - p0[0])
            sb = edge[0] * (b[1] - p0[1]) - edge[1] * (b[0] - p0[0])
            if sa >= 0:
                out.append(a)
            if (sa >= 0) != (sb >= 0):
                t = sa / (sa - sb)
                out.append(a + t * (b - a))
        poly = out
    return np.asarray(poly) if poly else np.zeros((0, 2))


def _signed_area(p) -> float:
    p = np.asarray(p)
    x, z = p[:, 0], p[:, 1]
    return (np.dot(x, np.roll(z, -1)) - np.dot(z, np.roll(x, -1))) / 2.0


def bev_overlap_matrix(dets, gts) -> np.ndarray:
    """Rotated BEV intersection areas [n_det, n_gt]."""
    pd, pg = _bev_poly(dets), _bev_poly(gts)
    # AABB prefilter
    d_lo, d_hi = pd.min(1), pd.max(1)
    g_lo, g_hi = pg.min(1), pg.max(1)
    maybe = (
        (d_lo[:, None, 0] < g_hi[None, :, 0]) & (d_hi[:, None, 0] > g_lo[None, :, 0])
        & (d_lo[:, None, 1] < g_hi[None, :, 1]) & (d_hi[:, None, 1] > g_lo[None, :, 1])
    )
    inter = np.zeros((len(dets), len(gts)))
    for i, j in zip(*np.where(maybe)):
        clipped = _clip_convex(pd[i], pg[j])
        if len(clipped) >= 3:
            inter[i, j] = _poly_area(clipped)
    return inter


def overlap_matrix(dets, gts, metric: str, criterion: int = -1) -> np.ndarray:
    """IoU-like overlap [n_det, n_gt] for a metric. criterion: -1 union,
    0 normalize by detection area/volume (used for DontCare absorption)."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    if metric == "image":
        db = np.stack([d.box2d for d in dets])
        gb = np.stack([g.box2d for g in gts])
        x1 = np.maximum(db[:, None, 0], gb[None, :, 0])
        y1 = np.maximum(db[:, None, 1], gb[None, :, 1])
        x2 = np.minimum(db[:, None, 2], gb[None, :, 2])
        y2 = np.minimum(db[:, None, 3], gb[None, :, 3])
        inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
        a_d = (db[:, 2] - db[:, 0]) * (db[:, 3] - db[:, 1])
        a_g = (gb[:, 2] - gb[:, 0]) * (gb[:, 3] - gb[:, 1])
        denom = (
            a_d[:, None] if criterion == 0
            else a_d[:, None] + a_g[None, :] - inter
        )
        return inter / np.maximum(denom, 1e-12)

    inter_bev = bev_overlap_matrix(dets, gts)
    a_d = np.array([d.l * d.w for d in dets])
    a_g = np.array([g.l * g.w for g in gts])
    if metric == "ground":
        denom = (
            a_d[:, None] if criterion == 0
            else a_d[:, None] + a_g[None, :] - inter_bev
        )
        return inter_bev / np.maximum(denom, 1e-12)

    # 3d: multiply by y-extent overlap (y down; box spans [t_y - h, t_y])
    ty_d = np.array([d.t[1] for d in dets])
    ty_g = np.array([g.t[1] for g in gts])
    h_d = np.array([d.h for d in dets])
    h_g = np.array([g.h for g in gts])
    ymax = np.minimum(ty_d[:, None], ty_g[None, :])
    ymin = np.maximum((ty_d - h_d)[:, None], (ty_g - h_g)[None, :])
    inter_vol = inter_bev * np.maximum(ymax - ymin, 0.0)
    v_d = a_d * h_d
    v_g = a_g * h_g
    denom = (
        v_d[:, None] if criterion == 0
        else v_d[:, None] + v_g[None, :] - inter_vol
    )
    return inter_vol / np.maximum(denom, 1e-12)


# ---------------------------------------------------------------------------
# devkit protocol
# ---------------------------------------------------------------------------

def _clean_data(cls_idx: int, gts, dets, difficulty: int):
    cls_name = CLASS_NAMES[cls_idx]
    ignored_gt, n_gt = [], 0
    dontcare = []
    for g in gts:
        t = g.type.lower()
        if t == cls_name:
            valid = 1
        elif t in NEIGHBORS.get(cls_name, ()):
            valid = 0
        else:
            valid = -1
        height = g.box2d[3] - g.box2d[1]
        ignore = (
            g.occlusion > MAX_OCCLUSION[difficulty]
            or g.truncation > MAX_TRUNCATION[difficulty]
            or height <= MIN_HEIGHT[difficulty]
        )
        if valid == 1 and not ignore:
            ignored_gt.append(0)
            n_gt += 1
        elif valid == 0 or (ignore and valid == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if t == "dontcare":
            dontcare.append(g)

    ignored_det = []
    for d in dets:
        height = abs(d.box2d[3] - d.box2d[1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_det.append(1)
        elif d.type.lower() == cls_name:
            ignored_det.append(0)
        else:
            ignored_det.append(-1)
    return np.asarray(ignored_gt), dontcare, np.asarray(ignored_det), n_gt


def _statistics(gts, dets, overlap, dc_overlap, ignored_gt, ignored_det,
                min_overlap, compute_fp, thresh, compute_aos):
    """One image, one threshold (computeStatistics, evaluate.cpp:652)."""
    NO_DET = -1e7
    n_det = len(dets)
    assigned = np.zeros(n_det, bool)
    ign_thresh = np.zeros(n_det, bool)
    if compute_fp:
        for j in range(n_det):
            if dets[j].score < thresh:
                ign_thresh[j] = True

    tp = fp = fn = 0
    scores, deltas = [], []
    for i in range(len(gts)):
        if ignored_gt[i] == -1:
            continue
        det_idx, valid_det, max_ov = -1, NO_DET, 0.0
        assigned_ignored = False
        for j in range(n_det):
            if ignored_det[j] == -1 or assigned[j] or ign_thresh[j]:
                continue
            ov = overlap[j, i]
            if not compute_fp:
                if ov > min_overlap and dets[j].score > valid_det:
                    det_idx, valid_det = j, dets[j].score
            elif ov > min_overlap and (ov > max_ov or assigned_ignored) \
                    and ignored_det[j] == 0:
                max_ov, det_idx, valid_det = ov, j, 1.0
                assigned_ignored = False
            elif ov > min_overlap and valid_det == NO_DET and ignored_det[j] == 1:
                det_idx, valid_det = j, 1.0
                assigned_ignored = True

        if valid_det == NO_DET and ignored_gt[i] == 0:
            fn += 1
        elif valid_det != NO_DET and (ignored_gt[i] == 1 or ignored_det[det_idx] == 1):
            assigned[det_idx] = True
        elif valid_det != NO_DET:
            tp += 1
            scores.append(dets[det_idx].score)
            if compute_aos:
                deltas.append(gts[i].alpha - dets[det_idx].alpha)
            assigned[det_idx] = True

    similarity = 0.0
    if compute_fp:
        for j in range(n_det):
            if not (assigned[j] or ignored_det[j] != 0 or ign_thresh[j]):
                fp += 1
        # DontCare absorption
        nstuff = 0
        for i in range(dc_overlap.shape[1]):
            for j in range(n_det):
                if assigned[j] or ignored_det[j] != 0 or ign_thresh[j]:
                    continue
                if dc_overlap[j, i] > min_overlap:
                    assigned[j] = True
                    nstuff += 1
        fp -= nstuff
        if compute_aos:
            sims = [0.0] * fp + [(1.0 + math.cos(d)) / 2.0 for d in deltas]
            similarity = sum(sims) if (tp > 0 or fp > 0) else -1.0
    return tp, fp, fn, scores, similarity


def _thresholds(scores: list, n_gt: int) -> list:
    v = sorted(scores, reverse=True)
    t, current = [], 0.0
    for i, s in enumerate(v):
        l_r = (i + 1) / n_gt
        r_r = (i + 2) / n_gt if i < len(v) - 1 else l_r
        if (r_r - current) < (current - l_r) and i < len(v) - 1:
            continue
        t.append(s)
        current += 1.0 / (N_SAMPLE_PTS - 1.0)
    return t


_GT_CODES = {"car": 0, "pedestrian": 1, "cyclist": 2, "van": 3,
             "person_sitting": 4, "dontcare": 5}
_METRIC_CODES = {"image": 0, "ground": 1, "3d": 2}


def _flatten_for_native(gt_per_image, det_per_image):
    gt_rows, det_rows, gt_counts, det_counts = [], [], [], []
    for gts, dets in zip(gt_per_image, det_per_image):
        gt_counts.append(len(gts))
        det_counts.append(len(dets))
        for g in gts:
            gt_rows.append([
                _GT_CODES.get(g.type.lower(), -1), *g.box2d, *g.t,
                g.l, g.h, g.w, g.ry, g.alpha, g.truncation, g.occlusion,
            ])
        for d in dets:
            det_rows.append([
                _GT_CODES.get(d.type.lower(), -1), *d.box2d, *d.t,
                d.l, d.h, d.w, d.ry, d.alpha, d.score,
            ])
    gt_arr = np.asarray(gt_rows, np.float32).reshape(-1, 15)
    det_arr = np.asarray(det_rows, np.float32).reshape(-1, 14)
    return gt_arr, np.asarray(gt_counts, np.int32), det_arr, np.asarray(
        det_counts, np.int32
    )


def eval_class(gt_per_image, det_per_image, cls_idx, difficulty, metric,
               compute_aos=False, use_native: bool | None = None):
    """-> (precision[41], aos[41] or None).

    Dispatches to the C++ core (ssd3d_torch/native/kitti_eval.cc) when it
    builds; `use_native=False` forces the numpy path (tests cross-check both)."""
    if use_native is None or use_native:
        from ssd3d_torch import native

        if native.load() is not None:
            gt_arr, gt_counts, det_arr, det_counts = _flatten_for_native(
                gt_per_image, det_per_image
            )
            prec, aos = native.kitti_eval_class_native(
                gt_arr, gt_counts, det_arr, det_counts,
                cls_idx, difficulty, _METRIC_CODES[metric],
                MIN_OVERLAP[metric][cls_idx], compute_aos,
            )
            return prec, aos
        if use_native:
            raise RuntimeError("native evaluator requested but not built")

    n_images = len(gt_per_image)
    min_ov = MIN_OVERLAP[metric][cls_idx]

    cleaned, overlaps, dc_overlaps = [], [], []
    n_gt_total = 0
    all_scores = []
    for i in range(n_images):
        gts, dets = gt_per_image[i], det_per_image[i]
        ignored_gt, dc, ignored_det, n_gt = _clean_data(
            cls_idx, gts, dets, difficulty
        )
        n_gt_total += n_gt
        ov = overlap_matrix(dets, gts, metric, -1)
        dc_ov = overlap_matrix(dets, dc, metric, 0)
        cleaned.append((ignored_gt, dc, ignored_det))
        overlaps.append(ov)
        dc_overlaps.append(dc_ov)
        _, _, _, scores, _ = _statistics(
            gts, dets, ov, dc_ov, ignored_gt, ignored_det, min_ov,
            compute_fp=False, thresh=0.0, compute_aos=False,
        )
        all_scores.extend(scores)

    thresholds = _thresholds(all_scores, max(n_gt_total, 1))
    tps = np.zeros(len(thresholds))
    fps = np.zeros(len(thresholds))
    fns = np.zeros(len(thresholds))
    sims = np.zeros(len(thresholds))
    for i in range(n_images):
        ignored_gt, dc, ignored_det = cleaned[i]
        for t, thr in enumerate(thresholds):
            tp, fp, fn, _, sim = _statistics(
                gt_per_image[i], det_per_image[i], overlaps[i],
                dc_overlaps[i], ignored_gt, ignored_det, min_ov,
                compute_fp=True, thresh=thr, compute_aos=compute_aos,
            )
            tps[t] += tp
            fps[t] += fp
            fns[t] += fn
            if sim != -1:
                sims[t] += sim

    precision = np.zeros(N_SAMPLE_PTS)
    aos = np.zeros(N_SAMPLE_PTS) if compute_aos else None
    for t in range(len(thresholds)):
        denom = max(tps[t] + fps[t], 1e-12)
        precision[t] = tps[t] / denom
        if compute_aos:
            aos[t] = sims[t] / denom
    # right-max filtering
    for t in range(len(thresholds)):
        precision[t] = precision[t:].max()
        if compute_aos:
            aos[t] = aos[t:].max()
    return precision, aos


def ap_from_curve(precision: np.ndarray) -> float:
    """Devkit AP: mean of every 4th of the 41 points, x100
    (printAp, evaluate.cpp:935)."""
    return float(np.sum(precision[0::4]) / 11.0 * 100.0)


def evaluate_kitti_ap(gt_per_image, det_per_image, cls_list=("Car",),
                      metrics=("image", "ground", "3d"), compute_aos=False):
    """Full evaluation. gt/det_per_image: lists (per scan) of EvalObject.

    Returns {class: {metric: [AP_easy, AP_moderate, AP_hard]}} (+ 'aos').
    """
    results: dict = {}
    for cls_name in cls_list:
        cls_idx = CLASS_NAMES.index(cls_name.lower())
        results[cls_name] = {}
        for metric in metrics:
            aps, aoss = [], []
            for difficulty in range(3):
                prec, aos = eval_class(
                    gt_per_image, det_per_image, cls_idx, difficulty,
                    metric, compute_aos=compute_aos and metric == "image",
                )
                aps.append(ap_from_curve(prec))
                if aos is not None:
                    aoss.append(ap_from_curve(aos))
            results[cls_name][metric] = aps
            if metric == "image" and compute_aos:
                results[cls_name]["aos"] = aoss
    return results
