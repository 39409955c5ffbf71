"""What the configuration's shapes ask of the card, counted from its layer
spec alone: the FLOPs of a batch (every shared-MLP, vote, head, FP, RoI
pool and RCNN multiply-add, twice), and each kernel launch's least time,
the larger of its operations at the published rate of their type and its
bytes (each input read once, each output written once) at the memory's
rate. Nothing here reads which route or compile flags the program chose.
"""

from __future__ import annotations

from portbench import peaks
from portbench.reference import nets

# D-FPS: per pick and point, the three differences, three squares, two
# adds, the running minimum and the argmax's compare
FPS_OPS_PER_POINT_PICK = 10


def mlp_macs(c_in: int, widths) -> int:
    macs = 0
    for c in widths:
        macs += c_in * c
        c_in = c
    return macs


def _walk(rows, n_in: int, c_in: int, aggregate: bool, prefix_points=(), prefix_ch=()):
    """The backbone's rows -> (MACs a cloud, D-FPS calls [(n, npoint)],
    SA-layer shapes [(n, m, c_in, ns_list, mlps, agg)], points and channels
    of each list entry)."""
    pts, ch = list(prefix_points) + [n_in], list(prefix_ch) + [c_in]
    macs, dfps, sa = 0, [], []
    picks_of = {}
    for i, row in enumerate(rows):
        li = len(pts)
        src = row[0][0]
        n, c = pts[src], ch[row[1][0]]
        kind = row[11]
        if kind == "SA_Layer":
            if row[14] != -1:
                m = pts[row[14]]
            else:
                m, start = 0, 0
                for rng, method, npoint in zip(row[6], row[7], row[8]):
                    length = (n - start) if rng == -1 else rng
                    if npoint:
                        m += npoint * (2 if method == "FS" else 1)
                        if method in ("D-FPS", "FS") and (npoint < length or method == "FS"):
                            dfps.append((length, npoint))
                    start += length
            if row[9] != -1:
                m += picks_of[row[9]]
            picks_of[li] = m
            out = c
            radii, ns_list, mlps = row[2], row[3], row[4]
            if radii:
                scales = len(radii)
                for k in range(scales):
                    macs += m * ns_list[k] * mlp_macs(c + 3, mlps[k])
                out = sum(mlp[-1] for mlp in mlps[:scales])
                agg = row[15] if aggregate and row[15] != -1 else None
                if agg:
                    macs += m * out * agg
                sa.append((n, m, c, list(ns_list[:scales]), [list(x) for x in mlps[:scales]],
                           agg))
                out = agg or out
            pts.append(m)
            ch.append(out)
        elif kind == "Vote_Layer":
            macs += n * (mlp_macs(c, row[4]) + row[4][-1] * 3)
            pts.append(n)
            ch.append(row[4][-1])
        elif kind == "FP_Layer":
            c_in_fp = ch[row[1][1]] + c
            macs += n * mlp_macs(c_in_fp, row[4])
            pts.append(n)
            ch.append(row[4][-1])
        else:  # SA_Layer_SSG_Last: one vector a cloud
            macs += n * mlp_macs(c + 3, row[4])
            pts.append(1)
            ch.append(row[4][-1])
    return macs, dfps, sa, pts, ch


def _head_macs(heads, pts, ch, cls_ch: int, reg_out: int) -> int:
    macs = 0
    for xyz_idx, feat_idx, _op, mlp, _bn, _kind, _scope in heads:
        n = sum(pts[j] for j in feat_idx)
        c = sum(ch[j] for j in feat_idx)
        t = mlp[-1] if mlp else c
        macs += n * (mlp_macs(c, mlp) + 2 * t * 128 + 128 * cls_ch + 128 * reg_out)
    return macs


def _stage_outputs(cfg: dict, stage: str) -> tuple[int, int]:
    sc = cfg["MODEL"][stage]
    method = sc["REGRESSION_METHOD"]["TYPE"]
    n_cls = len(cfg["DATASET"]["KITTI"]["CLS_LIST"])
    reg_base = 1 if method.endswith("free") else n_cls
    reg_ch = 6 if method != "Bin-Anchor" else sc["REGRESSION_METHOD"]["BIN_CLASS_NUM"] * 4 + 4
    cls_ch = n_cls + (1 if sc["CLS_ACTIVATION"] == "Softmax" else 0)
    return cls_ch, reg_base * (reg_ch + 2 * cfg["MODEL"]["ANGLE_CLS_NUM"])


def shapes(cfg: dict, batch: int) -> dict:
    """The counts of one batch: `macs`, `dfps` [(clouds, n, npoint)], and
    `sa_fused` [(clouds, n, m, c_in, ns_list, mlps, agg)] (the RCNN's SA
    layers, which run as the fused SA kernel). A two-stage model's RoI
    pooler counts its own multiply-adds and says what the RCNN gets
    (`reference/poolers/`)."""
    m, net = cfg["MODEL"], cfg["MODEL"]["NETWORK"]
    agg = net["AGGREGATION_SA_FEATURE"]
    n_points = m["POINTS_NUM_FOR_TRAINING"]
    macs, dfps, _, pts, ch = _walk(net["FIRST_STAGE"]["ARCHITECTURE"], n_points, 1, agg)
    cls_ch, reg_out = _stage_outputs(cfg, "FIRST_STAGE")
    macs += _head_macs(net["FIRST_STAGE"]["HEAD"], pts, ch, cls_ch, reg_out)
    out = {"macs": macs * batch, "dfps": [(batch, n, k) for n, k in dfps], "sa_fused": []}
    if m["TYPE"] != "DoubleStage":
        return out
    rois = batch * m["FIRST_STAGE"]["MAX_OUTPUT_NUM"]
    head = net["FIRST_STAGE"]["HEAD"][0]
    pool = nets.pooler(cfg, head[3][-1] if head[3] else sum(ch[j] for j in head[1]))
    # the RCNN's features come after each point's canonical xyz
    rmacs, rdfps, rsa, rpts, rch = _walk(net["SECOND_STAGE"]["ARCHITECTURE"], pool.points,
                                         pool.channels - 3, agg, prefix_points=(1,),
                                         prefix_ch=(0,))
    cls2, reg2 = _stage_outputs(cfg, "SECOND_STAGE")
    rmacs += _head_macs(net["SECOND_STAGE"]["HEAD"], rpts, rch, cls2, reg2)
    out["macs"] += rois * (pool.macs + rmacs)
    out["dfps"] += [(rois, n, k) for n, k in rdfps]
    out["sa_fused"] = [(rois,) + s for s in rsa]
    return out


def flops(cfg: dict, batch: int, train: bool = False) -> float:
    """FLOPs of a batch's forward (a train step: three times that)."""
    return 2.0 * shapes(cfg, batch)["macs"] * (3 if train else 1)


def fps_bound_s(clouds: int, n: int, npoint: int) -> float:
    """K1's least time for one launch."""
    ops = FPS_OPS_PER_POINT_PICK * clouds * n * npoint
    bytes_ = clouds * (n * 3 * 4 + npoint * 4)
    return max(ops / peaks.F32_FLOP_PER_S, bytes_ / peaks.HBM_BYTES_PER_S)


def sa_fused_bound_s(clouds: int, n: int, m: int, c_in: int, ns_list, mlps, agg) -> float:
    """K7's least time for one launch: its products at the f32 matrix rate
    (the max-pool's compares are far below them), and its inputs (the
    cloud rows of c_in + 3 floats, each ball's indices, the centres, the
    masks, the weights) and output once."""
    macs = sum(m * ns * mlp_macs(c_in + 3, mlp) for ns, mlp in zip(ns_list, mlps))
    out_c = sum(mlp[-1] for mlp in mlps)
    if agg:
        macs += m * out_c * agg
    weights = sum(mlp_macs(c_in + 3, mlp) + 3 * sum(mlp) for mlp in mlps)
    bytes_ = 4 * (clouds * (n * (c_in + 3) + m * sum(ns_list) + m * 3 + m * len(ns_list)
                            + m * (agg or out_c)) + weights)
    return max(2.0 * clouds * macs / peaks.F32_MATMUL_FLOP_PER_S, bytes_ / peaks.HBM_BYTES_PER_S)
