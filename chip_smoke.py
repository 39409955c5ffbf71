#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`ssd3d_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Ten phases, each of which raises on failure (no error is caught):

1. Environment: the card's name and power limit, torch / CUDA / nvcc
   versions, and the build of the CUDA kernels from `ssd3d_torch/csrc/`
   (one nvcc per source, in parallel).
2. Each kernel against its plain PyTorch version on the card, at the
   flagship's shapes (batch 8), with the kernel's and the plain version's
   times (`cuda_ms`: events around back-to-back calls); K1 on all three of
   its routes at every D-FPS shape of the three paths, and on its slice
   route past 16,384 points (nuScenes' SA1 on a 65,536-point synthetic
   scan, [2, 65536] -> 16384, [32, 32768] -> 1024 at every cluster size,
   [1, 262144] and [1, 524288], each tier of the slice route); K2 on every
   route its shape admits (picks equal to the row-wise plain version's) at
   SA2 and SA3, at SA2's shape over 1, 2 and 16 clouds, at every cluster
   size that fits, and at [1, 16384, 67], [2, 16384, 131] and
   [1, 65536, 4]; K3 on both routes at SA1-SA3 and CG-SA; K4 against
   `torch.gather`; K5, the scatter-add (the gather's backward), bit for bit
   the CPU plain version (`index_add_`, which adds each destination's rows
   in ascending order, as K5 does) and a second launch, at the three layer
   shapes and the four of `tests/test_torch_ops.py`, timed against
   `torch.index_add`.
3. The main path: flagship 3DSSD inference (KITTI Car,
   `configs/kitti/3dssd/3dssd.yaml`, 16,384-point scans, bf16 as shipped,
   seeded weights) on a batch of 8 synthetic KITTI-like scans: forward,
   decode and NMS. Asserts finite outputs, at most 100 boxes per scan and
   that every kernel was launched, each K1, K2 and K3 launch on the route
   its shape takes; prints scans/s at batch 8 and the median batch-1
   latency, and scans/s and a profile with K1 on each of its routes and
   with K2 and K3 on their first designs' routes (one block a cloud; brute
   force).
4. The card against the CPU on one scan: the kernel path on the GPU and the
   plain path on the CPU, same weights, compared pick by pick and box by box.
5. The training path: the flagship train step (`train_entry`, batch 8 =
   BATCH_SIZE 4 x GPU_NUM 2, bf16, Adam, fixed batch of synthetic scenes):
   a warm-up step and ten timed ones. Asserts finite losses, a lower total
   after the last step than after the first, moved BatchNorm statistics and
   that every kernel launched in one step (the scatter-add 8 times; K1-K3
   by route as in phase 3); prints
   the step time, training scans/s, peak memory and a profile of one step;
   then holds K5 at the inputs of the step's 8 calls, bit for bit, timed.
6. One f32 train step on the card against the CPU on 2 scans, same weights:
   sampling picks, losses, every gradient leaf and the new BatchNorm
   statistics; and reports (not asserted: cuBLAS and the BatchNorm
   reductions keep no fixed order) how many gradient leaves two card steps
   from the same state give bit for bit.
7. PointRCNN's kernels against their plain versions on the card, on the
   inputs of every launch in one PointRCNN forward (batch 4): K1 D-FPS on
   both routes (RPN and the RCNN's 400 clouds), K3 ball query on both
   routes (timed), K4 gather
   (RPN grouping, RegionPool's xyz, features and mask, the last three timed
   against `torch.gather`) equal or bit-identical; K6
   three_nn at the four FP layers' shapes and on a tie-heavy input of each,
   over 1, 2, 4 and 8 slices of the knowns, each timed (indices equal,
   distances within 1 ulp); K7 fused SA at the RCNN's SA1 and SA2 on both of its routes
   (wgmma and FMA; and once with one scale, unmasked, timed too), with the
   kernel's and the plain version's times, both bounds (3xTF32 on the
   tensor cores, f32 FMA), the SA module's own forward on the fused and the
   unfused route, and SA1's module both ways at 16, 64 and 400 clouds.
8. The PointRCNN path: inference (`two_stage_entry`, KITTI Car,
   `configs/kitti/pointrcnn/pointrcnn_test.yaml`, full widths and depth,
   f32, 16,384-point scans, 100 proposals, seeded weights) at batch 4.
   Asserts finite outputs, at most 100 boxes and proposals per scan and the
   launches of one forward (K6 4, K7 2, K1 6, K3 and K4 some, K2 and K5
   none; K1, K3 and K7 by route); prints scans/s, the median batch-1 latency,
   peak memory, a profile; then at batch 1, 2, 4, 8 and 16 the median of
   nine timed passes and the device busy time of a profiled one, and the
   fixed and per-scan costs fitted to them. The batch of 4 is profiled
   again with K1 on its one-block route and with K3 on brute force.
9. PointRCNN on the card against the CPU on one scan: RPN picks, head
   outputs, candidates, and the proposal NMS's keep sets (a candidate kept
   on one leg only must be a near-tie on the CPU's values); then the card's
   proposals through both legs' RCNN, with the card's RoI decisions
   replayed on the CPU leg, the final boxes and scores, and the final NMS's
   keep sets held the same way.

The second line from the end is a JSON object with one entry per kernel:
`launches_by_path` counts its launches in one run of each path (flagship
inference, phase 3; one training step, phase 5; PointRCNN inference, phase
8; phase 10's training run A of 20 steps, the flagship's evaluate and test,
and PointRCNN's evaluate and test), `launches` is their sum; times and bounds are of the shape in `shape`
(K1's, K2's and K3's on the route that shape takes; `routes` holds every
route's times at each shape of theirs, and `launches_by_route` their
launches by route on each path, which phases 3, 5 and 8 hold to the route
each call's shape takes; K7's likewise). Operations of the kernels built
with -fmad=false count at the f32 rate of instructions that are not FFMAs
(`H100_F32_OP_PER_S`). K3's bound counts the pairs inside
the outer ring only; K7's is its wgmma route's, three TF32 products a
multiply-add at the tensor cores' TF32 rate (`bound_fma_ms`: one f32 FMA at
the f32 FLOP rate).
The profiles of phases 3 and 8 list each D-FPS launch.
The last line is {"ok": true, "device": {...}}. Without a CUDA device the
script exits with code 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from ssd3d_torch.bin import evaluate as evaluate_cli
from ssd3d_torch.bin import preprocess as preprocess_cli
from ssd3d_torch.bin import test as test_cli
from ssd3d_torch.bin import train as train_cli
from ssd3d_torch.config import load_cfg
from ssd3d_torch.core.geometry import boxes_to_bev_aabb, canonicalize_points
from ssd3d_torch.core.iou import aabb_iou
from ssd3d_torch.data.loader import KittiLoader
from ssd3d_torch.entry import (
    FLAGSHIP_CFG,
    POINTRCNN_CFG,
    flagship,
    init_weights,
    pointrcnn,
    synthetic_scenes,
    train_entry,
    two_stage_entry,
)
from ssd3d_torch.models.api import build_pipeline
from ssd3d_torch.models import two_stage
from ssd3d_torch.nn import modules
from ssd3d_torch.nn.modules import ffps_segments
from ssd3d_torch.nn.modules import max_pool as _max_pool
from ssd3d_torch.ops import _build, grouping, interpolate, sa_fused, sampling
from ssd3d_torch.ops.grouping import (
    ball_query_multi,
    ball_query_multi_plain,
    gather_rows,
    gather_rows_plain,
    ring_specs,
    scatter_add_rows,
    scatter_add_rows_plain,
)
from ssd3d_torch.ops.interpolate import three_nn, three_nn_plain
from ssd3d_torch.ops.nms import _nms_rows as nms_rows
from ssd3d_torch.ops.nms import class_unaware_nms
from ssd3d_torch.ops.sampling import (
    farthest_point_sample,
    farthest_point_sample_features,
    ffps_plain,
    fps_pick_shortfall,
    fps_plain,
    fps_route,
    gather_points,
)
from ssd3d_torch.ops.topk import top_k_set
from ssd3d_torch.train.schedules import bn_momentum
from ssd3d_torch.train.train_step import TrainGraph
from ssd3d_torch.train.trainer import CheckpointManager
from ssd3d_torch.utils import synth
from ssd3d_torch.utils.timing import cuda_ms

BATCH = 8
N_POINTS = 16384
# An F-FPS pick may fall short of the step's farthest distance by this much
# (relative): kernel and plain version sum d2 in the same order, so any gap
# beyond float32 rounding is a wrong pick.
FFPS_TIE_RTOL = 1e-5
# Card against CPU, relative to the largest |value| of the compared tensor.
# float32: cuBLAS and the CPU BLAS sum products in different orders, ~1e-7
# relative per layer over ~20 layers. bfloat16: the same order differences
# can land a product one bf16 step (2^-8) apart, which later layers carry on.
F32_TOL = 1e-4
BF16_TOL = 2.0 ** -6
# bfloat16 with trained weights (phase 10): trained layers carry a bf16 step
# of rounding much further than seeded ones. After 20 Adam steps the JAX
# package's own bf16 forward parts from its f32 one by 67-97% of the largest
# head value, and the port's by as much (the F-FPS picks go another way;
# test_trained_weights_part_bf16_from_f32_in_both_frameworks in
# tests/test_torch_model.py). With every pick equal, card and CPU part by
# 2.4-3.8% on run A's step-20 weights (H100); the limit keeps 1.6x of that.
BF16_TRAINED_TOL = 2.0 ** -4
TRAIN_STEPS = 10
# One f32 train step, card against CPU: each gradient leaf within this
# fraction of its largest |entry|.
TRAIN_GRAD_TOL = 1e-3
_relu = torch.relu
TWO_STAGE_BATCH = 4
# timed PointRCNN passes per batch size (phase 8)
PASSES = 9
# K7 against its plain version, relative to the largest |value|: both sum
# every dot to f32 accuracy, K7 as three TF32 products (wgmma route) or in
# channel order with fmaf (FMA route), cuBLAS in its own order
K7_TOL = 1e-4
# The H100 SXM's published peaks (NVIDIA data sheet, at 700 W): HBM3 bytes/s,
# f32 FLOP/s outside the tensor cores, and dense TF32 FLOP/s of the tensor
# cores (K7's wgmma route). The f32 figure counts an FFMA as two FLOPs (132
# SMs x 128 lanes x 2 x 1.98 GHz): it bounds work written as FFMAs (K7's FMA
# route). The other kernels are compiled with -fmad=false, so that their
# arithmetic matches the plain versions bit for bit: each subtract,
# multiply, add, min or compare is an instruction of its own, at half that
# rate (H100_F32_OP_PER_S), and their operations are counted against it.
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOP_PER_S = 67e12
H100_F32_OP_PER_S = 33.5e12
H100_TF32_FLOP_PER_S = 495e12


def bound(n_bytes: float, ops: float, rate: float = H100_F32_OP_PER_S) -> dict:
    """The least time the card could take for a kernel's work: the larger of
    its bytes (each input read once, each output written once) over the
    memory rate and its operations over the rate of their type (f32
    operations that are not FFMAs unless `rate` says otherwise)."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def ball_query_ring_pairs(specs, xyz: torch.Tensor, q: torch.Tensor) -> int:
    """(query, point) pairs inside the outer ring on this data: the pairs
    whose d2 and ring tests the contract needs (K3's bound counts these
    only; a pair outside every ring takes no work once a grid rules it out)."""
    hi2 = max(s[1] for s in specs)
    pairs = 0
    for q0 in range(0, q.shape[1], 256):
        pairs += int((grouping._pairwise_dist2(q[:, q0:q0 + 256], xyz) < hi2).sum())
    return pairs


def check(ok: bool, what: str) -> None:
    """Fail the run (a check, not an assert: it holds under python -O too)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def log(msg: str = "") -> None:
    print(msg, flush=True)


def on_route(route: str):
    """K1 forced onto `route` ("block", "cluster" or "slice") while the context holds:
    for timing and for holding both routes to the plain version."""
    return mock.patch.object(sampling, "fps_route", lambda b, n: route)


def on_ffps_route(route: str):
    """K2 forced onto `route` ("block", "cluster" or "stream")."""
    return mock.patch.object(sampling, "ffps_route", lambda b, n, c: route)


def on_ball_route(route: str):
    """K3 forced onto `route` ("grid" or "brute")."""
    return mock.patch.object(grouping, "ball_query_route", lambda n: route)


def on_sa_route(route: str):
    """K7 forced onto `route` ("wgmma" or "fma")."""
    return mock.patch.object(sa_fused, "sa_fused_route", lambda cp, ns, widths: route)


# K7's routes, each held to the plain version and timed in phase 7
K7_ROUTES = ("wgmma", "fma")


def on_first_routes():
    """K2 on its one-block route and K3 on its brute-force route: the first
    designs of both, the yardstick of this run's end-to-end comparisons."""
    stack = contextlib.ExitStack()
    stack.enter_context(on_ffps_route("block"))
    stack.enter_context(on_ball_route("brute"))
    return stack


# The calls of each path to the kernels with routes: D-FPS (clouds, points) a call,
# F-FPS (clouds, points, channels) a call, ball-query points a cloud a call,
# fused SA (input width, ns list, widths) a call (3DSSD inference and its
# train step: SA1-SA3 and CG-SA at batch 8; PointRCNN at batch 4: RPN
# SA1-SA4, then the RCNN's SA1-SA2 over 400 RoIs).
PATH_CALLS = {
    "3DSSD": dict(fps=[(8, 16384), (8, 4096), (8, 512)], ffps=[(8, 4096, 67), (8, 512, 131)],
                  ball_query=[16384, 4096, 1024, 512], sa_fused=[]),
    "PointRCNN": dict(fps=[(4, 16384), (4, 4096), (4, 1024), (4, 256), (400, 512), (400, 128)],
                      ffps=[],
                      ball_query=[16384, 4096, 1024, 256, 512, 128],
                      sa_fused=[(259, [64], [[128, 128, 128]]), (131, [64], [[128, 128, 256]])]),
}


def path_routes(path: str) -> dict[str, dict[str, int]]:
    """The launches by route that the shape rules give a path's calls."""
    calls = PATH_CALLS[path]
    routes = {"fps": [fps_route(*shape) for shape in calls["fps"]],
              "ffps": [sampling.ffps_route(*shape) for shape in calls["ffps"]],
              "ball_query": [grouping.ball_query_route(n) for n in calls["ball_query"]],
              "sa_fused": [sa_fused.sa_fused_route(*shape) for shape in calls["sa_fused"]]}
    return {k: {r: v.count(r) for r in sorted(set(v))} for k, v in routes.items()}


def check_routes(what: str, path: str) -> dict[str, dict[str, int]]:
    """K1's, K2's and K3's launches by route since the last reset, held to
    what the shape rules give `path`."""
    got, want = _build.route_launches(), path_routes(path)
    log(f"launches by route in {what}: {got}")
    check(got == want, f"{what}: launches by route {got}, want {want}")
    return got


# ----------------------------------------------------------------- phase 1

def phase_environment() -> str:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("== phase 1: environment")
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log("card (nvidia-smi name, power.limit):")
    log(card)
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, nvcc: {nvcc}")
    log(f"device 0: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s: {path.name}")
    name = "?"
    for line in _build.build_log.splitlines():
        entry = re.search(r"entry function '.*?\d+([a-z_]+_kernel)(?:IL[ib](\d+)E)?", line)
        if entry:
            name = entry.group(1) + (f"<{entry.group(2)}>" if entry.group(2) else "")
        elif "Used" in line or "spill stores" in line:
            log(f"  ptxas {name}: {line.split(':', 1)[-1].strip()}")
        elif "wgmma" in line:  # ptxas serializing the wgmma pipeline, and why
            log(f"  ptxas: {line.strip()}")
    return card


# ----------------------------------------------------------------- phase 2

def ball_query_routes(name: str, pts, q, radii, ns, dilated: bool, plain: bool = True) -> dict:
    """K3 on both routes against its plain version at one shape (idx and cnt
    equal), each route timed; the plain version timed too with `plain`."""
    specs = ring_specs(radii, ns, dilated)
    ref = ball_query_multi_plain(specs, pts, q)
    times = {}
    for route in ("grid", "brute"):
        with on_ball_route(route):
            got = ball_query_multi(radii, ns, pts, q, dilated=dilated)
            for (gi, gc), (ri, rc) in zip(got, ref):
                check(torch.equal(gc, rc), f"ball query cnt differs on the {route} route at {name}")
                check(torch.equal(gi, ri), f"ball query idx differs on the {route} route at {name}")
            times[route] = cuda_ms(lambda: ball_query_multi(radii, ns, pts, q, dilated=dilated), 20)
    route = grouping.ball_query_route(pts.shape[1])
    b, m = q.shape[:2]
    pairs = ball_query_ring_pairs(specs, pts, q)
    # bytes: points and queries read once, idx and cnt written once; operations:
    # per pair inside the outer ring, d2 (3 sub, 3 mul, 2 add) and a test a ring
    out = dict(shape=f"{name} {list(q.shape)} x {list(pts.shape)}", route=route,
               ms=times[route], times=times, ring_pairs=pairs,
               **bound(4 * (pts.numel() + q.numel() + b * m * (sum(ns) + len(ns))),
                       pairs * (8 + len(ns))))
    if plain:
        out["plain_ms"] = cuda_ms(lambda: ball_query_multi_plain(specs, pts, q),
                                  3 if pts.shape[1] >= 4096 else 20)
    fill = [f"{float(c.float().mean()):.1f}" for _, c in ref]
    log(f"K3 ball query {out['shape']} rings {list(radii)} ns {list(ns)}: idx and cnt equal on "
        f"both routes (mean cnt {fill}); grid {times['grid']:.4f} ms, brute force "
        f"{times['brute']:.4f} ms ({times['brute'] / times['grid']:.2f}x); takes the {route} "
        f"route" + (f"; plain {out['plain_ms']:.3f} ms" if plain else "")
        + f"; {pairs} pairs inside the outer ring, bound {out['bound_ms']:.4f} ms "
          f"({out['bound_by']})")
    return out


# K1 past the 16,384 points the whole-cloud routes hold: nuScenes' SA1 at the
# reference bench's 65,536 points a scan, and clouds that reach each tier of
# the slice route (ops/sampling.dfps_slice_plan)
K1_BIG_SHAPES = ((1, 65536, 4096), (2, 65536, 16384), (32, 32768, 1024), (1, 262144, 1024),
                 (1, 524288, 256))


def fps_past_whole_clouds(dev: torch.device, gen: torch.Generator) -> dict:
    """K1's slice route against the plain version at K1_BIG_SHAPES, picks
    equal, timed, with the tier each took; at [32, 32768] -> 1024 at every
    cluster size (those past residency run in waves; a size of 1 is one
    block a cloud reading its points from global memory)."""
    scene = synth.make_scene(np.random.default_rng(3), n_points=65536)[0][:65536, :3]
    out = {}
    for b, n, m in K1_BIG_SHAPES:
        if (b, n) == (1, 65536):
            pts = torch.from_numpy(np.ascontiguousarray(scene))[None].to(dev)
        else:
            pts = (torch.randn(b, n, 3, generator=gen) * 20).to(dev)
        route, size = fps_route(b, n), sampling.dfps_slice_size(b, n)
        tier = sampling.dfps_slice_plan(n, size)["tier"]
        plain = fps_plain(pts, m)
        check(route == "slice", f"D-FPS at {[b, n]} takes the {route} route")
        got = farthest_point_sample(pts, m)
        check(torch.equal(got, plain), f"D-FPS slice route disagrees with plain at {[b, n]} -> {m}")
        name = f"{[b, n, 3]} -> {m}"
        out[name] = dict(size=size, tier=tier, ms=cuda_ms(lambda: farthest_point_sample(pts, m), 3))
        if (b, n) == (32, 32768):
            sizes = {}
            for s in sampling.DFPS_SLICE_SIZES:
                with mock.patch.object(sampling, "dfps_slice_size", lambda b_, n_, s=s: s):
                    check(torch.equal(farthest_point_sample(pts, m), plain),
                          f"D-FPS slice route over clusters of {s} disagrees with plain at {name}")
                    sizes[s] = dict(tier=sampling.dfps_slice_plan(n, s)["tier"],
                                    resident=_build.dfps_slice_clusters(n, s),
                                    ms=cuda_ms(lambda: farthest_point_sample(pts, m), 3))
            out[name]["by_size"] = sizes
        log(f"K1 D-FPS {name}: picks equal to plain on the slice route, clusters of {size}, "
            f"{tier} tier, {out[name]['ms']:.3f} ms"
            + ("; by cluster size: " + ", ".join(
                f"{s} ({e['tier']}, {e['resident']} resident) {e['ms']:.3f} ms"
                for s, e in out[name]["by_size"].items()) if "by_size" in out[name] else ""))
    return out


def phase_kernels(scans: torch.Tensor) -> list[dict]:
    log(f"== phase 2: kernels against their plain versions (batch {BATCH})")
    dev = scans.device
    gen = torch.Generator().manual_seed(1)
    xyz = scans[..., :3].contiguous()
    report = []

    # K1: D-FPS on both routes at every D-FPS shape of the three paths
    # (3DSSD inference and training share theirs), on points of these scans
    # (3DSSD, the RPN) and on RoI-sized gaussian clouds (the RCNN's 400)
    picks = farthest_point_sample(xyz, 4096)
    xyz1 = gather_points(xyz, picks)
    rois = torch.randn(400, 512, 3, generator=gen).to(dev) * torch.tensor([2.0, 0.8, 1.0], device=dev)
    big = torch.cat([xyz, xyz.flip(1)])  # 16 clouds: the RPN's SA1 at phase 8's batch 16
    fps_shapes = [("3DSSD SA1", xyz, 4096), ("3DSSD SA2", xyz1, 512),
                  ("3DSSD SA3", xyz1[:, 512:1024].contiguous(), 256),
                  ("RPN SA1", xyz[:4].contiguous(), 4096), ("RPN SA2", xyz1[:4].contiguous(), 1024),
                  ("RPN SA3", xyz1[:4, :1024].contiguous(), 256),
                  ("RPN SA4", xyz1[:4, :256].contiguous(), 64), ("RPN SA1 batch 16", big, 4096),
                  ("RCNN SA1", rois, 128), ("RCNN SA2", rois[:, :128].contiguous(), 32)]
    k1, k1_err = {}, 0
    for name, pts, m in fps_shapes:
        b, n = pts.shape[:2]
        plain = fps_plain(pts, m)
        times = {}
        for route in ("block", "cluster", "slice"):  # every route takes n <= 16,384
            with on_route(route):
                got = farthest_point_sample(pts, m)
                k1_err = max(k1_err, int((got - plain).abs().max()))
                check(torch.equal(got, plain), f"D-FPS {route} route disagrees with plain at {name}")
                times[route] = cuda_ms(lambda: farthest_point_sample(pts, m),
                                       5 if m >= 4096 else 20)
        size = _build.dfps_cluster_size(b, n)
        route = fps_route(b, n)
        k1[name] = dict(shape=f"{list(pts.shape)} -> {m}", block_ms=times["block"],
                        cluster_ms=times["cluster"], slice_ms=times["slice"], cluster_size=size,
                        route=route)
        log(f"K1 D-FPS {name} {list(pts.shape)} -> {m}: picks equal on all three routes; one "
            f"block a cloud {times['block']:.3f} ms, a cluster of {size} a cloud "
            f"{times['cluster']:.3f} ms ({times['block'] / times['cluster']:.2f}x), slices over "
            f"clusters of {sampling.dfps_slice_size(b, n)} {times['slice']:.3f} ms; takes the "
            f"{route} route")
    sa1 = k1["3DSSD SA1"]
    ms = sa1[f"{sa1['route']}_ms"]
    plain_ms = cuda_ms(lambda: fps_plain(xyz, 4096), 3)
    rpn_plain_ms = cuda_ms(lambda: fps_plain(xyz[:4].contiguous(), 4096), 3)
    k1["RPN SA1"]["plain_ms"] = rpn_plain_ms
    log(f"K1 D-FPS at 3DSSD SA1: {ms:.3f} ms on its route vs plain {plain_ms:.3f} ms; the cluster "
        f"route is {sa1['block_ms'] / sa1['cluster_ms']:.2f}x the one-block route's speed; plain "
        f"at RPN SA1 {rpn_plain_ms:.3f} ms")
    k1_big = fps_past_whole_clouds(dev, gen)
    b, n = xyz.shape[:2]
    # per pick and point: 3 sub, 3 mul, 2 add, a min and a compare
    report.append(dict(name="fps", route="cuda", source="ssd3d_torch/csrc/fps.cu",
                       replaces="ssd3d/ops/pallas/fps.py:126", launches=0,
                       max_abs_err=float(k1_err), ms=ms, plain_ms=plain_ms,
                       **bound(4 * (b * n * 3 + b * 4096), b * 4095 * n * 10),
                       library_ms=None, shape=sa1["shape"], routes=k1, past_16384=k1_big,
                       check="equal"))

    # K2: F-FPS at SA2 (4,096 x 67 -> 512) and SA3 (512 x 131 -> 256), at
    # SA2's shape over 1, 2 and 16 clouds, and at shapes past what the first
    # two routes take (a full scan with SA1's 64 features; 131 channels over
    # two scans; nuScenes' 65,536 points of xyz and intensity), on every
    # route the shape admits
    feat16 = torch.randn(16, 4096, 64, generator=gen).to(dev).relu()
    sa2 = torch.cat([torch.cat([xyz1, xyz1.flip(0)]), feat16], -1)  # [16, 4096, 67]
    sa3 = torch.cat([xyz1[:, :512], torch.randn(BATCH, 512, 128, generator=gen).to(dev).relu()],
                    -1)
    scan_sa1 = torch.cat([xyz[:1], torch.randn(1, N_POINTS, 64, generator=gen).to(dev).relu()], -1)
    scans_131 = torch.cat([xyz[:2], torch.randn(2, N_POINTS, 128, generator=gen).to(dev).relu()],
                          -1)
    scene = synth.make_scene(np.random.default_rng(4), n_points=65536)[0][:65536]
    k2_shapes = [("SA2", sa2[:BATCH].contiguous(), 512), ("SA3", sa3, 256),
                 ("SA2 batch 1", sa2[:1].contiguous(), 512),
                 ("SA2 batch 2", sa2[:2].contiguous(), 512), ("SA2 batch 16", sa2, 512),
                 ("full scan, 64 features", scan_sa1, 512), ("two scans, 128 features", scans_131, 256),
                 ("nuScenes scan", torch.from_numpy(np.ascontiguousarray(scene))[None].to(dev), 4096)]
    k2, worst = {}, 0.0
    for name, fused, m in k2_shapes:
        b, n, c = fused.shape
        plain = ffps_plain(fused, m)
        size = sampling.ffps_cluster_size(b, n, c)
        routes = [r for r, ok in (("cluster", size), ("block", sampling.ffps_block_fits(n, c)),
                                  ("stream", True)) if ok]
        iters = 5 if n * m <= 4096 * 512 else 3
        times = {}
        for route in routes:
            with on_ffps_route(route):
                got = farthest_point_sample_features(fused, m)
                check(torch.equal(got, plain), f"F-FPS {route} route disagrees with plain at {name}")
                times[route] = cuda_ms(lambda: farthest_point_sample_features(fused, m), iters)
        route = sampling.ffps_route(b, n, c)
        short = fps_pick_shortfall(fused, farthest_point_sample_features(fused, m))
        check(short <= FFPS_TIE_RTOL, f"F-FPS pick {short:.3g} below the farthest point at {name}")
        worst = max(worst, short)
        # the cluster route at each size that fits (sizes past residency run in waves)
        sizes = {}
        for s in ((16, 8, 4, 2) if size else ()):
            if sampling.ffps_cluster_fits(n, c, s):
                with on_ffps_route("cluster"), mock.patch.object(
                        sampling, "ffps_cluster_size", lambda b_, n_, c_, s=s: s):
                    check(torch.equal(farthest_point_sample_features(fused, m), plain),
                          f"F-FPS cluster route of size {s} disagrees with plain at {name}")
                    sizes[s] = cuda_ms(lambda: farthest_point_sample_features(fused, m), iters)
        chosen = times[route]
        # per pick, point and channel: sub, mul, add; per pick and point a min
        k2[name] = dict(shape=f"{list(fused.shape)} -> {m}", route=route, cluster_size=size,
                        ms=chosen, times=times, sizes=sizes,
                        **bound(4 * (b * n * c + b * m), b * (m - 1) * n * (3 * c + 2)))
        log(f"K2 F-FPS {name} {list(fused.shape)} -> {m}: picks equal to plain on "
            f"{', '.join(times)}; worst relative shortfall {short:.3g}; "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
            + (f"; cluster of {size}" if size else "; no cluster size fits and stays resident")
            + (f"; by cluster size: " + ", ".join(f"{k} {v:.3f} ms" for k, v in sizes.items())
               if sizes else "")
            + f"; takes the {route} route, bound {k2[name]['bound_ms']:.4f} ms "
              f"({k2[name]['bound_by']})")
    plain_ms = {name: cuda_ms(lambda: ffps_plain(fused, m), 3)
                for name, fused, m in k2_shapes[:2]}
    log(f"K2 plain at SA2 / SA3: {plain_ms['SA2']:.3f} / {plain_ms['SA3']:.3f} ms")
    report.append(dict(name="ffps", route="cuda", source="ssd3d_torch/csrc/ffps.cu",
                       replaces="ssd3d/ops/pallas/fps.py:310", launches=0, max_abs_err=0.0,
                       ms=k2["SA2"]["ms"], plain_ms=plain_ms["SA2"],
                       bound_ms=k2["SA2"]["bound_ms"], bound_by=k2["SA2"]["bound_by"],
                       library_ms=None, shape=k2["SA2"]["shape"], routes=k2,
                       sa3_plain_ms=plain_ms["SA3"], worst_relative_shortfall=worst,
                       check="picks equal to plain on every route; tie-aware shortfall"))

    # K3: ball query at all four SA layers' shapes, on both routes
    cg_pts = xyz1[:, :512].contiguous()
    cg_q = (cg_pts[:, :256] + torch.randn(BATCH, 256, 3, generator=gen).to(dev)).contiguous()
    k3_shapes = [
        ("SA1", xyz, xyz1, [0.2, 0.4, 0.8], [32, 32, 64], True),
        ("SA2", xyz1, xyz1[:, :1024].contiguous(), [0.4, 0.8, 1.6], [32, 32, 64], True),
        ("SA3", xyz1[:, :1024].contiguous(), xyz1[:, :512].contiguous(),
         [1.6, 3.2, 4.8], [32, 32, 32], True),
        ("CG-SA", cg_pts, cg_q, [4.8, 6.4], [16, 32], False),
    ]
    k3, idx_sa = {}, {}
    for name, pts, q, radii, ns, dilated in k3_shapes:
        k3[name] = ball_query_routes(name, pts, q, radii, ns, dilated)
        idx_sa[name] = ball_query_multi(radii, ns, pts, q, dilated=dilated)[-1][0]
    sa1 = k3["SA1"]
    report.append(dict(name="ball_query", route="cuda", source="ssd3d_torch/csrc/ball_query.cu",
                       replaces="ssd3d/ops/pallas/ring_words.py:144", launches=0,
                       max_abs_err=0.0, ms=sa1["ms"], plain_ms=sa1["plain_ms"],
                       bound_ms=sa1["bound_ms"], bound_by=sa1["bound_by"], library_ms=None,
                       shape=sa1["shape"], routes=k3, check="idx and cnt equal on both routes"))

    # K4: the grouping gather at c = 4, 67, 131, 259 with each layer's index
    k4 = [(scans, idx_sa["SA1"]), (torch.randn(BATCH, 4096, 67, generator=gen).to(dev),
                                   idx_sa["SA2"]),
          (torch.randn(BATCH, 1024, 131, generator=gen).to(dev), idx_sa["SA3"]),
          (torch.randn(BATCH, 512, 259, generator=gen).to(dev), idx_sa["CG-SA"])]
    k4_times = []
    for src, idx in k4:
        flat = idx.reshape(BATCH, -1).contiguous()
        got = gather_rows(src, flat)
        ref = gather_rows_plain(src, flat)
        check(torch.equal(got.view(torch.int32), ref.view(torch.int32)), "gather not bit-identical")
        ms = cuda_ms(lambda: gather_rows(src, flat), 20)
        plain_ms = cuda_ms(lambda: gather_rows_plain(src, flat), 20)
        wide = flat.long()[..., None].expand(-1, -1, src.shape[2])  # torch.gather's own index
        lib_ms = cuda_ms(lambda: src.gather(1, wide), 20)
        rows, c = flat.shape[1], src.shape[2]
        k4_times.append((ms, plain_ms, f"{list(src.shape)} x {rows} rows", lib_ms,
                         bound(4 * (BATCH * min(rows, src.shape[1]) * c + BATCH * rows
                                    + BATCH * rows * c), 0)))
        log(f"K4 gather {list(src.shape)} x {rows} rows: bit-identical; {ms:.4f} ms vs plain "
            f"{plain_ms:.4f} ms, torch.gather {lib_ms:.4f} ms (K4 / torch.gather "
            f"{ms / lib_ms:.2f}), bound {k4_times[-1][4]['bound_ms']:.4f} ms")
    report.append(dict(name="gather", route="cuda", source="ssd3d_torch/csrc/gather.cu",
                       replaces="ssd3d/ops/pallas/gather.py:57", launches=0, max_abs_err=0.0,
                       ms=k4_times[0][0], plain_ms=k4_times[0][1], **k4_times[0][4],
                       library_ms=k4_times[0][3], shape=k4_times[0][2],
                       other_shapes={e[2]: dict(ms=e[0], plain_ms=e[1], library_ms=e[3],
                                                bound_ms=e[4]["bound_ms"]) for e in k4_times[1:]},
                       check="bit-identical"))

    # K5: the gather's backward at each layer's largest backward shape, on
    # that layer's last (largest) ring from the ball query above, and at the
    # four shapes of tests/test_torch_ops.py (phase 5 adds the train step's 8)
    k5 = [k5_check(f"{name} {BATCH * idx_sa[name].reshape(BATCH, -1).shape[1]} x {c} into {n}",
                   idx_sa[name].reshape(BATCH, -1).contiguous(),
                   torch.randn(BATCH, idx_sa[name].reshape(BATCH, -1).shape[1], c,
                               generator=gen).to(dev), n)
          for name, n, c in (("SA2", 4096, 67), ("SA3", 1024, 131), ("CG-SA", 512, 259))]
    rng = np.random.RandomState(19)
    for n, c, rows in ((4096, 67, 65536), (1024, 131, 16384), (512, 259, 8192), (7, 5, 1000)):
        idx = rng.randint(-2, n + 2, size=(2, rows)).astype(np.int32)  # clamped ends
        idx[:, 1::4] = idx[:, ::4][:, :idx[:, 1::4].shape[1]]  # duplicates
        g = rng.randn(2, rows, c) * 10.0 ** rng.uniform(-3, 3, size=(2, rows, 1))
        k5.append(k5_check(f"test {2 * rows} x {c} into {n}", torch.from_numpy(idx).to(dev),
                           torch.from_numpy(g.astype(np.float32)).to(dev), n, timed=False))
    report.append(dict(name="scatter_add", route="cuda", source="ssd3d_torch/csrc/scatter_add.cu",
                       replaces="ssd3d/ops/pallas/scatter_add.py:68", launches=0,
                       max_abs_err=0.0, ms=k5[0]["ms"], plain_ms=k5[0]["plain_ms"],
                       bound_ms=k5[0]["bound_ms"], bound_by=k5[0]["bound_by"],
                       library_ms=k5[0]["library_ms"], shape=k5[0]["shape"],
                       other_shapes={e["shape"]: e for e in k5[1:3]},
                       check="bit for bit the CPU plain version (index_add_), and two launches "
                             "bit for bit each other"))
    return report


def k5_check(shape: str, idx: torch.Tensor, g: torch.Tensor, n: int, timed: bool = True) -> dict:
    """K5 at one shape: bit for bit the CPU plain version (index_add_, which
    adds each destination's rows in ascending order, as K5 does), and two
    launches bit for bit each other; with `timed`, K5's, the plain version's
    (on the card) and torch.index_add's times, and the bound."""
    b, rows, c = g.shape
    got, again = scatter_add_rows(idx, g, n), scatter_add_rows(idx, g, n)
    ref = scatter_add_rows_plain(idx.cpu(), g.cpu(), n)
    check(torch.equal(got.cpu(), ref), f"K5 at {shape} is not bit for bit the CPU plain version "
          f"(max |K5 - plain| {float((got.cpu() - ref).abs().max()):.3g})")
    check(torch.equal(got, again), f"two K5 launches at {shape} differ")
    out = dict(shape=shape)
    if timed:
        out["ms"] = cuda_ms(lambda: scatter_add_rows(idx, g, n), 20)
        out["plain_ms"] = cuda_ms(lambda: scatter_add_rows_plain(idx, g, n), 20)
        flat = (idx.long().clamp(0, n - 1) + n * torch.arange(b, device=g.device)[:, None]).reshape(-1)
        zero, g_flat = torch.zeros(b * n, c, device=g.device), g.reshape(-1, c)
        out["library_ms"] = cuda_ms(lambda: torch.index_add(zero, 0, flat, g_flat), 20)
        # bytes: g, idx and dsrc once; operations: one add an element of g
        out.update(bound(4 * (b * rows * c + b * rows + b * n * c), b * rows * c))
    log(f"K5 scatter-add {shape}: bit for bit the CPU plain version, two launches equal"
        + (f"; {out['ms']:.4f} ms vs plain {out['plain_ms']:.4f} ms, torch.index_add "
           f"{out['library_ms']:.4f} ms (K5 / index_add {out['ms'] / out['library_ms']:.2f}), "
           f"bound {out['bound_ms']:.4f} ms" if timed else ""))
    return out


# ----------------------------------------------------------------- phase 3

def phase_main_path(scans: torch.Tensor) -> dict:
    log(f"== phase 3: flagship 3DSSD inference, batch {BATCH}, {N_POINTS} points, bf16")
    _, model, spec, _ = flagship(device="cuda", seed=0)

    def infer(points):
        with torch.inference_mode():
            return spec.decode_and_nms(model(points))

    _build.reset_launches()
    det = infer(scans)
    torch.cuda.synchronize()
    launches = _build.launches()
    log(f"kernel launches in one forward + decode + NMS: {launches}")
    check(all(launches[k] > 0 for k in ("fps", "ffps", "ball_query", "gather")),
          f"a kernel was not launched: {launches}")
    check(launches["scatter_add"] == 0, "inference launched the gather's backward")
    check(launches["three_nn"] == 0 and launches["sa_fused"] == 0,
          "3DSSD launched a PointRCNN kernel")
    # K1, K2, K3 on the route each call's shape takes
    launches["routes"] = check_routes("3DSSD inference", "3DSSD")
    valid = det["valid"]
    check(det["boxes"].shape == (BATCH, 100, 7) and valid.shape == (BATCH, 100),
          f"detections have shape {tuple(det['boxes'].shape)}")
    check(bool(torch.isfinite(det["boxes"]).all() and torch.isfinite(det["scores"]).all()),
          "non-finite boxes or scores")
    check(bool((valid.sum(-1) <= 100).all() and valid.any()),
          "a scan has more than 100 boxes, or no scan has any")
    log(f"valid boxes per scan: {valid.sum(-1).tolist()}")

    iters = 10
    infer(scans)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()  # the peak of inference, not of phase 2's plain versions
    t0 = time.perf_counter()
    for _ in range(iters):
        infer(scans)
    torch.cuda.synchronize()
    scans_per_s = BATCH * iters / (time.perf_counter() - t0)
    one = scans[:1].contiguous()
    lat = []
    for _ in range(iters + 1):
        t0 = time.perf_counter()
        infer(one)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    log(f"throughput at batch {BATCH}: {scans_per_s:.2f} scans/s; "
        f"batch-1 latency median {statistics.median(lat[1:]):.2f} ms; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    profile_once(lambda: infer(scans), f"batch of {BATCH}", each="fps|ball_query|grid_build")
    # K1's one-block route (the first design) against the cluster route, in
    # turns: scans/s of `iters` batches each, then one profiled batch
    rates = []
    for route in ("block", "cluster", "cluster", "block"):
        with on_route(route):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                infer(scans)
            torch.cuda.synchronize()
            rates.append(f"{route} {BATCH * iters / (time.perf_counter() - t0):.2f}")
    log(f"scans/s at batch {BATCH} with K1 on each route, in turns: {', '.join(rates)}")
    with on_route("block"):
        profile_once(lambda: infer(scans), f"batch of {BATCH}, K1 on the one-block route", top=0,
                     each="dfps")
    # K2 and K3 on their first designs (one block a cloud; a scan of every point)
    # against their chosen routes, in turns, then one profiled batch
    rates = []
    for old in (True, False, False, True):
        with on_first_routes() if old else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                infer(scans)
            torch.cuda.synchronize()
            rates.append(f"{'first routes' if old else 'chosen routes'} "
                         f"{BATCH * iters / (time.perf_counter() - t0):.2f}")
    log(f"scans/s at batch {BATCH} with K2 and K3 on their first routes and on their chosen routes, "
        f"in turns: {', '.join(rates)}")
    with on_first_routes():
        profile_once(lambda: infer(scans), f"batch of {BATCH}, K2 and K3 on their first routes",
                     top=6, each="ffps|ball_query")
    return launches


def profile_once(fn, what: str, top: int = 12, each: str | None = None) -> tuple[float, float]:
    """Where the device time of one call goes (torch.profiler): wall, device
    busy share and the `top` kernels that take most of it; with `each` (a
    regular expression), also every launch of the kernels whose name it
    matches, in launch order.
    -> (wall ms, device busy ms) under the profiler.

    The trace has lost a call's first launches when the call came first
    under a profiler started late in a long process (phase 8 lost its first
    D-FPS launch, 2.4 ms, even after a fill kernel and a pause), so fn runs
    twice under the profiler, with a spin kernel between, and the second
    call's kernels are read: those that start after the spin kernel ends."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        fn()
        torch.cuda._sleep(100_000)  # the marker
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # a user annotation (the optimizer's step) spans kernels already counted
    device = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)),
                    key=lambda e: e.time_range.start)
    spin = [e for e in device if "spin_kernel" in e.name]
    check(len(spin) == 1, f"the profile of {what} holds {len(spin)} marker kernels")
    device = [e for e in device if e.time_range.start >= spin[0].time_range.end]
    by_name: dict[str, list[float]] = {}
    for e in device:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    busy_us = sum(sum(t) for t in by_name.values())
    log(f"profiled {what}: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}%), "
        f"{len(device)} kernel launches of {len(by_name)} names")
    for name, t in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:top]:
        log(f"  {sum(t) / 1e3:8.3f} ms  x{len(t):<5d} {name[:90]}")
    if each:
        launches = [e for e in device if re.search(each, e.name)]
        log(f"  each {each} launch in order ({len(launches)} in the trace): " + "; ".join(
            f"{re.sub(r'^.*::|[(].*$', '', e.name)} {e.time_range.elapsed_us() / 1e3:.3f} ms"
            for e in launches))
    return wall_us / 1e3, busy_us / 1e3


def linear_fit(xs, ys) -> tuple[float, float]:
    """Least-squares y = fixed + per_x * x -> (fixed, per_x)."""
    mx, my = statistics.fmean(xs), statistics.fmean(ys)
    per_x = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
             / sum((x - mx) ** 2 for x in xs))
    return my - per_x * mx, per_x


# ----------------------------------------------------------------- phase 4

def _run(model, spec, points):
    with torch.inference_mode():
        net = model.backbone(points)
        out = model.predict(net)
        return net, out, spec.decode(out), spec.decode_and_nms(out)


def _close(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> None:
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    log(f"  {name}: max |card - CPU| {err:.3g} (limit {tol:.3g} x {scale:.3g})")
    check(err <= tol * scale, f"{name} differ by {err:.3g}")


def compare_with_cpu(scan: torch.Tensor, dtype: str, state_dict: dict | None = None,
                     bf16_tol: float = BF16_TOL) -> bool:
    """Kernel path on the card against the plain path on the CPU for one
    scan, with seeded weights or those of `state_dict`. Continuous values
    are held to the tolerance (F32_TOL, or `bf16_tol` at bf16) wherever the
    two runs took the same discrete decisions (sampling picks, heading bins,
    NMS keeps); returns whether they took every one of them alike."""
    cfg, gmodel, gspec, _ = flagship(device="cuda", seed=0, compute_dtype=dtype)
    if state_dict is not None:
        gmodel.load_state_dict(state_dict)
    cmodel = copy.deepcopy(gmodel).cpu()
    gnet, gout, gcand, gdet = _run(gmodel, gspec, scan)
    cnet, cout, ccand, cdet = _run(cmodel, gspec, scan.cpu())
    arch = cfg.MODEL.NETWORK.FIRST_STAGE.ARCHITECTURE

    check(torch.equal(gnet["fps_idx"][1].cpu(), cnet["fps_idx"][1]), "SA1 D-FPS picks differ")
    picks_equal = True
    for layer, row in enumerate(arch, start=1):
        if row[11] != "SA_Layer":
            continue
        src = row[0][0]
        segments = ffps_segments(gnet["xyz"][src], gnet["features"][src],
                                 gnet["fps_idx"][layer], row[6], row[7], row[8])
        for fused, picks in segments:
            short = fps_pick_shortfall(fused, picks)
            check(short <= FFPS_TIE_RTOL, f"layer {layer}: F-FPS pick short by {short:.3g}")
        same = torch.equal(gnet["fps_idx"][layer].cpu(), cnet["fps_idx"][layer])
        picks_equal &= same
        if row[2] and row[2] != -1:
            # the ball query of this layer on the CPU run's own inputs, on both devices
            xyz_in, new_xyz = cnet["xyz"][src], cnet["xyz"][layer]
            on_cpu = ball_query_multi(row[2], row[3], xyz_in, new_xyz, dilated=row[13])
            on_gpu = ball_query_multi(row[2], row[3], xyz_in.cuda(), new_xyz.cuda(),
                                      dilated=row[13])
            for (gi, gc), (ci, cc) in zip(on_gpu, on_cpu):
                check(torch.equal(gc.cpu(), cc) and torch.equal(gi.cpu(), ci),
                      f"layer {layer}: ball query differs between card and CPU")
        log(f"  {dtype} layer {layer} ({row[12]}): picks {'equal' if same else 'DIFFER'} "
            f"on card and CPU; {len(segments)} F-FPS segment(s) pass the tie-aware check"
            + ("; ball query idx/cnt equal on the CPU run's inputs" if row[2] else ""))
    if not picks_equal:
        return False
    tol = F32_TOL if dtype == "float32" else bf16_tol
    for key in ("cls", "offset", "angle_cls", "angle_res"):
        _close(f"{dtype} head {key}", gout[key].float().cpu(), cout[key].float(), tol)
    # a heading bin is an argmax: where two logits lie within the tolerance
    # the bins may differ, and the decoded heading then by a whole bin
    flipped = gout["angle_cls"].argmax(-1).cpu() != cout["angle_cls"].argmax(-1)
    _close(f"{dtype} candidate box centres and sizes", gcand[0][..., :6].cpu(),
           ccand[0][..., :6], tol)
    _close(f"{dtype} candidate headings ({int(flipped.sum())} bins at a near-tie left out)",
           gcand[0][..., 6].cpu()[~flipped], ccand[0][..., 6][~flipped], tol)
    _close(f"{dtype} candidate scores", gcand[1].cpu(), ccand[1], tol)
    # the kept detections, matched by the candidate (point) each came from
    keep = [{int(i): k for k, i in enumerate(d["index"][0].tolist()) if d["valid"][0, k]}
            for d in (gdet, cdet)]
    both = sorted(set(keep[0]) & set(keep[1]))
    rows = [[kp[i] for i in both] for kp in keep]
    _close(f"{dtype} kept box centres and sizes", gdet["boxes"][0, rows[0], :6].cpu(),
           cdet["boxes"][0, rows[1], :6], tol)
    _close(f"{dtype} kept scores", gdet["scores"][0, rows[0]].cpu(),
           cdet["scores"][0, rows[1]], tol)
    one_side = len(keep[0]) + len(keep[1]) - 2 * len(both)
    log(f"  {dtype}: {len(both)} detections kept on both, {one_side} on one side only")
    return one_side == 0 and not bool(flipped.any())


def phase_card_vs_cpu(scans: torch.Tensor) -> None:
    log("== phase 4: card against CPU, one scan, same weights")
    hold_card_to_cpu(scans[:1].contiguous())


def hold_card_to_cpu(scan: torch.Tensor, state_dict: dict | None = None,
                     bf16_tol: float = BF16_TOL) -> None:
    """Phase 4's comparison of one scan at bf16, and at f32 where a bf16
    near-tie went another way on the two devices."""
    if compare_with_cpu(scan, "bfloat16", state_dict, bf16_tol):
        return
    log("  at bf16 a near-tie (F-FPS distances, heading logits or NMS scores within "
        "a bf16 step) went another way on the card than on the CPU; comparing again "
        "with COMPUTE_DTYPE float32, where every decision must agree")
    check(compare_with_cpu(scan, "float32", state_dict),
          "float32: picks, bins or kept detections differ")


# ----------------------------------------------------------------- phase 5

LOSS_KEYS = ("cls", "offset", "angle", "corner", "vote")
# numbers one phase hands a later one (phase 5's step time to phase 10)
MEASURED: dict = {}


def phase_training(report: list[dict]) -> dict:
    """-> the launches of one step; K5's times at the step's 8 calls go into
    phase 2's entry of K5 in `report`."""
    log(f"== phase 5: flagship 3DSSD training, batch {BATCH}, {N_POINTS} points, bf16, Adam")
    step, batch = train_entry(device="cuda", seed=0, batch=BATCH)
    state = step.args[0]
    stats = {k: v.clone() for k, v in state.model.named_buffers()
             if k.endswith((".mean", ".var"))}
    _build.reset_launches()
    first = step(batch)  # the warm-up step
    torch.cuda.synchronize()
    launches = _build.launches()
    log(f"kernel launches in one train step: {launches}")
    check(all(launches[k] > 0 for k in ("fps", "ffps", "ball_query", "gather", "scatter_add")),
          f"a kernel was not launched: {launches}")
    check(launches["three_nn"] == 0 and launches["sa_fused"] == 0,
          "3DSSD training launched a PointRCNN kernel")
    check(launches["scatter_add"] == 8, "the gather's backward did not run once per "
          "gradient-carrying grouping gather (3 + 3 + 2)")
    launches["routes"] = check_routes("3DSSD training", "3DSSD")
    torch.cuda.reset_peak_memory_stats()
    metrics, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics.append(step(batch))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for m in [first] + metrics:
        check(set(LOSS_KEYS) <= set(m), f"a loss is missing: {sorted(m)}")
        check(all(np.isfinite(float(m[k])) for k in LOSS_KEYS + ("total",)),
              f"a loss is not finite: {m}")
    totals = [float(m["total"]) for m in [first] + metrics]
    log("total loss by step: " + ", ".join(f"{t:.3f}" for t in totals))
    log("last step: " + ", ".join(f"{k} {float(v):.4f}" for k, v in metrics[-1].items()))
    check(totals[-1] < totals[0], f"the total loss did not fall: {totals[0]} -> {totals[-1]}")
    moved = sum(not torch.equal(v, stats[k]) for k, v in state.model.named_buffers() if k in stats)
    check(moved == len(stats), f"only {moved} of {len(stats)} BatchNorm statistics moved")
    check(state.step == TRAIN_STEPS + 1, f"step counter {state.step}")
    MEASURED["phase5_step_ms"] = statistics.median(times)
    log(f"train step at batch {BATCH}: median {statistics.median(times):.2f} ms "
        f"(min {min(times):.2f}, max {max(times):.2f}) over {TRAIN_STEPS} steps; "
        f"{BATCH * 1e3 / statistics.median(times):.2f} training scans/s; "
        f"peak memory {peak:.2f} GiB; {moved} BatchNorm statistics moved")
    profile_once(lambda: step(batch), f"train step at batch {BATCH}", top=16)
    # K5 at the step's 8 calls (the gather's backward), on their inputs,
    # recorded in one more step
    calls = []

    def recorded(idx, g, n):
        calls.append((idx.detach().clone(), g.detach().clone(), n))
        return scatter_add_rows(idx, g, n)

    with mock.patch.object(grouping, "scatter_add_rows", recorded):
        step(batch)
    check(len(calls) == 8, f"recorded {len(calls)} scatter-add calls in a train step")
    entry = next(e for e in report if e["name"] == "scatter_add")
    entry["train_step_shapes"] = [
        k5_check(f"train call {i}: {g.shape[0] * g.shape[1]} x {g.shape[2]} into {n}", idx, g, n)
        for i, (idx, g, n) in enumerate(calls)]
    return launches


# ----------------------------------------------------------------- phase 6

class DecisionReplay:
    """The card leg's discrete decisions, recorded and handed to the CPU leg.

    Three decisions of a train step compare computed values: a ReLU's sign,
    a max-pool's winner, and a ball query's members around a vote-shifted
    centre. Where such a value lies within rounding of the threshold, the
    legs decide differently, and the gradient through that one decision
    moves by O(1): at full width a few hundred of ~1.5e8 ReLU signs, about
    ten max-pool winners and one CG-layer ball differ, and a single flipped
    ReLU moves a head leaf's gradient by 8% of its largest entry. So the CPU
    leg takes the card's decisions, and the comparison holds what is left,
    the arithmetic, to rounding. Every decision the CPU would have taken
    otherwise is counted, and must be a near-tie on the CPU's own values:
    within F32_TOL of the tensor's largest |value| of the threshold (ReLU,
    max-pool). A ball query the legs ran on bit-identical inputs (SA1 to
    SA3: raw points and picks) must agree; the card's answer is also held
    against the plain version on the card's own inputs."""

    KINDS = ("relu", "max_pool", "ball_query")

    def __init__(self):
        self.recording = True  # the card leg; False for the CPU leg
        self.log = {k: [] for k in self.KINDS}
        self.pos = dict.fromkeys(self.KINDS, 0)
        self.differ = dict.fromkeys(self.KINDS, 0)  # decisions the CPU took otherwise
        self.total = dict.fromkeys(self.KINDS, 0)

    def _count(self, kind: str, differ: torch.Tensor) -> None:
        self.pos[kind] += 1
        self.differ[kind] += int(differ.sum())
        self.total[kind] += differ.numel()

    def patches(self):
        return (mock.patch.object(torch, "relu", self.relu),
                mock.patch.object(modules, "max_pool", self.max_pool),
                mock.patch.object(modules, "ball_query_multi", self.ball_query))

    def relu(self, x):
        if self.recording:
            self.log["relu"].append((x > 0).cpu())
            return _relu(x)
        card = self.log["relu"][self.pos["relu"]]
        flipped = card != (x > 0)
        self._count("relu", flipped)
        if flipped.any():
            check(float(x.detach()[flipped].abs().max()) <= F32_TOL * float(x.detach().abs().max()),
                  "a ReLU sign differs between card and CPU away from 0")
        return torch.where(card, x, x.new_zeros(()))

    def max_pool(self, grouped):
        out = _max_pool(grouped)
        if self.recording:
            self.log["max_pool"].append((grouped == out[:, :, None]).cpu())
            return out
        card = self.log["max_pool"][self.pos["max_pool"]]
        self._count("max_pool", (card != (grouped == out[:, :, None])).any(2))
        at_card = grouped.masked_fill(~card, float("-inf")).amax(2)
        check(float((out - at_card).detach().abs().max())
              <= F32_TOL * float(grouped.detach().abs().max()),
              "a max-pool winner differs between card and CPU away from a tie")
        # the card's winners, the gradient split among them as amax splits it
        w = card.to(grouped.dtype)
        return (grouped * w).sum(2) / w.sum(2)

    def ball_query(self, radius_list, nsample_list, xyz, new_xyz, dilated=False):
        own = ball_query_multi(radius_list, nsample_list, xyz, new_xyz, dilated=dilated)
        if self.recording:
            specs = ring_specs(radius_list, nsample_list, dilated)
            for (gi, gc), (pi, pc) in zip(own, ball_query_multi_plain(specs, xyz, new_xyz)):
                check(torch.equal(gi, pi) and torch.equal(gc, pc),
                      "ball query kernel differs from its plain version on the train step's inputs")
            self.log["ball_query"].append(
                (xyz.cpu(), new_xyz.cpu(), [(i.cpu(), c.cpu()) for i, c in own]))
            return own
        card_xyz, card_new_xyz, card = self.log["ball_query"][self.pos["ball_query"]]
        differ = torch.zeros(new_xyz.shape[:2], dtype=torch.bool)
        for (ci, cc), (oi, oc) in zip(card, own):
            differ |= (ci != oi).any(-1) | (cc != oc)
        self._count("ball_query", differ)
        if torch.equal(card_xyz, xyz) and torch.equal(card_new_xyz, new_xyz):
            check(not differ.any(), "ball query differs between card and CPU on equal inputs")
        return card


def _train_grads(model, spec, cfg, batch, replay: DecisionReplay):
    """One f32 loss + backward; -> (loss dict, outputs, grads, BN stats)."""
    outputs = {}
    hook = model.register_forward_hook(lambda mod, args, out: outputs.update(out))
    relu, pool, query = replay.patches()
    with relu, pool, query:
        total, losses = TrainGraph.build(cfg, model, spec).compute_losses(
            batch, bn_momentum(cfg.SOLVER, 0))
        total.backward()
    hook.remove()
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    stats = {k: v.detach().cpu() for k, v in model.named_buffers()
             if k.endswith((".mean", ".var"))}
    return {k: v.item() for k, v in losses.items()}, outputs, grads, stats


def phase_train_card_vs_cpu() -> None:
    n_scans = 2
    log(f"== phase 6: one f32 train step, card against CPU, {n_scans} scans of "
        f"{N_POINTS} points, same weights")
    cfg, gmodel, spec, n = flagship(device="cuda", seed=0, compute_dtype="float32")
    cmodel = copy.deepcopy(gmodel).cpu()
    gmodel2 = copy.deepcopy(gmodel)  # the same state, for a second card step
    data = {k: torch.from_numpy(v) for k, v in synthetic_scenes(n_scans, n).items()}
    gmodel.train()
    gmodel2.train()
    cmodel.train()
    replay = DecisionReplay()
    t0 = time.perf_counter()
    g_losses, g_out, g_grads, g_stats = _train_grads(
        gmodel, spec, cfg, {k: v.cuda() for k, v in data.items()}, replay)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    replay.recording = False
    c_losses, c_out, c_grads, c_stats = _train_grads(cmodel, spec, cfg, data, replay)
    log(f"  card {t1 - t0:.2f} s, CPU {time.perf_counter() - t1:.2f} s")
    check(all(replay.pos[k] == len(replay.log[k]) for k in replay.KINDS),
          f"the legs took different numbers of decisions: {replay.pos}")
    # reported, not held: K5 no longer varies from run to run, but cuBLAS and
    # the BatchNorm reductions are not bound to one order
    grads2 = _train_grads(gmodel2, spec, cfg, {k: v.cuda() for k, v in data.items()},
                          DecisionReplay())[2]
    same = [k for k, v in g_grads.items() if torch.equal(v, grads2[k])]
    log(f"  two card steps from the same state: {len(same)} of {len(g_grads)} gradient leaves "
        f"bit for bit equal" + ("" if len(same) == len(g_grads) else "; differ: " + ", ".join(
            k for k in g_grads if k not in same)[:400]))
    for layer, (gi, ci) in enumerate(zip(g_out["fps_idx"], c_out["fps_idx"])):
        if gi is not None:
            check(torch.equal(gi.cpu(), ci), f"layer {layer}: sampling picks differ between "
                  "card and CPU, so the comparison is void")
    log("  sampling picks equal on card and CPU at every layer; decisions the CPU would have "
        "taken otherwise, each a near-tie (the CPU leg takes the card's): "
        + ", ".join(f"{k} {replay.differ[k]} of {replay.total[k]}" for k in replay.KINDS))
    vote_err = float((g_out["vote_offset"][0].cpu() - c_out["vote_offset"][0]).detach().abs().max())
    log(f"  vote offsets (the CG layer's centres): max |card - CPU| {vote_err:.3g}")
    loss_err = {k: abs(g_losses[k] - c_losses[k]) / abs(c_losses[k]) for k in c_losses}
    log("  losses, card / CPU (relative difference): " + "; ".join(
        f"{k} {g_losses[k]:.6f} / {c_losses[k]:.6f} ({loss_err[k]:.2g})" for k in c_losses))
    grad_err = []
    for name, cg in c_grads.items():
        err = float((g_grads[name] - cg).abs().max())
        scale = cg
        if name.endswith("conv.bias") and name[:-9] + "bn.scale" in c_grads:
            # a Dense bias ahead of BatchNorm has a true gradient of 0 (the
            # batch mean takes it out): rounding on both sides, held against
            # the same layer's kernel gradient
            scale = c_grads[name[:-4] + "kernel"]
        grad_err.append((err / max(float(scale.abs().max()), 1e-30), name))
    grad_err.sort(reverse=True)
    log("  gradient leaves furthest apart (max |card - CPU| / max |CPU| of the leaf): "
        + "; ".join(f"{name} {r:.3g}" for r, name in grad_err[:6]))
    stats_err = sorted(((float((g_stats[k] - cs).abs().max()) / float(cs.abs().max()), k)
                        for k, cs in c_stats.items()), reverse=True)
    log("  running statistics furthest apart (relative to the buffer's largest |entry|): "
        + "; ".join(f"{name} {r:.3g}" for r, name in stats_err[:3]))
    for key, r in loss_err.items():
        check(r <= F32_TOL, f"loss {key} differs by {r:.3g} (relative)")
    for r, name in grad_err:
        check(r <= TRAIN_GRAD_TOL, f"gradient {name} differs by {r:.3g} of its max")
    for r, name in stats_err:
        check(r <= F32_TOL, f"running statistic {name} differs by {r:.3g} of its max")
    log(f"  {len(c_losses)} losses within {F32_TOL:g} relative, {len(c_grads)} gradient leaves "
        f"within {TRAIN_GRAD_TOL:g} of their largest entry, {len(c_stats)} running "
        f"statistics within {F32_TOL:g}")


# ----------------------------------------------------------------- phase 7

def capture_two_stage_inputs(forward, points: torch.Tensor, sa_layers) -> dict:
    """One PointRCNN forward, recording the inputs of every launch of the
    path's kernels: D-FPS (RPN SA1-SA4, RCNN SA1-SA2), ball query, row
    gather (RPN grouping; RegionPool's xyz, features and mask), three_nn
    (the four FP layers) and fused SA (RCNN SA1, SA2); and the inputs of the
    RCNN's SA modules `sa_layers`. Each kind's calls are held to its
    kernel's launches in that forward, so no launch goes unrecorded."""
    kinds = {"fps": (modules, "farthest_point_sample"),
             "ball_query": (modules, "ball_query_multi"),
             "gather": (grouping, "_gather_rows"),
             "three_nn": (modules, "three_nn"),
             "sa_fused": (sa_fused, "sa_fused_multi")}
    seen = {k: [] for k in list(kinds) + ["sa_module"]}

    def spy(kind, fn):
        def recorded(*args, **kwargs):
            seen[kind].append((args, kwargs))
            return fn(*args, **kwargs)
        return recorded

    patches = [mock.patch.object(mod, name, spy(kind, getattr(mod, name)))
               for kind, (mod, name) in kinds.items()]
    hooks = [layer.register_forward_pre_hook(
        lambda mod, args, kwargs: seen["sa_module"].append((mod, args, kwargs)), with_kwargs=True)
        for layer in sa_layers]
    _build.reset_launches()
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        forward(points)
    torch.cuda.synchronize()
    launches = _build.launches()
    for hook in hooks:
        hook.remove()
    for kind in kinds:
        check(len(seen[kind]) == launches[kind],
              f"{kind}: {len(seen[kind])} calls recorded, {launches[kind]} launches")
    return seen


def check_path_kernels(seen: dict) -> dict:
    """K1, K3 and K4 against their plain versions on the card, at every call
    of one PointRCNN forward (phase 2 holds them at 3DSSD's shapes); K1 and
    K3 on both routes. -> (K4's and torch.gather's times at RegionPool's
    gathers, the calls whose source has other widths than the RPN's; K3's
    times on both routes at each call)."""
    shapes = []
    for (xyz, npoint), _ in seen["fps"]:
        plain = fps_plain(xyz, npoint)
        for route in ("block", "cluster"):
            with on_route(route):
                check(torch.equal(farthest_point_sample(xyz, npoint), plain),
                      f"D-FPS {route} route disagrees with plain at {list(xyz.shape)} -> {npoint}")
        shapes.append(f"{list(xyz.shape)}->{npoint} ({fps_route(*xyz.shape[:2])})")
    log(f"K1 D-FPS at the path's {len(shapes)} calls, picks equal on both routes: "
        f"{', '.join(shapes)}")
    names = ["RPN SA1", "RPN SA2", "RPN SA3", "RPN SA4", "RCNN SA1", "RCNN SA2"]
    check(len(seen["ball_query"]) == len(names), f"{len(seen['ball_query'])} ball queries")
    k3 = {}
    for name, ((radii, ns, xyz, new_xyz), kwargs) in zip(names, seen["ball_query"]):
        k3[name] = ball_query_routes(name, xyz, new_xyz, radii, ns, kwargs.get("dilated", False),
                                     plain=False)
    shapes, pool = [], {}
    # the forward's last three gathers are RegionPool's: xyz, features, mask
    check([src.shape[2] for (src, _), _ in seen["gather"][-3:]] == [3, 128, 1],
          "RegionPool's gathers are not the forward's last three")
    for k, ((src, idx), _) in enumerate(seen["gather"]):
        got, ref = grouping._gather_rows(src, idx), gather_rows_plain(src, idx)
        check(got.dtype == ref.dtype and torch.equal(got.view(torch.int32), ref.view(torch.int32)),
              f"gather not bit-identical at {list(src.shape)} x {idx.shape[1]} rows")
        shape = f"{list(src.shape)} x {idx.shape[1]} rows"
        shapes.append(shape)
        if k >= len(seen["gather"]) - 3:
            wide = idx.long().clamp(0, src.shape[1] - 1)[..., None].expand(-1, -1, src.shape[2])
            b, rows, c = idx.shape[0], idx.shape[1], src.shape[2]
            pool[shape] = dict(ms=cuda_ms(lambda: grouping._gather_rows(src, idx), 20),
                               library_ms=cuda_ms(lambda: src.gather(1, wide), 20),
                               **bound(4 * (b * min(rows, src.shape[1]) * c + b * rows
                                            + b * rows * c), 0))
            log(f"K4 gather RegionPool {shape}: {pool[shape]['ms']:.4f} ms vs torch.gather "
                f"{pool[shape]['library_ms']:.4f} ms (K4 / torch.gather "
                f"{pool[shape]['ms'] / pool[shape]['library_ms']:.2f}), bound "
                f"{pool[shape]['bound_ms']:.4f} ms")
    log(f"K4 gather at the path's {len(shapes)} calls, bit-identical: {', '.join(shapes)}")
    return pool, k3


@torch.inference_mode()
def phase_two_stage_kernels(report: list[dict]) -> list[dict]:
    """-> the report's entries of K6 and K7; RegionPool's K4 times and the
    path's K3 times go into phase 2's entries of K4 and K3 in `report`."""
    log(f"== phase 7: PointRCNN's kernels against their plain versions, on the inputs "
        f"of one forward at batch {TWO_STAGE_BATCH}")
    _, model, rpn_spec, _, n = pointrcnn(device="cuda", seed=0)
    # the scans `two_stage_entry(seed=0, batch=TWO_STAGE_BATCH)` runs on
    points = torch.from_numpy(synthetic_scenes(TWO_STAGE_BATCH, n, seed=0)["points"]).cuda()
    layers = (model.rcnn_backbone.rcnn_layer1, model.rcnn_backbone.rcnn_layer2)
    seen = capture_two_stage_inputs(lambda p: model(p, rpn_spec), points, layers)
    check(len(seen["three_nn"]) == 4 and len(seen["sa_fused"]) == 2
          and len(seen["sa_module"]) == 2,
          f"captured {len(seen['three_nn'])} three_nn and {len(seen['sa_fused'])} fused-SA calls")
    pool, k3 = check_path_kernels(seen)
    next(e for e in report if e["name"] == "gather")["other_shapes"].update(pool)
    next(e for e in report if e["name"] == "ball_query")["routes"].update(k3)
    report = []

    # K6 at the four FP shapes, FP4 (256 x 64) to FP1 (16,384 x 4,096), with
    # the slices of the knowns `three_nn_slices` gives, and every other
    # slicing timed beside it; then on a tie-heavy input of each shape
    # (knowns on a lattice, each repeated a third of the cloud apart, so
    # equal distances cross slice borders) at every slicing
    k6, gen = [], torch.Generator().manual_seed(7)
    for (xyz1, xyz2), _ in seen["three_nn"]:
        b, n, m = xyz1.shape[0], xyz1.shape[1], xyz2.shape[1]
        chosen = interpolate.three_nn_slices(b, n, m)
        lattice = torch.randint(-3, 4, (b, -(-m // 3), 3), generator=gen).float()
        tied = (torch.randint(-6, 7, (b, n, 3), generator=gen).float() * 0.5,
                torch.cat([lattice, lattice.flip(1), lattice], 1)[:, :m])
        tied = tuple(t.to(xyz1.device).contiguous() for t in tied)
        wants = [((xyz1, xyz2), three_nn_plain(xyz1, xyz2)), (tied, three_nn_plain(*tied))]
        by_slices, ulps = {}, 0
        for sl in (1, 2, 4, 8):
            with mock.patch.object(interpolate, "three_nn_slices", lambda b_, n_, m_: sl):
                for inputs, (want_d, want_i) in wants:
                    got_d, got_i = three_nn(*inputs)
                    check(torch.equal(got_i, want_i),
                          f"three_nn indices differ at {list(inputs[0].shape)} over {sl} slices")
                    ulp = int((got_d.view(torch.int32) - want_d.view(torch.int32)).abs().max())
                    check(ulp <= 1, f"three_nn distances {ulp} ulp apart at "
                          f"{list(inputs[0].shape)} over {sl} slices")
                    ulps = max(ulps, ulp)
                by_slices[sl] = cuda_ms(lambda: three_nn(xyz1, xyz2), 20)
        ms = cuda_ms(lambda: three_nn(xyz1, xyz2), 20)
        plain_ms = cuda_ms(lambda: three_nn_plain(xyz1, xyz2), 3 if n >= 16384 else 20)
        # per pair: d2 (3 sub, 3 mul, 2 add) and one compare, none an FFMA
        k6.append(dict(ms=ms, plain_ms=plain_ms, ulps=ulps, shape=f"{n} x {m}", slices=chosen,
                       by_slices=by_slices,
                       **bound(4 * (b * n * 3 + b * m * 3 + 2 * b * n * 3), b * n * m * 9)))
        best = min(by_slices, key=by_slices.get)
        log(f"K6 three_nn {list(xyz1.shape)} x {list(xyz2.shape)}: indices equal, distances "
            f"{ulps} ulp apart at most over 1, 2, 4 and 8 slices, on the path's input and a "
            f"tie-heavy one; over {chosen} slice(s) (the plan): {ms:.4f} ms vs plain "
            f"{plain_ms:.3f} ms (bound {k6[-1]['bound_ms']:.4f} ms, "
            f"{100 * k6[-1]['bound_ms'] / ms:.0f}%); fastest over {best} slice(s), "
            f"{by_slices[best]:.4f} ms; by slices: "
            + ", ".join(f"{k} {v:.4f}" for k, v in by_slices.items()))
    fp1 = max(k6, key=lambda e: e["bound_ms"])
    report.append(dict(name="three_nn", route="cuda", source="ssd3d_torch/csrc/three_nn.cu",
                       replaces="ssd3d/ops/pallas/three_nn.py:90", launches=0,
                       max_abs_err=0.0, ms=fp1["ms"], plain_ms=fp1["plain_ms"],
                       bound_ms=fp1["bound_ms"], bound_by=fp1["bound_by"], library_ms=None,
                       shape=f"FP1 {fp1['shape']} (batch {TWO_STAGE_BATCH})",
                       slices=fp1["slices"],
                       other_shapes={e["shape"]: dict(ms=e["ms"], plain_ms=e["plain_ms"],
                                                      bound_ms=e["bound_ms"], slices=e["slices"],
                                                      by_slices=e["by_slices"]) for e in k6},
                       check="indices equal, distances within 1 ulp, over 1, 2, 4 and 8 "
                             "slices, on the path's inputs and on tie-heavy ones"))

    # K7 at the RCNN's SA1 and SA2, on the ball queries of the pooled RoIs,
    # on each of its routes; the yardstick is the same SA module's forward
    # with the fused route turned off (K4 gather, cuBLAS MLP, max-pool), on
    # the same inputs
    unfused_route = mock.patch.object(modules.PointnetSAModuleMSG, "_use_fused",
                                      lambda self, packed_src, queries: False)
    k7 = []
    for name, (args, _), (layer, l_args, l_kwargs) in zip(("SA1", "SA2"), seen["sa_fused"],
                                                           seen["sa_module"]):
        src, idx_list, centers, masks, layers_list, agg = args
        widths = [[w.shape[1] for w, *_ in lay] for lay in layers_list]
        route = sa_fused.sa_fused_route(src.shape[2], [i.shape[2] for i in idx_list], widths)
        want = sa_fused.sa_fused_multi_plain(*args)
        scale = float(want.abs().max())
        got, err, times = None, {}, {}
        for r in K7_ROUTES:
            with on_sa_route(r):
                out = sa_fused.sa_fused_multi(*args)
                err[r] = float((out - want).abs().max())
                check(err[r] <= K7_TOL * scale,
                      f"K7 on the {r} route at {name} differs from plain by {err[r]:.3g} of {scale:.3g}")
                times[r] = cuda_ms(lambda: sa_fused.sa_fused_multi(*args), 5)
            got = out if r == route else got
        fused_out = layer(*l_args, **l_kwargs)[1]
        with unfused_route:
            unfused_out = layer(*l_args, **l_kwargs)[1]
        err_unfused = float((fused_out - unfused_out).abs().max())
        check(torch.equal(fused_out, got), f"the {name} module's fused route is not K7's output")
        check(err_unfused <= K7_TOL * scale, f"K7 at {name} differs from the unfused route")
        plain_ms = cuda_ms(lambda: sa_fused.sa_fused_multi_plain(*args), 5)
        # the whole module (D-FPS, ball query, then either route) both ways
        module_ms = cuda_ms(lambda: layer(*l_args, **l_kwargs), 5)
        with unfused_route:
            unfused_ms = cuda_ms(lambda: layer(*l_args, **l_kwargs), 5)
        b, n, cp = src.shape
        m = centers.shape[1]
        flops = sum(2 * b * m * idx.shape[2] * sum(w.shape[0] * w.shape[1] for w, *_ in lay)
                    for idx, lay in zip(idx_list, layers_list))
        params = sum(t.numel() for lay in layers_list for layer_ in lay for t in layer_)
        n_bytes = 4 * (b * n * cp + sum(i.numel() for i in idx_list) + centers.numel()
                       + masks.numel() + params + got.numel())
        # the wgmma route does three TF32 products a multiply-add; the FMA
        # route one f32 FMA
        tc = bound(n_bytes, 3 * flops, H100_TF32_FLOP_PER_S)
        fma = bound(n_bytes, flops, H100_F32_FLOP_PER_S)
        k7.append(dict(name=name, route=route, ms=times[route], plain_ms=plain_ms,
                       route_ms=times, module_ms=[module_ms, unfused_ms], err=max(err.values()),
                       shape=f"{name} b {b}, n {n}, cp {cp}, m {m}, ns {idx_list[0].shape[2]}",
                       bound_fma_ms=fma["bound_ms"], **tc))
        log(f"K7 fused SA {k7[-1]['shape']}: takes the {route} route; max |K7 - plain| "
            + ", ".join(f"{r} {e:.3g}" for r, e in err.items())
            + f"; module output fused vs unfused route {err_unfused:.3g} (limit {K7_TOL:g} x "
            f"{scale:.3g}); K7 " + ", ".join(f"{r} {t:.3f} ms" for r, t in times.items())
            + f" vs plain {plain_ms:.3f} ms; bound {tc['bound_ms']:.3f} ms in 3xTF32 on the "
            f"tensor cores, {fma['bound_ms']:.3f} ms in f32 FMA ({flops / 1e9:.1f} GFLOP); the "
            f"SA module's forward {module_ms:.3f} ms fused, {unfused_ms:.3f} ms on the unfused "
            f"route")
    # where the fused route starts to win: SA1's module at 16, 64 and all
    # (400) of the forward's clouds
    (layer, l_args, l_kwargs), clouds = seen["sa_module"][0], {}
    fused_route = mock.patch.object(modules.PointnetSAModuleMSG, "_use_fused",
                                    lambda self, packed_src, queries: True)
    full = l_args[0].shape[0]
    for nb in (16, 64, full):
        sub = [a[:nb] if torch.is_tensor(a) and a.shape[:1] == (full,) else a for a in l_args]
        with fused_route:
            fused_ms = cuda_ms(lambda: layer(*sub, **l_kwargs), 5)
        with unfused_route:
            unfused_ms = cuda_ms(lambda: layer(*sub, **l_kwargs), 5)
        clouds[nb] = [fused_ms, unfused_ms]
        log(f"SA1 module at {nb} clouds: fused {fused_ms:.3f} ms, unfused {unfused_ms:.3f} ms "
            f"(fused / unfused {fused_ms / unfused_ms:.2f})")
    # K7 with one scale and no mask: the JAX package's sa_fused_pallas contract
    (src, idx_list, centers, _, layers_list, _), _ = seen["sa_fused"][1]
    single = sa_fused.sa_fused(src, idx_list[0], centers, layers_list[0])
    ones = torch.ones_like(centers[..., :1])
    want = sa_fused.sa_fused_multi_plain(src, idx_list, centers, ones, layers_list)
    err = float((single - want).abs().max())
    check(err <= K7_TOL * float(want.abs().max()), f"single-scale K7 differs by {err:.3g}")
    single_ms = cuda_ms(lambda: sa_fused.sa_fused(src, idx_list[0], centers, layers_list[0]), 5)
    single_plain_ms = cuda_ms(
        lambda: sa_fused.sa_fused_multi_plain(src, idx_list, centers, ones, layers_list), 5)
    log(f"K7 single scale, unmasked (R = 1) at SA2: max |K7 - plain| {err:.3g}; "
        f"{single_ms:.3f} ms vs plain {single_plain_ms:.3f} ms")
    sa1 = k7[0]
    report.append(dict(name="sa_fused", route="cuda", source="ssd3d_torch/csrc/sa_fused.cu",
                       replaces="ssd3d/ops/pallas/sa_fused.py:306", launches=0,
                       max_abs_err=max(e["err"] for e in k7), ms=sa1["ms"],
                       plain_ms=sa1["plain_ms"], bound_ms=sa1["bound_ms"],
                       bound_by=sa1["bound_by"], library_ms=None, shape=sa1["shape"],
                       bound_note="3xTF32 on the tensor cores (3 TF32 FLOP a f32 FLOP at "
                                  "495 TFLOP/s); bound_fma_ms: f32 FMA at 67 TFLOP/s",
                       bound_fma_ms=sa1["bound_fma_ms"], kernel_route=sa1["route"],
                       route_ms={e["name"]: e["route_ms"] for e in k7},
                       module_ms_fused_unfused={e["name"]: e["module_ms"] for e in k7},
                       sa1_module_ms_fused_unfused_by_clouds=clouds,
                       other_shapes={e["shape"]: dict(ms=e["ms"], plain_ms=e["plain_ms"],
                                                      bound_ms=e["bound_ms"],
                                                      bound_fma_ms=e["bound_fma_ms"])
                                     for e in k7[1:]},
                       single_scale_sa2_ms=[single_ms, single_plain_ms],
                       check=f"max |K7 - plain| <= {K7_TOL:g} x max |plain| on every route"))
    return report


# ----------------------------------------------------------------- phase 8

def timed_pass(fn, points) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(points)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_two_stage() -> dict:
    log(f"== phase 8: PointRCNN inference, batch {TWO_STAGE_BATCH}, {N_POINTS} points, f32")
    fn, (points,) = two_stage_entry(device="cuda", seed=0, batch=TWO_STAGE_BATCH)
    _build.reset_launches()
    det = fn(points)
    torch.cuda.synchronize()
    launches = _build.launches()
    log(f"kernel launches in one PointRCNN forward: {launches}")
    want = dict(three_nn=4, sa_fused=2, fps=6, ffps=0, scatter_add=0)
    check(all(launches[k] == v for k, v in want.items()), f"launches {launches}, want {want}")
    check(launches["ball_query"] > 0 and launches["gather"] > 0, "K3 or K4 was not launched")
    # the RPN's SA1-SA4 over 4 clouds, the RCNN's SA1-SA2 over 400
    launches["routes"] = check_routes("PointRCNN inference", "PointRCNN")
    b = TWO_STAGE_BATCH
    check(det["boxes"].shape == (b, 100, 7) and det["proposals"].shape == (b, 100, 7),
          f"detections {tuple(det['boxes'].shape)}, proposals {tuple(det['proposals'].shape)}")
    for key in ("boxes", "scores", "proposals"):
        check(bool(torch.isfinite(det[key]).all()), f"non-finite {key}")
    check(bool((det["valid"].sum(-1) <= 100).all() and det["valid"].any()),
          "a scan has more than 100 boxes, or no scan has any")
    check(bool((det["proposals_valid"].sum(-1) <= 100).all() and det["proposals_valid"].any()),
          "a scan has more than 100 proposals, or no scan has any")
    log(f"boxes per scan {det['valid'].sum(-1).tolist()}, proposals per scan "
        f"{det['proposals_valid'].sum(-1).tolist()}")

    fn(points)
    torch.cuda.reset_peak_memory_stats()
    t = [timed_pass(fn, points) for _ in range(PASSES)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    one = points[:1].contiguous()
    lat = [timed_pass(fn, one) * 1e3 for _ in range(PASSES + 1)]
    log(f"PointRCNN throughput at batch {b}: {b * PASSES / sum(t):.2f} scans/s over {PASSES} "
        f"passes (median pass {statistics.median(t) * 1e3:.2f} ms); batch-1 latency median "
        f"{statistics.median(lat[1:]):.2f} ms of {PASSES}; peak memory {peak:.2f} GiB")
    profile_once(lambda: fn(points), f"PointRCNN batch of {b}", top=16,
                 each="dfps|ball_query|grid_build")
    with on_route("block"):
        profile_once(lambda: fn(points), f"PointRCNN batch of {b}, K1 on the one-block route",
                     top=0, each="dfps")
    with on_ball_route("brute"):
        profile_once(lambda: fn(points), f"PointRCNN batch of {b}, K3 on the brute-force route",
                     top=0, each="ball_query")

    # batch scaling on other scans: at each batch a warm-up, PASSES timed
    # passes (the host-side NMS sweep moves one pass by ~20%) and one
    # profiled pass for the device busy time, which repeats far closer; the
    # fixed and per-scan costs are fitted to this call's readings only
    scans = torch.from_numpy(synthetic_scenes(16, N_POINTS, seed=1)["points"]).cuda()
    sizes, walls, busies = (1, 2, 4, 8, 16), [], []
    for bb in sizes:
        chunk = scans[:bb].contiguous()
        timed_pass(fn, chunk)
        torch.cuda.reset_peak_memory_stats()
        dts = sorted(timed_pass(fn, chunk) * 1e3 for _ in range(PASSES))
        peak = torch.cuda.max_memory_allocated() / 2**30
        walls.append(statistics.median(dts))
        busies.append(profile_once(lambda: fn(chunk), f"PointRCNN batch of {bb}", top=0,
                                   each="dfps")[1])
        log(f"PointRCNN batch {bb}: median {walls[-1]:.2f} ms of {PASSES} passes (min "
            f"{dts[0]:.2f}, max {dts[-1]:.2f}); {bb * 1e3 / walls[-1]:.2f} scans/s; device busy "
            f"{busies[-1]:.2f} ms; peak memory {peak:.2f} GiB")
    fixed, per_scan = linear_fit(sizes, walls)
    busy_fixed, busy_per_scan = linear_fit(sizes, busies)
    log(f"PointRCNN batch scaling fit over b {list(sizes)}: wall {fixed:.2f} ms + "
        f"{per_scan:.2f} ms a scan; device busy {busy_fixed:.2f} ms + {busy_per_scan:.2f} ms a scan")
    return launches


# ----------------------------------------------------------------- phase 9

class RoIReplay:
    """The card leg's discrete decisions inside the RCNN, handed to the CPU
    leg: RoI-pool membership (a point within rounding of a proposal face),
    the RCNN's D-FPS picks and its ball queries (on canonical coordinates,
    which the two devices' cos and sin round apart by an ulp). Every
    decision the CPU would have taken otherwise is counted and must be a
    near-tie on the CPU's own inputs: pool members inside the box grown by
    FACE_TOL, counts between those of the box shrunk and grown by it; balls
    likewise with the radius scaled by 1 -+ RADIUS_RTOL; a pick within
    FFPS_TIE_RTOL of the farthest distance."""

    KINDS = ("roi_points", "fps", "ball_query")
    FACE_TOL = 1e-4  # metres
    RADIUS_RTOL = 1e-5

    def __init__(self):
        self.recording = True
        self.log = {k: [] for k in self.KINDS}
        self.pos = dict.fromkeys(self.KINDS, 0)
        self.differ = dict.fromkeys(self.KINDS, 0)
        self.total = dict.fromkeys(self.KINDS, 0)
        self._roi = two_stage.query_boxes_3d_points
        self._fps = modules.farthest_point_sample
        self._ball = modules.ball_query_multi

    def patches(self):
        return (mock.patch.object(two_stage, "query_boxes_3d_points", self.roi_points),
                mock.patch.object(modules, "farthest_point_sample", self.fps),
                mock.patch.object(modules, "ball_query_multi", self.ball_query))

    def _next(self, kind):
        card = self.log[kind][self.pos[kind]]
        self.pos[kind] += 1
        return card

    def roi_points(self, xyz, boxes, nsample):
        own = self._roi(xyz, boxes, nsample)
        if self.recording:
            self.log["roi_points"].append(tuple(t.cpu() for t in own))
            return own
        idx, cnt = self._next("roi_points")
        differ = (idx != own[0]).any(-1) | (cnt != own[1])
        self.differ["roi_points"] += int(differ.sum())
        self.total["roi_points"] += differ.numel()
        if differ.any():
            grow = torch.cat([boxes[..., :3], boxes[..., 3:6] + 2 * self.FACE_TOL,
                              boxes[..., 6:]], -1)
            shrink = torch.cat([boxes[..., :3], boxes[..., 3:6] - 2 * self.FACE_TOL,
                                boxes[..., 6:]], -1)
            grow = torch.cat([grow[..., :1], grow[..., 1:2] + self.FACE_TOL, grow[..., 2:]], -1)
            shrink = torch.cat([shrink[..., :1], shrink[..., 1:2] - self.FACE_TOL,
                                shrink[..., 2:]], -1)
            lo, hi = self._roi(xyz, shrink, nsample)[1], self._roi(xyz, grow, nsample)[1]
            check(bool(((lo <= cnt) & (cnt <= hi))[differ].all()),
                  "an RoI pool count differs between card and CPU away from a box face")
            members = xyz.gather(1, idx.reshape(xyz.shape[0], -1, 1).long().expand(-1, -1, 3))
            canon = canonicalize_points(members.reshape(*idx.shape, 3), grow)
            l, h, w = grow[..., 3:4], grow[..., 4:5], grow[..., 5:6]
            inside = ((canon[..., 0].abs() <= l / 2) & (canon[..., 2].abs() <= w / 2)
                      & (canon[..., 1] <= 0) & (canon[..., 1] >= -h))
            check(bool(inside[differ & (cnt > 0)].all()),
                  "a card RoI pool member lies outside its proposal on the CPU")
        return idx, cnt

    def fps(self, xyz, npoint):
        own = self._fps(xyz, npoint)
        if self.recording:
            self.log["fps"].append(own.cpu())
            return own
        card = self._next("fps")
        differ = (card != own).any(-1)
        self.differ["fps"] += int(differ.sum())
        self.total["fps"] += differ.numel()
        if differ.any():
            short = fps_pick_shortfall(xyz[differ], card[differ])
            check(short <= FFPS_TIE_RTOL, f"a card D-FPS pick is {short:.3g} short on the CPU")
        return card

    def ball_query(self, radius_list, nsample_list, xyz, new_xyz, dilated=False):
        own = self._ball(radius_list, nsample_list, xyz, new_xyz, dilated=dilated)
        if self.recording:
            self.log["ball_query"].append([(i.cpu(), c.cpu()) for i, c in own])
            return own
        card = self._next("ball_query")
        check(not dilated, "the RCNN's ball queries are not dilated")
        lo = self._ball([r * (1 - self.RADIUS_RTOL) for r in radius_list], nsample_list, xyz,
                        new_xyz)
        hi = self._ball([r * (1 + self.RADIUS_RTOL) for r in radius_list], nsample_list, xyz,
                        new_xyz)
        for (ci, cc), (oi, oc), (_, lc), (_, hc), r in zip(card, own, lo, hi, radius_list):
            differ = (ci != oi).any(-1) | (cc != oc)
            self.differ["ball_query"] += int(differ.sum())
            self.total["ball_query"] += differ.numel()
            if differ.any():
                check(bool(((lc <= cc) & (cc <= hc))[differ].all()),
                      "a ball count differs between card and CPU away from the radius")
                pts = xyz.gather(1, ci.reshape(xyz.shape[0], -1, 1).long().expand(-1, -1, 3))
                d = pts.reshape(*ci.shape, 3) - new_xyz[:, :, None]
                d2 = (d * d).sum(-1)
                check(bool((d2[differ & (cc > 0)] < (r * (1 + self.RADIUS_RTOL)) ** 2).all()),
                      "a card ball member lies outside the radius on the CPU")
        return card


def _bins_flipped(a: torch.Tensor, b: torch.Tensor, tol: float) -> torch.Tensor:
    """Where two legs' argmax over the last axis differ; each such place must
    be a near-tie on leg b (its top two within tol x the largest |logit|)."""
    flipped = a.argmax(-1) != b.argmax(-1)
    if flipped.any():
        top2 = b[flipped].topk(2, dim=-1).values
        gap = float((top2[:, 0] - top2[:, 1]).max())
        check(gap <= tol * float(b.abs().max()), f"an argmax differs away from a tie ({gap:.3g})")
    return flipped


def bin_flips(coder, out_a: dict, out_b: dict, tol: float) -> torch.Tensor:
    """Bin-Anchor argmaxes (x bin, z bin, heading bin) that differ between
    two legs' head outputs -> bool [bs, n] of the candidates they touch."""
    nb = coder.num_bins
    flips = _bins_flipped(out_a["angle_cls"].cpu(), out_b["angle_cls"], tol)
    for part in (slice(0, nb), slice(2 * nb, 3 * nb)):
        flips |= _bins_flipped(out_a["offset"][..., part].cpu(), out_b["offset"][..., part], tol)
    return flips.any(-1)


def proposal_keeps(spec, out: dict):
    """The RPN's proposal NMS on scan 0, step by step as `class_unaware_nms`
    runs it (best score, top-k prefilter, greedy sweep), but with every keep
    before the max_output cap. -> (kept candidates in keep order, the top-k
    set, candidate scores [n], candidate BEV boxes [n, 4]), on the CPU."""
    boxes = spec.decode(out)[0].cpu()
    check(boxes.shape[1] == 1, "the RPN regresses one box per candidate")
    score = spec.scores(out)[0].amax(-1).cpu()
    bev = boxes_to_bev_aabb(boxes[:, 0])
    top = top_k_set(score[None], spec.nms_pre_topk)[0][0].long()
    idx, valid = nms_rows(bev[top][None], score[top][None], len(top), spec.nms_threshold)
    return top[idx[0][valid[0]].long()].tolist(), top, score, bev


def keeps_differ_at_ties(what: str, g_keep, c_keep, score, bev, thr: float, flips,
                         universe, cut: float | None = None, cap: int | None = None) -> int:
    """Greedy-NMS keep sets of the card (g_keep) and the CPU (c_keep), each in
    keep order. Every candidate kept on one leg only must be a near-tie on
    the CPU's values (`score`, `bev`; `universe` the candidates the sweeps
    saw): its score within F32_TOL of the largest of the top-k `cut`; an IoU
    with another candidate within F32_TOL of `thr`; an overlap above `thr`
    less F32_TOL with a candidate whose score is within F32_TOL of its own
    (the sweep's order); a bin flip (`flips`, its box decoded a whole bin
    apart); or an overlap above `thr` less F32_TOL with another such
    candidate, whose keep or loss it follows. With `cap`, the first `cap`
    keeps are compared too: a candidate in one leg's first `cap` only must
    be a differing keep, or have its score within F32_TOL of the cap's, or
    come after a differing keep. Fails otherwise; -> candidates kept on one
    side only."""
    s_tol = F32_TOL * float(score.abs().max())
    differ = sorted(set(g_keep) ^ set(c_keep))
    if differ:
        d, u = torch.tensor(differ), universe
        iou = aabb_iou(bev[d][None], bev[u][None])[0]  # [|d|, |u|]
        other = u[None] != d[:, None]
        overlap = (iou > thr - F32_TOL) & other
        near_thr = ((iou - thr).abs() <= F32_TOL) & other
        near_score = overlap & ((score[u][None] - score[d][:, None]).abs() <= s_tol)
        tie = flips[d] | near_thr.any(1) | near_score.any(1)
        if cut is not None:
            tie |= (score[d] - cut).abs() <= s_tol
        col = torch.isin(u, d)
        while True:  # a keep that follows from another differing keep
            tied_cols = torch.zeros(len(u), dtype=torch.bool)
            tied_cols[col.nonzero()[:, 0]] = tie[torch.searchsorted(d, u[col])]
            grown = tie | (overlap & tied_cols[None]).any(1)
            if torch.equal(grown, tie):
                break
            tie = grown
        check(bool(tie.all()), f"{what}: candidates {d[~tie].tolist()} are kept on one leg "
              "only, away from any tie")
    if cap is not None:
        first = [set(g_keep[:cap]), set(c_keep[:cap])]
        last = score[c_keep[min(cap, len(c_keep)) - 1]] if c_keep else score.max()
        earliest = max((float(score[i]) for i in differ), default=float("-inf"))
        for i in first[0] ^ first[1]:
            check(i in differ or abs(float(score[i] - last)) <= s_tol
                  or earliest >= float(score[i]) - s_tol,
                  f"{what}: candidate {i} is in one leg's first {cap} keeps only, away from a tie")
    log(f"  {what}: {len(set(g_keep) & set(c_keep))} kept on both legs, {len(differ)} on one "
        "side only" + (" (each a near-tie on the CPU's values)" if differ else ""))
    return len(differ)


def phase_two_stage_card_vs_cpu(scans: torch.Tensor) -> None:
    log(f"== phase 9: PointRCNN card against CPU, one scan of {N_POINTS} points, f32")
    _, gmodel, rpn_spec, rcnn_spec, _ = pointrcnn(device="cuda", seed=0)
    cmodel = copy.deepcopy(gmodel).cpu()
    scan = scans[:1].contiguous()
    t0 = time.perf_counter()
    with torch.inference_mode():
        gnet = gmodel.rpn_backbone(scan)
        cnet = cmodel.rpn_backbone(scan.cpu())
        gout, cout = gmodel.rpn(scan), cmodel.rpn(scan.cpu())
    log(f"  RPN on both legs in {time.perf_counter() - t0:.2f} s")
    for layer, (gi, ci) in enumerate(zip(gnet["fps_idx"], cnet["fps_idx"])):
        if gi is not None:
            check(torch.equal(gi.cpu(), ci), f"RPN layer {layer}: D-FPS picks differ")
    log("  RPN D-FPS picks equal at SA1-SA4 (raw points on both legs)")
    for key in ("feature", "cls", "offset", "angle_cls", "angle_res"):
        _close(f"RPN {key}", gout[key].cpu(), cout[key], F32_TOL)
    flips = bin_flips(rpn_spec.coder, gout, cout, F32_TOL)
    gbox, cbox = rpn_spec.decode(gout)[:, :, 0].cpu(), rpn_spec.decode(cout)[:, :, 0]
    _close(f"RPN candidate boxes ({int(flips.sum())} with a bin at a near-tie left out)",
           gbox[~flips], cbox[~flips], F32_TOL)
    gsc, csc = rpn_spec.scores(gout).cpu(), rpn_spec.scores(cout)
    _close("RPN candidate scores", gsc, csc, F32_TOL)

    with torch.inference_mode():
        gprop = rpn_spec.propose(gout)
        cprop = rpn_spec.propose(cout)
        # the CPU's NMS on the card's candidates: the same function on the
        # same inputs, so a difference between the legs comes from inputs
        # that lie within rounding of each other
        replay = class_unaware_nms(rpn_spec.decode(gout).cpu(), gsc, rpn_spec.max_output,
                                   rpn_spec.nms_threshold, pre_topk=rpn_spec.nms_pre_topk)
    check(torch.equal(replay[2], gprop[2].cpu()), "CPU NMS on the card's candidates keeps others")
    _close("CPU NMS on the card's candidates: proposals", replay[0], gprop[0].cpu(), F32_TOL)
    # the legs' own keep sets, every keep before the cap of max_output
    g_keep, g_top, _, _ = proposal_keeps(rpn_spec, gout)
    c_keep, c_top, c_score, c_bev = proposal_keeps(rpn_spec, cout)
    for keep, box, prop in ((g_keep, gbox, gprop), (c_keep, cbox, cprop)):
        count = int(prop[2][0].sum())
        check(count == min(len(keep), rpn_spec.max_output)
              and torch.equal(box[0, keep[:count]], prop[0][0, :count].cpu()),
              "proposal_keeps does not reproduce the proposals")
    cut = float(c_score.sort(descending=True).values[rpn_spec.nms_pre_topk - 1])
    keeps_differ_at_ties("proposal NMS", g_keep, c_keep, c_score, c_bev, rpn_spec.nms_threshold,
                         flips[0], torch.unique(torch.cat([g_top, c_top])), cut=cut,
                         cap=rpn_spec.max_output)
    capped = [keep[:rpn_spec.max_output] for keep in (g_keep, c_keep)]
    both = sorted(i for i in set(capped[0]) & set(capped[1]) if not flips[0, i])
    rows = [[keep.index(i) for i in both] for keep in capped]
    _close(f"proposals kept on both legs ({len(both)})", gprop[0][0, rows[0]].cpu(),
           cprop[0][0, rows[1]], F32_TOL)

    # the RCNN on the card's proposals, with the card's foreground mask and
    # RoI decisions replayed on the CPU leg
    gmask = two_stage.foreground_mask(gout)
    cmask = two_stage.foreground_mask(cout)
    flipped = gmask.cpu() != cmask
    if flipped.any():
        logit = cout["cls"].amax(-1, keepdim=True)
        check(float(logit[flipped].abs().max()) <= F32_TOL * float(logit.abs().max()),
              "a foreground bit differs away from the 0.5 threshold")
    log(f"  foreground mask bits that differ (near-ties, the card's taken): {int(flipped.sum())}")
    rep = RoIReplay()
    roi, fps_p, ball = rep.patches()
    t0 = time.perf_counter()
    with roi, fps_p, ball, torch.inference_mode():
        gr = gmodel.rcnn(gout["base_xyz"], gout["feature"], gmask, gprop[0])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rep.recording = False
        cr = cmodel.rcnn(gout["base_xyz"].cpu(), cout["feature"], gmask.cpu(), gprop[0].cpu())
    log(f"  RCNN card {t1 - t0:.2f} s, CPU {time.perf_counter() - t1:.2f} s")
    check(all(rep.pos[k] == len(rep.log[k]) for k in rep.KINDS),
          f"the legs took different numbers of RCNN decisions: {rep.pos}")
    log("  RCNN decisions the CPU would have taken otherwise, each a near-tie (the card's "
        "taken): " + ", ".join(f"{k} {rep.differ[k]} of {rep.total[k]}" for k in rep.KINDS))
    for key in ("cls", "offset", "angle_cls", "angle_res"):
        _close(f"RCNN {key}", gr[key].cpu(), cr[key], F32_TOL)
    gr["proposals"], cr["proposals"] = gprop[0], gprop[0].cpu()
    gdet, cdet = rcnn_spec.final_detections(gr), rcnn_spec.final_detections(cr)
    flips = bin_flips(rcnn_spec.coder, gr, cr, F32_TOL)
    keep = [{int(i): k for k, i in enumerate(d["index"][0].tolist()) if d["valid"][0, k]}
            for d in (gdet, cdet)]
    both = sorted(i for i in set(keep[0]) & set(keep[1]) if not flips[0, i])
    rows = [[kp[i] for i in both] for kp in keep]
    _close("final box centres and sizes", gdet["boxes"][0, rows[0], :6].cpu(),
           cdet["boxes"][0, rows[1], :6], F32_TOL)
    _close("final headings", gdet["boxes"][0, rows[0], 6].cpu(), cdet["boxes"][0, rows[1], 6],
           F32_TOL)
    _close("final scores", gdet["scores"][0, rows[0]].cpu(), cdet["scores"][0, rows[1]], F32_TOL)
    # the per-class NMS on the CPU's values (one class, so one row)
    with torch.inference_mode():
        c_final = rcnn_spec.decode(cr)[0, :, 0]
        c_final_score = (rcnn_spec.scores(cr) * cr["pool_mask"].float())[0, :, 0]
    check(rcnn_spec.scores(cr).shape[-1] == 1, "the RCNN scores one class")
    one_side = keeps_differ_at_ties(
        "final NMS", list(keep[0]), list(keep[1]), c_final_score, boxes_to_bev_aabb(c_final),
        rcnn_spec.nms_threshold, flips[0], torch.arange(len(c_final_score)))
    log(f"  final detections: {len(both)} kept on both and compared ({int(flips.sum())} "
        f"proposals with a bin at a near-tie left out), {one_side} on one side only")


# ----------------------------------------------------------------- phase 10

CLI_TRAIN_SCANS, CLI_VAL_SCANS, CLI_SCAN_POINTS = 16, 8, 20000
CLI_ITERS, CLI_CKPT_EVERY = 20, 10
# per-iteration values of metrics.jsonl that are times, not results
CLI_TIMES = ("sec_per_it", "loader_wait_s")


def _metrics(run_dir: str) -> list[dict]:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _det_rows(det_per_image) -> list[np.ndarray]:
    """Per scan, one row a detection: box (x, y, z, l, h, w, ry), score, 2D
    box."""
    return [np.array([[*d.t, d.l, d.h, d.w, d.ry, d.score, *d.box2d] for d in dets],
                     np.float64).reshape(-1, 12) for dets in det_per_image]


def same_detections(got: list, want: list, tol: float, what: str) -> dict:
    """Equal keep sets, scan by scan, and values within `tol` of the
    largest |value| of each field (boxes, scores, 2D boxes). Detections are
    matched by their boxes, not their order, which is by score: rounding
    may swap two of near-equal score. -> the largest difference a field."""
    pairs = []
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.shape == w.shape, f"{what}: val scan {i} keeps {len(g)} detections, not {len(w)}")
        if not len(w):
            continue
        pick = np.abs(g[:, None, :7] - w[None, :, :7]).max(-1).argmin(0)
        check(sorted(pick.tolist()) == list(range(len(w))),
              f"{what}: val scan {i}'s detections do not match one to one")
        pairs.append((g[pick], w))
    worst = {}
    if pairs:
        g, w = (np.concatenate(x) for x in zip(*pairs))
        for field, cols in (("boxes", slice(0, 7)), ("scores", slice(7, 8)),
                            ("2D boxes", slice(8, 12))):
            err, scale = np.abs(g[:, cols] - w[:, cols]).max(), np.abs(w[:, cols]).max()
            check(err <= tol * scale, f"{what}: {field} differ by {err:.3g} (limit {tol:.3g} "
                  f"x {scale:.3g})")
            worst[field] = float(f"{err:.3g}")
    return worst


@contextlib.contextmanager
def recording_inference(calls: list):
    """bin.evaluate's and bin.test's split inference, recorded: its
    detections and its seconds a call."""
    real = evaluate_cli.run_inference_on_split

    def recorded(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        calls.append({"seconds": time.perf_counter() - t0, "det": out[0],
                      "batch_size": kw.get("batch_size", 1)})
        return out

    with mock.patch.object(evaluate_cli, "run_inference_on_split", recorded), \
            mock.patch.object(test_cli, "run_inference_on_split", recorded):
        yield


def cli_launches(what: str, fn) -> dict:
    """Run `fn` with the launch counts set to 0 just before and read just
    after -> the launches, with their routes."""
    _build.reset_launches()
    fn()
    torch.cuda.synchronize()
    launches = _build.launches()
    launches["routes"] = _build.route_launches()
    log(f"kernel launches in {what}: {launches}")
    return launches


def phase_cli_chain() -> dict:
    """-> the launches of the three CLI paths (training run A, the
    flagship's evaluate and test, PointRCNN's evaluate and test)."""
    log(f"== phase 10: the CLI chain on the card: preprocess, train at batch {BATCH} "
        f"(run A to {CLI_ITERS}; run B to {CLI_CKPT_EVERY}, resumed to {CLI_ITERS}), "
        "evaluate and test the flagship and PointRCNN")
    paths = {}
    with tempfile.TemporaryDirectory(prefix="ssd3d_cli_") as root:
        data, npz = os.path.join(root, "kitti"), os.path.join(root, "npz")
        t0 = time.perf_counter()
        synth.write_tree(data, n_train=CLI_TRAIN_SCANS, n_val=CLI_VAL_SCANS,
                         n_points=CLI_SCAN_POINTS, seed=0)
        data_opts = ["DATASET.KITTI.BASE_DIR_PATH", data,
                     "DATASET.KITTI.TRAIN_LIST", os.path.join(data, "train.txt"),
                     "DATASET.KITTI.VAL_LIST", os.path.join(data, "val.txt"),
                     "DATASET.KITTI.SAVE_NUMPY_PATH", npz]
        data_opts = ["--device", "cuda"] + data_opts
        opts = data_opts + ["TRAIN.CONFIG.MAX_ITERATIONS", str(CLI_ITERS),
                            "TRAIN.CONFIG.CHECKPOINT_INTERVAL", str(CLI_CKPT_EVERY),
                            "TRAIN.CONFIG.SUMMARY_INTERVAL", "1"]
        cfg_path = str(FLAGSHIP_CFG)
        kept = {split: preprocess_cli.main(["--cfg", cfg_path, "--img_list", split] + opts)
                for split in ("train", "val")}
        check(len(kept["train"]) == CLI_TRAIN_SCANS and len(kept["val"]) == CLI_VAL_SCANS,
              f"preprocessing kept {len(kept['train'])} train and {len(kept['val'])} val scans")
        sizes = [len(np.load(os.path.join(npz, split, f"{i:06d}.npz"))["points"])
                 for split in kept for i in kept[split]]
        check(min(sizes) > N_POINTS, f"a preprocessed scan holds {min(sizes)} points, "
              f"not more than the {N_POINTS} the flagship samples")
        log(f"wrote and preprocessed {CLI_TRAIN_SCANS} + {CLI_VAL_SCANS} scans of "
            f"{CLI_SCAN_POINTS} points ({min(sizes)}-{max(sizes)} kept) in "
            f"{time.perf_counter() - t0:.1f} s")

        # run A: unbroken, with the launches of every step
        run_a, run_b = os.path.join(root, "run_a"), os.path.join(root, "run_b")
        per_step = []
        real_step = TrainGraph.train_step

        def counted_step(graph, state, batch):
            before = _build.launches()
            out = real_step(graph, state, batch)
            per_step.append({k: v - before[k] for k, v in _build.launches().items()})
            return out

        with mock.patch.object(TrainGraph, "train_step", counted_step):
            paths["cli_train"] = cli_launches(
                f"bin.train run A ({CLI_ITERS} steps)",
                lambda: train_cli.main(["--cfg", cfg_path, "--log_dir", run_a] + opts))
        check(len(per_step) == CLI_ITERS, f"run A took {len(per_step)} steps")
        for i, n in enumerate(per_step, start=1):
            check(all(n[k] > 0 for k in ("fps", "ffps", "ball_query", "gather", "scatter_add"))
                  and n["scatter_add"] == 8 and n["three_nn"] == 0 and n["sa_fused"] == 0,
                  f"run A step {i}: kernel launches {n}")
        log(f"run A: K1-K5 launched in each of its {CLI_ITERS} steps, per step {per_step[-1]}")
        a = _metrics(run_a)
        check([m["iter"] for m in a] == list(range(1, CLI_ITERS + 1)),
              f"run A's metrics.jsonl holds iterations {[m['iter'] for m in a]}")
        check(all(np.isfinite(m[k]) for m in a for k in LOSS_KEYS + ("total",)),
              "run A logged a loss that is not finite")
        with open(os.path.join(run_a, "log_train.txt")) as f:
            check("worker processes started by forkserver" in f.read(),
                  "run A's loader workers were not started by forkserver")
        steps = CheckpointManager(os.path.join(run_a, "ckpt")).all_steps()
        check(steps == [CLI_CKPT_EVERY, CLI_ITERS], f"run A's checkpoints are at steps {steps}")
        for it in (CLI_CKPT_EVERY, CLI_ITERS):
            for sub in ("bev", "scene3d"):
                png = os.path.join(run_a, sub, f"iter_{it:07d}.png")
                check(os.path.isfile(png) and open(png, "rb").read(8) == b"\x89PNG\r\n\x1a\n",
                      f"{png} was not written")
        log("run A totals: " + ", ".join(f"{m['total']:.3f}" for m in a))

        # run B: stopped at a checkpoint, resumed in a new Trainer
        train_cli.main(["--cfg", cfg_path, "--log_dir", run_b, "--max_iterations",
                        str(CLI_CKPT_EVERY)] + opts)
        train_cli.main(["--cfg", cfg_path, "--log_dir", run_b] + opts)
        b = _metrics(run_b)
        with open(os.path.join(run_b, "log_train.txt")) as f:
            check(f"restored checkpoint at step {CLI_CKPT_EVERY}" in f.read(),
                  "run B did not resume from its checkpoint")
        check([m["iter"] for m in b] == list(range(1, CLI_ITERS + 1)),
              f"run B's metrics.jsonl holds iterations {[m['iter'] for m in b]}")
        for ma, mb in zip(a[CLI_CKPT_EVERY:], b[CLI_CKPT_EVERY:]):
            va = {k: v for k, v in ma.items() if k not in CLI_TIMES}
            vb = {k: v for k, v in mb.items() if k not in CLI_TIMES}
            check(va == vb, f"iteration {ma['iter']}: resumed run B logged {vb}, "
                  f"unbroken run A {va}")
        log(f"run B, resumed at {CLI_CKPT_EVERY}: iterations {CLI_CKPT_EVERY + 1}-{CLI_ITERS} "
            f"equal run A's value for value ({len(a[0]) - len(CLI_TIMES)} values each)")

        sec = [m["sec_per_it"] for m in a[1:]]
        wait = [m["loader_wait_s"] for m in a[1:]]
        log(f"CLI trainer at batch {BATCH} (run A, iterations 2-{CLI_ITERS}): median "
            f"{statistics.median(sec):.4f} s/it (min {min(sec):.4f}, max {max(sec):.4f}); "
            f"loader wait {100 * sum(wait) / sum(sec):.1f}% of the time "
            f"(median {statistics.median(wait):.4f} s/it); phase 5's fixed-batch step: "
            f"{MEASURED['phase5_step_ms'] / 1e3:.4f} s")

        # the flagship's evaluate and test from run A's checkpoints
        calls: list = []
        eval_dir = os.path.join(root, "eval_b4")

        def flagship_eval_and_test():
            evaluate_cli.main(["--cfg", cfg_path, "--log_dir", run_a, "--once",
                               "--viz_scans", "1"] + opts)
            for _ in range(2):  # the second call is timed warm
                evaluate_cli.main(["--cfg", cfg_path, "--log_dir", eval_dir,
                                   "--restore_model_path", os.path.join(run_a, "ckpt"),
                                   "--viz_scans", "0"] + opts + ["TEST.BATCH_SIZE", "4"])
            test_cli.main(["--cfg", cfg_path, "--log_dir", run_a] + opts)

        with recording_inference(calls):
            paths["cli_eval"] = cli_launches("the flagship's bin.evaluate and bin.test",
                                             flagship_eval_and_test)
        n = paths["cli_eval"]
        check(all(n[k] > 0 for k in ("fps", "ffps", "ball_query", "gather"))
              and n["scatter_add"] == n["three_nn"] == n["sa_fused"] == 0,
              f"the flagship's evaluate and test launched {n}")
        with open(os.path.join(run_a, f"eval_{CLI_ITERS}.json")) as f:
            ap = json.load(f)["Car"]
        check(all(len(ap[m]) == 3 and all(np.isfinite(ap[m])) for m in ("image", "ground", "3d")),
              f"Car AP not finite at every difficulty: {ap}")
        log(f"run A step {CLI_ITERS}, Car AP easy/moderate/hard: " + "; ".join(
            f"{m} {'/'.join(f'{v:.2f}' for v in ap[m])}" for m in ("image", "ground", "3d")))
        check(os.path.isfile(os.path.join(run_a, "best.json")), "bin.evaluate wrote no best.json")
        b1, b4 = _det_rows(calls[1]["det"]), _det_rows(calls[3]["det"])
        check(calls[1]["batch_size"] == 1 and calls[3]["batch_size"] == 4,
              f"inference batch sizes {[c['batch_size'] for c in calls]}")
        check(len(b1) == len(b4) == CLI_VAL_SCANS, "batch 1 and 4 saw other scans")
        worst = same_detections(b4, b1, F32_TOL, "TEST.BATCH_SIZE 4 against batch 1")
        log(f"TEST.BATCH_SIZE 4 keeps batch 1's detections on all {CLI_VAL_SCANS} val scans "
            f"({sum(len(r) for r in b1)} at the 0.3 threshold); largest difference "
            f"{worst} (a GEMM over 4 scans' rows blocks its sums otherwise)")
        log(f"evaluate's split inference over {CLI_VAL_SCANS} val scans: batch 1 "
            f"{CLI_VAL_SCANS / calls[1]['seconds']:.2f} scans/s (ckpt {CLI_ITERS}); batch 4 "
            f"{CLI_VAL_SCANS / calls[3]['seconds']:.2f} scans/s (second call; the first "
            f"{CLI_VAL_SCANS / calls[2]['seconds']:.2f})")
        results = sorted(os.listdir(os.path.join(run_a, "kitti_result")))
        check(results == [f"{i:06d}.txt" for i in kept["val"]],
              f"bin.test wrote {results}")

        # PointRCNN: a seeded-weights checkpoint, evaluated and tested
        run_p = os.path.join(root, "run_pointrcnn")
        pipe = build_pipeline(load_cfg(str(POINTRCNN_CFG)), device="cuda")
        init_weights(pipe.model, 0)
        CheckpointManager(os.path.join(run_p, "ckpt")).save(
            0, {"step": 0, "model": {k: v.cpu() for k, v in pipe.model.state_dict().items()}})
        del pipe
        pcalls: list = []

        def pointrcnn_eval_and_test():
            evaluate_cli.main(["--cfg", str(POINTRCNN_CFG), "--log_dir", run_p, "--once",
                               "--viz_scans", "0"] + data_opts)
            test_cli.main(["--cfg", str(POINTRCNN_CFG), "--log_dir", run_p] + data_opts)

        with recording_inference(pcalls):
            paths["cli_pointrcnn"] = cli_launches("PointRCNN's bin.evaluate and bin.test",
                                                  pointrcnn_eval_and_test)
        n = paths["cli_pointrcnn"]
        check(all(n[k] > 0 for k in ("fps", "ball_query", "gather", "three_nn", "sa_fused"))
              and n["ffps"] == n["scatter_add"] == 0,
              f"PointRCNN's evaluate and test launched {n}")
        with open(os.path.join(run_p, "eval_0.json")) as f:
            pres = json.load(f)
        check(all(np.isfinite(pres["Car"][m]).all() for m in ("image", "ground", "3d"))
              and np.isfinite(pres["proposal_recall"]["recall"]),
              f"PointRCNN's evaluation is not finite: {pres}")
        results = sorted(os.listdir(os.path.join(run_p, "kitti_result")))
        check(len(results) == CLI_VAL_SCANS, f"PointRCNN's bin.test wrote {results}")
        log(f"PointRCNN (seeded weights): {CLI_VAL_SCANS / pcalls[0]['seconds']:.2f} scans/s "
            f"at batch 1 in bin.evaluate; proposal recall "
            f"{pres['proposal_recall']['detected']}/{pres['proposal_recall']['total']}")

        # run A's checkpoint on one val scan, card against CPU
        ckpt, step = CheckpointManager(os.path.join(run_a, "ckpt")).restore()
        cfg = load_cfg(cfg_path, opts[2:])
        scan = KittiLoader(cfg, "val", training=False).load_sample(0)["points"]
        log(f"card against CPU on val scan {kept['val'][0]} with run A's step-{step} weights:")
        scan = torch.from_numpy(scan[None]).cuda()
        hold_card_to_cpu(scan, ckpt["model"], BF16_TRAINED_TOL)
    return paths


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    def timed(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        log(f"-- {phase.__name__} took {time.perf_counter() - t0:.1f} s")
        return out

    card = timed(phase_environment)
    # the synthetic KITTI-like scans of `train_entry`'s batch (ground plane,
    # car shells and clutter from `ssd3d_torch.utils.synth.make_scene`)
    scans = torch.from_numpy(synthetic_scenes(BATCH, N_POINTS)["points"]).cuda()
    report = timed(phase_kernels, scans)
    infer_launches = timed(phase_main_path, scans)
    timed(phase_card_vs_cpu, scans)
    train_launches = timed(phase_training, report)
    timed(phase_train_card_vs_cpu)
    report += timed(phase_two_stage_kernels, report)
    two_stage_launches = timed(phase_two_stage)
    timed(phase_two_stage_card_vs_cpu, scans)
    paths = {"inference": infer_launches, "train": train_launches, "two_stage": two_stage_launches,
             **timed(phase_cli_chain)}
    for entry in report:
        entry["launches_by_path"] = {p: n[entry["name"]] for p, n in paths.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
        if entry["name"] in ("fps", "ffps", "ball_query", "sa_fused"):
            entry["launches_by_route"] = {p: n["routes"][entry["name"]] for p, n in paths.items()}
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
