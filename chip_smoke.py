#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`ssd3d_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Eighteen phases, each of which raises on failure (no error is caught):

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
   sampling picks, losses (each above 0 on both legs, so its gradients
   are compared), every gradient leaf and the new BatchNorm
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
10. The CLI chain in-process on a synthetic KITTI tree: `bin.preprocess`,
   `bin.train` of the flagship (run A unbroken, run B stopped and resumed,
   equal value for value), `bin.evaluate` at TEST.BATCH_SIZE 1 and 4,
   `bin.test`, PointRCNN's evaluate and test from a checkpoint, and run A's
   weights card against CPU.
11. PointRCNN stage-wise training (`two_stage_train_entry`,
   `configs/kitti/pointrcnn/pointrcnn_stage{1,2}.yaml`, full widths, f32,
   batch 4 of 16,384-point scans): stage 1 (the RPN) and stage 2 (the RCNN
   over 4 x 64 RoIs, the RPN frozen, from stage 1's weights), a warm-up and
   five timed steps each, with their launches by kernel and route, host
   share and peak memory; stage 2's rpn_* parameters held bit for bit to
   stage 1's while the RPN's statistics move; K1, K3 and K4 against their
   plain versions at every call of a stage-2 step and K5 at its backward's
   index tensors, the RCNN's shapes timed; one f32 step of each stage card
   against CPU (stage 1 on the timed batch's first scan, stage 2 on the
   whole timed batch, whose minibatch must hold positive and negative RoIs
   with every stage-2 loss live), the card's decisions (ReLU signs, max-pool
   winners, ball members, D-FPS picks, RoI members, proposal keeps, the
   context mask, IoU masks) replayed on the CPU leg, each difference a
   near-tie; then `bin.train` of stage 1, `bin.train` of stage 2 warm-started
   from it, and `bin.evaluate` of the stage-2 run, with s/it and the loader's
   share.
12. K2m, F-FPS over a given distance matrix (`csrc/ffps_dist.cu`), against
   the plain loop at the TPU entries' shapes ([8, 1024, 1024] -> 256,
   [8, 4096, 4096] -> 512), an odd n, a 10 x 10 x 10 lattice whose picks
   tie, and [1, 20000, 20000] (the scratch tier), picks equal, timed with
   the bound; then the public op path (`ssd3d_torch.ops`:
   farthest_point_sample_from_dist, ball_query, ball_query_dilated) and its
   launches.
13. STD (`configs/kitti/std/std.yaml`, the PointsPool voxel pooler, full
   widths, f32, 100 proposals) at batch 4: K1 (the RCNN's D-FPS over each
   RoI's 6 x 6 x 6 voxel centres, whose picks tie), K3, K4 (the pooler's
   gathers), K6 and K7 (SA1 over 216 voxel centres, both routes) against
   their plain versions on the inputs of one forward; inference through
   `two_stage_entry(config="std")` with its launches and routes, scans/s,
   batch-1 latency, device busy time and peak memory; then card against
   CPU on one scan as phase 9, the card's voxel ids replayed too.
14. STD's stage 2 (`std_stage2.yaml`) at batch 4 from stage 1's weights:
   launches, step time, the RPN bit for bit, the pooler trained; then
   `bin.train` of pointrcnn_stage1.yaml, `bin.train` of std_stage2.yaml
   with --restore_model_path, `bin.evaluate`, and `bin.evaluate` and
   `bin.test` of std.yaml from the STD run's checkpoint.
15. The training options no shipped config turns on (`entry.TRAIN_OPTIONS`:
   an IoU head, Dist-Anchor regression, AdaBound, the device augmentation
   with 15 crops of 512 points a scan) on the flagship at batch 8: four
   steps, finite losses, launches; the augmentation card against CPU on the
   same draws; one f32 step card against CPU as phase 6.
16. 3DSSD on nuScenes (`configs/nuscenes/3dssd/3dssd.yaml`: 10 classes, the
   velocity and attribute heads, bf16, 200 outputs a class, seeded
   weights) on a synthetic raw tree (`utils/synth_nuscenes.py`, 3 scenes
   of 6 key frames) that `bin.preprocess` converts (up to 10 sweeps a key
   frame) and the loader budgets to 16,384 points: K1, K2, K3 (both routes;
   the grid's cell grown past the outer radius over the +-50 m range) and
   K4 against their plain versions on the inputs of one forward at batch 4;
   inference at batch 4 (launches by kernel and route) and at batch 1, 2
   and 4 (scans/s, batch-1 latency, device busy time, peak memory); one
   scan budgeted to 65,536 points (K1's slice route, K3's brute force)
   against the plain versions and timed; card against CPU at f32 on one
   scan (heads, velocity and attribute included); the bf16 train step at
   batch 8 (Adam; K5 at its 8 calls; every loss finite and above 0) and
   one f32 step card against CPU on two scans whose boxes carry an
   attribute and a finite velocity, every loss above 0 on both legs;
   then `bin.train` (4 iterations), `bin.evaluate` (mAP, NDS) and
   `bin.test` (`nuscenes_result.json`, read back).
17. The flagship with attention grouping on SA1 and SA2 (`entry.flagship(
   attention=ATTENTION_LAYERS)`, bf16, full widths and depth): inference at
   batch 8 (launches by kernel and route: K3 at SA3 and CG-SA only; scans/s,
   batch-1 latency, device busy, peak memory), each SA1 attention query
   ([8, 4096] x [8, 16384], one a radius) timed with its kernel launches;
   card against CPU on one scan at f32 (every attention row equal, or a
   near-tie of the CPU's keys then taken from the card, `AttentionReplay`;
   picks equal, values within F32_TOL); the bf16 train step at batch 8
   (finite losses, step ms, peak memory, K5 bit for bit at its calls); then
   the flagship with GroupNorm (USE_GN) card against CPU at f32, forward and
   one train step as phase 6 (the card's F-FPS picks, ReLU signs, max-pool
   winners and balls replayed on the CPU leg where a near-tie went the
   other way, `parallel.steps.Decisions`;
   the card's GroupNorm moments, each first held to the CPU's,
   `GroupNormReplay`: the one-pass variance cancels where a group's values
   are nearly equal).
18. Data-parallel and FSDP training over NCCL, one process a card on every
   card (`entry.run_ranks`, `ssd3d_torch.parallel.steps`): the flagship's
   bf16 train step at batch 8 under dp and fsdp, on one card held to the
   plain step (dp bit for bit, fsdp at phase 6's tolerances), over more
   cards the f32 step held to one process on the global batch with the
   ranks' decisions replayed; step ms beside the plain step's, the NCCL
   version; then `bin.train` under SSD3D_DIST_* in dp and in fsdp (4
   iterations, a checkpoint each) and a single process resuming each.

The second line from the end is a JSON object with one entry per kernel:
`launches_by_path` counts its launches in one run of each path (flagship
inference, phase 3; one training step, phase 5; PointRCNN inference, phase
8; phase 10's training run A of 20 steps, the flagship's evaluate and test,
and PointRCNN's evaluate and test; one step of each PointRCNN training
stage and the stage-wise CLI chain, phase 11; the public op path, phase 12;
STD inference, phase 13; one STD stage-2 step and STD's CLI chain, phase 14;
one step with the training options, phase 15; nuScenes inference at batch 4
and at 65,536 points, one nuScenes train step and nuScenes' CLI chain,
phase 16; attention inference and its train step, phase 17; rank 0's dp
and fsdp train steps, phase 18), `launches` is their sum;
times and bounds are of the shape in `shape`
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
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
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
from ssd3d_torch.data.nuscenes import NuScenesLoader
import ssd3d_torch.ops as public_ops
from ssd3d_torch.core import geometry
from ssd3d_torch.entry import (
    ATTENTION_LAYERS,
    FLAGSHIP_CFG,
    NUSCENES_CFG,
    POINTRCNN_CFG,
    STD_CFG,
    TRAIN_OPTIONS,
    flagship,
    free_port,
    init_weights,
    nuscenes,
    pointrcnn,
    run_ranks,
    std,
    synthetic_candidates,
    synthetic_scenes,
    train_entry,
    train_options_entry,
    two_stage_entry,
    two_stage_train_entry,
)
from ssd3d_torch.models.api import build_pipeline
from ssd3d_torch.models import two_stage
from ssd3d_torch.nn import modules
from ssd3d_torch.nn.layers import GroupNorm
from ssd3d_torch.nn.modules import ffps_segments
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
    fps_from_dist_plain,
    fps_pick_shortfall,
    fps_plain,
    fps_route,
    gather_points,
)
from ssd3d_torch.ops.topk import top_k_set
from ssd3d_torch.train import assigner, device_aug, two_stage_step
from ssd3d_torch.train.schedules import bn_momentum
from ssd3d_torch.train.train_step import TrainGraph, trained_parameters
from ssd3d_torch.train.two_stage_step import TwoStageGraph
from ssd3d_torch.train.trainer import CheckpointManager, merge_by_name
from ssd3d_torch.parallel import steps as parallel_steps
from ssd3d_torch.parallel.steps import Decisions
from ssd3d_torch.utils import synth, synth_nuscenes
from ssd3d_torch.utils.timing import cuda_ms

BATCH = 8
N_POINTS = 16384
DEV = "cuda"  # the device of phases 12-18 (a rehearsal on the CPU sets "cpu")
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
# the card's decisions a CPU leg takes (`parallel.steps.Decisions`): those of
# a train step, and with GroupNorm the F-FPS picks too (its epsilon of 1e-6
# carries f32 rounding further than BatchNorm's 1e-3, and an F-FPS step whose
# two farthest points lie within it goes another way)
TRAIN_DECISIONS = ("relu", "max_pool", "ball_query")
GN_DECISIONS = TRAIN_DECISIONS + ("ffps",)
TWO_STAGE_BATCH = 4
# the ball queries of one PointRCNN or STD forward, in launch order
TWO_STAGE_SA_NAMES = ("RPN SA1", "RPN SA2", "RPN SA3", "RPN SA4", "RCNN SA1", "RCNN SA2")
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
    # PointRCNN training at batch 4: stage 1 the RPN; stage 2 the RPN, then
    # the RCNN's SA1-SA2 in train mode (unfused) over 4 x 64 RoIs
    "PointRCNN stage 1": dict(fps=[(4, 16384), (4, 4096), (4, 1024), (4, 256)], ffps=[],
                              ball_query=[16384, 4096, 1024, 256], sa_fused=[]),
    "PointRCNN stage 2": dict(fps=[(4, 16384), (4, 4096), (4, 1024), (4, 256), (256, 512),
                                   (256, 128)], ffps=[],
                              ball_query=[16384, 4096, 1024, 256, 512, 128], sa_fused=[]),
    # STD: PointRCNN's RPN, then the RCNN over the 6 x 6 x 6 voxel centres of
    # each RoI (400 at inference, 4 x 64 in stage 2's train mode, unfused)
    "STD": dict(fps=[(4, 16384), (4, 4096), (4, 1024), (4, 256), (400, 216), (400, 128)],
                ffps=[], ball_query=[16384, 4096, 1024, 256, 216, 128],
                sa_fused=[(131, [64], [[128, 128, 128]]), (131, [64], [[128, 128, 256]])]),
    "STD stage 2": dict(fps=[(4, 16384), (4, 4096), (4, 1024), (4, 256), (256, 216),
                             (256, 128)], ffps=[],
                        ball_query=[16384, 4096, 1024, 256, 216, 128], sa_fused=[]),
    # 3DSSD on nuScenes (phase 16): inference at batch 4, and one scan of
    # 65,536 points (its train step at batch 8 takes the "3DSSD" calls)
    "nuScenes": dict(fps=[(4, 16384), (4, 4096), (4, 512)], ffps=[(4, 4096, 67), (4, 512, 131)],
                     ball_query=[16384, 4096, 1024, 512], sa_fused=[]),
    # the flagship with attention grouping at SA1 and SA2 (phase 17): their
    # ball queries are the attention queries, not K3
    "3DSSD attention": dict(fps=[(8, 16384), (8, 4096), (8, 512)],
                            ffps=[(8, 4096, 67), (8, 512, 131)], ball_query=[1024, 512],
                            sa_fused=[]),
    "nuScenes 65,536": dict(fps=[(1, 65536), (1, 4096), (1, 512)],
                            ffps=[(1, 4096, 67), (1, 512, 131)],
                            ball_query=[65536, 4096, 1024, 512], sa_fused=[]),
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

def ball_query_routes(name: str, pts, q, radii, ns, dilated: bool, plain: bool = True,
                      routes=("grid", "brute")) -> dict:
    """K3 on both routes (or on `routes`) against its plain version at one
    shape (idx and cnt equal), each route timed; the plain version timed too
    with `plain`."""
    specs = ring_specs(radii, ns, dilated)
    ref = ball_query_multi_plain(specs, pts, q)
    times = {}
    for route in routes:
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
        f"{' and '.join(routes)} (mean cnt {fill}); "
        + ", ".join(f"{r} {t:.4f} ms" for r, t in times.items())
        + (f" ({times['brute'] / times['grid']:.2f}x)" if len(times) == 2 else "")
        + f"; takes the {route} route" + (f"; plain {out['plain_ms']:.3f} ms" if plain else "")
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


HEAD_KEYS = ("cls", "offset", "angle_cls", "angle_res", "attribute", "velocity")


def compare_with_cpu(scan: torch.Tensor, dtype: str, state_dict: dict | None = None,
                     bf16_tol: float = BF16_TOL, build=None) -> bool:
    """Kernel path on the card against the plain path on the CPU for one
    scan, with seeded weights or those of `state_dict`, of the flagship or
    of `build(dtype) -> (cfg, model on the card, spec)`. Continuous values
    are held to the tolerance (F32_TOL, or `bf16_tol` at bf16) wherever the
    two runs took the same discrete decisions (sampling picks, heading bins,
    NMS keeps); returns whether they took every one of them alike."""
    cfg, gmodel, gspec = (build(dtype) if build else
                          flagship(device="cuda", seed=0, compute_dtype=dtype)[:3])
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
    for key in (k for k in HEAD_KEYS if k in cout):
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
    for key in ("velocity", "attribute"):  # nuScenes: gathered by the source point
        if key in cdet:
            _close(f"{dtype} kept {key}", gdet[key][0, rows[0]].float().cpu(),
                   cdet[key][0, rows[1]].float(), tol)
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

def _train_grads(model, spec, cfg, batch, replay: Decisions | None):
    """One f32 loss + backward, under `replay` where given; -> (loss dict,
    outputs, grads, BN stats)."""
    outputs = {}
    hook = model.register_forward_hook(lambda mod, args, out: outputs.update(out))
    with replay.patched() if replay else contextlib.nullcontext():
        # a batch of the device augmentation comes augmented (phase 15)
        graph = dataclasses.replace(TrainGraph.build(cfg, model, spec), aug_cfg=None)
        total, losses = graph.compute_losses(batch, bn_momentum(cfg.SOLVER, 0))
        total.backward()
    hook.remove()
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    stats = {k: v.detach().cpu() for k, v in model.named_buffers()
             if k.endswith((".mean", ".var"))}
    return {k: v.item() for k, v in losses.items()}, outputs, grads, stats


def phase_train_card_vs_cpu(opts=()) -> None:
    """Phase 6; with `opts` (TRAIN_OPTIONS) phase 15's: the device
    augmentation runs on both legs on the same draws and is compared, and
    both legs' steps then take the card's augmented batch."""
    n_scans = 2
    log(f"== phase {15 if opts else 6}: one f32 train step, card against CPU, {n_scans} scans of "
        f"{N_POINTS} points, same weights" + (", the training options" if opts else ""))
    cfg, gmodel, spec, n = flagship(device="cuda", seed=0, compute_dtype="float32", opts=opts)
    data = {k: torch.from_numpy(v) for k, v in synthetic_scenes(n_scans, n).items()}
    if opts:
        data = augmented_card_vs_cpu(cfg, data, n)
    hold_train_step_to_cpu(cfg, gmodel, spec, data)


def hold_train_step_to_cpu(cfg, gmodel, spec, data: dict, kinds=TRAIN_DECISIONS) -> None:
    """One f32 loss and backward of `gmodel` (on the card, f32) on the CPU
    batch `data`, card against a CPU copy of the same state, the card's
    discrete decisions of `kinds` replayed on the CPU leg (`Decisions`, the
    card's balls also held to the plain version): picks, losses, every
    gradient leaf and the new BatchNorm statistics."""
    cmodel = copy.deepcopy(gmodel).cpu()
    gmodel2 = copy.deepcopy(gmodel)  # the same state, for a second card step
    gmodel.train()
    gmodel2.train()
    cmodel.train()
    replay = Decisions(kinds=kinds, plain=True)
    t0 = time.perf_counter()
    g_losses, g_out, g_grads, g_stats = _train_grads(
        gmodel, spec, cfg, {k: v.cuda() for k, v in data.items()}, replay)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    replay.recording = False
    c_losses, c_out, c_grads, c_stats = _train_grads(cmodel, spec, cfg, data, replay)
    log(f"  card {t1 - t0:.2f} s, CPU {time.perf_counter() - t1:.2f} s")
    check(replay.consumed(), f"the legs took different numbers of decisions: {replay.pos}")
    # reported, not held: K5 no longer varies from run to run, but cuBLAS and
    # the BatchNorm reductions are not bound to one order
    grads2 = _train_grads(gmodel2, spec, cfg, {k: v.cuda() for k, v in data.items()}, None)[2]
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
        + ", ".join(f"{k} {replay.differ[k]} of {replay.total[k]}" for k in replay.kinds)
        + f"; a differing ball's nearest moved point within {replay.ball_gap:.3g} of r^2 of a bound")
    vote_err = float((g_out["vote_offset"][0].cpu() - c_out["vote_offset"][0]).detach().abs().max())
    log(f"  vote offsets (the CG layer's centres): max |card - CPU| {vote_err:.3g}")
    # a loss of 0 (no entries to average) has no gradient to compare
    dead = [k for k in c_losses if not (g_losses[k] > 0 and c_losses[k] > 0)]
    if dead:
        log("  losses that read 0, card / CPU: " + "; ".join(
            f"{k} {g_losses[k]:.6g} / {c_losses[k]:.6g}" for k in dead))
    check(not dead, f"losses {dead} are not above 0 on both legs, so they compare nothing")
    loss_err = {k: abs(g_losses[k] - c_losses[k]) / abs(c_losses[k]) for k in c_losses}
    log("  losses, card / CPU (relative difference): " + "; ".join(
        f"{k} {g_losses[k]:.6f} / {c_losses[k]:.6f} ({loss_err[k]:.2g})" for k in c_losses))
    grad_err = []
    for name, cg in c_grads.items():
        err = float((g_grads[name] - cg).abs().max())
        scale = cg
        if name.endswith("conv.bias") and (name[:-9] + "bn.scale" in c_grads or (
                name[:-9] + "gn.scale" in c_grads and cg.numel() <= 32)):
            # a Dense bias ahead of BatchNorm (or of a GroupNorm of one
            # channel a group) has a true gradient of 0 (the mean takes it
            # out): rounding on both sides, held against the same layer's
            # kernel gradient
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
    path's kernels: D-FPS (RPN SA1-SA4, RCNN SA1-SA2), F-FPS (none; 3DSSD's
    SA2 and SA3 on nuScenes, phase 16), ball query, row
    gather (RPN grouping; RegionPool's xyz, features and mask), three_nn
    (the four FP layers) and fused SA (RCNN SA1, SA2); and the inputs of the
    RCNN's SA modules `sa_layers`. Each kind's calls are held to its
    kernel's launches in that forward, so no launch goes unrecorded."""
    kinds = {"fps": (modules, "farthest_point_sample"),
             "ffps": (modules, "farthest_point_sample_features"),
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


def check_path_kernels(report: list[dict], seen: dict, what: str, names, pool_widths=(),
                       fps_routes=("block", "cluster"), timed: bool = False) -> None:
    """K1, K2, K3 and K4 against their plain versions on the card, at every
    call of one forward captured by `capture_two_stage_inputs` (phase 2
    holds them at 3DSSD's KITTI shapes). K1 on `fps_routes` (past 16,384
    points on the slice route alone), K2 on each route its shape admits
    (picks equal), K3 on both routes (brute force alone past the grid's
    16,384 points) at the ball queries `names`, K4 bit for bit. K4 is timed
    against torch.gather at the RoI pooler's gathers, the forward's last,
    of widths `pool_widths`, or at the first gather where the path has no
    pooler; with `timed`, K1's and K2's routes and K3's plain version are
    timed too. The shapes and times go into the report's entries, named
    after `what`."""
    by_name = {e["name"]: e for e in report}
    shapes = []
    for (xyz, m), _ in seen["fps"]:
        b, n = xyz.shape[:2]
        plain = fps_plain(xyz, m)
        routes = fps_routes if n <= 16384 else ("slice",)
        times = {}
        for route in routes:
            with on_route(route):
                check(torch.equal(farthest_point_sample(xyz, m), plain),
                      f"{what}: D-FPS {route} route disagrees with plain at {[b, n]} -> {m}")
                if timed:
                    times[route] = cuda_ms(lambda: farthest_point_sample(xyz, m), 5)
        shape = f"{[b, n, 3]} -> {m}"
        shapes.append(f"{shape} ({fps_route(b, n)})")
        if timed:
            by_name["fps"]["routes"][f"{what} {shape}"] = dict(
                route=fps_route(b, n), times=times,
                **bound(4 * (b * n * 3 + b * m), b * (m - 1) * n * 10))
            log(f"K1 D-FPS {what} {shape}: " + ", ".join(f"{r} {t:.4f} ms"
                                                       for r, t in times.items()))
    log(f"K1 D-FPS at {what}'s {len(shapes)} calls, picks equal on "
        f"{', '.join(fps_routes)} (slice past 16,384 points): {', '.join(shapes)}")
    for (fused, m), _ in seen["ffps"]:
        b, n, c = fused.shape
        plain = ffps_plain(fused, m)
        routes = [r for r, ok in (("cluster", sampling.ffps_cluster_size(b, n, c)),
                                  ("block", sampling.ffps_block_fits(n, c)),
                                  ("stream", True)) if ok]
        times = {}
        for route in routes:
            with on_ffps_route(route):
                check(torch.equal(farthest_point_sample_features(fused, m), plain),
                      f"{what}: F-FPS {route} route disagrees with plain at {[b, n, c]} -> {m}")
                if timed:
                    times[route] = cuda_ms(lambda: farthest_point_sample_features(fused, m), 5)
        short = fps_pick_shortfall(fused, plain)
        check(short <= FFPS_TIE_RTOL, f"{what}: F-FPS pick {short:.3g} below the farthest point")
        shape = f"{[b, n, c]} -> {m}"
        if timed:
            by_name["ffps"]["routes"][f"{what} {shape}"] = dict(
                route=sampling.ffps_route(b, n, c), times=times,
                **bound(4 * (b * n * c + b * m), b * (m - 1) * n * (3 * c + 2)))
        log(f"K2 F-FPS {what} {shape} ({fused.dtype}): picks equal to plain on "
            f"{', '.join(routes)}; " + ", ".join(f"{r} {t:.4f} ms" for r, t in times.items())
            + f"; takes the {sampling.ffps_route(b, n, c)} route")
    check(len(seen["ball_query"]) == len(names), f"{len(seen['ball_query'])} ball queries")
    for name, ((radii, ns, xyz, new_xyz), kwargs) in zip(names, seen["ball_query"]):
        n, dilated = xyz.shape[1], kwargs.get("dilated", False)
        if grouping.ball_query_route(n) == "grid":
            specs = ring_specs(radii, ns, dilated)
            log(f"K3 at {what} {name}: grid cell {grid_cell_edge(xyz, specs):.3f} m for an outer "
                f"radius of {max(radii)} m (least cell {grouping.grid_cell_min(specs):.3f} m, at "
                f"most {grouping.grid_cell_cap(n)} cells a cloud)")
        by_name["ball_query"]["routes"][f"{what} {name}"] = ball_query_routes(
            f"{what} {name}", xyz, new_xyz, radii, ns, dilated, plain=timed and n <= 16384,
            routes=("grid", "brute") if n <= 16384 else ("brute",))
    n_gather = len(seen["gather"])
    pool = range(n_gather - len(pool_widths), n_gather)
    check([seen["gather"][k][0][0].shape[2] for k in pool] == list(pool_widths),
          f"the RoI pooler's gathers are not the forward's last {len(pool)}")
    timed_at = pool if pool_widths else range(1)
    shapes = []
    for k, ((src, idx), _) in enumerate(seen["gather"]):
        got, ref = grouping._gather_rows(src, idx), gather_rows_plain(src, idx)
        check(got.dtype == ref.dtype and torch.equal(got.view(torch.int32), ref.view(torch.int32)),
              f"{what}: gather not bit-identical at {list(src.shape)} x {idx.shape[1]} rows")
        shape = f"{list(src.shape)} x {idx.shape[1]} rows"
        shapes.append(shape)
        if k in timed_at:
            wide = idx.long().clamp(0, src.shape[1] - 1)[..., None].expand(-1, -1, src.shape[2])
            b, rows, c = idx.shape[0], idx.shape[1], src.shape[2]
            t = dict(ms=cuda_ms(lambda: grouping._gather_rows(src, idx), 20),
                     plain_ms=cuda_ms(lambda: gather_rows_plain(src, idx), 20),
                     library_ms=cuda_ms(lambda: src.gather(1, wide), 20),
                     **bound(4 * (b * min(rows, src.shape[1]) * c + b * rows + b * rows * c), 0))
            by_name["gather"]["other_shapes"][f"{what} {shape}"] = t
            log(f"K4 gather {what} {shape}: {t['ms']:.4f} ms vs torch.gather "
                f"{t['library_ms']:.4f} ms (K4 / torch.gather {t['ms'] / t['library_ms']:.2f}), "
                f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms")
    log(f"K4 gather at {what}'s {len(shapes)} calls, bit-identical: {', '.join(shapes)}")


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
    check_path_kernels(report, seen, "PointRCNN", TWO_STAGE_SA_NAMES, (3, 128, 1))
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

    KINDS = ("roi_points", "fps", "ball_query", "voxels")
    FACE_TOL = 1e-4  # metres
    RADIUS_RTOL = 1e-5
    VOXEL_TOL = 1e-4  # grid units: how near a voxel face a point's id may differ

    def __init__(self):
        self.recording = True
        self.log = {k: [] for k in self.KINDS}
        self.pos = dict.fromkeys(self.KINDS, 0)
        self.differ = dict.fromkeys(self.KINDS, 0)
        self.total = dict.fromkeys(self.KINDS, 0)
        self._roi = two_stage.query_boxes_3d_points
        self._fps = modules.farthest_point_sample
        self._ball = modules.ball_query_multi
        self._voxels = two_stage.PointsPool.voxel_ids

    def patches(self):
        replay = self
        return (mock.patch.object(two_stage, "query_boxes_3d_points", self.roi_points),
                mock.patch.object(modules, "farthest_point_sample", self.fps),
                mock.patch.object(modules, "ball_query_multi", self.ball_query),
                mock.patch.object(two_stage.PointsPool, "voxel_ids",
                                  lambda pool, canonical, size: replay.voxels(pool, canonical,
                                                                              size)))

    def voxels(self, pool, canonical, size):
        """STD's voxel ids: the CPU takes the card's, each one it would have
        given otherwise a point within VOXEL_TOL of a voxel face."""
        own = self._voxels(pool, canonical, size)
        if self.recording:
            self.log["voxels"].append(own.cpu())
            return own
        card = self._next("voxels")
        differ = card != own
        self.differ["voxels"] += int(differ.sum())
        self.total["voxels"] += differ.numel()
        if differ.any():
            gl, gh, gw, _ = pool.grid
            f = torch.stack([(canonical[..., 0] / size[..., None, 0] + 0.5) * gl,
                             (canonical[..., 1] / size[..., None, 1] + 1.0) * gh,
                             (canonical[..., 2] / size[..., None, 2] + 0.5) * gw], -1)
            near = ((f - f.round()).abs() <= self.VOXEL_TOL).any(-1)
            check(bool(near[differ].all()), "a voxel id differs between card and CPU away "
                  "from a voxel face")
        return card

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


def phase_two_stage_card_vs_cpu(scans: torch.Tensor, config: str = "pointrcnn") -> None:
    name = {"pointrcnn": "PointRCNN", "std": "STD"}[config]
    log(f"== phase {9 if config == 'pointrcnn' else 13}: {name} card against CPU, one scan of "
        f"{N_POINTS} points, f32")
    if config == "pointrcnn":
        _, gmodel, rpn_spec, rcnn_spec, _ = pointrcnn(device="cuda", seed=0)
    else:
        _, pipe = std(device="cuda", seed=0)
        gmodel, rpn_spec, rcnn_spec = pipe.model, pipe.rpn_spec, pipe.rcnn_spec
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
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack, torch.inference_mode():
        for patch in rep.patches():
            stack.enter_context(patch)
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
    if config == "std":
        # both legs build the voxel lattice from the card's proposals with
        # the same arithmetic, so its tied D-FPS picks fall alike
        check(rep.differ["fps"] == 0, f"{rep.differ['fps']} of STD's RCNN D-FPS calls picked "
              "otherwise on the CPU")
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

        def counted_step(graph, state, batch, *args):
            before = _build.launches()
            out = real_step(graph, state, batch, *args)
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


# ----------------------------------------------------------------- phase 11

# timed steps of each PointRCNN training stage, after a warm-up step
TWO_STAGE_STEPS = 5
# the stage-wise CLI chain: scans written, iterations of each stage
CLI_TWO_STAGE_SCANS, CLI_TWO_STAGE_VAL, CLI_TWO_STAGE_ITERS = 8, 4, 6
# A stage-2 IoU mask entry that differs between card and CPU (on the same
# proposals) must have its IoU within this of a threshold, or its distance
# within this of the sample range.
IOU_TIE = 1e-6
STAGE_CFG = {stage: POINTRCNN_CFG.parent / f"pointrcnn_stage{stage}.yaml" for stage in (1, 2)}
STD_STAGE2_CFG = STD_CFG.parent / "std_stage2.yaml"
TWO_STAGE_LOSS_KEYS = {1: ("cls", "offset", "angle"), 2: ("cls", "offset", "angle", "corner")}


def run_stage(step, batch: dict, what: str, path: str) -> tuple[dict, list]:
    """A warm-up step with the launch counts from 0, then TWO_STAGE_STEPS
    timed steps and a profiled one -> (the warm-up step's launches with
    their routes, every step's metrics)."""
    _build.reset_launches()
    first = step(batch)
    torch.cuda.synchronize()
    launches = _build.launches()
    log(f"kernel launches in one {what} step: {launches}")
    check(all(launches[k] > 0 for k in ("fps", "ball_query", "gather", "three_nn", "scatter_add")),
          f"{what}: a kernel of the path was not launched: {launches}")
    check(launches["ffps"] == 0 and launches["sa_fused"] == 0,
          f"{what} launched F-FPS or the fused SA (inference only)")
    launches["routes"] = check_routes(what, path)
    torch.cuda.reset_peak_memory_stats()
    metrics, times = [], []
    for _ in range(TWO_STAGE_STEPS):
        t0 = time.perf_counter()
        metrics.append(step(batch))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    metrics = [first] + metrics
    for m in metrics:
        check(all(np.isfinite(float(v)) for v in m.values()), f"{what}: a metric is not finite: {m}")
    wall, busy = profile_once(lambda: step(batch), f"{what} step at batch {TWO_STAGE_BATCH}",
                              top=10)
    step_ms = statistics.median(times)
    log(f"{what} at batch {TWO_STAGE_BATCH}: median step {step_ms:.2f} ms (min "
        f"{min(times):.2f}, max {max(times):.2f}) over {TWO_STAGE_STEPS} steps; "
        f"{TWO_STAGE_BATCH * 1e3 / step_ms:.2f} training scans/s; device busy "
        f"{busy:.2f} ms of a profiled {wall:.2f} ms step (host share "
        f"{100 * (1 - busy / wall):.1f}%); peak memory {peak:.2f} GiB")
    log(f"{what} totals by step: " + ", ".join(f"{float(m['total']):.4f}" for m in metrics))
    return launches, metrics


def check_train_kernels(seen: dict, k5_calls: list, report: list[dict]) -> None:
    """K1, K3 and K4 against their plain versions at every call of one
    stage-2 step, and K5 at the step's backward's index tensors; the RCNN's
    shapes (batch x minibatch clouds of NUM_OBJECT_POINT points) timed, into
    the report's entries as `two_stage_train_shapes`."""
    entry = {e["name"]: e for e in report}
    shapes = {k: {} for k in ("fps", "ball_query", "gather", "scatter_add")}
    for (xyz, npoint), _ in seen["fps"]:
        b, n = xyz.shape[:2]
        plain = fps_plain(xyz, npoint)
        for route in ("block", "cluster"):
            with on_route(route):
                check(torch.equal(farthest_point_sample(xyz, npoint), plain),
                      f"D-FPS {route} route disagrees with plain at {list(xyz.shape)} -> {npoint}")
        if b > TWO_STAGE_BATCH:  # the RCNN's
            name = f"{list(xyz.shape)} -> {npoint}"
            shapes["fps"][name] = dict(
                route=fps_route(b, n), ms=cuda_ms(lambda: farthest_point_sample(xyz, npoint), 20),
                plain_ms=cuda_ms(lambda: fps_plain(xyz, npoint), 3),
                **bound(4 * (b * n * 3 + b * npoint), b * (npoint - 1) * n * 10))
            log(f"K1 D-FPS RCNN {name}: picks equal on both routes; {shapes['fps'][name]}")
    log(f"K1 D-FPS at the step's {len(seen['fps'])} calls, picks equal on both routes")
    for k, ((radii, ns, xyz, new_xyz), kwargs) in enumerate(seen["ball_query"]):
        if xyz.shape[0] > TWO_STAGE_BATCH:
            out = ball_query_routes(f"RCNN SA{k - 3}", xyz, new_xyz, radii, ns,
                                    kwargs.get("dilated", False))
            shapes["ball_query"][out["shape"]] = out
        else:  # the RPN's, held as phase 7 holds them
            specs = ring_specs(radii, ns, kwargs.get("dilated", False))
            for (gi, gc), (pi, pc) in zip(ball_query_multi(radii, ns, xyz, new_xyz,
                                                           dilated=kwargs.get("dilated", False)),
                                          ball_query_multi_plain(specs, xyz, new_xyz)):
                check(torch.equal(gi, pi) and torch.equal(gc, pc),
                      f"ball query differs from plain at {list(new_xyz.shape)}")
    for (src, idx), _ in seen["gather"]:
        got, ref = grouping._gather_rows(src, idx), gather_rows_plain(src, idx)
        check(got.dtype == ref.dtype and torch.equal(got.view(torch.int32), ref.view(torch.int32)),
              f"gather not bit-identical at {list(src.shape)} x {idx.shape[1]} rows")
        if src.shape[0] > TWO_STAGE_BATCH and src.dtype == torch.float32:
            b, rows, c = idx.shape[0], idx.shape[1], src.shape[2]
            name = f"{list(src.shape)} x {rows} rows"
            wide = idx.long().clamp(0, src.shape[1] - 1)[..., None].expand(-1, -1, c)
            shapes["gather"][name] = dict(
                ms=cuda_ms(lambda: grouping._gather_rows(src, idx), 20),
                plain_ms=cuda_ms(lambda: gather_rows_plain(src, idx), 20),
                library_ms=cuda_ms(lambda: src.gather(1, wide), 20),
                **bound(4 * (b * min(rows, src.shape[1]) * c + b * rows + b * rows * c), 0))
            log(f"K4 gather RCNN {name}: bit-identical; {shapes['gather'][name]}")
    log(f"K4 gather at the step's {len(seen['gather'])} calls, bit-identical")
    for i, (idx, g, n) in enumerate(k5_calls):
        out = k5_check(f"stage-2 backward call {i}: {g.shape[0]} x {g.shape[1]} x {g.shape[2]} "
                       f"into {n}", idx, g, n)
        shapes["scatter_add"][out["shape"]] = out
    for name, by_shape in shapes.items():
        entry[name]["two_stage_train_shapes"] = by_shape


class StageTwoReplay:
    """The card leg's stage-2 decisions outside the RCNN, handed to the CPU
    leg: the proposal NMS's keep sets (the CPU takes the card's proposals
    after its own keep set is held to the card's, each difference a near-tie
    on the CPU's values, as phase 9 holds them), the pooler's context mask
    (a point within FACE_TOL of a grown proposal's face) and the IoU
    assignment on the card's proposals (an IoU within IOU_TIE of a
    threshold). The stage-1 assignment takes raw points on both legs and
    must agree."""

    FACE_TOL = RoIReplay.FACE_TOL

    def __init__(self, graph):
        self.graph = graph
        self.recording = True
        self.log = {"propose": [], "mask": [], "assign": []}
        self.pos = dict.fromkeys(self.log, 0)
        self.differ = dict.fromkeys(self.log, 0)
        self._propose = two_stage.StageSpec.propose
        self._mask = two_stage_step.query_boxes_3d_mask
        self._assign = two_stage_step.assign_targets

    def patches(self):
        return (mock.patch.object(two_stage.StageSpec, "propose",
                                  lambda spec, outputs: self.propose(spec, outputs)),
                mock.patch.object(two_stage_step, "query_boxes_3d_mask", self.mask),
                mock.patch.object(two_stage_step, "assign_targets", self.assign))

    def _next(self, kind):
        card = self.log[kind][self.pos[kind]]
        self.pos[kind] += 1
        return card

    def propose(self, spec, outputs):
        own = self._propose(spec, outputs)
        if self.recording:
            self.log["propose"].append((tuple(t.cpu() for t in own),
                                        {k: v.cpu() for k, v in outputs.items()
                                         if torch.is_tensor(v)}))
            return own
        card, gout = self._next("propose")
        g_keep, g_top, _, _ = proposal_keeps(spec, gout)
        c_keep, c_top, c_score, c_bev = proposal_keeps(spec, outputs)
        flips = bin_flips(spec.coder, gout, outputs, F32_TOL)
        cut = float(c_score.sort(descending=True).values[spec.nms_pre_topk - 1])
        self.differ["propose"] += keeps_differ_at_ties(
            "stage-2 proposal NMS", g_keep, c_keep, c_score, c_bev, spec.nms_threshold, flips[0],
            torch.unique(torch.cat([g_top, c_top])), cut=cut, cap=spec.max_output)
        return card

    def mask(self, xyz, boxes):
        own = self._mask(xyz, boxes)
        if self.recording:
            self.log["mask"].append(own.cpu())
            return own
        card = self._next("mask")
        differ = card != own
        self.differ["mask"] += int(differ.sum())
        if differ.any():
            grown = torch.cat([boxes[..., :3], boxes[..., 3:6] + 2 * self.FACE_TOL,
                               boxes[..., 6:]], -1)
            shrunk = torch.cat([boxes[..., :3], boxes[..., 3:6] - 2 * self.FACE_TOL,
                                boxes[..., 6:]], -1)
            grown[..., 1] += self.FACE_TOL
            shrunk[..., 1] -= self.FACE_TOL
            near = (self._mask(xyz, grown) != self._mask(xyz, shrunk))
            check(bool(near[differ].all()), "a context-mask point differs between card and CPU "
                  "away from a proposal face")
        return card

    def assign(self, cfg, points, anchors, gt_boxes, gt_labels, valid_mask=None, uniforms=None):
        own = self._assign(cfg, points, anchors, gt_boxes, gt_labels, valid_mask=valid_mask,
                           uniforms=uniforms)
        if self.recording:
            self.log["assign"].append({k: v.cpu() for k, v in own.items()})
            return own
        card = self._next("assign")
        differ = (card["pmask"] != own["pmask"]) | (card["nmask"] != own["nmask"])
        self.differ["assign"] += int(differ.sum())
        if differ.any():
            check(cfg.method == "IoU", "the stage-1 (Mask) assignment differs between card and CPU")
            # each differing anchor's IoU with its assigned box on the CPU lies
            # at a threshold, or its distance at the sample range
            from ssd3d_torch.core.iou import boxes_iou_bev_3d
            b, p, c = anchors.shape[:3]
            _, iou = boxes_iou_bev_3d(anchors.reshape(b, p * c, 7), gt_boxes)
            iou = iou.gather(-1, own["assigned_idx"][:, :, None].expand(b, p * c, 1)).reshape(b, p, c)
            dist = (anchors[..., 0:3] - own["gt_boxes"][..., 0:3]).norm(dim=-1)
            near = torch.zeros_like(differ)
            for thr in (cfg.pos_iou, cfg.neg_iou, assigner.MIN_NEG_IOU):
                near |= (iou - thr).abs() <= IOU_TIE
            near |= (dist - cfg.effective_sample_range).abs() <= IOU_TIE
            # a subset drawn from a candidate set that a near-tie changed may
            # part anywhere: held only where no candidate of the scan is near
            scan_near = near.flatten(1).any(1)
            check(bool(scan_near[differ.flatten(1).any(1)].all()),
                  "an IoU mask entry differs between card and CPU away from every threshold")
        return {k: v.cpu() for k, v in card.items()}


def counting_minibatch(rois: list):
    """A patch of `TwoStageGraph.stage2_targets` that appends to `rois`, at
    each call, the minibatch slots a scan holding a positive RoI and those
    holding a negative one."""
    real = TwoStageGraph.stage2_targets

    def counted(graph, *args):
        proposals, targets = real(graph, *args)
        rois.append(((targets["pmask"] > 0).any(-1).sum(-1).tolist(),
                     (targets["nmask"] > 0).any(-1).sum(-1).tolist()))
        return proposals, targets

    return mock.patch.object(TwoStageGraph, "stage2_targets", counted)


def _stage_grads(graph, model, batch: dict, uniforms, patches) -> tuple:
    """One f32 loss + backward of a two-stage graph on `model` -> (loss
    dict, the gradients of the trained parameters, BatchNorm statistics)."""
    g = dataclasses.replace(graph, model=model)
    trained = {id(p) for p in trained_parameters(model, graph.train_param_prefix)}
    with contextlib.ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        total, losses = g.compute_losses(batch, bn_momentum(graph.solver_cfg, 0), uniforms)
        total.backward()
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()
             if id(p) in trained and p.grad is not None}
    stats = {k: v.detach().cpu() for k, v in model.named_buffers() if k.endswith((".mean", ".var"))}
    return {k: v.item() for k, v in losses.items()}, grads, stats


def two_stage_card_vs_cpu(stage: int, weights: dict, data: dict) -> None:
    """One f32 step of a stage on the batch `data` (tensors on the CPU),
    card against CPU, the same weights and the same stage-2 draws; the
    card's discrete decisions replayed on the CPU leg. Stage 2's minibatch
    must hold positive and negative RoIs and every stage-2 loss be live, so
    that the Bin-Anchor encode, the bin offset and corner losses and their
    gradients are compared."""
    cfg = load_cfg(str(STAGE_CFG[stage]))
    pipe = build_pipeline(cfg, device="cuda")
    pipe.model.load_state_dict(weights)
    graph = pipe.graph
    gmodel = pipe.model.train()
    cmodel = copy.deepcopy(gmodel).cpu()
    n_scans = data["points"].shape[0]
    uniforms = (torch.rand(n_scans, 2, graph.rpn_spec.max_output,
                           generator=torch.Generator().manual_seed(3))
                if stage == 2 else None)
    decisions = Decisions(kinds=TRAIN_DECISIONS if stage == 1 else ("relu", "max_pool"),
                          plain=True)
    rois, two = RoIReplay(), StageTwoReplay(graph)
    minibatch = []
    patches = (decisions.patches() if stage == 1 else
               [*decisions.patches(), *rois.patches(), *two.patches(),
                counting_minibatch(minibatch)])
    t0 = time.perf_counter()
    g_losses, g_grads, g_stats = _stage_grads(
        graph, gmodel, {k: v.cuda() for k, v in data.items()},
        uniforms.cuda() if uniforms is not None else None, patches)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    decisions.recording = rois.recording = two.recording = False
    c_losses, c_grads, c_stats = _stage_grads(graph, cmodel, data, uniforms, patches)
    log(f"  stage {stage}: card {t1 - t0:.2f} s, CPU {time.perf_counter() - t1:.2f} s")
    kinds = [(decisions, decisions.kinds)]
    if stage == 2:
        kinds += [(rois, rois.KINDS), (two, tuple(two.log))]
    for rep, names in kinds:
        check(all(rep.pos[k] == len(rep.log[k]) for k in names),
              f"stage {stage}: the legs took different numbers of decisions: {rep.pos}")
    log(f"  stage {stage}: decisions the CPU would have taken otherwise, each a near-tie (the "
        "card's taken): " + ", ".join(f"{k} {rep.differ[k]}" for rep, names in kinds for k in names))
    scale = max(abs(v) for v in c_losses.values())
    loss_err = {k: abs(g_losses[k] - c_losses[k]) / scale for k in c_losses}
    log(f"  stage {stage} losses, card / CPU (difference over the largest loss): " + "; ".join(
        f"{k} {g_losses[k]:.6f} / {c_losses[k]:.6f} ({loss_err[k]:.2g})" for k in c_losses))
    grad_err = []
    check(set(g_grads) == set(c_grads) and c_grads, f"stage {stage}: gradient leaves differ")
    for name, cg in c_grads.items():
        ref = cg
        if name.endswith("conv.bias") and name[:-9] + "bn.scale" in c_grads:
            ref = c_grads[name[:-4] + "kernel"]  # rounding on both sides, as in phase 6
        err = float((g_grads[name] - cg).abs().max())
        grad_err.append((err / max(float(ref.abs().max()), 1e-30), name))
    grad_err.sort(reverse=True)
    log(f"  stage {stage} gradient leaves furthest apart: "
        + "; ".join(f"{name} {r:.3g}" for r, name in grad_err[:4]))
    stats_err = sorted(((float((g_stats[k] - v).abs().max()) / max(float(v.abs().max()), 1e-30),
                         k) for k, v in c_stats.items()), reverse=True)
    if stage == 2:
        check(len(minibatch) == 2 and minibatch[0] == minibatch[1],
              f"stage 2: the legs' minibatches differ: {minibatch}")
        pos, neg = minibatch[0]
        log(f"  stage 2 minibatch slots a scan holding a positive / a negative RoI: {pos} / {neg}")
        check(sum(pos) > 0 and sum(neg) > 0,
              "stage 2: the compared minibatch holds no positive or no negative RoI")
        live = [k for k in c_losses if k.startswith("loss_stage1/")]
        check(len(live) == len(TWO_STAGE_LOSS_KEYS[2])
              and all(g_losses[k] > 0 and c_losses[k] > 0 for k in live),
              f"stage 2: a stage-2 loss is not live in the compared step: {c_losses}")
    for key, r in loss_err.items():
        check(r <= F32_TOL, f"stage {stage}: loss {key} differs by {r:.3g} of the largest")
    for r, name in grad_err:
        check(r <= TRAIN_GRAD_TOL, f"stage {stage}: gradient {name} differs by {r:.3g}")
    for r, name in stats_err:
        check(r <= F32_TOL, f"stage {stage}: running statistic {name} differs by {r:.3g}")
    log(f"  stage {stage}: {len(c_losses)} losses within {F32_TOL:g} of the largest, "
        f"{len(c_grads)} gradient leaves within {TRAIN_GRAD_TOL:g} of their largest entry, "
        f"{len(c_stats)} running statistics within {F32_TOL:g}")


def phase_two_stage_training(report: list[dict]) -> dict:
    """-> the launches of one step of each stage and of the stage-wise CLI
    chain; K1, K3, K4 and K5 at stage 2's shapes go into `report`."""
    log(f"== phase 11: PointRCNN stage-wise training, batch {TWO_STAGE_BATCH}, {N_POINTS} "
        "points, f32, Adam (pointrcnn_stage1.yaml, then pointrcnn_stage2.yaml)")
    step1, batch = two_stage_train_entry(device="cuda", stage=1, batch=TWO_STAGE_BATCH, seed=0)
    state1 = step1.args[0]
    stats1 = {k: v.clone() for k, v in state1.model.named_buffers() if k.startswith("rpn")}
    launches1, m1 = run_stage(step1, batch, "PointRCNN stage 1", "PointRCNN stage 1")
    check(all(f"loss_stage0/{k}" in m1[0] for k in TWO_STAGE_LOSS_KEYS[1])
          and not any(k.startswith("loss_stage1/") for k in m1[0]), f"stage 1 losses {sorted(m1[0])}")
    check(float(m1[-1]["total"]) < float(m1[0]["total"]), "stage 1's total loss did not fall")
    check(all(not torch.equal(v, stats1[k]) for k, v in state1.model.named_buffers()
              if k in stats1 and k.endswith(".mean")), "an RPN BatchNorm statistic did not move")

    step2, _ = two_stage_train_entry(device="cuda", stage=2, batch=TWO_STAGE_BATCH, seed=0)
    state2 = step2.args[0]
    state2.model.load_state_dict(state1.model.state_dict())  # stage 2 starts from stage 1
    frozen = {k: v.clone() for k, v in state2.model.named_parameters() if k.startswith("rpn")}
    trained = {k: v.clone() for k, v in state2.model.named_parameters()
               if k.startswith(("rcnn", "roi"))}
    rpn_stats = {k: v.clone() for k, v in state2.model.named_buffers() if k.startswith("rpn")}
    rois = []
    with counting_minibatch(rois):
        launches2, m2 = run_stage(step2, batch, "PointRCNN stage 2", "PointRCNN stage 2")
    check(all(f"loss_stage1/{k}" in m2[0] for k in TWO_STAGE_LOSS_KEYS[2]),
          f"stage 2 losses {sorted(m2[0])}")
    for m in m2:
        stage2_total = sum(float(v) for k, v in m.items() if k.startswith("loss_stage1/"))
        check(abs(float(m["total"]) - stage2_total) <= 1e-5 * abs(stage2_total),
              "stage 2's total is not the sum of the RCNN's losses")
    log(f"stage-2 minibatch slots a scan holding a positive / a negative RoI (of "
        f"{step2.func.__self__.minibatch}; padding repeats a scan's first hit), step by step: "
        + "; ".join(f"{p} / {n}" for p, n in rois))
    params = dict(state2.model.named_parameters())
    check(all(torch.equal(params[k], v) for k, v in frozen.items()),
          "an rpn_* parameter moved in stage 2")
    check(all(not torch.equal(v, rpn_stats[k]) for k, v in state2.model.named_buffers()
              if k in rpn_stats and k.endswith(".mean")),
          "an RPN BatchNorm statistic did not move in stage 2 (the frozen RPN runs in train mode)")
    moved = sum(not torch.equal(params[k], v) for k, v in trained.items())
    check(moved > 0, "no RCNN parameter moved in stage 2")
    log(f"stage 2: all {len(frozen)} rpn_* parameters bit for bit stage 1's, every RPN "
        f"running mean moved, {moved} of {len(trained)} RCNN parameters moved")

    # the kernels at stage 2's shapes: the inputs of every launch of one step
    # (K1, K3, K4) and of every K5 launch of its backward
    seen = capture_two_stage_inputs(lambda _: step2(batch), batch["points"], ())
    k5_calls = []

    def recorded(idx, g, n):
        k5_calls.append((idx.detach().clone(), g.detach().clone(), n))
        return scatter_add_rows(idx, g, n)

    with mock.patch.object(grouping, "scatter_add_rows", recorded):
        step2(batch)
    check(len(k5_calls) == launches2["scatter_add"],
          f"recorded {len(k5_calls)} scatter-add calls, {launches2['scatter_add']} launches")
    check_train_kernels(seen, k5_calls, report)

    # stage 2 on the whole timed batch, whose minibatch holds positive RoIs
    # (a scan alone, its RPN normalised over itself, may hold none); stage 1,
    # whose losses are live on any scan, on its first scan (its CPU leg
    # takes ~15 s at batch 4)
    log(f"card against CPU, one f32 step of stage 1 on the timed batch's first scan and of "
        f"stage 2 on the timed batch of {TWO_STAGE_BATCH} scans, {N_POINTS} points each")
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    two_stage_card_vs_cpu(1, state1.model.state_dict(), {k: v[:1] for k, v in cpu_batch.items()})
    two_stage_card_vs_cpu(2, state1.model.state_dict(), cpu_batch)
    return {"two_stage_train_1": launches1, "two_stage_train_2": launches2,
            **phase_two_stage_cli()}


def phase_two_stage_cli(config: str = "pointrcnn") -> dict:
    """bin.train of stage 1, bin.train of stage 2 warm-started from it,
    bin.evaluate of the stage-2 run, on a synthetic KITTI tree -> the chain's
    launches. With config "std" stage 2 is `std_stage2.yaml`, its pooler
    must train, and `bin.evaluate` and `bin.test` of `std.yaml` follow from
    the stage-2 run's checkpoint."""
    std_run = config == "std"
    key = "cli_std" if std_run else "cli_two_stage"
    with tempfile.TemporaryDirectory(prefix="ssd3d_rcnn_cli_") as root:
        data, npz = os.path.join(root, "kitti"), os.path.join(root, "npz")
        synth.write_tree(data, n_train=CLI_TWO_STAGE_SCANS, n_val=CLI_TWO_STAGE_VAL,
                         n_points=CLI_SCAN_POINTS, seed=1)
        cfg1, cfg2 = str(STAGE_CFG[1]), str(STD_STAGE2_CFG if std_run else STAGE_CFG[2])
        opts = ["--device", "cuda",
                "DATASET.KITTI.BASE_DIR_PATH", data,
                "DATASET.KITTI.TRAIN_LIST", os.path.join(data, "train.txt"),
                "DATASET.KITTI.VAL_LIST", os.path.join(data, "val.txt"),
                "DATASET.KITTI.SAVE_NUMPY_PATH", npz,
                "TRAIN.CONFIG.MAX_ITERATIONS", str(CLI_TWO_STAGE_ITERS),
                "TRAIN.CONFIG.CHECKPOINT_INTERVAL", str(CLI_TWO_STAGE_ITERS),
                "TRAIN.CONFIG.SUMMARY_INTERVAL", "1"]
        for split in ("train", "val"):
            preprocess_cli.main(["--cfg", cfg1, "--img_list", split] + opts)
        run1, run2 = os.path.join(root, "stage1"), os.path.join(root, "stage2")

        def from_checkpoint():  # STD's inference config from the stage-2 run
            evaluate_cli.main(["--cfg", str(STD_CFG), "--log_dir", os.path.join(root, "eval"),
                               "--restore_model_path", os.path.join(run2, "ckpt"),
                               "--viz_scans", "0"] + opts)
            test_cli.main(["--cfg", str(STD_CFG), "--log_dir", run2] + opts)

        paths = {key: cli_launches(
            f"the stage-wise CLI chain of {config} (bin.train stage 1, stage 2, bin.evaluate"
            + (", bin.evaluate and bin.test of std.yaml)" if std_run else ")"),
            lambda: (train_cli.main(["--cfg", cfg1, "--log_dir", run1] + opts),
                     train_cli.main(["--cfg", cfg2, "--log_dir", run2,
                                     "--restore_model_path", run1] + opts),
                     evaluate_cli.main(["--cfg", cfg2, "--log_dir", run2, "--once",
                                        "--viz_scans", "0"] + opts),
                     from_checkpoint() if std_run else None))}
        n = paths[key]
        check(all(n[k] > 0 for k in ("fps", "ball_query", "gather", "three_nn", "scatter_add",
                                      "sa_fused")) and n["ffps"] == 0,
              f"the stage-wise chain launched {n}")
        with open(os.path.join(run2, "log_train.txt")) as f:
            check("warm start from" in f.read(), "stage 2 did not warm-start from stage 1")
        c1 = CheckpointManager(os.path.join(run1, "ckpt")).restore()[0]["model"]
        c2 = CheckpointManager(os.path.join(run2, "ckpt")).restore()[0]["model"]
        check(all(torch.equal(c1[k], c2[k]) for k in c1
                  if k.startswith("rpn") and not k.endswith((".mean", ".var"))),
              "the stage-2 run's rpn_* parameters are not stage 1's")
        for name, run in (("stage 1", run1), ("stage 2", run2)):
            m = _metrics(run)
            check([x["iter"] for x in m] == list(range(1, CLI_TWO_STAGE_ITERS + 1))
                  and all(np.isfinite(x["total"]) for x in m), f"{name}'s metrics: {m}")
            sec = [x["sec_per_it"] for x in m[1:]]
            wait = [x["loader_wait_s"] for x in m[1:]]
            log(f"CLI {name} at batch {TWO_STAGE_BATCH} (iterations 2-{CLI_TWO_STAGE_ITERS}): "
                f"median {statistics.median(sec):.4f} s/it; loader wait "
                f"{100 * sum(wait) / sum(sec):.1f}% of the time")
        with open(os.path.join(run2, f"eval_{CLI_TWO_STAGE_ITERS}.json")) as f:
            res = json.load(f)
        check(all(np.isfinite(res["Car"][m]).all() for m in ("image", "ground", "3d")),
              f"the stage-2 run's evaluation is not finite: {res}")
        log(f"stage-2 run, step {CLI_TWO_STAGE_ITERS}, Car 3D AP easy/moderate/hard "
            f"{'/'.join(f'{v:.2f}' for v in res['Car']['3d'])}")
        if std_run:
            # the pooler trained: its VFE left where the trainer's seeded init put it
            fresh = build_pipeline(load_cfg(cfg2), device="cpu").model
            init_weights(fresh, 0)
            init = fresh.state_dict()
            vfe = [k for k in c2 if k.startswith("roi_pool.vfe.") and k.endswith("kernel")]
            check(bool(vfe) and all(not torch.equal(c2[k], init[k]) for k in vfe),
                  "the STD pooler's VFE did not train in stage 2")
            outputs = sorted(os.listdir(run2))
            log(f"STD: the pooler's {len(vfe)} VFE kernels trained; bin.evaluate and bin.test "
                f"of std.yaml ran from the stage-2 checkpoint (run files: {outputs})")
    return paths


# ----------------------------------------------------------------- phase 12

# K2m: F-FPS over a given matrix at the TPU entries' two shape classes (the
# VMEM entry's [8, 1024, 1024] -> 256; the HBM entry's fusion-sampling
# segment [<= 16, 4096, 4096] -> 512), an odd n, a lattice whose every pick
# is a tie, and past the register tier's 16,384 points
FFPS_DIST_SHAPES = (("VMEM entry", 8, 1024, 256, "random"),
                    ("HBM entry", 8, 4096, 512, "fused"),
                    ("odd n", 3, 1000, 100, "random"),
                    ("lattice ties", 4, 1000, 200, "lattice"),
                    ("scratch tier", 1, 20000, 64, "random"))


def dist_matrix(kind: str, b: int, n: int, gen: torch.Generator, dev) -> torch.Tensor:
    """A [b, n, n] f32 matrix of squared distances: of random 5-channel
    vectors; of SA2-like fused vectors (xyz and 64 ReLU features); or of a
    10 x 10 x 10 integer lattice scaled by a power of two a cloud, whose
    distances are exact, so that from every pick many points tie."""
    if kind == "lattice":
        g = torch.stack(torch.meshgrid(*[torch.arange(10.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
        d = ((g[:, None] - g[None]) ** 2).sum(-1)
        return torch.stack([d * 2.0 ** k for k in range(b)]).to(dev)
    c = 67 if kind == "fused" else 5
    f = torch.randn(b, n, c, generator=gen).to(dev)
    if kind == "fused":
        f = torch.cat([f[..., :3] * 20, f[..., 3:].relu()], -1)
    return torch.cdist(f, f).square_()


def phase_ffps_dist(report: list[dict]) -> dict:
    """K2m against its plain version at FFPS_DIST_SHAPES, then the public op
    path that runs it -> the path's launches; K2m's entry into `report`."""
    log("== phase 12: K2m (F-FPS from a distance matrix) and the public op surface")
    dev, gen = torch.device(DEV), torch.Generator().manual_seed(12)
    shapes = {}
    for name, b, n, m, kind in FFPS_DIST_SHAPES:
        dist = dist_matrix(kind, b, n, gen, dev)
        want = fps_from_dist_plain(dist, m)
        got = public_ops.farthest_point_sample_from_dist(dist, m)
        check(torch.equal(got, want), f"K2m disagrees with plain at {name} {[b, n, n]} -> {m}")
        tied = 0
        if kind == "lattice":  # how many picks were ties on the plain loop's own values
            row = dist.gather(1, want.long()[:, :, None].expand(b, m, n))
            run = row.cummin(1).values[:, :-1]  # the running minimum before each pick
            top = run.amax(-1, keepdim=True)
            tied = int(((run == top).sum(-1) > 1).sum())
            check(tied >= b * (m - 1) // 2, f"only {tied} lattice picks were ties")
        ppt = sampling.ffps_dist_ppt(n)
        # bytes: the m rows read once and the picks written; operations: a
        # min and a compare a point and pick
        e = dict(shape=f"[{b}, {n}, {n}] -> {m}", tier="registers" if ppt else "global",
                 ms=cuda_ms(lambda: public_ops.farthest_point_sample_from_dist(dist, m), 5),
                 plain_ms=cuda_ms(lambda: fps_from_dist_plain(dist, m), 1),
                 **bound(4 * (b * m * n + b * m), 2 * b * m * n))
        shapes[name] = e
        log(f"K2m {name} {e['shape']} ({kind}): picks equal to plain"
            + (f", {tied} of {b * (m - 1)} picks ties" if kind == "lattice" else "")
            + f"; {e['tier']} tier; {e['ms']:.4f} ms ({1e3 * e['ms'] / m:.2f} us a pick) vs "
              f"plain {e['plain_ms']:.3f} ms; bound {e['bound_ms']:.4f} ms ({e['bound_by']}), "
              f"{100 * e['bound_ms'] / e['ms']:.1f}%")
        del dist
    main = shapes["HBM entry"]
    report.append(dict(name="ffps_dist", route="cuda", source="ssd3d_torch/csrc/ffps_dist.cu",
                       replaces="ssd3d/ops/pallas/fps.py:183 (ffps_pallas; ffps_pallas_hbm :291)",
                       launches=0, max_abs_err=0.0, ms=main["ms"], plain_ms=main["plain_ms"],
                       bound_ms=main["bound_ms"], bound_by=main["bound_by"], library_ms=None,
                       shape=f"HBM entry {main['shape']}",
                       other_shapes={k: v for k, v in shapes.items() if k != "HBM entry"},
                       check="picks equal to the plain loop's (fps_from_dist_plain)"))
    # the path: the public ops a user calls, over a scan's SA2 segment
    dist = dist_matrix("fused", BATCH, 4096, gen, dev)
    xyz = torch.from_numpy(synthetic_scenes(2, N_POINTS, seed=12)["points"][..., :3]).to(dev)
    _build.reset_launches()
    picks = public_ops.farthest_point_sample_from_dist(dist, 512)
    idx, cnt = public_ops.ball_query(0.8, 32, xyz, xyz[:, :1024].contiguous())
    didx, dcnt = public_ops.ball_query_dilated(0.4, 0.8, 32, xyz, xyz[:, :1024].contiguous())
    torch.cuda.synchronize()
    launches = _build.launches()
    launches["routes"] = _build.route_launches()
    log(f"kernel launches of the public op path (farthest_point_sample_from_dist on "
        f"[{BATCH}, 4096, 4096], ball_query and ball_query_dilated on two scans): {launches}")
    check(launches["ffps_dist"] == 1 and launches["ball_query"] == 2
          and sum(launches[k] for k in launches if k not in ("ffps_dist", "ball_query",
                                                               "routes")) == 0,
          f"the public op path launched {launches}")
    check(all(len(p.unique()) == 512 for p in picks) and bool((cnt > 0).all())
          and bool((dcnt > 0).all()),
          "the public ops' outputs are not plausible")
    return {"public_ops": launches}


# ----------------------------------------------------------------- phase 13

@torch.inference_mode()
def phase_std_kernels(report: list[dict]) -> None:
    """K1, K3, K4, K6 and K7 against their plain versions on the inputs of
    every launch of one STD forward at batch 4 (the RCNN's D-FPS over each
    RoI's 6 x 6 x 6 voxel centres, K7 at n = 216); STD's shapes go into the
    report's entries."""
    log(f"== phase 13: STD's kernels against their plain versions, on the inputs of one "
        f"forward at batch {TWO_STAGE_BATCH} (configs/kitti/std/std.yaml)")
    cfg, pipe = std(device=DEV, seed=0)
    n = cfg.MODEL.POINTS_NUM_FOR_TRAINING
    points = torch.from_numpy(synthetic_scenes(TWO_STAGE_BATCH, n, seed=0)["points"]).to(DEV)
    layers = (pipe.model.rcnn_backbone.rcnn_layer1, pipe.model.rcnn_backbone.rcnn_layer2)
    seen = capture_two_stage_inputs(lambda p: pipe.model(p, pipe.rpn_spec), points, layers)
    check(len(seen["three_nn"]) == 4 and len(seen["sa_fused"]) == 2,
          f"captured {len(seen['three_nn'])} three_nn and {len(seen['sa_fused'])} fused-SA calls")
    check_path_kernels(report, seen, "STD", TWO_STAGE_SA_NAMES, (3, 128, 1, 3 + 2 + 128))
    by_name = {e["name"]: e for e in report}
    # K1 at the RCNN's D-FPS over the voxel lattice, timed on both routes
    (lattice, m), _ = seen["fps"][4]
    check(tuple(lattice.shape) == (400, 216, 3), f"the RCNN's SA1 samples {tuple(lattice.shape)}")
    plain = fps_plain(lattice, m)
    x, y, z = lattice.unbind(-1)
    run = torch.full(x.shape, float("inf"), device=x.device)
    tied = 0
    for i in range(1, m):  # ties on the plain arithmetic's own running distance
        last = plain[:, i - 1:i].long()
        run = torch.minimum(run, sampling.xyz_dist2(x - x.gather(1, last), y - y.gather(1, last),
                                                    z - z.gather(1, last)))
        tied += int(((run == run.amax(1, keepdim=True)).sum(1) > 1).sum())
    times = {}
    for route in ("block", "cluster"):
        with on_route(route):
            times[route] = cuda_ms(lambda: farthest_point_sample(lattice, m), 5)
    b, n_vox = lattice.shape[:2]
    k1 = dict(shape=f"{list(lattice.shape)} -> {m}", route=fps_route(b, n_vox), ties=tied,
              block_ms=times["block"], cluster_ms=times["cluster"],
              plain_ms=cuda_ms(lambda: fps_plain(lattice, m), 1),
              **bound(4 * (b * n_vox * 3 + b * m), b * (m - 1) * n_vox * 10))
    by_name["fps"]["routes"]["STD RCNN SA1 (voxel lattice)"] = k1
    log(f"K1 D-FPS STD RCNN SA1 {k1['shape']}: picks equal to plain on both routes, "
        f"{tied} of {b * (m - 1)} picks ties; one block a cloud {times['block']:.4f} ms, a "
        f"cluster {times['cluster']:.4f} ms (takes the {k1['route']} route); plain "
        f"{k1['plain_ms']:.3f} ms; bound {k1['bound_ms']:.4f} ms")
    for (xyz1, xyz2), _ in seen["three_nn"]:
        want_d, want_i = three_nn_plain(xyz1, xyz2)
        got_d, got_i = three_nn(xyz1, xyz2)
        check(torch.equal(got_i, want_i), f"K6 indices differ at STD {list(xyz1.shape)}")
        ulp = int((got_d.view(torch.int32) - want_d.view(torch.int32)).abs().max())
        check(ulp <= 1, f"K6 distances {ulp} ulp apart at STD {list(xyz1.shape)}")
    log("K6 three_nn at STD's four FP layers: indices equal, distances within 1 ulp")
    for name, (args, _) in zip(("SA1", "SA2"), seen["sa_fused"]):
        src, idx_list, centers, masks, layers_list, agg = args
        want = sa_fused.sa_fused_multi_plain(*args)
        scale, err, t = float(want.abs().max()), {}, {}
        for r in K7_ROUTES:
            with on_sa_route(r):
                err[r] = float((sa_fused.sa_fused_multi(*args) - want).abs().max())
                check(err[r] <= K7_TOL * scale,
                      f"K7 on the {r} route at STD {name} differs from plain by {err[r]:.3g}")
                t[r] = cuda_ms(lambda: sa_fused.sa_fused_multi(*args), 5)
        widths = [[w.shape[1] for w, *_ in lay] for lay in layers_list]
        route = sa_fused.sa_fused_route(src.shape[2], [i.shape[2] for i in idx_list], widths)
        bb, nn_, cp = src.shape
        mm = centers.shape[1]
        flops = sum(2 * bb * mm * idx.shape[2] * sum(w.shape[0] * w.shape[1] for w, *_ in lay)
                    for idx, lay in zip(idx_list, layers_list))
        params = sum(tt.numel() for lay in layers_list for layer_ in lay for tt in layer_)
        n_bytes = 4 * (bb * nn_ * cp + sum(i.numel() for i in idx_list) + centers.numel()
                       + masks.numel() + params + bb * mm * widths[-1][-1])
        e = dict(ms=t[route], route=route, route_ms=t,
                 plain_ms=cuda_ms(lambda: sa_fused.sa_fused_multi_plain(*args), 5),
                 bound_fma_ms=bound(n_bytes, flops, H100_F32_FLOP_PER_S)["bound_ms"],
                 **bound(n_bytes, 3 * flops, H100_TF32_FLOP_PER_S))
        shape = f"STD {name} b {bb}, n {nn_}, cp {cp}, m {mm}, ns {idx_list[0].shape[2]}"
        by_name["sa_fused"]["other_shapes"][shape] = e
        log(f"K7 fused SA {shape}: takes the {route} route; max |K7 - plain| "
            + ", ".join(f"{r} {v:.3g}" for r, v in err.items()) + f" (limit {K7_TOL:g} x "
            f"{scale:.3g}); " + ", ".join(f"{r} {v:.3f} ms" for r, v in t.items())
            + f" vs plain {e['plain_ms']:.3f} ms; bound {e['bound_ms']:.3f} ms (3xTF32), "
              f"{e['bound_fma_ms']:.3f} ms (f32 FMA)")


def phase_std() -> dict:
    """STD inference at batch 4 through `two_stage_entry(config="std")` (the
    pipeline of `models/api.py`): launches, routes, outputs, scans/s,
    batch-1 latency, peak memory and a profile -> the path's launches."""
    b = TWO_STAGE_BATCH
    log(f"== phase 13: STD inference, batch {b}, {N_POINTS} points, f32, 100 proposals")
    fn, (points,) = two_stage_entry(device=DEV, seed=0, batch=b, config="std")
    _build.reset_launches()
    det = fn(points)
    torch.cuda.synchronize()
    launches = _build.launches()
    log(f"kernel launches in one STD forward: {launches}")
    want = dict(three_nn=4, sa_fused=2, fps=6, ffps=0, scatter_add=0, ffps_dist=0)
    check(all(launches[k] == v for k, v in want.items()), f"launches {launches}, want {want}")
    check(launches["ball_query"] == 6 and launches["gather"] > 0, "K3 or K4 was not launched")
    launches["routes"] = check_routes("STD inference", "STD")
    check(det["boxes"].shape == (b, 100, 7) and det["proposals"].shape == (b, 100, 7),
          f"detections {tuple(det['boxes'].shape)}, proposals {tuple(det['proposals'].shape)}")
    for key in ("boxes", "scores", "proposals"):
        check(bool(torch.isfinite(det[key]).all()), f"STD: non-finite {key}")
    check(bool((det["valid"].sum(-1) <= 100).all() and det["valid"].any()),
          "STD: a scan has more than 100 boxes, or no scan has any")
    log(f"STD boxes per scan {det['valid'].sum(-1).tolist()}, proposals per scan "
        f"{det['proposals_valid'].sum(-1).tolist()}")
    torch.cuda.reset_peak_memory_stats()
    t = [timed_pass(fn, points) for _ in range(PASSES)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    one = points[:1].contiguous()
    lat = [timed_pass(fn, one) * 1e3 for _ in range(PASSES + 1)]
    wall, busy = profile_once(lambda: fn(points), f"STD batch of {b}", top=14,
                              each="dfps|sa_fused")
    log(f"STD throughput at batch {b}: {b * PASSES / sum(t):.2f} scans/s over {PASSES} passes "
        f"(median pass {statistics.median(t) * 1e3:.2f} ms); batch-1 latency median "
        f"{statistics.median(lat[1:]):.2f} ms of {PASSES}; device busy {busy:.2f} ms of a "
        f"profiled {wall:.2f} ms pass; peak memory {peak:.2f} GiB")
    return launches


# ----------------------------------------------------------------- phase 14

def phase_std_training() -> dict:
    """STD's stage 2 (`std_stage2.yaml`: 1,000 proposals, 64-RoI minibatches)
    at batch 4 from stage 1's weights, then the stage-wise CLI chain of STD
    -> the launches of one step and of the chain."""
    log(f"== phase 14: STD stage-2 training, batch {TWO_STAGE_BATCH}, {N_POINTS} points, f32, "
        "Adam (std_stage2.yaml from pointrcnn_stage1.yaml's weights)")
    step1, batch = two_stage_train_entry(device=DEV, stage=1, batch=TWO_STAGE_BATCH, seed=0)
    step1(batch)
    step2, _ = two_stage_train_entry(device=DEV, stage=2, batch=TWO_STAGE_BATCH, seed=0,
                                     config="std")
    state2 = step2.args[0]
    # the warm start of bin.train: the tensors whose names and shapes match
    merged, copied, _ = merge_by_name(state2.model.state_dict(), step1.args[0].model.state_dict())
    state2.model.load_state_dict(merged)
    params = dict(state2.model.named_parameters())
    frozen = {k: v.clone() for k, v in params.items() if k.startswith("rpn")}
    pooler = {k: v.clone() for k, v in params.items() if k.startswith("roi_pool")}
    check(all(k in copied for k in frozen), "a stage-1 RPN tensor was not carried into STD")
    launches, metrics = run_stage(step2, batch, "STD stage 2", "STD stage 2")
    check(all(f"loss_stage1/{k}" in metrics[0] for k in TWO_STAGE_LOSS_KEYS[2]),
          f"STD stage 2 losses {sorted(metrics[0])}")
    params = dict(state2.model.named_parameters())
    check(all(torch.equal(params[k], v) for k, v in frozen.items()),
          "an rpn_* parameter moved in STD's stage 2")
    moved = [k for k, v in pooler.items() if not torch.equal(params[k], v)]
    check(any(".vfe." in k for k in moved) and any(".align." in k for k in moved),
          f"STD's pooler did not train: moved {moved}")
    log(f"STD stage 2: all {len(frozen)} rpn_* parameters bit for bit stage 1's; {len(moved)} of "
        f"{len(pooler)} pooler parameters moved (align and vfe); losses finite")
    return {"std_train_2": launches, **phase_two_stage_cli("std")}


# ----------------------------------------------------------------- phase 15

def augmented_card_vs_cpu(cfg, data: dict, n: int) -> dict:
    """The device augmentation on both legs, same batch (with 15 crops of
    512 points a scan) and draws: points and boxes within F32_TOL of their
    largest |value|, labels equal -> the card's augmented batch, on the CPU."""
    data = dict(data, **{k: torch.from_numpy(v) for k, v in
                         synthetic_candidates(data["points"].shape[0], 15, 512).items()})
    draws = device_aug.draw(torch.Generator().manual_seed(15), data["points"].shape[0], n,
                            data["gt_boxes"].shape[1], "cpu")
    card_draws = device_aug.AugDraws(**{k: v.to(DEV) for k, v in
                                        dataclasses.asdict(draws).items()})
    got = device_aug.augment_batch({k: v.to(DEV) for k, v in data.items()},
                                   cfg.TRAIN.AUGMENTATIONS, card_draws)
    want = device_aug.augment_batch(data, cfg.TRAIN.AUGMENTATIONS, draws)
    _close("augmented points", got["points"].cpu(), want["points"], F32_TOL)
    _close("augmented boxes", got["gt_boxes"].cpu(), want["gt_boxes"], F32_TOL)
    check(torch.equal(got["gt_labels"].cpu(), want["gt_labels"]), "augmented labels differ")
    pasted = int((want["gt_labels"] > 0).sum() - (data["gt_labels"] > 0).sum())
    log(f"  device augmentation card against CPU on the same draws: points and boxes within "
        f"{F32_TOL:g}, labels equal ({pasted} crops pasted over {data['points'].shape[0]} scans)")
    return {k: v.cpu() for k, v in got.items()}


def phase_train_options() -> dict:
    """The flagship with TRAIN_OPTIONS (an IoU head, Dist-Anchor, AdaBound,
    the device augmentation with 15 crops of 512 points a scan) at batch 8:
    a few steps, their launches, then one f32 step card against CPU."""
    log(f"== phase 15: the training options (IoU head, Dist-Anchor, AdaBound, device "
        f"augmentation), flagship train step, batch {BATCH}")
    step, batch = train_options_entry(device=DEV, seed=0, batch=BATCH)
    state = step.args[0]
    _build.reset_launches()
    first = step(batch)
    torch.cuda.synchronize()
    launches = _build.launches()
    log(f"kernel launches in one step with the training options: {launches}")
    check(all(launches[k] > 0 for k in ("fps", "ffps", "ball_query", "gather", "scatter_add")),
          f"a kernel of the train step was not launched: {launches}")
    launches["routes"] = check_routes("the train step with the training options", "3DSSD")
    times, metrics = [], [first]
    for _ in range(3):
        t0 = time.perf_counter()
        metrics.append(step(batch))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    for m in metrics:
        check(all(np.isfinite(float(v)) for v in m.values()), f"a metric is not finite: {m}")
    check("iou" in first and state.optimizer.__class__.__name__ == "AdaBound"
          and state.optimizer.param_groups[0]["count"] == len(metrics),
          "the step did not run the IoU branch and AdaBound")
    log("losses by step (cls, offset, angle, corner, vote, iou, total): " + "; ".join(
        ", ".join(f"{float(m[k]):.4f}" for k in ("cls", "offset", "angle", "corner", "vote",
                                                  "iou", "total")) for m in metrics)
        + f"; median step {statistics.median(times):.2f} ms")
    phase_train_card_vs_cpu(TRAIN_OPTIONS)
    return {"train_options": launches}


# ----------------------------------------------------------------- phase 16

# Phase 16's synthetic raw nuScenes tree (`utils/synth_nuscenes.py`): scenes
# of key frames 0.5 s apart with one sweep between, a frame of about the
# points a 32-beam LIDAR_TOP returns; scene 0 is the val split. A key frame
# aggregates up to 10 sweeps (NSWEEPS) before the voxel budget.
NUSC_SCENES, NUSC_SAMPLES, NUSC_FRAME_POINTS = 3, 6, 34000
NUSC_BATCHES = (1, 2, 4)
# the config's global batch (BATCH_SIZE 4 x GPU_NUM 2)
NUSC_TRAIN_BATCH = 8
NUSC_TRAIN_STEPS = 3
# the point budget of the reference bench's nuScenes row
# (benchmarks/bench_configs.py:101)
NUSC_BIG = 65536
NUSC_CLI_ITERS = 4
NUSC_LOSS_KEYS = LOSS_KEYS + ("attribute", "velocity")
NUSC_INPUTS = ("points", "gt_boxes", "gt_labels", "gt_velocity", "gt_attribute")
# the ball queries of one nuScenes 3DSSD forward, in launch order, and K1's
# routes held at its shapes up to 16,384 points (past them the slice route)
NUSC_SA_NAMES = ("SA1", "SA2", "SA3", "CG-SA")
NUSC_FPS_ROUTES = ("block", "cluster", "slice")


def grid_cell_edge(xyz: torch.Tensor, specs) -> float:
    """K3's grid cell edge for the first cloud of `xyz` [b, n, 3]: the rule of
    `grid_build_kernel` (csrc/ball_query.cu), at least the outer ring's radius
    with its margin, grown by 1.25 until the cloud's box takes at most
    `grid_cell_cap(n)` cells."""
    pts = xyz[0].double().cpu()
    ext = (pts.amax(0) - pts.amin(0)).tolist()
    cell = max(grouping.grid_cell_min(specs), max(ext) / 1023)
    while math.prod(int(math.floor(e / cell)) + 1 for e in ext) > grouping.grid_cell_cap(
            xyz.shape[1]):
        cell *= 1.25
    return cell


def nuscenes_inference(pipe, scans: torch.Tensor, path: str, what: str) -> dict:
    """One forward, decode and NMS of `scans` with its launches by kernel and
    route, outputs checked -> the launches."""
    _build.reset_launches()
    det = pipe.infer(scans)
    torch.cuda.synchronize()
    launches = _build.launches()
    log(f"kernel launches in one {what} forward, decode and NMS: {launches}")
    check(all(launches[k] > 0 for k in ("fps", "ffps", "ball_query", "gather"))
          and launches["scatter_add"] == launches["three_nn"] == launches["sa_fused"] == 0,
          f"{what}: launches {launches}")
    launches["routes"] = check_routes(what, path)
    b, k = scans.shape[0], 10 * pipe.spec.max_output
    check(det["boxes"].shape == (b, k, 7) and det["velocity"].shape == (b, k, 2)
          and det["attribute"].shape == (b, k, 8), f"{what}: detections "
          f"{tuple(det['boxes'].shape)}, velocity {tuple(det['velocity'].shape)}, attribute "
          f"{tuple(det['attribute'].shape)}")
    valid = det["valid"]
    for key in ("boxes", "scores", "velocity", "attribute"):
        check(bool(torch.isfinite(det[key][valid]).all()), f"{what}: non-finite kept {key}")
    check(bool(valid.any() and (valid.sum(-1) <= k).all()), f"{what}: no scan kept a box")
    per_class = torch.stack([valid[:, c0:c0 + pipe.spec.max_output].sum(-1)
                             for c0 in range(0, k, pipe.spec.max_output)], -1)
    log(f"{what}: boxes kept per scan {valid.sum(-1).tolist()} (per class, scan 0: "
        f"{per_class[0].tolist()})")
    return launches


def nuscenes_sweep(pipe, scans: torch.Tensor) -> None:
    """Inference at NUSC_BATCHES: for each a warm-up, PASSES timed passes,
    peak memory and one profiled pass (device busy time, launches)."""
    walls, busies = [], []
    for bb in NUSC_BATCHES:
        chunk = scans[:bb].contiguous()
        timed_pass(pipe.infer, chunk)
        torch.cuda.reset_peak_memory_stats()
        dts = sorted(timed_pass(pipe.infer, chunk) * 1e3 for _ in range(PASSES))
        peak = torch.cuda.max_memory_allocated() / 2**30
        walls.append(statistics.median(dts))
        wall, busy = profile_once(lambda: pipe.infer(chunk), f"nuScenes batch of {bb}",
                                  top=12 if bb == NUSC_BATCHES[-1] else 0, each="dfps")
        busies.append(busy)
        log(f"nuScenes batch {bb}: median {walls[-1]:.2f} ms of {PASSES} passes (min "
            f"{dts[0]:.2f}, max {dts[-1]:.2f}); {bb * 1e3 / walls[-1]:.2f} scans/s; device busy "
            f"{busy:.2f} ms of a profiled {wall:.2f} ms pass (host share "
            f"{100 * (1 - busy / wall):.1f}%); peak memory {peak:.2f} GiB")
    fixed, per_scan = linear_fit(NUSC_BATCHES, walls)
    busy_fixed, busy_per_scan = linear_fit(NUSC_BATCHES, busies)
    log(f"nuScenes batch scaling fit over b {list(NUSC_BATCHES)}: wall {fixed:.2f} ms + "
        f"{per_scan:.2f} ms a scan; device busy {busy_fixed:.2f} ms + {busy_per_scan:.2f} ms a "
        f"scan; batch-1 latency {walls[0]:.2f} ms")


def nuscenes_big(report: list[dict], data_opts: list) -> dict:
    """One scan budgeted to NUSC_BIG points (the config's sample counts as
    shipped): its kernels against their plain versions (K1's slice route,
    K3's brute force), launches and routes, timed passes -> the launches."""
    cfg = load_cfg(str(NUSCENES_CFG), data_opts + [
        "DATASET.NUSCENES.MAX_CUR_SAMPLE_POINTS_NUM", str(NUSC_BIG),
        "MODEL.POINTS_NUM_FOR_TRAINING", str(NUSC_BIG)])
    loader = NuScenesLoader(cfg, "val", training=False)
    sample = loader.load_sample(NUSC_SAMPLES - 1)  # the last key frame: 10 sweeps
    scan = torch.from_numpy(sample["points"][None]).to(DEV)
    check(scan.shape == (1, NUSC_BIG, 4), f"the {NUSC_BIG}-point scan is {tuple(scan.shape)}")
    pipe = build_pipeline(cfg, device=DEV)
    init_weights(pipe.model, 0)
    check_path_kernels(report, capture_two_stage_inputs(pipe.infer, scan, ()),
                       f"nuScenes {NUSC_BIG}", NUSC_SA_NAMES, fps_routes=NUSC_FPS_ROUTES,
                       timed=True)
    launches = nuscenes_inference(pipe, scan, "nuScenes 65,536", f"nuScenes {NUSC_BIG}")
    timed_pass(pipe.infer, scan)
    torch.cuda.reset_peak_memory_stats()
    dts = sorted(timed_pass(pipe.infer, scan) * 1e3 for _ in range(PASSES))
    peak = torch.cuda.max_memory_allocated() / 2**30
    wall, busy = profile_once(lambda: pipe.infer(scan), f"nuScenes {NUSC_BIG} points, batch 1",
                              top=8, each="dfps|ball_query")
    log(f"nuScenes at {NUSC_BIG} points, batch 1: median {dts[len(dts) // 2]:.2f} ms of {PASSES} "
        f"passes (min {dts[0]:.2f}, max {dts[-1]:.2f}); device busy {busy:.2f} ms of a profiled "
        f"{wall:.2f} ms pass; peak memory {peak:.2f} GiB")
    return launches


def nuscenes_training(report: list[dict], batch: dict) -> dict:
    """The bf16 train step at the config's global batch (Adam at
    SOLVER.BASE_LR): a warm-up and NUSC_TRAIN_STEPS timed steps, launches,
    K5 at the step's calls; then one f32 step card against CPU on two of its
    scans whose boxes give the attribute and velocity losses targets, every
    loss above 0 on both legs -> the launches of one step."""
    cfg, model, spec = nuscenes(device=DEV, seed=0)
    graph = TrainGraph.build(cfg, model, spec)
    state = graph.init_state()
    data = {k: torch.from_numpy(batch[k]).to(DEV) for k in NUSC_INPUTS}
    _build.reset_launches()
    first = graph.train_step(state, data)
    torch.cuda.synchronize()
    launches = _build.launches()
    log(f"kernel launches in one nuScenes train step: {launches}")
    check(all(launches[k] > 0 for k in ("fps", "ffps", "ball_query", "gather"))
          and launches["scatter_add"] == 8 and launches["three_nn"] == launches["sa_fused"] == 0,
          f"nuScenes train step: launches {launches}")
    launches["routes"] = check_routes("the nuScenes train step", "3DSSD")
    torch.cuda.reset_peak_memory_stats()
    metrics, times = [first], []
    for _ in range(NUSC_TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics.append(graph.train_step(state, data))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for m in metrics:
        check(set(NUSC_LOSS_KEYS) <= set(m)
              and all(np.isfinite(float(m[k])) and float(m[k]) > 0
                      for k in NUSC_LOSS_KEYS + ("total",)),
              f"nuScenes train step: a loss is missing, not finite or 0: {m}")
    lr = state.optimizer.param_groups[0]["lr"]
    check(state.optimizer.__class__.__name__ == "Adam"
          and math.isclose(lr, cfg.SOLVER.BASE_LR, rel_tol=1e-6),
          f"the nuScenes step is not Adam at SOLVER.BASE_LR: {type(state.optimizer)}, lr {lr}")
    wall, busy = profile_once(lambda: graph.train_step(state, data),
                              f"nuScenes train step at batch {NUSC_TRAIN_BATCH}", top=12)
    step_ms = statistics.median(times)
    log("losses by step (" + ", ".join(NUSC_LOSS_KEYS) + ", total): " + "; ".join(
        ", ".join(f"{float(m[k]):.4f}" for k in NUSC_LOSS_KEYS + ("total",)) for m in metrics))
    log(f"nuScenes bf16 train step at batch {NUSC_TRAIN_BATCH}: median {step_ms:.2f} ms (min "
        f"{min(times):.2f}, max {max(times):.2f}) over {NUSC_TRAIN_STEPS} steps; "
        f"{NUSC_TRAIN_BATCH * 1e3 / step_ms:.2f} training scans/s; device busy {busy:.2f} ms of "
        f"a profiled {wall:.2f} ms step; peak memory {peak:.2f} GiB")
    calls = []

    def recorded(idx, g, n):
        calls.append((idx.detach().clone(), g.detach().clone(), n))
        return scatter_add_rows(idx, g, n)

    with mock.patch.object(grouping, "scatter_add_rows", recorded):
        graph.train_step(state, data)
    check(len(calls) == 8, f"recorded {len(calls)} scatter-add calls in a nuScenes train step")
    entry = next(e for e in report if e["name"] == "scatter_add")
    entry["nuscenes_train_step_shapes"] = [
        k5_check(f"nuScenes train call {i}: {g.shape[0] * g.shape[1]} x {g.shape[2]} into {n}",
                 idx, g, n) for i, (idx, g, n) in enumerate(calls)]
    del graph, state, model
    # two scans each holding a box with an attribute and a finite velocity,
    # so the attribute and velocity losses have targets on both legs
    live = ((batch["gt_labels"] > 0) & (batch["gt_attribute"] >= 0)
            & np.isfinite(batch["gt_velocity"]).all(-1))
    pick = np.flatnonzero(live.any(-1))[:2]
    check(len(pick) == 2, f"scans with an attributed, moving box: {pick.tolist()}")
    log(f"one f32 nuScenes train step, card against CPU, scans {pick.tolist()} of the batch "
        f"({live[pick].sum(-1).tolist()} boxes with an attribute and a finite velocity), same "
        "weights:")
    cfg32, gmodel, spec32 = nuscenes(compute_dtype="float32", device=DEV, seed=0)
    hold_train_step_to_cpu(cfg32, gmodel, spec32,
                           {k: torch.from_numpy(batch[k][pick]) for k in NUSC_INPUTS})
    return launches


def nuscenes_cli(root: str, data_opts: list, lists: dict) -> dict:
    """bin.train of the full config for NUSC_CLI_ITERS iterations,
    bin.evaluate (NDS and mAP) and bin.test (the submission JSON, read back)
    on the tree bin.preprocess converted -> the chain's launches."""
    run = os.path.join(root, "run")
    opts = data_opts + ["TRAIN.CONFIG.MAX_ITERATIONS", str(NUSC_CLI_ITERS),
                        "TRAIN.CONFIG.CHECKPOINT_INTERVAL", str(NUSC_CLI_ITERS),
                        "TRAIN.CONFIG.SUMMARY_INTERVAL", "1", "TEST.BATCH_SIZE", "4"]
    cfg_path = str(NUSCENES_CFG)
    seconds = {}

    def chain():
        for name, fn in (("train", lambda: train_cli.main(["--cfg", cfg_path, "--log_dir", run]
                                                           + opts)),
                         ("evaluate", lambda: evaluate_cli.main(
                             ["--cfg", cfg_path, "--log_dir", run, "--once", "--cls_threshold",
                              "0.0"] + opts)),
                         ("test", lambda: test_cli.main(["--cfg", cfg_path, "--log_dir", run,
                                                         "--cls_threshold", "0.0"] + opts))):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0

    launches = cli_launches("the nuScenes bin.train, bin.evaluate and bin.test", chain)
    check(all(launches[k] > 0 for k in ("fps", "ffps", "ball_query", "gather", "scatter_add"))
          and launches["three_nn"] == launches["sa_fused"] == 0,
          f"the nuScenes CLI chain launched {launches}")
    metrics = _metrics(run)
    check([m["iter"] for m in metrics] == list(range(1, NUSC_CLI_ITERS + 1))
          and all(np.isfinite(m[k]) for m in metrics for k in NUSC_LOSS_KEYS + ("total",)),
          f"bin.train logged {metrics}")
    sec = [m["sec_per_it"] for m in metrics[1:]]
    wait = [m["loader_wait_s"] for m in metrics[1:]]
    with open(os.path.join(run, f"eval_{NUSC_CLI_ITERS}.json")) as f:
        res = json.load(f)
    check(np.isfinite(res["NDS"]) and np.isfinite(res["mAP"]) and 0 <= res["NDS"] <= 1,
          f"NDS {res['NDS']}, mAP {res['mAP']}")
    with open(os.path.join(run, "nuscenes_result.json")) as f:
        dump = json.load(f)
    records = [r for recs in dump["results"].values() for r in recs]
    check(sorted(dump["results"]) == sorted(lists["val"]) and records
          and all(len(r["translation_cam"]) == 3 and len(r["velocity_cam"]) == 2
                  and 0 <= r["attribute_id"] < 8 for r in records),
          "nuscenes_result.json does not hold the val split's detections")
    log(f"nuScenes CLI: bin.train at batch {NUSC_TRAIN_BATCH}, iterations 2-{NUSC_CLI_ITERS}: "
        f"median {statistics.median(sec):.4f} s/it, loader wait "
        f"{100 * sum(wait) / sum(sec):.1f}%; bin.evaluate of {len(lists['val'])} val scans at "
        f"TEST.BATCH_SIZE 4: mAP {res['mAP']:.4f}, NDS {res['NDS']:.4f}; bin.test wrote "
        f"{len(records)} records; seconds "
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    return launches


def phase_nuscenes(report: list[dict]) -> dict:
    """3DSSD on nuScenes (`configs/nuscenes/3dssd/3dssd.yaml`) on scans of a
    synthetic raw tree converted by bin.preprocess and read by the loader:
    the kernels at its shapes, inference at NUSC_BATCHES and at NUSC_BIG
    points, card against CPU, the train step and the CLI chain -> the
    launches of its paths."""
    log("== phase 16: nuScenes 3DSSD (configs/nuscenes/3dssd/3dssd.yaml: 10 classes, velocity "
        "and attribute heads, bf16, 200 outputs a class) on the card")
    paths = {}
    with tempfile.TemporaryDirectory(prefix="ssd3d_nusc_") as root:
        raw, npz = os.path.join(root, "raw"), os.path.join(root, "npz")
        t0 = time.perf_counter()
        version = synth_nuscenes.write_tree(raw, n_scenes=NUSC_SCENES,
                                            samples_per_scene=NUSC_SAMPLES,
                                            n_points=NUSC_FRAME_POINTS, seed=0)
        t1 = time.perf_counter()
        data_opts = ["DATASET.NUSCENES.BASE_DIR_PATH", raw, "DATASET.NUSCENES.VERSION", version,
                     "DATASET.NUSCENES.SAVE_NUMPY_PATH", npz]
        lists = preprocess_cli.main(["--cfg", str(NUSCENES_CFG), "--device", DEV] + data_opts)
        t2 = time.perf_counter()
        check(len(lists["train"]) == (NUSC_SCENES - 1) * NUSC_SAMPLES
              and len(lists["val"]) == NUSC_SAMPLES, f"bin.preprocess wrote {lists}")
        sizes = [len(np.load(os.path.join(npz, split, f"{name}.npz"))["points"])
                 for split in lists for name in lists[split]]
        log(f"wrote a raw tree of {NUSC_SCENES} scenes x {NUSC_SAMPLES} key frames "
            f"({NUSC_FRAME_POINTS} points a frame) in {t1 - t0:.1f} s; bin.preprocess aggregated "
            f"{len(sizes)} key frames of {min(sizes)}-{max(sizes)} points in {t2 - t1:.1f} s")
        cfg = load_cfg(str(NUSCENES_CFG), data_opts)
        batch = next(NuScenesLoader(cfg, "train", seed=0).batches(NUSC_TRAIN_BATCH))
        scans = torch.from_numpy(batch["points"]).to(DEV)
        check(scans.shape == (NUSC_TRAIN_BATCH, 16384, 4), f"the loader gave {tuple(scans.shape)}")
        log(f"loader batch: {NUSC_TRAIN_BATCH} scans of 16384 points (x, y, z, time lag up to "
            f"{float(batch['points'][..., 3].max()):.2f} s), "
            f"{int((batch['gt_labels'] > 0).sum())} boxes")
        pipe = build_pipeline(cfg, device=DEV)
        init_weights(pipe.model, 0)
        b = NUSC_BATCHES[-1]
        check_path_kernels(report, capture_two_stage_inputs(pipe.infer, scans[:b].contiguous(), ()),
                           "nuScenes", NUSC_SA_NAMES, fps_routes=NUSC_FPS_ROUTES, timed=True)
        paths["nuscenes"] = nuscenes_inference(pipe, scans[:b].contiguous(), "nuScenes",
                                               f"nuScenes batch {b}")
        nuscenes_sweep(pipe, scans)
        del pipe
        paths["nuscenes_65536"] = nuscenes_big(report, data_opts)
        log("nuScenes card against CPU, one scan, same weights, f32:")
        check(compare_with_cpu(scans[:1].contiguous(), "float32", build=lambda dtype: nuscenes(
            compute_dtype=dtype, device=DEV, seed=0)),
            "nuScenes float32: picks, bins or kept detections differ between card and CPU")
        paths["nuscenes_train"] = nuscenes_training(report, batch)
        paths["nuscenes_cli"] = nuscenes_cli(root, ["--device", DEV] + data_opts, lists)
    return paths


# ---------------------------------------------------------------- phase 17

ATTN_STEPS = 3  # timed bf16 train steps with attention grouping
# an attention query's row may differ card against CPU only where a member
# taken on one leg and not the other lies this close (relative) to the CPU's
# selection threshold of feature distance: the keys are one f32 matrix
# product summed in another order on each device
ATTN_TIE_RTOL = 1e-5
GN_OPTS = ["MODEL.NETWORK.USE_GN", "True"]


class AttentionReplay:
    """Every attention query (`modules.ball_query_attention`) of a card leg
    recorded, then held to and handed to a CPU leg: a CPU row (idx and cnt
    of one centre) that differs from the card's must be a near-tie
    (ATTN_TIE_RTOL) of the CPU's own keys, and the CPU leg then takes the
    card's answer, so that the rest of the two legs compares arithmetic."""

    def __init__(self, per_leg: int):
        self.per_leg = per_leg  # the attention queries of one forward
        self.calls, self.pos, self.rows, self.differ = [], 0, 0, 0

    def __call__(self, radius, ns, xyz, new_xyz, feats, new_feats):
        idx, cnt = grouping.ball_query_attention(radius, ns, xyz, new_xyz, feats, new_feats)
        if len(self.calls) < self.per_leg:  # the card leg runs first
            self.calls.append((idx.cpu(), cnt.cpu()))
            return idx, cnt
        card_idx, card_cnt = self.calls[self.pos]
        self.pos += 1
        rows = (card_idx != idx).any(-1) | (card_cnt != cnt)
        self.rows += rows.numel()
        self.differ += int(rows.sum())
        r2 = float(np.float32(radius * radius))
        for b, q in rows.nonzero().tolist():
            key = geometry.square_distance(new_feats[b, q:q + 1], feats[b])[0]
            inside = grouping._pairwise_dist2(new_xyz[b:b + 1, q:q + 1], xyz[b:b + 1])[0, 0] < r2
            t = key[inside].sort(descending=True).values[min(ns, int(inside.sum())) - 1]
            moved = set(card_idx[b, q].tolist()) ^ set(idx[b, q].tolist())
            gap = max(float((key[p] - t).abs()) for p in moved) if moved else 0.0
            check(gap <= ATTN_TIE_RTOL * max(float(t.abs()), 1e-30),
                  f"attention query r={radius} scan {b} centre {q} differs card against CPU "
                  f"{gap:.3g} from the threshold {float(t):.6g}: not a near-tie")
        return card_idx, card_cnt


GN_MOMENT_RTOL = 1e-5


class GroupNormReplay:
    """The card leg's GroupNorm moments (E[x], E[x^2] of each scan and
    group, `GroupNorm.moments`) handed to a CPU leg, each first held to the
    CPU's own within GN_MOMENT_RTOL of the largest E[x^2] of the call. The
    variance E[x^2] - E[x]^2 (flax's fast variance, which the port keeps)
    cancels where a group's values are nearly equal, and multiplies the two
    devices' rounding of the moments by up to 170 (measured, the flagship's
    SA1 r=0.8 scale, conv2); past that the two legs compare the rest of the
    arithmetic. The CPU leg takes the card's values with its own gradient
    (card + own - own.detach()), so a train step's backward is its own."""

    def __init__(self):
        self.calls, self.pos, self.worst = [], 0, 0.0
        self._moments = GroupNorm.moments  # the layer's own, before the patch

    def bound(self):
        """The replay as a method of GroupNorm, for patching `moments`."""
        return lambda gn, x: self(gn, x)

    def __call__(self, gn, x):
        mean, mean2 = self._moments(gn, x)
        if x.is_cuda:
            self.calls.append((mean.detach().cpu(), mean2.detach().cpu()))
            return mean, mean2
        card = self.calls[self.pos]
        self.pos += 1
        scale = float(mean2.detach().abs().max().clamp(min=1e-30))
        err = max(float((c - o.detach()).abs().max()) for c, o in zip(card, (mean, mean2))) / scale
        self.worst = max(self.worst, err)
        check(err <= GN_MOMENT_RTOL, f"GroupNorm moments differ card against CPU by {err:.3g} of "
              "the largest E[x^2]")
        return tuple(c + o - o.detach() for c, o in zip(card, (mean, mean2)))


def attention_flagship_on(device, dtype=None, opts=()):
    return flagship(device=device, seed=0, compute_dtype=dtype, opts=opts,
                    attention=ATTENTION_LAYERS)


def attention_query_times(model, scans: torch.Tensor) -> list[dict]:
    """SA1's attention queries at their inputs in one forward: each radius's
    query timed (`cuda_ms`) and profiled for its kernel launches."""
    seen = []
    real = modules.ball_query_attention

    def record(*args):
        seen.append(args)
        return real(*args)

    with mock.patch.object(modules, "ball_query_attention", record), torch.inference_mode():
        model(scans)
    sa1 = seen[:len(model.backbone.layer1.radius_list)]
    out = []
    for radius, ns, xyz, new_xyz, feats, new_feats in sa1:
        fn = lambda: grouping.ball_query_attention(radius, ns, xyz, new_xyz, feats, new_feats)  # noqa: E731
        ms = cuda_ms(fn, 5)
        # two calls under the profiler, halved: a call first under a
        # profiler can lose its first launches (`profile_once`)
        activities = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            fn()
            fn()
            torch.cuda.synchronize()
        n_launch = sum(1 for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA) // 2
        chunk = grouping.attention_chunk(xyz.shape[0], new_xyz.shape[1], xyz.shape[1])
        out.append(dict(radius=radius, nsample=ns, ms=ms, launches=n_launch,
                        shape=f"{tuple(new_xyz.shape[:2])} x {tuple(xyz.shape[:2])}, "
                              f"{feats.shape[-1]} feature channels", chunk=chunk))
        log(f"SA1 attention query r={radius} ns={ns} at {out[-1]['shape']}: {ms:.3f} ms, "
            f"{n_launch} kernel launches ({-(-new_xyz.shape[1] // chunk)} chunks of {chunk} "
            f"queries a cloud)")
    return out


def phase_attention_and_groupnorm(report: list[dict]) -> dict:
    """Phase 17: the flagship with attention grouping on SA1 and SA2 and with
    GroupNorm -> the launches of attention inference and of its train step."""
    log(f"== phase 17: the flagship with attention grouping on SA1 and SA2 (bf16, batch {BATCH}, "
        f"{N_POINTS} points), and with GroupNorm (USE_GN)")
    paths = {}
    scans = torch.from_numpy(synthetic_scenes(BATCH, N_POINTS)["points"]).to(DEV)
    cfg, model, spec, _ = attention_flagship_on(DEV)

    def infer(points):
        with torch.inference_mode():
            return spec.decode_and_nms(model(points))

    _build.reset_launches()
    det = infer(scans)
    torch.cuda.synchronize()
    launches = _build.launches()
    log(f"kernel launches in one attention forward, decode and NMS: {launches}")
    check(all(launches[k] > 0 for k in ("fps", "ffps", "ball_query", "gather"))
          and launches["scatter_add"] == launches["three_nn"] == launches["sa_fused"] == 0,
          f"attention inference: launches {launches}")
    launches["routes"] = check_routes("attention inference", "3DSSD attention")
    paths["attention"] = launches
    valid = det["valid"]
    check(bool(torch.isfinite(det["boxes"]).all() and torch.isfinite(det["scores"]).all()
               and valid.any() and (valid.sum(-1) <= 100).all()),
          "attention inference: non-finite or no detections")
    iters = 10
    infer(scans)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        infer(scans)
    torch.cuda.synchronize()
    rate = BATCH * iters / (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    one = scans[:1].contiguous()
    lat = []
    for _ in range(iters + 1):
        t0 = time.perf_counter()
        infer(one)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    wall, busy = profile_once(lambda: infer(scans), f"attention batch of {BATCH}", top=8)
    log(f"attention inference: {rate:.2f} scans/s at batch {BATCH}; batch-1 latency median "
        f"{statistics.median(lat[1:]):.2f} ms; device busy {busy:.2f} ms of a profiled "
        f"{wall:.2f} ms; peak memory {peak:.2f} GiB")
    MEASURED["attention_queries"] = attention_query_times(model, scans)
    del model

    log("attention flagship card against CPU, one scan, same weights, f32 (the CPU leg takes "
        "the card's attention rows where a near-tie went the other way):")
    arch = cfg.MODEL.NETWORK.FIRST_STAGE.ARCHITECTURE
    replay = AttentionReplay(sum(len(arch[row][2]) for row in ATTENTION_LAYERS))
    with mock.patch.object(modules, "ball_query_attention", replay):
        check(compare_with_cpu(scans[:1].contiguous(), "float32",
                               build=lambda dtype: attention_flagship_on(DEV, dtype)[:3]),
              "attention float32: picks, bins or kept detections differ between card and CPU")
    check(replay.pos == len(replay.calls) == replay.per_leg,
          f"the legs made {len(replay.calls)} / {replay.pos} attention queries, "
          f"not {replay.per_leg} each")
    log(f"  attention queries: {len(replay.calls)} on each leg, {replay.differ} of {replay.rows} "
        "rows differ (each a near-tie of the CPU's keys)")

    cfg, model, spec, _ = attention_flagship_on(DEV)
    graph = TrainGraph.build(cfg, model, spec)
    state = graph.init_state()
    data = {k: torch.from_numpy(v).to(DEV) for k, v in synthetic_scenes(BATCH, N_POINTS).items()}
    _build.reset_launches()
    first = graph.train_step(state, data)
    torch.cuda.synchronize()
    tl = _build.launches()
    log(f"kernel launches in one attention train step: {tl}")
    check(all(tl[k] > 0 for k in ("fps", "ffps", "ball_query", "gather", "scatter_add"))
          and tl["three_nn"] == tl["sa_fused"] == 0, f"attention train step: launches {tl}")
    tl["routes"] = check_routes("the attention train step", "3DSSD attention")
    paths["attention_train"] = tl
    torch.cuda.reset_peak_memory_stats()
    metrics, times = [first], []
    for _ in range(ATTN_STEPS):
        t0 = time.perf_counter()
        metrics.append(graph.train_step(state, data))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(np.isfinite(float(m[k])) for m in metrics for k in LOSS_KEYS + ("total",)),
          f"attention train step: a loss is not finite: {metrics}")
    wall, busy = profile_once(lambda: graph.train_step(state, data),
                              f"attention train step at batch {BATCH}", top=8)
    log(f"attention bf16 train step at batch {BATCH}: median {statistics.median(times):.2f} ms "
        f"(min {min(times):.2f}, max {max(times):.2f}) over {ATTN_STEPS} steps; device busy "
        f"{busy:.2f} ms of a profiled {wall:.2f} ms; peak memory {peak:.2f} GiB; total loss by "
        "step " + ", ".join(f"{float(m['total']):.4f}" for m in metrics))
    calls = []

    def recorded(idx, g, n):
        calls.append((idx.detach().clone(), g.detach().clone(), n))
        return scatter_add_rows(idx, g, n)

    with mock.patch.object(grouping, "scatter_add_rows", recorded):
        graph.train_step(state, data)
    check(len(calls) == tl["scatter_add"], f"recorded {len(calls)} scatter-add calls in an "
          f"attention train step, launched {tl['scatter_add']}")
    entry = next(e for e in report if e["name"] == "scatter_add")
    entry["attention_train_step_shapes"] = [
        k5_check(f"attention train call {i}: {g.shape[0] * g.shape[1]} x {g.shape[2]} into {n}",
                 idx, g, n, timed=False) for i, (idx, g, n) in enumerate(calls)]
    del graph, state, model

    log("GroupNorm flagship (USE_GN) card against CPU, one scan, same weights, f32 (the CPU "
        "leg takes the card's F-FPS picks, ReLU signs, max-pool winners and balls where a "
        "near-tie went the other way):")
    replay, gn = Decisions(kinds=GN_DECISIONS, by_device=True, plain=True), GroupNormReplay()
    with replay.patched(), mock.patch.object(GroupNorm, "moments", gn.bound()):
        check(compare_with_cpu(scans[:1].contiguous(), "float32", build=lambda dtype: flagship(
            device=DEV, seed=0, compute_dtype=dtype, opts=GN_OPTS)[:3]),
            "GroupNorm float32: picks, bins or kept detections differ between card and CPU")
    log(f"  GroupNorm moments of {gn.pos} layers within {gn.worst:.3g} of the largest E[x^2] "
        "(the CPU leg takes the card's); decisions the CPU would have taken otherwise, each a "
        "near-tie: " + ", ".join(f"{k} {replay.differ[k]} of {replay.total[k]}"
                                 for k in replay.kinds))
    check(replay.consumed(), f"the legs took different numbers of decisions: {replay.pos}")
    log("one f32 GroupNorm train step, card against CPU, 2 scans, same weights (the card's "
        "F-FPS picks too):")
    cfg32, gmodel, spec32, _ = flagship(device=DEV, seed=0, compute_dtype="float32",
                                        opts=GN_OPTS)
    check(not any(".bn." in k for k in gmodel.state_dict()), "USE_GN left a BatchNorm")
    gn = GroupNormReplay()
    with mock.patch.object(GroupNorm, "moments", gn.bound()):
        hold_train_step_to_cpu(cfg32, gmodel, spec32, {
            k: torch.from_numpy(v) for k, v in synthetic_scenes(2, N_POINTS).items()},
            kinds=GN_DECISIONS)
    log(f"  GroupNorm moments within {gn.worst:.3g} of the largest E[x^2]")
    return paths


# ---------------------------------------------------------------- phase 18

DIST_CLI_ITERS = 4
DIST_CLI_SCANS = 16
# the flagship's step at batch 8 over the cards (bf16 as shipped), and at f32
# where more than one card is held to one process (`parallel.steps.CASES`)
DIST_CASE, DIST_CASE_F32 = "3dssd", "3dssd_f32"
DIST_TIMED = 5  # steps timed after the compared one, each mode


def _same_step(got, want, what: str) -> None:
    """World size 1: the dp step is the plain step, bit for bit."""
    check(got.losses == want.losses, f"{what}: losses {got.losses} != {want.losses}")
    differ = [k for k, v in want.grads.items() if not torch.equal(got.grads[k], v)]
    check(not differ, f"{what}: {len(differ)} gradient leaves differ, e.g. {differ[:3]}")
    differ = [k for k, v in want.stats.items() if not torch.equal(got.stats[k], v)]
    check(not differ, f"{what}: {len(differ)} BatchNorm statistics differ, e.g. {differ[:3]}")


def _step_within(got, want, what: str) -> None:
    """World size 1 under FSDP: phase 6's tolerances (losses F32_TOL relative,
    each gradient leaf TRAIN_GRAD_TOL of its largest |value|, statistics
    F32_TOL of theirs)."""
    loss = max(abs(got.losses[k] - v) / max(abs(v), 1e-30) for k, v in want.losses.items())
    grad = max(float((got.grads[k] - v).abs().max()) / parallel_steps._grad_scale(k, want.grads)
               for k, v in want.grads.items())
    stats = max(float((got.stats[k] - v).abs().max()) / max(float(v.abs().max()), 1e-30)
                for k, v in want.stats.items())
    exact = got.losses == want.losses and all(torch.equal(got.grads[k], v)
                                              for k, v in want.grads.items())
    log(f"  {what}: {'bit for bit the plain step' if exact else 'not bit for bit'}; worst "
        f"relative loss {loss:.3g}, gradient {grad:.3g}, statistics {stats:.3g}")
    check(loss <= F32_TOL and grad <= TRAIN_GRAD_TOL and stats <= F32_TOL,
          f"{what}: past phase 6's tolerances")


def dist_cli(n: int, root: str) -> None:
    """`bin.train` of the flagship in n processes under SSD3D_DIST_* (one
    rank a card), in dp and in fsdp, DIST_CLI_ITERS iterations each; then a
    single-process `bin.train` resumes each run's checkpoint."""
    data, npz = os.path.join(root, "kitti"), os.path.join(root, "npz")
    synth.write_tree(data, n_train=DIST_CLI_SCANS, n_val=1, n_points=CLI_SCAN_POINTS, seed=1)
    opts = ["--device", DEV, "DATASET.KITTI.BASE_DIR_PATH", data,
            "DATASET.KITTI.TRAIN_LIST", os.path.join(data, "train.txt"),
            "DATASET.KITTI.VAL_LIST", os.path.join(data, "val.txt"),
            "DATASET.KITTI.SAVE_NUMPY_PATH", npz,
            "TRAIN.CONFIG.CHECKPOINT_INTERVAL", str(DIST_CLI_ITERS),
            "TRAIN.CONFIG.SUMMARY_INTERVAL", "1"]
    preprocess_cli.main(["--cfg", str(FLAGSHIP_CFG), "--img_list", "train"] + opts)
    for mode in ("dp", "fsdp"):
        run = os.path.join(root, f"run_{mode}")
        argv = ["-m", "ssd3d_torch.bin.train", "--cfg", str(FLAGSHIP_CFG), "--log_dir", run,
                "--max_iterations", str(DIST_CLI_ITERS)] + opts + ["TPU.PARALLEL_MODE", mode]
        port = free_port()
        env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent),
                   SSD3D_DIST_COORDINATOR=f"localhost:{port}", SSD3D_DIST_NUM_PROCESSES=str(n))
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, *argv], env=dict(env, SSD3D_DIST_PROCESS_ID=str(r)),
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(n)]
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        check(all(p.returncode == 0 for p in procs),
              f"bin.train under {mode}: exit codes {[p.returncode for p in procs]}:\n"
              + outs[0][-3000:])
        metrics = _metrics(run)
        check([m["iter"] for m in metrics] == list(range(1, DIST_CLI_ITERS + 1))
              and all(np.isfinite(m[k]) for m in metrics for k in LOSS_KEYS + ("total",)),
              f"bin.train under {mode}: metrics {metrics}")
        steps_saved = CheckpointManager(os.path.join(run, "ckpt")).all_steps()
        check(steps_saved == [DIST_CLI_ITERS], f"bin.train under {mode} saved steps {steps_saved}")
        sec = [m["sec_per_it"] for m in metrics[1:]]
        log(f"bin.train under SSD3D_DIST_* in {mode} over {n} rank(s): {DIST_CLI_ITERS} iterations "
            f"in {time.perf_counter() - t0:.1f} s, median {statistics.median(sec):.4f} s/it, "
            f"total loss " + ", ".join(f"{m['total']:.4f}" for m in metrics))
        train_cli.main(["--cfg", str(FLAGSHIP_CFG), "--log_dir", run,
                        "--max_iterations", str(DIST_CLI_ITERS + 1)] + opts)
        with open(os.path.join(run, "log_train.txt")) as f:
            check(f"restored checkpoint at step {DIST_CLI_ITERS}" in f.read(),
                  f"the single process did not resume the {mode} run's checkpoint")
        last = _metrics(run)[-1]
        check(last["iter"] == DIST_CLI_ITERS + 1 and np.isfinite(last["total"]),
              f"the resumed {mode} run logged {last}")
        log(f"  one process resumed the {mode} run's step-{DIST_CLI_ITERS} checkpoint: iteration "
            f"{last['iter']} total loss {last['total']:.4f}")


def phase_data_parallel() -> dict:
    """Phase 18: the flagship's train step under dp and fsdp over NCCL, one
    process a card on every card of the machine -> the launches of each
    mode's step (rank 0's)."""
    n = torch.cuda.device_count()
    log(f"== phase 18: data-parallel and FSDP training over NCCL, {n} process(es), one a card; "
        f"the flagship's train step at batch {BATCH} (bf16), then bin.train under SSD3D_DIST_*")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    recs = run_ranks(n, DEV, [DIST_CASE], ["dp", "fsdp"], timed=DIST_TIMED)
    log(f"ranks ran in {time.perf_counter() - t0:.1f} s on {recs['device']} (rank 0), NCCL "
        f"{recs.get('nccl')}")
    plain = parallel_steps.single_step(DIST_CASE, DEV, timed=DIST_TIMED)
    paths = {}
    for mode in ("dp", "fsdp"):
        rec = recs[(DIST_CASE, mode)]
        check(all(rec.launches[k] > 0 for k in ("fps", "ffps", "ball_query", "gather",
                                                "scatter_add")),
              f"the {mode} step on rank 0: launches {rec.launches}")
        if n == 1:  # rank 0's batch is the whole batch of 8
            check(rec.routes == path_routes("3DSSD"), f"the {mode} step: routes {rec.routes}")
        paths[f"{mode}_train"] = dict(rec.launches, routes=rec.routes)
        log(f"the flagship's {mode} step over {n} card(s): {rec.ms:.2f} ms (rank 0, median of "
            f"{DIST_TIMED} steps after the compared one), the plain step {plain.ms:.2f} ms; rank "
            f"0's launches {rec.launches}")
        if n == 1:
            if mode == "dp":
                _same_step(rec, plain, "dp over one card against the plain step")
                log("  dp over one card: losses, every gradient leaf and the BatchNorm statistics "
                    "bit for bit the plain step's")
            else:
                _step_within(rec, plain, "fsdp over one card against the plain step")
    if n > 1:
        log(f"the f32 flagship over {n} cards against one process on the global batch, the "
            "ranks' decisions taken by the single process:")
        recs32 = run_ranks(n, DEV, [DIST_CASE_F32], ["dp", "fsdp"], record=True)
        for mode in ("dp", "fsdp"):
            rec = recs32[(DIST_CASE_F32, mode)]
            taken = parallel_steps.Decisions(rec.decisions)
            want = parallel_steps.single_step(DIST_CASE_F32, DEV, decisions=taken)
            worst = parallel_steps.compare(rec, want, f"{mode} over {n} cards")
            log(f"  {mode}: worst relative errors {worst}; decisions taken otherwise "
                f"{taken.differ}")
    with tempfile.TemporaryDirectory(prefix="ssd3d_dist_") as root:
        dist_cli(n, root)
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
             **timed(phase_cli_chain), **timed(phase_two_stage_training, report)}
    paths.update(timed(phase_ffps_dist, report))
    timed(phase_std_kernels, report)
    paths["std"] = timed(phase_std)
    timed(phase_two_stage_card_vs_cpu, scans, "std")
    paths.update(timed(phase_std_training))
    paths.update(timed(phase_train_options))
    paths.update(timed(phase_nuscenes, report))
    paths.update(timed(phase_attention_and_groupnorm, report))
    paths.update(timed(phase_data_parallel))
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
