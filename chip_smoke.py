#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`ssd3d_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Six phases, each of which raises on failure (no error is caught):

1. Environment: the card's name and power limit, torch / CUDA / nvcc
   versions, and the build of the CUDA kernels from `ssd3d_torch/csrc/`
   (one nvcc per source, in parallel).
2. Each kernel against its plain PyTorch version on the card, at the
   flagship's shapes (batch 8), with the kernel's and the plain version's
   median times; for the scatter-add (the gather's backward, whose float
   atomics add in no fixed order) also the difference between two launches.
3. The main path: flagship 3DSSD inference (KITTI Car,
   `configs/kitti/3dssd/3dssd.yaml`, 16,384-point scans, bf16 as shipped,
   seeded weights) on a batch of 8 synthetic KITTI-like scans: forward,
   decode and NMS. Asserts finite outputs, at most 100 boxes per scan and
   that every kernel was launched; prints scans/s at batch 8 and the median
   batch-1 latency.
4. The card against the CPU on one scan: the kernel path on the GPU and the
   plain path on the CPU, same weights, compared pick by pick and box by box.
5. The training path: the flagship train step (`train_entry`, batch 8 =
   BATCH_SIZE 4 x GPU_NUM 2, bf16, Adam, fixed batch of synthetic scenes):
   a warm-up step and ten timed ones. Asserts finite losses, a lower total
   after the last step than after the first, moved BatchNorm statistics and
   that every kernel launched in one step (the scatter-add 8 times); prints
   the step time, training scans/s, peak memory and a profile of one step.
6. One f32 train step on the card against the CPU on 2 scans, same weights:
   sampling picks, losses, every gradient leaf and the new BatchNorm
   statistics.

The second line from the end is a JSON object with one entry per kernel
(its launches are those of one training step, phase 5);
the last line is {"ok": true, "device": {...}}. Without a CUDA device the
script exits with code 1 and prints no result.
"""

from __future__ import annotations

import copy
import json
import re
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from ssd3d_torch.entry import flagship, synthetic_scenes, train_entry
from ssd3d_torch.nn import modules
from ssd3d_torch.nn.modules import ffps_segments
from ssd3d_torch.nn.modules import max_pool as _max_pool
from ssd3d_torch.ops import _build
from ssd3d_torch.ops.grouping import (
    ball_query_multi,
    ball_query_multi_plain,
    gather_rows,
    gather_rows_plain,
    ring_specs,
    scatter_add_rows,
    scatter_add_rows_plain,
)
from ssd3d_torch.ops.sampling import (
    farthest_point_sample,
    farthest_point_sample_features,
    ffps_plain,
    fps_pick_shortfall,
    fps_plain,
    gather_points,
)
from ssd3d_torch.train.schedules import bn_momentum
from ssd3d_torch.train.train_step import TrainGraph

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
# K5 against index_add_: both add in their own order, f32 atomics on the card
K5_RTOL = 1e-5
TRAIN_STEPS = 10
# One f32 train step, card against CPU: each gradient leaf within this
# fraction of its largest |entry|.
TRAIN_GRAD_TOL = 1e-3
_relu = torch.relu


def check(ok: bool, what: str) -> None:
    """Fail the run (a check, not an assert: it holds under python -O too)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def log(msg: str = "") -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Median device time of fn() in ms, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
        entry = re.search(r"entry function '.*?\d+([a-z_]+_kernel)(?:ILi(\d+)E)?", line)
        if entry:
            name = entry.group(1) + (f"<{entry.group(2)}>" if entry.group(2) else "")
        elif "Used" in line or "spill stores" in line:
            log(f"  ptxas {name}: {line.split(':', 1)[-1].strip()}")
    return card


# ----------------------------------------------------------------- phase 2

def phase_kernels(scans: torch.Tensor) -> list[dict]:
    log(f"== phase 2: kernels against their plain versions (batch {BATCH})")
    dev = scans.device
    gen = torch.Generator().manual_seed(1)
    xyz = scans[..., :3].contiguous()
    report = []

    # K1: D-FPS, SA1 16,384 -> 4,096 (the other D-FPS calls are smaller)
    picks = farthest_point_sample(xyz, 4096)
    plain = fps_plain(xyz, 4096)
    check(torch.equal(picks, plain), "D-FPS kernel disagrees with its plain version")
    ms = cuda_ms(lambda: farthest_point_sample(xyz, 4096), 5)
    plain_ms = cuda_ms(lambda: fps_plain(xyz, 4096), 3)
    log(f"K1 D-FPS {list(xyz.shape)} -> 4096: picks equal; {ms:.3f} ms vs plain {plain_ms:.3f} ms")
    report.append(dict(name="fps", route="cuda", source="ssd3d_torch/csrc/fps.cu",
                       replaces="ssd3d/ops/pallas/fps.py:126", launches=0,
                       max_abs_err=float((picks - plain).abs().max()), ms=ms,
                       plain_ms=plain_ms, shape=f"{list(xyz.shape)} -> 4096", check="equal"))

    # K2: F-FPS at SA2 (4,096 x 67 -> 512) and SA3 (512 x 131 -> 256)
    xyz1 = gather_points(xyz, picks)
    worst, k2_times = 0.0, []
    for n, c, m in ((4096, 67, 512), (512, 131, 256)):
        feat = torch.randn(BATCH, n, c - 3, generator=gen).to(dev).relu()
        fused = torch.cat([xyz1[:, :n], feat], -1)
        got = farthest_point_sample_features(fused, m)
        ref = ffps_plain(fused, m)
        check(bool((got[:, 0] == 0).all()), "F-FPS pick 0 is not index 0")
        short = fps_pick_shortfall(fused, got)
        check(short <= FFPS_TIE_RTOL, f"F-FPS pick {short:.3g} below the farthest point")
        worst = max(worst, short)
        same = int((got == ref).sum())
        ms = cuda_ms(lambda: farthest_point_sample_features(fused, m), 5)
        plain_ms = cuda_ms(lambda: ffps_plain(fused, m), 3)
        k2_times.append((ms, plain_ms, f"{list(fused.shape)} -> {m}"))
        log(f"K2 F-FPS {list(fused.shape)} -> {m}: worst relative shortfall {short:.3g}; "
            f"{same}/{got.numel()} picks equal to plain; {ms:.3f} ms vs plain {plain_ms:.3f} ms")
    report.append(dict(name="ffps", route="cuda", source="ssd3d_torch/csrc/ffps.cu",
                       replaces="ssd3d/ops/pallas/fps.py:310", launches=0, max_abs_err=worst,
                       ms=k2_times[0][0], plain_ms=k2_times[0][1], shape=k2_times[0][2],
                       check="tie-aware: max relative shortfall of a pick"))

    # K3: ball query at all four SA layers' shapes
    cg_pts = xyz1[:, :512].contiguous()
    cg_q = (cg_pts[:, :256] + torch.randn(BATCH, 256, 3, generator=gen).to(dev)).contiguous()
    k3 = [
        ("SA1", xyz, xyz1, [0.2, 0.4, 0.8], [32, 32, 64], True),
        ("SA2", xyz1, xyz1[:, :1024].contiguous(), [0.4, 0.8, 1.6], [32, 32, 64], True),
        ("SA3", xyz1[:, :1024].contiguous(), xyz1[:, :512].contiguous(),
         [1.6, 3.2, 4.8], [32, 32, 32], True),
        ("CG-SA", cg_pts, cg_q, [4.8, 6.4], [16, 32], False),
    ]
    k3_times, idx_sa = [], {}
    for name, pts, q, radii, ns, dilated in k3:
        got = ball_query_multi(radii, ns, pts, q, dilated=dilated)
        specs = ring_specs(radii, ns, dilated)
        ref = ball_query_multi_plain(specs, pts, q)
        for (gi, gc), (ri, rc) in zip(got, ref):
            check(torch.equal(gc, rc), f"ball query cnt differs at {name}")
            check(torch.equal(gi, ri), f"ball query idx differs at {name}")
        idx_sa[name] = got[-1][0]
        ms = cuda_ms(lambda: ball_query_multi(radii, ns, pts, q, dilated=dilated), 10)
        plain_ms = cuda_ms(lambda: ball_query_multi_plain(specs, pts, q), 3)
        k3_times.append((ms, plain_ms, f"{name} {list(q.shape)} x {list(pts.shape)}"))
        fill = [f"{float(c.float().mean()):.1f}" for _, c in got]
        log(f"K3 ball query {name} {list(q.shape)} x {list(pts.shape)} rings {radii}: "
            f"idx and cnt equal (mean cnt {fill}); {ms:.3f} ms vs plain {plain_ms:.3f} ms")
    report.append(dict(name="ball_query", route="cuda", source="ssd3d_torch/csrc/ball_query.cu",
                       replaces="ssd3d/ops/pallas/ring_words.py:144", launches=0,
                       max_abs_err=0.0, ms=k3_times[0][0], plain_ms=k3_times[0][1],
                       shape=k3_times[0][2], check="equal"))

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
        k4_times.append((ms, plain_ms, f"{list(src.shape)} x {flat.shape[1]} rows"))
        log(f"K4 gather {list(src.shape)} x {flat.shape[1]} rows: "
            f"bit-identical; {ms:.3f} ms vs plain {plain_ms:.3f} ms")
    report.append(dict(name="gather", route="cuda", source="ssd3d_torch/csrc/gather.cu",
                       replaces="ssd3d/ops/pallas/gather.py:57", launches=0, max_abs_err=0.0,
                       ms=k4_times[0][0], plain_ms=k4_times[0][1], shape=k4_times[0][2],
                       check="bit-identical"))

    # K5: the gather's backward at each layer's largest backward shape, on
    # that layer's last (largest) ring from the ball query above
    k5 = []
    for name, n, c in (("SA2", 4096, 67), ("SA3", 1024, 131), ("CG-SA", 512, 259)):
        idx = idx_sa[name].reshape(BATCH, -1).contiguous()
        g = torch.randn(BATCH, idx.shape[1], c, generator=gen).to(dev)
        got, again = scatter_add_rows(idx, g, n), scatter_add_rows(idx, g, n)
        ref = scatter_add_rows_plain(idx, g, n)
        err, scale = float((got - ref).abs().max()), float(ref.abs().max())
        rerun = float((got - again).abs().max())
        check(err <= K5_RTOL * scale, f"scatter-add at {name} differs by {err:.3g}")
        ms = cuda_ms(lambda: scatter_add_rows(idx, g, n), 20)
        plain_ms = cuda_ms(lambda: scatter_add_rows_plain(idx, g, n), 20)
        k5.append((ms, plain_ms, f"{BATCH * idx.shape[1]} x {c} into {n}", err, rerun))
        log(f"K5 scatter-add {name} {BATCH * idx.shape[1]} rows x {c} into {n}: max |K5 - plain| "
            f"{err:.3g} (limit {K5_RTOL:g} x {scale:.3g}); two launches differ by {rerun:.3g}; "
            f"{ms:.3f} ms vs plain {plain_ms:.3f} ms")
    report.append(dict(name="scatter_add", route="cuda", source="ssd3d_torch/csrc/scatter_add.cu",
                       replaces="ssd3d/ops/pallas/scatter_add.py:68", launches=0,
                       max_abs_err=max(e[3] for e in k5), ms=k5[0][0], plain_ms=k5[0][1],
                       shape=k5[0][2], run_to_run_max_abs=max(e[4] for e in k5),
                       check=f"max |K5 - plain| <= {K5_RTOL:g} x max |plain|"))
    return report


# ----------------------------------------------------------------- phase 3

def phase_main_path(scans: torch.Tensor) -> dict[str, int]:
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
    check(all(v > 0 for k, v in launches.items() if k != "scatter_add"),
          f"a kernel was not launched: {launches}")
    check(launches["scatter_add"] == 0, "inference launched the gather's backward")
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

    profile_once(lambda: infer(scans), f"batch of {BATCH}")
    return launches


def profile_once(fn, what: str, top: int = 12) -> None:
    """Where the device time of one call goes (torch.profiler): wall, device
    busy share and the kernels that take most of it."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # a user annotation (the optimizer's step) spans kernels already counted
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"profiled {what}: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}%), "
        f"{sum(e.count for e in kernels)} kernel launches of {len(kernels)} names")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")


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


def compare_with_cpu(scan: torch.Tensor, dtype: str) -> bool:
    """Kernel path on the card against the plain path on the CPU for one
    scan. Continuous values are held to the tolerance wherever the two runs
    took the same discrete decisions (sampling picks, heading bins, NMS
    keeps); returns whether they took every one of them alike."""
    cfg, gmodel, gspec, _ = flagship(device="cuda", seed=0, compute_dtype=dtype)
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
    tol = F32_TOL if dtype == "float32" else BF16_TOL
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
    scan = scans[:1].contiguous()
    if compare_with_cpu(scan, "bfloat16"):
        return
    log("  at bf16 a near-tie (F-FPS distances, heading logits or NMS scores within "
        "a bf16 step) went another way on the card than on the CPU; comparing again "
        "with COMPUTE_DTYPE float32, where every decision must agree")
    check(compare_with_cpu(scan, "float32"), "float32: picks, bins or kept detections differ")


# ----------------------------------------------------------------- phase 5

LOSS_KEYS = ("cls", "offset", "angle", "corner", "vote")


def phase_training() -> dict[str, int]:
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
    check(all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}")
    check(launches["scatter_add"] == 8, "the gather's backward did not run once per "
          "gradient-carrying grouping gather (3 + 3 + 2)")
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
    log(f"train step at batch {BATCH}: median {statistics.median(times):.2f} ms "
        f"(min {min(times):.2f}, max {max(times):.2f}) over {TRAIN_STEPS} steps; "
        f"{BATCH * 1e3 / statistics.median(times):.2f} training scans/s; "
        f"peak memory {peak:.2f} GiB; {moved} BatchNorm statistics moved")
    profile_once(lambda: step(batch), f"train step at batch {BATCH}", top=16)
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
    data = {k: torch.from_numpy(v) for k, v in synthetic_scenes(n_scans, n).items()}
    gmodel.train()
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = phase_environment()
    # the synthetic KITTI-like scans of `train_entry`'s batch (ground plane,
    # car shells and clutter from `tools.synth_kitti.make_scene`)
    scans = torch.from_numpy(synthetic_scenes(BATCH, N_POINTS)["points"]).cuda()
    report = phase_kernels(scans)
    phase_main_path(scans)
    phase_card_vs_cpu(scans)
    launches = phase_training()
    phase_train_card_vs_cpu()
    for entry in report:
        entry["launches"] = launches[entry["name"]]
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
