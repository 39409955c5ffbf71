"""One train step under data parallelism against the single-process step on
the same global batch: the check behind `entry.dryrun_multichip`, the CPU
tests (gloo) and `chip_smoke.py` (NCCL, one process a card).

A case names a model and its global batch (`CASES`): the 3DSSD flagship
(`entry.flagship`, `shrink` dividing its sample counts, at `dtype`) or
PointRCNN's stage 2 (`configs/kitti/pointrcnn/pointrcnn_{tiny_,}stage2.yaml`,
the RPN frozen, the minibatch drawn from the step's (seed, step) generator
for the global batch and sliced by rank). `single_step` runs the plain step
on the whole batch; `rank_step` runs this rank's rows wrapped for `dp` or
`fsdp` in the default process group. Both return a `StepRecord`: the
losses (summed over the ranks), every gradient leaf after the clip (whole,
on the CPU) and the BatchNorm statistics after the step. `compare` holds
one to the other; the step is compared before Adam, whose first update is
about lr * sign(g) and turns rounding of a near-zero gradient into a full
step.

The ranks sum each BatchNorm moment in another order than one process
does, so activations part at f32 rounding, and a decision taken on a value
within rounding of its threshold can go the other way: a ReLU's sign, a
max-pool's winner, a ball's member around a vote-shifted centre, an FPS
pick. One flipped ReLU moves a head leaf's gradient by percents. So the
ranks record their decisions (`Decisions`) and the single-process step
takes them (over more than one rank); every decision it would have taken
otherwise must be a near-tie on its own values, and is counted.

Run as a module, it is one rank of such a run:

    python -m ssd3d_torch.parallel.steps --rank R --world N --port P \\
        --device cpu|cuda --case NAME --mode dp|fsdp [--record] --out FILE

each rank on its card (LOCAL_RANK = R) or on the CPU (gloo); rank 0 writes
the records to FILE (`torch.save`; `load_records` reads them), with
`--record` every rank's decisions joined.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import statistics
import time
from pathlib import Path
from unittest import mock

import torch
import torch.distributed as dist

from ssd3d_torch.parallel import data_parallel as dp
from ssd3d_torch.parallel.distributed import rank, world

CONFIGS = Path(__file__).resolve().parents[2] / "configs" / "kitti"

# losses within this share of the single-process loss; each gradient leaf
# within GRAD_TOL of its largest |value|; BatchNorm statistics within
# STATS_TOL of the buffer's largest |value| (at least 1). Ranks sum their
# shares of each reduction in another order than one process does, so
# values part at f32 rounding.
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
STATS_TOL = 1e-5
# a replayed ReLU sign or max-pool winner must lie within this share of the
# tensor's largest |value| of its threshold on the replaying leg's values; a
# replayed ball must move a point within BALL_TIE_RTOL of r^2 from a ring's
# bound (its centre moved with the votes by rounding); replayed FPS picks
# must fall short of the farthest point by at most FPS_TIE_RTOL
TIE_TOL = 1e-4
BALL_TIE_RTOL = 1e-3
FPS_TIE_RTOL = 1e-5

# the stage-2 overrides that give a seeded RPN's proposals targets (as the
# two-stage train tests take them): more proposals, lower IoU thresholds
STAGE2_OPTS = ["MODEL.FIRST_STAGE.MAX_OUTPUT_NUM", "128",
               "MODEL.SECOND_STAGE.CLASSIFICATION_POS_IOU", "0.2",
               "MODEL.SECOND_STAGE.CLASSIFICATION_NEG_IOU", "0.15"]

CASES = {
    # the CPU tests' and dryrun_multichip's: few points, f32
    "3dssd_shrunk": dict(model="3dssd", shrink=8, batch=2, dtype="float32"),
    "pointrcnn2_tiny": dict(model="pointrcnn2", config="pointrcnn_tiny_stage2.yaml", batch=2,
                            points=2048, dtype="float32"),
    # the card's: the flagship at full width and depth, the config's batch
    # of 8 (BATCH_SIZE 4 x GPU_NUM 2), bf16 as shipped; at f32 to be held to
    # the single process over more than one card (at bf16 a rounding-level
    # difference of the ranks' sums moves a product by a bf16 step)
    "3dssd": dict(model="3dssd", shrink=1, batch=8, dtype=None),
    "3dssd_f32": dict(model="3dssd", shrink=1, batch=8, dtype="float32"),
}


@dataclasses.dataclass
class StepRecord:
    losses: dict  # name -> float, the global batch's
    grads: dict  # parameter name -> CPU tensor, after the clip
    stats: dict  # BatchNorm buffer name -> CPU tensor, after the step
    ms: float  # the step's host milliseconds (synchronised; see `_record`)
    launches: dict  # the kernels' launches in the step (this rank's)
    routes: dict  # and by route (`_build.route_launches`)
    decisions: dict | None = None  # the rank's `Decisions.log`


class Decisions:
    """The discrete decisions of a train step, recorded on one leg and
    replayed on another: the ranks (each on its rows; `join` puts their logs
    together along the batch axis, axis 0 of every call: scans, or RoIs
    scan-major) and the single-process step, or a card leg and a CPU copy
    of it (`chip_smoke.py`). `recording` says which leg a call belongs to;
    with `by_device`, a call on a CUDA tensor records and a call on the CPU
    replays, for two forwards run one after the other under one patch.

    The replaying leg takes the recorded decision; `differ` counts those it
    would have taken otherwise (of `total`), and each must be a near-tie on
    its own values:
    - a ReLU sign or max-pool winner: within TIE_TOL of the tensor's largest
      |value| of its threshold;
    - a ball query, D-FPS or F-FPS answer: equal wherever the call's batch
      row had bit-identical inputs on both legs; else a differing ball must
      move a point that lies within BALL_TIE_RTOL of a ring's bound, and
      differing picks must be a farthest-point sequence on the replaying
      leg's own inputs (`fps_pick_shortfall` within FPS_TIE_RTOL).
    With `plain`, a ball query recorded on the card is also held to its
    plain version on the same inputs."""

    KINDS = ("relu", "max_pool", "ball_query", "fps", "ffps")

    def __init__(self, log: dict | None = None, kinds=KINDS, by_device: bool = False,
                 plain: bool = False):
        from ssd3d_torch.nn import layers, modules

        # the functions the patches stand in for, as they are unpatched
        self._relu, self._max_pool = torch.relu, layers.max_pool
        self._ball, self._fps = modules.ball_query_multi, modules.farthest_point_sample
        self._ffps = modules.farthest_point_sample_features
        self.recording = log is None
        self.log = log if log is not None else {k: [] for k in self.KINDS}
        self.kinds, self.by_device, self.plain = tuple(kinds), by_device, plain
        self.pos = dict.fromkeys(self.KINDS, 0)
        self.differ = dict.fromkeys(self.KINDS, 0)
        self.total = dict.fromkeys(self.KINDS, 0)
        self.ball_gap = 0.0  # the largest relative gap of a differing ball's nearest move

    @staticmethod
    def join(logs: list[dict]) -> dict:
        """The ranks' logs, in rank order, joined call by call along axis 0."""
        def cat(items):
            if isinstance(items[0], torch.Tensor):
                return torch.cat(items)
            return [cat(list(parts)) for parts in zip(*items)]

        return {k: [cat(list(calls)) for calls in zip(*(log[k] for log in logs))]
                for k in Decisions.KINDS}

    def patches(self) -> list:
        """The patches of `kinds` (torch.relu, `nn.layers.max_pool` and
        `nn.modules`' names)."""
        from ssd3d_torch.nn import layers, modules

        target = dict(relu=torch, max_pool=layers, ball_query=modules, fps=modules,
                      ffps=modules)
        name = dict(relu="relu", max_pool="max_pool", ball_query="ball_query_multi",
                    fps="farthest_point_sample", ffps="farthest_point_sample_features")
        return [mock.patch.object(target[k], name[k], getattr(self, k)) for k in self.kinds]

    @contextlib.contextmanager
    def patched(self):
        with contextlib.ExitStack() as stack:
            for patch in self.patches():
                stack.enter_context(patch)
            yield self

    def consumed(self) -> bool:
        """Whether the replaying leg took every recorded decision."""
        return all(self.pos[k] == len(self.log[k]) for k in self.kinds)

    def _records(self, t: torch.Tensor) -> bool:
        if self.by_device:
            self.recording = t.is_cuda
        return self.recording

    def _next(self, kind: str):
        entry = self.log[kind][self.pos[kind]]
        self.pos[kind] += 1
        return entry

    def _count(self, kind: str, differ: torch.Tensor) -> None:
        self.differ[kind] += int(differ.sum())
        self.total[kind] += differ.numel()

    def relu(self, x):
        if self._records(x):
            self.log["relu"].append((x > 0).cpu())
            return self._relu(x)
        mask = self._next("relu").to(x.device)
        flipped = mask != (x > 0)
        self._count("relu", flipped)
        if flipped.any() and (float(x.detach()[flipped].abs().max())
                              > TIE_TOL * float(x.detach().abs().max())):
            raise AssertionError("a ReLU sign differs from the recorded one away from 0")
        return torch.where(mask, x, x.new_zeros(()))

    def max_pool(self, grouped):
        out = self._max_pool(grouped)
        if self._records(grouped):
            self.log["max_pool"].append((grouped == out[:, :, None]).cpu())
            return out
        won = self._next("max_pool").to(grouped.device)
        self._count("max_pool", (won != (grouped == out[:, :, None])).any(2))
        at_theirs = grouped.masked_fill(~won, float("-inf")).amax(2)
        if float((out - at_theirs).detach().abs().max()) > TIE_TOL * float(
                grouped.detach().abs().max()):
            raise AssertionError("a max-pool winner differs from the recorded one away from a tie")
        w = won.to(grouped.dtype)  # the recorded winners, the gradient split as amax splits it
        return (grouped * w).sum(2) / w.sum(2)

    def _replay(self, kind: str, inputs: list, own: list) -> tuple[list, torch.Tensor]:
        """Record (inputs, answers) or replay them -> (the answers to return,
        the batch rows whose inputs were bit-identical on both legs)."""
        if self._records(inputs[0]):
            self.log[kind].append(([t.detach().cpu() for t in inputs], [t.cpu() for t in own]))
            return own, None
        their_in, theirs = self._next(kind)
        dev = inputs[0].device
        same = torch.ones(inputs[0].shape[0], dtype=torch.bool, device=dev)
        for a, b in zip(their_in, inputs):
            if a.shape != b.shape:
                raise AssertionError(f"a {kind} call's inputs differ in shape between the legs")
            same &= (a.to(dev) == b.detach()).flatten(1).all(1)
        return [t.to(dev) for t in theirs], same

    def ball_query(self, radius_list, nsample_list, xyz, new_xyz, dilated=False):
        from ssd3d_torch.ops.grouping import _pairwise_dist2, ball_query_multi_plain, ring_specs

        own = self._ball(radius_list, nsample_list, xyz, new_xyz, dilated=dilated)
        specs = ring_specs(radius_list, nsample_list, dilated)
        if self.plain and self._records(xyz) and xyz.is_cuda:
            for (gi, gc), (pi, pc) in zip(own, ball_query_multi_plain(specs, xyz, new_xyz)):
                if not (torch.equal(gi, pi) and torch.equal(gc, pc)):
                    raise AssertionError("a ball query kernel differs from its plain version on "
                                         "the step's inputs")
        flat = [t for pair in own for t in pair]
        theirs, same = self._replay("ball_query", [xyz, new_xyz], flat)
        if same is None:
            return own
        out = [(theirs[2 * i], theirs[2 * i + 1]) for i in range(len(own))]
        for (ti, tc), (oi, oc), (lo2, hi2, _, annulus) in zip(out, own, specs):
            rows = (ti != oi).any(-1) | (tc != oc)
            self._count("ball_query", rows)
            if (rows & same[:, None]).any():
                raise AssertionError("a ball differs from the recorded one on equal inputs")
            bounds = [hi2] + ([lo2] if annulus and lo2 > 0 else [])
            for b, q in rows.nonzero().tolist():
                moved = (set(ti[b, q, :int(tc[b, q])].tolist())
                         ^ set(oi[b, q, :int(oc[b, q])].tolist()))
                d2 = _pairwise_dist2(new_xyz[b:b + 1, q:q + 1].detach(),
                                     xyz[b:b + 1].detach())[0, 0]
                gap = min((abs(float(d2[p]) - r2) / r2 for p in moved for r2 in bounds),
                          default=float("inf"))
                self.ball_gap = max(self.ball_gap, gap)
                if gap > BALL_TIE_RTOL:
                    raise AssertionError(
                        f"a ball (scan {b}, centre {q}) differs from the recorded one, its "
                        f"nearest moved point {gap:.3g} of r^2 from a bound: not a near-tie")
        return out

    def _picks(self, kind: str, fn, points, npoint):
        from ssd3d_torch.ops.sampling import fps_pick_shortfall

        own = fn(points, npoint)
        (theirs,), same = self._replay(kind, [points], [own])
        if same is None:
            return own
        rows = (theirs != own).any(1)
        self._count(kind, theirs != own)
        if (rows & same).any():
            raise AssertionError(f"{kind} picks differ from the recorded ones on equal inputs")
        if rows.any():
            short = fps_pick_shortfall(points.detach()[rows], theirs[rows])
            if short > FPS_TIE_RTOL:
                raise AssertionError(f"the recorded {kind} picks fall {short:.3g} short on this "
                                     "leg's inputs: not a near-tie")
        return theirs

    def fps(self, xyz, npoint):
        return self._picks("fps", self._fps, xyz, npoint)

    def ffps(self, fused, npoint):
        return self._picks("ffps", self._ffps, fused, npoint)


def build(case: str, device, seed: int = 0):
    """(graph, global batch as numpy arrays) of a case on `device`."""
    from ssd3d_torch.config import load_cfg
    from ssd3d_torch.entry import flagship, init_weights, synthetic_scenes
    from ssd3d_torch.models.api import build_pipeline
    from ssd3d_torch.train.train_step import TrainGraph

    spec = CASES[case]
    if spec["model"] == "3dssd":
        cfg, model, det_spec, n = flagship(shrink=spec["shrink"], compute_dtype=spec["dtype"],
                                           device=device, seed=seed)
        graph = TrainGraph.build(cfg, model, det_spec)
    else:
        opts = STAGE2_OPTS + (["TPU.COMPUTE_DTYPE", spec["dtype"]] if spec["dtype"] else [])
        cfg = load_cfg(str(CONFIGS / "pointrcnn" / spec["config"]), opts)
        pipe = build_pipeline(cfg, nms_pre_topk=512, device=device)
        init_weights(pipe.model, seed)
        graph, n = pipe.graph, spec["points"]
    return graph, synthetic_scenes(spec["batch"], n, seed)


def _timed_step(graph, state, batch: dict, seed: int):
    """One step -> (its metrics, its host ms, synchronised on the card)."""
    dev = batch["points"].device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    metrics = graph.train_step(state, batch, seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return metrics, (time.perf_counter() - t0) * 1e3


def _record(graph, state, batch: dict, seed: int, decisions: Decisions | None,
            timed: int) -> StepRecord:
    """The first step from `state` recorded; with `timed`, that many more
    steps after it on the same batch give the step time (their median: the
    first step of a wrapped model also sets the wrapper up)."""
    from ssd3d_torch.ops import _build

    _build.reset_launches()
    with decisions.patched() if decisions else contextlib.nullcontext():
        metrics, ms = _timed_step(graph, state, batch, seed)
    launches, routes = _build.launches(), _build.route_launches()
    grads = {}
    for name, p in state.model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        grads[name] = dp.full(g).detach().float().cpu()
    stats = {k: v.detach().cpu().clone() for k, v in state.model.named_buffers()
             if k.endswith((".mean", ".var"))}
    losses = {k: float(v) for k, v in metrics.items() if k != "lr"}
    if timed:
        ms = statistics.median(_timed_step(graph, state, batch, seed)[1] for _ in range(timed))
    return StepRecord(losses, grads, stats, ms, launches, routes,
                      decisions.log if decisions and decisions.recording else None)


def single_step(case: str, device, seed: int = 0, timed: int = 0,
                decisions: Decisions | None = None) -> StepRecord:
    """The plain step of `case` on its whole global batch, taking the
    ranks' `decisions` where given; with `timed`, timed over that many
    steps after it."""
    graph, data = build(case, device, seed)
    batch = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
    return _record(graph, graph.init_state(), batch, seed, decisions, timed)


def rank_step(case: str, mode: str, device, seed: int = 0, timed: int = 0,
              record: bool = False) -> StepRecord:
    """This rank's step of `case` in the default process group: its rows of
    the global batch, the model wrapped for `mode`; the record holds the
    global losses, the whole gradients (every rank gathers), with `record`
    this rank's decisions (which cost host copies of every ReLU mask) and
    with `timed` the median time of that many steps after it."""
    graph, data = build(case, device, seed)
    lo, hi = dp.row_range(data["points"].shape[0], rank(), world())
    batch = {k: torch.from_numpy(v[lo:hi]).to(device) for k, v in data.items()}
    return _record(graph, graph.init_state(mode), batch, seed, Decisions() if record else None,
                   timed)


def _grad_scale(name: str, grads: dict) -> float:
    """The scale a gradient leaf is held at: its largest |value|; for a
    Dense bias before a BatchNorm, whose gradient is exactly 0 (the batch
    mean takes it out) and holds rounding only, its kernel's."""
    if name.endswith("conv.bias") and name[:-9] + "bn.scale" in grads:
        name = name[:-4] + "kernel"
    return max(float(grads[name].abs().max()), 1e-30)


def compare(got: StepRecord, want: StepRecord, what: str) -> dict:
    """Hold a data-parallel record to the single-process one at LOSS_RTOL,
    GRAD_TOL and STATS_TOL -> the worst errors; raises past a tolerance."""
    if set(got.losses) != set(want.losses) or set(got.grads) != set(want.grads):
        raise AssertionError(f"{what}: keys differ")
    loss = max(abs(got.losses[k] - v) / max(abs(v), 1e-30) for k, v in want.losses.items())
    grad = max(float((got.grads[k] - v).abs().max()) / _grad_scale(k, want.grads)
               for k, v in want.grads.items())
    stats = max((float((got.stats[k] - v).abs().max()) / max(float(v.abs().max()), 1.0)
                 for k, v in want.stats.items()), default=0.0)
    worst = dict(loss=loss, grad=grad, stats=stats)
    if loss > LOSS_RTOL or grad > GRAD_TOL or stats > STATS_TOL:
        raise AssertionError(f"{what}: worst relative errors {worst} past loss {LOSS_RTOL}, "
                             f"grad {GRAD_TOL}, stats {STATS_TOL}")
    return worst


def load_records(path: str) -> dict:
    """Rank 0's records as `main` wrote them, each step a `StepRecord`."""
    out = torch.load(path, weights_only=False)
    return {k: StepRecord(**v) if isinstance(v, dict) and "grads" in v else v
            for k, v in out.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m ssd3d_torch.parallel.steps")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--case", action="append", required=True)
    ap.add_argument("--mode", action="append", required=True)
    ap.add_argument("--timed", type=int, default=0, help="steps timed after the recorded one")
    ap.add_argument("--record", action="store_true", help="record the ranks' decisions")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    os.environ.update(SSD3D_DIST_COORDINATOR=f"localhost:{args.port}",
                      SSD3D_DIST_NUM_PROCESSES=str(args.world),
                      SSD3D_DIST_PROCESS_ID=str(args.rank), LOCAL_RANK=str(args.rank))
    from ssd3d_torch.parallel.distributed import initialize_from_env, rank_device

    initialize_from_env(lambda msg: None, args.device)
    device = rank_device(args.device)
    out = {"device": str(device), "world": world()}
    if device.type == "cuda":
        out["nccl"] = ".".join(map(str, torch.cuda.nccl.version()))
    try:
        for case in args.case:
            for mode in args.mode:
                rec = rank_step(case, mode, device, timed=args.timed, record=args.record)
                if args.record:
                    decisions = [None] * world()
                    dist.all_gather_object(decisions, rec.decisions)
                    rec.decisions = Decisions.join(decisions)
                out[(case, mode)] = dataclasses.asdict(rec)  # `load_records` rebuilds it
        if rank() == 0:
            torch.save(out, args.out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
