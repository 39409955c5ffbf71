"""The training cells: the program's train step driven through its first
steps in set-up, then on through the window, and the comparison that
decides `correct` for them.

Set-up builds one train state (model, optimizer) and drives it through
`checked_steps` steps on distinct batches of the pool, through the same
call and feed the window uses; what those steps produced is kept: each
step's loss, the first gradient as the optimizer got it (Adam's first
moment after step 1, over 1 - b1), and the leaves after the last checked
step. The window then goes on stepping the same state.

The reference (`reference.train.Trainer`) follows the checked steps from
the same seeded weights, on the same batches, with the decisions the
program's own forward made at each step, taken by a hook on each SA and
vote layer: the sampling picks, and the values of the vote-shifted centres
(the reference's gradient flows through its own), which decide the balls
of the CG layer and the targets each candidate is assigned. Float32
features pick, group and assign otherwise than bfloat16 ones at
near-ties, and a different pick is another network, not a rounding. Every
other part of the step (grouping, MLPs, BatchNorm, assignment, losses,
backward, clip, Adam) the reference computes itself. Numbers:

- `forward_gap`: the first step's forward in train mode judged layer by
  layer, as the inference cells' `layer_gap` (`judge.py`): each layer
  recomputed from the program's own inputs to it, BatchNorm on that
  layer's batch;
- `loss_gap`: |program's loss - reference's| / |reference's| of the first
  step (the later steps' are printed, not compared: Adam's first updates
  move each weight by about the learning rate whatever its gradient's
  size, so a gradient that is nought to rounding sends a weight either
  way, and the two networks part by more than their precision);
- `grad_gap`: the median leaf's |norm of the program's first gradient -
  the reference's|, over the larger of the reference's norm of that leaf
  and of the median leaf;
- `change_gap`: the median leaf's gap, so measured, of its change over the
  checked steps (parameters and BatchNorm running statistics);
- `change_worst`: the worst such gap over the leaves whose reference
  change is at least the median one's (a fault that moves a few leaves, or
  none, shows here and not in the median); `param_change_worst`: the same
  over the parameters alone, without the running statistics.

`grad_worst`, the worst leaf's gradient gap over the same large leaves, is
printed, not compared: it falls on the first SA layer's leaves, the end of
the backward chain, on every seed; bfloat16's rounding over that chain
moves it by 30-100% (in float32 the same run reads 1e-6), and the control
reads no more than that on some seeds.

All of them leave out the parameters whose reference gradient is under a
thousandth of the median leaf's (the biases under BatchNorm, which move by
round-off alone).
"""

from __future__ import annotations

import statistics

import torch

from portbench import judge as layers
from portbench.capture import Recorder
from portbench.reference import nets, train

B1 = 0.9


class PortTrainer:
    """The program's train step: its pipeline's `TrainGraph` and state."""

    def __init__(self, cfg: dict, nms_pre_topk: int, w: dict, device, sa_names: list[str],
                 parallel: str | None = None, watched: list[str] = ()):
        from ssd3d_torch.config import Config
        from ssd3d_torch.models.api import build_pipeline
        pipe = build_pipeline(Config(cfg), nms_pre_topk=nms_pre_topk, device=device)
        pipe.model.load_state_dict(w, strict=True)
        self.model, self.graph = pipe.model, pipe.graph
        self.state = self.graph.init_state(parallel)
        modules = dict(self.model.named_modules())
        self.picks: dict = {}
        self.handles = [modules[n].register_forward_hook(self._hook(n)) for n in sa_names]
        # every watched module's output in the first step
        self.outputs: dict = {}
        self.recorder = Recorder(self.model, list(watched), 1, 0)
        self.recorder.begin()

    def _hook(self, name):
        def hook(_m, _i, out):
            # an SA layer's picks, or a vote layer's shifted centres
            kept = out[2] if out[2].dtype == torch.int32 else out[0]
            self.picks[name] = kept.detach().clone()
        return hook

    def stop_watching(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []
        self.recorder.close()

    def step(self, batch: dict) -> torch.Tensor:
        loss = self.graph.train_step(self.state, batch)["total"]
        if self.recorder.current is not None:
            self.outputs = self.recorder.current["outputs"]
            self.recorder.current = None
        return loss

    def leaves(self) -> dict:
        """Parameters and BatchNorm running statistics by name."""
        return {k: v.detach() for k, v in self.model.state_dict().items()}

    def first_grad(self) -> dict:
        names = {id(p): n for n, p in self.model.named_parameters()}
        return {names[id(p)]: s["mu"] / (1 - B1) for p, s in self.state.optimizer.state.items()}


def gather_rows(picks: dict, ranks: int) -> dict:
    """Each rank's picks (or centres) of its rows -> the global batch's, in
    rank order, on every rank."""
    if ranks == 1:
        return picks
    import torch.distributed as dist
    out = {}
    for name, t in sorted(picks.items()):
        parts = [torch.empty_like(t) for _ in range(ranks)]
        dist.all_gather(parts, t.contiguous())
        out[name] = torch.cat(parts)
    return out


def gather_outputs(outputs: dict, ranks: int) -> dict:
    """Each rank's module outputs of its rows -> the global batch's (tensors,
    tuples of them and dicts of them), in rank order."""
    if ranks == 1:
        return outputs
    import torch.distributed as dist

    def cat(t):
        if t is None:
            return None
        parts = [torch.empty_like(t) for _ in range(ranks)]
        dist.all_gather(parts, t.detach().contiguous())
        return torch.cat(parts)

    out = {}
    for name in sorted(outputs):
        o = outputs[name]
        if isinstance(o, dict):
            out[name] = {k: cat(v) for k, v in sorted(o.items())}
        elif isinstance(o, tuple):
            out[name] = tuple(cat(v) for v in o)
        else:
            out[name] = cat(o)
    return out


def rank0_decides(device):
    """-> go(more): rank 0's `more` on every rank (one broadcast a step)."""
    import torch.distributed as dist
    flag = torch.zeros(1, dtype=torch.int32, device=device)

    def go(more: bool) -> bool:
        flag.fill_(int(more))
        dist.broadcast(flag, 0)
        return bool(flag.item())
    return go


def across_ranks(device, how, *values) -> list[float]:
    """Each value reduced over the ranks: `max` or "mean"."""
    import torch.distributed as dist
    t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX if how is max else dist.ReduceOp.SUM)
    if how == "mean":
        t /= dist.get_world_size()
    return t.tolist()


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(prog: dict, ref: dict, names) -> dict:
    """Each name's |norm(prog) - norm(ref)| / max(norm(ref), median norm(ref))."""
    ref_n = {k: _norm(ref[k]) for k in names}
    med = statistics.median(ref_n.values())
    return {k: abs((_norm(prog[k]) if k in prog else 0.0) - ref_n[k])  # absent: never moved
            / max(ref_n[k], med, 1e-30) for k in names}


def first_forward(det: nets.Detector, w: dict, outputs: dict, batch: dict):
    """The first step's forward in train mode, layer by layer from the
    program's own inputs to each layer (`judge.judge_backbone`), BatchNorm on
    each layer's batch -> a `judge.Verdict` (its layer_gap)."""
    p = nets.Params(w, det.bf16, training=True,
                    bn_m=train.schedule(det.cfg["SOLVER"], 0)[1])
    v = layers.Verdict()
    with torch.no_grad():
        lists = layers.judge_backbone(det.backbone, p, det.backbone.start(batch["points"]),
                                      outputs, v)
        if v.layer_gap != float("inf"):
            layers.judge_heads(det, det.heads, p, lists, outputs, v)
    return v


def _worst_big(gaps: dict, ref: dict) -> float:
    """The worst gap over the leaves whose reference norm is at least the
    median leaf's."""
    norms = {k: _norm(ref[k]) for k in gaps}
    med = statistics.median(norms.values())
    return max((g for k, g in gaps.items() if norms[k] >= med), default=float("nan"))


def judge(det: nets.Detector, w: dict, kept: dict, batches: list[dict]) -> tuple[dict, str]:
    """kept: the program's losses, first gradient, leaves after the checked
    steps and picks of each step -> (numbers, where the worst ones are)."""
    rows = batches[0]["points"].shape[0]
    seen = {v.shape[0] for picks in kept["picks"] for v in picks.values()}
    if seen != {rows}:
        inf = float("inf")
        return ({k: inf for k in ("forward_gap", "loss_gap", "grad_gap", "change_gap",
                                  "grad_worst", "change_worst", "param_change_worst")},
                f"the program's forward saw {sorted(seen)} rows of a batch of {rows}")
    forward = first_forward(det, w, kept["outputs"], batches[0])
    ref = train.Trainer(det, w, det.spec)
    losses, grads = [], None
    for s, batch in enumerate(batches):
        out = ref.step(batch, s, picks=kept["picks"][s])
        losses.append(float(out["loss"]))
        if s == 0:
            grads = out["grads"]
    step_gaps = [abs(float(p) - r) / max(abs(r), 1e-30) for p, r in zip(kept["losses"], losses)]
    # the leaves whose gradient is nought to rounding in the reference (the
    # biases under BatchNorm) are left out of both comparisons
    g_med = statistics.median(_norm(g) for g in grads.values())
    live = [k for k in grads if _norm(grads[k]) >= 1e-3 * g_med]
    firsts = leaf_gaps(kept["first_grad"], grads, live)
    moved = live + [k for k in ref.params if k not in grads]  # and the running statistics
    delta_p = {k: kept["leaves"][k].float() - w[k] for k in moved}
    delta_r = {k: ref.params[k].detach() - w[k] for k in moved}
    changes = leaf_gaps(delta_p, delta_r, moved)
    param_changes = leaf_gaps(delta_p, delta_r, live)
    numbers = {"forward_gap": forward.layer_gap, "loss_gap": step_gaps[0],
               "grad_gap": statistics.median(firsts.values()),
               "change_gap": statistics.median(changes.values()),
               "grad_worst": _worst_big(firsts, grads),
               "change_worst": _worst_big(changes, delta_r),
               "param_change_worst": _worst_big(param_changes, delta_r)}
    g_worst, c_worst = max(firsts, key=firsts.get), max(changes, key=changes.get)
    p_worst = max(param_changes, key=param_changes.get)
    where = (f"first forward's worst layer {forward.where}; "
             f"losses {[round(float(x), 6) for x in kept['losses']]} against "
             f"{[round(x, 6) for x in losses]} (later steps' gaps "
             f"{[round(x, 5) for x in step_gaps[1:]]}); worst leaf's gradient gap "
             f"{firsts[g_worst]:.4g} at {g_worst}, change gap {changes[c_worst]:.4g} at "
             f"{c_worst} (of a parameter {param_changes[p_worst]:.4g} at {p_worst}); "
             f"{len(grads) - len(live)} leaves with no gradient left out")
    return numbers, where
