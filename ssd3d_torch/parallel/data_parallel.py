"""Data parallelism over `torch.distributed` (counterpart of
`ssd3d/parallel/mesh.py` and of the batch handling in
`ssd3d/train/trainer.py`).

The JAX package runs one jitted step over a `Mesh('data')`: the batch is
sharded along it, and BatchNorm statistics and every loss normaliser are
those of the global batch because its arrays are global. The port keeps
that contract with one process a card:

- the global batch is cut into contiguous row ranges, rank r taking
  [r B / N, (r + 1) B / N) (`row_range`), loaded by that rank alone
  (`data.loader` row ranges);
- train-mode BatchNorm all-reduces its moments (`nn.layers.BatchNorm`),
  every loss divides by the count all-reduced over the ranks
  (`global_count`), and each rank's backward is scaled by N
  (`backward_scale`) so that the gradient average of DDP or FSDP leaves the
  sum of the ranks' numerators over the global count: the single-process
  gradient of the global batch;
- the step's random draws are made for the global batch from the (seed,
  step) generator and each rank keeps its rows (`local_rows`);
- `wrap` puts the graph's loss computation in a module (`LossModule`) and
  wraps it for PARALLEL_MODE `dp` (DDP, parameters replicated) or `fsdp`
  (FSDP2's `fully_shard` on every SA, vote, FP, pooler and head module, then
  on the root: parameters and Adam's moments sharded, the same update).

`SSD3D_MESH_INTERLEAVE`, the JAX package's knob that reorders a TPU mesh's
devices along its fastest links, has no counterpart: NCCL ranks have no
such layout, so rows stay contiguous by rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from ssd3d_torch.parallel.distributed import rank, world


def global_batch_size(batch_size: int, n_ranks: int) -> int:
    """The JAX trainer's rule (ssd3d/train/trainer.py:201-203): a global
    batch that the ranks do not divide shrinks to the largest multiple of
    their count, at least one row a rank."""
    if batch_size % n_ranks:
        return max(n_ranks, batch_size - batch_size % n_ranks)
    return batch_size


def row_range(batch_size: int, r: int, n_ranks: int) -> tuple[int, int]:
    """Rank r's contiguous rows [r B / N, (r + 1) B / N) of a global batch
    of B = batch_size rows that N = n_ranks divides."""
    if batch_size % n_ranks:
        raise ValueError(f"row_range: {n_ranks} ranks do not divide a batch of {batch_size}")
    per = batch_size // n_ranks
    return r * per, (r + 1) * per


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a tensor made for the global batch (leading axis
    world() x the rank's batch); the tensor itself with one rank."""
    n = world()
    if n == 1:
        return x
    lo, hi = row_range(x.shape[0], rank(), n)
    return x[lo:hi]


def global_count(mask: torch.Tensor) -> torch.Tensor:
    """A loss normaliser: mask.sum() over the batch of every rank (no
    gradient), at least 1 (the JAX package's `mask.sum()` over its global
    array, clamped)."""
    n = mask.detach().sum()
    if world() > 1:
        n = n.float().clone()
        dist.all_reduce(n)
    return n.clamp(min=1.0)


def backward_scale() -> float:
    """The factor of each rank's loss in its backward: N, so that DDP's and
    FSDP's gradient average over N ranks leaves the gradient of the sum of
    the ranks' losses (each already divided by the global count)."""
    return float(world())


@torch.no_grad()
def sum_over_ranks(metrics: dict) -> dict:
    """Each tensor of a metrics dict summed over the ranks (one all-reduce):
    the global loss, each rank's share being its numerator over the global
    count. Floats (the learning rate) pass as they are."""
    if world() == 1:
        return metrics
    keys = [k for k, v in metrics.items() if torch.is_tensor(v)]
    if not keys:
        return metrics
    flat = torch.stack([metrics[k].float().reshape(()) for k in keys])
    dist.all_reduce(flat)
    return {**metrics, **dict(zip(keys, flat.unbind()))}


def full(t: torch.Tensor) -> torch.Tensor:
    """A sharded tensor's whole value (an all-gather every rank takes part
    in); any other tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def local(t: torch.Tensor) -> torch.Tensor:
    """A sharded tensor's local shard; any other tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def shard_like(value: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """A whole tensor of `param`'s shape placed as `param` is: sharded as
    an FSDP2 parameter is, else as it is."""
    if isinstance(param, DTensor) and tuple(value.shape) == tuple(param.shape):
        return distribute_tensor(value.to(param.device), param.device_mesh, param.placements)
    return value


class LossModule(nn.Module):
    """A train graph's loss computation as a module, so that DDP and FSDP2
    see every forward of the step through their own: forward(batch, bn_m,
    draws) = graph.compute_losses(batch, bn_m, draws) -> (total, loss
    dict). The detector is its submodule `model`."""

    def __init__(self, graph):
        super().__init__()
        self.model = graph.model
        self._compute = graph.compute_losses

    def forward(self, batch: dict, bn_m: float, draws=None):
        return self._compute(batch, bn_m, draws)


def _fsdp_units(model: nn.Module) -> list[nn.Module]:
    """The modules FSDP2 shards one by one: every SA, vote, FP and global
    SA layer, the RoI poolers and the heads."""
    from ssd3d_torch.models.heads import DetectionHead, IoUHead
    from ssd3d_torch.models.two_stage import PointsPool, RegionPool
    from ssd3d_torch.nn.modules import (
        PointnetFPModule,
        PointnetSAModuleGlobal,
        PointnetSAModuleMSG,
        VoteLayer,
    )

    kinds = (PointnetSAModuleMSG, VoteLayer, PointnetFPModule, PointnetSAModuleGlobal,
             DetectionHead, IoUHead, RegionPool, PointsPool)
    return [m for m in model.modules() if isinstance(m, kinds)]


def wrap(graph, mode: str) -> nn.Module:
    """The graph's `LossModule`, wrapped for PARALLEL_MODE `mode` over the
    default process group: "dp" in DDP (parameters replicated; BatchNorm
    buffers equal on every rank by construction, so not broadcast), "fsdp"
    in FSDP2 (each of `_fsdp_units`, then the root; the detector's
    parameters become sharded DTensors in place, so the optimizer is built
    after this)."""
    module = LossModule(graph)
    if mode == "dp":
        from torch.nn.parallel import DistributedDataParallel

        dev = next(graph.model.parameters()).device
        return DistributedDataParallel(
            module, device_ids=[dev] if dev.type == "cuda" else None,
            broadcast_buffers=False, find_unused_parameters=True)
    if mode == "fsdp":
        from torch.distributed.fsdp import fully_shard

        for unit in _fsdp_units(graph.model):
            fully_shard(unit)
        return fully_shard(module)
    raise ValueError(f"unknown TPU.PARALLEL_MODE {mode!r}")
