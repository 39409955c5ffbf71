"""Faults planted under the timed path, to show that the comparison catches
them (the tests on the CPU; `calibrate.py --fault` on the card). Each wraps
the program and passes every other attribute through."""

from __future__ import annotations

import torch


class _Wrap:
    def __init__(self, program):
        self.program = program

    def __getattr__(self, name):
        return getattr(self.program, name)


class HalfBatch(_Wrap):
    """Inference on the first half of the batch only, its detections handed
    out for the second half too."""

    def infer(self, points):
        half = points.shape[0] // 2
        return self.program.infer(torch.cat([points[:half], points[:half]]))


class AlteredAnswer(_Wrap):
    """One detection box altered where it is produced."""

    def infer(self, points):
        dets = dict(self.program.infer(points))
        boxes = dets["boxes"].clone()
        boxes[0, 0, 0] += 0.5
        dets["boxes"] = boxes
        return dets


class HalfBatchStep(_Wrap):
    """A train step on the first half of the batch, its mean over those rows."""

    def step(self, batch):
        half = batch["points"].shape[0] // 2
        return self.program.step({k: v[:half] for k, v in batch.items()})


class HalfRowsStep(_Wrap):
    """A train step whose batch keeps its shape, its second half of rows
    replaced by the first half's: the forward sees the whole batch, the loss
    and the gradient are the mean over the first half's rows alone."""

    def step(self, batch):
        half = batch["points"].shape[0] // 2
        return self.program.step({k: torch.cat([v[:half], v[:half]]) for k, v in batch.items()})


class UnchangedState(_Wrap):
    """A train step that computes, then leaves the state as it found it:
    parameters, BatchNorm statistics and the optimizer's moments."""

    def step(self, batch):
        import copy
        prog = getattr(self.program, "state", None)
        if prog is not None:  # the port's TrainState
            model = copy.deepcopy(prog.model.state_dict())
            opt = copy.deepcopy(prog.optimizer.state_dict())
            loss = self.program.step(batch)
            prog.model.load_state_dict(model)
            prog.optimizer.load_state_dict(opt)
            return loss
        t = self.program.trainer  # the reference in the program's place
        saved = copy.deepcopy((t.params, t.mu, t.nu, t.count))
        loss = self.program.step(batch)
        t.params, t.mu, t.nu, t.count = saved
        self.program.first = {k: torch.zeros_like(v) for k, v in self.program.first.items()}
        return loss


class NoExchange(_Wrap):
    """A data-parallel train step whose gradients are never exchanged
    between the ranks: each rank steps on its own rows' gradient."""

    def step(self, batch):
        with self.program.state.parallel.no_sync():
            return self.program.step(batch)


FAULTS = {"half": HalfBatch, "altered": AlteredAnswer, "half_step": HalfBatchStep,
          "half_rows": HalfRowsStep,
          "unchanged": UnchangedState, "no_exchange": NoExchange}
