"""AdaBound (counterpart of `ssd3d/train/adabound.py`, an optax transform
there): Adam whose per-parameter step is clipped into bounds that close in
on `final_lr` as the step count grows, so that it turns SGD-like. No
shipped config selects it; SOLVER.TYPE 'AdaBound' does.

The arithmetic is the JAX transform's, in float32: with c the step count
after its increment, bc1 = 1 - b1^c, bc2 = 1 - b2^c, step_size = lr(c) *
sqrt(bc2) / bc1, the bounds final_lr * (1 -+ 1 / (gamma c + 1 or gamma c)),
and the update -clip(step_size / (sqrt(nu) + eps), lower, upper) * mu. The
learning rate is the schedule's at that incremented count, one step past
the one Adam reads, as the JAX transform calls its schedule; so `schedule`
is given here, and the `lr` that `train_step.apply_update` writes into the
parameter groups is not read.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


class AdaBound(torch.optim.Optimizer):
    """AdaBound over `params` with the learning rate `schedule(count)`;
    multi-tensor (`torch._foreach_*`) ops, state `mu` and `nu` a parameter
    and the count in the parameter group, as `train_step.Adam` keeps them."""

    def __init__(self, params, schedule: Callable[[int], float], final_lr: float = 0.1,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, gamma: float = 1e-3):
        super().__init__(params, dict(lr=float(schedule(0)), final_lr=final_lr, b1=b1, b2=b2,
                                      eps=eps, gamma=gamma))
        self.schedule = schedule

    @torch.no_grad()
    def step(self, closure=None):
        f32 = np.float32
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p].update(mu=torch.zeros_like(p), nu=torch.zeros_like(p))
            group["count"] = count = group.get("count", 0) + 1
            b1, b2 = group["b1"], group["b2"]
            grads = [p.grad for p in params]
            mu = [self.state[p]["mu"] for p in params]
            nu = [self.state[p]["nu"] for p in params]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
            c = f32(count)
            bc1 = f32(1) - f32(b1) ** c
            bc2 = f32(1) - f32(b2) ** c
            step_size = f32(self.schedule(count)) * np.sqrt(bc2) / bc1
            final, gamma = f32(group["final_lr"]), f32(group["gamma"])
            lower = float(final * (f32(1) - f32(1) / (gamma * c + f32(1))))
            upper = float(final * (f32(1) + f32(1) / (gamma * c)))
            denom = torch._foreach_sqrt(nu)
            torch._foreach_add_(denom, group["eps"])
            # a true division (a float over a tensor would multiply by the
            # reciprocal, which rounds otherwise)
            eta = [torch.div(d.new_tensor(float(step_size)), d).clamp_(lower, upper)
                   for d in denom]
            torch._foreach_mul_(eta, mu)
            torch._foreach_sub_(params, eta)
