"""Learning-rate and BatchNorm-momentum schedules (counterpart of
`ssd3d/train/schedules.py`), piecewise constant on SOLVER.STEPS:

    lr(k)      = BASE_LR * GAMMA^(boundaries passed)
    bn_m(k)    = min(BN_DECAY_CLIP, 1 - BN_INIT_DECAY * RATE^(boundaries passed))

Values are rounded to float32, as the JAX package holds them.
"""

from __future__ import annotations

import numpy as np


def piecewise_values(step: int, boundaries, values) -> float:
    """values[k], k the number of boundaries at or below `step`, as a float32
    value."""
    return float(np.float32(values[sum(int(step) >= int(b) for b in boundaries)]))


def learning_rate(solver_cfg, step: int) -> float:
    steps = list(solver_cfg.STEPS)
    values = [solver_cfg.BASE_LR * solver_cfg.GAMMA ** i for i in range(len(steps) + 1)]
    return piecewise_values(step, steps, values)


def bn_momentum(solver_cfg, step: int) -> float:
    steps = list(solver_cfg.STEPS)
    values = [min(solver_cfg.BN_DECAY_CLIP,
                  1.0 - solver_cfg.BN_INIT_DECAY * solver_cfg.BN_DECAY_DECAY_RATE ** i)
              for i in range(len(steps) + 1)]
    return piecewise_values(step, steps, values)
