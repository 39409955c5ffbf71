"""Exact top-k set for the proposal prefilter (counterpart of
`ssd3d/ops/topk.py`).

The JAX package finds the set with a radix select because a sort is slow on
a TPU; here one stable descending sort does it. The contract is the same:
the k largest scores of each row, ties at the threshold to the lower index
(as `lax.top_k`), emitted in ascending index order. Scores are ordered as
the JAX package's uint32 keys order them, so -0.0 ranks below +0.0.
"""

from __future__ import annotations

import torch


def _order_key(scores: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 keys whose order is the float order with -0.0 < +0.0
    (NaN-free inputs assumed)."""
    bits = scores.float().contiguous().view(torch.int32).long()
    mag = bits & 0x7FFFFFFF
    return torch.where(bits < 0, -mag - 1, mag)


def top_k_set(scores: torch.Tensor, k: int):
    """scores: [b, n] -> (idx int32 [b, k], valid bool [b, k]); when n < k
    the slots past n hold n - 1 and are not valid."""
    b, n = scores.shape
    kk = min(k, n)
    order = torch.argsort(_order_key(scores), dim=-1, descending=True, stable=True)
    idx = order[:, :kk].sort(dim=-1).values
    if kk < k:
        idx = torch.cat([idx, idx.new_full((b, k - kk), n - 1)], dim=-1)
    valid = torch.arange(k, device=scores.device).expand(b, k) < kk
    return idx.to(torch.int32), valid
