"""What the timed path produced inside a request, for the judge.

A `Recorder` puts a forward hook on each module of the program that the
reference judges (every backbone layer, head and RoI pool, named as the
reference names them). A hook costs one Python call a module and keeps
nothing unless the request is one the seed picked for judging: then it
holds on to the module's return value (references to the tensors the
forward made, on the card, no copy) until the window has closed.

Which requests are judged is drawn from the seed by reservoir sampling, so
that every request of the window is equally likely to be judged, whatever
their number.
"""

from __future__ import annotations

import numpy as np
import torch


class Recorder:
    def __init__(self, model: torch.nn.Module, names: list[str], keep: int, seed: int):
        modules = dict(model.named_modules())
        missing = [n for n in names if n not in modules]
        if missing:
            raise RuntimeError(f"portbench: the program has no module {missing[0]!r} to judge")
        self.keep = keep
        self.rng = np.random.default_rng([seed, 0x5A3D])
        self.kept: list[dict] = []  # one dict a judged request: index, outputs, calls
        self.current: dict | None = None
        self.seen = 0
        self.handles = [modules[n].register_forward_hook(self._hook(n)) for n in names]

    def _hook(self, name: str):
        def hook(_module, _inputs, output):
            cur = self.current
            if cur is not None:
                cur["calls"][name] = cur["calls"].get(name, 0) + 1
                cur["outputs"][name] = output
        return hook

    def begin(self) -> int | None:
        """Before a request: -> the slot it will fill if it is to be judged."""
        i, self.seen = self.seen, self.seen + 1
        slot = i if i < self.keep else int(self.rng.integers(0, i + 1))
        if slot >= self.keep:
            self.current = None
            return None
        self.current = {"index": i, "outputs": {}, "calls": {}}
        return slot

    def end(self, slot: int | None, extra: dict) -> None:
        """After a request: keep what it recorded, with `extra` (its inputs
        and results), in its slot."""
        if slot is None:
            return
        self.current.update(extra)
        if slot < len(self.kept):
            self.kept[slot] = self.current
        else:
            self.kept.append(self.current)
        self.current = None

    def close(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []

