"""The plain reference, written from the model's definition and importing
nothing of the program.

A step: every flow computes its outflow field from the values at the start
of the step (``reference/<kind>.py``); the outflows of one channel add up;
each cell keeps its value less its outflow and gains, from every in-bounds
neighbour, that neighbour's outflow divided by the neighbour's count of
in-bounds neighbours. Mass is conserved; the grid does not wrap.

A flow's rate is the number the configuration's storage dtype holds for it
(0.1 in f32 is 0.100000001490116...), and the arithmetic is in ``dtype``:
float64 for the comparison, bfloat16 for the control that stands in for
the program (``check.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import registry
from ..inputs import dtype_of
from ..neighbourhoods import offsets as offsets_of


def stated_rate(value: float, config: dict) -> float:
    """The rate as the configuration's storage dtype holds it."""
    return float(torch.tensor(float(value),
                              dtype=dtype_of(config["storage_dtype"])))


class Reference:
    """The configuration's flows in plain PyTorch, in ``dtype``."""

    def __init__(self, config: dict, dtype: torch.dtype = torch.float64):
        self.config = config
        self.dtype = dtype
        self.offsets = offsets_of(config)
        self.flows = []
        for f in config["flows"]:
            f = dict(f)
            f["flow_rate"] = stated_rate(f["flow_rate"], config)
            self.flows.append((registry.reference(f["kind"]), f))
        self._counts: dict = {}

    def counts(self, shape: tuple, device) -> torch.Tensor:
        """Each cell's number of in-bounds neighbours."""
        key = (tuple(shape), str(device))
        c = self._counts.get(key)
        if c is None:
            h, w = shape
            r = torch.arange(h, device=device)
            q = torch.arange(w, device=device)
            c = torch.zeros((h, w), dtype=self.dtype, device=device)
            for dr, dq in self.offsets:
                ok_r = ((r + dr >= 0) & (r + dr < h)).to(self.dtype)
                ok_q = ((q + dq >= 0) & (q + dq < w)).to(self.dtype)
                c.add_(ok_r[:, None] * ok_q[None, :])
            self._counts = {key: c}
        return c

    def cast(self, values: dict) -> dict:
        return {k: v.to(self.dtype) for k, v in values.items()}

    def outflows(self, values: dict) -> dict:
        out: dict = {}
        for mod, f in self.flows:
            o = mod.outflow(values, f)
            out[f["attr"]] = out[f["attr"]] + o if f["attr"] in out else o
        return out

    def step(self, values: dict) -> dict:
        new = dict(values)
        for ch, o in self.outflows(values).items():
            v = values[ch]
            h, w = v.shape
            share = o / self.counts((h, w), v.device)
            p = F.pad(share, (1, 1, 1, 1))
            del share
            inflow = None
            for dr, dq in self.offsets:
                s = p[1 + dr:1 + dr + h, 1 + dq:1 + dq + w]
                inflow = s.clone() if inflow is None else inflow.add_(s)
            del p
            nv = v - o
            del o
            new[ch] = nv.add_(inflow)
        return new

    def run(self, values: dict, steps: int) -> dict:
        """``steps`` steps from ``values`` (cast to ``dtype`` first)."""
        cur = self.cast(values)
        for _ in range(int(steps)):
            cur = self.step(cur)
        return cur

    def totals(self, values: dict) -> dict:
        """Each channel's sum, in float64."""
        return {k: float(torch.sum(v, dtype=torch.float64))
                for k, v in values.items()}

    def outflow_sums(self, values: dict) -> list:
        """Each flow's total outflow from ``values``, in float64, in the
        configuration's order."""
        return [float(torch.sum(mod.outflow(values, f), dtype=torch.float64))
                for mod, f in self.flows]
