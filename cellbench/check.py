"""The comparison that decides ``correct``.

The program's answers (a ``Model.execute`` call's output space and
``Report``, or a served scenario's) are held against the plain reference
(``reference/``), which works everything out again from the inputs the
benchmark made. Each number compared has its limit in the cell's file
(``limits``); ``PERF.md`` gives the readings each was set from.

- ``state_err``: the largest ``|program - reference|`` over every cell and
  channel of an answer, over the largest ``|reference|`` of that channel;
- ``total_err``: a report's initial and final channel totals against the
  reference's float64 sums, relative;
- ``outflow_err``: a report's ``last_execute`` (each flow's total
  outflow from the final state) against the reference's, relative;
- counts with the limit 0: answers that never came or raised, inputs the
  program changed.

With ``control="reference_bf16"`` the reference computed in bfloat16 takes
the program's place: its answers, and its totals, are what is judged.
"""

from __future__ import annotations

import math
import sys

import torch

from .reference import Reference


class Checks:
    """Numbers compared, each with its limit; ``ok`` when none is over."""

    def __init__(self, limits: dict):
        self.limits = dict(limits)
        self.values: dict = {}

    def worst(self, name: str, value: float) -> None:
        """Keep the largest reading of ``name``."""
        v = float(value)
        if v != v:  # NaN: nothing compares, so nothing can pass
            v = float("inf")
        self.values[name] = max(self.values.get(name, 0.0), v)

    def count(self, name: str, n: int = 1) -> None:
        self.values[name] = self.values.get(name, 0) + int(n)

    @property
    def ok(self) -> bool:
        return all(self.values.get(k, 0) <= lim
                   for k, lim in self.limits.items()) and all(
            k in self.limits for k in self.values)

    def table(self) -> dict:
        """``{name: {value, limit}}``; a reading that is not finite shows
        as the largest float, so the line stays JSON."""
        names = list(self.limits) + [k for k in self.values
                                     if k not in self.limits]
        out = {}
        for k in names:
            v = self.values.get(k, 0)
            out[k] = {"value": v if math.isfinite(v) else sys.float_info.max,
                      "limit": self.limits.get(k)}
        return out

    def print(self, file=sys.stderr) -> None:
        for k, row in self.table().items():
            print(f"check {k} {row['value']!r} limit {row['limit']!r}",
                  file=file)


def rel_state_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """``max|got - want| / max|want|``, in float64, in blocks of rows."""
    scale = float(want.abs().max())
    worst = 0.0
    step = max(1, (1 << 24) // max(1, want.shape[-1]))
    for r in range(0, want.shape[0], step):
        d = (got[r:r + step].to(torch.float64)
             - want[r:r + step].to(torch.float64)).abs().max()
        worst = max(worst, float(d))
    return worst / scale if scale > 0 else float("inf")


def rel(a: float, b: float) -> float:
    return abs(float(a) - float(b)) / abs(float(b)) if b else abs(float(a))


def judge(checks: Checks, ref: Reference, start: dict, steps: int,
          got_values: dict, got_report, control: str = "none") -> None:
    """Run the reference ``steps`` steps from ``start`` (the inputs the
    program was given) and hold the program's answer to it: its values
    ``got_values`` and its ``Report`` (``initial_total``, ``final_total``,
    ``last_execute``)."""
    want0 = ref.totals(ref.cast(start))
    want = ref.run(start, steps)
    if control == "reference_bf16":
        low = Reference(ref.config, torch.bfloat16)
        got_values = low.run(start, steps)
        got_init = low.totals(low.cast(start))
        got_final = low.totals(got_values)
        got_out = low.outflow_sums(got_values)
    else:
        got_init = got_report.initial_total
        got_final = got_report.final_total
        got_out = got_report.last_execute
    for ch, w in want.items():
        checks.worst("state_err", rel_state_err(got_values[ch], w))
    wantf = ref.totals(want)
    for ch in want:
        checks.worst("total_err", rel(got_init[ch], want0[ch]))
        checks.worst("total_err", rel(got_final[ch], wantf[ch]))
    for g, w in zip(got_out, ref.outflow_sums(want)):
        checks.worst("outflow_err", rel(g, w))
    if len(got_out) != len(ref.flows):
        checks.count("answers_missing")
