"""The work count: the yardstick of every roofline share. It reads the
configuration and the traffic, never the program, so a later change to how
the program fuses steps or which kernel it runs meets the same count.

- Operations a cell-step: each flow's outflow (``work/<kind>.py``), one
  addition for each further flow on a channel, and the transport of each
  written channel: one division (the share), ``k - 1`` additions (the
  sum of ``k`` neighbours' shares), one subtraction (the value less its
  outflow) and one addition (the inflow): ``k + 2``, 10 for Moore-8. So
  Moore-8 ``Diffusion`` is 11, and config 4's three flows are 25: channel
  ``a`` 1 (``Diffusion``) + 2 (``Coupled``) + 1 (their sum) + 10, channel
  ``b`` 1 + 10.
- Bytes of a run of any number of steps: each channel that is read once,
  and each written channel written once, in the storage dtype, whatever a
  kernel reads again.
- The roofline time is the larger of the operations over the card's
  float32 rate and the bytes over its memory rate (``peaks.json``, the
  published figures).
"""

from __future__ import annotations

import json
from pathlib import Path

from .. import registry
from ..neighbourhoods import offsets as offsets_of

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}


def ops_per_cell_step(config: dict) -> int:
    per_channel: dict = {}
    ops = 0
    for f in config["flows"]:
        ops += registry.work(f["kind"]).ops(f)
        per_channel[f["attr"]] = per_channel.get(f["attr"], 0) + 1
    k = len(offsets_of(config))
    for n in per_channel.values():
        ops += (n - 1) + (k + 2)
    return ops


def channels_read_written(config: dict) -> tuple:
    read, written = set(), set()
    for f in config["flows"]:
        read |= registry.work(f["kind"]).reads(f)
        written.add(f["attr"])
    return read | written, written


def run_work(config: dict, cells: int, steps: int) -> dict:
    """Operations and bytes of one run of ``steps`` steps over ``cells``
    cells (a ``Model.execute`` call, or one scenario)."""
    read, written = channels_read_written(config)
    item = _ITEMSIZE[config["storage_dtype"]]
    return {"flops": float(ops_per_cell_step(config)) * cells * steps,
            "bytes": float(len(read) + len(written)) * cells * item}


def peak(kind: str):
    """The published peaks of the card named ``kind``, or None."""
    with open(Path(__file__).resolve().parent.parent / "peaks.json") as f:
        return json.load(f).get(kind)


def roofline_s(work: dict, pk: dict) -> float:
    return max(work["flops"] / pk["float32_flops"],
               work["bytes"] / pk["bytes_per_s"])
