"""What the benchmark takes from the program: the configuration's flows
built as the port's own objects. The traffic kinds import the port through
``harness.Context.mt``; the reference and the work count never do."""

from __future__ import annotations

from .neighbourhoods import offsets


def build_model(mt, config: dict):
    """``mt.Model`` of the configuration's flows (each a public class of
    the port named by ``kind``, built from the entry's other keys)."""
    flows = []
    for f in config["flows"]:
        cls = getattr(mt, f["kind"])
        flows.append(cls(**{k: v for k, v in f.items() if k != "kind"}))
    return mt.Model(flows, offsets=offsets(config))


def space(mt, values: dict):
    """A whole-grid ``mt.CellularSpace`` over ``values``."""
    h, w = next(iter(values.values())).shape
    return mt.CellularSpace(dict(values), h, w)
