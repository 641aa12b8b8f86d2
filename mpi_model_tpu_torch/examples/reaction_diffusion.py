"""Gray-Scott reaction-diffusion through the Flow IR (the JAX package's
``examples/reaction_diffusion.py``).

The model is FIVE declarative terms, no step code anywhere:

    Transport(u, Du)                   # diffusion of the substrate
    Transport(v, Dv)                   # diffusion of the activator
    Transfer(u, v, v**2 * u)           # cubic autocatalysis (conserving)
    Source(u, 1 - u, rate=F)           # declared feed (budgeted)
    Sink(v, v, rate=F + k)             # declared kill (budgeted)

One registered lowering (``ir.lower``) turns that list into the step every
engine runs: the serial dense path, the sharded per-shard runner, and the
batched ensemble with per-scenario rates as lanes. The conservation
contract is per-term BUDGET RECONCILIATION: the feed/kill terms integrate
their signed mass into hidden budget channels, and the observed drift must
equal their sum; a lying term raises naming it.

The program runs the model three ways (serial / 4 row stripes / a small
parameter-sweep ensemble), checks the first two agree bitwise, prints the
reconciled budget ledger, and renders the activator field as ASCII. The
model is nonlinear, so every engine takes the plain path and no kernel is
launched. Every mesh position sits on the one device.

Run: python -m mpi_model_tpu_torch.examples.reaction_diffusion [--device=cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.cellular_space import resolve_device
from ..ir import build_model
from ..parallel import ShardMapExecutor, make_mesh
from . import device_name, expect, run


def render(field: np.ndarray, width: int = 48) -> str:
    """Coarse ASCII view of a channel (row-major block means)."""
    h, w = field.shape
    sy, sx = max(1, h // 24), max(1, w // width)
    shades = " .:-=+*#%@"
    rows = []
    f = field[: (h // sy) * sy, : (w // sx) * sx]
    blocks = f.reshape(h // sy, sy, w // sx, sx).mean(axis=(1, 3))
    lo, hi = float(blocks.min()), float(blocks.max())
    span = (hi - lo) or 1.0
    for row in blocks:
        rows.append("".join(
            shades[min(int((x - lo) / span * (len(shades) - 1)),
                       len(shades) - 1)] for x in row))
    return "\n".join(rows)


def main(device=None, side: int = 96, steps: int = 64) -> dict:
    dev = resolve_device(device)
    print(f"device: {device_name(dev)}")
    model, space = build_model("gray_scott", side, device=dev)

    # 1. serial: the dense lowering, budget-reconciled by execute()
    out, rep = model.execute(space, steps=steps)
    ledger = model.budget_totals(out)
    residual = model.report_conservation_error(rep)
    print(f"serial: {steps} steps, wall {rep.wall_time_s:.2f}s")
    print(f"  budget ledger: {ledger}")
    print(f"  reconciliation residual: {residual:.3e}")

    # 2. sharded: same terms, same lowering, ghost rings between the
    #    stripes; bitwise-equal to the serial run
    mesh = make_mesh(4, devices=[dev] * 4)
    out_sh, _ = model.execute(space, ShardMapExecutor(mesh), steps=steps)
    for ch in out.values:
        expect(torch.equal(out.values[ch], out_sh.values[ch]),
               f"sharded channel {ch!r} is not the serial one")
    print("sharded(4): bitwise-equal to serial")

    # 3. ensemble: a feed-rate sweep as ONE batched run; per-scenario
    #    term rates ride [B, F] lanes
    rates = list(model.term_rates())
    sweep = []
    for scale in (0.9, 1.0, 1.1):
        r = list(rates)
        r[3] = rates[3] * scale  # the feed term's rate (F)
        sweep.append(model.with_rates(r))
    results = model.execute_many([space] * len(sweep), models=sweep,
                                 steps=steps)
    print("ensemble feed sweep (one batched dispatch):")
    sweep_rows = []
    for m, (sp, _) in zip(sweep, results):
        budgets = m.budget_totals(sp)
        sweep_rows.append({"feed_rate": m.ir_terms[3].rate,
                           "budgets": budgets, "values": sp.values})
        print(f"  F={m.ir_terms[3].rate:.4f}: budgets {budgets}")

    picture = render(out.values["v"].cpu().numpy().astype(np.float64))
    print("\nactivator field v after", steps, "steps:")
    print(picture)
    return {"device": str(dev), "steps": steps, "serial": out.values,
            "wall_s": rep.wall_time_s, "ledger": ledger,
            "residual": residual, "sharded": out_sh.values,
            "sweep": sweep_rows, "render": picture}


if __name__ == "__main__":
    raise SystemExit(run(main))
