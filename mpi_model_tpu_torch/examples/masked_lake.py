"""Masked diffusion over a land-water mask: the int/bool half of the L0
seam, end to end (the JAX package's ``examples/masked_lake.py``).

A bool ``mask`` channel (True = water) rides beside the float ``value``
channel through every layer the float channels use:

1. STORED: ``CellularSpace.create`` with a per-channel dtype
   (``{"value": 1.0, "mask": (False, "bool")}``), then painted with a
   lake region; flows are masked by coupling to it
   (``Coupled(attr="value", modulator="mask")``: only water cells shed, a
   bool modulator multiplies as 0/1), so land cells emit nothing while
   mass conservation holds grid-wide.
2. HALO-EXCHANGED: the same model on 4 row stripes: the bool channel
   shards with the grid and the masked flow computes per shard; the result
   matches the serial run exactly.
3. CHECKPOINTED + RESUMED: ``run_checkpointed`` interrupts and resumes
   the run; the restored bool channel keeps its dtype and the final state
   is bit-identical to an uninterrupted run.

The serial run asks for ``SerialExecutor("auto")``. The fused field kernel
K4 takes no bool modulator, so ``"auto"`` resolves to the plain path
(``"xla"``) and this example launches no kernel. Every mesh position sits on
the one device.

Run: python -m mpi_model_tpu_torch.examples.masked_lake [--device=cpu]
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch

from .. import CellularSpace, Coupled, Model, SerialExecutor
from ..core.cellular_space import resolve_device
from ..io import CheckpointManager, run_checkpointed
from ..parallel import ShardMapExecutor, make_mesh
from . import device_name, expect, run


def build_scenario(g: int = 64, device=None):
    """A g x g grid: water value 1.0 everywhere, a rectangular lake of
    True mask cells in the middle (everything else is land)."""
    dev = resolve_device(device)
    space = CellularSpace.create(
        g, g, {"value": 1.0, "mask": (False, "bool")}, dtype="float32",
        device=dev)
    mask = np.zeros((g, g), dtype=bool)
    mask[g // 4: 3 * g // 4, g // 8: 7 * g // 8] = True
    space = space.with_values({"value": space.values["value"],
                               "mask": torch.from_numpy(mask).to(dev)})
    # masked diffusion: outflow = rate * value * mask; land sheds nothing
    model = Model(Coupled(flow_rate=0.15, attr="value", modulator="mask"),
                  16.0, 1.0)
    return space, model


def main(device=None, side: int = 64) -> dict:
    dev = resolve_device(device)
    print(f"device: {device_name(dev)}")
    space, model = build_scenario(side, dev)
    mask_np = space.values["mask"].cpu().numpy()

    # 1. serial run: land cells only ever RECEIVE; mask is untouched
    ex = SerialExecutor("auto")
    out, rep = model.execute(space, ex, steps=8)
    value = out.values["value"]
    expect(out.values["mask"].dtype == torch.bool, "mask lost its dtype")
    expect(np.array_equal(out.values["mask"].cpu().numpy(), mask_np),
           "the run wrote the mask")
    water = float(value.cpu().numpy()[mask_np].sum())
    print(f"1. serial masked diffusion ({ex.last_impl}): |drift|="
          f"{rep.conservation_error():.2e}, water total {water:.2f} "
          f"(started {float(mask_np.sum()):.0f})")

    # 2. sharded: the bool channel shards with the grid; result matches
    out2, rep2 = model.execute(
        space, ShardMapExecutor(make_mesh(4, devices=[dev] * 4)), steps=8)
    err = float((out2.values["value"] - value).abs().max())
    expect(out2.values["mask"].dtype == torch.bool,
           "the sharded mask lost its dtype")
    print(f"2. sharded x{rep2.comm_size}: max|err| vs serial {err:.2e}")

    # 3. checkpoint/resume: interrupt at step 4, resume to 8; the bool
    # channel survives with dtype intact, state bit-identical to (1)
    with tempfile.TemporaryDirectory() as d:
        run_checkpointed(model, space, CheckpointManager(d, device=dev),
                         steps=4, every=2)
        out3, step3, _ = run_checkpointed(  # resumes from step 4
            model, space, CheckpointManager(d, device=dev), steps=8,
            every=2)
    expect(step3 == 8, f"the resumed run ended at step {step3}")
    expect(out3.values["mask"].dtype == torch.bool,
           "the restored mask lost its dtype")
    same = torch.equal(out3.values["value"], value)
    print(f"3. resumed run bit-identical to uninterrupted: {same}")
    expect(same, "the resumed run is not the uninterrupted one")
    return {"device": str(dev), "impl": ex.last_impl, "serial": value,
            "mask": out.values["mask"], "drift": rep.conservation_error(),
            "water_total": water, "sharded": out2.values["value"],
            "sharded_comm_size": rep2.comm_size, "sharded_err": err,
            "resumed": out3.values["value"], "resumed_step": step3}


if __name__ == "__main__":
    raise SystemExit(run(main))
