"""The port's examples (``mpi_model_tpu_torch/examples/``) on the CPU,
each held against the JAX package on the same inputs.

Each example's ``main(device="cpu")`` runs once per module at its CPU sizes
(the JAX scripts' CPU branch), its printed lines captured. The JAX side
runs the JAX scripts' own helpers (``examples/masked_lake.py``'s
``build_scenario``, ``examples/reaction_diffusion.py``'s ``render``,
loaded from their files) and the JAX package's entry points. JAX's plain
dense lowering needs ``mpi_model_tpu.ir.lower.optimization_barrier`` bound
to ``jax.lax.optimization_barrier`` to run on the CPU (the ``jax_ir``
fixture of ``tests/test_torch_ir.py``, here for the module): no file of
the JAX package changes.

Tolerances:

- ``reference_run``: the serial grid bit for bit the JAX package's oracle
  (``reference_run_np``), and within 1e-12 of JAX's ``Model.execute`` at
  f64, as are the rectangular demo's grid and total; the 5-stripe and
  rectangular runs bit for bit the port's own serial runs.
- ``masked_lake``: the serial grid bit for bit the JAX package's oracle
  (``transport_np`` of the masked outflow, at f32) and within
  ``2·eps32·steps·max|v|`` of JAX's serial run (XLA's CPU compile
  contracts the outflow's multiply-adds into FMAs: 161 cells differ by one
  ulp at 8 steps); the stripes and the resumed run bit for bit the port's
  serial run.
- ``reaction_diffusion``: every channel within ``2·eps·steps·max|v|`` of
  JAX's (XLA contracts some multiply-adds on the CPU); a budget total
  within that bound summed over its cells plus the f32 reduction's
  ``4·eps·log2(n)`` (``default_conservation_rtol``) of its magnitude; the
  stripes bit for bit the port's serial run.
- ``scaling``: §1 (K1's plain version on the CPU) within
  ``2·eps32·steps·max|v|`` of JAX's serial ``"xla"`` run and of its
  ``"auto"`` run (the JAX script's own path: Pallas in interpret mode), the
  tolerance of ``tests/test_torch_k1_interior.py``, and bit for bit the
  chained plain K1 calls; §2 within the same bound of JAX's 2×4 depth-4
  run and bit for bit the port's serial run; §3 bit for bit its
  uninterrupted run and within ``2·eps64·steps·max|v|`` of JAX's; §4's
  50,000 frozen point steps bit for bit JAX's point path.
"""

import contextlib
import importlib.util
import io
import runpy
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import mpi_model_tpu as mm
from mpi_model_tpu import oracle as joracle
from mpi_model_tpu.ir import lower as jlower
from mpi_model_tpu.models import ModelRectangular as JModelRectangular
from mpi_model_tpu.models.model import SerialExecutor as JSerialExecutor
from mpi_model_tpu.parallel import ShardMapExecutor as JShardMapExecutor
from mpi_model_tpu.parallel import make_mesh_2d as jmake_mesh_2d

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch import oracle
from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS
from mpi_model_tpu_torch.examples import (masked_lake, reaction_diffusion,
                                          reference_run, scaling)
from mpi_model_tpu_torch.models.model import default_conservation_rtol
from mpi_model_tpu_torch.ops import fused_stencil as fs

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
EPS32 = float(np.finfo(np.float32).eps)
EPS64 = float(np.finfo(np.float64).eps)
EXAMPLES = {"reference_run": reference_run, "masked_lake": masked_lake,
            "reaction_diffusion": reaction_diffusion, "scaling": scaling}
#: the opening words of each line the JAX script prints, in order, at the
#: CPU sizes
JAX_LINES = {
    "reference_run": ("serial: total=10000.000000 source cell (19,3)="
                      "0.780000 neighbor (18,3)=1.027500",
                      "sharded x5: identical to serial",
                      "rectangular 2x3 blocks (the reference's disabled "
                      "demo): total=1200.000000"),
    "masked_lake": ("1. serial masked diffusion", "2. sharded x4: max|err| "
                    "vs serial 0.00e+00", "3. resumed run bit-identical to "
                    "uninterrupted: True"),
    "reaction_diffusion": ("serial: 64 steps, wall", "  budget ledger:",
                           "  reconciliation residual:",
                           "sharded(4): bitwise-equal to serial",
                           "ensemble feed sweep (one batched dispatch):",
                           "  F=0.0315: budgets", "  F=0.0350: budgets",
                           "  F=0.0385: budgets", "",
                           "activator field v after 64 steps:"),
    "scaling": ("1. 256x256 float32, 64 steps, fused x4",
                "2. 256x256 over a 2x4 mesh, depth-4 halos (4 steps per "
                "exchange): ranks=8",
                "3. supervised run (sharded ckpt layout): 1 failure "
                "recovered (RuntimeError: simulated preemption), final "
                "state bit-identical to an uninterrupted run",
                "4. 256x256 point flow, 50,000 steps in"),
}


def _jax_example(name: str):
    """The JAX package's example script ``examples/<name>.py`` as a
    module (its ``main`` is not run)."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_barrier():
    """JAX's plain dense lowering made runnable on the CPU (the module
    docstring)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlower, "optimization_barrier",
                   jax.lax.optimization_barrier)
        yield


@pytest.fixture(scope="module")
def ran():
    """Each example's ``main(device="cpu")``: its result and its printed
    lines."""
    out = {}
    for name, mod in EXAMPLES.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = mod.main(device="cpu")
        out[name] = (res, buf.getvalue().splitlines())
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _within(got, want, bound: float) -> float:
    err = float(np.abs(np.asarray(got, np.float64)
                       - np.asarray(want, np.float64)).max())
    assert err <= bound, (err, bound)
    return err


# -- every example -------------------------------------------------------------

@pytest.mark.parametrize("name", list(EXAMPLES))
def test_prints_the_jax_scripts_sections(ran, name):
    lines = ran[name][1]
    assert lines[0] == "device: cpu"
    want = JAX_LINES[name]
    assert len(lines) >= len(want) + 1
    for got, start in zip(lines[1:], want):
        assert got.startswith(start), (got, start)


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_runs_on_the_card_by_default_and_raises_without_one(monkeypatch,
                                                            name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EXAMPLES[name].main()


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_result_names_its_device(ran, name):
    res = ran[name][0]
    assert res["device"] == "cpu"
    tensors = [v for v in res.values() if isinstance(v, torch.Tensor)]
    tensors += [v for d in res.values() if isinstance(d, dict)
                for v in d.values() if isinstance(v, torch.Tensor)]
    assert tensors and all(t.device == CPU for t in tensors)


def test_python_dash_m_entry_runs(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["reference_run", "--device=cpu"])
    monkeypatch.delitem(sys.modules,
                        "mpi_model_tpu_torch.examples.reference_run")
    with pytest.raises(SystemExit) as exc:
        runpy.run_module("mpi_model_tpu_torch.examples.reference_run",
                         run_name="__main__")
    assert exc.value.code == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device: cpu"
    assert out[1].startswith(JAX_LINES["reference_run"][0])


# -- reference_run --------------------------------------------------------------

def test_reference_serial_is_the_oracle_bit_for_bit(ran):
    res = ran["reference_run"][0]
    v = _np(res["serial"])
    assert v.dtype == np.float64
    assert np.array_equal(v, joracle.reference_run_np())
    assert np.array_equal(v, oracle.reference_run_np())
    assert res["serial_total"] == pytest.approx(10000.0, abs=1e-3)


def test_reference_serial_matches_jax_execute(ran):
    space = mm.CellularSpace.create(100, 100, 1.0, dtype="float64")
    model = mm.Model(mm.Exponencial(mm.Cell(19, 3, mm.Attribute(99, 2.2)),
                                    0.1), 10.0, 0.2)
    out, rep = model.execute(space, steps=1)
    res = ran["reference_run"][0]
    _within(_np(res["serial"]), out.values["value"], 1e-12)
    assert abs(res["serial_total"] - rep.final_total["value"]) <= 1e-12


@pytest.mark.parametrize("which", ["sharded", "rect"])
def test_reference_mesh_runs_are_the_serial_runs_bit_for_bit(ran, which):
    res = ran["reference_run"][0]
    if which == "sharded":
        want = res["serial"]
        assert res["sharded_comm_size"] == 5
    else:
        rspace, rmodel = mt.ModelRectangular.reference_scenario(device="cpu")
        want = rmodel.execute(rspace, mt.SerialExecutor())[0].values["value"]
        assert res["rect_comm_size"] == 6
    assert torch.equal(res[which], want)


def test_reference_rectangular_matches_jax(ran, eight_devices):
    rspace, rmodel = JModelRectangular.reference_scenario()
    rout, rrep = rmodel.execute(
        rspace, rmodel.default_executor(devices=eight_devices[:6]))
    res = ran["reference_run"][0]
    _within(_np(res["rect"]), rout.values["value"], 1e-12)
    assert abs(res["rect_total"] - rrep.final_total["value"]) <= 1e-12
    assert res["owner"] == rmodel.owner_of(18, 19, rspace) == 3


# -- masked_lake -----------------------------------------------------------------

def test_masked_scenario_is_jaxs():
    jspace, _ = _jax_example("masked_lake").build_scenario(64)
    tspace, _ = masked_lake.build_scenario(64, "cpu")
    for k in ("value", "mask"):
        assert np.array_equal(_np(tspace.values[k]),
                              np.asarray(jspace.values[k]))
    assert tspace.values["mask"].dtype == torch.bool


def test_masked_serial_is_the_oracles_bit_for_bit(ran):
    jspace, _ = _jax_example("masked_lake").build_scenario(64)
    v = np.asarray(jspace.values["value"])
    water = np.asarray(jspace.values["mask"]).astype(np.float32)
    for _ in range(8):
        v = joracle.transport_np(v, (np.float32(0.15) * v) * water)
    res = ran["masked_lake"][0]
    assert res["impl"] == "xla"
    got = _np(res["serial"])
    assert got.dtype == np.float32
    assert np.array_equal(got, v)


def test_masked_serial_matches_jax(ran):
    jspace, jmodel = _jax_example("masked_lake").build_scenario(64)
    jout, _ = jmodel.execute(jspace, steps=8)
    res = ran["masked_lake"][0]
    want = jout.values["value"]
    _within(_np(res["serial"]), want, _channel_bound(want, 8))
    assert res["mask"].dtype == torch.bool
    assert np.array_equal(_np(res["mask"]), np.asarray(jout.values["mask"]))


@pytest.mark.parametrize("which", ["sharded", "resumed"])
def test_masked_runs_are_the_serial_run_bit_for_bit(ran, which):
    res = ran["masked_lake"][0]
    assert torch.equal(res[which], res["serial"])
    assert res["sharded_comm_size"] == 4 and res["resumed_step"] == 8


# -- reaction_diffusion ----------------------------------------------------------

@pytest.fixture(scope="module")
def jax_gray_scott(jax_barrier):
    """JAX's serial run and feed sweep of the example's model."""
    jm, js = mm.build_model("gray_scott", 96)
    jo, _ = jm.execute(js, steps=64)
    rates = list(jm.term_rates())
    sweep = []
    for scale in (0.9, 1.0, 1.1):
        r = list(rates)
        r[3] = rates[3] * scale
        sweep.append(jm.with_rates(r))
    runs = jm.execute_many([js] * 3, models=sweep, steps=64)
    return jm, jo, [(m, sp) for m, (sp, _) in zip(sweep, runs)]


def _channel_bound(want, steps: int = 64) -> float:
    return 2.0 * EPS32 * steps * float(np.abs(np.asarray(want)).max())


def _budget_bound(cells, steps: int = 64) -> float:
    """A budget total's bound: the cells' ``2·eps·steps·|b|`` summed, plus
    the f32 reduction's ``4·eps·log2(n)`` of ``Σ|b|``."""
    a = np.abs(np.asarray(cells, np.float64))
    return float(a.sum()) * (2.0 * EPS32 * steps + default_conservation_rtol(
        a.shape, torch.float32))


@pytest.mark.parametrize("channel", ["u", "v", "_b_feed", "_b_kill"])
def test_gray_scott_serial_matches_jax(ran, jax_gray_scott, channel):
    _, jo, _ = jax_gray_scott
    got = ran["reaction_diffusion"][0]["serial"][channel]
    assert got.dtype == torch.float32
    want = jo.values[channel]
    _within(_np(got), want, _channel_bound(want))


def test_gray_scott_ledger_matches_jax(ran, jax_gray_scott):
    jm, jo, _ = jax_gray_scott
    res = ran["reaction_diffusion"][0]
    want = jm.budget_totals(jo)
    assert set(res["ledger"]) == set(want) == {"feed", "kill"}
    for k in want:
        bound = _budget_bound(jo.values[f"_b_{k}"])
        assert abs(res["ledger"][k] - want[k]) <= bound, (k, bound)
    assert res["residual"] <= 1e-3


@pytest.mark.parametrize("lane", [0, 1, 2])
def test_gray_scott_sweep_matches_jax(ran, jax_gray_scott, lane):
    jm, _, jsweep = jax_gray_scott
    row = ran["reaction_diffusion"][0]["sweep"][lane]
    m, sp = jsweep[lane]
    assert row["feed_rate"] == m.ir_terms[3].rate
    for ch, v in sp.values.items():
        _within(_np(row["values"][ch]), v, _channel_bound(v))
    want = m.budget_totals(sp)
    for k in want:
        bound = _budget_bound(sp.values[f"_b_{k}"])
        assert abs(row["budgets"][k] - want[k]) <= bound, (k, bound)


def test_gray_scott_stripes_are_the_serial_run_bit_for_bit(ran):
    res = ran["reaction_diffusion"][0]
    assert set(res["sharded"]) == set(res["serial"])
    for ch, v in res["serial"].items():
        assert torch.equal(res["sharded"][ch], v), ch
    # the sweep's middle lane is the serial model: the ensemble's lanes
    # are the serial run bit for bit
    for ch, v in res["serial"].items():
        assert torch.equal(res["sweep"][1]["values"][ch], v), ch


def test_render_is_jaxs_byte_for_byte(ran):
    jrender = _jax_example("reaction_diffusion").render
    field = _np(ran["reaction_diffusion"][0]["serial"]["v"]).astype(
        np.float64)
    assert ran["reaction_diffusion"][0]["render"] == jrender(field)
    rng = np.random.default_rng(7)
    for shape, width in (((96, 96), 48), ((50, 130), 30), ((7, 3), 48)):
        f = rng.normal(size=shape)
        assert reaction_diffusion.render(f, width) == jrender(f, width)
    flat = np.ones((24, 48))
    assert reaction_diffusion.render(flat) == jrender(flat)


# -- scaling ---------------------------------------------------------------------

@pytest.mark.parametrize("jax_impl", ["xla", "auto"])
def test_scaling_fused_section_matches_jax(ran, jax_barrier, jax_impl):
    space = mm.CellularSpace.create(256, 256, 1.0, dtype="float32")
    jout, _ = mm.Model(mm.Diffusion(0.1), 64.0, 1.0).execute(
        space, JSerialExecutor(jax_impl, substeps=4))
    res = ran["scaling"][0]
    assert (res["side"], res["dtype"]) == (256, "float32")
    got = res["s1"]["values"]
    assert got.dtype == torch.float32
    want = jout.values["value"]
    _within(_np(got), want, _channel_bound(want))


def test_scaling_fused_section_is_the_plain_k1_bit_for_bit(ran):
    s1 = ran["scaling"][0]["s1"]
    assert s1["impl"] == "pallas"
    assert s1["launches"] == 0  # CPU tensors: the plain version, no launch
    want = torch.ones((256, 256), dtype=torch.float32)
    for _ in range(16):
        want = fs.dense_step_plain(want, 0.1, MOORE_OFFSETS, 4)
    assert torch.equal(s1["values"], want)


def test_scaling_deep_halo_section(ran, jax_barrier, eight_devices):
    s2 = ran["scaling"][0]["s2"]
    assert s2["comm_size"] == 8
    space = mt.CellularSpace.create(256, 256, 1.0, dtype="float32",
                                    device="cpu")
    want = mt.Model(mt.Diffusion(0.1), 16.0, 1.0).execute(
        space, mt.SerialExecutor("xla"))[0].values["value"]
    assert torch.equal(s2["values"], want)
    mesh = jmake_mesh_2d(2, 4, devices=eight_devices[:8])
    jspace = mm.CellularSpace.create(256, 256, 1.0, dtype="float32")
    jout, _ = mm.Model(mm.Diffusion(0.1), 16.0, 1.0).execute(
        jspace, JShardMapExecutor(mesh, halo_depth=4))
    jv = jout.values["value"]
    _within(_np(s2["values"]), jv, _channel_bound(jv, 16))


def test_scaling_supervised_section(ran, jax_barrier):
    s3 = ran["scaling"][0]["s3"]
    assert s3["bitwise"] and s3["recovered"] == 1
    assert s3["detail"] == "RuntimeError: simulated preemption"
    assert torch.equal(s3["values"], s3["uninterrupted"])
    assert s3["values"].dtype == torch.float64

    class Flaky:
        comm_size = 1

        def __init__(self):
            self.calls = 0
            self.inner = JSerialExecutor()

        def run_model(self, m, s, k):
            self.calls += 1
            if self.calls == 3:
                raise RuntimeError("simulated preemption")
            return self.inner.run_model(m, s, k)

    s = mm.CellularSpace.create(64, 64, 1.0, dtype="float64")
    m = mm.Model(mm.Diffusion(0.05), 20.0, 1.0)
    from mpi_model_tpu.io import CheckpointManager

    with tempfile.TemporaryDirectory() as d:
        jres = mm.supervised_run(m, s, CheckpointManager(d, layout="sharded"),
                                 steps=20, every=5, executor=Flaky())
    assert jres.recovered_failures == s3["recovered"]
    jv = jres.space.values["value"]
    bound = 2.0 * EPS64 * 20 * float(np.abs(np.asarray(jv)).max())
    _within(_np(s3["values"]), jv, bound)


def test_scaling_point_section_is_jaxs_bit_for_bit(ran):
    s4 = ran["scaling"][0]["s4"]
    assert s4["impl"] == "point" and s4["steps"] == scaling.POINT_STEPS
    assert s4["us_per_step"] > 0
    space = mm.CellularSpace.create(256, 256, 1.0, dtype="float32")
    model = mm.Model(mm.Exponencial(mm.Cell(19, 3, mm.Attribute(99, 2.2)),
                                    1e-5), 1.0, 1.0)
    want = JSerialExecutor().run_model(model, space, scaling.POINT_STEPS)
    assert np.array_equal(_np(s4["values"]), np.asarray(want["value"]))


@pytest.mark.parametrize("steps", [1, 1000])
def test_point_run_is_the_oracle(steps):
    got = scaling.point_run(64, steps, "cpu")
    assert got["impl"] == "point" and got["steps"] == steps
    want = oracle.reference_run_np(64, 64, rate=1e-5, steps=steps,
                                   dtype=np.float32)
    # the oracle moves a float64 amount cast at every add; the subsystem
    # adds one f32 delta a step: within an f32 ulp of 1 per step
    _within(_np(got["values"]), want, steps * EPS32)
