"""The slice as a whole: the port's Model/SerialExecutor/Report, oracle,
interop and CLI against the JAX package, on the CPU.

- the reference run (100×100, one Exponencial) at f64, bitwise against the
  oracle and JAX ``Model.execute``;
- dense Diffusion + a PointFlow on two channels, plain-op path, bitwise at
  f64;
- the kernel path (``SerialExecutor("pallas", substeps=4)``; on the CPU
  K1's plain version) against JAX's (Pallas in interpret mode) at 1e-5;
- import isolation, pinned statically (an AST scan, no subprocess).
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mpi_model_tpu as mm
from mpi_model_tpu import oracle as joracle
from mpi_model_tpu.core import cell as jcell
from mpi_model_tpu.models.model import SerialExecutor as JSerial

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch import interop
from mpi_model_tpu_torch import oracle as toracle
from mpi_model_tpu_torch.cli import main as cli_main
from mpi_model_tpu_torch.core import cell as tcell
from mpi_model_tpu_torch.models.model import default_conservation_rtol
from mpi_model_tpu_torch.ops import fused_stencil as fs

REPO = Path(__file__).resolve().parent.parent


def _ref_models():
    return (mt.Model(mt.Exponencial(mt.Cell(19, 3, mt.Attribute(99, 2.2)),
                                    0.1), 10.0, 0.2),
            mm.Model(mm.Exponencial(mm.Cell(19, 3, mm.Attribute(99, 2.2)),
                                    0.1), 10.0, 0.2))


@pytest.mark.parametrize("steps", [1, 50])
def test_reference_run_bitwise(steps):
    tm, jm = _ref_models()
    tout, trep = tm.execute(mt.CellularSpace.create(
        100, 100, 1.0, dtype="float64", device="cpu"), steps=steps)
    jout, _ = jm.execute(mm.CellularSpace.create(100, 100, 1.0,
                                                 dtype=jnp.float64),
                         steps=steps)
    got = tout.values["value"].numpy()
    np.testing.assert_array_equal(got, toracle.reference_run_np(steps=steps))
    np.testing.assert_array_equal(got, np.asarray(jout.values["value"]))
    assert trep.impl == "point" and trep.steps == steps
    assert float(tout.total("value")) == pytest.approx(10000.0, abs=1e-9)
    if steps == 1:
        assert got[19, 3] == pytest.approx(0.78, abs=1e-15)


@pytest.mark.parametrize("substeps", [1, 4])
def test_diffusion_plus_point_flow_two_channels_bitwise(substeps):
    rng = np.random.default_rng(11)
    a, b = rng.uniform(0.5, 2.0, (24, 40)), rng.uniform(0.5, 2.0, (24, 40))
    # The Coupled flow sends the JAX side through its summed-outflow step:
    # its plain-Diffusion IR step does not run under jax 0.9 (the
    # compat.optimization_barrier bridge; ROADMAP.md Queue 3). XLA's CPU
    # compile contracts the summed outflows (rate*a + r*a*b) into FMAs, so
    # the match is to atol 1e-12 (docs/PARITY.md), not bitwise.
    tflows = [mt.Diffusion(0.1, attr="a"), mt.Diffusion(0.2, attr="b"),
              mt.Coupled(0.05, attr="a", modulator="b"),
              mt.PointFlow(source=(0, 0), flow_rate=0.5, attr="a"),
              mt.PointFlow(source=(5, 7), flow_rate=0.3, attr="b")]
    jflows = [mm.Diffusion(0.1, attr="a"), mm.Diffusion(0.2, attr="b"),
              mm.Coupled(0.05, attr="a", modulator="b"),
              mm.PointFlow(source=(0, 0), flow_rate=0.5, attr="a"),
              mm.PointFlow(source=(5, 7), flow_rate=0.3, attr="b")]
    ts = interop.space_from_numpy({"a": a, "b": b}, device="cpu")
    js = mm.CellularSpace.create(24, 40, {"a": 1.0, "b": 1.0},
                                 dtype=jnp.float64).with_values(
        {"a": jnp.asarray(a), "b": jnp.asarray(b)})
    tout, trep = mt.Model(tflows, 10.0, 1.0).execute(
        ts, mt.SerialExecutor("xla", substeps=substeps), steps=10)
    jout, jrep = mm.Model(jflows, 10.0, 1.0).execute(
        js, JSerial("xla", substeps=substeps), steps=10)
    for k in ("a", "b"):
        np.testing.assert_allclose(tout.values[k].numpy(),
                                   np.asarray(jout.values[k]), rtol=0,
                                   atol=1e-12)
    assert trep.impl == "xla" and trep.backend_report is None
    np.testing.assert_allclose(trep.last_execute, jrep.last_execute,
                               rtol=1e-12)


@pytest.mark.parametrize("hood", ["moore", "von_neumann"])
def test_plain_diffusion_path_bitwise_against_the_oracle(hood):
    """The plain-Diffusion step, held to the oracle bitwise at f64 (the JAX
    package's own plain-Diffusion step does not run under jax 0.9)."""
    offs = tcell.MOORE_OFFSETS if hood == "moore" else \
        tcell.VON_NEUMANN_OFFSETS
    v = np.random.default_rng(12).uniform(0.5, 2.0, (13, 17))
    ts = interop.space_from_numpy({"value": v}, device="cpu")
    out, rep = mt.Model(mt.Diffusion(0.13), offsets=offs).execute(
        ts, mt.SerialExecutor("auto", substeps=3), steps=7)
    want = v
    for _ in range(7):
        want = toracle.dense_flow_step_np(want, 0.13, offs)
    np.testing.assert_array_equal(out.values["value"].numpy(), want)
    assert rep.impl == "xla"  # f64 stays on the plain path


def test_kernel_path_substeps_matches_jax():
    """Port SerialExecutor("pallas", substeps=4) on CPU f32 (K1's plain
    version) against JAX's (Pallas interpret); 10 steps = 2 fused calls +
    2 single-step calls."""
    v = np.random.default_rng(5).uniform(0.5, 2.0, (24, 256)).astype(
        np.float32)
    ts = interop.space_from_numpy({"value": v}, device="cpu")
    js = mm.CellularSpace.create(24, 256, 1.0, dtype=jnp.float32).with_values(
        {"value": jnp.asarray(v)})
    tout, trep = mt.Model(mt.Diffusion(0.12)).execute(
        ts, mt.SerialExecutor("pallas", substeps=4), steps=10)
    jout, _ = mm.Model(mm.Diffusion(0.12)).execute(
        js, JSerial("pallas", substeps=4), steps=10)
    np.testing.assert_allclose(tout.values["value"].numpy(),
                               np.asarray(jout.values["value"]),
                               rtol=1e-5, atol=1e-5)
    assert trep.impl == "pallas"
    # on the CPU the plain version ran: no kernel launch is counted
    assert trep.backend_report == {"kernel": "K1 fused_stencil",
                                   "substeps": 4, "launches": 0}
    # the input space is left untouched (the kernel path is out of place)
    np.testing.assert_array_equal(ts.values["value"].numpy(), v)


def test_auto_picks_by_static_eligibility_only():
    f32 = mt.CellularSpace.create(32, 256, 1.0, dtype="float32",
                                  device="cpu")
    f64 = mt.CellularSpace.create(32, 256, 1.0, dtype="float64",
                                  device="cpu")
    m = mt.Model(mt.Diffusion(0.1))
    assert m.make_step(f32, impl="auto").impl == "pallas"
    assert m.make_step(f32, impl="auto", substeps=8).impl == "pallas"
    # f64 stays on the plain path; so does a substeps past the ghost depth
    assert m.make_step(f64, impl="auto").impl == "xla"
    assert m.make_step(f32, impl="auto", substeps=9).impl == "xla"
    two = mt.CellularSpace.create(32, 256, {"a": 1.0, "b": 1.0},
                                  dtype="float32", device="cpu")
    coupled = mt.Model([mt.Coupled(0.1, attr="a", modulator="b")])
    # a Coupled flow takes the field kernel K4 (statically eligible)
    assert coupled.make_step(two, impl="auto").impl == "pallas"
    assert coupled.make_step(two, impl="pallas").field_stepper is not None
    assert coupled.make_step(two, impl="auto", substeps=9).impl == "xla"
    with pytest.raises(ValueError, match="f32/bf16"):
        m.make_step(f64, impl="pallas")
    with pytest.raises(ValueError, match="ghost depth"):
        m.make_step(f32, impl="pallas", substeps=9)
    pt = mt.Model([mt.Diffusion(0.1), mt.PointFlow((3, 3), 0.2)])
    with pytest.raises(ValueError, match="point flows"):
        pt.make_step(f32, impl="pallas", substeps=2)
    assert pt.make_step(f32, impl="auto", substeps=2).impl == "xla"


@pytest.mark.parametrize("impl", ["composed", "active", "active_fused"])
def test_unported_impls_name_the_roadmap(impl):
    """The three impls are ported, bf16 interior math (``compute_dtype``)
    included, through make_step and the executor alike. At 8 x 8 no TPU
    tile is off the edge: the active runners' dense fallback is K1 at one
    step, where the knob changes nothing (bit for bit); K3 takes the knob
    at every k, its near tiles reading the grid rounded to bf16 (within a
    bf16 rounding of the value, 2^-8 relative, a step)."""
    s = mt.CellularSpace.create(8, 8, 1.0, device="cpu")
    m = mt.Model(mt.Diffusion(0.1))
    assert m.make_step(s, impl=impl).impl == impl
    assert m.make_step(s, impl=impl,
                       compute_dtype=torch.bfloat16).impl == impl
    out16, _ = m.execute(s, mt.SerialExecutor(
        step_impl=impl, compute_dtype=torch.bfloat16), steps=2,
        check_conservation=False)
    out, rep = m.execute(s, mt.SerialExecutor(step_impl=impl), steps=2)
    if impl == "composed":
        np.testing.assert_allclose(out16.values["value"].numpy(),
                                   out.values["value"].numpy(),
                                   rtol=2 * 2.0 ** -8, atol=0)
    else:
        assert torch.equal(out16.values["value"], out.values["value"])
    ref, _ = m.execute(s, mt.SerialExecutor(step_impl="xla"), steps=2)
    assert rep.impl == impl
    np.testing.assert_allclose(out.values["value"].numpy(),
                               ref.values["value"].numpy(), rtol=0,
                               atol=1e-6)


def test_unported_options_name_the_roadmap():
    s = mt.CellularSpace.create(8, 8, 1.0, device="cpu")
    m = mt.Model(mt.Diffusion(0.1))
    # bf16 interior math is ported; a dtype other than f32/bf16 is refused
    assert m.make_step(s, impl="pallas",
                       compute_dtype=torch.bfloat16).impl == "pallas"
    with pytest.raises(ValueError, match="compute_dtype"):
        m.make_step(s, impl="pallas", compute_dtype=torch.float16)
    # the ensemble engine is ported; its mesh-sharded form is not
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        m.execute_many([s], executor=mt.EnsembleExecutor(mesh=2))
    with pytest.raises(ValueError, match="unknown step impl"):
        m.make_step(s, impl="nope")
    ints = mt.CellularSpace.create(8, 8, {"value": (1, "int32")},
                                   device="cpu")
    with pytest.raises(TypeError, match="floating dtype"):
        m.make_step(ints)


class _LeakyExecutor(mt.SerialExecutor):
    """A broken execution path that loses one unit of mass per run."""

    def run_model(self, model, space, num_steps):
        out = super().run_model(model, space, num_steps)
        out["value"] = out["value"].clone()
        out["value"][0, 0] -= 1.0
        return out


def test_conservation_error_raised_on_a_violating_run():
    s = mt.CellularSpace.create(16, 16, 1.0, dtype="float64", device="cpu")
    m = mt.Model(mt.Diffusion(0.1), 1.0, 1.0)
    with pytest.raises(mt.ConservationError, match="conservation"):
        m.execute(s, _LeakyExecutor())
    with pytest.raises(mt.ConservationError):
        m.execute(s, tolerance=-1.0)
    # a partition space skips the global check
    part = mt.CellularSpace.create(16, 16, 1.0, dtype="float64",
                                   global_dim_x=32, device="cpu")
    m.execute(part, _LeakyExecutor())


def test_report_fields_match_jax():
    tm, jm = _ref_models()
    _, tr = tm.execute(mt.CellularSpace.create(100, 100, 1.0,
                                               dtype="float64",
                                               device="cpu"))
    _, jr = jm.execute(mm.CellularSpace.create(100, 100, 1.0,
                                               dtype=jnp.float64))
    assert (tr.comm_size, tr.rank_id, tr.steps) == (1, 0, jr.steps) == \
        (1, 0, 50)
    assert tr.initial_total == jr.initial_total
    assert tr.final_total["value"] == pytest.approx(
        jr.final_total["value"], abs=1e-9)
    assert tr.last_execute == pytest.approx(jr.last_execute)
    assert tr.conservation_error() < 1e-9 and tr.wall_time_s >= 0.0
    assert {f.name for f in dataclasses.fields(jr)} <= \
        {f.name for f in dataclasses.fields(tr)}
    s = mt.CellularSpace.create(64, 64, 1.0, device="cpu")
    assert tm.conservation_threshold(s) == pytest.approx(
        jm.conservation_threshold(mm.CellularSpace.create(64, 64, 1.0)))
    assert default_conservation_rtol((64, 64), torch.float32) == \
        pytest.approx(4 * 2.0 ** -23 * 12)


def test_interop_carries_jax_state_and_flows():
    rng = np.random.default_rng(8)
    vals = {"value": rng.uniform(0.5, 2.0, (12, 20)),
            "mask": rng.uniform(size=(12, 20)) > 0.5}
    js = mm.CellularSpace.create(12, 20, {"value": 1.0,
                                          "mask": (True, "bool")},
                                 dtype=jnp.float64).with_values(
        {k: jnp.asarray(v) for k, v in vals.items()})
    ts = interop.space_from_numpy(js.to_numpy(), device="cpu")
    assert ts.values["mask"].dtype == torch.bool
    back = interop.space_to_numpy(ts)
    for k in vals:
        np.testing.assert_array_equal(back[k], vals[k])
    # bf16 arrays (as the JAX package hands them out) arrive exactly
    bf = np.asarray(jnp.asarray(vals["value"], jnp.bfloat16))
    tb = interop.space_from_numpy({"value": bf}, device="cpu")
    assert tb.values["value"].dtype == torch.bfloat16
    np.testing.assert_array_equal(interop.space_to_numpy(tb)["value"],
                                  bf.astype(np.float32))
    # partitions keep their origin and global bounds
    p = interop.space_from_numpy({"value": vals["value"]}, x_init=4,
                                 y_init=2, global_shape=(30, 40),
                                 device="cpu")
    assert p.is_partition and p.global_shape == (30, 40)
    # flows: specs from the JAX flows with dataclasses.asdict (a Coupled
    # flow keeps the JAX side off its IR step, as above)
    jflows = [mm.Diffusion(0.13), mm.Coupled(0.05, modulator="value"),
              mm.Exponencial(mm.Cell(3, 4, mm.Attribute(99, 2.2)), 0.1),
              mm.PointFlow(source=(0, 1), flow_rate=0.2)]
    specs = [dict(dataclasses.asdict(f), type=type(f).__name__)
             for f in jflows]
    tflows = interop.flows_from_specs(specs)
    assert [type(f).__name__ for f in tflows] == \
        ["Diffusion", "Coupled", "Exponencial", "PointFlow"]
    assert tflows[2].source_xy == (3, 4)
    assert tflows[2].frozen_source_value == 2.2
    tout, _ = mt.Model(tflows).execute(ts, steps=3)
    jout, _ = mm.Model(jflows).execute(js, steps=3)
    np.testing.assert_allclose(tout.values["value"].numpy(),
                               np.asarray(jout.values["value"]), rtol=0,
                               atol=1e-12)
    with pytest.raises(ValueError, match="unknown flow type"):
        interop.flows_from_specs([{"type": "Nope"}])


def test_oracle_and_offset_copies_equal_the_originals():
    assert tcell.MOORE_OFFSETS == jcell.MOORE_OFFSETS
    assert tcell.VON_NEUMANN_OFFSETS == jcell.VON_NEUMANN_OFFSETS
    v = np.random.default_rng(2).uniform(0.5, 2.0, (9, 11))
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            np.testing.assert_array_equal(toracle.shift2d_np(v, dx, dy),
                                          joracle.shift2d_np(v, dx, dy))
    for offs in (tcell.MOORE_OFFSETS, tcell.VON_NEUMANN_OFFSETS):
        np.testing.assert_array_equal(
            toracle.dense_flow_step_np(v, 0.13, offs),
            joracle.dense_flow_step_np(v, 0.13, offs))
        np.testing.assert_array_equal(
            toracle.transport_np(v, 0.2 * v, offsets=offs),
            joracle.transport_np(v, 0.2 * v, offsets=offs))
    for src in ((0, 0), (4, 10), (8, 5)):
        np.testing.assert_array_equal(
            toracle.point_flow_step_np(v, *src, 0.3),
            joracle.point_flow_step_np(v, *src, 0.3))
    for steps in (1, 7):
        np.testing.assert_array_equal(
            toracle.reference_run_np(steps=steps),
            joracle.reference_run_np(steps=steps))


@pytest.mark.parametrize("argv,impl", [
    (["--flow=diffusion", "--dimx=32", "--dimy=256", "--impl=pallas",
      "--substeps=4", "--steps=9"], "pallas"),
    (["--flow=diffusion", "--dimx=16", "--dimy=16", "--dtype=float64",
      "--steps=3"], "xla"),
    (["--steps=50", "--dtype=float64"], "point"),
    (["--flow=diffusion", "--dimx=64", "--dimy=256", "--impl=composed",
      "--substeps=8", "--steps=16"], "composed"),
    (["--flow=diffusion", "--dimx=64", "--dimy=64", "--impl=active",
      "--blob=0.05", "--dtype=float64", "--steps=5"], "active"),
    (["--flow=diffusion", "--dimx=64", "--dimy=64", "--impl=active_fused",
      "--blob=0.05", "--substeps=4", "--steps=8"], "active_fused"),
])
def test_cli_row(argv, impl, capsys):
    import json

    assert cli_main(["run", "--device=cpu", "--json", *argv]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["impl"] == impl and row["conserved"] is True
    assert row["kernel_launches"] == 0 and row["device"] == "cpu"
    assert set(row) >= {"initial", "final", "wall_s", "steps",
                        "backend_report"}
    if impl in ("active", "active_fused"):
        br = row["backend_report"]
        assert br["impl"] == impl and br["fallback_steps"] == 0
        assert 0.0 < br["mean_active_fraction"] <= 1.0
    if impl == "composed":
        assert row["backend_report"]["composed_k"] == 8


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "mpi_model_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "k1_variants.py",
              REPO / "k3_variants.py", REPO / "k4_variants.py",
              REPO / "k56_variants.py"]
    assert len(files) > 10
    names = {f.name for f in files}
    assert {"active.py", "fused_active.py", "composed_stencil.py",
            "field_lower.py", "field_stencil.py", "field_codegen.py",
            "pipeline_stencil.py", "fused_stencil.py", "cli.py",
            "batch.py", "scheduler.py", "service.py", "metrics.py",
            "events.py", "model_rectangular.py", "output.py",
            "point_kernel.py"} <= names
    rel = {f.relative_to(REPO).as_posix() for f in files}
    assert {f"mpi_model_tpu_torch/parallel/{m}.py" for m in (
        "__init__", "mesh", "collectives", "halo", "executors")} <= rel
    assert {"mpi_model_tpu_torch/io/__init__.py",
            "mpi_model_tpu_torch/io/output.py"} <= rel
    assert {"mpi_model_tpu_torch/resilience/inject.py",
            "mpi_model_tpu_torch/ensemble/service.py",
            "mpi_model_tpu_torch/ensemble/scheduler.py"} <= rel
    assert {"mpi_model_tpu_torch/io/checkpoint.py",
            "mpi_model_tpu_torch/io/delta.py",
            "mpi_model_tpu_torch/resilience/supervisor.py",
            "mpi_model_tpu_torch/resilience/__init__.py"} <= rel
    assert {f"mpi_model_tpu_torch/ir/{m}.py" for m in (
        "__init__", "expr", "terms", "lower", "model", "library")} <= rel
    assert ({f"mpi_model_tpu_torch/utils/{m}.py" for m in (
        "__init__", "metrics", "tracing", "roofline", "compile_cache")}
        | {f"mpi_model_tpu_torch/obs/{m}.py" for m in (
            "__init__", "flight", "__main__")}
        | {"mpi_model_tpu_torch/native.py"}) <= rel
    assert ({f"mpi_model_tpu_torch/ensemble/{m}.py" for m in (
        "lifecycle", "journal", "wire")}
        | {f"mpi_model_tpu_torch/resilience/{m}.py" for m in (
            "lockdep", "protocolcheck")}
        | {"mpi_model_tpu_torch/obs/postmortem.py"}) <= rel
    for f in files:
        bad = _imports(f) & {"jax", "jaxlib", "mpi_model_tpu", "ml_dtypes"}
        assert not bad, f"{f.relative_to(REPO)} imports {sorted(bad)}"


def test_kernel_source_is_in_the_package():
    for name in ("fused_stencil.cu", "composed_stencil.cu", "fused_active.cu",
                 "field_stencil.cuh", "pipeline_stencil.cu",
                 "stencil_common.cuh"):
        assert (REPO / "mpi_model_tpu_torch/csrc" / name).is_file(), name
    # nothing is built at import time
    assert fs.launches() >= 0
