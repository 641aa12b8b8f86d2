"""The port's ``AutoShardedExecutor`` (``--executor=gspmd``) on the CPU.

Meshes are ``[torch.device("cpu")] * n``: 1-D row stripes of 4 and 2×2
blocks. Tolerances:

- against the port's ``SerialExecutor("xla")`` (and, for ``Diffusion``, the
  oracle): bit for bit, at f64 and f32, on every route (per mesh position,
  whole grid, point);
- against the JAX package's ``AutoShardedExecutor`` on the conftest's
  forced host devices: ``atol=1e-12`` at f64. Under jax 0.9 JAX's plain
  ``Diffusion`` XLA step raises (``compat.optimization_barrier``), so JAX
  is compared on point flows, an undeclared flow and a ``Coupled`` chain,
  which route around it.
"""

import datetime
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

import mpi_model_tpu as mm
from mpi_model_tpu import cli as jcli
from mpi_model_tpu.ops.flow import Flow as JFlow
from mpi_model_tpu.parallel import AutoShardedExecutor as JAutoSharded
from mpi_model_tpu.parallel import make_mesh as jmake_mesh
from mpi_model_tpu.parallel import make_mesh_2d as jmake_mesh_2d

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch import cli as tcli
from mpi_model_tpu_torch import oracle
from mpi_model_tpu_torch.ops.flow import Flow
from mpi_model_tpu_torch.parallel import (AutoShardedExecutor,
                                          ShardMapExecutor, grid_spec,
                                          make_mesh, make_mesh_2d)

CPU = torch.device("cpu")

#: (port mesh, JAX mesh) builders by name
MESHES = {
    "1d4": (lambda: make_mesh(4, devices=[CPU] * 4),
            lambda: jmake_mesh(4, devices=jax.devices("cpu")[:4])),
    "2x2": (lambda: make_mesh_2d(2, 2, devices=[CPU] * 4),
            lambda: jmake_mesh_2d(2, 2, devices=jax.devices("cpu")[:4])),
}


def _np(shape, seed, names=("value",)):
    rng = np.random.default_rng(seed)
    return {n: rng.uniform(0.5, 2.0, shape) for n in names}


def tspace(vals, dtype="float64"):
    names = tuple(vals)
    h, w = vals[names[0]].shape
    s = mt.CellularSpace.create(h, w, {n: 1.0 for n in names}, dtype=dtype,
                                device="cpu")
    return s.with_values({k: torch.from_numpy(v).to(s.dtype)
                          for k, v in vals.items()})


def jspace(vals):
    names = tuple(vals)
    h, w = vals[names[0]].shape
    s = mm.CellularSpace.create(h, w, {n: 1.0 for n in names},
                                dtype=jnp.float64)
    return s.with_values({k: jnp.asarray(v, jnp.float64)
                          for k, v in vals.items()})


class Undeclared(Flow):
    """A user flow whose footprint is left undeclared ("unknown")."""

    flow_rate = 0.1
    attr = "value"

    def outflow(self, values, origin=(0, 0)):
        return values[self.attr] * self.flow_rate


class JUndeclared(JFlow):
    flow_rate = 0.1
    attr = "value"

    def outflow(self, values, origin=(0, 0)):
        return values[self.attr] * self.flow_rate


class NeighborMean(Flow):
    """A ``ring1`` flow: rate times the mean of the 3×3 neighbourhood."""

    footprint = "ring1"
    flow_rate = 0.2
    attr = "value"

    def outflow_padded(self, padded, origin=(0, 0)):
        p = padded[self.attr]
        h, w = p.shape[0] - 2, p.shape[1] - 2
        acc = 0.0
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                acc = acc + p[1 + dx:1 + dx + h, 1 + dy:1 + dy + w]
        return torch.tensor(self.flow_rate, dtype=p.dtype) * acc / 9.0


def config4(pkg):
    return [pkg.Diffusion(0.1, attr="a"),
            pkg.Coupled(flow_rate=0.05, attr="a", modulator="b"),
            pkg.Diffusion(0.2, attr="b")]


def masked_space(dtype):
    """The JAX package's masked scenario: a bool land-water mask beside the
    value channel, a ``Coupled`` flow modulated by the mask."""
    g = 32
    rng = np.random.default_rng(3)
    mask = np.zeros((g, g), dtype=bool)
    mask[g // 4: 3 * g // 4, g // 8: 7 * g // 8] = True
    v = rng.uniform(0.5, 2.0, (g, g))
    s = mt.CellularSpace.create(g, g, {"value": 1.0, "mask": (False, "bool")},
                                dtype=dtype, device="cpu")
    return s.with_values({"value": torch.from_numpy(v).to(s.dtype),
                          "mask": torch.from_numpy(mask)})


def serial_run(model, space, steps):
    out, _ = model.execute(space, mt.SerialExecutor("xla"), steps=steps,
                           check_conservation=False)
    return out


def assert_same(a, b):
    assert list(a.values) == list(b.values)
    for k in a.values:
        assert a.values[k].dtype == b.values[k].dtype, k
        assert torch.equal(a.values[k], b.values[k]), k


# -- against the port's serial run, bit for bit -------------------------------

CASES = {
    "diffusion": (lambda: mt.Model(mt.Diffusion(0.13)),
                  lambda d: tspace(_np((16, 32), 3), d), "positions"),
    "masked": (lambda: mt.Model(mt.Coupled(flow_rate=0.2, attr="value",
                                           modulator="mask"), 1.0, 1.0),
               masked_space, "positions"),
    "ring1": (lambda: mt.Model(NeighborMean()),
              lambda d: tspace(_np((16, 32), 6), d), "positions"),
    "coupled": (lambda: mt.Model(config4(mt)),
                lambda d: tspace(_np((16, 32), 5, ("a", "b")), d),
                "positions"),
    "undeclared": (lambda: mt.Model(Undeclared()),
                   lambda d: tspace(_np((16, 32), 10), d), "whole"),
    "point": (lambda: mt.Model(mt.Exponencial(mt.Cell(
        7, 15, mt.Attribute(99, 2.2)), 0.1)),
        lambda d: tspace(_np((16, 32), 8), d), "point"),
}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("meshname", sorted(MESHES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_every_route_is_the_serial_run_bit_for_bit(case, meshname, dtype):
    make_model, make_space, route = CASES[case]
    model, space = make_model(), make_space(dtype)
    ex = AutoShardedExecutor(MESHES[meshname][0]())
    out, rep = model.execute(space, ex, steps=5, check_conservation=False)
    assert ex.last_route == route
    assert rep.impl == ("point" if route == "point" else "xla")
    assert rep.comm_size == 4 and rep.backend_report is None
    assert_same(out, serial_run(model, space, 5))
    if case == "masked":
        assert out.values["mask"].dtype == torch.bool


@pytest.mark.parametrize("meshname", sorted(MESHES))
def test_diffusion_is_the_oracle(meshname):
    vals = _np((16, 32), 3)
    out, _ = mt.Model(mt.Diffusion(0.13)).execute(
        tspace(vals), AutoShardedExecutor(MESHES[meshname][0]()), steps=5)
    want = vals["value"]
    for _ in range(5):
        want = oracle.dense_flow_step_np(want, 0.13)
    np.testing.assert_array_equal(out.values["value"].numpy(), want)


@pytest.mark.parametrize("name", ["diffusion", "gray_scott", "sir",
                                  "predator_prey"])
def test_every_ir_model_is_its_serial_run(name):
    """JAX's ``tests/test_ir.py`` sharded matrix's GSPMD leg: every library
    model, 8 steps at f64 on a 1-D mesh of 4, bit for bit its serial run,
    ``comm_size == 4``."""
    model, space = mt.build_model(name, 32, dtype="float64", device="cpu")
    want, _ = model.execute(space, steps=8)
    out, rep = model.execute(space, AutoShardedExecutor(
        MESHES["1d4"][0]()), steps=8)
    assert_same(out, want)
    assert rep.comm_size == 4 and rep.impl == "xla"


def test_zero_steps_and_a_cached_runner_serve_any_count():
    space = tspace(_np((16, 32), 12))
    model = mt.Model(mt.Diffusion(0.1))
    ex = AutoShardedExecutor(MESHES["2x2"][0]())
    out = ex.run_model(model, space, 0)
    assert torch.equal(out["value"], space.values["value"])
    for steps in (3, 4):
        assert torch.equal(ex.run_model(model, space, steps)["value"],
                           serial_run(model, space, steps).values["value"])
    # the point route on zero steps runs the global step, as JAX's does
    pt = mt.Model(mt.PointFlow((3, 3), 0.2))
    ex.run_model(pt, space, 0)
    assert ex.last_impl == "xla"


def test_a_mutated_flow_rebuilds_and_the_cache_holds_no_space():
    space = tspace(_np((16, 32), 13))
    flow = Undeclared()
    model = mt.Model(flow)
    ex = AutoShardedExecutor(MESHES["1d4"][0]())
    first = ex.run_model(model, space, 2)["value"]
    flow.flow_rate = 0.3
    second = ex.run_model(model, space, 2)["value"]
    assert not torch.equal(first, second)
    assert torch.equal(second, serial_run(model, space, 2).values["value"])
    pt = mt.Model([mt.PointFlow((3, 3), 0.2)])
    a = ex.run_model(pt, space, 2)["value"]
    pt.flows[0].flow_rate = 0.4
    b = ex.run_model(pt, space, 2)["value"]
    assert torch.equal(b, serial_run(pt, space, 2).values["value"])
    assert not torch.equal(a, b)
    # no cached runner holds the space it was built for
    from mpi_model_tpu_torch.analysis.step_audit import closure_tensors

    ex.run_model(mt.Model(mt.Diffusion(0.1)), space, 2)
    ptr = space.values["value"].untyped_storage().data_ptr()
    runners = ([r for r in ex._global._cache.values() if r]
               + [r for _, r in ex._positions._cache.values()])
    assert len(runners) == 3
    for runner in runners:
        assert not [p for p, t in closure_tensors(runner)
                    if isinstance(t, torch.Tensor)
                    and t.untyped_storage().data_ptr() == ptr]


def test_no_chaos_seam_on_the_gspmd_path():
    """JAX's ``AutoShardedExecutor.run_model`` has no fault seam: an armed
    executor fault never fires there (ShardMapExecutor's does)."""
    from mpi_model_tpu_torch.resilience import inject

    space = tspace(_np((16, 32), 14))
    model = mt.Model(mt.Diffusion(0.1))
    plan = inject.FaultPlan((inject.Fault("exc", at=0),))
    with inject.armed(plan) as st:
        AutoShardedExecutor(MESHES["2x2"][0]()).run_model(model, space, 2)
        assert st.fired == []
    with inject.armed(plan):
        with pytest.raises(inject.InjectedFault):
            ShardMapExecutor(MESHES["2x2"][0]()).run_model(model, space, 2)


# -- against JAX's AutoShardedExecutor, atol 1e-12 at f64 ---------------------

@pytest.mark.parametrize("meshname", sorted(MESHES))
def test_point_flows_frozen_and_dynamic_against_jax(meshname):
    """JAX's ``test_gspmd_point_subsystem_fast_path``: a frozen source and
    a dynamic one take the point subsystem (``"point"``), bit for bit the
    serial point path and within 1e-12 of JAX's."""
    def flows(pkg):
        return [pkg.PointFlow(source=(7, 15), flow_rate=0.3,
                              frozen_source_value=2.2),
                pkg.PointFlow(source=(3, 3), flow_rate=0.1)]

    vals = _np((16, 32), 15)
    model = mt.Model(flows(mt), 6.0, 1.0)
    ex = AutoShardedExecutor(MESHES[meshname][0]())
    out = ex.run_model(model, tspace(vals), 6)
    assert ex.last_impl == "point"
    serial = mt.SerialExecutor()
    want = serial.run_model(model, tspace(vals), 6)
    assert serial.last_impl == "point"
    assert torch.equal(out["value"], want["value"])
    jex = JAutoSharded(MESHES[meshname][1]())
    jout = jex.run_model(mm.Model(flows(mm), 6.0, 1.0), jspace(vals), 6)
    assert jex.last_impl == "point"
    np.testing.assert_allclose(out["value"].numpy(),
                               np.asarray(jout["value"]), atol=1e-12, rtol=0)


@pytest.mark.parametrize("meshname", sorted(MESHES))
def test_undeclared_flow_against_jax(meshname):
    vals = _np((16, 32), 10)
    out, _ = mt.Model(Undeclared()).execute(
        tspace(vals), AutoShardedExecutor(MESHES[meshname][0]()), steps=3,
        check_conservation=False)
    jex = JAutoSharded(MESHES[meshname][1]())
    jout, _ = mm.Model(JUndeclared()).execute(jspace(vals), jex, steps=3,
                                              check_conservation=False)
    assert jex.last_impl == "xla"
    np.testing.assert_allclose(out.values["value"].numpy(),
                               np.asarray(jout.values["value"]), atol=1e-12,
                               rtol=0)


@pytest.mark.parametrize("meshname", sorted(MESHES))
def test_coupled_model_against_jax(meshname):
    vals = _np((16, 32), 5, ("a", "b"))
    out, rep = mt.Model(config4(mt)).execute(
        tspace(vals), AutoShardedExecutor(MESHES[meshname][0]()), steps=4)
    jex = JAutoSharded(MESHES[meshname][1]())
    jout, _ = mm.Model(config4(mm)).execute(jspace(vals), jex, steps=4)
    assert rep.impl == jex.last_impl == "xla"
    for n in ("a", "b"):
        np.testing.assert_allclose(out.values[n].numpy(),
                                   np.asarray(jout.values[n]), atol=1e-12,
                                   rtol=0)


# -- the spec and the divisibility rule -----------------------------------------

def test_default_and_row_only_specs_give_equal_values():
    mesh = MESHES["2x2"][0]()
    assert grid_spec(mesh) == ("x", "y")
    assert grid_spec(MESHES["1d4"][0]()) == ("x", None)
    vals = _np((16, 32), 16)
    model = mt.Model(config4(mt)[:1] + [mt.Diffusion(0.2)])
    space = tspace({"a": vals["value"], "value": vals["value"][::-1].copy()})
    default = AutoShardedExecutor(mesh)
    rows = AutoShardedExecutor(mesh, spec=("x", None))
    assert default.spec == ("x", "y") and rows.spec == ("x", None)
    a = default.run_model(model, space, 4)
    b = rows.run_model(model, space, 4)
    for k in a:
        assert torch.equal(a[k], b[k])
    with pytest.raises(ValueError, match="distinct mesh axis name"):
        AutoShardedExecutor(mesh, spec=("x", "x"))
    with pytest.raises(ValueError, match="distinct mesh axis name"):
        AutoShardedExecutor(mesh, spec=("z", None))


@pytest.mark.parametrize("meshname", sorted(MESHES))
def test_a_grid_the_mesh_does_not_divide_raises_jax_s_text(meshname):
    vals = _np((15, 30), 17)
    model = mt.Model(Undeclared())
    with pytest.raises(ValueError) as te:
        AutoShardedExecutor(MESHES[meshname][0]()).run_model(
            model, tspace(vals), 1)
    with pytest.raises(ValueError) as je:
        JAutoSharded(MESHES[meshname][1]()).run_model(
            mm.Model(JUndeclared()), jspace(vals), 1)
    assert str(te.value) == str(je.value)
    assert "divisibility requirement" in str(te.value)


# -- the CLI ---------------------------------------------------------------------

def _row(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_gspmd_rows(capsys):
    """JAX's ``test_cli_gspmd_executor``: ``impl`` ``"xla"``, four ranks,
    conserved; the default scenario (a point source) reports ``"point"``,
    as JAX's row does."""
    base = ["run", "--mesh=4x1", "--executor=gspmd", "--dtype=float64",
            "--json"]
    assert tcli.main(base + ["--device=cpu", "--flow=diffusion",
                             "--dimx=32", "--dimy=32", "--steps=4"]) == 0
    row = _row(capsys)
    assert row["impl"] == "xla" and row["comm_size"] == 4
    assert row["conserved"] is True and row["kernel_launches"] == 0
    assert row["mesh"] == {"lines": 4, "columns": 1, "devices": 1}
    assert tcli.main(base + ["--device=cpu"]) == 0
    row = _row(capsys)
    assert jcli.main(base) == 0
    jrow = _row(capsys)
    assert row["impl"] == jrow["impl"] == "point"
    assert row["comm_size"] == jrow["ranks"] == 4
    assert row["conserved"] is jrow["conserved"] is True
    assert row["final"] == jrow["final"]


@pytest.mark.parametrize("argv", [
    ["--executor=gspmd"],
    ["--rectangular=2x3", "--executor=gspmd"],
    ["--mesh=4", "--executor=gspmd", "--impl=pallas"],
    ["--mesh=4", "--executor=gspmd", "--impl=composed"],
    ["--mesh=4", "--executor=gspmd", "--halo-depth=2"],
    ["--mesh=4", "--executor=gspmd", "--compute-dtype=bfloat16"],
    ["--executor=gspmd", "--halo-depth=2"],
    ["--rectangular=2x2", "--mesh=2x2", "--executor=gspmd"],
    ["--serve", "--executor=gspmd"],
    ["--serve", "--mesh=2x2", "--executor=gspmd"],
])
def test_cli_refuses_with_jax_s_words(argv):
    with pytest.raises(SystemExit) as te:
        tcli.main(["run", "--device=cpu", *argv])
    with pytest.raises(SystemExit) as je:
        jcli.main(["run", *argv])
    assert str(te.value) == str(je.value)


def test_cli_runs_an_undeclared_flow_that_shardmap_refuses(capsys,
                                                         monkeypatch):
    """JAX's ``test_cli_gspmd_runs_unknown_footprint_flow``."""
    real = tcli.build_scenario

    def patched(args):
        space, model = real(args)
        model.flows = [Undeclared()]
        return space, model

    monkeypatch.setattr(tcli, "build_scenario", patched)
    argv = ["run", "--device=cpu", "--dimx=32", "--dimy=32", "--steps=2",
            "--mesh=4x1", "--dtype=float64", "--json"]
    assert tcli.main(argv + ["--executor=gspmd"]) == 0
    row = _row(capsys)
    assert row["conserved"] is True and row["impl"] == "xla"
    with pytest.raises(ValueError, match="footprint"):
        tcli.main(argv + ["--executor=shardmap"])


@pytest.mark.parametrize("layout", [["--checkpoint-layout=sharded"],
                                    ["--checkpoint-layout=sharded",
                                     "--async-checkpoints"]])
def test_cli_sharded_checkpoints_restore_bit_for_bit(tmp_path, capsys,
                                                     layout):
    """A checkpointed gspmd run writes one piece a mesh block; resumed from
    its newest checkpoint, it ends bit for bit the uninterrupted run, and
    the checkpoint restores through the mesh as the serial state."""
    from mpi_model_tpu_torch.io import CheckpointManager

    ck = tmp_path / "ck"
    argv = ["run", "--device=cpu", "--flow=diffusion", "--dimx=32",
            "--dimy=32", "--mesh=2x2", "--executor=gspmd",
            "--dtype=float64", f"--checkpoint-dir={ck}",
            "--checkpoint-every=2", "--json", *layout]
    assert tcli.main(argv + ["--steps=4"]) == 0
    assert _row(capsys)["checkpoint_steps"][-1] == 4
    assert tcli.main(argv + ["--steps=6"]) == 0
    row = _row(capsys)
    assert row["impl"] == "xla" and row["comm_size"] == 4
    assert row["conserved"] and row["checkpoint_steps"][-1] == 6
    assert row["recovered_failures"] == 0
    space = tspace({"value": np.ones((32, 32))})
    want = serial_run(mt.Model(mt.Diffusion(0.1)), space, 6)
    assert row["final"]["value"] == float(want.total("value"))
    got = CheckpointManager(str(ck), layout="sharded", device="cpu").latest(
        mesh=MESHES["2x2"][0]())
    assert got.step == 6
    assert torch.equal(got.space.values["value"], want.values["value"])


def test_cli_chaos_and_output_compose_as_in_jax(tmp_path, capsys):
    """``--chaos`` runs supervised and fires nothing on the GSPMD path (it
    has no executor seam, in either package); ``--output`` writes a dump a
    rank and the merged file."""
    base = ["run", "--mesh=4x1", "--executor=gspmd", "--dtype=float64",
            "--steps=3", "--chaos=exc:0", "--json"]
    assert tcli.main(base + ["--device=cpu"]) == 0
    row = _row(capsys)
    assert jcli.main(base) == 0
    jrow = _row(capsys)
    for k in ("injected_faults", "recovered_failures", "conserved",
              "final"):
        assert row[k] == jrow[k], k
    assert row["injected_faults"] == 0 and row["impl"] == "point"
    out = tmp_path / "out"
    assert tcli.main(["run", "--device=cpu", "--mesh=2x2", "--dimx=20",
                      "--dimy=20", "--executor=gspmd", "--flow=diffusion",
                      "--steps=2", f"--output={out}", "--json"]) == 0
    assert _row(capsys)["conserved"]
    names = sorted(os.listdir(out))
    assert [n for n in names if n.startswith("comm_rank")] == [
        f"comm_rank{r}.txt" for r in range(4)]
    assert sum(n.startswith("output ") for n in names) == 1


def test_a_world_of_one_runs_every_route(tmp_path, capsys):
    """A gloo group of one process: every route is the one-process run,
    and the CLI's gspmd row is the same."""
    spaces = {c: (m(), s("float64")) for c, (m, s, _) in CASES.items()}
    alone = {c: AutoShardedExecutor(MESHES["2x2"][0]()).run_model(
        m, s, 3) for c, (m, s) in spaces.items()}
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        for c, (m, s) in spaces.items():
            ex = AutoShardedExecutor(MESHES["2x2"][0]())
            got = ex.run_model(m, s, 3)
            assert ex.last_route == CASES[c][2]
            for k in got:
                assert torch.equal(got[k], alone[c][k]), (c, k)
        assert tcli.main(["run", "--device=cpu", "--mesh=2x2",
                          "--executor=gspmd", "--flow=diffusion",
                          "--dimx=16", "--dimy=16", "--steps=3",
                          "--json"]) == 0
        row = _row(capsys)
        assert row["conserved"] and row["impl"] == "xla"
    finally:
        dist.destroy_process_group()
