"""``ModelRectangular``, the output dumps and the sharded CLI rows of the
port against the JAX package, on the CPU (meshes of
``[torch.device("cpu")] * n`` beside the conftest's forced host devices).

The reference scenario (20×60 on a 2×3 block mesh, an Exponencial source
at (18, 19) whose shares cross both block axes) is held bit for bit at f64
to the JAX package's ``ModelRectangular``, to the port's serial run and to
an oracle of repeated point steps; the output files are byte for byte the
JAX package's."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import mpi_model_tpu as mm
from mpi_model_tpu.io import output as joutput

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch import oracle
from mpi_model_tpu_torch.cli import main as cli_main
from mpi_model_tpu_torch.io import output as toutput
from mpi_model_tpu_torch.parallel import ShardMapExecutor, make_mesh_2d

CPU = torch.device("cpu")


def _cpus(n):
    return [CPU] * n


def test_reference_scenario_matches_jax_serial_and_oracle():
    space, model = mt.ModelRectangular.reference_scenario(device="cpu")
    ex = model.default_executor(devices=_cpus(6))
    out, rep = model.execute(space, ex)
    assert rep.comm_size == 6 and rep.steps == 50
    assert rep.conservation_error() == 0.0
    jspace, jmodel = mm.ModelRectangular.reference_scenario()
    jout, jrep = jmodel.execute(
        jspace, jmodel.default_executor(devices=jax.devices("cpu")[:6]))
    np.testing.assert_array_equal(out.values["value"].numpy(),
                                  np.asarray(jout.values["value"]))
    assert rep.final_total == jrep.final_total
    serial, _ = mt.Model(model.flows, model.time, model.time_step).execute(
        space)
    assert torch.equal(out.values["value"], serial.values["value"])
    np.testing.assert_array_equal(
        out.values["value"].numpy(),
        oracle.reference_run_np(20, 60, src=(18, 19), steps=50))
    # the corner: (18, 19)'s diagonal (19, 20) sits in block (1, 1)
    assert float(out.values["value"][19, 20]) > 1.0


@pytest.mark.parametrize("impl,depth", [("xla", 1), ("xla", 2),
                                        ("pallas", 4), ("auto", 4)])
def test_diffusion_on_blocks_matches_the_serial_run(impl, depth):
    rng = np.random.default_rng(2)
    dtype = "float64" if impl == "xla" else "float32"
    space = mt.CellularSpace.create(32, 768, 1.0, dtype=dtype, device="cpu")
    space = space.with_values({"value": torch.from_numpy(
        rng.uniform(0.5, 2.0, (32, 768))).to(space.dtype)})
    model = mt.ModelRectangular(mt.Diffusion(0.1), 6.0, 1.0, lines=2,
                                columns=3, step_impl=impl, halo_depth=depth)
    out, rep = model.execute(space, model.default_executor(
        devices=_cpus(6)))
    assert rep.impl == ("xla" if impl == "xla" else "pallas")
    serial = mt.Model(mt.Diffusion(0.1), 6.0, 1.0)
    if impl == "xla":
        want, _ = serial.execute(space, mt.SerialExecutor("xla"))
        assert torch.equal(out.values["value"], want.values["value"])
        return
    # 6 steps at depth 4: the blocks run a 4-step chunk and a 2-step one;
    # K1 takes the closed form past the call's depth from the edge, so the
    # serial run of the same chunks is the bit-for-bit reference
    want, _ = serial.execute(space, mt.SerialExecutor("pallas", substeps=4),
                             steps=4)
    want, _ = serial.execute(want, mt.SerialExecutor("pallas", substeps=2),
                             steps=2)
    assert torch.equal(out.values["value"], want.values["value"])
    single, _ = serial.execute(space, mt.SerialExecutor("pallas",
                                                        substeps=depth))
    v = single.values["value"]
    gap = float((out.values["value"] - v).abs().max())
    assert gap <= 2 * 2.0 ** -23 * 6 * float(v.abs().max())


def test_owner_map_where_the_reference_is_wrong():
    """The reference's ``(x + y) / height + 1`` collides cells (0, 59) and
    (18, 1); the block map gives every cell the block containing it, as the
    JAX package's does."""
    space, model = mt.ModelRectangular.reference_scenario(device="cpu")
    jspace, jmodel = mm.ModelRectangular.reference_scenario()
    parts = model.partitions(space)
    assert [p.describe() for p in parts] == [
        p.describe() for p in jmodel.partitions(jspace)]
    assert [p.describe() for p in parts[:3]] == [
        "0|0:10|20", "0|20:10|20", "0|40:10|20"]
    for x, y in [(0, 0), (0, 59), (18, 1), (9, 19), (10, 20), (19, 59),
                 (18, 19)]:
        r = model.owner_of(x, y, space)
        assert parts[r].contains(x, y)
        assert r == jmodel.owner_of(x, y, jspace)
    assert model.owner_of(0, 59, space) != model.owner_of(18, 1, space)
    with pytest.raises(IndexError):
        model.owner_of(20, 0, space)


def test_write_output_is_byte_identical_to_jax(tmp_path):
    space, model = mt.ModelRectangular.reference_scenario(device="cpu")
    out, _ = model.execute(space, model.default_executor(devices=_cpus(6)),
                           steps=3)
    jspace, jmodel = mm.ModelRectangular.reference_scenario()
    jout, _ = jmodel.execute(
        jspace, jmodel.default_executor(devices=jax.devices("cpu")[:6]),
        steps=3)
    t_dir, j_dir = tmp_path / "port", tmp_path / "jax"
    merged = model.write_output(str(t_dir), out, timestamp="TEST")
    jmerged = jmodel.write_output(str(j_dir), jout, timestamp="TEST")
    assert Path(merged).name == Path(jmerged).name == "output TEST.txt"
    assert Path(merged).read_bytes() == Path(jmerged).read_bytes()
    for r in range(6):
        name = f"comm_rank{r}.txt"
        assert (t_dir / name).read_bytes() == (j_dir / name).read_bytes()
    seen = set()
    for line in Path(merged).read_text().splitlines():
        x, y, _ = line.split("\t")
        assert (int(x), int(y)) not in seen
        seen.add((int(x), int(y)))
    assert len(seen) == 20 * 60


def test_row_striped_output_and_exact_format_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    v = rng.uniform(0.5, 2.0, (12, 5))
    space = mt.CellularSpace.create(12, 5, 1.0, dtype="float64",
                                    device="cpu").with_values(
        {"value": torch.from_numpy(v)})
    jspace = mm.CellularSpace.create(12, 5, 1.0, dtype="float64").with_values(
        {"value": jax.numpy.asarray(v)})
    for fmt in ("{:.6g}", "{:.17g}"):
        a = toutput.write_output(str(tmp_path / "t"), space, comm_size=3,
                                 fmt=fmt, timestamp="T")
        b = joutput.write_output(str(tmp_path / "j"), jspace, comm_size=3,
                                 fmt=fmt, timestamp="T")
        assert Path(a).read_bytes() == Path(b).read_bytes()
    assert toutput.output_filename("X") == joutput.output_filename("X")


def test_geometry_follows_the_executed_mesh():
    """lines=2 with the columns inferred from 6 devices: a 2x3 mesh, and the
    block map follows it; an explicitly passed executor becomes the source
    of truth too."""
    model = mt.ModelRectangular(mt.Diffusion(0.1), 2.0, 1.0, lines=2)
    space = mt.CellularSpace.create(16, 24, 1.0, dtype="float64",
                                    device="cpu")
    ex = model.default_executor(devices=_cpus(6))
    assert ex.mesh.shape == {"x": 2, "y": 3}
    parts = model.partitions(space)
    assert len(parts) == 6 and parts[1].describe() == "0|8:8|8"
    model = mt.ModelRectangular(mt.Diffusion(0.1), 2.0, 1.0, lines=2)
    out, rep = model.execute(space, ShardMapExecutor(
        make_mesh_2d(2, 3, devices=_cpus(6))))
    assert rep.comm_size == 6
    assert model.partitions(space)[1].describe() == "0|8:8|8"


def test_default_executor_wants_the_card():
    model = mt.ModelRectangular(mt.Diffusion(0.1), lines=2, columns=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            model.default_executor()
    else:
        ex = model.default_executor()
        assert ex.mesh.distinct_devices()[0].type == "cuda"


# -- the CLI -------------------------------------------------------------------

def _row(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("argv,impl,mesh", [
    (["--flow=diffusion", "--dimx=32", "--dimy=256", "--mesh=2x2",
      "--impl=pallas", "--halo-depth=4", "--steps=6"], "pallas",
     {"lines": 2, "columns": 2, "devices": 1}),
    (["--flow=diffusion", "--dimx=32", "--dimy=32", "--mesh=4",
      "--dtype=float64", "--steps=3"], "xla",
     {"lines": 4, "columns": 1, "devices": 1}),
    (["--flow=coupled", "--dimx=32", "--dimy=256", "--mesh=2x2",
      "--impl=pallas", "--halo-depth=2", "--steps=4"], "pallas",
     {"lines": 2, "columns": 2, "devices": 1}),
])
def test_cli_mesh_rows(argv, impl, mesh, capsys):
    assert cli_main(["run", "--device=cpu", "--json", *argv]) == 0
    row = _row(capsys)
    assert row["backend"] == "sharded" and row["impl"] == impl
    assert row["comm_size"] == mesh["lines"] * mesh["columns"]
    assert row["mesh"] == mesh and row["conserved"] is True
    assert row["kernel_launches"] == 0  # the CPU runs the plain versions
    if impl == "pallas":
        assert row["backend_report"]["kernel"] in (
            "K2 fused_stencil_halo", "K4-halo field_stencil")


def test_cli_rectangular_row_with_the_owner(capsys):
    assert cli_main(["run", "--device=cpu", "--json", "--rectangular=2x3",
                     "--dimx=20", "--dimy=60", "--dtype=float64",
                     "--steps=50", "--owner-of=18,19"]) == 0
    row = _row(capsys)
    assert row["comm_size"] == 6 and row["rectangular"] == "2x3"
    assert row["mesh"] == {"lines": 2, "columns": 3, "devices": 1}
    assert row["owner_of"]["owner"] == 3
    assert row["owner_of"]["partitions"][3] == "10|0:10|20"
    assert row["conservation_error"] == 0.0


@pytest.mark.parametrize("argv,what", [
    # runs, as the JAX CLI runs it (what None: the run exits 0)
    (["--mesh=2x2", "--executor=gspmd"], None),
    (["--halo-depth=2"], "--halo-depth applies to sharded execution"),
    (["--mesh=2x2", "--substeps=2"], "--substeps applies to the serial"),
    (["--mesh=2x2", "--rectangular=2x2"], "--rectangular IS the mesh"),
    (["--executor=shardmap"], "--executor=shardmap needs --mesh"),
    (["--mesh=2x2", "--executor=serial"], "contradicts"),
    (["--owner-of=1,2"], "--owner-of reports the 2-D block owner"),
    (["--mesh=0x2"], "not N or LxC"),
    (["--mesh=2x2", "--ensemble=2"], "drop --mesh/--rectangular"),
])
def test_cli_error_rows(argv, what):
    if what is None:
        assert cli_main(["run", "--device=cpu", "--json", *argv]) == 0
        return
    with pytest.raises(SystemExit) as e:
        cli_main(["run", "--device=cpu", "--json", *argv])
    assert what in str(e.value)
