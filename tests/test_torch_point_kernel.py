"""The port's point subsystem (``ops/point_kernel.py``) and the reference
scenario's CLI flags, on the CPU, against the JAX package's
``ops/point_kernel.py``, its executors and CLI, the port's own full-grid
point step and the oracle.

Tolerances:

- plans: field for field equal to JAX's (f32, f64);
- frozen non-overlapping flows: bit for bit the port's full-grid
  ``point_flow_step``, ``oracle.point_flow_step_np`` and JAX's runs;
- the sequenced branches (overlapping neighbourhoods, dynamic amounts):
  within one ulp of ``max|v|`` a step of both;
- the CLI's ``--output`` files: byte for byte JAX's CLI's (the merged
  file's name carries a timestamp, so its contents are compared).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mpi_model_tpu as mm
from mpi_model_tpu import cli as jcli
from mpi_model_tpu.models.model import SerialExecutor as JSerial
from mpi_model_tpu.ops import point_kernel as jpk
from mpi_model_tpu.parallel import ShardMapExecutor as JShardMap
from mpi_model_tpu.parallel import make_mesh as jmake_mesh

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch import cli as tcli
from mpi_model_tpu_torch import oracle
from mpi_model_tpu_torch.ops import point_kernel as tpk
from mpi_model_tpu_torch.parallel import ShardMapExecutor, make_mesh

CPU = torch.device("cpu")
EPS = {"float64": 2.0 ** -52, "float32": 2.0 ** -23}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread keeps the runs' times steady on a
    shared machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: scenario name -> [(x, y, value or None, rate)]; None = a dynamic flow
SCENARIOS = {
    "reference": [(19, 3, 2.2, 0.1)],
    "disjoint": [(5, 5, 2.2, 0.1), (20, 11, 1.7, 0.2), (0, 0, 3.0, 0.05),
                 (39, 23, 1.1, 0.3)],
    "overlap": [(5, 5, 2.2, 0.1), (5, 7, 1.7, 0.2)],
    "same_source": [(5, 5, 2.2, 0.1), (5, 5, 1.7, 0.2)],
    "dynamic": [(5, 5, None, 0.1), (20, 11, 1.7, 0.2)],
    "dynamic_overlap": [(5, 5, None, 0.1), (6, 6, None, 0.15),
                        (0, 23, None, 0.2)],
}


def flows_of(pkg, spec):
    out = []
    for x, y, val, rate in spec:
        if val is None:
            out.append(pkg.PointFlow(source=(x, y), flow_rate=rate))
        else:
            out.append(pkg.Exponencial(pkg.Cell(x, y, pkg.Attribute(99, val)),
                                       rate))
    return out


def initial(shape=(40, 24), seed=3):
    return np.random.default_rng(seed).uniform(0.5, 2.0, shape)


def tspace(v, dtype="float64"):
    s = mt.CellularSpace.create(v.shape[0], v.shape[1], 1.0, dtype=dtype,
                                device="cpu")
    return s.with_values({"value": torch.from_numpy(v).to(s.dtype)})


def jspace(v, dtype="float64"):
    s = mm.CellularSpace.create(v.shape[0], v.shape[1], 1.0,
                                dtype=jnp.dtype(dtype))
    return s.with_values({"value": jnp.asarray(v, jnp.dtype(dtype))})


def full_grid(model, space, steps):
    """The port's full-grid point path: ``make_step(impl="xla")``, one
    ``point_flow_step`` a step."""
    step = model.make_step(space, impl="xla")
    vals = dict(space.values)
    for _ in range(steps):
        vals = step(vals)
    return vals["value"].numpy()


def oracle_run(v, spec, steps):
    """The oracle's point steps: every amount read from the pre-step values,
    each flow's shed and shares applied in turn."""
    out = v.copy()
    for _ in range(steps):
        pre = out.copy()
        for x, y, val, rate in spec:
            amt = rate * (val if val is not None else pre[x, y])
            out = oracle.point_flow_step_np(out, x, y, amt)
    return out


# -- plans ---------------------------------------------------------------------

def _plans_equal(tp, jp):
    assert tp.keys() == jp.keys()
    for a in tp:
        t, j = tp[a], jp[a]
        assert t.attr == j.attr and t.m == j.m
        np.testing.assert_array_equal(t.xs, j.xs)
        np.testing.assert_array_equal(t.ys, j.ys)
        assert (t.delta is None) == (j.delta is None)
        if t.delta is not None:
            assert t.delta.dtype == np.asarray(j.delta).dtype
            np.testing.assert_array_equal(t.delta, np.asarray(j.delta))
        assert (t.phase_deltas is None) == (j.phase_deltas is None)
        if t.phase_deltas is not None:
            assert len(t.phase_deltas) == len(j.phase_deltas)
            for a1, b1 in zip(t.phase_deltas, j.phase_deltas):
                np.testing.assert_array_equal(a1, np.asarray(b1))
        assert (t.dyn is None) == (j.dyn is None)
        if t.dyn is not None:
            assert t.dyn.keys() == j.dyn.keys()
            for k in t.dyn:
                assert t.dyn[k].dtype == np.asarray(j.dyn[k]).dtype, k
                np.testing.assert_array_equal(t.dyn[k], np.asarray(j.dyn[k]))
        assert t.frozen_only == j.frozen_only


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_build_point_plans_equals_jax_field_by_field(name, dtype):
    v = initial()
    spec = SCENARIOS[name]
    tp = tpk.build_point_plans(flows_of(mt, spec), tspace(v, dtype),
                               mt.Model(flows_of(mt, spec)).offsets)
    jp = jpk.build_point_plans(flows_of(mm, spec), jspace(v, dtype),
                               mm.Model(flows_of(mm, spec)).offsets)
    _plans_equal(tp, jp)
    kind = {"reference": "delta", "disjoint": "delta", "overlap": "phase",
            "same_source": "dyn", "dynamic": "dyn",
            "dynamic_overlap": "dyn"}[name]
    p = tp["value"]
    assert {"delta": p.delta, "phase": p.phase_deltas,
            "dyn": p.dyn}[kind] is not None


def test_build_point_plans_on_a_partition_equals_jax():
    """Owner test and local coordinates on a partition with a global
    origin: a flow outside the partition is dropped, and shares leaving it
    are dropped while counts stay global."""
    v = initial((40, 24))
    spec = [(12, 3, 2.2, 0.1), (10, 20, 1.3, 0.2), (30, 5, 1.0, 0.1)]
    tpart = mt.CellularSpace.create(40, 24, 1.0, dtype="float64",
                                    device="cpu").with_values(
        {"value": torch.from_numpy(v)}).slice_partition(
            mt.Partition(rank=1, x_init=10, y_init=0, height=10, width=24))
    jpart = jspace(v).slice_partition(
        mm.Partition(rank=1, x_init=10, y_init=0, height=10, width=24))
    tp = tpk.build_point_plans(flows_of(mt, spec), tpart,
                               mt.Model.offsets)
    jp = jpk.build_point_plans(flows_of(mm, spec), jpart, mm.Model.offsets)
    _plans_equal(tp, jp)
    assert tp["value"].m < 27


def test_build_point_plans_refuses_as_jax_does():
    v = initial()
    many = [(i % 40, (i * 7) % 24, 1.0 + i / 100, 0.01) for i in range(65)]
    assert tpk.MAX_FLOWS == jpk.MAX_FLOWS == 64
    for spec, space_t, space_j in (
            (many, tspace(v), jspace(v)),
            (many[:64], tspace(v), jspace(v))):
        tp = tpk.build_point_plans(flows_of(mt, spec), space_t,
                                   mt.Model.offsets)
        jp = jpk.build_point_plans(flows_of(mm, spec), space_j,
                                   mm.Model.offsets)
        assert (tp is None) == (jp is None) == (len(spec) > 64)
    ti = mt.CellularSpace.create(16, 16, {"value": (1, "int64")},
                                 device="cpu")
    ji = mm.CellularSpace.create(16, 16, {"value": (1, "int64")})
    spec = [(5, 5, 2.0, 0.1)]
    assert tpk.build_point_plans(flows_of(mt, spec), ti,
                                 mt.Model.offsets) is None
    assert jpk.build_point_plans(flows_of(mm, spec), ji,
                                 mm.Model.offsets) is None
    mixed = flows_of(mt, spec) + [mt.Diffusion(0.1)]
    assert tpk.build_point_plans(mixed, tspace(v), mt.Model.offsets) is None
    assert tpk.build_point_plans([], tspace(v), mt.Model.offsets) is None


# -- values --------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["reference", "disjoint"])
def test_frozen_flows_bitwise_full_grid_oracle_and_jax(name, dtype):
    v = initial()
    spec = SCENARIOS[name]
    steps = 7
    model = mt.Model(flows_of(mt, spec))
    ex = mt.SerialExecutor("xla")
    out, rep = model.execute(tspace(v, dtype), ex, steps=steps)
    assert ex.last_impl == rep.impl == "point"
    got = out.values["value"].numpy()
    np.testing.assert_array_equal(got, full_grid(model, tspace(v, dtype),
                                                 steps))
    jex = JSerial("xla")
    jout, _ = mm.Model(flows_of(mm, spec)).execute(jspace(v, dtype), jex,
                                                   steps=steps)
    assert jex.last_impl == "point"
    np.testing.assert_array_equal(got, np.asarray(jout.values["value"]))
    if dtype == "float64":
        np.testing.assert_array_equal(got, oracle_run(v, spec, steps))


@pytest.mark.parametrize("name", ["overlap", "same_source", "dynamic",
                                  "dynamic_overlap"])
def test_sequenced_branches_within_an_ulp_a_step(name):
    v = initial()
    spec = SCENARIOS[name]
    steps = 9
    model = mt.Model(flows_of(mt, spec))
    ex = mt.SerialExecutor("xla")
    out, _ = model.execute(tspace(v), ex, steps=steps)
    assert ex.last_impl == "point"
    got = out.values["value"].numpy()
    tol = steps * EPS["float64"] * float(np.abs(v).max())
    np.testing.assert_allclose(got, full_grid(model, tspace(v), steps),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(got, oracle_run(v, spec, steps), rtol=0,
                               atol=tol)


def test_shard_point_runner_owns_only_its_cells():
    """Every shard steps the whole table; put together they equal the
    serial runner bit for bit, each shard writing only its cells."""
    v = initial((40, 24))
    spec = SCENARIOS["disjoint"] + [(9, 12, 1.4, 0.1)]  # (9, 12) by a seam
    space = tspace(v)
    plans = tpk.build_point_plans(flows_of(mt, spec), space,
                                  mt.Model.offsets)
    serial = tpk.serial_point_runner(plans, torch.float64)(
        dict(space.values), 6)["value"]
    run = tpk.shard_point_runner(plans, torch.float64, 10, 24)
    x = space.values["value"]
    parts = [run({"value": x[10 * i:10 * (i + 1)].clone()}, 10 * i, 0, 6)
             ["value"] for i in range(4)]
    assert torch.equal(torch.cat(parts), serial)
    dyn = tpk.build_point_plans(flows_of(mt, SCENARIOS["dynamic"]), space,
                                mt.Model.offsets)
    with pytest.raises(ValueError, match="frozen"):
        tpk.shard_point_runner(dyn, torch.float64, 10, 24)


def test_last_impl_equals_jax_serial_and_sharded():
    v = initial((40, 24))
    three = [(5, 5, 2.2, 0.1), (20, 11, 1.7, 0.2), (33, 17, 1.2, 0.1)]
    seventy = [(i % 40, (i * 7) % 24, 1.0 + i / 100, 0.01)
               for i in range(70)]
    for spec, want in ((three, "point"), (seventy, "xla")):
        ex, jex = mt.SerialExecutor("xla"), JSerial("xla")
        out, _ = mt.Model(flows_of(mt, spec)).execute(tspace(v), ex,
                                                      steps=3)
        jout, _ = mm.Model(flows_of(mm, spec)).execute(jspace(v), jex,
                                                       steps=3)
        assert ex.last_impl == jex.last_impl == want
        tol = 3 * EPS["float64"] * float(np.abs(v).max())
        np.testing.assert_allclose(out.values["value"].numpy(),
                                   np.asarray(jout.values["value"]),
                                   rtol=0, atol=tol)
    # sharded, all frozen: the point subsystem, no exchange
    for impl in ("xla", "auto", "active", "active_fused"):
        ex = ShardMapExecutor(make_mesh(4, devices=[CPU] * 4), impl)
        out, rep = mt.Model(flows_of(mt, three)).execute(tspace(v), ex,
                                                         steps=4)
        assert ex.last_impl == rep.impl == "point"
        assert rep.backend_report is None
        serial, _ = mt.Model(flows_of(mt, three)).execute(
            tspace(v), mt.SerialExecutor("xla"), steps=4)
        assert torch.equal(out.values["value"], serial.values["value"])
    jex = JShardMap(jmake_mesh(4, devices=jax.devices("cpu")[:4]), "xla")
    jout, _ = mm.Model(flows_of(mm, three)).execute(jspace(v), jex, steps=4)
    assert jex.last_impl == "point"
    np.testing.assert_array_equal(out.values["value"].numpy(),
                                  np.asarray(jout.values["value"]))
    # a dynamic flow is not shardable as a subsystem: the pad-gather step
    ex = ShardMapExecutor(make_mesh(4, devices=[CPU] * 4), "xla")
    mt.Model(flows_of(mt, SCENARIOS["dynamic"])).execute(tspace(v), ex,
                                                         steps=2)
    assert ex.last_impl == "xla"


@pytest.mark.parametrize("where", ["serial", "2x3"])
@pytest.mark.parametrize("name", ["65_frozen", "diffusion_exponencial"])
def test_point_models_off_the_subsystem_bitwise_oracle(name, where):
    """Models the point subsystem refuses run the full-grid steps and say
    ``"xla"``: serially one ``point_flow_step`` after the field step,
    sharded the point scattered into the owning shard's outflow before the
    share exchange; each bit for bit the oracle with the same rounding
    points. The 65 sources sit 3 apart (no cell neighbours two of them),
    some on the 2x3 mesh's seams and one in a corner."""
    from mpi_model_tpu_torch.parallel import make_mesh_2d

    H, W, steps, rate = 30, 45, 6, 0.1
    rng = np.random.default_rng(8)
    if name == "65_frozen":
        must = [(0, 0), (15, 15), (15, 30)]
        rest = [(x, y) for x in range(0, H, 3) for y in range(0, W, 3)
                if (x, y) not in must]
        picks = must + [rest[k] for k in rng.choice(len(rest), 62,
                                                    replace=False)]
        spec = [(x, y, float(a), rate) for (x, y), a in zip(
            picks, rng.uniform(0.5, 2.0, len(picks)))]
        assert len(spec) == 65
        flows = flows_of(mt, spec)
    else:
        spec = [(14, 16, 2.2, rate)]
        flows = [mt.Diffusion(rate)] + flows_of(mt, spec)
    v = initial((H, W), seed=9)
    ex = (mt.SerialExecutor("xla") if where == "serial" else
          ShardMapExecutor(make_mesh_2d(2, 3, devices=[CPU] * 6), "xla"))
    out, rep = mt.Model(flows).execute(tspace(v), ex, steps=steps)
    assert ex.last_impl == rep.impl == "xla"
    want = v.copy()
    for _ in range(steps):
        if where == "serial":
            if name != "65_frozen":
                want = oracle.dense_flow_step_np(want, rate)
            for x, y, val, r in spec:
                want = oracle.point_flow_step_np(want, x, y, r * val)
        else:
            o = (rate * want if name != "65_frozen"
                 else np.zeros_like(want))
            for x, y, val, r in spec:
                o[x, y] += r * val
            want = oracle.transport_np(want, o)
    np.testing.assert_array_equal(out.values["value"].numpy(), want)


# -- the CLI's scenario flags and --output ---------------------------------------

def _files(d):
    """{dump name or "merged": bytes} of one --output directory."""
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            key = "merged" if name.startswith("output ") else name
            assert key not in out
            out[key] = f.read()
    return out


@pytest.mark.parametrize("extra", [[], ["--mesh=4"], ["--rectangular=2x2"]],
                         ids=["serial", "stripes", "rectangular"])
def test_cli_output_files_byte_for_byte_jax(tmp_path, capsys, extra):
    args = ["run", "--flow=exponencial", "--source=19,3", "--value=2.2",
            "--rate=0.1", "--steps=-1", "--dtype=float64", "--json"] + extra
    d_t, d_j = str(tmp_path / "port"), str(tmp_path / "jax")
    assert tcli.main(args + [f"--output={d_t}", "--device=cpu"]) == 0
    out_t = capsys.readouterr()
    assert jcli.main(args + [f"--output={d_j}"]) == 0
    capsys.readouterr()
    assert "output written to" in out_t.err
    ft, fj = _files(d_t), _files(d_j)
    assert ft.keys() == fj.keys()
    assert "merged" in ft and len(ft) >= 2
    for k in ft:
        assert ft[k] == fj[k], k
    if not extra:
        # the reference run: 50 steps (time 10, step 0.2), the oracle's
        want = oracle.reference_run_np(steps=50)
        lines = ft["merged"].decode().splitlines()
        assert len(lines) == 100 * 100
        x, y, val = lines[19 * 100 + 3].split("\t")
        assert (int(x), int(y)) == (19, 3)
        assert val == "{:.6g}".format(want[19, 3])


def test_cli_scenario_flags(capsys):
    import json

    assert tcli.main(["run", "--flow=exponencial", "--source=5,7",
                      "--value=3.0", "--rate=0.2", "--time=1.0",
                      "--time-step=0.25", "--steps=-1", "--dimx=16",
                      "--dimy=16", "--dtype=float64", "--device=cpu",
                      "--json"]) == 0
    row = json.loads(capsys.readouterr().out)
    assert row["steps"] == 4 and row["impl"] == "point"
    want = np.full((16, 16), 1.0)
    for _ in range(4):
        want = oracle.point_flow_step_np(want, 5, 7, 0.2 * 3.0)
    assert row["final"]["value"] == pytest.approx(float(want.sum()),
                                                  rel=0, abs=1e-12)
    with pytest.raises(SystemExit, match="--steps=-2"):
        tcli.main(["run", "--steps=-2", "--device=cpu"])
    with pytest.raises(SystemExit, match="--output"):
        tcli.main(["run", "--ensemble=2", "--output=x", "--device=cpu"])
    with pytest.raises(SystemExit, match="--source"):
        tcli.main(["run", "--source=5", "--device=cpu"])
