"""The port's Flow IR through every path it has, on the CPU: the serial
impls, the active window path, the ensemble engine and the services, the
sharded executor, checkpoints and supervision, and the CLI's ``--model``.

Each nonlinear library model is held bit for bit across the port's own
engines at f64 (64², 128² with 16² tiles for the active path, 32² on the
meshes): the serial ``xla`` run is the reference every other engine
matches (the JAX comparisons are in ``tests/test_torch_ir.py``). The
chaos rows (``exc``, ``nan``, ``halo``, ``lane_nan``) recover bit for bit
the clean run. Nothing here needs JAX.
"""

import json
import warnings

import numpy as np
import pytest
import torch

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch.cli import main as cli_main
from mpi_model_tpu_torch.ensemble import EnsembleExecutor, EnsembleScheduler
from mpi_model_tpu_torch.ensemble.batch import padding_scenarios, \
    structure_key
from mpi_model_tpu_torch.ir import library
from mpi_model_tpu_torch.ir import lower as tlower
from mpi_model_tpu_torch.parallel import ShardMapExecutor, make_mesh, \
    make_mesh_2d
from mpi_model_tpu_torch.resilience import inject
from mpi_model_tpu_torch.resilience.inject import Fault, FaultPlan

CPU = torch.device("cpu")
NONLINEAR = ("gray_scott", "sir", "predator_prey")


def _same(a, b) -> bool:
    return all(torch.equal(a.values[k], b.values[k]) for k in b.values)


def _mesh(kind: str):
    if kind == "2x2":
        return make_mesh_2d(2, 2, devices=[CPU] * 4)
    return make_mesh(4, devices=[CPU] * 4)


# -- serial ------------------------------------------------------------------------

@pytest.mark.parametrize("impl,kw", [("auto", {}), ("composed", {}),
                                     ("composed", {"substeps": 3}),
                                     ("active", {}), ("xla", {"substeps": 3})])
@pytest.mark.parametrize("name", NONLINEAR)
def test_serial_impls_bitwise(name, impl, kw):
    model, space = library.MODELS[name](64, dtype="float64", device=CPU)
    want, _ = model.execute(space, mt.SerialExecutor("xla"), steps=7)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got, rep = model.execute(space, mt.SerialExecutor(impl, **kw),
                                 steps=7)
    assert _same(got, want)
    assert rep.impl == ("xla" if impl == "auto" else impl)


@pytest.mark.parametrize("name,dtype", [("sir", "float64"),
                                        ("predator_prey", "float64"),
                                        ("sir", "float32")])
def test_active_window_path_skips_tiles_bitwise(name, dtype):
    """128² with 16² tiles: the term-derived predicate keeps the blobs'
    neighbourhoods and skips the rest, bit for bit the dense lowering; the
    run's counters say so."""
    base, space = library.MODELS[name](128, dtype=dtype, device=CPU)
    model = mt.FlowIRModel(base.ir_terms, base.time, base.time_step,
                           active_opts={"tile": (16, 16),
                                        "max_active_frac": 0.9})
    want, _ = model.execute(space, steps=8)
    got, rep = model.execute(space, mt.SerialExecutor("active"), steps=8)
    assert _same(got, want)
    br = rep.backend_report
    assert br["impl"] == "active" and br["tiles"] == 64
    assert br["fallback_steps"] == 0 and br["host_syncs"] == 8
    assert 0.0 < br["mean_active_fraction"] < 0.9


@pytest.mark.parametrize("substeps", [1, 3])
def test_active_run_owns_its_buffers(substeps):
    """An active run scatters into tensors it owns: the input space, and a
    space one run returned and the next run reads, keep their values; two
    chained runs equal one run of their summed steps."""
    base, space = library.sir(128, dtype="float64", device=CPU)
    model = mt.FlowIRModel(base.ir_terms, base.time, base.time_step,
                           active_opts={"tile": (16, 16),
                                        "max_active_frac": 0.9})
    ex = mt.SerialExecutor("active", substeps=substeps)
    before = {k: v.clone() for k, v in space.values.items()}
    mid, _ = model.execute(space, ex, steps=4)
    kept = {k: v.clone() for k, v in mid.values.items()}
    end, rep = model.execute(mid, ex, steps=5)
    assert all(torch.equal(space.values[k], before[k]) for k in before)
    assert all(torch.equal(mid.values[k], kept[k]) for k in kept)
    want, _ = model.execute(space, steps=9)
    assert _same(end, want)
    assert rep.backend_report["fallback_steps"] == 0


def test_weighted_counts_at_indices_match_the_block():
    """``weighted_counts`` at row and column index tensors (the active
    windows' form) equals its block form over the same cells."""
    offs = mt.Model.offsets
    wts = tuple(0.5 + 0.1 * i for i in range(len(offs)))
    stencil = mt.ops.stencil
    block = stencil.weighted_counts((6, 5), offs, wts, (3, 7), (12, 12),
                                    torch.float64)
    rows = (3 + torch.arange(6))[None, :, None]
    cols = (7 + torch.arange(5))[None, None, :]
    at = stencil.weighted_counts((6, 5), offs, wts, global_shape=(12, 12),
                                 dtype=torch.float64, rows=rows, cols=cols)
    assert at.shape == (1, 6, 5) and torch.equal(at[0], block)


def test_active_falls_back_where_every_tile_is_live():
    """Gray-Scott's u ≈ 1 background lights every tile: each step runs the
    dense lowering, as the JAX package's does."""
    base, space = library.gray_scott(64, dtype="float64", device=CPU)
    model = mt.FlowIRModel(base.ir_terms, base.time, base.time_step,
                           active_opts={"tile": (16, 16)})
    want, _ = model.execute(space, steps=5)
    got, rep = model.execute(space, mt.SerialExecutor("active"), steps=5)
    assert _same(got, want)
    assert rep.backend_report["fallback_steps"] == 5
    assert rep.backend_report["mean_active_fraction"] == 1.0


@pytest.mark.parametrize("ctx", ["serial", "active", "sharded"])
def test_weighted_transport_stranded_cells_shed_nothing(ctx):
    """All weight on the north tap strands row 0 (no in-bounds north): it
    sheds nothing, in every context alike, finite and conserving."""
    w = tuple(1.0 if (dx, dy) == (-1, 0) else 0.0
              for dx, dy in mt.Model.offsets)
    m = mt.FlowIRModel([mt.Transport("u", rate=0.2, weights=w)],
                       active_opts={"tile": (4, 4), "max_active_frac": 1.0})
    v = np.zeros((12, 12))
    v[0, 3:9] = 1.0
    v[5:7, 5:7] = 2.0
    space = m.create_space(12, 12, {"u": 0.0}, dtype="float64", device=CPU)
    space = space.with_values({"u": torch.from_numpy(v)})
    want, rep = m.execute(space, steps=3)
    assert torch.isfinite(want.values["u"]).all()
    assert rep.conservation_error() < 1e-12
    # row 0's mass stays put; north of the 2x2 block receives
    assert torch.equal(want.values["u"][0, 3:9], torch.ones(6,
                                                            dtype=torch.float64))
    ex = {"serial": mt.SerialExecutor("xla"),
          "active": mt.SerialExecutor("active"),
          "sharded": ShardMapExecutor(make_mesh(3, devices=[CPU] * 3))}[ctx]
    got, _ = m.execute(space, ex, steps=3)
    assert _same(got, want)


@pytest.mark.parametrize("ctx", ["serial", "active", "ensemble", "sharded"])
def test_time_varying_masked_source_in_every_context(ctx):
    mask = np.zeros((16, 16))
    mask[2:6, 9:13] = 1.0
    m = mt.FlowIRModel([mt.Clock("t"), mt.Transport("u", rate=0.1),
                        mt.Source("u", mt.Chan("t") * mt.Chan("mask"),
                                  rate=0.25, name="pulse")],
                       active_opts={"tile": (4, 4), "max_active_frac": 1.0})
    space = m.create_space(16, 16, {"u": 0.0, "t": 0.0, "mask": 0.0},
                           dtype="float64", device=CPU)
    space = space.with_values({**space.values,
                               "mask": torch.from_numpy(mask)})
    want, _ = m.execute(space, steps=5)
    assert m.budget_totals(want)["pulse"] == 0.25 * 10 * mask.sum()
    if ctx == "ensemble":
        (got, _), = m.execute_many([space], steps=5)
    else:
        ex = {"serial": mt.SerialExecutor("composed", substeps=5),
              "active": mt.SerialExecutor("active"),
              "sharded": ShardMapExecutor(_mesh("2x2"))}[ctx]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            got, _ = m.execute(space, ex, steps=5)
    assert _same(got, want)


# -- ensembles ------------------------------------------------------------------------

@pytest.mark.parametrize("name", NONLINEAR)
def test_ensemble_lanes_bitwise_with_a_padding_lane(name):
    """Three lanes with differing term rates and a zero-rate padding lane
    (the scheduler's pad): each real lane is its serial run bit for bit,
    the pad stays zero and is neither checked nor returned."""
    model, space = library.MODELS[name](32, dtype="float64", device=CPU)
    models = [model.with_rates([r * s for r in model.term_rates()])
              for s in (1.0, 1.1, 0.9)]
    pad_spaces, pad_models = padding_scenarios(model, space, 1)
    assert all(r == 0.0 for r in pad_models[0].term_rates())
    res = mt.run_ensemble(model, [space] * 3 + pad_spaces,
                          models=models + pad_models, steps=8, count=3)
    assert len(res) == 3
    for m, (sp, rep) in zip(models, res):
        want, wrep = m.execute(space, steps=8)
        assert _same(sp, want)
        assert rep.final_total == wrep.final_total
    assert structure_key(models[1], space) == structure_key(model, space)


def test_pad_lane_is_a_no_op():
    model, space = library.gray_scott(16, dtype="float64", device=CPU)
    pad_spaces, pad_models = padding_scenarios(model, space, 1)
    (out, _), = mt.run_ensemble(pad_models[0], pad_spaces,
                                models=pad_models, steps=3)
    assert all(not v.any() for v in out.values.values())


def test_linear_ir_batches_with_the_flow_model():
    m_ir, space = mt.build_model("diffusion", 32, dtype="float64",
                                 device=CPU)
    m_flow = mt.Model(mt.Diffusion(0.1), 10.0, 1.0)
    assert structure_key(m_ir, space) == structure_key(m_flow, space)
    res = mt.run_ensemble(m_flow, [space, space], models=[m_flow, m_ir],
                          steps=6)
    want, _ = m_flow.execute(space, steps=6)
    for sp, _ in res:
        assert _same(sp, want)


@pytest.mark.parametrize("impl", ["pipeline", "active", "active_fused"])
def test_nonlinear_ensemble_refuses_linear_engines(impl):
    model, space = mt.build_model("gray_scott", 32, dtype="float32",
                                  device=CPU)
    with pytest.raises(ValueError):
        model.execute_many([space], executor=EnsembleExecutor(impl),
                           steps=2)


def test_linear_ir_pipeline_is_the_flow_dispatch():
    """The linear IR model through K5's path (its plain version on the
    CPU), lanes and rates as the flow-built dispatch's."""
    m_ir, space = mt.build_model("diffusion", 128, dtype="float32",
                                 device=CPU)
    m_flow = mt.Model(mt.Diffusion(0.1), 10.0, 1.0)
    spaces = [space.with_values({"value": torch.roll(
        space.values["value"], 7 * i, 0)}) for i in range(3)]
    got = [m.execute_many(spaces, executor=EnsembleExecutor(
        "pipeline", substeps=4), steps=8) for m in (m_ir, m_flow)]
    for (a, ra), (b, rb) in zip(*got):
        assert _same(a, b)
        assert ra.backend_report["kernel"] == "K5 pipeline_stencil"


@pytest.mark.parametrize("name", NONLINEAR)
def test_through_async_service(name):
    model, space = library.MODELS[name](16, dtype="float64", device=CPU)
    want, _ = model.execute(space, steps=4)
    svc = mt.AsyncEnsembleService(model, steps=4, buckets=(2,), start=False)
    try:
        tickets = [svc.submit(space) for _ in range(3)]
        got = {}
        for _ in range(10):
            svc.pump_once(force=True)
            for t in tickets:
                if t not in got:
                    r = svc.poll(t)
                    if r is not None:
                        got[t] = r
            if len(got) == 3:
                break
        assert len(got) == 3
        for sp, rep in got.values():
            assert _same(sp, want)
            assert rep.steps == 4
    finally:
        svc.stop()


def test_sync_service_flush_batches_ir_tickets():
    model, space = mt.build_model("predator_prey", 16, dtype="float64",
                                  device=CPU)
    other = model.with_rates([r * 1.2 for r in model.term_rates()])
    svc = mt.EnsembleService(model, steps=3, buckets=mt.buckets_for(4))
    t1 = svc.submit(space)
    t2 = svc.submit(space, model=other)
    svc.flush()
    for t, m in ((t1, model), (t2, other)):
        want, _ = m.execute(space, steps=3)
        assert _same(svc.result(t)[0], want)
    assert svc.stats()["dispatches"] == 1


def test_scheduler_lane_nan_chaos_recovers():
    """A poisoned lane is caught by the per-lane conservation view,
    solo-retried clean, and its batchmate is untouched."""
    model, space = mt.build_model("gray_scott", 16, dtype="float64",
                                  device=CPU)
    want, _ = model.execute(space, steps=4)
    sched = EnsembleScheduler(max_batch=2, retry="solo")
    with inject.armed(FaultPlan((Fault("lane_nan", ticket=0,
                                       once=True),))) as st:
        t1 = sched.submit(space, model, steps=4)
        t2 = sched.submit(space, model, steps=4)
        r1, r2 = sched.poll(t1), sched.poll(t2)
    assert [f["kind"] for f in st.fired] == ["lane_nan"]
    assert sched.stats()["recovered_failures"] == 1
    for sp, _ in (r1, r2):
        assert _same(sp, want)


# -- sharded ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
@pytest.mark.parametrize("name", NONLINEAR)
def test_sharded_bitwise_serial(name, mesh):
    model, space = library.MODELS[name](32, dtype="float64", device=CPU)
    want, _ = model.execute(space, steps=8)
    for impl in ("xla", "auto"):
        out, rep = model.execute(space, ShardMapExecutor(_mesh(mesh), impl),
                                 steps=8)
        assert _same(out, want), impl
        assert rep.comm_size == 4 and rep.impl == "xla"


def test_sharded_runner_cache_keys_on_terms():
    model, space = mt.build_model("gray_scott", 32, dtype="float64",
                                  device=CPU)
    doubled = model.with_rates([r * 2 for r in model.term_rates()])
    ex = ShardMapExecutor(_mesh("4x1"))
    a, _ = model.execute(space, ex, steps=4)
    b, _ = doubled.execute(space, ex, steps=4)
    want_b, _ = doubled.execute(space, steps=4)
    assert not _same(b, a)
    assert _same(b, want_b)


@pytest.mark.parametrize("kw,match", [
    ({"step_impl": "composed"}, "linear-stencil"),
    ({"step_impl": "pallas"}, "linear-stencil"),
    ({"halo_depth": 2}, "halo depth")])
def test_sharded_refusals(kw, match):
    model, space = mt.build_model("gray_scott", 32, dtype="float32",
                                  device=CPU)
    with pytest.raises(ValueError, match=match):
        model.execute(space, ShardMapExecutor(_mesh("4x1"), **kw), steps=2)


def test_sharded_halo_zero_mode_differs_only_at_seams():
    model, space = mt.build_model("sir", 32, dtype="float64", device=CPU)
    want, _ = model.execute(space, steps=2)
    # the diagnostic's rings are zeros: mass leaves at the seams
    got, _ = model.execute(space, ShardMapExecutor(_mesh("4x1"),
                                                   halo_mode="zero"),
                           steps=2, check_conservation=False)
    diff = (got.values["I"] != want.values["I"]).any(dim=1)
    # only rows next to a shard edge (8, 16, 24 ± 2) can differ
    rows = set(torch.nonzero(diff).flatten().tolist())
    assert rows <= {r for e in (8, 16, 24) for r in range(e - 2, e + 2)}


# -- checkpoints and supervision --------------------------------------------------

@pytest.mark.parametrize("layout", ["full", "delta"])
def test_checkpointed_run_resumes_bitwise(tmp_path, layout):
    """A checkpointed run cut after 4 steps and resumed by a fresh manager
    gives the uninterrupted run bit for bit, budget channels included."""
    from mpi_model_tpu_torch.io import CheckpointManager, run_checkpointed

    model, space = mt.build_model("predator_prey", 32, dtype="float64",
                                  device=CPU)
    want, _ = model.execute(space, steps=8)
    kw = dict(layout=layout, device=CPU)
    if layout == "delta":
        kw["keyframe_every"] = 2
    mgr = CheckpointManager(str(tmp_path), **kw)
    run_checkpointed(model, space, mgr, steps=4, every=2)
    ck = CheckpointManager(str(tmp_path), **kw).latest()
    assert ck.step == 4 and "_b_growth" in ck.space.values
    out, step, _ = run_checkpointed(model, space,
                                    CheckpointManager(str(tmp_path), **kw),
                                    steps=8, every=2)
    assert step == 8 and _same(out, want)


@pytest.mark.parametrize("kind", ["exc", "nan"])
def test_supervised_chaos_recovers_bitwise(kind):
    from mpi_model_tpu_torch.resilience import supervised_run

    model, space = mt.build_model("predator_prey", 16, dtype="float64",
                                  device=CPU)
    want, _ = model.execute(space, steps=8)
    kw = {"cell": (3, 4)} if kind == "nan" else {}
    with inject.armed(FaultPlan((Fault(kind, at=1, **kw),))) as st:
        res = supervised_run(model, space, steps=8, every=2,
                             executor=mt.SerialExecutor())
    assert [f["kind"] for f in st.fired] == [kind]
    assert len(res.events) == 1
    assert _same(res.space, want)


def test_supervised_halo_chaos_recovers_bitwise():
    from mpi_model_tpu_torch.resilience import supervised_run

    model, space = mt.build_model("sir", 32, dtype="float64", device=CPU)
    want, _ = model.execute(space, ShardMapExecutor(_mesh("4x1")), steps=8)
    ex = ShardMapExecutor(_mesh("4x1"))
    with inject.armed(FaultPlan((Fault("halo", at=1),), seed=7)) as st:
        res = supervised_run(model, space, steps=8, every=2, executor=ex)
    assert [f["kind"] for f in st.fired] == ["halo"]
    assert len(res.events) == 1
    assert _same(res.space, want)


# -- the CLI ---------------------------------------------------------------------------

def _cli(capsys, *argv):
    rc = cli_main(["run", *argv, "--device=cpu", "--json"])
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("argv", [
    ("--model=gray_scott", "--dimx=24", "--dimy=24", "--dtype=float64",
     "--steps=4"),
    ("--model=predator_prey", "--dimx=16", "--dimy=16", "--steps=3",
     "--impl=active"),
    ("--model=sir", "--dimx=16", "--dimy=16", "--steps=4",
     "--impl=composed", "--substeps=2"),
    ("--model=sir", "--dimx=16", "--dimy=16", "--dtype=float64",
     "--steps=3", "--ensemble=3"),
    ("--model=gray_scott", "--dimx=32", "--dimy=32", "--steps=4",
     "--mesh=2x2"),
    ("--model=gray_scott", "--dimx=32", "--dimy=32", "--steps=6",
     "--chaos=nan:1"),
    ("--model=diffusion", "--dimx=32", "--dimy=32", "--steps=4",
     "--impl=pallas", "--substeps=2"),
    ("--model=sir", "--dimx=16", "--dimy=16", "--steps=4", "--serve",
     "--serve-scenarios=5"),
])
def test_cli_model_rows(capsys, argv, tmp_path):
    rc, row = _cli(capsys, *argv)
    assert rc == 0
    if "--serve" in argv:
        assert row["ledger_complete"] and row["served"] == 5
        return
    assert row["conserved"] is True
    if "--chaos=nan:1" in argv:
        assert row["recovered_failures"] == 1
    if argv[0] == "--model=gray_scott":
        assert "_b_feed" in row["final"]


def test_cli_model_checkpoint_dir(capsys, tmp_path):
    rc, row = _cli(capsys, "--model=sir", "--dimx=16", "--dimy=16",
                   "--steps=4", f"--checkpoint-dir={tmp_path}",
                   "--checkpoint-every=2")
    assert rc == 0 and row["conserved"] and row["checkpoint_steps"] == [
        0, 2, 4]


def test_cli_model_conserved_reads_the_view(capsys):
    """The raw per-channel drift of a model with a source is large; the
    verdict reads the budget-reconciled view."""
    rc, row = _cli(capsys, "--model=gray_scott", "--dimx=24", "--dimy=24",
                   "--dtype=float64", "--steps=4")
    raw = max(abs(row["final"][k] - row["initial"][k])
              for k in row["initial"])
    assert raw > 0.5 and row["conservation_error"] < 1e-9


@pytest.mark.parametrize("argv,match", [
    (("--model=gray_scott", "--flow=diffusion"), "pick one"),
    (("--model=gray_scott", "--impl=active_fused"), "linear-stencil"),
    (("--model=gray_scott", "--impl=pallas"), "linear-stencil"),
    (("--model=sir", "--ensemble=2", "--ensemble-impl=pipeline"),
     "ensemble-impl"),
    (("--model=gray_scott", "--rate=0.5"), "registry"),
    (("--model=gray_scott", "--rectangular=2x2"), "ModelRectangular"),
    (("--model=gray_scott", "--blob=0.1"), "seeded space"),
    (("--model=sir", "--mesh=2x2", "--impl=composed"), "linear-stencil"),
])
def test_cli_model_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        cli_main(["run", *argv, "--device=cpu"])


def test_written_channels_helper_matches_the_terms():
    model, _ = mt.build_model("predator_prey", 8, dtype="float64",
                              device=CPU)
    assert tlower.written_channels(model.ir_terms) == sorted(
        {"x", "y", "_b_growth", "_b_predation", "_b_reproduction",
         "_b_mortality"})
