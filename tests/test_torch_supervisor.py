"""The port's supervisor (``resilience/supervisor.py``) and the executor,
halo and checkpoint seams of ``resilience/inject.py`` on the CPU: the port's
versions of JAX's ``tests/test_resilience.py`` and the executor, seam and
CLI rows of ``tests/test_chaos.py``. JAX's supervised runs fail on the CPU
here (its plain-Diffusion step, ``compat.optimization_barrier``), so every
recovery is held bit for bit to the port's own uninterrupted run and, for
the reference scenario, to ``oracle.reference_run_np`` at f64."""

import json

import numpy as np
import pytest
import torch

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch import oracle
from mpi_model_tpu_torch.io import CheckpointManager, run_checkpointed
from mpi_model_tpu_torch.models.model import kernel_launches
from mpi_model_tpu_torch.parallel import (ShardMapExecutor, make_mesh,
                                          make_mesh_2d)
from mpi_model_tpu_torch.parallel.halo import (exchange_ring,
                                               pad_with_halo_1d,
                                               pad_with_halo_2d,
                                               refresh_rings)
from mpi_model_tpu_torch.resilience import (FailureEvent, SimulationFailure,
                                            SupervisedResult, check_health,
                                            inject, supervised_run)
from mpi_model_tpu_torch.resilience import supervisor as sup
from mpi_model_tpu_torch.resilience.inject import (Fault, FaultPlan,
                                                   InjectedFault)

CPU = torch.device("cpu")
RNG = np.random.default_rng(5)
BASE = RNG.uniform(0.5, 2.0, (16, 16))


def make_space(h=12, w=16, dtype=torch.float64):
    return mt.CellularSpace({"value": torch.from_numpy(
        BASE[:h, :w].copy()).to(dtype)}, h, w)


def make_model(time=8.0):
    return mt.Model(mt.Diffusion(0.1), time=time, time_step=1.0)


def expected(model, space, steps=8, executor=None):
    out, _ = model.execute(space, executor, steps=steps)
    return out.values["value"]


class FaultyExecutor:
    """A SerialExecutor that fails on chosen call indices, by raising or by
    corrupting the returned state."""

    comm_size = 1

    def __init__(self, fail_calls, mode="raise"):
        self.fail_calls = set(fail_calls)
        self.mode = mode
        self.calls = 0
        self._inner = mt.SerialExecutor()

    def run_model(self, model, space, num_steps):
        idx = self.calls
        self.calls += 1
        if idx in self.fail_calls:
            if self.mode == "same":
                raise RuntimeError("poisoned chunk")
            if self.mode == "raise":
                raise RuntimeError(f"injected device fault on call {idx}")
            out = dict(self._inner.run_model(model, space, num_steps))
            if self.mode == "nan":
                out["value"] = out["value"].clone()
                out["value"][1, 1] = float("nan")
                return out
            return {k: v * 0.9 for k, v in out.items()}  # "leak"
        return self._inner.run_model(model, space, num_steps)


# -- check_health --------------------------------------------------------------

def test_check_health_clean():
    space = make_space()
    assert check_health(space) == []
    assert check_health(space, {"value": float(space.total("value"))},
                        threshold=1e-6) == []


@pytest.mark.parametrize("bad", [float("inf"), float("-inf"), float("nan")])
def test_check_health_detects_nonfinite(bad):
    space = make_space()
    v = space.values["value"].clone()
    v[0, 0] = bad
    problems = check_health(space.with_values({"value": v}))
    assert len(problems) == 1 and "non-finite" in problems[0]


def test_check_health_detects_drift():
    space = make_space()
    problems = check_health(space, {"value": float(space.total("value"))
                                    + 1.0}, threshold=0.5)
    assert len(problems) == 1 and "conservation drift" in problems[0]


def test_check_health_skips_channel_without_baseline():
    space = make_space()
    two = space.with_values({**space.values,
                             "extra": torch.ones_like(space.values["value"])})
    assert check_health(two, {"value": float(space.total("value"))},
                        threshold=1e-6) == []


def test_check_health_int_and_bool_channels():
    space = make_space()
    mixed = space.with_values({
        **space.values,
        "count": torch.arange(12 * 16, dtype=torch.int32).reshape(12, 16),
        "mask": torch.ones(12, 16, dtype=torch.bool)})
    init = {k: float(mixed.total(k)) for k in mixed.values}
    assert init["count"] == sum(range(12 * 16)) and init["mask"] == 192.0
    assert check_health(mixed, init, threshold=0.0) == []
    off = dict(init, count=init["count"] + 1)
    assert "'count'" in check_health(mixed, off, threshold=0.5)[0]


def test_check_health_is_one_host_transfer(monkeypatch):
    """Every finite flag and total of every channel reaches the host in ONE
    transfer (``_fetch``); no other read of a tensor happens."""
    space = make_space()
    many = space.with_values({f"c{i}": space.values["value"] + i
                              for i in range(5)})
    fetches = []
    real = sup._fetch
    monkeypatch.setattr(sup, "_fetch",
                        lambda s: fetches.append(len(s)) or real(s))

    def no_read(*a, **k):
        raise AssertionError("a tensor was read outside _fetch")

    for name in ("item", "__bool__", "__float__", "tolist"):
        if name == "tolist":
            continue  # _fetch's own read
        monkeypatch.setattr(torch.Tensor, name, no_read)
    init = {f"c{i}": float(BASE[:12, :16].sum() + 192 * i)
            for i in range(5)}
    before = sup.health_syncs()
    assert check_health(many, init, threshold=1e-6) == []
    assert fetches == [10] and sup.health_syncs() == before + 1


# -- recovery --------------------------------------------------------------------

@pytest.mark.parametrize("mode,kind", [("raise", "exception"),
                                       ("nan", "nonfinite"),
                                       ("leak", "conservation")])
def test_transient_failure_recovers_bit_identical(mode, kind):
    space, model = make_space(), make_model()
    seen = []
    res = supervised_run(model, space, steps=8, every=2,
                         executor=FaultyExecutor({2}, mode),
                         on_event=seen.append)
    assert isinstance(res, SupervisedResult)
    assert res.step == 8 and res.recovered_failures == 1
    assert torch.equal(res.space.values["value"], expected(model, space))
    (ev,) = res.events
    assert seen == [ev] and isinstance(ev, FailureEvent)
    assert ev.kind == kind and ev.rolled_back_to == 4 and ev.attempt == 1
    assert ev.classification == "transient" and ev.step == 6


def test_persistent_failure_raises_with_event_log():
    with pytest.raises(SimulationFailure) as ei:
        supervised_run(make_model(), make_space(), steps=4, every=2,
                       executor=FaultyExecutor(range(100)), max_failures=3)
    assert len(ei.value.events) == 4
    assert all(e.rolled_back_to == 0 for e in ei.value.events)
    assert [e.attempt for e in ei.value.events] == [1, 2, 3, 4]


def test_consecutive_counter_resets_on_success():
    space, model = make_space(), make_model()
    res = supervised_run(model, space, steps=4, every=2,
                         executor=FaultyExecutor({0, 1, 3, 4}),
                         max_failures=2)
    assert res.step == 4 and res.recovered_failures == 4
    assert torch.equal(res.space.values["value"],
                       expected(model, space, steps=4))


def test_durable_recovery_resumes_across_restart(tmp_path):
    space, model = make_space(), make_model()
    mgr = CheckpointManager(str(tmp_path), keep=2, device="cpu")
    with pytest.raises(SimulationFailure):
        supervised_run(model, space, mgr, steps=8, every=2,
                       executor=FaultyExecutor({2, 3, 4, 5, 6}),
                       max_failures=2)
    res = supervised_run(model, make_space(), mgr, steps=8, every=2,
                         executor=mt.SerialExecutor())
    assert res.step == 8
    assert torch.equal(res.space.values["value"], expected(model, space))


def test_supervised_run_validates_args():
    with pytest.raises(ValueError, match="every"):
        supervised_run(make_model(), make_space(), steps=4, every=0)


def test_clean_run_has_no_events_and_matches_plain_execute():
    space, model = make_space(), make_model()
    res = supervised_run(model, space, steps=8, every=3)
    assert res.events == []
    assert torch.equal(res.space.values["value"], expected(model, space))
    assert res.report is not None and res.report.steps == 2


def test_run_checkpointed_surfaces_original_exception(tmp_path):
    with pytest.raises(RuntimeError, match="injected device fault"):
        run_checkpointed(make_model(), make_space(),
                         CheckpointManager(str(tmp_path), device="cpu"),
                         steps=4, every=2, executor=FaultyExecutor({0}))


def test_max_failures_zero_matches_run_checkpointed(tmp_path):
    space, model = make_space(), make_model()
    res = supervised_run(model, space, CheckpointManager(
        str(tmp_path / "a"), keep=10, device="cpu"), steps=8, every=3,
        max_failures=0, executor=mt.SerialExecutor())
    out, step, _ = run_checkpointed(model, make_space(), CheckpointManager(
        str(tmp_path / "b"), keep=10, device="cpu"), steps=8, every=3,
        executor=mt.SerialExecutor())
    assert res.step == step == 8
    assert torch.equal(res.space.values["value"], out.values["value"])
    assert (CheckpointManager(str(tmp_path / "a")).steps()
            == CheckpointManager(str(tmp_path / "b")).steps())
    plan = FaultPlan((Fault("exc", at=0),))
    with inject.armed(plan):
        with pytest.raises(SimulationFailure) as ei:
            supervised_run(model, make_space(), steps=4, every=2,
                           max_failures=0, executor=mt.SerialExecutor())
    assert isinstance(ei.value.__cause__, InjectedFault)
    with inject.armed(plan):
        with pytest.raises(InjectedFault):
            run_checkpointed(model, make_space(), CheckpointManager(
                str(tmp_path / "c"), device="cpu"), steps=4, every=2,
                executor=mt.SerialExecutor())


# -- the fault plan --------------------------------------------------------------

def test_fault_plan_is_pure_data_and_seeded():
    plan = FaultPlan((Fault("exc", at=2), Fault("halo")), seed=9)
    with pytest.raises(Exception):
        plan.faults[0].at = 3
    assert plan.value_for(1) == FaultPlan(plan.faults, seed=9).value_for(1)
    assert plan.value_for(1) != FaultPlan(plan.faults, seed=10).value_for(1)


def test_unknown_fault_kind_rejected():
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault("meteor")
    with pytest.raises(ValueError, match="tear mode"):
        Fault("torn", tear="gnaw")


def test_armed_is_exclusive_and_clears():
    plan = FaultPlan((Fault("exc"),))
    with inject.armed(plan):
        assert inject.active() is not None
        with pytest.raises(RuntimeError, match="already armed"):
            with inject.armed(plan):
                pass
    assert inject.active() is None


# -- executor faults heal bit for bit ----------------------------------------------

EXECUTORS = {
    "serial xla": lambda: mt.SerialExecutor(),
    "serial pallas": lambda: mt.SerialExecutor("pallas", substeps=2),
    "serial active": lambda: mt.SerialExecutor(
        "active", active_opts={"tile": (4, 4)}),
    "sharded xla 1d4": lambda: ShardMapExecutor(
        make_mesh(4, devices=[CPU] * 4)),
    "sharded pallas 2x2": lambda: ShardMapExecutor(
        make_mesh_2d(2, 2, devices=[CPU] * 4), "pallas", halo_depth=2),
}


def _space_for(name):
    dtype = torch.float32 if "pallas" in name else torch.float64
    return make_space(16, 16, dtype)


@pytest.mark.parametrize("name", list(EXECUTORS))
@pytest.mark.parametrize("kind,want_kind", [("exc", "exception"),
                                            ("nan", "nonfinite")])
def test_injected_executor_fault_recovers_bitwise(name, kind, want_kind):
    space, model = _space_for(name), make_model()
    want = expected(model, space, executor=EXECUTORS[name]())
    plan = FaultPlan((Fault(kind, at=1, cell=(3, 4)),))
    with inject.armed(plan) as st:
        res = supervised_run(model, space, steps=8, every=2,
                             executor=EXECUTORS[name]())
    assert [f["kind"] for f in st.fired] == [kind]
    (ev,) = res.events
    assert ev.kind == want_kind and ev.classification == "transient"
    if kind == "exc":
        assert "InjectedFault" in ev.detail and "call 1" in ev.detail
    assert torch.equal(res.space.values["value"], want)


def test_nan_fault_clears_the_dirty_tile_export():
    ex = EXECUTORS["serial active"]()
    space = make_space(16, 16)
    with inject.armed(FaultPlan((Fault("nan", at=0),))):
        out = ex.run_model(make_model(), space, 2)
    assert ex.last_dirty_tiles is None
    assert torch.isnan(out["value"][0, 0])
    assert not torch.isnan(space.values["value"]).any()  # the input is kept


@pytest.mark.parametrize("name", ["sharded xla 1d4", "sharded pallas 2x2"])
def test_halo_perturbation_detected_and_recovered_bitwise(name):
    """A perturbed ghost payload manufactures mass: the in-band
    conservation check is the detector."""
    space, model = _space_for(name), make_model()
    want = expected(model, space, executor=EXECUTORS[name]())
    plan = FaultPlan((Fault("halo", at=1),), seed=7)
    with inject.armed(plan) as st:
        res = supervised_run(model, space, steps=8, every=2,
                             executor=EXECUTORS[name]())
    assert [f["kind"] for f in st.fired] == ["halo"]
    (ev,) = res.events
    assert ev.kind == "conservation" and ev.rolled_back_to == 2
    assert torch.equal(res.space.values["value"], want)


def test_halo_fault_is_ignored_by_the_serial_executor():
    space, model = make_space(), make_model()
    with inject.armed(FaultPlan((Fault("halo", at=0),))) as st:
        res = supervised_run(model, space, steps=4, every=2)
    assert st.fired == [] and res.events == []


# -- transient against deterministic, backoff ----------------------------------------

def test_deterministic_fault_fails_fast():
    ex = FaultyExecutor(range(100), "same")
    with pytest.raises(SimulationFailure, match="deterministic"):
        supervised_run(make_model(), make_space(), steps=8, every=2,
                       executor=ex, max_failures=5)
    assert ex.calls == 2


def test_deterministic_fail_fast_can_be_disabled():
    with pytest.raises(SimulationFailure) as ei:
        supervised_run(make_model(), make_space(), steps=8, every=2,
                       executor=FaultyExecutor(range(100), "same"),
                       max_failures=3, fail_fast_deterministic=False)
    assert len(ei.value.events) == 4


def test_varying_details_stay_transient():
    space, model = make_space(), make_model()
    plan = FaultPlan((Fault("exc", at=0), Fault("exc", at=1)))
    with inject.armed(plan):
        res = supervised_run(model, space, steps=4, every=2,
                             executor=mt.SerialExecutor(), max_failures=3)
    assert [e.classification for e in res.events] == ["transient"] * 2
    assert torch.equal(res.space.values["value"],
                       expected(model, space, steps=4))


def test_backoff_is_jittered_and_reproducible():
    def run(seed):
        plan = FaultPlan((Fault("exc", at=0), Fault("exc", at=2)))
        with inject.armed(plan):
            return supervised_run(make_model(), make_space(), steps=8,
                                  every=2, executor=mt.SerialExecutor(),
                                  retry_backoff_s=1e-4, backoff_jitter=0.5,
                                  backoff_seed=seed)

    a, b, c = run(13), run(13), run(14)
    assert all(e.backoff_s > 0.0 for e in a.events)
    assert [e.backoff_s for e in a.events] == [e.backoff_s for e in b.events]
    assert [e.backoff_s for e in a.events] != [e.backoff_s for e in c.events]


# -- held to the oracle ---------------------------------------------------------------

@pytest.mark.parametrize("faults", [
    (Fault("exc", at=3),),
    (Fault("nan", at=1, cell=(19, 3)), Fault("exc", at=6)),
])
def test_supervised_reference_scenario_is_the_oracle(tmp_path, faults):
    """The reference's 100×100 ``Exponencial`` scenario, 50 steps in chunks
    of 7 under the supervisor with faults armed and checkpoints on disk:
    bit for bit ``oracle.reference_run_np`` at f64."""
    space = mt.CellularSpace.create(100, 100, 1.0, dtype="float64",
                                    device="cpu")
    model = mt.Model(mt.Exponencial(mt.Cell(19, 3, mt.Attribute(99, 2.2)),
                                    0.1), 10.0, 0.2)
    with inject.armed(FaultPlan(faults)):
        res = supervised_run(model, space, CheckpointManager(
            str(tmp_path), device="cpu"), every=7,
            executor=mt.SerialExecutor())
    assert res.step == 50 and len(res.events) == len(faults)
    np.testing.assert_array_equal(res.space.values["value"].numpy(),
                                  oracle.reference_run_np(steps=50))


# -- unarmed seams cost nothing ------------------------------------------------------

def _grid(lines, columns):
    return [[torch.from_numpy(RNG.uniform(0.5, 2.0, (8, 8)))
             for _ in range(columns)] for _ in range(lines)]


@pytest.mark.parametrize("plan", [None, FaultPlan((Fault("torn", at=0),)),
                                  FaultPlan((Fault("halo", at=5),))])
def test_unarmed_halo_seam_leaves_the_rings_unchanged(plan):
    grid = _grid(2, 2)
    clean = {(i, j): exchange_ring(grid, i, j, 2) for i in range(2)
             for j in range(2)}
    clean_pad = pad_with_halo_2d(grid, 1, 1, 2)
    stripes = _grid(3, 1)
    clean_1d = pad_with_halo_1d(stripes, 1, 2)
    ctx = inject.armed(plan) if plan is not None else None
    if ctx is not None:
        ctx.__enter__()
    try:
        for (i, j), ring in clean.items():
            got = exchange_ring(grid, i, j, 2)
            assert all(torch.equal(got[k], ring[k]) for k in ring)
        assert torch.equal(pad_with_halo_2d(grid, 1, 1, 2), clean_pad)
        assert torch.equal(pad_with_halo_1d(stripes, 1, 2), clean_1d)
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)


def test_armed_halo_window_perturbs_the_received_top_rows():
    grid = _grid(2, 2)
    padded = [[torch.nn.functional.pad(t, (1, 1, 1, 1)) for t in row]
              for row in grid]
    refresh_rings(padded)
    clean_padded = [[p.clone() for p in row] for row in padded]
    clean = exchange_ring(grid, 1, 0, 2)
    plan = FaultPlan((Fault("halo", value=0.5),))
    with inject.armed(plan) as st:
        with st.halo_window(plan.faults[0]):
            got = exchange_ring(grid, 1, 0, 2)
            refresh_rings(padded)
    for k in clean:
        want = clean[k] + 0.5 if k in ("n", "nw", "ne") else clean[k]
        assert torch.equal(got[k], want), k
    # the neighbour's shard (which "n" views) is untouched
    assert torch.equal(grid[0][0], _grid_copy(grid)[0][0])
    assert torch.equal(padded[1][0][0], clean_padded[1][0][0] + 0.5)
    assert torch.equal(padded[0][0], clean_padded[0][0])


def _grid_copy(grid):
    return [[t.clone() for t in row] for row in grid]


@pytest.mark.parametrize("name", list(EXECUTORS))
def test_seams_leave_results_and_launch_counts_unchanged(name):
    """With a plan armed for other seams (and with none), each executor's
    result and the kernels' launch counts are those of a clean run."""
    space, model = _space_for(name), make_model()
    before = kernel_launches()
    want = expected(model, space, executor=EXECUTORS[name]())
    clean_launches = kernel_launches()
    plan = FaultPlan((Fault("torn", at=0), Fault("lane_nan", lane=3),
                      Fault("exc", at=99)))
    with inject.armed(plan) as st:
        got = expected(model, space, executor=EXECUTORS[name]())
    assert st.fired == []
    assert torch.equal(got, want)
    assert kernel_launches() == clean_launches == before


# -- the CLI's chaos surface --------------------------------------------------------

def _cli(argv):
    from mpi_model_tpu_torch.cli import main

    return main(["run", "--device=cpu"] + argv)


@pytest.mark.parametrize("spec,kind", [("nan:1", "nonfinite"),
                                       ("exc:2", "exception")])
def test_cli_chaos_run_recovers(capsys, spec, kind):
    rc = _cli(["--flow=diffusion", "--dimx=12", "--dimy=12", "--steps=4",
               "--impl=xla", f"--chaos={spec}", "--json"])
    row = json.loads(capsys.readouterr().out)
    assert rc == 0 and row["conserved"] is True
    assert row["injected_faults"] == 1 and row["recovered_failures"] == 1
    assert [e["kind"] for e in row["events"]] == [kind]


def test_cli_sharded_halo_chaos_recovers(capsys):
    rc = _cli(["--flow=diffusion", "--dimx=16", "--dimy=16", "--steps=4",
               "--mesh=2x2", "--impl=xla", "--chaos=halo:1",
               "--checkpoint-every=2", "--json"])
    row = json.loads(capsys.readouterr().out)
    assert rc == 0 and row["backend"] == "sharded"
    assert [e["kind"] for e in row["events"]] == ["conservation"]


@pytest.mark.parametrize("spec,at", [("torn", 8), ("torn-delta", 6),
                                     ("torn-keyframe", 8), ("torn-chain", 8)])
def test_cli_torn_chaos_fires_and_the_run_completes(tmp_path, capsys, spec,
                                                    at):
    """1024² (64 tiles of 128²) at 0.01: the chain is kf0 d2 d4 d6 kf8."""
    rc = _cli(["--flow=diffusion", "--dimx=1024", "--dimy=1024", "--steps=8",
               "--impl=active", "--blob=0.01", f"--checkpoint-dir={tmp_path}",
               "--checkpoint-every=2", "--checkpoint-layout=delta",
               "--keyframe-every=4", f"--chaos={spec}:{at}", "--json"])
    row = json.loads(capsys.readouterr().out)
    assert rc == 0 and row["injected_faults"] == 1 and row["conserved"]


@pytest.mark.parametrize("argv,msg", [
    (["--chaos=halo"], "halo"),
    (["--chaos=torn:2"], "checkpoint-dir"),
    (["--chaos=meteor"], "unknown kind"),
    (["--chaos=exc:x"], "not an integer"),
    (["--ensemble=2", "--chaos=nan"], "ensemble"),
    (["--serve", "--chaos=nan"], "serve-mode chaos"),
    (["--checkpoint-dir=X", "--chaos=torn-delta"],
     "--checkpoint-layout=delta"),
])
def test_cli_chaos_validates_flags(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        _cli(argv)


def test_cli_failed_supervised_run_reports(capsys):
    rc = _cli(["--flow=diffusion", "--dimx=12", "--dimy=12", "--steps=4",
               "--impl=xla", "--chaos=exc:0", "--max-failures=0", "--json"])
    row = json.loads(capsys.readouterr().out)
    assert rc == 1 and row["conserved"] is False
    assert "InjectedFault" in row["error"] and row["injected_faults"] == 1
