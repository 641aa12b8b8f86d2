"""The port's ensemble serving path (``ensemble/``, ``Model.execute_many``,
the CLI's ``--ensemble``) on the CPU, against the port's own serial runs,
the oracle and the JAX package's ensemble entry points, at the sizes of
``tests/test_ensemble.py`` (16², 24², 32², 16×128).

- ``impl="xla"`` lanes are bit for bit the port's ``SerialExecutor("xla")``
  runs at f64 (values, report totals and ``last_execute``) and
  ``oracle.dense_flow_step_np`` applied step by step; against JAX's
  ``run_ensemble`` they are held within ``2·eps·steps·max|v|`` (XLA on the
  CPU contracts multiply-adds, ROADMAP Queue 3).
- ``impl="pipeline"`` (K5's plain version on the CPU) is held to the ``xla``
  impl at f32 within ``1e-5``, as the JAX package's tests hold it.
- The scheduler, service and CLI are held to the JAX package's contracts
  (padding, cache hits, flush order on a fake clock, marked lanes; every
  ``degrade_after`` injected faults take the degradation ladder's rung,
  ``pipeline`` → ``xla``, while a kernel's own error reaches its tickets
  and steps no rung), with no wall clock read.
"""

import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mpi_model_tpu as mm
from mpi_model_tpu.ensemble.batch import run_ensemble as jax_run_ensemble
from mpi_model_tpu.ensemble.scheduler import EnsembleScheduler as JScheduler
from mpi_model_tpu.oracle import dense_flow_step_np
from mpi_model_tpu.resilience import FailureEvent as JFailureEvent
from mpi_model_tpu.utils.metrics import ThroughputCounter as JCounter

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch import interop
from mpi_model_tpu_torch.cli import main as cli_main
from mpi_model_tpu_torch.ensemble.batch import (
    check_batch_conserved, complete_ensemble, conservation_violations,
    launch_ensemble, padding_scenarios, structure_key)
from mpi_model_tpu_torch.ops import KernelError
from mpi_model_tpu_torch.resilience import FailureEvent, inject
from mpi_model_tpu_torch.resilience.inject import Fault, FaultPlan
from mpi_model_tpu_torch.utils.metrics import ThroughputCounter

EPS64 = 2.0 ** -52


def _space(v, dtype="float64", **chans):
    sp = mt.CellularSpace.create(v.shape[0], v.shape[1], 1.0, dtype=dtype,
                                 device="cpu")
    vals = {"value": torch.from_numpy(np.asarray(v)).to(sp.dtype)}
    vals.update(chans)
    return sp.with_values(vals)


def make_scenarios(B=3, g=16, dtype="float64", seed=0, base_rate=0.05):
    rng = np.random.default_rng(seed)
    spaces, models, raw = [], [], []
    for i in range(B):
        v = rng.uniform(0.5, 2.0, (g, g))
        raw.append(v)
        spaces.append(_space(v, dtype))
        models.append(mt.Model(mt.Diffusion(base_rate + 0.03 * i), 1.0, 1.0))
    return spaces, models, raw


def _serial(model, space, steps, impl="xla"):
    return model.execute(space, mt.SerialExecutor(step_impl=impl),
                         steps=steps)


# -- EnsembleSpace -----------------------------------------------------------

def test_stack_scenario_roundtrip():
    spaces, _, _ = make_scenarios()
    es = mt.EnsembleSpace.stack(spaces)
    assert es.batch == 3 and es.shape == (16, 16)
    assert es.dtype == torch.float64 and es.device.type == "cpu"
    for i, s in enumerate(spaces):
        got = es.scenario(i)
        assert got.shape == s.shape
        assert torch.equal(got.values["value"], s.values["value"])
    assert len(es.unstack()) == 3
    with pytest.raises(IndexError):
        es.scenario(3)
    # stacking copies: the lanes never alias the scenarios' tensors
    assert es.values["value"].data_ptr() != spaces[0].values["value"] \
        .data_ptr()


def test_stack_rejects_mismatches_like_jax():
    spaces, _, _ = make_scenarios()
    jspaces = [mm.CellularSpace.create(16, 16, 1.0, dtype=jnp.float64)]
    cases = [
        ([], []),
        ([spaces[0], mt.CellularSpace.create(8, 8, 1.0, dtype="float64",
                                             device="cpu")],
         [jspaces[0], mm.CellularSpace.create(8, 8, 1.0,
                                              dtype=jnp.float64)]),
        ([spaces[0], mt.CellularSpace.create(16, 16, 1.0, dtype="float32",
                                             device="cpu")],
         [jspaces[0], mm.CellularSpace.create(16, 16, 1.0,
                                              dtype=jnp.float32)]),
        ([dataclasses.replace(spaces[0], x_init=16, global_dim_x=32,
                              global_dim_y=16)],
         [dataclasses.replace(jspaces[0], x_init=16, global_dim_x=32,
                              global_dim_y=16)]),
    ]
    for tcase, jcase in cases:
        with pytest.raises(ValueError) as t_exc:
            mt.EnsembleSpace.stack(tcase)
        with pytest.raises(ValueError) as j_exc:
            mm.EnsembleSpace.stack(jcase)
        assert str(t_exc.value) == str(j_exc.value)


def test_interop_stacks_as_jax_stacks():
    rng = np.random.default_rng(4)
    vals = [{"value": rng.uniform(0.5, 2.0, (16, 24))} for _ in range(3)]
    specs = [[{"type": "Diffusion", "flow_rate": 0.05 + 0.01 * i}]
             for i in range(3)]
    es, models = interop.ensemble_from_numpy(vals, specs, device="cpu")
    jes = mm.EnsembleSpace.stack([
        mm.CellularSpace.create(16, 24, 1.0, dtype=jnp.float64).with_values(
            {"value": jnp.asarray(v["value"])}) for v in vals])
    np.testing.assert_array_equal(es.values["value"].numpy(),
                                  np.asarray(jes.values["value"]))
    assert [m.flows[0].flow_rate for m in models] == [
        s[0]["flow_rate"] for s in specs]
    with pytest.raises(ValueError, match="lanes"):
        interop.ensemble_from_numpy(vals, specs[:2], device="cpu")


# -- batched-vs-serial parity ------------------------------------------------

@pytest.mark.parametrize("substeps,steps", [(1, 5), (3, 7)])
def test_xla_lanes_bitwise_serial_and_oracle(substeps, steps):
    spaces, models, raw = make_scenarios(B=3)
    out = models[0].execute_many(
        spaces, models=models, steps=steps,
        executor=mt.EnsembleExecutor(substeps=substeps))
    assert len(out) == 3
    for i, (sp, rep) in enumerate(out):
        want, wrep = _serial(models[i], spaces[i], steps)
        assert torch.equal(sp.values["value"], want.values["value"])
        assert rep.initial_total == wrep.initial_total
        assert rep.final_total == wrep.final_total
        assert rep.last_execute == wrep.last_execute
        assert rep.steps == steps and rep.impl == "xla"
        ref = raw[i]
        for _ in range(steps):
            ref = dense_flow_step_np(ref, models[i].flows[0].flow_rate)
        np.testing.assert_array_equal(sp.values["value"].numpy(), ref)


def test_xla_lanes_match_jax_run_ensemble():
    spaces, models, raw = make_scenarios(B=3)
    steps = 7
    out = models[0].execute_many(spaces, models=models, steps=steps,
                                 executor=mt.EnsembleExecutor(substeps=3))
    jspaces = [mm.CellularSpace.create(16, 16, 1.0, dtype=jnp.float64)
               .with_values({"value": jnp.asarray(v)}) for v in raw]
    jmodels = [mm.Model(mm.Diffusion(m.flows[0].flow_rate), 1.0, 1.0)
               for m in models]
    jout = jax_run_ensemble(jmodels[0], jspaces, models=jmodels, steps=steps,
                            executor=mm.EnsembleExecutor(substeps=3))
    for (sp, rep), (jsp, jrep) in zip(out, jout):
        got = sp.values["value"].numpy()
        want = np.asarray(jsp.values["value"])
        tol = 2 * EPS64 * steps * float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= tol
        assert rep.final_total["value"] == pytest.approx(
            jrep.final_total["value"], abs=1e-9)
        assert rep.last_execute == pytest.approx(jrep.last_execute,
                                                 abs=1e-12)


def test_point_flows_match_serial_and_jax():
    spaces, models, jspaces, jmodels = [], [], [], []
    rng = np.random.default_rng(3)
    for i in range(3):
        v = rng.uniform(0.5, 2.0, (24, 24))
        spaces.append(_space(v))
        jspaces.append(mm.CellularSpace.create(24, 24, 1.0, dtype=jnp.float64)
                       .with_values({"value": jnp.asarray(v)}))
        models.append(mt.Model([
            mt.Exponencial(mt.Cell(5, 7, mt.Attribute(99, 2.0 + i)),
                           0.1 * (i + 1)),
            mt.PointFlow(source=(0, 23), flow_rate=0.05 * (i + 1))],
            10.0, 1.0))
        jmodels.append(mm.Model([
            mm.Exponencial(mm.Cell(5, 7, mm.Attribute(99, 2.0 + i)),
                           0.1 * (i + 1)),
            mm.PointFlow(source=(0, 23), flow_rate=0.05 * (i + 1))],
            10.0, 1.0))
    out = models[0].execute_many(spaces, models=models, steps=4)
    jout = jax_run_ensemble(jmodels[0], jspaces, models=jmodels, steps=4)
    for i, ((sp, rep), (jsp, jrep)) in enumerate(zip(out, jout)):
        want, wrep = _serial(models[i], spaces[i], 4)
        assert torch.equal(sp.values["value"], want.values["value"])
        assert rep.last_execute == wrep.last_execute
        np.testing.assert_allclose(sp.values["value"].numpy(),
                                   np.asarray(jsp.values["value"]),
                                   rtol=0, atol=1e-12)
        assert rep.last_execute == pytest.approx(jrep.last_execute)


def test_diffusion_and_coupled_match_jax():
    """``[Diffusion, Coupled]`` on two channels: the batched summed-outflow
    step against JAX's ``run_ensemble`` and the port's serial runs."""
    rng = np.random.default_rng(6)
    spaces, models, jspaces, jmodels = [], [], [], []
    for i in range(2):
        a, b = rng.uniform(0.5, 2.0, (16, 16)), rng.uniform(0.5, 2.0, (16, 16))
        spaces.append(mt.CellularSpace.create(
            16, 16, {"a": 1.0, "b": 1.0}, dtype="float64",
            device="cpu").with_values({"a": torch.from_numpy(a),
                                       "b": torch.from_numpy(b)}))
        jspaces.append(mm.CellularSpace.create(
            16, 16, {"a": 1.0, "b": 1.0}, dtype=jnp.float64).with_values(
                {"a": jnp.asarray(a), "b": jnp.asarray(b)}))
        r1, r2 = 0.05 + 0.02 * i, 0.03 + 0.01 * i
        models.append(mt.Model([mt.Diffusion(r1, "a"),
                                mt.Coupled(r2, "a", "b")]))
        jmodels.append(mm.Model([mm.Diffusion(r1, "a"),
                                 mm.Coupled(r2, "a", "b")]))
    out = models[0].execute_many(spaces, models=models, steps=5)
    jout = jax_run_ensemble(jmodels[0], jspaces, models=jmodels, steps=5)
    for i, ((sp, rep), (jsp, _)) in enumerate(zip(out, jout)):
        want, wrep = _serial(models[i], spaces[i], 5)
        for n in ("a", "b"):
            assert torch.equal(sp.values[n], want.values[n])
            got, jw = sp.values[n].numpy(), np.asarray(jsp.values[n])
            assert float(np.abs(got - jw).max()) <= \
                2 * EPS64 * 5 * float(np.abs(jw).max())
        assert rep.final_total == wrep.final_total


def test_mixed_flows_and_substeps_bitwise_serial():
    rng = np.random.default_rng(1)
    spaces, models = [], []
    for i in range(2):
        spaces.append(_space(rng.uniform(0.5, 2.0, (16, 16))))
        models.append(mt.Model(
            [mt.Diffusion(0.02 * (i + 1)),
             mt.PointFlow(source=(3, 3), flow_rate=0.1 + 0.1 * i)],
            1.0, 1.0))
    # substeps=3 with steps=7: 2 fused calls + 1 remainder single step
    out = models[0].execute_many(spaces, models=models, steps=7,
                                 executor=mt.EnsembleExecutor(substeps=3))
    for i, (sp, _) in enumerate(out):
        want, _ = _serial(models[i], spaces[i], 7)
        assert torch.equal(sp.values["value"], want.values["value"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_low_precision_lanes_bitwise_serial(dtype):
    """A lane's rate enters as the serial Python float does: rounded once to
    the channel dtype (never an f64 product against an f32 grid)."""
    spaces, models, _ = make_scenarios(B=3, dtype=dtype, base_rate=0.1)
    out = models[0].execute_many(spaces, models=models, steps=4)
    for i, (sp, rep) in enumerate(out):
        want, wrep = _serial(models[i], spaces[i], 4)
        assert sp.values["value"].dtype == getattr(torch, dtype)
        assert torch.equal(sp.values["value"], want.values["value"])
        assert rep.final_total == wrep.final_total


def test_int_channel_totals_exact():
    rng = np.random.default_rng(7)
    spaces, models = [], []
    for i in range(2):
        age = rng.integers(0, 2 ** 28, (64, 64), dtype=np.int32)
        sp = mt.CellularSpace.create(
            64, 64, {"value": 1.0, "age": (0, "int32")}, dtype="float64",
            device="cpu").with_values(
                {"value": torch.from_numpy(rng.uniform(0.5, 2.0, (64, 64))),
                 "age": torch.from_numpy(age)})
        spaces.append(sp)
        models.append(mt.Model(mt.Diffusion(0.05 + 0.02 * i), 1.0, 1.0))
    out = models[0].execute_many(spaces, models=models, steps=3)
    for i, (sp, rep) in enumerate(out):
        _, wrep = _serial(models[i], spaces[i], 3)
        exact = float(spaces[i].values["age"].numpy().astype(np.int64).sum())
        assert rep.initial_total["age"] == exact == rep.final_total["age"]
        assert rep.initial_total["age"] == wrep.initial_total["age"]
        assert sp.values["age"].dtype == torch.int32


def test_structure_mismatch_is_rejected():
    spaces, models, _ = make_scenarios(B=2)
    other = mt.Model(mt.Exponencial(mt.Cell(3, 3, mt.Attribute(99, 2.2)),
                                    0.1), 1.0, 1.0)
    with pytest.raises(ValueError, match="not batch-compatible"):
        models[0].execute_many(spaces, models=[models[0], other], steps=2)
    a = mt.Model(mt.Exponencial(mt.Cell(3, 3, mt.Attribute(99, 2.2)), 0.1))
    b = mt.Model(mt.Exponencial(mt.Cell(4, 4, mt.Attribute(99, 2.2)), 0.1))
    assert structure_key(a, spaces[0]) != structure_key(b, spaces[0])
    c = mt.Model(mt.Exponencial(mt.Cell(3, 3, mt.Attribute(99, 9.9)), 0.7))
    assert structure_key(a, spaces[0]) == structure_key(c, spaces[0])


def test_conservation_violation_names_the_scenario():
    initial = {"value": np.array([10.0, 10.0, 10.0])}
    final = {"value": np.array([10.0, 10.5, 10.0])}
    th = np.full(3, 1e-3)
    with pytest.raises(mt.EnsembleConservationError,
                       match="scenario 1") as ei:
        check_batch_conserved(initial, final, th, 3)
    assert ei.value.scenario == 1
    assert check_batch_conserved(initial, final, th, 1)[0] == 0.0
    assert conservation_violations(initial, final, th, 3)[1] == [1]
    # NaN is always a violation
    final["value"][2] = np.nan
    assert conservation_violations(initial, final, th, 3)[1] == [1, 2]


def test_padding_scenarios_contribute_zero():
    spaces, models, _ = make_scenarios(B=1)
    pspaces, pmodels = padding_scenarios(models[0], spaces[0], 2)
    assert len(pspaces) == len(pmodels) == 2
    assert float(pspaces[0].total("value")) == 0.0
    assert pmodels[0].flows[0].flow_rate == 0.0
    assert structure_key(pmodels[0], pspaces[0]) == structure_key(
        models[0], spaces[0])
    out = models[0].execute_many(spaces + pspaces, models=models + pmodels,
                                 steps=3)
    want, _ = _serial(models[0], spaces[0], 3)
    assert torch.equal(out[0][0].values["value"], want.values["value"])
    assert float(out[1][0].values["value"].abs().max()) == 0.0


def test_launch_then_complete_is_run_ensemble():
    spaces, models, _ = make_scenarios(B=2)
    ex = mt.EnsembleExecutor()
    fl = launch_ensemble(models[0], spaces, models=models, executor=ex,
                         steps=3)
    assert fl.count == 2 and fl.num_steps == 3 and fl.t_launched >= fl.t0
    assert fl.launches["pipeline_stencil"] == 0
    got = complete_ensemble(fl)
    again = mt.run_ensemble(models[0], spaces, models=models, executor=ex,
                            steps=3)
    for (a, _), (b, _) in zip(got, again):
        assert torch.equal(a.values["value"], b.values["value"])
    assert ex.builds == 1 and ex.cache_hits == 1
    with pytest.raises(ValueError, match="on_violation"):
        complete_ensemble(fl, on_violation="ignore")


def test_reports_with_an_int_channel_match_serial():
    """With an int bystander channel listed first, each lane's report keeps
    the space's channel order and the serial run's totals and outflow sums
    bit for bit (the int totals exact host sums, the float ones one
    reduction per lane)."""
    rng = np.random.default_rng(21)
    spaces, models = [], []
    for i in range(2):
        sp = mt.CellularSpace.create(
            16, 16, {"age": (0, "int32"), "value": 1.0}, dtype="float64",
            device="cpu").with_values(
                {"age": torch.from_numpy(rng.integers(0, 99, (16, 16),
                                                      dtype=np.int32)),
                 "value": torch.from_numpy(rng.uniform(0.5, 2.0, (16, 16)))})
        spaces.append(sp)
        models.append(mt.Model(mt.Diffusion(0.04 + 0.03 * i), 1.0, 1.0))
    fl = launch_ensemble(models[0], spaces, models=models, steps=3)
    for i, (_, rep) in enumerate(complete_ensemble(fl)):
        _, wrep = _serial(models[i], spaces[i], 3)
        assert list(rep.initial_total) == ["age", "value"]
        assert rep.initial_total == wrep.initial_total
        assert rep.final_total == wrep.final_total
        assert rep.last_execute == wrep.last_execute


def test_execute_many_keeps_its_executor():
    spaces, models, _ = make_scenarios(B=2)
    models[0].execute_many(spaces, steps=2)
    models[0].execute_many(spaces, steps=5)
    ex = models[0]._default_ensemble
    assert ex.builds == 1 and ex.cache_hits == 1


# -- the scheduler -----------------------------------------------------------

def test_scheduler_pads_to_bucket_and_serves_correct_results():
    spaces, models, _ = make_scenarios(B=3)
    sch = mt.EnsembleScheduler(buckets=(1, 2, 4, 8))
    tickets = [sch.submit(spaces[i], models[i], steps=3) for i in range(3)]
    sch.pump(force=True)
    st = sch.stats()
    assert st["dispatches"] == 1
    assert st["batch_occupancy"] == pytest.approx(0.75)
    assert sch.dispatch_log[0]["bucket"] == 4
    assert sch.dispatch_log[0]["count"] == 3
    for i, t in enumerate(tickets):
        sp, rep = sch.poll(t)
        want, _ = _serial(models[i], spaces[i], 3)
        assert torch.equal(sp.values["value"], want.values["value"])
    with pytest.raises(KeyError):
        sch.poll(tickets[0])


def test_scheduler_cache_hits_on_repeated_bucket():
    spaces, models, _ = make_scenarios(B=3)
    sch = mt.EnsembleScheduler()
    for i in range(3):
        sch.submit(spaces[i], models[i], steps=2)
    sch.pump(force=True)
    # same structure and bucket, other rates and step count: a hit
    for i in range(3):
        sch.submit(spaces[i], models[(i + 1) % 3], steps=5)
    sch.pump(force=True)
    st = sch.stats()
    assert st["dispatches"] == 2
    assert st["runner_builds"] == 1 and st["runner_cache_hits"] == 1
    assert st["compile_cache_hits"] == 1
    assert st["compile_cache_hit_rate"] == pytest.approx(0.5)
    assert [d["cache_hit"] for d in sch.dispatch_log] == [False, True]


def test_scheduler_flush_on_max_wait_ordering():
    clock = {"t": 0.0}
    sch = mt.EnsembleScheduler(max_wait_s=1.0, clock=lambda: clock["t"])
    spaces, models, _ = make_scenarios(B=4)
    ta = sch.submit(spaces[0], models[0], steps=2)   # group A @ t=0
    clock["t"] = 0.5
    tb = sch.submit(spaces[1], models[1], steps=3)   # group B @ t=0.5
    assert sch.pump() == 0
    assert sch.poll(ta) is None
    clock["t"] = 1.2                                  # A due, B not
    assert sch.pump() == 1
    assert [d["steps"] for d in sch.dispatch_log] == [2]
    assert sch.poll(ta) is not None
    assert sch.poll(tb) is None
    clock["t"] = 1.6
    assert sch.pump() == 1
    assert [d["steps"] for d in sch.dispatch_log] == [2, 3]
    # several groups due at once flush oldest first
    sch.submit(spaces[2], models[2], steps=4)
    clock["t"] = 1.7
    sch.submit(spaces[3], models[3], steps=5)
    clock["t"] = 10.0
    sch.pump()
    assert [d["steps"] for d in sch.dispatch_log][-2:] == [4, 5]
    # the queue latency runs on the same clock
    assert sch.stats()["latency_p99_s"] == pytest.approx(8.4)


def test_scheduler_flushes_when_batch_fills():
    spaces, models, _ = make_scenarios(B=2)
    sch = mt.EnsembleScheduler(buckets=(1, 2, 4), max_batch=2,
                               max_wait_s=1e9)
    sch.submit(spaces[0], models[0], steps=2)
    assert sch.stats()["dispatches"] == 0
    sch.submit(spaces[1], models[1], steps=2)
    assert sch.stats()["dispatches"] == 1
    assert sch.dispatch_log[0]["bucket"] == 2
    assert sch.stats()["batch_occupancy"] == 1.0


def test_launch_due_then_finish_flight():
    """The two halves of a dispatch: ``launch_due`` queues the batch and
    resolves nothing; ``finish_flight`` publishes every ticket."""
    spaces, models, _ = make_scenarios(B=2)
    sch = mt.EnsembleScheduler(max_wait_s=1e9)
    tickets = [sch.submit(spaces[i], models[i], steps=3) for i in range(2)]
    assert sch.launch_due() is None             # nothing due yet
    flight = sch.launch_due(force=True)
    assert flight.bucket == 2 and not flight.cache_hit
    assert [sch.poll(t, pump=False) for t in tickets] == [None, None]
    sch.finish_flight(flight)
    for i, t in enumerate(tickets):
        sp, _ = sch.poll(t, pump=False)
        want, _ = _serial(models[i], spaces[i], 3)
        assert torch.equal(sp.values["value"], want.values["value"])
    assert sch.stats()["dispatches"] == 1 and sch.stats()["pending"] == 0


def _drifting():
    """Rate-0 lanes conserve exactly at f32; the 0.3 lane drifts (a
    zero-threshold contract flags it). The seed is one whose 0.3 lane's f32
    total moves in 10 steps under torch's summation (whether a total moves
    depends on the order a reduction adds in)."""
    rng = np.random.default_rng(4)
    spaces, models = [], []
    for rate in (0.0, 0.3, 0.0):
        spaces.append(_space(rng.uniform(0.5, 2.0, (32, 32)), "float32"))
        models.append(mt.Model(mt.Diffusion(rate), 1.0, 1.0))
    return spaces, models


def test_scheduler_marks_bad_scenario_without_poisoning_batch():
    spaces, models = _drifting()
    sch = mt.EnsembleScheduler(tolerance=0.0, rtol=0.0)
    tickets = [sch.submit(spaces[i], models[i], steps=10) for i in range(3)]
    sch.pump(force=True)
    assert sch.poll(tickets[0]) is not None
    with pytest.raises(mt.EnsembleConservationError) as ei:
        sch.poll(tickets[1])
    assert ei.value.scenario == 1 and ei.value.ticket == tickets[1]
    assert sch.poll(tickets[2]) is not None


def test_solo_retry_quarantines_the_bad_scenario():
    spaces, models = _drifting()
    sch = mt.EnsembleScheduler(tolerance=0.0, rtol=0.0, retry="solo")
    tickets = [sch.submit(spaces[i], models[i], steps=10) for i in range(3)]
    sch.pump(force=True)
    with pytest.raises(mt.EnsembleConservationError) as ei:
        sch.poll(tickets[1])
    ev = ei.value.failure_event
    assert isinstance(ev, FailureEvent)
    assert (ev.kind, ev.ticket, ev.attempt, ev.classification) == (
        "conservation", tickets[1], 2, "deterministic")
    assert sch.quarantine_log == [ev]
    st = sch.stats()
    assert st["solo_retries"] == 1 and st["quarantined"] == 1
    assert st["recovered_failures"] == 0 and st["impl_faults"] == 0
    assert sch.dispatch_log[0]["retried_solo"] == [tickets[1]]
    assert sch.dispatch_log[1]["solo_retry"] is True
    _, rep = sch.poll(tickets[0])
    assert rep.backend_report is None


def test_dispatch_failure_surfaces_at_poll_not_submit():
    sch = mt.EnsembleScheduler(impl="pipeline", max_batch=1)
    bad_space = mt.CellularSpace.create(16, 128, 1.0, dtype="float64",
                                        device="cpu")
    model = mt.Model(mt.Diffusion(0.1), 1.0, 1.0)
    t_bad = sch.submit(bad_space, model, steps=1)   # dispatches inline
    assert isinstance(t_bad, int)
    assert sch.dispatch_log[-1]["error"].startswith("ValueError")
    with pytest.raises(ValueError, match="f32"):
        sch.poll(t_bad)
    good = mt.CellularSpace.create(16, 128, 1.0, dtype="float32",
                                   device="cpu")
    t_ok = sch.submit(good, model, steps=1)
    sp, rep = sch.poll(t_ok)
    assert rep.steps == 1


def test_all_violating_dispatch_still_bills_wall_time():
    rng = np.random.default_rng(1)   # a seed whose total moves
    space = _space(rng.uniform(0.5, 2.0, (32, 32)), "float32")
    model = mt.Model(mt.Diffusion(0.3), 1.0, 1.0)
    sch = mt.EnsembleScheduler(tolerance=0.0, rtol=0.0)
    t = sch.submit(space, model, steps=10)
    sch.pump(force=True)
    assert sch.stats()["busy_s"] > 0.0
    with pytest.raises(mt.EnsembleConservationError):
        sch.poll(t)


def test_ticket_deadline_and_dispatch_deadline_on_a_fake_clock():
    from mpi_model_tpu_torch.ensemble import DispatchTimeout, TicketExpired

    clock = {"t": 0.0}
    spaces, models, _ = make_scenarios(B=2)
    sch = mt.EnsembleScheduler(max_wait_s=100.0, ticket_deadline_s=1.0,
                               clock=lambda: clock["t"])
    t = sch.submit(spaces[0], models[0], steps=2)
    clock["t"] = 1.5
    with pytest.raises(TicketExpired) as ei:
        sch.poll(t)
    assert ei.value.failure_event.kind == "expired"
    assert sch.stats()["expired"] == 1

    # a clock that jumps 5 s per reading overruns a 1 s dispatch deadline
    ticks = iter(range(0, 1000, 5))
    sch = mt.EnsembleScheduler(dispatch_deadline_s=1.0,
                               clock=lambda: float(next(ticks)))
    t = sch.submit(spaces[0], models[0], steps=2)
    sch.pump(force=True)
    with pytest.raises(DispatchTimeout):
        sch.poll(t)
    assert sch.stats()["dispatches"] == 0      # an overrun is not billed


def test_scheduler_stats_keys_are_jax_keys():
    jkeys = set(JScheduler(compile_cache=None).stats())
    assert set(mt.EnsembleScheduler().stats()) == jkeys
    assert set(ThroughputCounter().snapshot()) == set(JCounter().snapshot())
    assert ThroughputCounter.COUNTERS == JCounter.COUNTERS
    assert [f.name for f in dataclasses.fields(FailureEvent)] == \
        [f.name for f in dataclasses.fields(JFailureEvent)]
    with pytest.raises(ValueError, match="unknown counter"):
        ThroughputCounter().bump("nope")


def test_unported_options_name_the_roadmap(tmp_path):
    spaces, models, _ = make_scenarios(B=1)
    # the mesh is ported (tests/test_torch_ensemble_mesh.py): on the CPU a
    # mesh names its devices, and a spec resolves against the cards
    cpu2 = mt.ensemble.make_ensemble_mesh(2, devices=["cpu"] * 2)
    assert mt.EnsembleExecutor(mesh=cpu2).mesh is cpu2
    assert mt.EnsembleScheduler(mesh=cpu2).stats()["mesh"] == {
        "batch": 2, "space": 1, "devices": 2}
    if not torch.cuda.is_available():
        for make in (lambda: mt.EnsembleExecutor(mesh=2),
                     lambda: mt.EnsembleScheduler(mesh=(2, 1))):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    # the multi-process layer is ported: in a torch.distributed world above
    # one process the process count is the world's
    import torch.distributed as dist

    from mpi_model_tpu_torch.parallel import multihost

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dist, "is_available", lambda: True)
        mp.setattr(dist, "is_initialized", lambda: True)
        mp.setattr(dist, "get_world_size", lambda *a, **k: 2)
        assert multihost.process_count() == 2
    # migration is ported: a queued ticket moves to another service
    src = mt.EnsembleService(models[0], max_batch=8)
    dst = mt.EnsembleService(models[0], max_batch=8)
    moved = src.migrate(src.submit(spaces[0]), dst)
    assert dst.stats()["migrated_in"] == 1
    assert dst.result(moved)[0].values["value"].shape == \
        spaces[0].values["value"].shape
    # windowed and donated dispatch are ported (impl="xla")
    svc = mt.EnsembleService(models[0], windows=2, donate=True)
    assert svc.scheduler.windows == 2 and svc.scheduler.donate
    fl = launch_ensemble(models[0], spaces, windows=2, donate=True,
                         steps=2)
    assert fl.windows == fl.donated_windows == 2
    complete_ensemble(fl)
    # the kernel build cache is ported: a directory re-points the build
    # directory, None builds into a private one, "auto" is the package's
    from mpi_model_tpu_torch.ops import _build

    cache = str(tmp_path / "kernels")
    try:
        assert mt.EnsembleService(models[0], compile_cache=cache) \
            .compile_cache == cache
        assert str(_build.BUILD_DIR) == cache
        assert mt.EnsembleService(models[0], compile_cache=None) \
            .compile_cache is None
        assert _build.BUILD_DIR not in (_build.DEFAULT_BUILD_DIR,
                                        _build.Path(cache))
    finally:
        mt.EnsembleService(models[0])
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR
    with pytest.raises(ValueError, match="unknown ensemble impl"):
        mt.EnsembleExecutor(impl="nope")
    # bf16 interior math is ported: accepted, and a bad dtype refused
    ex = mt.EnsembleExecutor("pipeline", compute_dtype=torch.bfloat16)
    assert ex.compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="compute_dtype"):
        mt.EnsembleExecutor(compute_dtype="float16")


# -- the service -------------------------------------------------------------

def test_service_submit_poll_and_counters():
    spaces, models, _ = make_scenarios(B=3)
    svc = mt.EnsembleService(models[0], steps=3, max_wait_s=1e9)
    tickets = [svc.submit(spaces[i], model=models[i]) for i in range(3)]
    assert svc.poll(tickets[0]) is None
    svc.flush()
    for t in tickets:
        _, rep = svc.result(t)
        assert rep.steps == 3
    st = svc.stats()
    assert st["scenarios"] == 3
    assert st["batch_occupancy"] == pytest.approx(0.75)
    assert st["scenarios_per_s"] is None or st["scenarios_per_s"] > 0
    assert st["pending"] == 0 and st["latency_n"] == 3


def test_result_flushes_only_its_own_group():
    spaces, models, _ = make_scenarios(B=1)
    other = mt.CellularSpace.create(8, 8, 1.0, dtype="float64", device="cpu")
    svc = mt.EnsembleService(models[0], steps=2, max_wait_s=1e9)
    t_a = svc.submit(spaces[0], model=models[0])
    t_b = svc.submit(other, model=mt.Model(mt.Diffusion(0.05), 1.0, 1.0))
    _, rep = svc.result(t_a)
    assert rep.steps == 2
    assert svc.poll(t_b) is None
    assert svc.stats()["dispatches"] == 1
    svc.flush()
    assert svc.poll(t_b) is not None


# -- the pipeline impl (K5) --------------------------------------------------

def _strips(B=2, seed=2, dtype="float32"):
    rng = np.random.default_rng(seed)
    return [_space(rng.uniform(0.5, 2.0, (16, 128)), dtype)
            for _ in range(B)]


@pytest.mark.parametrize("substeps,steps", [(1, 2), (4, 9)])
def test_pipeline_impl_matches_xla(substeps, steps):
    spaces = _strips()
    model = mt.Model(mt.Diffusion(0.1), 1.0, 1.0)
    out = model.execute_many(
        spaces, executor=mt.EnsembleExecutor(impl="pipeline",
                                             substeps=substeps),
        steps=steps)
    for i, (sp, rep) in enumerate(out):
        want, _ = _serial(model, spaces[i], steps)
        np.testing.assert_allclose(sp.values["value"].double().numpy(),
                                   want.values["value"].double().numpy(),
                                   atol=1e-5)
        assert rep.impl == "pipeline"
        assert rep.backend_report == {
            "impl": "pipeline", "kernel": "K5 pipeline_stencil",
            "substeps": substeps, "launches": 0}


def test_pipeline_lanes_are_the_wrapper_calls():
    """Each fused call of the pipeline runner is one K5 call over the whole
    batch: a lane equals that lane stepped through the wrapper alone."""
    from mpi_model_tpu_torch.ops.pipeline_stencil import pipeline_dense_step

    spaces = _strips(B=3, seed=8, dtype="bfloat16")
    model = mt.Model(mt.Diffusion(0.1), 1.0, 1.0)
    out = model.execute_many(
        spaces, executor=mt.EnsembleExecutor(impl="pipeline", substeps=4),
        steps=9)
    for i, (sp, _) in enumerate(out):
        v = spaces[i].values["value"]
        for ns in (4, 4, 1):
            v = pipeline_dense_step(v, 0.1, nsteps=ns)
        assert torch.equal(sp.values["value"], v)


def test_pipeline_impl_refusals_match_jax():
    spaces = _strips()
    jspaces = [mm.CellularSpace.create(16, 128, 1.0, dtype=jnp.float32)
               for _ in range(2)]
    cases = [
        (lambda M, E, sp: M.Model(M.Diffusion(0.1), 1.0, 1.0).execute_many(
            sp, models=[M.Model(M.Diffusion(0.1)), M.Model(M.Diffusion(0.2))],
            executor=E(impl="pipeline"), steps=1), "share one rate"),
        (lambda M, E, sp: M.Model(M.Exponencial(
            M.Cell(3, 3, M.Attribute(99, 2.2)), 0.1)).execute_many(
                sp[:1], executor=E(impl="pipeline"), steps=1), "Diffusion"),
        (lambda M, E, sp: M.Model(M.Coupled(0.1)).execute_many(
            sp[:1], executor=E(impl="pipeline"), steps=1), "Diffusion"),
        (lambda M, E, sp: M.Model(M.Diffusion(0.1)).execute_many(
            sp[:1], executor=E(impl="pipeline", substeps=9), steps=9),
         "strip"),
    ]
    for run, match in cases:
        with pytest.raises(ValueError, match=match) as t_exc:
            run(mt, mt.EnsembleExecutor, spaces)
        with pytest.raises(ValueError, match=match) as j_exc:
            run(mm, mm.EnsembleExecutor, jspaces)
        assert str(t_exc.value) == str(j_exc.value)
    bad = [mt.CellularSpace.create(20, 50, 1.0, device="cpu")]
    jbad = [mm.CellularSpace.create(20, 50, 1.0, dtype=jnp.float32)]
    with pytest.raises(ValueError, match="strip") as t_exc:
        mt.Model(mt.Diffusion(0.1)).execute_many(
            bad, executor=mt.EnsembleExecutor(impl="pipeline"), steps=1)
    with pytest.raises(ValueError, match="strip") as j_exc:
        mm.Model(mm.Diffusion(0.1)).execute_many(
            jbad, executor=mm.EnsembleExecutor(impl="pipeline"), steps=1)
    assert str(t_exc.value) == str(j_exc.value)


def test_pipeline_impl_works_with_bucket_padding():
    spaces = _strips(B=3, seed=9)
    model = mt.Model(mt.Diffusion(0.1), 1.0, 1.0)
    svc = mt.EnsembleService(model, steps=2, impl="pipeline")
    tickets = [svc.submit(s) for s in spaces]
    svc.flush()
    assert svc.stats()["batch_occupancy"] == pytest.approx(0.75)
    for i, t in enumerate(tickets):
        sp, _ = svc.result(t)
        want, _ = _serial(model, spaces[i], 2)
        np.testing.assert_allclose(sp.values["value"].double().numpy(),
                                   want.values["value"].double().numpy(),
                                   atol=1e-5)


def _failing_k5(monkeypatch):
    """Make every K5 call fail as a build or launch failure does (the
    wrapper's ``KernelError``); returns the list the calls are appended
    to."""
    from mpi_model_tpu_torch.ops import pipeline_stencil

    calls = []

    def fail(*args, **kwargs):
        calls.append(1)
        raise KernelError("pipeline_stencil kernel launch failed: "
                          "no kernel image is available (cudaError 209)")

    monkeypatch.setattr(pipeline_stencil, "pipeline_dense_step", fail)
    return calls


def _counted_k5(monkeypatch):
    """Count K5's calls (its plain version on the CPU); returns the list
    the calls are appended to."""
    from mpi_model_tpu_torch.ops import pipeline_stencil

    calls = []
    real = pipeline_stencil.pipeline_dense_step

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(pipeline_stencil, "pipeline_dense_step", counted)
    return calls


def _batch_fault():
    return inject.armed(FaultPlan((Fault("batch_exc", at=0),)))


def test_ladder_degrades_pipeline_to_xla(monkeypatch):
    """The JAX package's ladder: after a clean K5 dispatch, an injected
    whole-batch fault reaches its tickets with no warning, until the
    ``degrade_after``-th (2) steps the engine ``pipeline`` → ``xla`` with a
    ``RuntimeWarning`` and the intake gate raised; the next dispatch runs
    on ``xla`` (K5 is not called again), bit for bit a fresh ``xla``
    scheduler's, stamped ``impl: "xla"``, ``degraded_from: "pipeline"``,
    and closes the gate."""
    calls = _counted_k5(monkeypatch)
    sch = mt.EnsembleScheduler(impl="pipeline")
    spaces = _strips(B=2, seed=13)
    model = mt.Model(mt.Diffusion(0.1), 1.0, 1.0)

    def serve():
        tickets = [sch.submit(s, model, steps=1) for s in spaces]
        sch.pump(force=True)
        return tickets

    [sch.poll(t) for t in serve()]
    assert len(calls) == 1 and sch.stats()["degraded_from"] is None
    for round_ in range(2):
        with _batch_fault(), warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            tickets = serve()
        for t in tickets:
            with pytest.raises(inject.InjectedFault):
                sch.poll(t)
        rungs = [str(x.message) for x in w
                 if issubclass(x.category, RuntimeWarning)]
        st = sch.stats()
        if round_ == 0:
            assert rungs == []
            assert (st["impl"], st["degraded_from"], st["intake_gated"]) \
                == ("pipeline", None, False)
        else:
            assert len(rungs) == 1 and "degraded to 'xla'" in rungs[0]
            assert (st["impl"], st["degraded_from"], st["intake_gated"]) \
                == ("xla", "pipeline", True)
    served = [sch.poll(t) for t in serve()]
    assert len(calls) == 1  # K5 is not called after the rung
    fresh = mt.EnsembleScheduler(impl="xla")
    ft = [fresh.submit(s, model, steps=1) for s in spaces]
    fresh.pump(force=True)
    for (sp, rep), t in zip(served, ft):
        assert torch.equal(sp.values["value"],
                           fresh.poll(t)[0].values["value"])
        assert (rep.backend_report["impl"],
                rep.backend_report["degraded_from"]) == ("xla", "pipeline")
    st = sch.stats()
    assert st["impl_faults"] == 2 and st["dispatches"] == 2
    assert not st["intake_gated"]


def test_ladder_with_solo_retry_recovers_on_xla(monkeypatch):
    """Under ``retry="solo"`` and ``degrade_after=1`` an injected fault of
    a ``pipeline`` batch takes the rung at once: both solo retries run on
    ``xla`` and recover, each lane bit for bit a fresh ``xla`` dispatch and
    stamped ``degraded_from: "pipeline"``; K5 never runs."""
    calls = _counted_k5(monkeypatch)
    sch = mt.EnsembleScheduler(impl="pipeline", retry="solo",
                               degrade_after=1)
    model = mt.Model(mt.Diffusion(0.1), 1.0, 1.0)
    spaces = _strips(B=2, seed=14)
    with _batch_fault():
        tickets = [sch.submit(s, model, steps=2) for s in spaces]
        with pytest.warns(RuntimeWarning, match="degraded to 'xla'"):
            sch.pump(force=True)
    fresh = mt.EnsembleScheduler(impl="xla")
    ft = [fresh.submit(s, model, steps=2) for s in spaces]
    fresh.pump(force=True)
    for t, f in zip(tickets, ft):
        sp, rep = sch.poll(t)
        assert torch.equal(sp.values["value"],
                           fresh.poll(f)[0].values["value"])
        assert (rep.backend_report["impl"],
                rep.backend_report["degraded_from"]) == ("xla", "pipeline")
    assert calls == []
    st = sch.stats()
    assert (st["solo_retries"], st["recovered_failures"],
            st["quarantined"], st["impl_faults"]) == (2, 2, 0, 1)
    assert st["impl"] == "xla" and st["degraded_from"] == "pipeline"
    assert [e.get("outcome") for e in sch.dispatch_log] == [
        None, "recovered", "recovered"]


@pytest.mark.parametrize("retry", ["none", "solo"])
def test_a_kernel_error_never_steps_the_ladder(monkeypatch, retry):
    """A K5 build or launch error is counted as an impl-level fault but
    steps no rung, even at ``degrade_after=1`` and however often it
    repeats: every affected ticket gets that error (under ``"solo"`` after
    its solo retry on K5), no warning comes, and no dispatch runs the plain
    engine in the kernel's place."""
    calls = _failing_k5(monkeypatch)
    sch = mt.EnsembleScheduler(impl="pipeline", retry=retry,
                               degrade_after=1)
    spaces = _strips(B=2, seed=13)
    model = mt.Model(mt.Diffusion(0.1), 1.0, 1.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for _ in range(3):
            tickets = [sch.submit(s, model, steps=1) for s in spaces]
            sch.pump(force=True)
            for t in tickets:
                with pytest.raises(KernelError, match="pipeline_stencil"):
                    sch.poll(t)
    per_round = 3 if retry == "solo" else 1
    assert len(calls) == 3 * per_round
    st = sch.stats()
    assert (st["impl"], st["degraded_from"], st["intake_gated"]) == (
        "pipeline", None, False)
    assert st["impl_faults"] == 3 * per_round and st["dispatches"] == 0
    assert sch.executor.impl == "pipeline"


def test_k5_error_reaches_execute_many_and_service_result(monkeypatch):
    """A K5 error propagates out of every entry point unchanged."""
    _failing_k5(monkeypatch)
    spaces = _strips(B=2, seed=15)
    model = mt.Model(mt.Diffusion(0.1), 1.0, 1.0)
    with pytest.raises(RuntimeError, match="pipeline_stencil"):
        model.execute_many(spaces, executor=mt.EnsembleExecutor("pipeline"),
                           steps=1)
    svc = mt.EnsembleService(model, steps=1, impl="pipeline", retry="solo")
    t = svc.submit(spaces[0])
    # the batch and its solo retry fail on K5: two impl-level faults at the
    # default degrade_after, and still no rung
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(KernelError, match="pipeline_stencil"):
            svc.result(t)
    st = svc.stats()
    assert (st["impl"], st["degraded_from"], st["quarantined"],
            st["impl_faults"]) == ("pipeline", None, 1, 2)


def test_results_never_alias_a_later_dispatch():
    """A served result is its own memory: a later dispatch (same runner,
    pipeline and xla alike) writes none of it, and it aliases no input."""
    for impl in ("pipeline", "xla"):
        spaces = _strips(B=2, seed=12)
        model = mt.Model(mt.Diffusion(0.1), 1.0, 1.0)
        svc = mt.EnsembleService(model, steps=3, impl=impl, substeps=2)
        first = [svc.result(t) for t in [svc.submit(s) for s in spaces]]
        kept = [sp.values["value"].clone() for sp, _ in first]
        second = [svc.result(t) for t in [svc.submit(s) for s in spaces]]
        assert svc.stats()["runner_cache_hits"] == 1
        ptrs = {sp.values["value"].untyped_storage().data_ptr()
                for sp, _ in second}
        ptrs |= {s.values["value"].untyped_storage().data_ptr()
                 for s in spaces}
        for (sp, _), k in zip(first, kept):
            assert torch.equal(sp.values["value"], k)
            assert sp.values["value"].untyped_storage().data_ptr() \
                not in ptrs


# -- the active impls --------------------------------------------------------

def _sparse(B=3, g=128, dtype="float64"):
    rng = np.random.default_rng(21)
    spaces, raw = [], []
    for i in range(B):
        v = np.zeros((g, g))
        v[40 + 5 * i:60 + 5 * i, 50:70] = rng.uniform(0.5, 2.0, (20, 20))
        raw.append(v)
        spaces.append(_space(v, dtype))
    return spaces, raw


@pytest.mark.parametrize("impl,substeps", [("active", 1),
                                           ("active_fused", 1),
                                           ("active_fused", 4)])
def test_active_lanes_bitwise_serial(impl, substeps):
    spaces, _ = _sparse()
    models = [mt.Model(mt.Diffusion(0.05 + 0.03 * i)) for i in range(3)]
    ex = mt.EnsembleExecutor(impl=impl, substeps=substeps)
    out = models[0].execute_many(spaces, models=models, steps=9, executor=ex)
    for i, (sp, rep) in enumerate(out):
        want, _ = _serial(models[i], spaces[i], 9)
        assert torch.equal(sp.values["value"], want.values["value"])
        assert rep.backend_report["impl"] == impl
        assert rep.backend_report["fallback_steps"] == 0
    br = ex.last_backend_report
    assert br["lanes"] == 3 and br["steps"] == 9
    if impl == "active_fused":
        k = br["composed_k"]
        assert k == substeps and br["passes"] == 9 // k + 9 % k
        assert br["flags_fused"] == 3 * br["passes"]


def test_active_lanes_match_jax_run_ensemble():
    spaces, raw = _sparse(B=2)
    models = [mt.Model(mt.Diffusion(0.05 + 0.03 * i)) for i in range(2)]
    out = models[0].execute_many(spaces, models=models, steps=6,
                                 executor=mt.EnsembleExecutor(impl="active"))
    jspaces = [mm.CellularSpace.create(128, 128, 0.0, dtype=jnp.float64)
               .with_values({"value": jnp.asarray(v)}) for v in raw]
    jmodels = [mm.Model(mm.Diffusion(m.flows[0].flow_rate)) for m in models]
    jout = jax_run_ensemble(jmodels[0], jspaces, models=jmodels, steps=6,
                            executor=mm.EnsembleExecutor(impl="active"))
    for (sp, rep), (jsp, jrep) in zip(out, jout):
        want = np.asarray(jsp.values["value"])
        assert float(np.abs(sp.values["value"].numpy() - want).max()) <= \
            2 * EPS64 * 6 * float(np.abs(want).max())
        assert rep.backend_report["mean_active_fraction"] == pytest.approx(
            jrep.backend_report["mean_active_fraction"])


def test_active_impls_refuse_like_jax():
    spaces, _, _ = make_scenarios(B=1)
    model = mt.Model([mt.Diffusion(0.1),
                      mt.PointFlow(source=(1, 1), flow_rate=0.1)])
    jmodel = mm.Model([mm.Diffusion(0.1),
                       mm.PointFlow(source=(1, 1), flow_rate=0.1)])
    jsp = mm.CellularSpace.create(16, 16, 1.0, dtype=jnp.float64)
    for impl in ("active", "active_fused"):
        with pytest.raises(ValueError) as t_exc:
            model.execute_many(spaces, executor=mt.EnsembleExecutor(impl),
                               steps=1)
        with pytest.raises(ValueError) as j_exc:
            jmodel.execute_many([jsp], executor=mm.EnsembleExecutor(impl),
                                steps=1)
        assert str(t_exc.value) == str(j_exc.value)


# -- the CLI -----------------------------------------------------------------

@pytest.mark.parametrize("argv,impl,occupancy", [
    (["--dimx=16", "--dimy=16", "--flow=diffusion", "--steps=3",
      "--ensemble=3", "--dtype=float64"], "xla", 0.75),
    (["--dimx=16", "--dimy=128", "--flow=diffusion", "--steps=9",
      "--substeps=4", "--ensemble=8", "--ensemble-impl=pipeline"],
     "pipeline", 1.0),
    (["--dimx=64", "--dimy=64", "--flow=diffusion", "--steps=4",
      "--blob=0.05", "--ensemble=2", "--ensemble-impl=active_fused"],
     "active_fused", 1.0),
])
def test_cli_ensemble_row(argv, impl, occupancy, capsys):
    rc = cli_main(["run", "--device=cpu", "--json", *argv])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert row["backend"] == "ensemble" and row["impl"] == impl
    assert row["conserved"] is True and row["device"] == "cpu"
    assert row["batch_occupancy"] == pytest.approx(occupancy)
    assert row["dispatches"] >= 1 and row["kernel_launches"] == 0
    jax_keys = {"backend", "ranks", "ensemble", "steps", "initial", "final",
                "conservation_error", "conserved", "wall_s", "impl",
                "substeps", "mesh", "scenarios_per_s", "batch_occupancy",
                "compile_cache_hits", "dispatches", "recovered_failures",
                "quarantined", "solo_retries"}
    assert jax_keys <= set(row)


@pytest.mark.parametrize("argv", [
    ["run", "--ensemble=2", "--impl=pallas"],
    ["run", "--ensemble=0"],
    ["run", "--ensemble-impl=pipeline"],
])
def test_cli_ensemble_flag_checks(argv):
    with pytest.raises(SystemExit):
        cli_main(argv + ["--device=cpu"])


def test_cli_ineligible_engine_is_a_clean_exit():
    # the pipeline engine has no point-flow kernel
    with pytest.raises(SystemExit, match="ensemble run failed"):
        cli_main(["run", "--ensemble=2", "--ensemble-impl=pipeline",
                  "--device=cpu"])
