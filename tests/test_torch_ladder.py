"""The port's degradation ladder (``EnsembleScheduler.DEGRADE_TO``,
``degrade_after``, ``intake_gated``, the ``impl``/``degraded_from`` stamp)
on the CPU, against the JAX package's ladder on the same numpy-seeded
scenarios and fault plans.

- Counterparts of ``tests/test_chaos.py::test_batch_fault_engages_
  degradation_ladder`` and ``tests/test_serving.py``'s two health-gate
  tests, run beside JAX's scheduler and async service: the same counters,
  the same sheds, the same ledger.
- Each lane a degraded engine serves is bit for bit the port's own dispatch
  on that engine (the ``xla`` rung, and the ``active`` rung of
  ``active_fused``), and at f64 bit for bit ``oracle.dense_flow_step_np``
  applied step by step. JAX's degraded lanes run here (its ``xla`` and
  ``active`` ensemble engines) and are held at the reference's tolerance,
  atol 1e-12 (PARITY.md): XLA on the CPU contracts multiply-adds.
- ``pipeline`` lanes are f32 16×128 strips (K5's smallest), run through
  K5's plain version on the CPU; ``active_fused`` through K6/K7's.
- Below ``degrade_after`` nothing degrades: the fault reaches its tickets,
  no warning, no stamp.
- A hand kernel's own failure (``KernelError``, or an error caused by one)
  steps no rung at any ``degrade_after``, where JAX's ladder steps on any
  impl-level fault: it reaches its tickets as itself.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_model_tpu as mm
from mpi_model_tpu.ensemble import AsyncEnsembleService as JAsync
from mpi_model_tpu.ensemble.scheduler import EnsembleScheduler as JScheduler
from mpi_model_tpu.oracle import dense_flow_step_np
from mpi_model_tpu.resilience import inject as jinject

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch.ensemble import (AsyncEnsembleService,
                                          EnsembleScheduler,
                                          ServiceOverloaded)
from mpi_model_tpu_torch.resilience import inject
from mpi_model_tpu_torch.resilience.inject import Fault, FaultPlan

BASE = np.random.default_rng(29).uniform(0.5, 2.0, (32, 32))
STRIP = np.random.default_rng(31).uniform(0.5, 2.0, (16, 128))
STEPS = 4


def raw(i, g=16):
    return np.roll(BASE, 5 * i, axis=1)[:g, :g].copy()


def space(i, g=16, dtype="float64"):
    return mt.CellularSpace.create(g, g, 1.0, dtype=dtype,
                                   device="cpu").with_values(
        {"value": torch.from_numpy(raw(i, g)).to(getattr(torch, dtype))})


def strip(i):
    v = np.roll(STRIP, 7 * i, axis=1).astype(np.float32)
    return mt.CellularSpace.create(16, 128, 1.0, dtype="float32",
                                   device="cpu").with_values(
        {"value": torch.from_numpy(v)})


def model(rate=0.1):
    return mt.Model(mt.Diffusion(rate), float(STEPS), 1.0)


def jspace(i, g=16):
    return mm.CellularSpace.create(g, g, 1.0, dtype=jnp.float64).with_values(
        {"value": jnp.asarray(raw(i, g))})


def jmodel(rate=0.1):
    return mm.Model(mm.Diffusion(rate), float(STEPS), 1.0)


def oracle_run(i, rate=0.1, steps=STEPS, g=16):
    ref = raw(i, g)
    for _ in range(steps):
        ref = dense_flow_step_np(ref, rate)
    return ref


def own_dispatch(impl, spaces, steps=STEPS, **kw):
    """The port's own dispatch of ``spaces`` on ``impl``: the bits a rung to
    ``impl`` must serve."""
    sch = EnsembleScheduler(impl=impl, max_batch=len(spaces), **kw)
    tickets = [sch.submit(s, model(), steps=steps) for s in spaces]
    return [sch.poll(t)[0].values["value"] for t in tickets]


@pytest.fixture(autouse=True)
def _one_thread_and_no_plan():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
    assert inject.active() is None and jinject.active() is None


# -- the JAX package's ladder tests, side by side ------------------------------

def test_batch_fault_engages_degradation_ladder_like_jax():
    """``active`` → ``xla`` on a ``batch_exc``: the warning, solo recovery of
    every lane on ``xla``, the stamp, the counters, all as JAX's scheduler
    (``tests/test_chaos.py:692``); each lane bit for bit the port's ``xla``
    dispatch and the oracle, and within 1e-12 of JAX's."""
    plan = FaultPlan((Fault("batch_exc", at=0),))
    sch = EnsembleScheduler(impl="active", retry="solo", max_batch=2,
                            degrade_after=1)
    with inject.armed(plan):
        with pytest.warns(RuntimeWarning, match="degraded to 'xla'"):
            ts = [sch.submit(space(i), model(), steps=STEPS)
                  for i in range(2)]
            res = [sch.poll(t) for t in ts]
    jsch = JScheduler(impl="active", retry="solo", max_batch=2,
                      degrade_after=1, compile_cache=None)
    with jinject.armed(jinject.FaultPlan((jinject.Fault("batch_exc",
                                                        at=0),))):
        with pytest.warns(RuntimeWarning, match="degraded to 'xla'"):
            jts = [jsch.submit(jspace(i), jmodel(), steps=STEPS)
                   for i in range(2)]
            jres = [jsch.poll(t) for t in jts]
    st, jst = sch.stats(), jsch.stats()
    for k in ("impl", "degraded_from", "intake_gated", "recovered_failures",
              "impl_faults", "solo_retries", "quarantined", "dispatches"):
        assert st[k] == jst[k], k
    assert (st["impl"], st["degraded_from"]) == ("xla", "active")
    assert [("error" in d, d.get("outcome")) for d in sch.dispatch_log] == [
        ("error" in d, d.get("outcome")) for d in jsch.dispatch_log]
    want = own_dispatch("xla", [space(i) for i in range(2)])
    for i, ((sp, rep), (jsp, jrep)) in enumerate(zip(res, jres)):
        assert rep.backend_report["impl"] == jrep.backend_report["impl"] \
            == "xla"
        assert rep.backend_report["degraded_from"] == "active"
        assert torch.equal(sp.values["value"], want[i])
        np.testing.assert_array_equal(sp.values["value"].numpy(),
                                      oracle_run(i))
        np.testing.assert_allclose(sp.values["value"].numpy(),
                                   np.asarray(jsp.values["value"]),
                                   rtol=0, atol=1e-12)


def _gate_run(make, submit_space, armed, plan, shed_error):
    """``tests/test_serving.py:274``'s sequence on one package's service:
    returns what the test observes, step by step."""
    seen = []
    svc = make(impl="active", retry="none", degrade_after=1, max_wait_s=1e9,
               max_batch=2, start=False)
    with armed(plan):
        a = svc.submit(submit_space(0))
        b = svc.submit(submit_space(1))        # fills the A/B group
        c = svc.submit(submit_space(2), steps=3)  # its own group, queued
        with pytest.warns(RuntimeWarning, match="degraded to 'xla'"):
            svc.pump_once()                    # A/B fails: the gate rises
        seen.append(("gated", svc.scheduler.intake_gated))
        with pytest.raises(shed_error, match="health-gated"):
            svc.submit(submit_space(3))
        seen.append(("shed", svc.stats()["shed"]))
        svc.pump_once(force=True)              # launches C (clean engine)
        with pytest.raises(shed_error, match="health-gated"):
            svc.submit(submit_space(3))        # still mid-fall: C in flight
        svc.pump_once()                        # completes C: the gate falls
        seen.append(("gated", svc.scheduler.intake_gated))
        t = svc.submit(submit_space(3))        # intake reopened
        seen.append(("ticket", t))
    for bad in (a, b):
        with pytest.raises(Exception) as ei:
            svc.poll(bad)
        seen.append(("failed", type(ei.value).__name__))
    out_c = svc.poll(c)
    svc.stop()
    out_t = svc.poll(t)
    st = svc.stats()
    seen.append(("stats", {k: st[k] for k in (
        "shed", "impl", "degraded_from", "intake_gated", "impl_faults",
        "dispatches", "scenarios")}))
    return seen, out_c, out_t


def test_degradation_mid_fall_gates_intake_until_clean_dispatch():
    """After a rung, admission sheds while backlog is unproven and the first
    clean completion reopens it, step for step as JAX's service
    (``tests/test_serving.py:274``); the lanes served after the rung are
    the port's ``xla`` dispatch bit for bit and within 1e-12 of JAX's."""
    port, out_c, out_t = _gate_run(
        lambda **kw: AsyncEnsembleService(model(), steps=STEPS, **kw), space,
        inject.armed, FaultPlan((Fault("batch_exc", at=0),)),
        ServiceOverloaded)
    from mpi_model_tpu.ensemble import ServiceOverloaded as JOverloaded

    jax_seen, jout_c, jout_t = _gate_run(
        lambda **kw: JAsync(jmodel(), steps=STEPS, compile_cache=None, **kw),
        jspace, jinject.armed,
        jinject.FaultPlan((jinject.Fault("batch_exc", at=0),)), JOverloaded)
    assert port == jax_seen
    assert port[1] == ("shed", 1) and port[-1][1]["shed"] == 2
    assert out_c[1].backend_report["degraded_from"] == "active"
    assert torch.equal(out_c[0].values["value"],
                       own_dispatch("xla", [space(2)], steps=3)[0])
    assert torch.equal(out_t[0].values["value"],
                       own_dispatch("xla", [space(3)])[0])
    for got, want in ((out_c, jout_c), (out_t, jout_t)):
        np.testing.assert_allclose(got[0].values["value"].numpy(),
                                   np.asarray(want[0].values["value"]),
                                   rtol=0, atol=1e-12)


def test_idle_degraded_service_accepts_a_probe():
    """``tests/test_serving.py:306``: with no backlog the gate does not shed
    the next submission, which is served on the rung; JAX's service does the
    same."""
    outs = {}
    for pkg, make, sp, armed, plan in (
            ("port", lambda: AsyncEnsembleService(
                model(), steps=STEPS, impl="active", retry="none",
                degrade_after=1, max_batch=1, start=False), space,
             inject.armed, FaultPlan((Fault("batch_exc", at=0),))),
            ("jax", lambda: JAsync(
                jmodel(), steps=STEPS, impl="active", retry="none",
                degrade_after=1, max_batch=1, start=False,
                compile_cache=None), jspace, jinject.armed,
             jinject.FaultPlan((jinject.Fault("batch_exc", at=0),)))):
        svc = make()
        with armed(plan):
            a = svc.submit(sp(0))
            with pytest.warns(RuntimeWarning, match="degraded"):
                svc.pump_once()
            with pytest.raises(Exception, match="injected batch fault"):
                svc.poll(a)
            gated = svc.scheduler.intake_gated
            t = svc.submit(sp(1))  # depth 0: the probe is admitted
        svc.stop()
        res = svc.poll(t)
        outs[pkg] = (gated, t, svc.stats()["shed"],
                     svc.scheduler.intake_gated, res)
    assert outs["port"][:4] == outs["jax"][:4] == (True, 1, 0, False)
    got = outs["port"][4][0].values["value"]
    assert torch.equal(got, own_dispatch("xla", [space(1)])[0])
    np.testing.assert_array_equal(got.numpy(), oracle_run(1))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(outs["jax"][4][0].values["value"]),
        rtol=0, atol=1e-12)


# -- every rung, each bit for bit its engine's own dispatch -------------------

@pytest.mark.parametrize("start,lanes", [
    ("pipeline", "strips"), ("active", "grids"), ("active_fused", "grids")])
def test_each_rung_is_bitwise_its_engines_own_dispatch(start, lanes):
    """With ``degrade_after=1`` each ``batch_exc`` takes one rung
    (``pipeline`` → ``xla``; ``active_fused`` → ``active`` → ``xla``); the
    lanes served after each rung are bit for bit a fresh scheduler's
    dispatch on that engine, and the stamp names the rung."""
    spaces = ([strip(i) for i in range(2)] if lanes == "strips"
              else [space(i, dtype="float64") for i in range(2)])
    rungs = []
    impl = start
    while impl in EnsembleScheduler.DEGRADE_TO:
        impl = EnsembleScheduler.DEGRADE_TO[impl]
        rungs.append(impl)
    # a round is three dispatches (the batch and two solo retries)
    plan = FaultPlan(tuple(Fault("batch_exc", at=3 * r)
                           for r in range(len(rungs))))
    wants = {rung: own_dispatch(rung, spaces) for rung in rungs}
    sch = EnsembleScheduler(impl=start, retry="solo", max_batch=2,
                            degrade_after=1)
    with inject.armed(plan) as st:
        for rung in rungs:
            with pytest.warns(RuntimeWarning,
                              match=f"degraded to '{rung}'"):
                ts = [sch.submit(s, model(), steps=STEPS) for s in spaces]
                res = [sch.poll(t) for t in ts]
            for (sp, rep), w in zip(res, wants[rung]):
                assert torch.equal(sp.values["value"], w)
                assert (rep.backend_report["impl"],
                        rep.backend_report["degraded_from"]) == (rung, start)
            stats = sch.stats()
            assert (stats["impl"], stats["degraded_from"],
                    stats["intake_gated"]) == (rung, start, False)
    assert [f["kind"] for f in st.fired] == ["batch_exc"] * len(rungs)
    assert sch.stats()["impl_faults"] == len(rungs)
    if lanes == "grids":
        for i, (sp, _) in enumerate(res):
            np.testing.assert_array_equal(sp.values["value"].numpy(),
                                          oracle_run(i))


def test_substeps_and_compute_dtype_survive_a_rung():
    """The rung's executor keeps ``substeps`` and ``compute_dtype``."""
    sch = EnsembleScheduler(impl="pipeline", substeps=4,
                            compute_dtype=torch.bfloat16, retry="solo",
                            degrade_after=1, max_batch=2)
    with inject.armed(FaultPlan((Fault("batch_exc", at=0),))):
        with pytest.warns(RuntimeWarning, match="degraded to 'xla'"):
            ts = [sch.submit(strip(i), model(), steps=STEPS)
                  for i in range(2)]
            [sch.poll(t) for t in ts]
    assert (sch.executor.impl, sch.executor.substeps,
            sch.executor.compute_dtype) == ("xla", 4, torch.bfloat16)
    assert sch.stats()["substeps"] == 4


# -- the count, the guard ------------------------------------------------------

def test_below_degrade_after_nothing_degrades_and_jax_agrees():
    """``degrade_after=2``: the first fault reaches its tickets with no
    warning and no stamp; the second takes the rung; each further rung
    needs two new faults. JAX's scheduler counts the same."""
    def run(make, sp, armed, plan, mdl):
        sch = make()
        seen = []
        with armed(plan):
            for round_ in range(3):
                with warnings.catch_warnings(record=True) as w:
                    warnings.simplefilter("always")
                    ts = [sch.submit(sp(i), mdl(), steps=STEPS)
                          for i in range(2)]
                    sch.pump(force=True)
                    outcomes = []
                    for t in ts:
                        try:
                            rep = sch.poll(t)[1]
                            outcomes.append(
                                rep.backend_report.get("degraded_from"))
                        except (inject.InjectedFault,
                                jinject.InjectedFault) as e:
                            outcomes.append(type(e).__name__)
                st = sch.stats()
                seen.append((round_, [str(x.message)[:40] for x in w
                                      if issubclass(x.category,
                                                    RuntimeWarning)],
                             outcomes, st["impl"], st["degraded_from"],
                             st["impl_faults"], st["intake_gated"]))
        return seen

    port = run(lambda: EnsembleScheduler(impl="active", max_batch=2),
               space, inject.armed,
               FaultPlan((Fault("batch_exc", at=0), Fault("batch_exc",
                                                          at=1))), model)
    jax_seen = run(lambda: JScheduler(impl="active", max_batch=2,
                                      compile_cache=None),
                   jspace, jinject.armed,
                   jinject.FaultPlan((jinject.Fault("batch_exc", at=0),
                                      jinject.Fault("batch_exc", at=1))),
                   jmodel)
    assert port == jax_seen
    assert port[0][1:] == ([], ["InjectedFault"] * 2, "active", None, 1,
                           False)
    assert port[1][3:] == ("xla", "active", 2, True)
    assert port[2][2:] == (["active", "active"], "xla", "active", 2, False)


def test_a_lane_fault_cleared_solo_feeds_the_ladder():
    """A ``lane_nan`` poison that a solo run clears is evidence of a
    batch-level fault: it counts toward the ladder as in JAX."""
    outs = {}
    for pkg, sch, sp, armed, plan, mdl in (
            ("port", EnsembleScheduler(impl="active", retry="solo",
                                       max_batch=2, degrade_after=1),
             space, inject.armed, FaultPlan((Fault("lane_nan", ticket=0),)),
             model),
            ("jax", JScheduler(impl="active", retry="solo", max_batch=2,
                               degrade_after=1, compile_cache=None),
             jspace, jinject.armed,
             jinject.FaultPlan((jinject.Fault("lane_nan", ticket=0),)),
             jmodel)):
        with armed(plan):
            with pytest.warns(RuntimeWarning, match="degraded to 'xla'"):
                ts = [sch.submit(sp(i), mdl(), steps=STEPS)
                      for i in range(2)]
                res = [sch.poll(t) for t in ts]
        st = sch.stats()
        outs[pkg] = ([r[1].backend_report.get("degraded_from") for r in res],
                     st["impl"], st["impl_faults"], st["recovered_failures"])
    assert outs["port"] == outs["jax"] == ([None, None], "xla", 1, 1)


@pytest.mark.parametrize("retry", ["none", "solo"])
@pytest.mark.parametrize("how", ["direct", "chained"])
def test_a_k6_k7_error_steps_no_rung(monkeypatch, how, retry):
    """``active_fused`` at ``degrade_after=1`` whose K6/K7 runner fails as
    a build or launch failure does (a ``KernelError``, or an error raised
    from one): every ticket gets that error, no warning comes, the engine
    stays ``active_fused`` and the plain ``active`` engine never runs."""
    from mpi_model_tpu_torch.ops import KernelError
    from mpi_model_tpu_torch.ops import active as act
    from mpi_model_tpu_torch.ops import fused_active as fa

    def failing_runner(*args, **kwargs):
        def lane(values, n):
            err = KernelError("fused_compute (K6) kernel launch failed: "
                              "invalid device function (cudaError 98)")
            if how == "direct":
                raise err
            raise RuntimeError("the fused active pass failed") from err
        return lane

    plain = []
    monkeypatch.setattr(fa, "build_fused_runner", failing_runner)
    monkeypatch.setattr(act, "build_active_runner",
                        lambda *a, **k: plain.append(a))
    sch = EnsembleScheduler(impl="active_fused", retry=retry, max_batch=2,
                            degrade_after=1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for _ in range(2):
            ts = [sch.submit(space(i), model(), steps=STEPS)
                  for i in range(2)]
            sch.pump(force=True)
            for t in ts:
                with pytest.raises(RuntimeError, match="fused") as ei:
                    sch.poll(t)
                assert isinstance(ei.value if how == "direct"
                                  else ei.value.__cause__, KernelError)
    per_round = 3 if retry == "solo" else 1
    st = sch.stats()
    assert (st["impl"], st["degraded_from"], st["intake_gated"],
            st["impl_faults"], st["dispatches"]) == (
        "active_fused", None, False, 2 * per_round, 0)
    assert plain == []


def test_stats_read_the_live_ladder_keys():
    sch = EnsembleScheduler(impl="pipeline", degrade_after=1)
    st = sch.stats()
    assert (st["impl"], st["degraded_from"], st["intake_gated"]) == (
        "pipeline", None, False)
    with inject.armed(FaultPlan((Fault("batch_exc", at=0),))):
        with pytest.warns(RuntimeWarning):
            t = sch.submit(strip(0), model(), steps=1)
            sch.pump(force=True)
    with pytest.raises(inject.InjectedFault):
        sch.poll(t)
    st = sch.stats()
    assert (st["impl"], st["degraded_from"], st["intake_gated"]) == (
        "xla", "pipeline", True)
    assert set(st) == set(JScheduler(compile_cache=None).stats())
