"""The serving chaos seams of the port (``resilience/inject.py``) on the
CPU, as the JAX package's ``tests/test_chaos.py`` drives them against its
async loop: ``thread_exc`` (pump), ``slow_compile`` (assemble), ``hang``
and ``batch_exc`` (dispatch), ``lane_nan`` (ensemble), ``fetch_nan``
(fetch) and ``queue_full`` (admission). Each fault resolves to its
documented outcome with every ticket accounted for, and a plan written by
either package arms the same firings, with the same outcomes, in the other.

Every armed plan is disarmed in ``finally`` (the context manager, and the
autouse fixture after a failure), since xdist runs this file's tests one
after another in one worker."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_model_tpu as mm
from mpi_model_tpu.ensemble import AsyncEnsembleService as JAsync
from mpi_model_tpu.resilience import inject as jinject

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch.ensemble import (AsyncEnsembleService,
                                          ServiceOverloaded, run_ensemble)
from mpi_model_tpu_torch.resilience import inject
from mpi_model_tpu_torch.resilience.inject import (Fault, FaultPlan,
                                                   InjectedFault)

BASE = np.random.default_rng(11).uniform(0.5, 2.0, (16, 16))


def raw(i, h=8, w=8):
    return np.roll(BASE, 3 * i, axis=0)[:h, :w].copy()


def scen(i):
    return mt.CellularSpace.create(8, 8, 1.0, dtype="float64",
                                   device="cpu").with_values(
        {"value": torch.from_numpy(raw(i))})


def jscen(i):
    return mm.CellularSpace.create(8, 8, 1.0, dtype=jnp.float64).with_values(
        {"value": jnp.asarray(raw(i))})


def model():
    return mt.Model(mt.Diffusion(0.1), time=4.0, time_step=1.0)


def serial(i, steps=4):
    out, _ = model().execute(scen(i), mt.SerialExecutor("xla"), steps=steps)
    return out.values["value"]


def svc_of(**kw):
    kw.setdefault("steps", 4)
    kw.setdefault("start", False)
    return AsyncEnsembleService(model(), **kw)


def drain(svc):
    while svc.pump_once(force=True):
        pass


@pytest.fixture(autouse=True)
def _disarmed():
    assert inject.active() is None and jinject.active() is None
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
        inject._ACTIVE = None
        jinject._ACTIVE = None


# -- the plan, across both packages -------------------------------------------

def test_fault_plan_is_pure_data_and_seeded_like_jax():
    plan = FaultPlan((Fault("thread_exc", at=2), Fault("halo")), seed=9)
    with pytest.raises(dataclasses.FrozenInstanceError):
        plan.faults[0].at = 3
    jplan = jinject.FaultPlan((jinject.Fault("thread_exc", at=2),
                               jinject.Fault("halo")), seed=9)
    assert [plan.value_for(i) for i in range(3)] == \
        [jplan.value_for(i) for i in range(3)]
    assert plan.value_for(1) != FaultPlan(plan.faults, seed=10).value_for(1)
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault("meteor")
    with pytest.raises(ValueError, match="sticky"):
        Fault("member_wedge", once=False)
    with pytest.raises(RuntimeError, match="already armed"):
        with inject.armed(plan), inject.armed(plan):
            pass


def _to_jax(plan: FaultPlan):
    return jinject.FaultPlan(tuple(jinject.Fault(**dataclasses.asdict(f))
                                   for f in plan.faults), seed=plan.seed)


def _run_matrix(svc, spaces, steps):
    """Two waves through a manually pumped service; every ticket's outcome
    ('ok' or the error's type name)."""
    outcomes = []
    for wave, wsteps in ((range(4), 4), (range(2), steps)):
        tickets = [svc.submit(spaces(i), steps=wsteps) for i in wave]
        drain(svc)
        for t in tickets:
            try:
                svc.poll(t)
                outcomes.append("ok")
            except (InjectedFault, jinject.InjectedFault,
                    mt.EnsembleConservationError,
                    mm.EnsembleConservationError) as e:
                outcomes.append(type(e).__name__)
    svc.stop()
    return outcomes


@pytest.mark.parametrize("written_by", ["port", "jax"])
def test_a_plan_arms_the_same_firings_in_both_packages(written_by):
    """One plan (lane poison, batch fault, hang, slow build, fetch poison)
    written by either package, armed in each: the same firings in the same
    order, the same outcomes and the same counters."""
    # dispatches: 0 = wave 1 (ticket 1 poisoned), 1 = its solo, 2 = wave 2
    # (batch fault), 3 and 4 = wave 2's solos (3: a slow build and a hang
    # under a generous deadline; 4: a fetch poison on a solo, quarantined)
    faults = (Fault("lane_nan", ticket=1, once=True),
              Fault("batch_exc", at=2),
              Fault("hang", at=3, seconds=0.5),
              Fault("slow_compile", at=2, seconds=0.25),
              Fault("fetch_nan", at=3, lane=0))
    plan = FaultPlan(faults, seed=5)
    if written_by == "jax":
        plan = _to_jax(plan)
    clock = {"t": 0.0}
    kw = dict(retry="solo", max_batch=4, dispatch_deadline_s=1e9,
              clock=lambda: clock["t"], steps=4, start=False)
    runs = {}
    for pkg, make, spaces, arm, conv in (
            ("port", lambda: AsyncEnsembleService(model(), **kw), scen,
             inject.armed, lambda p: p),
            ("jax", lambda: JAsync(mm.Model(mm.Diffusion(0.1), 4.0, 1.0),
                                   compile_cache=None, **kw), jscen,
             jinject.armed,
             lambda p: p if isinstance(p, jinject.FaultPlan)
             else _to_jax(p))):
        svc = make()
        with arm(conv(plan)) as st:
            outcomes = _run_matrix(svc, spaces, 3)
        stats = svc.stats()
        runs[pkg] = (st.fired, outcomes,
                     {k: stats[k] for k in (
                         "scenarios", "dispatches", "solo_retries",
                         "recovered_failures", "impl_faults",
                         "quarantined", "pending")})
    assert runs["port"] == runs["jax"]
    fired = [f["kind"] for f in runs["port"][0]]
    assert fired == ["lane_nan", "batch_exc", "slow_compile", "hang",
                     "fetch_nan"]
    assert runs["port"][1] == ["ok"] * 5 + ["EnsembleConservationError"]
    assert runs["port"][2]["quarantined"] == 1


# -- each wired seam ---------------------------------------------------------------

def test_thread_exc_loop_survives_and_serves():
    """An injected dispatch-thread exception: the loop's supervisor counts
    it and keeps serving; every ticket resolves bit for bit."""
    plan = FaultPlan((Fault("thread_exc", at=0),))
    with inject.armed(plan) as st:
        with AsyncEnsembleService(model(), steps=4) as svc:
            tickets = [svc.submit(scen(i)) for i in range(3)]
            outs = [svc.result(t, timeout=120) for t in tickets]
    assert [f["kind"] for f in st.fired] == ["thread_exc"]
    stats = svc.stats()
    assert stats["loop_faults"] == 1 and stats["pending"] == 0
    assert svc.loop_errors and "InjectedFault" in svc.loop_errors[0]
    for i, (sp, _) in enumerate(outs):
        assert torch.equal(sp.values["value"], serial(i))


def test_slow_compile_trips_dispatch_deadline_and_recovers():
    clock = {"t": 0.0}
    svc = svc_of(retry="solo", max_batch=2, dispatch_deadline_s=1.0,
                 clock=lambda: clock["t"])
    plan = FaultPlan((Fault("slow_compile", at=0, seconds=5.0),))
    with inject.armed(plan) as st:
        a = svc.submit(scen(0))
        b = svc.submit(scen(1))
        drain(svc)
        ra, rb = svc.poll(a), svc.poll(b)
    assert [f["kind"] for f in st.fired] == ["slow_compile"]
    assert torch.equal(ra[0].values["value"], serial(0))
    assert torch.equal(rb[0].values["value"], serial(1))
    stats = svc.stats()
    assert stats["recovered_failures"] == 2 and stats["impl_faults"] == 1
    assert any("DispatchTimeout" in d.get("error", "")
               for d in svc.scheduler.dispatch_log)
    svc.stop()


def test_hang_without_retry_raises_timeout_for_every_ticket():
    clock = {"t": 0.0}
    svc = svc_of(retry="none", max_batch=2, dispatch_deadline_s=1.0,
                 clock=lambda: clock["t"])
    plan = FaultPlan((Fault("hang", at=0, seconds=5.0),))
    with inject.armed(plan):
        tickets = [svc.submit(scen(i)) for i in range(2)]
        drain(svc)
        for t in tickets:
            with pytest.raises(mt.ensemble.DispatchTimeout,
                               match="deadline"):
                svc.poll(t)
    assert svc.stats()["dispatches"] == 0
    svc.stop()


@pytest.mark.parametrize("kind", ["fetch_nan", "lane_nan"])
def test_poisoned_lane_is_caught_and_solo_recovered(kind):
    """A poison at the fetch boundary (or in one lane of the launch): per-
    lane conservation flags it, the solo retry (fault consumed) recovers
    the scenario bit for bit, and its batchmate is untouched."""
    svc = svc_of(retry="solo", max_batch=2)
    fault = (Fault("fetch_nan", at=0, lane=0) if kind == "fetch_nan"
             else Fault("lane_nan", ticket=0))
    with inject.armed(FaultPlan((fault,))) as st:
        a = svc.submit(scen(0))
        b = svc.submit(scen(1))
        drain(svc)
        ra, rb = svc.poll(a), svc.poll(b)
    assert [f["kind"] for f in st.fired] == [kind]
    assert torch.equal(ra[0].values["value"], serial(0))
    assert torch.equal(rb[0].values["value"], serial(1))
    stats = svc.stats()
    assert stats["recovered_failures"] == 1 and stats["solo_retries"] == 1
    svc.stop()


def test_sticky_lane_poison_is_quarantined_with_its_event():
    svc = svc_of(retry="solo", max_batch=2)
    with inject.armed(FaultPlan((Fault("lane_nan", ticket=1,
                                       once=False),))):
        a = svc.submit(scen(0))
        b = svc.submit(scen(1))
        drain(svc)
        assert svc.poll(a) is not None
        with pytest.raises(mt.EnsembleConservationError,
                           match="non-finite") as ei:
            svc.poll(b)
    ev = ei.value.failure_event
    assert (ev.kind, ev.ticket, ev.attempt) == ("nonfinite", b, 2)
    assert svc.stats()["quarantined"] == 1
    svc.stop()


def test_direct_lane_fault_poisons_run_ensemble():
    with inject.armed(FaultPlan((Fault("lane_nan", lane=1, at=0),))) as st:
        res = run_ensemble(model(), [scen(0), scen(1)], steps=2,
                           on_violation="mark")
    assert [f["kind"] for f in st.fired] == ["lane_nan"]
    assert not isinstance(res[0], Exception)
    assert isinstance(res[1], mt.EnsembleConservationError)


def test_queue_full_sheds_at_admission():
    svc = svc_of()
    with inject.armed(FaultPlan((Fault("queue_full", at=0),))) as st:
        with pytest.raises(ServiceOverloaded, match="injected"):
            svc.submit(scen(0))
        t = svc.submit(scen(1))
    assert [f["kind"] for f in st.fired] == ["queue_full"]
    assert svc.stats()["shed"] == 1
    svc.stop()
    assert svc.poll(t) is not None


def test_batch_exc_and_hang_resolve_every_ticket():
    """Lane poison, whole-batch fault and hang in one plan against the
    loop: every scenario recovers bit for bit and the ledger reconciles."""
    clock = {"t": 0.0}
    svc = svc_of(retry="solo", max_batch=4, dispatch_deadline_s=1e9,
                 clock=lambda: clock["t"])
    plan = FaultPlan((Fault("lane_nan", ticket=1, once=True),
                      Fault("batch_exc", at=2),
                      Fault("hang", at=3, seconds=0.5)))
    with inject.armed(plan) as st:
        tickets = [svc.submit(scen(i)) for i in range(4)]
        drain(svc)
        outs = [svc.poll(t) for t in tickets]
        wave2 = [svc.submit(scen(i), steps=3) for i in range(2)]
        drain(svc)
        outs2 = [svc.poll(t) for t in wave2]
    fired = [f["kind"] for f in st.fired]
    assert "lane_nan" in fired and "batch_exc" in fired
    for i, (sp, _) in enumerate(outs):
        assert torch.equal(sp.values["value"], serial(i))
    for i, (sp, _) in enumerate(outs2):
        assert torch.equal(sp.values["value"], serial(i, steps=3))
    stats = svc.stats()
    assert stats["scenarios"] == 7 and stats["pending"] == 0
    assert stats["recovered_failures"] >= 1
    assert stats["quarantined"] == 0 and stats["shed"] == 0
    assert stats["expired"] == 0
    svc.stop()


def test_disarmed_seams_fire_nothing():
    svc = svc_of(max_batch=2)
    tickets = [svc.submit(scen(i)) for i in range(2)]
    drain(svc)
    assert all(svc.poll(t) is not None for t in tickets)
    st = svc.stats()
    assert (st["impl_faults"], st["loop_faults"], st["shed"]) == (0, 0, 0)
    svc.stop()
