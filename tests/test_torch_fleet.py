"""The port's fleet supervisor (``ensemble/fleet.py``) on the CPU: a
counterpart of each test of the JAX package's ``tests/test_fleet.py`` that
is not slow (its journal and ``model_meta`` tests have theirs in
``tests/test_torch_journal.py``), and the port held against the JAX
package's fleet on the same numpy-seeded scenarios.

- Fleet-routed results are bit for bit the port's synchronous service at
  f64, whatever member served them; routing, shedding, fencing, respawn,
  autoscaling and crash-restart recovery run as JAX's do, on the
  injectable clock, with no wall sleeps.
- Against JAX's ``FleetSupervisor``: the two packages compute the same
  expressions in the same order, and XLA on the CPU contracts
  ``v - rate*v`` into a multiply-add (``tests/test_torch_ensemble.py``).
  With rates that are powers of two the product is exact, the contraction
  changes nothing, and the two fleets' results are bit for bit; with other
  rates they agree within ``2·eps64·steps·max|v|``.
- A fleet journal written by either package is recovered by the other:
  every ticket resolves, the results are bit for bit, and both packages'
  audits are clean.

The tiering test (``test_fleet.py:866``) has its counterpart here; the
rest of the fleet's paging is ``tests/test_torch_tiering.py``'s. Waiting
for later slices (ROADMAP.md): the bench and ladder rows (``:617``,
``:634``) and the analysis one (``:673``).
"""

import functools
import json
import os
import threading
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_model_tpu as mm
from mpi_model_tpu.ensemble import FleetSupervisor as JFleet
from mpi_model_tpu.ensemble.journal import audit_journal as jaudit
from mpi_model_tpu.ensemble.journal import journal_path as jjournal_path

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch.ensemble import (
    AsyncEnsembleService, AutoscalePolicy, EnsembleService,
    FleetSupervisor, MemberFailure, ServiceOverloaded, TicketExpired,
    TicketNotMigratable, run_soak)
from mpi_model_tpu_torch.ensemble.journal import (audit_journal,
                                                  journal_path, replay)
from mpi_model_tpu_torch.ensemble.member_proc import spawn_loopback_member
from mpi_model_tpu_torch.resilience import inject, lockdep
from mpi_model_tpu_torch.resilience.inject import Fault, FaultPlan

EPS64 = 2.0 ** -52
BASE = np.random.default_rng(31).uniform(0.5, 2.0, (16, 16))

loopback = functools.partial(spawn_loopback_member, device="cpu")


def raw(i, g=16):
    return np.roll(BASE, 3 * i, axis=0)[:g, :g].copy()


def scen_space(i, g=16):
    return mt.CellularSpace.create(g, g, 1.0, dtype="float64",
                                   device="cpu").with_values(
        {"value": torch.from_numpy(raw(i, g))})


def scen_model(i=0):
    return mt.Model(mt.Diffusion(0.05 + 0.01 * i), 4.0, 1.0)


def jscen_space(i, g=16):
    return mm.CellularSpace.create(g, g, 1.0, dtype=jnp.float64).with_values(
        {"value": jnp.asarray(raw(i, g))})


def manual_fleet(model=None, **kw):
    kw.setdefault("services", 2)
    kw.setdefault("steps", 4)
    kw.setdefault("device", "cpu")
    return FleetSupervisor(model or scen_model(), start=False, **kw)


@pytest.fixture(autouse=True)
def _one_thread_and_no_plan():
    """One intra-op thread (steady under xdist), and no fault plan or
    witness left armed by a failing test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
        inject._ACTIVE = None
        lockdep._ACTIVE = None


def _values(space) -> np.ndarray:
    v = space.values["value"]
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# -- the f64 gate: fleet == sync, bit for bit ---------------------------------

@pytest.mark.parametrize("transport", ["inproc", "process"])
def test_fleet_routed_results_bitwise_equal_sync_f64(transport):
    """The same scenarios through a 3-member fleet and one synchronous
    service: every served state bit for bit at f64, whatever member
    served it (process members over the loopback wire: each state crosses
    it twice)."""
    model = scen_model()
    spaces = [scen_space(i) for i in range(6)]
    models = [scen_model(i) for i in range(6)]
    sync = EnsembleService(model, steps=4)
    ts = [sync.submit(spaces[i], model=models[i]) for i in range(6)]
    sync.flush()
    want = [sync.result(t)[0] for t in ts]
    kw = ({} if transport == "inproc"
          else dict(member_transport="process", member_spawner=loopback))
    fleet = manual_fleet(model, services=3, **kw)
    fa = [fleet.submit(spaces[i], model=models[i]) for i in range(6)]
    got = [fleet.result(t) for t in fa]
    for i in range(6):
        assert torch.equal(got[i][0].values["value"],
                           want[i].values["value"])
    st = fleet.stats()
    assert st["scenarios"] == 6 and st["pending"] == 0
    assert st["members"] == 3 and st["fleet"] is True
    assert st["member_transport"] == transport
    fleet.stop()


@pytest.mark.parametrize("rates,exact", [
    ((0.0625, 0.125, 0.25), True),
    ((0.05, 0.06, 0.07), False)], ids=["dyadic", "decimal"])
def test_port_fleet_equals_jax_fleet_f64(rates, exact):
    """The same numpy-seeded scenarios through JAX's fleet and the port's,
    3 members each, at f64: bit for bit where the rate's product is exact
    (module docstring), else within ``2·eps64·steps·max|v|``; the same
    ledger."""
    n = 6
    jf = JFleet(mm.Model(mm.Diffusion(rates[0]), 4.0, 1.0), services=3,
                steps=4, start=False)
    jt = [jf.submit(jscen_space(i),
                    model=mm.Model(mm.Diffusion(rates[i % 3]), 4.0, 1.0))
          for i in range(n)]
    jgot = [jf.result(t) for t in jt]
    jst = jf.stats()
    jf.stop()
    tf = manual_fleet(mt.Model(mt.Diffusion(rates[0]), 4.0, 1.0),
                      services=3)
    tt = [tf.submit(scen_space(i),
                    model=mt.Model(mt.Diffusion(rates[i % 3]), 4.0, 1.0))
          for i in range(n)]
    tgot = [tf.result(t) for t in tt]
    tst = tf.stats()
    tf.stop()
    for (ts_, trep), (js_, jrep) in zip(tgot, jgot):
        got, want = _values(ts_), _values(js_)
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= \
                2 * EPS64 * 4 * np.abs(want).max()
        assert trep.steps == jrep.steps == 4
        assert trep.final_total["value"] == pytest.approx(
            jrep.final_total["value"], abs=1e-12)
    for k in ("scenarios", "pending", "members", "shed", "member_faults",
              "readmitted", "member_transport"):
        assert tst[k] == jst[k], k


def test_fleet_stats_keys_are_jax_keys():
    tf = manual_fleet()
    tf.result(tf.submit(scen_space(0)))
    jf = JFleet(mm.Model(mm.Diffusion(0.05), 4.0, 1.0), services=2,
                steps=4, start=False)
    jf.result(jf.submit(jscen_space(0)))
    tst, jst = tf.stats(), jf.stats()
    tf.stop(), jf.stop()
    assert set(jst) <= set(tst)
    assert set(jst["services"][0]) <= set(tst["services"][0])


# -- routing ------------------------------------------------------------------

def test_structure_affinity_keeps_one_group_on_one_member():
    fleet = manual_fleet(services=3, max_wait_s=1e9, max_batch=8)
    for i in range(5):
        fleet.submit(scen_space(i))
    depths = sorted(s["pending"] for s in fleet.stats()["services"])
    assert depths == [0, 0, 5]
    fleet.stop()


def test_routing_reroutes_before_shedding():
    fleet = manual_fleet(services=2, max_queue=2, max_wait_s=1e9,
                         max_batch=8)
    tickets = [fleet.submit(scen_space(0)) for _ in range(4)]
    assert len(tickets) == 4
    depths = sorted(s["pending"] for s in fleet.stats()["services"])
    assert depths == [2, 2]
    assert fleet.stats()["shed"] == 0
    fleet.stop()


def test_fleet_sheds_only_when_every_member_refuses():
    fleet = manual_fleet(services=2, max_queue=1, max_wait_s=1e9,
                         max_batch=8)
    fleet.submit(scen_space(0))
    fleet.submit(scen_space(1))
    with pytest.raises(ServiceOverloaded, match="every member") as ei:
        fleet.submit(scen_space(2))
    assert ei.value.queue_depth == 2
    assert fleet.stats()["shed"] == 1
    fleet.stop()


def test_injected_queue_full_on_one_member_reroutes():
    fleet = manual_fleet(services=2)
    with inject.armed(FaultPlan((Fault("queue_full"),))) as st:
        t = fleet.submit(scen_space(0))
    assert st.fired and st.fired[0]["kind"] == "queue_full"
    assert fleet.result(t) is not None
    assert fleet.stats()["shed"] == 0
    fleet.stop()


# -- migrate against a pump ---------------------------------------------------

def test_migrate_mid_launch_reports_not_migratable():
    model = scen_model()
    src = AsyncEnsembleService(model, steps=4, start=False)
    dst = AsyncEnsembleService(model, steps=4, start=False)
    t = src.submit(scen_space(0))
    src.pump_once()
    with pytest.raises(TicketNotMigratable, match="claimed/launched"):
        src.scheduler.migrate_ticket(t, dst.scheduler)
    src.pump_once()
    assert src.poll(t) is not None
    assert src.scheduler.migrated_out == 0
    assert dst.scheduler.pending_count() == 0
    src.stop()
    dst.stop()


def test_migrate_queued_ticket_still_works():
    model = scen_model()
    src = AsyncEnsembleService(model, steps=4, start=False,
                               max_wait_s=1e9, max_batch=8)
    dst = AsyncEnsembleService(model, steps=4, start=False)
    t = src.submit(scen_space(0))
    nt = src.scheduler.migrate_ticket(t, dst.scheduler)
    with pytest.raises(KeyError):
        src.poll(t)
    while dst.pump_once(force=True):
        pass
    assert dst.poll(nt) is not None
    src.stop()
    dst.stop()


def test_service_id_stamped_into_stats_reports_and_events():
    clock = {"t": 0.0}
    model = scen_model()
    svc = AsyncEnsembleService(model, steps=4, service_id="m7g0",
                               deadline_s=1.0, max_wait_s=1e9,
                               max_batch=8, clock=lambda: clock["t"],
                               start=False)
    assert svc.stats()["service_id"] == "m7g0"
    t = svc.submit(scen_space(0))
    clock["t"] = 2.0
    svc.pump_once()
    with pytest.raises(TicketExpired):
        svc.poll(t)
    assert svc.scheduler.expired_log[-1].service_id == "m7g0"
    svc.stop()
    svc2 = AsyncEnsembleService(model, steps=4, service_id="m8g1",
                                start=False)
    t2 = svc2.submit(scen_space(1))
    while svc2.pump_once(force=True):
        pass
    _, rep = svc2.poll(t2)
    assert rep.backend_report["service_id"] == "m8g1"
    svc2.stop()
    svc3 = AsyncEnsembleService(model, steps=4, service_id="m9g0",
                                retry="solo", start=False)
    plan = FaultPlan((Fault("lane_nan", ticket=0, once=False),))
    with inject.armed(plan):
        t3 = svc3.submit(scen_space(2))
        while svc3.pump_once(force=True):
            pass
        with pytest.raises(Exception):
            svc3.poll(t3)
    assert svc3.scheduler.quarantine_log[-1].service_id == "m9g0"
    svc3.stop()


# -- the pump's member seams ----------------------------------------------------

def test_member_kill_seam_kills_the_pump_thread_only():
    """``member_kill`` raises ``MemberKilled`` at the top of the targeted
    service's pump (another service's pump is untouched); on a thread the
    loop dies without draining."""
    other = AsyncEnsembleService(scen_model(), steps=4, start=False,
                                 service_id="m1g0")
    victim = AsyncEnsembleService(scen_model(), steps=4, start=False,
                                  service_id="m0g0")
    plan = FaultPlan((Fault("member_kill", channel="m0g0"),))
    with inject.armed(plan) as st:
        t = other.submit(scen_space(0))
        assert other.pump_once(force=True) in (True, False)
        with pytest.raises(inject.MemberKilled, match="m0g0"):
            victim.pump_once()
    assert [f["kind"] for f in st.fired] == ["member_kill"]
    other.stop()
    assert other.poll(t) is not None
    threaded = AsyncEnsembleService(scen_model(), steps=4,
                                    service_id="m2g0", max_wait_s=1e9,
                                    max_batch=8)
    with inject.armed(FaultPlan((Fault("member_kill", channel="m2g0"),))):
        threaded.submit(scen_space(1))
        threaded._thread.join(timeout=30)
    assert not threaded.is_alive()
    assert threaded.scheduler.pending_count() == 1   # no drain
    threaded.abandon()


def test_member_wedge_seam_makes_no_progress():
    svc = AsyncEnsembleService(scen_model(), steps=4, start=False,
                               service_id="m0g0")
    t = svc.submit(scen_space(0))
    with inject.armed(FaultPlan((Fault("member_wedge", channel="m0g0",
                                       once=False),))) as st:
        for _ in range(3):
            assert svc.pump_once(force=True) is False
        assert svc.poll(t) is None and svc.has_work_due()
    assert len(st.fired) == 3
    svc.stop()
    assert svc.poll(t) is not None


# -- failure-domain isolation -------------------------------------------------

@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_member_kill_fences_restarts_and_serves_everything(pkg):
    """JAX's row, in both packages: the same kill, the same fence and
    respawn, the same ledger."""
    if pkg == "jax":
        from mpi_model_tpu.resilience import inject as inj

        fleet = JFleet(mm.Model(mm.Diffusion(0.05), 4.0, 1.0), services=2,
                       steps=4, start=False)
        space = jscen_space
    else:
        inj, fleet, space = inject, manual_fleet(services=2), scen_space
    tickets = [fleet.submit(space(i)) for i in range(6)]
    victim = fleet.stats()["services"][0]["service_id"]
    plan = inj.FaultPlan((inj.Fault("member_kill", channel=victim),))
    with inj.armed(plan), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        res = [fleet.result(t) for t in tickets]
    assert len(res) == 6
    st = fleet.stats()
    assert st["member_faults"] == 1 and st["pending"] == 0
    sids = {s["service_id"] for s in st["services"]}
    assert victim not in sids
    assert any(s["gen"] == 1 for s in st["services"])
    assert st["respawns"] == 1
    ev = fleet.member_log[0]
    assert ev.kind == "member" and ev.service_id == victim
    assert "died" in ev.detail
    fleet.stop()


def test_member_kill_readmits_launched_tickets():
    fleet = manual_fleet(services=2, max_wait_s=1e9, max_batch=8)
    tickets = [fleet.submit(scen_space(0)) for _ in range(3)]
    loaded = next(s for s in fleet.stats()["services"]
                  if s["pending"] == 3)
    victim = loaded["service_id"]
    fleet.pump_once(force=True)
    plan = FaultPlan((Fault("member_kill", channel=victim),))
    with inject.armed(plan), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        res = [fleet.result(t) for t in tickets]
    assert len(res) == 3
    st = fleet.stats()
    assert st["member_faults"] == 1
    assert st["readmitted"] == 3
    fleet.stop()


def test_member_wedge_fenced_after_supervision_deadline():
    clock = {"t": 0.0}
    fleet = manual_fleet(services=2, supervision_deadline_s=1.0,
                         clock=lambda: clock["t"])
    tickets = [fleet.submit(scen_space(i)) for i in range(4)]
    victim = next(s["service_id"] for s in fleet.stats()["services"]
                  if s["pending"] > 0)
    plan = FaultPlan((Fault("member_wedge", channel=victim, once=False),))
    with inject.armed(plan), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        fleet.pump_once()
        clock["t"] = 2.0
        fleet.pump_once()
        res = [fleet.result(t) for t in tickets]
    assert len(res) == 4
    st = fleet.stats()
    assert st["member_faults"] == 1 and st["pending"] == 0
    assert any("wedged" in e.detail for e in fleet.member_log)
    fleet.stop()


def test_ladder_bottom_member_drains_out_and_replacement_is_fresh():
    fleet = manual_fleet(services=1, impl="active", retry="none",
                         degrade_after=1, max_wait_s=1e9, max_batch=2)
    a = fleet.submit(scen_space(0))
    b = fleet.submit(scen_space(1))
    plan = FaultPlan((Fault("batch_exc", at=0),))
    with inject.armed(plan), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        fleet.pump_once(force=True)
        fleet.pump_once(force=True)
    for t in (a, b):
        with pytest.raises(inject.InjectedFault):
            fleet.poll(t)
    st = fleet.stats()
    assert st["member_faults"] == 1
    assert st["members"] == 1
    assert st["services"][0]["impl"] == "active"
    assert st["services"][0]["gen"] == 0
    assert st["services"][0]["slot"] == 1
    assert st["scale_downs"] == 0
    assert any("ladder bottomed" in e.detail for e in fleet.member_log)
    assert st["impl_faults"] >= 1
    c = fleet.submit(scen_space(2))
    assert fleet.result(c) is not None
    fleet.stop()


# -- autoscaling --------------------------------------------------------------

def test_autoscale_up_has_hysteresis_and_cooldown():
    pol = AutoscalePolicy(min_services=1, max_services=3, depth_high=0.5,
                          scale_up_after=2, cooldown_ticks=2)
    fleet = manual_fleet(services=1, policy=pol, max_queue=4,
                         max_wait_s=1e9, max_batch=8)
    for i in range(3):
        fleet.submit(scen_space(i))
    fleet.tick()
    assert fleet.stats()["members"] == 1
    fleet.tick()
    st = fleet.stats()
    assert st["members"] == 2 and st["scale_ups"] == 1
    fleet.tick()
    assert fleet.stats()["members"] == 2
    for _ in range(8):
        fleet.pump_once(force=True)
    fleet.stop()


def test_autoscale_drain_before_retire_loses_nothing():
    pol = AutoscalePolicy(min_services=1, max_services=2, depth_low=0.9,
                          scale_down_after=2, cooldown_ticks=0)
    fleet = manual_fleet(services=2, policy=pol, max_wait_s=1e9,
                         max_batch=8)
    ta = [fleet.submit(scen_space(i)) for i in range(3)]
    tb = [fleet.submit(scen_space(i), steps=3) for i in range(2)]
    before = {s["service_id"] for s in fleet.stats()["services"]}
    fleet.tick()
    fleet.tick()
    st = fleet.stats()
    retiring = [s for s in st["services"] if s["retiring"]]
    assert len(retiring) == 1
    res = [fleet.result(t) for t in ta + tb]
    assert len(res) == 5
    for _ in range(3):
        fleet.tick()
    st = fleet.stats()
    assert st["members"] == 1 and st["scale_downs"] == 1
    assert {s["service_id"] for s in st["services"]} < before
    assert st["pending"] == 0
    fleet.stop()


# -- crash-restart recovery ---------------------------------------------------

def test_recover_readmits_unresolved_and_completes_ledger(tmp_path):
    model = scen_model()
    sync = EnsembleService(model, steps=4)
    ts = [sync.submit(scen_space(i)) for i in range(4)]
    sync.flush()
    want = [sync.result(t)[0] for t in ts]
    fleet = manual_fleet(model, journal_dir=str(tmp_path))
    tickets = [fleet.submit(scen_space(i)) for i in range(4)]
    fleet.pump_once(force=True)
    fleet.abandon()
    f2 = FleetSupervisor.recover(str(tmp_path), model, services=2,
                                 steps=4, start=False, device="cpu")
    res = [f2.result(t) for t in tickets]
    for i in range(4):
        assert torch.equal(res[i][0].values["value"],
                           want[i].values["value"])
        assert res[i][0].values["value"].device.type == "cpu"
    f2.stop()
    state = replay(journal_path(str(tmp_path)))
    assert state.unresolved() == []
    assert state.duplicate_terminals == []


def test_recover_served_unacknowledged_without_rerun(tmp_path):
    model = scen_model()
    fleet = manual_fleet(model, journal_dir=str(tmp_path))
    t = fleet.submit(scen_space(1))
    while fleet.stats()["pending"]:
        fleet.pump_once(force=True)
    fleet.abandon()
    f2 = FleetSupervisor.recover(str(tmp_path), model, services=2,
                                 steps=4, start=False, device="cpu")
    space, rep = f2.result(t)
    assert rep.backend_report["recovered_from_journal"] is True
    assert f2.stats()["scenarios"] == 0
    assert f2.stats()["readmitted"] == 0
    assert rep.initial_total and rep.final_total
    f2.stop()


def test_recover_twice_is_idempotent(tmp_path):
    model = scen_model()
    fleet = manual_fleet(model, journal_dir=str(tmp_path))
    tickets = [fleet.submit(scen_space(i)) for i in range(3)]
    fleet.abandon()
    f2 = FleetSupervisor.recover(str(tmp_path), model, services=2,
                                 steps=4, start=False, device="cpu")
    assert f2.stats()["readmitted"] == 3
    for t in tickets:
        assert f2.result(t) is not None
    f2.stop()
    f3 = FleetSupervisor.recover(str(tmp_path), model, services=2,
                                 steps=4, start=False, device="cpu")
    assert f3.stats()["readmitted"] == 0
    assert f3.stats()["pending"] == 0
    f3.stop()


def test_recover_reconstructs_failure_outcomes(tmp_path):
    clock = {"t": 0.0}
    model = scen_model()
    fleet = manual_fleet(model, journal_dir=str(tmp_path),
                         deadline_s=1.0, retry="solo", max_wait_s=1e9,
                         max_batch=8, clock=lambda: clock["t"])
    texp = fleet.submit(scen_space(0))
    clock["t"] = 5.0
    fleet.tick()
    with inject.armed(FaultPlan(
            (Fault("lane_nan", lane=0, once=False),))):
        tq = fleet.submit(scen_space(1))
        while fleet.stats()["pending"]:
            fleet.pump_once(force=True)
    fleet.abandon()
    f2 = FleetSupervisor.recover(str(tmp_path), model, services=2,
                                 steps=4, start=False, device="cpu")
    with pytest.raises(TicketExpired):
        f2.result(texp)
    with pytest.raises(RuntimeError, match="quarantined before restart"):
        f2.result(tq)
    assert f2.stats()["readmitted"] == 0
    f2.stop()


def test_recover_without_result_journaling_resolves_served_as_error(
        tmp_path):
    model = scen_model()
    fleet = manual_fleet(model, journal_dir=str(tmp_path),
                         journal_results=False)
    t = fleet.submit(scen_space(0))
    while fleet.stats()["pending"]:
        fleet.pump_once(force=True)
    fleet.abandon()
    f2 = FleetSupervisor.recover(str(tmp_path), model, services=2,
                                 steps=4, start=False, device="cpu")
    with pytest.raises(MemberFailure, match="journal_results=False"):
        f2.result(t)
    assert f2.stats()["scenarios"] == 0
    f2.stop()


# -- the journal across the packages --------------------------------------------

DYADIC = (0.0625, 0.125)


def _jfleet(jdir, **kw):
    return JFleet(mm.Model(mm.Diffusion(DYADIC[0]), 4.0, 1.0), services=2,
                  steps=4, start=False, journal_dir=jdir, **kw)


def _tfleet(jdir, **kw):
    return manual_fleet(mt.Model(mt.Diffusion(DYADIC[0]), 4.0, 1.0),
                        journal_dir=jdir, **kw)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_recovers_the_others_fleet_journal(tmp_path, writer):
    """A fleet of one package serves one ticket, journals three more and
    is abandoned mid-run (one launched, two queued); the other package's
    ``recover`` resolves every ticket: the served one from the journal, the
    rest re-run, bit for bit the writer's own uninterrupted results (rates
    that are powers of two: module docstring). Both audits are clean."""
    jdir = str(tmp_path / "j")
    n = 4

    def models(pkg, i):
        lib = mm if pkg == "jax" else mt
        return lib.Model(lib.Diffusion(DYADIC[i % 2]), 4.0, 1.0)

    def spaces(pkg, i):
        return jscen_space(i) if pkg == "jax" else scen_space(i)

    make = _jfleet if writer == "jax" else _tfleet
    ref = make(str(tmp_path / "ref"))
    want = [_values(ref.result(ref.submit(spaces(writer, i),
                                          model=models(writer, i)))[0])
            for i in range(n)]
    ref.stop()
    fleet = make(jdir, max_wait_s=1e9, max_batch=8)
    first = fleet.submit(spaces(writer, 0), model=models(writer, 0))
    fleet.result(first)
    tickets = [first] + [fleet.submit(spaces(writer, i),
                                      model=models(writer, i))
                         for i in range(1, n)]
    fleet.pump_once(force=True)       # one batch launches
    fleet.abandon()                   # the crash: nothing harvested
    reader = "torch" if writer == "jax" else "jax"
    if reader == "torch":
        f2 = FleetSupervisor.recover(
            jdir, models("torch", 0), services=2, steps=4, start=False,
            device="cpu")
    else:
        f2 = JFleet.recover(jdir, models("jax", 0), services=2, steps=4,
                            start=False)
    got = [_values(f2.result(t)[0]) for t in tickets]
    f2.stop()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ours = audit_journal(journal_path(jdir))
    theirs = jaudit(jjournal_path(jdir))
    for aud in (ours, theirs):
        assert aud["ok"] and not aud["unresolved"], aud
        assert not aud["duplicate_terminals"] and aud["submits"] == n


# -- the soak surface ---------------------------------------------------------

def test_run_soak_fleet_ledger_complete_on_fake_clock():
    """The open-loop soak through a fleet with the witness armed against
    the port's static lock graph: no violation, and every edge the port's
    fleet shows lies in that graph."""
    from mpi_model_tpu_torch.analysis.concurrency import static_lock_graph

    clock = {"t": 0.0}

    def fake_sleep(dt):
        clock["t"] += dt

    model = scen_model()
    with lockdep.armed(allowed=static_lock_graph()) as witness:
        fleet = manual_fleet(model, services=2, steps=2, max_queue=3,
                             clock=lambda: clock["t"])
        scen = [(scen_space(i % 3), None, None) for i in range(8)]
        rep = run_soak(fleet, scen, arrival_rate_hz=1000.0,
                       clock=lambda: clock["t"], sleep=fake_sleep)
        fleet.stop()
    assert witness.edges, "the witness saw no acquisitions"
    witness.assert_clean()
    assert ("FleetSupervisor._cv", "EnsembleScheduler._lock") \
        in witness.edges
    assert rep["offered"] == 8
    assert rep["ledger_complete"] is True
    assert len(rep["services"]) == 2
    assert {"member_faults", "readmitted", "scale_ups",
            "scale_downs"} <= set(rep)


def test_fleet_stats_has_the_full_serving_surface():
    fleet = manual_fleet()
    t = fleet.submit(scen_space(0))
    fleet.result(t)
    st = fleet.stats()
    for k in ("dispatches", "scenarios", "scenarios_per_s",
              "batch_occupancy", "compile_cache_hit_rate", "busy_s",
              "inflight_s", "solo_retries", "recovered_failures",
              "quarantined", "shed", "expired", "loop_faults",
              "latency_p50_s", "latency_p99_s", "pending",
              "degraded_from", "intake_gated", "services", "journal"):
        assert k in st, k
    assert st["latency_n"] == 1
    fleet.stop()


def test_fleet_constructor_validation():
    with pytest.raises(ValueError, match="services=0"):
        FleetSupervisor(scen_model(), services=0, start=False,
                        device="cpu")
    with pytest.raises(ValueError, match="max_services"):
        FleetSupervisor(scen_model(), services=5, start=False,
                        policy=AutoscalePolicy(max_services=2),
                        device="cpu")
    with pytest.raises(ValueError, match="min_services"):
        AutoscalePolicy(min_services=3, max_services=2)


@pytest.mark.parametrize("kw", [
    dict(member_transport="tcp", mesh=2),
    dict(residency_budget=1, hibernate_dir="vault", mesh=2),
    dict(hibernate_budget=4, mesh=2),
    dict(mesh=2),
], ids=["tcp", "tiering", "hibernate_budget", "mesh"])
def test_unported_fleet_options_name_the_roadmap(kw, tmp_path):
    """The mesh was the fleet's last unported option. Now each member gets
    it as a member kwarg, beside the TCP transport and the tiering options:
    an in-process member's mesh resolves over the fleet's device and
    ``stats()`` names it per member; a wire member's crosses as its extents
    (here through the loopback, which resolves them as a child does).
    Inside a ``torch.distributed`` world above one process (the
    multi-process layer) the fleet's rank is the world's."""
    import torch.distributed as dist

    from mpi_model_tpu_torch.parallel import multihost

    kw = dict(kw)
    if kw.get("hibernate_dir") is not None:
        kw["hibernate_dir"] = str(tmp_path / "vault")
    if kw.get("member_transport") == "tcp":
        kw["member_spawner"] = spawn_loopback_member
    fleet = FleetSupervisor(scen_model(), start=False, device="cpu",
                            services=1, steps=4, **kw)
    try:
        t = fleet.submit(scen_space(0))
        sp, _ = fleet.result(t, timeout=60)
        want, _ = scen_model().execute(scen_space(0), mt.SerialExecutor(),
                                       steps=4)
        assert torch.equal(sp.values["value"], want.values["value"])
        assert fleet.stats()["services"][0]["mesh"] == {
            "batch": 2, "space": 1, "devices": 2}
    finally:
        fleet.stop()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dist, "is_available", lambda: True)
        mp.setattr(dist, "is_initialized", lambda: True)
        mp.setattr(dist, "get_world_size", lambda *a, **k: 2)
        mp.setattr(dist, "get_rank", lambda *a, **k: 1)
        assert multihost.process_index() == 1
        assert not multihost.is_master()


def test_fleet_defaults_to_the_card():
    """The fleet is an entry point: with no ``device`` it serves on the card,
    and on a machine without one it says so."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetSupervisor(scen_model(), start=False)


# -- the CLI ------------------------------------------------------------------

def test_cli_serve_services_json(capsys):
    from mpi_model_tpu_torch.cli import main as cli_main

    rc = cli_main(["run", "--dimx=16", "--dimy=16", "--flow=diffusion",
                   "--steps=2", "--serve", "--serve-scenarios=6",
                   "--serve-services=2", "--json", "--device=cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert out["services"] == 2
    assert out["served"] == 6 and out["ledger_complete"] is True
    assert len(out["members"]) == 2
    assert {m["service_id"] for m in out["members"]} == {"m0g0", "m1g0"}
    assert sum(m["scenarios"] for m in out["members"]) == 6


def test_cli_serve_transport_tcp_json(monkeypatch, capsys, tmp_path):
    """``--serve-transport=tcp`` builds the fleet's TCP spawner
    (``spawn_process_member(transport="tcp", host="127.0.0.1")``); here it
    stands in a loopback member that records what it was asked for, so the
    row's wire ledger and the paging ledger of a tiered fleet come back on
    the CPU without a child."""
    from mpi_model_tpu_torch.cli import main as cli_main
    from mpi_model_tpu_torch.ensemble import fleet as fleet_mod

    asked = []

    def fake_spawn(model, *, transport="unix", host="127.0.0.1", **kw):
        asked.append((transport, host, kw["heartbeat_deadline_s"],
                      kw["rpc_deadline_s"]))
        kw.pop("device", None)
        kw.pop("python", None)
        return spawn_loopback_member(model, device="cpu", **kw)

    monkeypatch.setattr(fleet_mod, "spawn_process_member", fake_spawn)
    rc = cli_main(["run", "--dimx=16", "--dimy=16", "--flow=diffusion",
                   "--steps=2", "--serve", "--serve-scenarios=6",
                   "--serve-transport=tcp", "--serve-services=2",
                   "--residency-budget=1",
                   f"--hibernate-dir={tmp_path / 'v'}",
                   "--json", "--device=cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert asked == [("tcp", "127.0.0.1", 5.0, 60.0)] * 2
    assert out["transport"] == "tcp" and out["services"] == 2
    assert out["served"] == 6 and out["ledger_complete"] is True
    assert out["wire_bytes_in"] > 0 and out["wire_bytes_out"] > 0
    assert out["hibernations"] >= 1 and out["residency_budget"] == 1
    assert sum(out["wakes_by_member"].values()) == out["wakes"]


@pytest.mark.parametrize("argv,match", [
    (["run", "--serve", "--serve-services=0"], "serve-services"),
    (["run", "--serve-services=3"], "serving loop"),
    (["run", "--serve-transport=process"], "serving loop"),
    (["run", "--serve-member-env=A=1"], "serving loop"),
    (["run", "--serve", "--serve-member-env=A=1"], "serve-transport"),
    (["run", "--serve", "--serve-transport=process",
      "--serve-member-env=A"], "KEY=VAL"),
])
def test_cli_serve_services_validation(argv, match):
    from mpi_model_tpu_torch.cli import main as cli_main

    with pytest.raises(SystemExit, match=match):
        cli_main(argv + ["--device=cpu"])


# -- supervision details ------------------------------------------------------

def test_member_not_fenced_while_waiting_out_batching_policy():
    clock = {"t": 0.0}
    fleet = manual_fleet(services=1, supervision_deadline_s=1.0,
                         max_wait_s=100.0, max_batch=8,
                         clock=lambda: clock["t"])
    t = fleet.submit(scen_space(0))
    clock["t"] = 50.0
    fleet.pump_once()
    assert fleet.stats()["member_faults"] == 0
    clock["t"] = 150.0
    fleet.pump_once()
    assert fleet.result(t) is not None
    assert fleet.stats()["member_faults"] == 0
    fleet.stop()


def test_member_fault_constructor_guards_and_at_threshold():
    with pytest.raises(ValueError, match="pin its member"):
        Fault("member_wedge", once=False)
    Fault("member_wedge", once=False, channel="m0g0")
    Fault("member_wedge")
    fleet = manual_fleet(services=2, max_wait_s=1e9, max_batch=8)
    tickets = [fleet.submit(scen_space(i)) for i in range(4)]
    with inject.armed(FaultPlan(
            (Fault("member_kill", at=3),))) as st, \
            warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        fleet.pump_once()
        assert not st.fired
        res = [fleet.result(t) for t in tickets]
    assert len(res) == 4
    assert [f["kind"] for f in st.fired] == ["member_kill"]
    assert fleet.stats()["member_faults"] == 1
    fleet.stop()


def test_fenced_member_counters_still_count_in_fleet_stats():
    fleet = manual_fleet(services=2)
    t = fleet.submit(scen_space(0))
    assert fleet.result(t) is not None
    before = fleet.stats()
    assert before["scenarios"] == 1 and before["dispatches"] >= 1
    victim = next(s["service_id"] for s in before["services"]
                  if s["scenarios"] == 1)
    with inject.armed(FaultPlan(
            (Fault("member_kill", channel=victim),))), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        fleet.pump_once()
    st = fleet.stats()
    assert st["member_faults"] == 1
    assert st["scenarios"] == 1
    assert st["dispatches"] == before["dispatches"]
    assert st["busy_s"] == pytest.approx(before["busy_s"])
    fleet.stop()


def test_abandoned_member_loop_exits_without_draining():
    model = scen_model()
    svc = AsyncEnsembleService(model, steps=4, start=False,
                               max_wait_s=1e9, max_batch=8)
    t = svc.submit(scen_space(0))
    svc.abandon()
    svc._loop()
    assert svc.scheduler.pending_count() == 1
    assert svc.poll(t) is None
    with pytest.raises(RuntimeError, match="abandoned"):
        svc.start()


def test_fence_records_and_dumps_the_flight_ring():
    """A fence lands a ``fence`` record and a dump of the ring beside its
    FailureEvent; the replacement a ``respawn`` record (JAX's names)."""
    from mpi_model_tpu_torch.obs.flight import FlightRecorder, set_recorder

    rec = FlightRecorder()
    prev = set_recorder(rec)
    try:
        fleet = manual_fleet(services=2)
        victim = fleet.stats()["services"][0]["service_id"]
        with inject.armed(FaultPlan((Fault("member_kill",
                                           channel=victim),))), \
                warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            fleet.pump_once()
        fleet.stop()
        kinds = [e["kind"] for e in rec.snapshot(victim)]
        assert "fence" in kinds
        assert any(e["kind"] == "respawn"
                   for e in rec.snapshot(f"m{victim[1]}g1"))
        assert [d["reason"] for d in rec.dump_ledger()] == ["fence"]
    finally:
        set_recorder(prev)


# -- spawns outside the fleet lock --------------------------------------------

def test_admissions_proceed_during_a_slow_respawn():
    spawn_blocked = threading.Event()
    release_spawn = threading.Event()

    def gated_spawner(model, *, service_id, **kw):
        if service_id.endswith("g1"):
            spawn_blocked.set()
            assert release_spawn.wait(timeout=30)
        return spawn_loopback_member(model, service_id=service_id, **kw)

    model = scen_model()
    fleet = FleetSupervisor(model, services=2, steps=2, start=True,
                            member_transport="process",
                            member_spawner=gated_spawner,
                            heartbeat_deadline_s=0.2,
                            tick_interval_s=0.01, device="cpu")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            victim = fleet._members[0].service
            victim.kill()
            assert spawn_blocked.wait(timeout=30), \
                "the respawn never started"
            t = fleet.submit(scen_space(0))
            out = fleet.result(t, timeout=30)
            assert out is not None
            assert spawn_blocked.is_set() and not release_spawn.is_set()
    finally:
        release_spawn.set()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            fleet.stop()
    st = fleet.stats()
    assert st["respawns"] >= 1
    assert st["member_faults"] >= 1


def _flaky(fails):
    flaky = {"fails_left": fails}

    def spawner(model, *, service_id, **kw):
        if service_id.endswith("g1") and flaky["fails_left"] > 0:
            flaky["fails_left"] -= 1
            raise RuntimeError("transient spawner failure")
        return spawn_loopback_member(model, service_id=service_id, **kw)

    return flaky, spawner


def test_failed_respawn_is_retried_next_tick():
    flaky, spawner = _flaky(1)
    clock = {"t": 0.0}
    fleet = FleetSupervisor(scen_model(), services=2, steps=2,
                            start=False, member_transport="process",
                            member_spawner=spawner,
                            heartbeat_deadline_s=1.0,
                            clock=lambda: clock["t"], device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        fleet._members[0].service.kill()
        clock["t"] = 2.0
        fleet.tick()
        assert fleet.stats()["members"] == 1
        assert fleet.counter.loop_faults >= 1
        fleet.tick()
    st = fleet.stats()
    assert st["members"] == 2
    assert flaky["fails_left"] == 0
    t = fleet.submit(scen_space(0))
    assert fleet.result(t) is not None
    fleet.stop()


def test_sole_member_fence_defers_drain_until_respawn_lands():
    flaky, spawner = _flaky(1)
    clock = {"t": 0.0}
    fleet = FleetSupervisor(scen_model(), services=1, steps=2,
                            start=False, member_transport="process",
                            member_spawner=spawner,
                            heartbeat_deadline_s=1.0, max_wait_s=1e9,
                            max_batch=8, clock=lambda: clock["t"],
                            device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        t = fleet.submit(scen_space(0))
        fleet._members[0].service.kill()
        clock["t"] = 2.0
        fleet.tick()
        assert fleet.poll(t) is None
        fleet.tick()
        assert fleet.counter.readmitted >= 1
        out = fleet.result(t)
    assert out is not None
    fleet.stop()


def test_fleet_snapshot_and_prometheus_take_a_fleet():
    """``obs.fleet_snapshot`` validates over a fleet, and the Prometheus
    text labels each member by ``service_id``."""
    from mpi_model_tpu_torch import obs

    fleet = manual_fleet(services=2)
    fleet.result(fleet.submit(scen_space(0)))
    doc = obs.fleet_snapshot(fleet)
    obs.validate_snapshot(doc)
    assert doc["stats"]["fleet"] is True
    assert len(doc["stats"]["services"]) == 2
    text = obs.prometheus_text(doc["stats"])
    assert 'mpi_model_tpu_scenarios{service_id="m0g0"}' in text
    assert 'mpi_model_tpu_scenarios{service_id="m1g0"}' in text
    assert "# TYPE mpi_model_tpu_member_faults counter" in text
    fleet.stop()


def test_timeline_reads_a_fleet_journal_like_jax(tmp_path):
    """``obs.timeline`` over the port fleet's journal: a recovered
    ticket's events (submit, the re-admission, served), complete, and the
    document JAX's ``reconstruct`` makes of the same journal."""
    from mpi_model_tpu.obs import postmortem as jpostmortem

    from mpi_model_tpu_torch import obs

    jdir = str(tmp_path)
    fleet = manual_fleet(journal_dir=jdir, max_wait_s=1e9, max_batch=8)
    t = fleet.submit(scen_space(0))
    fleet.abandon()
    f2 = FleetSupervisor.recover(jdir, scen_model(), services=2, steps=4,
                                 start=False, device="cpu")
    f2.result(t)
    f2.stop()
    ours = obs.timeline(t, journal_dir=jdir)
    kinds = [e.kind for e in ours.events]
    assert kinds[0] == "submit" and "readmit" in kinds
    assert kinds[-1] == "served" and ours.complete
    assert ours.to_dict() == jpostmortem.reconstruct(
        t, journal_dir=jdir).to_dict()


def test_fleet_hibernation_write_failure_sheds_observably(tmp_path):
    """An unwritable vault leaves no ticket that never resolves: the
    admission sheds with ServiceOverloaded, the journaled submit gets its
    terminal record and the replay audit stays complete, in both
    packages."""
    from mpi_model_tpu.ensemble import ServiceOverloaded as JOverloaded
    from mpi_model_tpu.ensemble.journal import replay as jreplay

    def broken_hibernate(*a, **kw):
        raise OSError("vault full")

    cuts = []
    for pkg in ("jax", "torch"):
        jd = str(tmp_path / pkg / "j")
        kw = dict(services=1, steps=2, start=False, max_queue=1,
                  journal_dir=jd, residency_budget=1,
                  hibernate_dir=str(tmp_path / pkg / "v"))
        if pkg == "jax":
            fleet = JFleet(mm.Model(mm.Diffusion(0.05), 4.0, 1.0), **kw)
            space, overloaded, rep = jscen_space(0), JOverloaded, jreplay
        else:
            fleet = FleetSupervisor(scen_model(), device="cpu", **kw)
            space, overloaded, rep = scen_space(0), ServiceOverloaded, replay
        fleet.tiering.hibernate = broken_hibernate
        with pytest.raises(overloaded, match="hibernation write failed"):
            fleet.submit(space)
        st = fleet.stats()
        assert st["shed"] == 1 and st["pending"] == 0
        fleet.stop()
        audit = rep(journal_path(jd))
        assert audit.unresolved() == [] and not audit.duplicate_terminals
        cuts.append({k: st[k] for k in ("shed", "pending",
                                         "hibernated_scenarios")})
    assert cuts[0] == cuts[1]
