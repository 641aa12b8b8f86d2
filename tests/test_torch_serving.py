"""The port's always-on serving path on the CPU (``AsyncEnsembleService``,
``run_soak``, windowed and donated dispatch, the CLI's ``--serve``): each
test of the JAX package's ``tests/test_serving.py`` that has a counterpart,
and the port held against the JAX package on the same numpy-seeded
scenarios.

- Async results are bit for bit the synchronous service's (f64, xla; f32
  and the bf16 knob, pipeline: K5's plain version on the CPU), and
  windowed dispatch bit for bit the one-call dispatch.
- Against JAX's ``AsyncEnsembleService(impl="xla")`` at f64 the served
  values agree within ``2·eps64·steps·max|v|`` (XLA on the CPU contracts
  multiply-adds; the bound of ``tests/test_torch_ensemble.py``), with the
  same ledger; ``run_soak``'s report has JAX's keys and counts on a fake
  clock, and the async ``stats()`` JAX's keys.
- Grids are at most 64² (K5's smallest strip, 16×128, for the pipeline
  impl); the clock is injectable and ``start=False`` drives the pump where
  a thread is not the point; every threaded wait is bounded by
  ``result(timeout=)`` and ``stop()``.
"""

import dataclasses
import json
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_model_tpu as mm
from mpi_model_tpu import cli as jcli
from mpi_model_tpu.ensemble import AsyncEnsembleService as JAsync
from mpi_model_tpu.ensemble import run_soak as jrun_soak

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch.cli import main as cli_main
from mpi_model_tpu_torch.ensemble import (
    AsyncEnsembleService, EnsembleExecutor, EnsembleScheduler,
    EnsembleService, ServiceOverloaded, TicketExpired, complete_ensemble,
    launch_ensemble, run_soak)
from mpi_model_tpu_torch.resilience import inject
from mpi_model_tpu_torch.resilience.inject import Fault, FaultPlan
from mpi_model_tpu_torch.utils.metrics import ThroughputCounter

EPS64 = 2.0 ** -52
BASE = np.random.default_rng(21).uniform(0.5, 2.0, (16, 16))


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


def jscen_model(i=0):
    return mm.Model(mm.Diffusion(0.05 + 0.01 * i), 4.0, 1.0)


def drain(svc):
    while svc.pump_once(force=True):
        pass


@pytest.fixture(autouse=True)
def _one_thread_and_no_plan():
    """One intra-op thread (steady under xdist), and no fault plan left
    armed by a failing test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
        inject._ACTIVE = None


# -- async == sync, bit for bit ----------------------------------------------

def test_async_served_results_bitwise_equal_sync_f64():
    """The same scenarios through the always-on loop (threaded, windowed,
    donated) and through the synchronous service: every served state bit
    for bit."""
    model = scen_model()
    spaces = [scen_space(i) for i in range(5)]
    models = [scen_model(i) for i in range(5)]
    sync = EnsembleService(model, steps=4)
    ts = [sync.submit(spaces[i], model=models[i]) for i in range(5)]
    sync.flush()
    want = [sync.result(t) for t in ts]
    with AsyncEnsembleService(model, steps=4, windows=2) as svc:
        ta = [svc.submit(spaces[i], model=models[i]) for i in range(5)]
        got = [svc.result(t, timeout=120) for t in ta]
    for (gs, grep), (ws, wrep) in zip(got, want):
        assert torch.equal(gs.values["value"], ws.values["value"])
        assert grep.steps == 4
        assert grep.final_total == wrep.final_total
        assert grep.last_execute == wrep.last_execute
    st = svc.stats()
    assert st["scenarios"] == 5 and st["pending"] == 0
    assert st["latency_n"] == 5


def _strips(B, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    return [mt.CellularSpace.create(16, 128, 1.0, dtype=dtype,
                                    device="cpu").with_values(
        {"value": torch.from_numpy(rng.uniform(0.5, 2.0, (16, 128))).to(
            getattr(torch, dtype))}) for _ in range(B)]


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_async_pipeline_bitwise_equal_sync(compute_dtype):
    """``impl="pipeline"`` (K5; its plain version on the CPU) through the
    loop equals the synchronous service bit for bit, with and without the
    bf16 interior knob; ``donate=True`` (the default) turns off without a
    word for it, as in the JAX package."""
    model = mt.Model(mt.Diffusion(0.1), 1.0, 1.0)
    spaces = _strips(5, 31)
    kw = dict(steps=9, impl="pipeline", substeps=4,
              buckets=mt.buckets_for(8), retry="solo",
              compute_dtype=compute_dtype)
    sync = EnsembleService(model, **kw)
    ts = [sync.submit(s) for s in spaces]
    sync.flush()
    want = [sync.result(t) for t in ts]
    svc = AsyncEnsembleService(model, start=False, **kw)
    assert svc.scheduler.donate
    ta = [svc.submit(s) for s in spaces]
    svc.stop()
    for t, (ws, wrep) in zip(ta, want):
        gs, grep = svc.poll(t)
        assert torch.equal(gs.values["value"], ws.values["value"])
        assert grep.backend_report == wrep.backend_report
    # the log says what ran: one window, nothing donated
    last = svc.scheduler.dispatch_log[-1]
    assert (last["windows"], last["donated_windows"]) == (1, 0)


def test_windowed_dispatch_matches_single_call_bitwise():
    """windows=k is the step sequence of one call, bit for bit (donation
    never changes the math), point flows included."""
    model = mt.Model([mt.Diffusion(0.1),
                      mt.PointFlow(source=(5, 7), flow_rate=0.1)], 1.0, 1.0)
    spaces = [scen_space(i) for i in range(3)]
    one = launch_ensemble(model, spaces, steps=6, executor=EnsembleExecutor())
    for donate in (True, False):
        win = launch_ensemble(model, spaces, steps=6, windows=3,
                              donate=donate, executor=EnsembleExecutor())
        for (sa, ra), (sb, rb) in zip(complete_ensemble(one),
                                      complete_ensemble(win)):
            assert torch.equal(sa.values["value"], sb.values["value"])
            assert ra.last_execute == rb.last_execute
            assert ra.final_total == rb.final_total


# -- donation: the storage check ------------------------------------------------

def test_donation_carries_state_in_the_dispatch_buffers():
    """With donate=True every window's result lies in the dispatch's two
    buffers (the stacked batch and one more): the [B,H,W] state moved
    between windows with no copy and no fresh allocation. Undonated
    launches count none."""
    model, spaces = scen_model(), [scen_space(i) for i in range(2)]
    flight = launch_ensemble(model, spaces, steps=4, windows=2, donate=True,
                             executor=EnsembleExecutor())
    assert flight.windows == 2
    assert flight.donated_windows == 2
    out = flight.out[0]["value"]
    assert out.data_ptr() == flight.espace.values["value"].data_ptr()
    complete_ensemble(flight)
    plain = launch_ensemble(model, spaces, steps=4, windows=2, donate=False,
                            executor=EnsembleExecutor())
    assert plain.donated_windows == 0
    complete_ensemble(plain)


def test_service_dispatch_log_records_donation():
    svc = AsyncEnsembleService(scen_model(), steps=4, windows=2, start=False)
    svc.submit(scen_space(0))
    drain(svc)
    entries = [d for d in svc.scheduler.dispatch_log if "windows" in d]
    assert entries and all(d["donated_windows"] == d["windows"] == 2
                           for d in entries)


def test_donate_rejected_for_stat_lane_impls():
    model, spaces = scen_model(), [scen_space(0)]
    with pytest.raises(ValueError, match="impl='xla'"):
        launch_ensemble(model, spaces, steps=2, donate=True,
                        executor=EnsembleExecutor(impl="active"))
    with pytest.raises(ValueError, match="windows"):
        EnsembleScheduler(impl="active", windows=2)
    with pytest.raises(ValueError, match="windowed dispatch"):
        launch_ensemble(model, spaces, steps=2, windows=2,
                        executor=EnsembleExecutor(impl="active"))


def test_flight_records_effective_window_count():
    """steps < windows clamps the split; the flight records what ran."""
    flight = launch_ensemble(scen_model(), [scen_space(0)], steps=1,
                             windows=4, donate=True,
                             executor=EnsembleExecutor())
    assert flight.windows == 1
    assert flight.donated_windows == 1
    complete_ensemble(flight)


# -- the double-buffered pump -----------------------------------------------------

def test_pump_once_overlaps_launch_with_previous_completion():
    """Iteration i launches batch i and then completes batch i-1."""
    svc = AsyncEnsembleService(scen_model(), steps=2, max_batch=1,
                               start=False)
    a = svc.submit(scen_space(0))
    b = svc.submit(scen_space(1), steps=3)  # its own structure group
    assert svc.pump_once() is True      # launches A; nothing to complete
    assert svc.poll(a) is None          # A in flight, not fetched
    assert svc.has_work_due()
    assert svc.pump_once() is True      # launches B, completes A
    assert svc.poll(a) is not None
    assert svc.poll(b) is None
    assert svc.pump_once() is True      # completes B
    assert svc.poll(b) is not None
    assert svc.pump_once() is False     # idle
    assert not svc.has_work_due() and not svc.is_alive()
    svc.stop()


def test_stop_drains_every_ticket():
    svc = AsyncEnsembleService(scen_model(), steps=2, start=False)
    tickets = [svc.submit(scen_space(i)) for i in range(5)]
    svc.stop()
    for t in tickets:
        assert svc.poll(t) is not None
    assert svc.stats()["pending"] == 0


def test_abandon_is_final():
    svc = AsyncEnsembleService(scen_model(), steps=2, start=False)
    svc.abandon()
    with pytest.raises(RuntimeError, match="abandoned"):
        svc.start()


# -- bounded admission ------------------------------------------------------------

def test_overload_sheds_with_depth_and_retry_after():
    svc = AsyncEnsembleService(scen_model(), steps=2, max_queue=2,
                               start=False)
    svc.submit(scen_space(0))
    svc.submit(scen_space(1))
    with pytest.raises(ServiceOverloaded, match="queue full") as ei:
        svc.submit(scen_space(2))
    assert ei.value.queue_depth == 2
    assert ei.value.retry_after_s >= 0.0
    st = svc.stats()
    assert st["shed"] == 1 and st["pending"] == 2
    svc.stop()
    assert svc.stats()["shed"] == 1


def test_concurrent_submitters_respect_the_queue_bound():
    """Admission and enqueue are atomic under the scheduler's lock: racing
    submitters never overfill the queue."""
    svc = AsyncEnsembleService(scen_model(), steps=2, max_queue=4,
                               start=False)
    outcomes = []
    lock = threading.Lock()

    def client(i):
        try:
            t = svc.submit(scen_space(i % 3))
            with lock:
                outcomes.append(("ok", t))
        except ServiceOverloaded:
            with lock:
                outcomes.append(("shed", None))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(10)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len([o for o in outcomes if o[0] == "ok"]) == 4
    assert len(outcomes) == 10
    assert svc.stats()["shed"] == 6
    svc.stop()
    assert svc.stats()["pending"] == 0


# -- deadlines on the injectable clock ----------------------------------------------

def test_ticket_deadline_expires_with_complete_failure_event():
    clock = {"t": 0.0}
    svc = AsyncEnsembleService(scen_model(), steps=4, deadline_s=1.0,
                               max_wait_s=1e9, max_batch=8,
                               clock=lambda: clock["t"], start=False)
    t = svc.submit(scen_space(0))
    clock["t"] = 0.5
    svc.pump_once()
    assert svc.poll(t) is None
    clock["t"] = 1.5
    svc.pump_once()
    with pytest.raises(TicketExpired, match="expired") as ei:
        svc.poll(t)
    ev = ei.value.failure_event
    assert ei.value.ticket == t
    assert ev.kind == "expired" and ev.ticket == t
    assert ev.classification == "deterministic"
    assert svc.stats()["expired"] == 1
    assert [e.ticket for e in svc.scheduler.expired_log] == [t]
    assert any(d.get("expired_ticket") == t
               for d in svc.scheduler.dispatch_log)
    svc.stop()


def test_deadline_not_applied_to_dispatched_work():
    clock = {"t": 0.0}
    svc = AsyncEnsembleService(scen_model(), steps=4, deadline_s=1.0,
                               clock=lambda: clock["t"], start=False)
    t = svc.submit(scen_space(0))
    clock["t"] = 0.9
    svc.pump_once()                      # launched before expiry
    clock["t"] = 5.0                     # the deadline passes in flight
    svc.pump_once()
    assert svc.poll(t) is not None
    assert svc.stats()["expired"] == 0
    svc.stop()


def test_queue_latency_percentiles_on_injectable_clock():
    clock = {"t": 0.0}
    svc = AsyncEnsembleService(scen_model(), steps=2, max_wait_s=1e9,
                               max_batch=8, clock=lambda: clock["t"],
                               start=False)
    t = svc.submit(scen_space(0))
    clock["t"] = 2.5
    drain(svc)
    assert svc.poll(t) is not None
    st = svc.stats()
    assert st["latency_n"] == 1
    assert st["latency_p50_s"] == pytest.approx(2.5)
    assert st["latency_p99_s"] == pytest.approx(2.5)
    svc.stop()


def test_dispatch_deadline_ignores_async_overlap_gap():
    """A healthy dispatch does not blow its deadline on the time it ran
    while the loop assembled its successor: the deadline bills the launch
    and fetch segments only."""
    clock = {"t": 0.0}
    svc = AsyncEnsembleService(scen_model(), steps=2, max_batch=1,
                               dispatch_deadline_s=1.0,
                               clock=lambda: clock["t"], start=False)
    a = svc.submit(scen_space(0))
    b = svc.submit(scen_space(1), steps=3)
    svc.pump_once()
    clock["t"] = 50.0
    svc.pump_once()
    assert svc.poll(a) is not None
    svc.pump_once()
    assert svc.poll(b) is not None
    assert svc.stats()["impl_faults"] == 0
    svc.stop()


def test_finish_unwind_resolves_tickets_before_reraising():
    svc = AsyncEnsembleService(scen_model(), steps=2, start=False)
    a = svc.submit(scen_space(0))
    svc.pump_once()
    real = svc.scheduler.finish_flight

    def boom(flight):
        raise RuntimeError("fan-out interrupted")

    svc.scheduler.finish_flight = boom
    with pytest.raises(RuntimeError, match="fan-out interrupted"):
        svc.pump_once()
    svc.scheduler.finish_flight = real
    with pytest.raises(RuntimeError, match="fan-out interrupted"):
        svc.poll(a)
    assert svc.stats()["pending"] == 0
    svc.stop()


# -- retry budgets, counters ---------------------------------------------------------

def test_retry_budget_caps_solo_amplification():
    svc = AsyncEnsembleService(scen_model(), steps=4, retry="solo",
                               retry_budget=1, max_batch=3, start=False)
    plan = FaultPlan(tuple(Fault("lane_nan", ticket=i, once=False)
                           for i in range(3)))
    with inject.armed(plan):
        tickets = [svc.submit(scen_space(i)) for i in range(3)]
        drain(svc)
        for t in tickets:
            with pytest.raises(mt.EnsembleConservationError):
                svc.poll(t)
    st = svc.stats()
    assert st["solo_retries"] == 1
    assert st["quarantined"] == 3
    assert len([e for e in svc.scheduler.quarantine_log
                if "retry budget" in e.detail]) == 2
    entry = next(d for d in svc.scheduler.dispatch_log
                 if "retry_budget_exhausted" in d)
    assert len(entry["retry_budget_exhausted"]) == 2
    assert len(entry["retried_solo"]) == 1
    svc.stop()


def test_throughput_counter_bump_validates_names():
    c = ThroughputCounter()
    c.bump("shed")
    c.bump("expired", 2)
    with pytest.raises(ValueError, match="unknown counter"):
        c.bump("typo_counter")
    snap = c.snapshot()
    assert snap["shed"] == 1 and snap["expired"] == 2
    assert c.busy_per_scenario() is None
    c.record_dispatch(scenarios=4, bucket=4, wall_s=2.0, cache_hit=False)
    assert c.busy_per_scenario() == 0.5


def test_concurrent_bumps_never_lose_updates():
    c = ThroughputCounter()

    def worker():
        for _ in range(500):
            c.bump("shed")
            c.record_latency(0.001)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    snap = c.snapshot()
    assert snap["shed"] == 4000
    assert snap["latency_n"] == 4000
    assert snap["latency_p50_s"] == pytest.approx(0.001)


def test_threaded_service_stats_are_consistent():
    """Concurrent submitters against the live loop: every ticket resolves
    and the final snapshot reconciles."""
    results = []
    lock = threading.Lock()
    with AsyncEnsembleService(scen_model(), steps=2, max_queue=64) as svc:

        def client(i):
            t = svc.submit(scen_space(i % 4))
            out = svc.result(t, timeout=120)
            with lock:
                results.append(out)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert svc.is_alive()
        st = svc.stats()
    assert not any(t.is_alive() for t in threads)
    assert len(results) == 12
    assert st["scenarios"] == 12 and st["pending"] == 0
    assert st["latency_n"] == 12
    assert st["shed"] == 0 and st["expired"] == 0


# -- run_soak ---------------------------------------------------------------------------

def test_run_soak_ledger_is_complete_on_fake_clock():
    clock = {"t": 0.0}

    def fake_sleep(dt):
        clock["t"] += dt

    svc = AsyncEnsembleService(scen_model(), steps=2, max_queue=3,
                               start=False, clock=lambda: clock["t"])
    scen = [(scen_space(i % 3), None, None) for i in range(7)]
    rep = run_soak(svc, scen, arrival_rate_hz=1000.0,
                   clock=lambda: clock["t"], sleep=fake_sleep)
    svc.stop()
    assert rep["offered"] == 7
    assert rep["ledger_complete"] is True
    assert rep["served"] + rep["failed"] + rep["expired"] + rep["shed"] \
        == 7
    assert rep["shed"] >= 1
    assert rep["sustained_scenarios_per_s"] is not None


def test_run_soak_rejects_bad_rate():
    svc = AsyncEnsembleService(scen_model(), steps=2, start=False)
    with pytest.raises(ValueError, match="positive"):
        run_soak(svc, [], arrival_rate_hz=0.0)
    svc.stop()


def test_unported_serving_options_name_the_roadmap(tmp_path):
    model = scen_model()
    for make in (
            lambda: AsyncEnsembleService(model, residency_budget=1,
                                         hibernate_dir=str(tmp_path),
                                         start=False),
            lambda: AsyncEnsembleService(model, hibernate_budget=1,
                                         start=False),
            lambda: AsyncEnsembleService(model, mesh=2, start=False)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            make()
    # the degradation ladder's knob is accepted, as in the JAX package
    svc = AsyncEnsembleService(model, degrade_after=3, start=False)
    assert svc.scheduler.degrade_after == 3
    assert JAsync(jscen_model(), degrade_after=3, start=False,
                  compile_cache=None).scheduler.degrade_after == 3
    with pytest.raises(ValueError, match="max_queue"):
        AsyncEnsembleService(model, max_queue=0, start=False)
    assert AsyncEnsembleService(model, service_id="m0g0", start=False) \
        .stats()["service_id"] == "m0g0"


def test_a_kernel_error_reaches_each_ticket_through_the_pump(monkeypatch):
    """A K5 error in the pump reaches each ticket as that error, through
    the solo retry and then quarantine, at the default ``degrade_after``:
    a kernel's own error steps no rung of the degradation ladder, and no
    plain version runs in the kernel's place."""
    from mpi_model_tpu_torch.ops import KernelError, pipeline_stencil

    def fail(*args, **kwargs):
        raise KernelError("pipeline_stencil kernel launch failed")

    plain_calls = []
    monkeypatch.setattr(pipeline_stencil, "pipeline_dense_step", fail)
    monkeypatch.setattr(pipeline_stencil, "pipeline_step_plain",
                        lambda *a, **k: plain_calls.append(a))
    model = mt.Model(mt.Diffusion(0.1), 1.0, 1.0)
    svc = AsyncEnsembleService(model, steps=2, impl="pipeline",
                               start=False)
    tickets = [svc.submit(s) for s in _strips(2, 14)]
    svc.stop()
    for t in tickets:
        with pytest.raises(KernelError, match="pipeline_stencil") as ei:
            svc.poll(t)
        assert ei.value.failure_event.kind == "exception"
        assert ei.value.failure_event.attempt == 2
    st = svc.stats()
    assert (st["solo_retries"], st["quarantined"], st["impl"]) == (
        2, 2, "pipeline")
    assert (st["impl_faults"], st["degraded_from"],
            st["intake_gated"]) == (3, None, False)
    assert plain_calls == []


# -- the port against the JAX package ----------------------------------------------------

def test_async_service_agrees_with_jax_at_f64_with_the_same_ledger():
    """The same scenarios through JAX's ``AsyncEnsembleService`` and the
    port's (xla, windowed, donated, manual pump): values within
    ``2·eps64·steps·max|v|`` and the same ledger (counters, dispatch log,
    donation)."""
    steps = 4
    kw = dict(steps=steps, windows=2, max_batch=4, start=False)
    port = AsyncEnsembleService(scen_model(), **kw)
    jax_svc = JAsync(jscen_model(), compile_cache=None, **kw)
    pt = [port.submit(scen_space(i), model=scen_model(i)) for i in range(6)]
    jt = [jax_svc.submit(jscen_space(i), model=jscen_model(i))
          for i in range(6)]
    assert pt == jt
    for svc in (port, jax_svc):
        drain(svc)
        svc.stop()
    for i, (p, j) in enumerate(zip(pt, jt)):
        ps, prep = port.poll(p)
        js, jrep = jax_svc.poll(j)
        want = np.asarray(js.values["value"])
        tol = 2 * EPS64 * steps * np.abs(want).max()
        np.testing.assert_allclose(ps.values["value"].numpy(), want,
                                   rtol=0, atol=tol)
        assert prep.steps == jrep.steps == steps
        for k in jrep.final_total:
            assert abs(prep.final_total[k] - jrep.final_total[k]) <= \
                tol * 16 * 16
    keys = ("scenarios", "dispatches", "pending", "shed", "expired",
            "quarantined", "solo_retries", "recovered_failures",
            "loop_faults", "latency_n", "batch_occupancy",
            "compile_cache_hits", "runner_builds")
    pst, jst = port.stats(), jax_svc.stats()
    assert {k: pst[k] for k in keys} == {k: jst[k] for k in keys}
    drop = ("wall_s",)
    plog = [{k: v for k, v in d.items() if k not in drop}
            for d in port.scheduler.dispatch_log]
    jlog = [{k: v for k, v in d.items() if k not in drop}
            for d in jax_svc.scheduler.dispatch_log]
    assert plog == jlog
    assert all(d["donated_windows"] == d["windows"] == 2 for d in plog)


def test_async_stats_keys_are_jax_keys():
    port = AsyncEnsembleService(scen_model(), start=False)
    jax_svc = JAsync(jscen_model(), compile_cache=None, start=False)
    assert set(port.stats()) == set(jax_svc.stats())


@pytest.mark.parametrize("max_queue,deadline_s", [(3, None), (8, 0.0025)])
def test_run_soak_report_matches_jax_on_a_fake_clock(max_queue, deadline_s):
    """The same open-loop schedule on a fake clock through both packages:
    the same report keys and the same served/failed/expired/shed counts."""
    reports = []
    for make, space in (
            (lambda c: AsyncEnsembleService(
                scen_model(), steps=2, max_queue=max_queue,
                deadline_s=deadline_s, start=False, clock=c), scen_space),
            (lambda c: JAsync(
                jscen_model(), steps=2, max_queue=max_queue,
                deadline_s=deadline_s, start=False, clock=c,
                compile_cache=None), jscen_space)):
        clock = {"t": 0.0}

        def fake_sleep(dt, clock=clock):
            clock["t"] += dt

        def now(clock=clock):
            return clock["t"]

        svc = make(now)
        soak = run_soak if space is scen_space else jrun_soak
        reports.append(soak(svc, [(space(i % 3), None, None)
                                  for i in range(7)],
                            arrival_rate_hz=1000.0, clock=now,
                            sleep=fake_sleep))
        svc.stop()
    port_rep, jax_rep = reports
    assert set(port_rep) == set(jax_rep)
    for k in ("offered", "served", "failed", "expired", "shed",
              "ledger_complete", "dispatches", "expired_total",
              "shed_total", "quarantined", "loop_faults"):
        assert port_rep[k] == jax_rep[k], k
    assert port_rep["ledger_complete"] is True


# -- the CLI --------------------------------------------------------------------------------

def test_cli_serve_json(capsys):
    rc = cli_main(["run", "--device=cpu", "--dimx=16", "--dimy=16",
                   "--flow=diffusion", "--steps=2", "--serve",
                   "--serve-scenarios=6", "--json"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert jcli.main(["run", "--dimx=16", "--dimy=16", "--flow=diffusion",
                      "--steps=2", "--serve", "--serve-scenarios=6",
                      "--compile-cache=off", "--json"]) == 0
    jout = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(jout) <= set(out)
    assert out["backend"] == "serve"
    assert out["served"] == jout["served"] == 6
    assert out["ledger_complete"] is True
    assert out["shed"] == 0 and out["expired"] == 0
    assert out["kernel_launches"] == 0


def test_cli_serve_pipeline_row(capsys):
    rc = cli_main(["run", "--device=cpu", "--dimx=16", "--dimy=128",
                   "--flow=diffusion", "--steps=8", "--substeps=8",
                   "--serve", "--serve-scenarios=4",
                   "--ensemble-impl=pipeline", "--json"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["impl"] == "pipeline"
    assert out["served"] == 4 and out["ledger_complete"] is True


@pytest.mark.parametrize("argv", [
    ["run", "--serve", "--ensemble=2"],
    ["run", "--serve", "--mesh=2x1"],
    ["run", "--serve", "--output=/nonexistent/x"],
    ["run", "--serve", "--impl=pallas"],
    ["run", "--serve", "--serve-scenarios=0"],
    ["run", "--serve", "--max-queue=0"],
    ["run", "--serve", "--deadline-s=0"],
    ["run", "--serve", "--arrival-rate=-1"],
    ["run", "--arrival-rate=5"],
    ["run", "--deadline-s=2"],
    ["run", "--max-queue=8"],
    ["run", "--serve-scenarios=9"],
])
def test_cli_serve_flag_validation(argv):
    with pytest.raises(SystemExit) as ei:
        cli_main(argv + ["--device=cpu"])
    assert ei.value.code not in (0, 2)       # a check, not argparse's


@pytest.mark.parametrize("argv", [
    ["--serve-services=2"], ["--serve-transport=process"],
    ["--residency-budget=1", "--hibernate-dir=/nonexistent"],
    ["--hibernate-dir=/nonexistent"], ["--serve-services=3"],
    ["--serve-transport=tcp"], ["--ensemble-mesh=2x1"],
    ["--ensemble-mesh=2"],
])
def test_cli_refuses_unported_serving_flags(argv):
    with pytest.raises(SystemExit, match="ROADMAP.md"):
        cli_main(["run", "--serve", "--device=cpu", *argv])


def test_dataclass_fields_of_the_plan_are_jax_fields():
    from mpi_model_tpu.resilience import inject as jinject

    assert [f.name for f in dataclasses.fields(Fault)] == \
        [f.name for f in dataclasses.fields(jinject.Fault)]
    assert inject.SITE_OF == jinject.SITE_OF
