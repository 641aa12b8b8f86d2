"""The port's fleet with its members behind the wire
(``ensemble/member_proc.py``) on the CPU: a counterpart of each test of
the JAX package's ``tests/test_fleet_proc.py``.

The tier-1 rows run ``member_transport="process"`` over the loopback
transport (a real ``MemberServer`` on a thread over a real socketpair: the
codec, the framing, the chaos seams and the client path of a child, with
no subprocess), device ``"cpu"``: the bit-for-bit gate against the
in-process fleet and the synchronous service, the whole chaos matrix of
the fleet (8 kinds) under a lockdep witness armed with the port's static
lock graph (every edge the port's fleet shows lies in it), the kill-then-wedge
and torn-journal rows, the wire's own seams (``proc_kill``,
``heartbeat_loss``, ``wire_torn``: fence, respawn as generation + 1,
recovery of every ticket) and the heartbeat, RSS and wire-bytes
observability. The rows with real spawned children (CPU children: a
``kill -9``, the bit-for-bit gate, the ``member_env`` pin) are marked
``slow``.

The tiering rows (``test_fleet_proc.py:732``, ``:767``) page and wake
across the loopback wire. Waiting for a later slice (ROADMAP.md): the mesh
row (``:667``).
"""

import functools
import json
import os
import signal
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch.ensemble import (EnsembleService, FleetSupervisor,
                                          run_soak)
from mpi_model_tpu_torch.ensemble import member_proc
from mpi_model_tpu_torch.ensemble.journal import (audit_journal,
                                                  journal_path, model_meta,
                                                  replay)
from mpi_model_tpu_torch.ensemble.member_proc import spawn_loopback_member
from mpi_model_tpu_torch.resilience import inject, lockdep
from mpi_model_tpu_torch.resilience.inject import Fault, FaultPlan

loopback = functools.partial(spawn_loopback_member, device="cpu")


def scen_space(i, g=16, dtype="float64"):
    rng = np.random.default_rng((97, i, g))
    v = torch.from_numpy(rng.uniform(0.5, 2.0, (g, g))).to(
        getattr(torch, dtype))
    return mt.CellularSpace.create(g, g, 1.0, dtype=dtype,
                                   device="cpu").with_values({"value": v})


def scen_model(i=0):
    return mt.Model(mt.Diffusion(0.05 + 0.01 * i), 4.0, 1.0)


def proc_fleet(model=None, **kw):
    kw.setdefault("services", 2)
    kw.setdefault("steps", 4)
    kw.setdefault("retry", "solo")
    kw.setdefault("device", "cpu")
    return FleetSupervisor(model or scen_model(), start=False,
                           member_transport="process",
                           member_spawner=loopback, **kw)


@pytest.fixture(autouse=True)
def _one_thread_and_no_plan():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
        inject._ACTIVE = None
        lockdep._ACTIVE = None


_ALLOWED_GRAPH = None


def _allowed_graph():
    """The port's static acquisition graph (its concurrency auditor over
    the port's sources), read once."""
    global _ALLOWED_GRAPH
    if _ALLOWED_GRAPH is None:
        from mpi_model_tpu_torch.analysis.concurrency import \
            static_lock_graph

        _ALLOWED_GRAPH = static_lock_graph()
    return _ALLOWED_GRAPH


def _assert_edges_in_static_graph(witness) -> None:
    witness.assert_clean()
    assert witness.edges, "the witness saw no acquisitions"
    assert set(witness.edges) <= _allowed_graph()


# -- the gate: process == inproc == sync, bit for bit --------------------------

def test_process_fleet_bitwise_equal_inproc_and_sync_f64():
    model = scen_model()
    spaces = [scen_space(i) for i in range(6)]
    models = [scen_model(i) for i in range(6)]
    sync = EnsembleService(model, steps=4)
    ts = [sync.submit(spaces[i], model=models[i]) for i in range(6)]
    sync.flush()
    want = [sync.result(t)[0] for t in ts]
    inproc = FleetSupervisor(model, services=3, steps=4, start=False,
                             device="cpu")
    ti = [inproc.submit(spaces[i], model=models[i]) for i in range(6)]
    got_inproc = [inproc.result(t)[0] for t in ti]
    inproc.stop()
    fleet = proc_fleet(model, services=3)
    tp = [fleet.submit(spaces[i], model=models[i]) for i in range(6)]
    got_proc = [fleet.result(t)[0] for t in tp]
    st = fleet.stats()
    fleet.stop()
    for i in range(6):
        assert torch.equal(got_proc[i].values["value"],
                           want[i].values["value"])
        assert torch.equal(got_proc[i].values["value"],
                           got_inproc[i].values["value"])
    assert st["member_transport"] == "process"
    assert st["scenarios"] == 6 and st["pending"] == 0


def test_report_and_conservation_totals_cross_the_wire():
    fleet = proc_fleet(services=1)
    t = fleet.submit(scen_space(0))
    space, report = fleet.result(t)
    fleet.stop()
    assert report.steps == 4
    assert report.backend_report.get("service_id") == "m0g0"
    assert report.impl == "xla"
    assert report.backend_report.get("degraded_from") is None
    want = float(scen_space(0).values["value"].sum())
    assert abs(report.initial_total["value"] - want) < 1e-9
    assert abs(report.final_total["value"] - want) < 1e-6
    assert space.values["value"].device.type == "cpu"


def test_bf16_and_f32_states_cross_the_wire_bit_for_bit():
    """The wire carries each dtype as itself (bf16 as its raw bytes): a
    served f32 and bf16 lane are bit for bit the synchronous service's."""
    for dtype in ("float32", "bfloat16"):
        sync = EnsembleService(scen_model(), steps=4)
        want = sync.result(sync.submit(scen_space(1, dtype=dtype)))[0]
        fleet = proc_fleet(services=1)
        got = fleet.result(fleet.submit(scen_space(1, dtype=dtype)))[0]
        fleet.stop()
        assert got.values["value"].dtype == getattr(torch, dtype)
        assert torch.equal(got.values["value"], want.values["value"])


# -- the chaos matrix, across the wire -------------------------------------------

FLEET_MATRIX = {
    "lane_nan_transient": (
        (Fault("lane_nan", lane=0, at=0, once=True),), {},
        dict(min_recovered=1, quarantined=0)),
    "lane_nan_sticky": (
        (Fault("lane_nan", lane=0, once=False),), {},
        dict(min_quarantined=1)),
    "batch_exc": (
        (Fault("batch_exc", at=0),), {},
        dict(min_recovered=1, quarantined=0)),
    "hang": (
        (Fault("hang", at=0, seconds=5.0),),
        dict(dispatch_deadline_s=1.0, clock=None),
        dict(min_recovered=1, quarantined=0)),
    "thread_exc": (
        (Fault("thread_exc", at=0),), {},
        dict(min_loop_faults=1, quarantined=0)),
    "slow_compile": (
        (Fault("slow_compile", at=0, seconds=5.0),),
        dict(dispatch_deadline_s=1.0, clock=None),
        dict(min_recovered=1, quarantined=0)),
    "fetch_nan": (
        (Fault("fetch_nan", at=0, lane=0, once=True),), {},
        dict(min_recovered=1, quarantined=0)),
    "queue_full": (
        (Fault("queue_full", at=0),), {},
        dict(quarantined=0, fleet_shed=0)),
}


def test_the_matrix_is_jax_s():
    import test_fleet_proc as jrows

    assert sorted(FLEET_MATRIX) == sorted(jrows.FLEET_MATRIX)
    for k, (faults, extra, expect) in FLEET_MATRIX.items():
        jf, jextra, jexpect = jrows.FLEET_MATRIX[k]
        assert [vars(f) for f in faults] == [vars(f) for f in jf]
        assert extra == jextra and expect == jexpect


@pytest.mark.parametrize("kind", sorted(FLEET_MATRIX))
def test_process_fleet_matrix_every_ticket_resolves(kind):
    """Each kind of the fleet's chaos matrix with every member behind the
    wire and the witness armed: every ticket resolves to a counted outcome
    through the codec, with no lock-order violation and every edge in
    the port's static graph."""
    faults, extra, expect = FLEET_MATRIX[kind]
    extra = dict(extra)
    if "clock" in extra:
        clock = {"t": 0.0}
        extra["clock"] = lambda: clock["t"]
    served = failed = 0
    with lockdep.armed(allowed=_allowed_graph()) as witness:
        fleet = proc_fleet(**extra)
        with inject.armed(FaultPlan(faults)) as st, \
                warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            tickets = [fleet.submit(scen_space(i)) for i in range(4)]
            for t in tickets:
                try:
                    fleet.result(t)
                    served += 1
                # analysis: ignore[broad-except] — the matrix's ledger:
                # every outcome that is not served is counted, whatever
                # the chaos threw across the wire
                except Exception:
                    failed += 1
        stats = fleet.stats()
        fleet.stop()
    _assert_edges_in_static_graph(witness)
    assert st.fired, f"{kind}: fault never fired"
    assert served + failed == 4
    assert stats["pending"] == 0
    if "quarantined" in expect:
        assert stats["quarantined"] == expect["quarantined"]
    if "min_quarantined" in expect:
        assert stats["quarantined"] >= expect["min_quarantined"]
    if "min_recovered" in expect:
        assert stats["recovered_failures"] >= expect["min_recovered"]
    if "min_loop_faults" in expect:
        assert stats["loop_faults"] >= expect["min_loop_faults"]
    if "fleet_shed" in expect:
        assert stats["shed"] == expect["fleet_shed"]


def test_process_fleet_member_kill_then_wedge():
    clock = {"t": 0.0}
    with lockdep.armed(allowed=_allowed_graph()) as witness:
        fleet = proc_fleet(supervision_deadline_s=1.0,
                           clock=lambda: clock["t"])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            tickets = [fleet.submit(scen_space(i)) for i in range(3)]
            fleet.tick()
            victim = next(s["service_id"]
                          for s in fleet.stats()["services"]
                          if s["pending"] > 0)
            with inject.armed(FaultPlan(
                    (Fault("member_kill", channel=victim),))) as st1:
                outs = [fleet.result(t) for t in tickets]
            wave2 = [fleet.submit(scen_space(i), steps=3)
                     for i in range(3)]
            fleet.tick()
            wedged = next(s["service_id"]
                          for s in fleet.stats()["services"]
                          if s["pending"] > 0)
            with inject.armed(FaultPlan(
                    (Fault("member_wedge", channel=wedged,
                           once=False),))) as st2:
                fleet.pump_once()
                clock["t"] = 2.0
                fleet.pump_once()
                clock["t"] = 4.0
                fleet.pump_once()
                outs2 = [fleet.result(t) for t in wave2]
        stats = fleet.stats()
        fleet.stop()
    _assert_edges_in_static_graph(witness)
    assert {f["kind"] for f in st1.fired} == {"member_kill"}
    assert "member_wedge" in {f["kind"] for f in st2.fired}
    assert len(outs) == 3 and len(outs2) == 3
    assert stats["member_faults"] == 2 and stats["pending"] == 0
    assert stats["respawns"] >= 1
    assert {e.service_id for e in fleet.member_log} == {victim, wedged}


def test_process_fleet_journal_torn_recovery(tmp_path):
    jdir = str(tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        fleet = proc_fleet(journal_dir=jdir, max_wait_s=1e9, max_batch=8)
        tickets = [fleet.submit(scen_space(i)) for i in range(4)]
        with inject.armed(FaultPlan(
                (Fault("journal_torn", at=4, offset=5,
                       tear="truncate"),))) as st:
            fleet.submit(scen_space(4))
        assert st.fired
        fleet.abandon()
        state = replay(journal_path(jdir))
        assert state.torn
        assert len(state.submits) == 4
        r2 = FleetSupervisor.recover(
            jdir, scen_model(), services=2, steps=4, retry="solo",
            start=False, member_transport="process",
            member_spawner=loopback, device="cpu")
        for t in tickets:
            space, report = r2.result(t)
            assert space.values["value"].shape == (16, 16)
        r2.stop()
    audit = audit_journal(journal_path(jdir))
    assert audit["ok"] and not audit["unresolved"]


# -- the wire's own seams -------------------------------------------------------

def _victim_with_work(fleet) -> str:
    fleet.tick()  # a beat refreshes the telemetry cut
    return next(s["service_id"] for s in fleet.stats()["services"]
                if s["pending"] > 0)


def test_proc_kill_fences_respawns_and_recovers_tickets():
    clock = {"t": 0.0}
    fleet = proc_fleet(services=2, clock=lambda: clock["t"],
                       heartbeat_deadline_s=1.0, max_wait_s=1e9,
                       max_batch=8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        tickets = [fleet.submit(scen_space(i)) for i in range(4)]
        victim = _victim_with_work(fleet)
        with inject.armed(FaultPlan(
                (Fault("proc_kill", channel=victim),))) as st:
            fleet.pump_once()
            clock["t"] = 2.0
            fleet.pump_once()
            outs = [fleet.result(t) for t in tickets]
    stats = fleet.stats()
    fleet.stop()
    assert st.fired and st.fired[0]["kind"] == "proc_kill"
    assert len(outs) == 4
    assert stats["member_faults"] >= 1
    assert stats["respawns"] >= 1
    assert stats["readmitted"] >= 1
    assert stats["wire_errors"] >= 1
    assert stats["pending"] == 0
    assert victim not in {s["service_id"] for s in stats["services"]}


def test_heartbeat_loss_fences_after_missed_deadline():
    clock = {"t": 0.0}
    fleet = proc_fleet(services=2, clock=lambda: clock["t"],
                       heartbeat_deadline_s=1.0, max_wait_s=1e9,
                       max_batch=8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        tickets = [fleet.submit(scen_space(i)) for i in range(4)]
        victim = _victim_with_work(fleet)
        with inject.armed(FaultPlan(
                (Fault("heartbeat_loss", channel=victim,
                       once=False),))) as st:
            fleet.pump_once()
            clock["t"] = 2.0
            fleet.pump_once()
            outs = [fleet.result(t) for t in tickets]
    stats = fleet.stats()
    fleet.stop()
    assert {f["kind"] for f in st.fired} == {"heartbeat_loss"}
    assert len(outs) == 4
    assert stats["heartbeat_misses"] >= 1
    assert stats["member_faults"] >= 1 and stats["respawns"] >= 1
    assert stats["pending"] == 0
    assert any("missed heartbeats" in e.detail for e in fleet.member_log)


def test_wire_torn_mid_stream_is_a_member_fault_not_a_ticket_loss():
    clock = {"t": 0.0}
    fleet = proc_fleet(services=2, clock=lambda: clock["t"],
                       heartbeat_deadline_s=1.0, max_wait_s=1e9,
                       max_batch=8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        tickets = [fleet.submit(scen_space(i)) for i in range(4)]
        victim = _victim_with_work(fleet)
        with inject.armed(FaultPlan(
                (Fault("wire_torn", channel=victim, offset=2,
                       nbytes=8, tear="corrupt"),))) as st:
            fleet.pump_once()
            clock["t"] = 2.0
            fleet.pump_once()
            outs = [fleet.result(t) for t in tickets]
    stats = fleet.stats()
    fleet.stop()
    assert {f["kind"] for f in st.fired} == {"wire_torn"}
    assert len(outs) == 4
    assert stats["wire_errors"] >= 1
    assert stats["pending"] == 0


# -- the soak and the observability ---------------------------------------------

def test_process_fleet_soak_ledger_complete_lockdep_armed():
    clock = {"t": 0.0}

    def fake_sleep(dt):
        clock["t"] += dt

    scen = [(scen_space(i), None, None) for i in range(8)]
    with lockdep.armed(allowed=_allowed_graph()) as witness:
        fleet = proc_fleet(services=2, clock=lambda: clock["t"])
        rep = run_soak(fleet, scen, arrival_rate_hz=50.0,
                       clock=lambda: clock["t"], sleep=fake_sleep)
        fleet.stop()
    _assert_edges_in_static_graph(witness)
    assert rep["ledger_complete"] and rep["served"] == 8
    assert rep["member_faults"] == 0


def test_wire_observability_in_stats():
    fleet = proc_fleet(services=2)
    t = fleet.submit(scen_space(0))
    fleet.result(t)
    st = fleet.stats()
    per = st["services"]
    fleet.stop()
    assert st["member_transport"] == "process"
    assert st["heartbeats"] >= 2 and st["heartbeat_misses"] == 0
    assert st["wire_bytes_in"] > 0 and st["wire_bytes_out"] > 0
    assert st["respawns"] == 0 and st["wire_errors"] == 0
    for s in per:
        assert s["transport"] == "process"
        assert s["wire_bytes_in"] >= 0 and s["wire_bytes_out"] >= 0
        assert s["heartbeat_age_s"] >= 0.0
        assert s["member_pid"] == os.getpid()  # loopback: this process
        assert s["rss_bytes"] is None or s["rss_bytes"] > 0
        assert s["backend"]["platform"] in ("cpu", "gpu")
        assert "pipeline_stencil" in s["kernel_launches"]


def test_dead_member_wire_bytes_absorbed_into_fleet_stats():
    clock = {"t": 0.0}
    fleet = proc_fleet(services=2, clock=lambda: clock["t"],
                       heartbeat_deadline_s=1.0, max_wait_s=1e9,
                       max_batch=8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        tickets = [fleet.submit(scen_space(i)) for i in range(2)]
        victim = _victim_with_work(fleet)
        before = fleet.stats()["wire_bytes_in"]
        with inject.armed(FaultPlan(
                (Fault("proc_kill", channel=victim),))):
            fleet.pump_once()
            clock["t"] = 2.0
            fleet.pump_once()
            [fleet.result(t) for t in tickets]
    after = fleet.stats()["wire_bytes_in"]
    fleet.stop()
    assert after >= before


# -- guards and proxies ---------------------------------------------------------

def test_process_transport_refuses_unserializable_models():
    with pytest.raises(ValueError, match="unknown member_transport"):
        FleetSupervisor(scen_model(), member_transport="carrier-pigeon",
                        device="cpu")

    class NonDC:
        pass

    m = scen_model()
    m2 = mt.Model(mt.Diffusion(0.05), 4.0, 1.0)
    m2.flows = [NonDC()]
    assert model_meta(m2) is None
    with pytest.raises(ValueError, match="wire recipe"):
        FleetSupervisor(m2, member_transport="process",
                        member_spawner=loopback, start=False, device="cpu")
    assert model_meta(m) is not None


def test_wire_migration_is_crc_verified_end_to_end():
    model = scen_model()
    sync = EnsembleService(model, steps=4)
    ts = sync.submit(scen_space(0))
    sync.flush()
    want = sync.result(ts)[0]
    fleet = proc_fleet(services=2, max_wait_s=1e9, max_batch=8,
                       policy=None)
    t = fleet.submit(scen_space(0))
    with fleet._cv:
        route = fleet._route[t]
        src = route.member
        dst = next(m for m in fleet._members.values() if m is not src)
        new_mt = src.service.scheduler.migrate_ticket(
            route.member_ticket, dst.service.scheduler)
        route.member, route.member_ticket = dst, new_mt
    got = fleet.result(t)[0]
    st = fleet.stats()
    fleet.stop()
    assert torch.equal(got.values["value"], want.values["value"])
    assert st["pending"] == 0


def test_journal_cli_main_runs_the_audit(tmp_path, capsys):
    from mpi_model_tpu_torch.ensemble import journal as journal_mod

    jdir = str(tmp_path)
    fleet = proc_fleet(journal_dir=jdir)
    tickets = [fleet.submit(scen_space(i)) for i in range(3)]
    for t in tickets:
        fleet.result(t)
    fleet.stop()
    rc = journal_mod.main([jdir])
    out = capsys.readouterr().out
    assert rc == 0
    assert "exactly-once: OK" in out
    assert "submit" in out and "served" in out
    rc = journal_mod.main([jdir, "--json"])
    audit = json.loads(capsys.readouterr().out)
    assert audit["ok"] and audit["submits"] == 3 and not audit["torn"]
    assert journal_mod.main([str(tmp_path / "nope")]) == 2


def test_heartbeat_telemetry_cache_reuses_idle_and_invalidates():
    client = loopback(scen_model(), service_id="m9g0",
                      member_kwargs=dict(steps=4, retry="solo"))
    server = client._server
    assert client.heartbeat()
    cut1 = server._stats_cached
    assert client.stats()["scenarios"] == 0
    assert client.heartbeat()
    assert server._stats_cached is cut1
    t = client.submit(scen_space(0))
    while client.poll(t) is None:
        client.pump_once(force=True)
    assert client.heartbeat()
    assert server._stats_cached is not cut1
    assert client.stats()["scenarios"] == 1
    client.close()


def test_fence_respawn_never_serves_a_retired_generations_cut():
    clock = {"t": 0.0}
    fleet = proc_fleet(services=2, clock=lambda: clock["t"],
                       heartbeat_deadline_s=1.0, max_wait_s=1e9,
                       max_batch=8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        tickets = [fleet.submit(scen_space(i)) for i in range(4)]
        outs = [fleet.result(t) for t in tickets]
        assert len(outs) == 4
        victim = next(s["service_id"]
                      for s in fleet.stats()["services"]
                      if s["scenarios"] > 0)
        slot = int(victim[1:victim.index("g")])
        with inject.armed(FaultPlan(
                (Fault("proc_kill", channel=victim),))):
            fleet.pump_once()
            clock["t"] = 2.0
            fleet.pump_once()
    stats = fleet.stats()
    assert stats["respawns"] >= 1
    replacement = next(s for s in stats["services"]
                       if s["service_id"] == f"m{slot}g1")
    assert replacement["scenarios"] == 0
    assert replacement["dispatches"] == 0
    assert stats["scenarios"] == 4
    fleet.stop()


def test_submit_frame_carries_the_trace_context():
    """The caller's trace context rides the submit frame
    (``wire.TRACE_META_KEY``) and the member attaches it: the member's
    dispatch spans parent under the fleet's ``fleet.submit`` span."""
    from mpi_model_tpu_torch.utils import Tracer, set_tracer

    tr = Tracer()
    prev = set_tracer(tr)
    try:
        fleet = proc_fleet(services=1)
        t = fleet.submit(scen_space(0))
        fleet.result(t)
        fleet.stop()
    finally:
        set_tracer(prev)
    spans = tr.spans
    submit = next(s for s in spans if s.name == "fleet.submit")
    launches = [s for s in spans if s.name == "ensemble.launch"]
    assert launches and all(s.trace_id == submit.trace_id
                            for s in launches)


def test_member_main_without_a_card_fails_its_config(tmp_path, capsys):
    """A child whose config asks for the card and finds none exits 2 before
    it dials back (``resolve_device``), naming the cause: the spawn fails
    loudly, and the member never serves on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({
        "service_id": "m0g0", "model": model_meta(scen_model()),
        "member_kwargs": {"steps": 4}, "pump": "thread",
        "device": "cuda"}))
    rc = member_proc.main(["--connect", str(tmp_path / "sock"),
                           "--config", str(cfg)])
    assert rc == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_member_kwargs_that_cannot_cross_are_refused():
    with pytest.raises(ValueError, match="cannot cross"):
        member_proc._encode_member_kwargs({"service_id": "x"})
    # the mesh crosses as its (batch, space) extents, whatever its form
    from mpi_model_tpu_torch.ensemble import make_ensemble_mesh

    assert member_proc._encode_member_kwargs({"mesh": 2}) == {"mesh": [2, 1]}
    assert member_proc._encode_member_kwargs({"mesh": (2, 2)}) == {
        "mesh": [2, 2]}
    assert member_proc._encode_member_kwargs(
        {"mesh": make_ensemble_mesh(2, devices=["cpu"] * 2)}) == {
            "mesh": [2, 1]}
    assert member_proc._decode_member_kwargs({"mesh": [2, 1]}) == {
        "mesh": (2, 1)}
    # a member inside a torch.distributed world above one process votes
    # with the world (the multi-process layer): its answer is the group's
    import torch.distributed as dist

    from mpi_model_tpu_torch.parallel import multihost

    reduced = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dist, "is_available", lambda: True)
        mp.setattr(dist, "is_initialized", lambda: True)
        mp.setattr(dist, "get_world_size", lambda *a, **k: 2)
        mp.setattr(dist, "get_backend", lambda *a, **k: "gloo")
        mp.setattr(dist, "all_reduce",
                   lambda t, op=None, **k: (reduced.append(op),
                                            t.zero_()))
        assert multihost.all_agree(True) is False
    assert reduced == [dist.ReduceOp.MIN]
    enc = member_proc._encode_member_kwargs(
        {"compute_dtype": torch.bfloat16, "buckets": (1, 2),
         "clock": time.monotonic})
    assert enc == {"compute_dtype": "bfloat16", "buckets": [1, 2]}
    assert member_proc._decode_member_kwargs(enc)["buckets"] == (1, 2)
    # tcp is a transport now (tests/test_torch_failover.py); an unknown one
    # is refused before anything is spawned
    with pytest.raises(ValueError, match="unknown member transport"):
        member_proc.spawn_process_member(
            scen_model(), service_id="x", member_kwargs={},
            transport="udp", device="cpu")


def test_mesh_spec_crosses_the_wire_loopback():
    """The ``(batch, space)`` mesh is a member kwarg (the JAX package's
    ``test_fleet_proc.py:667``): it crosses the wire as its extents and the
    member resolves them over its own device, here the CPU. Served results
    are bit for bit the meshless in-process fleet's, and the member's stats
    name the mesh."""
    model = scen_model()
    spaces = [scen_space(i) for i in range(4)]
    inproc = FleetSupervisor(model, services=1, steps=4, start=False,
                             device="cpu")
    want = [inproc.result(inproc.submit(s))[0] for s in spaces]
    inproc.stop()
    fleet = proc_fleet(model, services=1, mesh=2)
    try:
        tp = [fleet.submit(s) for s in spaces]
        got = [fleet.result(t, timeout=300)[0] for t in tp]
        st = fleet.stats()
    finally:
        fleet.stop()
    for i in range(4):
        assert torch.equal(got[i].values["value"], want[i].values["value"])
    assert st["services"][0]["mesh"] == {"batch": 2, "space": 1,
                                         "devices": 2}


# -- scenario tiering across the wire -----------------------------------------

def test_tiering_pages_and_wakes_across_the_wire_bitwise(tmp_path):
    """The paging tier with process members (loopback): admissions beyond
    the residency budget hibernate at the fleet, wake FIFO, and their
    placements cross the wire like any submission; every served state bit
    for bit the synchronous service's, zero sheds, wakes attributed per
    member."""
    from mpi_model_tpu_torch.ensemble import scenario_nbytes

    model = scen_model()
    spaces = [scen_space(i) for i in range(6)]
    models = [scen_model(i) for i in range(6)]
    sync = EnsembleService(model, steps=4)
    ts = [sync.submit(spaces[i], model=models[i]) for i in range(6)]
    sync.flush()
    want = [sync.result(t)[0].values["value"] for t in ts]

    one = scenario_nbytes(spaces[0])
    fleet = proc_fleet(model, services=2, residency_budget=2 * one + 1,
                       hibernate_dir=str(tmp_path / "wire-tier"))
    tp = [fleet.submit(spaces[i], model=models[i]) for i in range(6)]
    st = fleet.stats()
    assert st["hibernated_scenarios"] == 4 and st["shed"] == 0
    for i, t in enumerate(tp):
        out, _rep = fleet.result(t)
        assert torch.equal(out.values["value"], want[i])
    st = fleet.stats()
    assert st["wakes"] == 4 and st["shed"] == 0
    assert sum(st["wakes_by_member"].values()) == 4
    fleet.stop()


def test_tiering_wake_survives_proc_kill_fence(tmp_path):
    """A hibernated ticket belongs to no member: the loopback
    ``proc_kill`` fencing one member while scenarios sleep changes nothing;
    wakes land on the survivor or the replacement and everything serves
    with zero sheds."""
    from mpi_model_tpu_torch.ensemble import scenario_nbytes

    clock = {"t": 0.0}
    one = scenario_nbytes(scen_space(0))
    fleet = proc_fleet(services=2, clock=lambda: clock["t"],
                       heartbeat_deadline_s=1.0, residency_budget=one + 1,
                       hibernate_dir=str(tmp_path / "wire-tk"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        tickets = [fleet.submit(scen_space(i)) for i in range(4)]
        assert fleet.stats()["hibernated_scenarios"] >= 2
        victim = _victim_with_work(fleet)
        with inject.armed(FaultPlan(
                (Fault("proc_kill", channel=victim),))):
            fleet.pump_once()   # the kill lands on a wire RPC
            clock["t"] = 2.0    # past the heartbeat deadline
            fleet.pump_once()
            outs = [fleet.result(t) for t in tickets]
    stats = fleet.stats()
    fleet.stop()
    assert len(outs) == 4
    assert stats["respawns"] >= 1
    assert stats["shed"] == 0
    assert stats["wakes"] >= 2


# -- real spawned children (slow) ---------------------------------------------

def _wait_until(pred, timeout_s=120.0):
    """Poll without a wall sleep in test code (``Event.wait`` paces it)."""
    ev = threading.Event()
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        ev.wait(0.05)
    return False


@pytest.mark.slow
def test_real_process_members_serve_and_survive_kill_dash_nine(tmp_path):
    """Real CPU children, a real ``kill -9`` of the one holding the queue
    mid-stream: the supervisor fences it on its dead wire and stale
    heartbeats, respawns generation + 1, re-admits from the fleet's copy,
    every ticket serves, and the journal audit is exactly-once."""
    jdir = str(tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        fleet = FleetSupervisor(
            scen_model(), services=2, steps=400, start=True,
            member_transport="process", journal_dir=jdir,
            heartbeat_deadline_s=0.5, tick_interval_s=0.05,
            rpc_deadline_s=60.0, max_wait_s=0.0, max_batch=1,
            retry="solo", device="cpu")
        tickets = [fleet.submit(scen_space(i, g=32, dtype="float32"))
                   for i in range(6)]
        assert _wait_until(lambda: any(
            s["pending"] > 0 and s.get("member_pid")
            for s in fleet.stats()["services"]))
        victim = next(s for s in fleet.stats()["services"]
                      if s["pending"] > 0)
        os.kill(victim["member_pid"], signal.SIGKILL)
        outs = [fleet.result(t, timeout=300) for t in tickets]
        st = fleet.stats()
        fleet.stop()
    assert len(outs) == 6
    assert st["respawns"] >= 1 and st["member_faults"] >= 1
    assert victim["service_id"] not in {
        s["service_id"] for s in st["services"]}
    audit = audit_journal(journal_path(jdir))
    assert audit["ok"] and not audit["unresolved"]
    assert audit["submits"] == 6


@pytest.mark.slow
def test_real_process_results_bitwise_equal_inproc():
    model = scen_model()
    spaces = [scen_space(i) for i in range(3)]
    inproc = FleetSupervisor(model, services=2, steps=4, start=False,
                             device="cpu")
    want = [inproc.result(inproc.submit(s))[0] for s in spaces]
    inproc.stop()
    fleet = FleetSupervisor(model, services=2, steps=4, start=True,
                            member_transport="process",
                            heartbeat_deadline_s=30.0,
                            rpc_deadline_s=120.0, device="cpu")
    got = [fleet.result(fleet.submit(s), timeout=300)[0] for s in spaces]
    fleet.stop()
    for g, w in zip(got, want):
        assert torch.equal(g.values["value"], w.values["value"])


@pytest.mark.slow
def test_member_env_pins_each_real_members_environment():
    """Two real CPU children with per-slot ``member_env`` pins: each child's
    telemetry reports its own pin (``CUDA_VISIBLE_DEVICES`` as the child
    read it; on the card, its device set), and the fleet serves bit for bit
    through both."""
    model = scen_model()
    spaces = [scen_space(i) for i in range(4)]
    inproc = FleetSupervisor(model, services=2, steps=4, start=False,
                             device="cpu")
    want = [inproc.result(inproc.submit(s))[0] for s in spaces]
    inproc.stop()
    fleet = FleetSupervisor(
        model, services=2, steps=4, start=True, member_transport="process",
        heartbeat_deadline_s=30.0, rpc_deadline_s=120.0, device="cpu",
        member_env=[{"CUDA_VISIBLE_DEVICES": ""},
                    {"CUDA_VISIBLE_DEVICES": "-1"}])
    try:
        assert _wait_until(lambda: all(
            s.get("backend") for s in fleet.stats()["services"]))
        by_slot = {s["slot"]: s["backend"]
                   for s in fleet.stats()["services"]}
        assert by_slot[0]["cuda_visible_devices"] == ""
        assert by_slot[1]["cuda_visible_devices"] == "-1"
        assert all(b["platform"] == "cpu" for b in by_slot.values())
        got = [fleet.result(fleet.submit(s), timeout=300)[0]
               for s in spaces]
    finally:
        fleet.stop()
    for g, w in zip(got, want):
        assert torch.equal(g.values["value"], w.values["value"])
