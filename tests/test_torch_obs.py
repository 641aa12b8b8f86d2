"""The port's telemetry plane (``mpi_model_tpu_torch.obs``: the flight
recorder, the snapshot document, the Prometheus text, the status
endpoint, the operator command line) and the serving stack's records into
it, on the CPU; held against the JAX package's ``obs`` on the same stats
(the single-service cases of ``tests/test_obs.py``)."""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from mpi_model_tpu import obs as jobs

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch import obs
from mpi_model_tpu_torch.ensemble import AsyncEnsembleService, run_soak
from mpi_model_tpu_torch.obs import FlightRecorder, set_recorder
from mpi_model_tpu_torch.obs.__main__ import main as obs_main
from mpi_model_tpu_torch.resilience.inject import Fault, FaultPlan, armed
from mpi_model_tpu_torch.utils import Tracer, set_tracer
from mpi_model_tpu_torch.utils.metrics import (LatencyReservoir,
                                               ThroughputCounter)

BASE = np.random.default_rng(20).uniform(0.5, 2.0, (16, 16))


def scen_space(i):
    return mt.CellularSpace.create(16, 16, 1.0, dtype="float64",
                                   device="cpu").with_values(
        {"value": torch.from_numpy(np.roll(BASE, 3 * i, axis=0).copy())})


def scen_model(i=0):
    return mt.Model(mt.Diffusion(0.05 + 0.01 * i), 4.0, 1.0)


@pytest.fixture
def fresh_obs():
    """A private tracer and flight recorder as the process defaults."""
    tr, rec = Tracer(), FlightRecorder()
    prev_tr, prev_rec = set_tracer(tr), set_recorder(rec)
    try:
        yield tr, rec
    finally:
        set_tracer(prev_tr)
        set_recorder(prev_rec)


def scrape(port: int, path: str) -> tuple[int, str]:
    """One GET against the status endpoint on the loopback."""
    # the loopback only: no proxy from the environment is consulted
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def prom_values(text: str) -> dict:
    """``name{labels} value`` lines → {name{labels}: value}."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, v = line.rsplit(" ", 1)
            out[name] = float(v)
    return out


# -- LatencyReservoir ---------------------------------------------------------

def test_latency_reservoir_bounded_and_percentiles():
    r = LatencyReservoir(maxlen=4)
    for v in (5.0, 1.0, 2.0, 3.0, 4.0):  # the 5.0 ages out
        r.record(v)
    snap = r.snapshot("lat")
    assert snap["lat_n"] == 4
    assert snap["lat_p50_s"] in (2.0, 3.0)
    assert snap["lat_p99_s"] == 4.0
    assert LatencyReservoir.percentile_of([], 0.5) is None
    assert LatencyReservoir().snapshot("x") == {
        "x_n": 0, "x_p50_s": None, "x_p99_s": None}
    c = ThroughputCounter()
    assert isinstance(c._latencies, LatencyReservoir)
    c.record_latency(0.25)
    s = c.snapshot()
    assert s["latency_p50_s"] == 0.25 and s["latency_n"] == 1


# -- flight recorder ----------------------------------------------------------

def test_flight_recorder_ring_is_bounded_per_service():
    rec = FlightRecorder(capacity=3)
    for i in range(5):
        rec.record("submit", service_id="m0g0", ticket=i)
    rec.record("submit", ticket=9)
    assert [e["ticket"] for e in rec.snapshot("m0g0")] == [2, 3, 4]
    assert [e["ticket"] for e in rec.snapshot("fleet")] == [9]
    assert len(rec.snapshot()) == 4


def test_flight_recorder_dump_merges_service_and_fleet_rings(tmp_path):
    rec = FlightRecorder(dump_dir=str(tmp_path))
    rec.record("submit", service_id=None, ticket=1)
    rec.record("dispatch", service_id="m0g0", ticket=1)
    d = rec.dump("quarantine", service_id="m0g0", ticket=1)
    assert [e["kind"] for e in d["events"]] == ["submit", "dispatch"]
    assert d["path"].endswith("flight-0001-quarantine.json")
    with open(d["path"]) as fh:
        on_disk = json.load(fh)
    assert on_disk["reason"] == "quarantine" and on_disk["ticket"] == 1
    assert rec.dumps[-1] is d
    # the same dump from the JAX package's recorder has the same fields
    jrec = jobs.FlightRecorder()
    jrec.record("submit", service_id=None, ticket=1)
    assert set(jrec.dump("quarantine", service_id="m0g0", ticket=1)) == \
        set(d)


def test_flight_recorder_dump_list_is_bounded(tmp_path):
    rec = FlightRecorder(max_dumps=2, dump_dir=str(tmp_path / "no" / "x"))
    for i in range(4):
        rec.dump(f"r{i}")
    assert [d["reason"] for d in rec.dumps] == ["r2", "r3"]
    assert rec.dump_ledger() == list(rec.dumps)
    # an unwritable dump directory leaves path None, never raises
    (tmp_path / "file").write_text("")
    bad = FlightRecorder(dump_dir=str(tmp_path / "file" / "sub"))
    assert bad.dump("x")["path"] is None


def test_serving_lifecycle_lands_in_the_recorder(fresh_obs):
    _, rec = fresh_obs
    svc = AsyncEnsembleService(scen_model(), steps=2, start=False,
                               service_id="m0g0", max_queue=2)
    t = [svc.submit(scen_space(i)) for i in range(2)]
    with pytest.raises(mt.ServiceOverloaded):
        svc.submit(scen_space(2))
    for x in t:
        svc.result(x)
    svc.stop()
    kinds = [(e["kind"], e["ticket"]) for e in rec.snapshot("m0g0")]
    assert kinds == [("submit", 0), ("submit", 1), ("shed", None),
                     ("served", 0), ("served", 1)]
    assert rec.snapshot("m0g0")[2]["depth"] == 2


def test_quarantine_dumps_the_flight_recorder(fresh_obs):
    _, rec = fresh_obs
    svc = AsyncEnsembleService(scen_model(), steps=4, start=False,
                               retry="solo")
    with armed(FaultPlan((Fault("lane_nan", lane=0, once=False),))):
        t = svc.submit(scen_space(0))
        with pytest.raises(Exception):
            svc.result(t)
    svc.stop()
    d = next(d for d in rec.dumps if d["reason"] == "quarantine")
    assert d["ticket"] == t
    assert any(e["kind"] == "submit" and e["ticket"] == t
               for e in d["events"])
    assert any(e["kind"] == "quarantined" and e["ticket"] == t
               for e in d["events"])
    assert [e["kind"] for e in rec.snapshot("fleet")][-1] == "failed"


def test_expired_ticket_is_recorded(fresh_obs):
    _, rec = fresh_obs
    clock = {"t": 0.0}
    svc = AsyncEnsembleService(scen_model(), steps=2, start=False,
                               deadline_s=1.0, clock=lambda: clock["t"],
                               max_wait_s=10.0, max_batch=4)
    t = svc.submit(scen_space(0))
    clock["t"] = 2.0
    with pytest.raises(mt.TicketExpired):
        svc.result(t)
    svc.stop()
    ev = next(e for e in rec.snapshot() if e["kind"] == "expired")
    assert ev["ticket"] == t and ev["queued_s"] == 2.0


# -- the telemetry plane ------------------------------------------------------

def test_snapshot_validates_for_a_service(fresh_obs, tmp_path):
    svc = AsyncEnsembleService(scen_model(), steps=4, start=False)
    t = svc.submit(scen_space(0))
    svc.result(t)
    svc.stop()
    doc = obs.fleet_snapshot(svc)
    obs.validate_snapshot(doc)
    jobs.validate_snapshot(doc)  # the JAX package's gate accepts it
    assert doc["schema"] == jobs.SCHEMA == obs.SCHEMA
    assert doc["stats"]["scenarios"] == 1
    assert doc["tracer"]["dropped"] == 0
    for name in ("ensemble.assemble", "ensemble.launch", "ensemble.fetch"):
        st = doc["tracer"]["stages"][name]
        assert st["count"] == 1 and 0 <= st["p50_s"] <= st["max_s"]
    path = str(tmp_path / "snap.json")
    doc2 = obs.write_snapshot(path, svc)
    with open(path) as fh:
        jobs.validate_snapshot(json.load(fh))
    assert doc2["stats"] == doc["stats"]
    assert not list(tmp_path.glob("*.tmp.*"))  # tmp and rename


def test_snapshot_matches_the_jax_package_on_the_same_cut(fresh_obs):
    tr, rec = fresh_obs
    with tr.span("stage"):
        pass
    rec.dump("quarantine", ticket=1)
    svc = AsyncEnsembleService(scen_model(), steps=2, start=False)
    svc.result(svc.submit(scen_space(0)))
    svc.stop()
    st = svc.stats()
    mine = obs.fleet_snapshot(stats=st)
    theirs = jobs.fleet_snapshot(stats=st, tracer=tr, recorder=rec)
    for doc in (mine, theirs):
        doc.pop("generated_unix_s")
    assert mine == theirs
    assert mine["flight_recorder"]["dump_reasons"] == ["quarantine"]
    with pytest.raises(ValueError, match="stats"):
        obs.fleet_snapshot()


def test_snapshot_schema_gate_names_the_missing_field():
    with pytest.raises(ValueError, match="schema"):
        obs.validate_snapshot({"stats": {}})
    doc = {"schema": obs.SCHEMA, "generated_unix_s": 0.0,
           "stats": {"dispatches": 0}, "tracer": {},
           "flight_recorder": {}}
    with pytest.raises(ValueError, match="scenarios"):
        obs.validate_snapshot(doc)
    ok = {k: 0 for k in obs._REQUIRED_STATS}
    with pytest.raises(ValueError, match="dropped"):
        obs.validate_snapshot(dict(doc, stats=ok))
    with pytest.raises(ValueError, match="schema"):
        obs.validate_snapshot(dict(doc, stats=ok, schema="other/1",
                                   tracer={"dropped": 0, "stages": {}}))
    with pytest.raises(ValueError, match="not a dict"):
        obs.validate_snapshot([])


def test_prometheus_text_is_the_jax_package_s(fresh_obs):
    svc = AsyncEnsembleService(scen_model(), steps=2, start=False,
                               service_id="m0g0")
    svc.result(svc.submit(scen_space(0)))
    svc.stop()
    st = svc.stats()
    text = obs.prometheus_text(st)
    assert text == jobs.prometheus_text(st)
    for name in ThroughputCounter.COUNTERS:
        if name in st:
            assert f"# TYPE mpi_model_tpu_{name} counter" in text, name
    assert "# TYPE mpi_model_tpu_pending gauge" in text
    assert prom_values(text)["mpi_model_tpu_scenarios"] == 1.0
    # a fleet-shaped cut: members labelled by service_id
    fleet = {"dispatches": 3, "shed": 1,
             "services": [dict(st, service_id="m0g0"),
                          dict(st, service_id="m1g0")]}
    ftext = obs.prometheus_text(fleet)
    assert ftext == jobs.prometheus_text(fleet)
    assert 'mpi_model_tpu_dispatches{service_id="m1g0"}' in ftext


def test_jsonable_projects_numpy_and_tuples():
    x = {"a": np.int64(3), "b": np.float32(0.5), "c": (1, 2),
         "d": np.arange(2), 4: object}
    got = obs.jsonable(x)
    assert got["a"] == 3 and got["b"] == 0.5 and got["c"] == [1, 2]
    assert got["d"] == [0, 1] and got["4"] == repr(object)
    assert got == jobs.jsonable(x)


def test_run_soak_dumps_snapshots_on_an_interval(fresh_obs, tmp_path,
                                                 monkeypatch):
    clock = {"t": 0.0}

    def fake_sleep(dt):
        clock["t"] += dt

    writes = []
    real = obs.write_snapshot

    def counted(path, service=None, **kw):
        writes.append(clock["t"])
        return real(path, service, **kw)

    monkeypatch.setattr(obs, "write_snapshot", counted)
    path = str(tmp_path / "soak-snap.json")
    svc = AsyncEnsembleService(scen_model(), steps=4, start=False,
                               clock=lambda: clock["t"])
    scen = [(scen_space(i), None, None) for i in range(6)]
    rep = run_soak(svc, scen, arrival_rate_hz=1.0,
                   clock=lambda: clock["t"], sleep=fake_sleep,
                   snapshot_path=path, snapshot_interval_s=2.0)
    svc.stop()
    assert rep["ledger_complete"] and rep["served"] == 6
    assert rep["telemetry_snapshot"] == path
    with open(path) as fh:
        doc = json.load(fh)
    obs.validate_snapshot(doc)
    jobs.validate_snapshot(doc)
    assert doc["stats"]["scenarios"] == 6  # the final cut
    # arrivals over 5 s of clock at a 2 s interval: the cuts at 2 and 4 s,
    # then the final one
    assert len(writes) == 3 and writes[0] >= 2.0 and writes[1] >= 4.0


def test_run_soak_serves_the_status_endpoint(fresh_obs, monkeypatch):
    """A /metrics scrape while the soak runs (after its last ticket
    resolved, before the endpoint is torn down) parses, and its dispatch
    count is the service's final one; / serves the snapshot."""
    servers = []
    real = obs.serve_status

    def capture(port, fn, host="127.0.0.1"):
        servers.append(real(port, fn, host=host))
        return servers[-1]

    monkeypatch.setattr(obs, "serve_status", capture)
    svc = AsyncEnsembleService(scen_model(), steps=2, start=False)
    scrapes = []

    class Scraped:
        """The service, scraped after every result."""

        def submit(self, *a, **k):
            return svc.submit(*a, **k)

        def result(self, t, **k):
            out = svc.result(t, **k)
            port = servers[0].server_address[1]
            scrapes.append((scrape(port, "/metrics"), scrape(port, "/")))
            return out

        def stats(self):
            return svc.stats()

    rep = run_soak(Scraped(), [(scen_space(i), None, None)
                               for i in range(5)],
                   arrival_rate_hz=1e9, status_port=0)
    svc.stop()
    assert rep["ledger_complete"] and len(scrapes) == 5
    (code, text), (code2, body) = scrapes[-1]
    assert code == code2 == 200
    assert prom_values(text)["mpi_model_tpu_dispatches"] == \
        svc.stats()["dispatches"] == rep["dispatches"]
    jobs.validate_snapshot(json.loads(body))
    # the endpoint is gone with the soak
    with pytest.raises(OSError):
        scrape(servers[0].server_address[1], "/metrics")


def test_serve_status_answers_errors_and_refuses_a_bound_port():
    calls = {"n": 0}

    def snap():
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("torn")
        return {"stats": {"dispatches": 7}}

    server = obs.serve_status(0, snap)
    try:
        port = server.server_address[1]
        code, text = scrape(port, "/metrics")
        assert code == 200 and prom_values(text) == {
            "mpi_model_tpu_dispatches": 7.0}
        code, text = scrape(port, "/snapshot")
        assert code == 500 and "torn" in text
        assert scrape(port, "/nope")[0] == 404
        with pytest.raises(OSError):
            obs.serve_status(port, snap)
    finally:
        server.shutdown()
        server.server_close()


def test_dispatch_spans_parent_under_the_submit_span(fresh_obs):
    """The pump thread launches and fetches; each dispatch span parents
    under the submitting thread's span through the ticket's context."""
    tr, _ = fresh_obs
    with AsyncEnsembleService(scen_model(), steps=2, max_batch=1,
                              buckets=(1,)) as svc:
        subs = {}
        for i in range(3):
            with tr.span("client.submit", i=i):
                subs[svc.submit(scen_space(i))] = tr.current()
        for t in subs:
            svc.result(t, timeout=60)
    by_ticket = {}
    for s in tr.spans:
        if s.name.startswith("ensemble."):
            by_ticket.setdefault(s.meta["tickets"][0], []).append(s)
            assert s.thread != threading.get_ident()
    for t, ctx in subs.items():
        spans = by_ticket[t]
        assert sorted(s.name for s in spans) == [
            "ensemble.assemble", "ensemble.fetch", "ensemble.launch"]
        for s in spans:
            assert (s.parent_id, s.trace_id) == (ctx.span_id, ctx.trace_id)
            assert s.meta["trace_ids"] == [ctx.trace_id]
            assert s.depth == 0  # from the pump's own (empty) stack
    launch = next(s for s in by_ticket[0] if s.name == "ensemble.launch")
    assert launch.meta["cache_hit"] is False and launch.meta["bucket"] == 1


def test_disabled_tracer_leaves_serving_results_unchanged():
    outs = []
    for enabled in (True, False):
        tr = Tracer(enabled=enabled)
        prev = set_tracer(tr)
        try:
            svc = AsyncEnsembleService(scen_model(), steps=3, start=False)
            res = [svc.result(svc.submit(scen_space(i))) for i in range(2)]
            svc.stop()
        finally:
            set_tracer(prev)
        outs.append([r[0].values["value"] for r in res])
        assert bool(tr.spans) is enabled
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# -- the operator command line ---------------------------------------------------

def test_obs_cli_validate_and_prom(fresh_obs, tmp_path, capsys):
    svc = AsyncEnsembleService(scen_model(), steps=2, start=False)
    svc.result(svc.submit(scen_space(0)))
    svc.stop()
    path = str(tmp_path / "s.json")
    obs.write_snapshot(path, svc)
    assert obs_main(["validate", path]) == 0
    assert "validates against mpi-model-tpu.obs/1" in capsys.readouterr().out
    assert obs_main(["prom", path]) == 0
    out = capsys.readouterr().out
    assert out == jobs.prometheus_text(json.load(open(path))["stats"])
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": obs.SCHEMA}))
    assert obs_main(["validate", str(bad)]) == 1
    assert "INVALID" in capsys.readouterr().err
    for argv, msg in ((["timeline", "3"], "--journal"),
                      (["--serve", "0"], "--snapshot"),
                      (["--serve", "0", "--snapshot", path, "prom", path],
                       "no subcommand"),
                      ([], "subcommand")):
        with pytest.raises(SystemExit):
            obs_main(argv)
        assert msg in capsys.readouterr().err
    # the timeline of a ticket the journal never saw is incomplete, with
    # its explicit uncertainty record, as JAX's is
    tl = obs.timeline(3, journal_dir=str(tmp_path))
    assert not tl.complete
    assert [e.kind for e in tl.gaps] == ["uncertainty"]
    assert obs_main(["timeline", "3", "--journal", str(tmp_path)]) == 1
    assert "INCOMPLETE" in capsys.readouterr().out
    # the JAX package's command line reads the port's document
    from mpi_model_tpu.obs.__main__ import main as jobs_main

    assert jobs_main(["validate", path]) == 0
