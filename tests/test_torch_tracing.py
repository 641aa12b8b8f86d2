"""The port's tracer (``mpi_model_tpu_torch.utils.tracing``) against the JAX
package's: the unit cases of ``tests/test_tracing.py`` on the port, the
framework's own spans (``Model.execute``, the sharded executor's builds,
the supervisor), and the formats the two packages exchange (span dicts,
Chrome events, JSONL lines, trace contexts)."""

import json
import os
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mpi_model_tpu as mm
from mpi_model_tpu.utils import tracing as jtracing

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch.utils import (Tracer, get_tracer, set_tracer,
                                       trace_span)
from mpi_model_tpu_torch.utils.tracing import Span, TraceContext

CPU = torch.device("cpu")


@pytest.fixture
def tracer():
    """A private tracer installed as the port's process default."""
    tr = Tracer()
    prev = set_tracer(tr)
    try:
        yield tr
    finally:
        set_tracer(prev)


@pytest.fixture
def jax_ir(monkeypatch):
    """JAX's plain Diffusion step lowers through its IR, whose barrier
    (``compat.optimization_barrier``) fails under this jax; the primitive
    itself runs."""
    import jax

    from mpi_model_tpu.ir import lower as jlower

    monkeypatch.setattr(jlower, "optimization_barrier",
                        jax.lax.optimization_barrier)


# -- the unit cases of tests/test_tracing.py, on the port ----------------------

def test_nested_spans_depth_and_duration():
    tr = Tracer()
    with tr.span("outer", job=1):
        with tr.span("inner"):
            pass
    inner, outer = tr.spans
    assert (inner.name, outer.name) == ("inner", "outer")
    assert inner.depth == 1 and outer.depth == 0
    assert 0 <= inner.duration_s <= outer.duration_s
    assert outer.meta == {"job": 1}
    assert outer.start_s <= inner.start_s
    assert (inner.start_s + inner.duration_s
            <= outer.start_s + outer.duration_s + 1e-9)


def test_span_recorded_on_exception():
    tr = Tracer()
    with pytest.raises(ValueError):
        with tr.span("boom"):
            raise ValueError("x")
    assert [s.name for s in tr.spans] == ["boom"]
    assert tr.current() is None  # the context stack unwound


def test_summary_aggregates():
    tr = Tracer()
    for _ in range(3):
        with tr.span("a"):
            pass
    with tr.span("b"):
        pass
    s = tr.summary()
    assert s["a"]["count"] == 3 and s["b"]["count"] == 1
    assert s["a"]["total_s"] >= s["a"]["max_s"] >= s["a"]["mean_s"] >= 0


def test_disabled_tracer_records_nothing():
    tr = Tracer(enabled=False)
    with tr.span("a") as meta:
        tr.instant("marker")
        meta["k"] = 1
    assert tr.spans == [] and tr.current() is None


def test_ring_buffer_bounds_memory():
    tr = Tracer(max_spans=5)
    for i in range(9):
        tr.instant("m", i=i)
    spans = tr.spans
    assert len(spans) == 5 and tr.dropped == 4
    assert [s.meta["i"] for s in spans] == [4, 5, 6, 7, 8]
    tr.clear()
    assert tr.spans == [] and tr.dropped == 0


def test_thread_safety_and_per_thread_nesting():
    tr = Tracer()
    # every thread alive at once: thread idents are reused after exit
    barrier = threading.Barrier(8)

    def work(i):
        barrier.wait(timeout=30)
        with tr.span("outer", i=i):
            with tr.span("inner", i=i):
                pass
        barrier.wait(timeout=30)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    spans = tr.spans
    assert len(spans) == 16
    for s in spans:
        assert s.depth == (1 if s.name == "inner" else 0)
    assert len({s.thread for s in spans}) == 8
    outer = {s.span_id: s for s in spans if s.name == "outer"}
    for s in spans:
        if s.name == "inner":  # each inner under its own thread's outer
            assert outer[s.parent_id].thread == s.thread


def test_chrome_export(tmp_path):
    tr = Tracer()
    with tr.span("phase", detail="x"):
        pass
    tr.instant("mark")
    path = tr.export_chrome(str(tmp_path / "trace.json"))
    with open(path) as f:
        doc = json.load(f)
    assert doc["dropped"] == 0 and doc["displayTimeUnit"] == "ms"
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    metas = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert len(spans) == 2
    for e in spans:
        assert set(e) >= {"name", "ph", "ts", "dur", "pid", "tid"}
    assert metas and metas[0]["name"] == "process_name"
    assert spans[0]["args"]["detail"] == "x"
    assert spans[0]["args"]["trace_id"] and spans[0]["args"]["span_id"]


def test_trace_span_uses_current_default(tracer):
    with trace_span("x"):
        pass
    assert get_tracer() is tracer
    assert [s.name for s in tracer.spans] == ["x"]


def test_trace_context_ids_nest_and_propagate():
    tr = Tracer()
    with tr.span("outer") as meta:
        meta["k"] = 1
        ctx = tr.current()
        with tr.span("inner"):
            pass
    outer = next(s for s in tr.spans if s.name == "outer")
    inner = next(s for s in tr.spans if s.name == "inner")
    assert outer.meta == {"k": 1}
    assert outer.span_id == ctx.span_id and outer.parent_id is None
    assert inner.trace_id == outer.trace_id
    assert inner.parent_id == outer.span_id != inner.span_id
    assert outer.span_id.startswith(f"{os.getpid():x}-")


def test_attach_adopts_a_remote_context():
    tr = Tracer()
    with tr.span("root"):
        wire_meta = tr.current().to_meta()
    ctx = TraceContext.from_meta(wire_meta)
    with tr.attach(ctx):
        with tr.span("remote-child"):
            pass
    root = next(s for s in tr.spans if s.name == "root")
    child = next(s for s in tr.spans if s.name == "remote-child")
    assert child.trace_id == root.trace_id
    assert child.parent_id == root.span_id
    assert TraceContext.from_meta(None) is None
    assert TraceContext.from_meta({"trace_id": 1}) is None
    with tr.attach(None):
        assert tr.current() is None


def test_explicit_parent_overrides_thread_context():
    tr = Tracer()
    with tr.span("ticket-submit"):
        ticket_ctx = tr.current()
    with tr.span("pump-iteration"):
        with tr.span("dispatch", parent=ticket_ctx):
            pass
    dispatch = next(s for s in tr.spans if s.name == "dispatch")
    submit = next(s for s in tr.spans if s.name == "ticket-submit")
    assert dispatch.parent_id == submit.span_id
    assert dispatch.trace_id == submit.trace_id


def test_spans_since_and_ingest_roundtrip():
    tr = Tracer()
    with tr.span("a"):
        pass
    cur, delta = tr.spans_since(0)
    assert [d["name"] for d in delta] == ["a"]
    cur2, delta2 = tr.spans_since(cur)
    assert delta2 == [] and cur2 == cur
    with tr.span("b"):
        pass
    _, delta3 = tr.spans_since(cur)
    assert [d["name"] for d in delta3] == ["b"]
    tr2 = Tracer()
    assert tr2.ingest(delta) == 0  # this process's own spans are skipped
    foreign = [dict(d, pid=999_999) for d in delta]
    assert tr2.ingest(foreign, label="m3g1") == 1
    s = tr2.spans[0]
    assert s.pid == 999_999 and s.name == "a"
    names = {e["args"]["name"] for e in tr2.chrome_events()
             if e["ph"] == "M"}
    assert "m3g1" in names


def test_summary_surfaces_dropped_and_percentiles(tmp_path):
    tr = Tracer(max_spans=2)
    for _ in range(4):
        with tr.span("x"):
            pass
    s = tr.summary()
    assert s["__tracer__"] == {"dropped": 2, "recorded": 2}
    assert s["x"]["count"] == 2
    assert 0 <= s["x"]["p50_s"] <= s["x"]["p99_s"] <= s["x"]["max_s"]
    path = tr.export_chrome(str(tmp_path / "t.json"))
    with open(path) as f:
        assert json.load(f)["dropped"] == 2


def test_export_stream_writes_spans_as_they_complete(tmp_path):
    path = str(tmp_path / "spans.jsonl")
    with open(path, "w") as fh:
        fh.write('{"name": "torn')  # a killed writer's torn last line
    tr = Tracer()
    tr.export_stream(path)
    with tr.span("a", k=1):
        pass
    tr.instant("b")
    assert tr.close_stream() == path
    assert tr.close_stream() is None
    with tr.span("after"):
        pass
    lines = open(path).read().splitlines()
    assert lines[0] == '{"name": "torn'
    got = [json.loads(x) for x in lines[1:]]
    assert [d["name"] for d in got] == ["a", "b"]
    assert got[0]["meta"] == {"k": 1}
    assert set(got[0]) == set(Span("x", 0.0, 0.0, 0, 0).to_dict())


def test_device_trace_writes_a_chrome_profile(tmp_path):
    tr = Tracer()
    logdir = str(tmp_path / "prof")
    with tr.device_trace(logdir):
        torch.ones(64, 64).sum()
    assert [s.name for s in tr.spans] == ["device_trace"]
    assert tr.spans[0].meta == {"logdir": logdir}
    with open(os.path.join(logdir, "device_trace.pt.trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "aten::sum" for e in events)


# -- the port's own spans --------------------------------------------------------

def test_model_execute_emits_phases(tracer):
    space = mt.CellularSpace.create(8, 8, 1.0, dtype="float64", device=CPU)
    mt.Model(mt.Diffusion(0.1), 2.0, 1.0).execute(space)
    names = [s.name for s in tracer.spans]
    assert names == ["executor.run", "model.report", "model.execute"]
    ex = tracer.spans[-1]
    assert ex.meta == {"steps": 2, "executor": "SerialExecutor"}
    run, report = tracer.spans[:2]
    assert run.depth == report.depth == ex.depth + 1
    assert run.parent_id == report.parent_id == ex.span_id
    assert ex.start_s <= run.start_s <= report.start_s


def test_shardmap_executor_emits_build_phase(tracer):
    mesh = mt.make_mesh_2d(2, 2, devices=[CPU] * 4)
    space = mt.CellularSpace.create(16, 16, 1.0, dtype="float64",
                                    device=CPU)
    model = mt.Model(mt.Diffusion(0.1), 1.0, 1.0)
    ex = mt.ShardMapExecutor(mesh)
    out, _ = model.execute(space, ex)
    model.execute(space, ex)  # the cached runner: no second build
    assert np.isfinite(out.to_numpy()["value"]).all()
    builds = [s for s in tracer.spans if s.name == "shardmap.build"]
    assert len(builds) == 1
    assert builds[0].meta == {"impl": "xla", "depth": 1}
    deep = mt.ShardMapExecutor(mesh, "xla", halo_depth=2)
    model.execute(space, deep, steps=2)
    assert [s.meta["impl"] for s in tracer.spans
            if s.name == "shardmap.build"] == ["xla", "deep-halo"]
    # the plain paths launch no kernel: no compile+first_run span
    assert "shardmap.compile+first_run" not in {s.name
                                                for s in tracer.spans}


def test_supervised_run_emits_chunk_and_failure_spans(tracer):
    from mpi_model_tpu_torch.resilience import supervised_run

    class OnceFaulty:
        comm_size = 1

        def __init__(self):
            self.n = 0
            self.inner = mt.SerialExecutor()

        def run_model(self, m, s, k):
            self.n += 1
            if self.n == 2:
                raise RuntimeError("injected")
            return self.inner.run_model(m, s, k)

    space = mt.CellularSpace.create(8, 8, 1.0, dtype="float64", device=CPU)
    res = supervised_run(mt.Model(mt.Diffusion(0.1), 4.0, 1.0), space,
                         steps=4, every=2, executor=OnceFaulty())
    assert res.recovered_failures == 1
    names = [s.name for s in tracer.spans]
    assert names.count("supervise.chunk") == 3  # 2 good + 1 failed
    fails = [s for s in tracer.spans if s.name == "supervise.failure"]
    assert len(fails) == 1 and fails[0].meta["kind"] == "exception"
    assert fails[0].meta["step"] == 4 and fails[0].meta["attempt"] == 1
    chunks = [s for s in tracer.spans if s.name == "supervise.chunk"]
    assert [c.meta for c in chunks] == [{"start": 0, "steps": 2},
                                        {"start": 2, "steps": 2},
                                        {"start": 2, "steps": 2}]


def test_supervised_flush_failure_is_an_instant_under_a_failing_run(tracer):
    from mpi_model_tpu_torch.resilience import (SimulationFailure,
                                                supervised_run)

    class Manager:
        layout = "full"

        def steps(self):
            return [0]

        def latest(self, device=None):
            return None

        def save(self, *a, **k):
            pass

        def flush(self):
            raise OSError("disk gone")

    class Broken:
        comm_size = 1

        def run_model(self, m, s, k):
            raise RuntimeError("always")

    space = mt.CellularSpace.create(8, 8, 1.0, dtype="float64", device=CPU)
    model = mt.Model(mt.Diffusion(0.1), 2.0, 1.0)
    with pytest.raises(SimulationFailure):
        supervised_run(model, space, Manager(), steps=2, every=1,
                       max_failures=0, executor=Broken())
    assert [s.name for s in tracer.spans
            if s.name.startswith("supervise.f")] == [
        "supervise.failure", "supervise.flush_failed"]
    # a run that succeeds raises its flush failure
    with pytest.raises(OSError, match="disk gone"):
        supervised_run(model, space, Manager(), steps=2, every=1)


# -- against the JAX package -----------------------------------------------------

def test_span_dicts_ingest_across_packages():
    port, jax_tr = Tracer(), jtracing.Tracer()
    with port.span("port.submit", ticket=3):
        with port.span("port.inner"):
            pass
    _, delta = port.spans_since(0)
    foreign = [dict(d, pid=424_242) for d in delta]
    assert jax_tr.ingest(foreign, label="port") == 2
    got = {s.name: s for s in jax_tr.spans}
    assert got["port.inner"].parent_id == got["port.submit"].span_id
    assert got["port.submit"].meta == {"ticket": 3}
    assert [s.to_dict() for s in jax_tr.spans] == foreign
    # and back: JAX's dicts into the port's tracer
    with jax_tr.span("jax.dispatch"):
        pass
    _, jdelta = jax_tr.spans_since(2)
    jforeign = [dict(d, pid=434_343) for d in jdelta]
    assert port.ingest(jforeign, label="jax") == 1
    assert port.spans[-1].to_dict() == jforeign[0]
    assert set(delta[0]) == set(jdelta[0])


def test_chrome_and_jsonl_exports_carry_the_same_keys(tmp_path):
    def record(tr):
        with tr.span("outer", k=1):
            tr.instant("mark")

    out = {}
    for label, tr in (("port", Tracer()), ("jax", jtracing.Tracer())):
        tr.export_stream(str(tmp_path / f"{label}.jsonl"))
        record(tr)
        tr.close_stream()
        tr.export_chrome(str(tmp_path / f"{label}.json"))
        with open(tmp_path / f"{label}.json") as fh:
            doc = json.load(fh)
        with open(tmp_path / f"{label}.jsonl") as fh:
            lines = [json.loads(x) for x in fh]
        out[label] = (doc, lines)
    (pdoc, plines), (jdoc, jlines) = out["port"], out["jax"]
    assert set(pdoc) == set(jdoc)
    assert [(e["name"], e["ph"], sorted(e), sorted(e["args"]))
            for e in pdoc["traceEvents"]] == \
        [(e["name"], e["ph"], sorted(e), sorted(e["args"]))
         for e in jdoc["traceEvents"]]
    assert [sorted(d) for d in plines] == [sorted(d) for d in jlines]
    assert [d["name"] for d in plines] == [d["name"] for d in jlines]
    # a JAX JSONL line is a port Span, and the other way round
    assert Span.from_dict(jlines[0]).to_dict() == jlines[0]
    assert jtracing.Span.from_dict(plines[0]).to_dict() == plines[0]


def test_trace_context_crosses_packages():
    port, jax_tr = Tracer(), jtracing.Tracer()
    with jax_tr.span("jax.submit"):
        meta = jax_tr.current().to_meta()
    with port.attach(TraceContext.from_meta(meta)):
        with port.span("port.dispatch"):
            pass
    sub = jax_tr.spans[0]
    d = port.spans[0]
    assert (d.trace_id, d.parent_id) == (sub.trace_id, sub.span_id)
    assert jtracing.TraceContext.from_meta(
        TraceContext(d.trace_id, d.span_id).to_meta()) == \
        jtracing.TraceContext(d.trace_id, d.span_id)


def test_model_execute_spans_match_the_jax_package(tracer, jax_ir):
    jtr = jtracing.Tracer()
    prev = jtracing.set_tracer(jtr)
    try:
        jspace = mm.CellularSpace.create(8, 8, 1.0, dtype=jnp.float64)
        mm.Model(mm.Diffusion(0.1), 2.0, 1.0).execute(jspace)
    finally:
        jtracing.set_tracer(prev)
    space = mt.CellularSpace.create(8, 8, 1.0, dtype="float64", device=CPU)
    mt.Model(mt.Diffusion(0.1), 2.0, 1.0).execute(space)

    def shape(spans):
        ids = {s.span_id: s.name for s in spans}
        return [(s.name, s.depth, ids.get(s.parent_id), s.meta)
                for s in spans]

    assert shape(tracer.spans) == shape(jtr.spans)
    assert shape(tracer.spans)[-1] == (
        "model.execute", 0, None, {"steps": 2, "executor": "SerialExecutor"})
