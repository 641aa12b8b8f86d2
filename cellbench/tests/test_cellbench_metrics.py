"""The per-layer readers' arithmetic on synthetic spans and device
timelines, and the work count against the kernel table's times."""

from types import SimpleNamespace

import pytest

from cellbench import registry, work
from cellbench.timeline import Timeline

H100 = work.peak("NVIDIA H100 80GB HBM3")


def span(name, start, dur, sid, parent=None):
    return SimpleNamespace(name=name, start_s=start, duration_s=dur,
                           span_id=sid, parent_id=parent)


def grid_spans():
    out = []
    for i in range(4):
        t = i * 0.02
        out.append(span("model.execute", t, 0.019, f"e{i}"))
        out.append(span("executor.run", t + 0.001, 0.017, f"r{i}", f"e{i}"))
        out.append(span("model.report", t + 0.018, 0.001, f"p{i}", f"e{i}"))
    return out


def test_execute_host_ms_is_the_parent_less_its_run():
    rec = {"spans": grid_spans()}
    v = registry.metric("execute_host_ms.grid").read(rec)
    assert v == pytest.approx(2.0)


def test_dispatch_host_ms_is_assemble_plus_launch_per_dispatch():
    spans = []
    for i in range(5):
        spans += [span("ensemble.assemble", i, 0.0005, f"a{i}"),
                  span("ensemble.launch", i + 0.001, 0.0015, f"l{i}"),
                  span("ensemble.fetch", i + 0.003, 0.003, f"f{i}")]
    v = registry.metric("dispatch_host_ms.sweep").read({"spans": spans})
    assert v == pytest.approx(2.0)


def timeline():
    # 10 ms traced (profiler µs 1000..11000), perf offset 1000 µs; kernels
    # busy 1000-5000 and 6000-9000 (one overlap), idle 5000-6000 and
    # 9000-11000
    ops = [("k1", 500, 3000), ("k1", 2500, 5000), ("sum", 6000, 8000),
           ("memcpy", 7500, 9000), ("late", 12000, 13000)]
    return Timeline(ops, 1000, 11000, 1000)


def test_timeline_busy_gaps_and_tops():
    tl = timeline()
    assert tl.window_s == pytest.approx(0.010)
    assert tl.busy_s == pytest.approx(0.007)
    assert [g[1] for g in tl.gaps()] == [1000, 2000]
    top = dict(tl.top_ops())
    assert top["k1"] == pytest.approx(0.0045) and "late" not in top
    assert tl.perf_window() == pytest.approx((0.0, 0.010))
    spans = [span("outer", 0.0, 0.010, "o"), span("inner", 0.0039, 0.0015,
                                                  "i", "o")]
    gaps = tl.top_gaps(spans)
    assert gaps[0] == ["outer", pytest.approx(0.002)]
    assert gaps[1] == ["inner", pytest.approx(0.001)]
    assert timeline().top_gaps([])[0][0] == "no span"


@pytest.mark.parametrize("cls", ["grid", "sweep"])
def test_idle_share(cls):
    v = registry.metric(f"device_idle_share.{cls}").read(
        {"timeline": timeline()})
    assert v == pytest.approx(30.0)


@pytest.mark.parametrize("cls", ["grid", "sweep"])
def test_roofline_share_and_step_mfu(cls):
    rec = {"timeline": timeline(), "work_roofline_s": 0.0014}
    assert registry.metric(f"kernel_roofline_share.{cls}").read(rec) == \
        pytest.approx(20.0)
    assert registry.metric(f"step_mfu.{cls}").read(rec) == \
        pytest.approx(14.0)
    # nothing traced, or no peak for the card: nothing read, never 0
    assert registry.metric(f"step_mfu.{cls}").read(
        {"timeline": timeline()}) is None
    empty = Timeline([], 0, 1000, 0)
    assert registry.metric(f"kernel_roofline_share.{cls}").read(
        {"timeline": empty, "work_roofline_s": 1e-4}) is None


def test_batch_occupancy_over_the_window():
    s0 = {"scenarios": 12, "batch_occupancy": 12 / 15}
    s1 = {"scenarios": 112, "batch_occupancy": 112 / 125}
    v = registry.metric("batch_occupancy.sweep").read({"stats": (s0, s1)})
    assert v == pytest.approx(100 * 100 / 110)


def test_batch_occupancy_reads_nothing_without_dispatches():
    s = {"scenarios": 12, "batch_occupancy": 12 / 15}
    assert registry.metric("batch_occupancy.sweep").read({"stats": (s, s)}) \
        is None
    assert registry.metric("batch_occupancy.sweep").read({}) is None


@pytest.mark.parametrize("conf,ops", [("moore8_f32", 11), ("field4_f32", 25)])
def test_operations_a_cell_step(conf, ops):
    assert work.ops_per_cell_step(registry.config(conf)) == ops


# PERF.md's kernel table: K1 f32 ns=8 2.144 ms a launch (8 a 64-step call at
# 16384², byte bound 0.641 ms), K4 2.490 (8 a call at 8192², 0.321 ms), K5
# 2.131 ms a dispatch of 8 × 4096² scenarios of 8 steps (0.321 ms)
@pytest.mark.parametrize("conf,side,steps,lanes,kernel_ms,bytes_ms", [
    ("moore8_f32", 16384, 64, 1, 8 * 2.144, 0.641),
    ("field4_f32", 8192, 64, 1, 8 * 2.490, 0.321),
    ("moore8_f32", 4096, 8, 8, 2.131, 0.321),
])
def test_work_gives_a_share_at_most_100_at_the_table_times(
        conf, side, steps, lanes, kernel_ms, bytes_ms):
    w = work.run_work(registry.config(conf), side * side, steps)
    w = {k: v * lanes for k, v in w.items()}
    assert 1e3 * w["bytes"] / H100["bytes_per_s"] == pytest.approx(
        bytes_ms, rel=2e-3)
    share = 100 * 1e3 * work.roofline_s(w, H100) / kernel_ms
    assert 5.0 < share <= 100.0


def test_unknown_card_has_no_peak():
    assert work.peak("NVIDIA A100-SXM4-40GB") is None
