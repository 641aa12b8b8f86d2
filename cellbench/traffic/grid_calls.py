"""Traffic kind ``grid_calls``: one grid, stepped by ``Model.execute``
calls run back to back, each call's output space the next call's input (a
closed loop of one client).

Parameters: ``side`` (the grid is ``side``²), ``steps`` a call, the
executor's ``impl`` and ``substeps``, ``warmup_calls`` (set-up calls on the
cell's one shape, from the seed's grid, whose outputs are dropped).

End to end: ``cell_updates_per_s``, the grid's cells × ``steps`` of every
call completed in the window over the window's seconds (the window runs
from its start to the end of the call in progress when ``--seconds``
passed). Checked, after the window: the first call, from the seed's grid,
and one later call drawn from the seed (a reservoir over the window's
calls), from the state the program gave it: the reference cannot follow
all of the window's calls in the time of a run.
"""

from __future__ import annotations

import time

from cellbench import inputs, program
from cellbench.check import judge
from cellbench.reference import Reference
from cellbench.work import roofline_s, run_work


def run(ctx) -> None:
    p, mt = ctx.params, ctx.mt
    side, steps = int(p["side"]), int(p["steps"])
    values = inputs.grid(ctx.config, side, ctx.seed, ctx.device)
    start = program.space(mt, values)
    model = program.build_model(mt, ctx.config)
    ex = mt.SerialExecutor(p["impl"], substeps=int(p["substeps"]),
                           compute_dtype=ctx.compute_dtype)
    for _ in range(int(p["warmup_calls"])):
        model.execute(start, ex, steps=steps)
    rng = inputs.host_rng(ctx.seed, "grid_calls", "sample")
    first = kept = None
    calls = profiled = 0
    cur = start
    out = rep = None
    w = ctx.window()
    w.begin()
    while not w.over():
        w.tick()
        inside = w.profiling
        ctx.attempted += 1
        try:
            out, rep = model.execute(cur, ex, steps=steps)
        # a call that raises (a conservation error, a kernel error) is an
        # answer that never came: counted, and the run stops there
        except Exception as e:  # noqa: BLE001
            ctx.failed += 1
            ctx.checks.count("answers_missing")
            ctx.notes["error"] = f"{type(e).__name__}: {e}"
            break
        calls += 1
        profiled += inside and w.profiling
        if rep.steps != steps:
            ctx.checks.count("steps_wrong")
        if first is None:
            first = (out.values, rep)
        elif rng.integers(0, calls - 1) == 0:
            kept = (cur.values, out.values, rep)
        cur = out
    t_end = w.end()
    ctx.close_window(w)
    cells = side * side
    ctx.e2e["cell_updates_per_s"] = calls * cells * steps / (t_end - w.t0)
    if ctx.peak is not None:
        ctx.record["work_roofline_s"] = profiled * roofline_s(
            run_work(ctx.config, cells, steps), ctx.peak)
    ctx.notes.update(calls=calls, profiled_calls=profiled)
    ctx.read_peak()
    del model, ex, cur, out, rep, start, values
    ctx.free()

    t_check = time.perf_counter()
    ref = Reference(ctx.config)
    ctx.notes["checked_calls"] = (first is not None) + (kept is not None)
    if first is not None:
        seeded = inputs.grid(ctx.config, side, ctx.seed, ctx.device)
        judge(ctx.checks, ref, seeded, steps, first[0], first[1],
              ctx.control)
        del seeded, first
    if kept is not None:
        judge(ctx.checks, ref, kept[0], steps, kept[1], kept[2], ctx.control)
    ctx.sync()
    ctx.notes["check_s"] = time.perf_counter() - t_check
