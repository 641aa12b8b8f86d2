"""Traffic kind ``batch_rounds``: a parameter-study client that submits a
round of ``round`` scenarios, flushes the service, and takes every answer
of the round before it submits the next (``bench.py``'s serving row,
``run_batched``: at most one round in flight).

Parameters: ``side``, ``steps``, ``impl``, ``substeps``, ``pool``,
``check_sample`` and ``round`` (``lanes.Lanes``).

End to end: ``scenarios_per_s``, the scenarios of the rounds answered
within ``--seconds`` of the window's start, over ``--seconds``. The round
in progress when the window closes is answered and checked, and not
counted.
"""

from __future__ import annotations

from cellbench.lanes import Lanes
from cellbench.work import roofline_s, run_work


def run(ctx) -> None:
    lanes = Lanes(ctx)
    w = ctx.window()
    w.begin()
    s0 = lanes.stats()
    served = profiled = 0
    last, gap_max, gap_at = 0.0, 0.0, None
    while True:
        inside = w.profiling
        batch = lanes.submit_round()
        ctx.attempted += len(batch)
        ok = sum(lanes.collect(ticket, idx) for ticket, idx in batch)
        if w.over():
            break
        e = w.elapsed()
        if e - last > gap_max:
            gap_max, gap_at = e - last, last
        last = e
        served += ok
        if inside and w.profiling:
            profiled += ok
        w.tick()
    w.end()
    s1 = lanes.stats()
    ctx.close_window(w)
    ctx.record["stats"] = (s0, s1)
    ctx.e2e["scenarios_per_s"] = served / w.seconds
    if ctx.peak is not None:
        one = run_work(ctx.config, lanes.side * lanes.side, lanes.steps)
        ctx.record["work_roofline_s"] = profiled * roofline_s(one, ctx.peak)
    ctx.notes.update(served=served, profiled_served=profiled,
                     round_gap_max_ms=1e3 * gap_max, round_gap_at_s=gap_at)
    lanes.finish()
