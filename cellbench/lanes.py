"""Served scenarios, for the ``batch_rounds`` traffic kind: the pool of
initial states, the service, and the answers kept for the check.

- The pool: ``pool`` distinct ``side``² states made on the device from the
  seed; a scenario is one of them run ``steps`` steps, picked in an order
  drawn from the seed (each pass over the pool a new permutation). Two
  states never share a total to f32's precision in practice, and a lane
  handed to the wrong ticket reads another state's answer.
- The service: ``mt.EnsembleService(model, steps=, impl=, substeps=,
  buckets=mt.buckets_for(round), retry="solo")``, as ``bench.py``'s
  serving row builds it, warmed before the window by one round (the
  cell's one bucket).
- Every answer: its ``Report``'s steps, and its initial and final totals
  against the pool state's float64 total (``ticket_total_err``). A sample
  of ``check_sample`` answers drawn from the seed (a reservoir over all of
  them) is held to the reference after the window, from the pool made
  again from the seed (``check.judge``). The pool's own totals are read
  again after the window: the program may not write its inputs.
"""

from __future__ import annotations

import time

from cellbench import inputs, program
from cellbench.check import judge, rel
from cellbench.reference import Reference


def pick_order(seed: int, count: int):
    """The pool states scenarios start from, in submission order: each
    pass over the pool a new permutation drawn from the seed."""
    rng = inputs.host_rng(seed, "lanes", "pick")
    while True:
        yield from (int(i) for i in rng.permutation(count))


class Lanes:
    def __init__(self, ctx):
        self.ctx = ctx
        p, mt = ctx.params, ctx.mt
        self.side, self.steps = int(p["side"]), int(p["steps"])
        self.count = int(p["pool"])
        self.sample = int(p["check_sample"])
        pool = inputs.pool(ctx.config, self.side, self.count, ctx.seed,
                           ctx.device)
        self.spaces = [program.space(mt, v) for v in pool]
        self.totals = [self._totals(v) for v in pool]
        self.model = program.build_model(mt, ctx.config)
        self.round = int(p["round"])
        self.svc = mt.EnsembleService(
            self.model, steps=self.steps, impl=p["impl"],
            substeps=int(p["substeps"]), buckets=mt.buckets_for(self.round),
            retry="solo", compute_dtype=ctx.compute_dtype,
            compile_cache=ctx.build_dir)
        self._picks = pick_order(ctx.seed, self.count)
        self._keep = inputs.host_rng(ctx.seed, "lanes", "sample")
        self.kept: list = []
        self.answered = 0
        #: every answer's (pool index, initial totals, final totals)
        self.totals_seen: list = []
        tickets = [self.svc.submit(self.spaces[i % self.count])
                   for i in range(self.round)]
        self.svc.flush()
        for t in tickets:
            self.svc.result(t)
        ctx.sync()

    def _totals(self, values: dict) -> dict:
        torch = self.ctx.torch
        return {k: float(torch.sum(v, dtype=torch.float64))
                for k, v in values.items()}

    def submit_round(self) -> list:
        """Submit the next round's scenarios and flush the service; returns
        each one's (ticket, pool index)."""
        out = []
        for _ in range(self.round):
            idx = next(self._picks)
            out.append((self.svc.submit(self.spaces[idx]), idx))
        self.svc.flush()
        return out

    def collect(self, ticket: int, idx: int) -> bool:
        """Take ``ticket``'s answer (the pool's state ``idx``) and check it;
        False when it raised instead."""
        ctx = self.ctx
        try:
            space, rep = self.svc.result(ticket)
        # a quarantined or failed ticket is an answer that never came:
        # counted against ``attempted`` and for ``correct``
        except Exception as e:  # noqa: BLE001
            ctx.failed += 1
            ctx.checks.count("answers_missing")
            ctx.notes.setdefault("error", f"{type(e).__name__}: {e}")
            return False
        if rep.steps != self.steps:
            ctx.checks.count("steps_wrong")
        self.totals_seen.append((idx, rep.initial_total, rep.final_total))
        self.answered += 1
        if len(self.kept) < self.sample:
            self.kept.append((idx, self.own(space.values), rep))
        else:
            j = int(self._keep.integers(0, self.answered))
            if j < self.sample:
                self.kept[j] = (idx, self.own(space.values), rep)
        return True

    @staticmethod
    def own(values: dict) -> dict:
        """A kept answer's own copy: a lane's values are views of its whole
        dispatch, and a kept view would hold all of the dispatch's lanes
        on the device."""
        return {k: v.clone() for k, v in values.items()}

    def _judge_totals(self, pool: list) -> None:
        """Every answer's totals against its pool state's float64 total
        (``ticket_total_err``). Under ``reference_bf16`` the bf16
        reference's totals of each state stand in for the program's."""
        got = None
        if self.ctx.control == "reference_bf16":
            low = Reference(self.ctx.config, self.ctx.torch.bfloat16)
            got = {}
            for idx in sorted({i for i, _, _ in self.totals_seen}):
                got[idx] = (low.totals(low.cast(pool[idx])),
                            low.totals(low.run(pool[idx], self.steps)))
        for idx, init, final in self.totals_seen:
            if got is not None:
                init, final = got[idx]
            for ch, w in self.totals[idx].items():
                for t in (init[ch], final[ch]):
                    self.ctx.checks.worst("ticket_total_err", rel(t, w))

    def stats(self) -> dict:
        return self.svc.stats()

    def finish(self) -> None:
        """After the window and the drain: the pool's totals again, the
        device peak, the program freed, then the sample against the
        reference."""
        ctx = self.ctx
        for v, t in zip(self.spaces, self.totals):
            if self._totals(v.values) != t:
                ctx.checks.count("pool_changed")
        ctx.read_peak()
        t_check = time.perf_counter()
        kept, self.kept = self.kept, []
        self.svc = self.model = self.spaces = None
        ctx.free()
        ctx.notes["checked_answers"] = len(kept)
        pool = inputs.pool(ctx.config, self.side, self.count, ctx.seed,
                           ctx.device)
        ref = Reference(ctx.config)
        self._judge_totals(pool)
        for idx, values, rep in kept:
            judge(ctx.checks, ref, pool[idx], self.steps, values, rep,
                  ctx.control)
        ctx.sync()
        ctx.notes["check_s"] = time.perf_counter() - t_check
