"""Failure detection and recovery (counterpart of
``mpi_model_tpu/resilience/supervisor.py``).

The reference has no failure handling: live code ignores MPI return codes
(``/root/reference/src/Model.hpp:73,85,90``) and a failed rank hangs the
job. Here:

- ``check_health``: in-band detection. Non-finite values (a NaN/Inf
  divergence, a dead shard) and conservation drift beyond the model's
  contract (the reference's own invariant, ``Model.hpp:95``, used as a
  detector). The reductions run on the channels' device and every scalar
  comes to the host in one transfer, whatever the channel count.
- ``supervised_run``: checkpoint-based recovery. The run advances in chunks;
  each is health-checked and, with a manager, checkpointed; a failure (the
  executor raising, or a bad state) rolls back to the last good state and
  re-runs the chunk, up to ``max_failures`` consecutive failures, then
  raises ``SimulationFailure`` with the event log. A transient fault costs
  one chunk of recompute, and the state after recovery is an uninterrupted
  run's bit for bit.
- ``FailureEvent`` (``resilience.events``): the record of each detection and
  recovery.

The last good state is kept in memory: the executors never write their
input space's tensors (``SerialExecutor`` and ``ShardMapExecutor`` write
buffers of their own, made per run), so a retried chunk reads exactly the
state it read the first time. Each chunk runs under a ``supervise.chunk``
span (``start``, ``steps``), each failure records a ``supervise.failure``
instant with its event's fields, and a manager's ``flush`` that fails while
the run is raising records ``supervise.flush_failed`` (``utils.tracing``).
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, Optional

import torch

from ..core.cellular_space import CellularSpace
from ..io.checkpoint import CheckpointManager
from ..models.model import Model, Report
from .events import FailureEvent

__all__ = [
    "HealthError",
    "SimulationFailure",
    "FailureEvent",
    "SupervisedResult",
    "check_health",
    "supervised_run",
    "health_syncs",
]

#: host transfers ``check_health`` has made (one per check)
_HEALTH_SYNCS = 0


def health_syncs() -> int:
    """The number of host transfers ``check_health`` has made: one per
    call that had channels to check."""
    return _HEALTH_SYNCS


class HealthError(RuntimeError):
    """The in-band health check failed (non-finite values or conservation
    drift); ``problems`` lists what it found."""

    def __init__(self, problems: list[str]):
        super().__init__("; ".join(problems))
        self.problems = problems


class SimulationFailure(RuntimeError):
    """The supervisor exhausted ``max_failures`` consecutive recoveries (or
    met a deterministic fault); ``events`` holds the failure log."""

    def __init__(self, message: str, events: list[FailureEvent]):
        super().__init__(message)
        self.events = events


@dataclasses.dataclass
class SupervisedResult:
    """Final state and provenance of a supervised run."""

    space: CellularSpace
    step: int
    #: the last chunk's report; None when a resumed run was already at the
    #: requested step count
    report: Optional[Report]
    events: list[FailureEvent]
    #: the run-global conservation baseline (from the start, or the resumed
    #: checkpoint's extra)
    initial_totals: dict[str, float] = dataclasses.field(
        default_factory=dict)

    @property
    def recovered_failures(self) -> int:
        return len(self.events)


def _fetch(scalars: list[torch.Tensor]) -> list[float]:
    """Every scalar to the host in one transfer."""
    global _HEALTH_SYNCS
    _HEALTH_SYNCS += 1
    return torch.stack(scalars).tolist()


def check_health(space: CellularSpace,
                 initial_totals: Optional[dict[str, float]] = None,
                 threshold: Optional[float] = None,
                 view: Optional[Callable[[dict], dict]] = None
                 ) -> list[str]:
    """Problems with the state (empty: healthy). Every channel is checked
    for non-finite values and, with ``initial_totals`` and ``threshold``,
    for total-mass drift beyond the conservation contract (``view`` judges
    drift on a model's conservation view instead of raw totals). Per
    channel one ``isfinite().all()`` and one sum on the channel's device
    (f64 channels in f64, other floats in f32, integer and bool channels
    in int64), and all of them reach the host in one transfer."""
    problems: list[str] = []
    names, scalars = [], []
    for name, v in space.values.items():
        if v.dtype.is_floating_point:
            acc = torch.float64 if v.dtype == torch.float64 else torch.float32
            finite = torch.isfinite(v).all()
        else:
            acc = torch.int64
            finite = torch.ones((), dtype=torch.bool, device=v.device)
        names.append(name)
        dev0 = scalars[0].device if scalars else v.device
        scalars += [finite.to(dev0, torch.float64),
                    torch.sum(v, dtype=acc).to(dev0, torch.float64)]
    if not scalars:
        return problems
    fetched = _fetch(scalars)
    totals: dict[str, float] = {}
    any_nonfinite = False
    for i, name in enumerate(names):
        finite, total = fetched[2 * i], fetched[2 * i + 1]
        if not finite:
            any_nonfinite = True
            problems.append(f"channel {name!r}: non-finite cell(s) "
                            "(NaN/Inf divergence)")
            continue  # a non-finite channel's total means nothing
        totals[name] = float(total)
    if initial_totals is None or threshold is None:
        return problems
    if view is not None:
        if not any_nonfinite:
            try:
                vi = view(initial_totals)
                vt = view(totals)
            except KeyError:
                # a baseline from before some view channel existed
                return problems
            for key in vi:
                if key not in vt:
                    continue
                drift = abs(float(vt[key]) - float(vi[key]))
                if drift > threshold:
                    problems.append(
                        f"channel {key!r}: conservation drift "
                        f"{drift:.3e} > {threshold:.3e}")
        return problems
    for name, total in totals.items():
        baseline = initial_totals.get(name)
        if baseline is None:
            # a channel added after the baseline was taken has no reference
            continue
        drift = abs(total - baseline)
        if drift > threshold:
            problems.append(f"channel {name!r}: conservation drift "
                            f"{drift:.3e} > {threshold:.3e}")
    return problems


def _classify(exc: BaseException) -> str:
    if isinstance(exc, HealthError):
        return ("conservation" if any("conservation" in p
                                      for p in exc.problems)
                else "nonfinite")
    return "exception"


def supervised_run(
    model: Model,
    space: CellularSpace,
    manager: Optional[CheckpointManager] = None,
    *,
    steps: Optional[int] = None,
    every: int = 1,
    max_failures: int = 3,
    executor=None,
    health_checks: bool = True,
    tolerance: float = 1e-3,
    rtol: Optional[float] = None,
    on_event: Optional[Callable[[FailureEvent], None]] = None,
    retry_backoff_s: float = 0.0,
    backoff_jitter: float = 0.5,
    backoff_seed: int = 0,
    fail_fast_deterministic: bool = True,
) -> SupervisedResult:
    """Run ``model`` for ``steps`` (default ``model.num_steps``) under
    failure supervision, in chunks of ``every`` steps.

    After each chunk the state is health-checked against the run's original
    totals (drift is bounded over the whole run, not per chunk) and, with a
    ``manager``, checkpointed (the delta layout gets the executor's
    dirty-tile export). On a failure the supervisor rolls back to the last
    good state and re-runs the chunk; ``max_failures`` bounds consecutive
    failures (a success resets the count). With a ``manager``, an
    interrupted run resumes from its latest verified checkpoint onto the
    space's device, and the original totals travel in the checkpoint's
    ``extra``. ``on_event`` observes each ``FailureEvent``.
    ``health_checks=False`` turns the state checks off (exceptions are still
    supervised); ``io.run_checkpointed`` is this with ``max_failures=0``.

    ``retry_backoff_s > 0`` sleeps before each retry, exponential in the
    consecutive-failure count with a jittered factor from a generator
    seeded by ``backoff_seed`` (recorded as ``FailureEvent.backoff_s``).
    ``fail_fast_deterministic``: when the same fault (kind, step, detail)
    recurs right after a rollback, recomputing can only reproduce it, so the
    supervisor raises at once (``classification="deterministic"``)."""
    total = model.num_steps if steps is None else int(steps)
    if every <= 0:
        raise ValueError(f"every must be positive, got {every}")

    start = 0
    initial: Optional[dict[str, float]] = None
    if manager is not None:
        ck = manager.latest(device=space.device)
        if ck is not None:
            if ck.step > total:
                raise ValueError(
                    f"latest checkpoint is at step {ck.step} > requested "
                    f"total {total}")
            space, start = ck.space, ck.step
            saved = ck.extra.get("initial_totals")
            if saved is not None:
                initial = {k: float(v) for k, v in saved.items()}
    if initial is None:
        initial = {k: float(space.total(k)) for k in space.values}
    threshold = (model.conservation_threshold(
        space, tolerance, rtol, initial_totals=initial)
        if health_checks else None)

    good_space, good_step = space, start
    if manager is not None and not manager.steps():
        manager.save(good_space, good_step,
                     extra={"initial_totals": initial})
    from ..utils.tracing import get_tracer

    tracer = get_tracer()
    # an explicit flag, not sys.exc_info(): that also reports an exception
    # a caller is handling, and a successful run would swallow its own
    # flush failure
    run_raising = False
    try:
        return _supervise_loop(
            model, manager, total, every, max_failures, executor,
            health_checks, threshold, initial, good_space, good_step,
            tracer, [], on_event,
            _RetryPolicy(retry_backoff_s, backoff_jitter, backoff_seed,
                         fail_fast_deterministic))
    except BaseException:
        run_raising = True
        raise
    finally:
        if manager is not None:
            # a manager with buffered writes commits them even when the run
            # raises; a flush failure never masks the run's own exception,
            # and propagates when the run succeeded
            try:
                getattr(manager, "flush", lambda: None)()
            except BaseException:
                if not run_raising:
                    raise
                tracer.instant("supervise.flush_failed")


@dataclasses.dataclass(frozen=True)
class _RetryPolicy:
    """The supervisor's between-retry knobs."""

    backoff_s: float
    jitter: float
    seed: int
    fail_fast: bool

    def delay(self, rng, attempt: int) -> float:
        """Jittered exponential backoff for consecutive failure ``attempt``
        (1-based); 0.0 when backoff is off."""
        if self.backoff_s <= 0.0:
            return 0.0
        return (self.backoff_s * (2.0 ** (attempt - 1))
                * (1.0 + self.jitter * float(rng.random())))


def _supervise_loop(model, manager, total, every, max_failures, executor,
                    health_checks, threshold, initial, good_space, good_step,
                    tracer, events, on_event,
                    retry: _RetryPolicy) -> SupervisedResult:
    consecutive = 0
    report: Optional[Report] = None
    backoff_rng = None
    if retry.backoff_s > 0.0:
        import numpy as np

        # seeded once a run: reproducible, yet decorrelated across seeds
        backoff_rng = np.random.default_rng(retry.seed)
    #: (kind, step, detail) of the previous failure
    last_sig = None
    view = getattr(model, "conservation_view", None)
    while good_step < total:
        n = min(every, total - good_step)
        t0 = _time.perf_counter()
        try:
            with tracer.span("supervise.chunk", start=good_step, steps=n):
                # conservation is judged here against the run-global
                # baseline; execute()'s own check would re-baseline every
                # chunk
                out_space, report = model.execute(
                    good_space, executor, steps=n, check_conservation=False)
                if health_checks:
                    problems = check_health(out_space, initial, threshold,
                                            view=view)
                    if problems:
                        raise HealthError(problems)
        # the supervisor boundary: any step or health failure becomes a
        # FailureEvent and a rollback; only exhaustion re-raises
        except Exception as exc:  # noqa: BLE001
            consecutive += 1
            detail = f"{type(exc).__name__}: {exc}"
            sig = (_classify(exc), good_step + n, detail)
            deterministic = retry.fail_fast and sig == last_sig
            last_sig = sig
            exhausted = consecutive > max_failures
            backoff = (0.0 if deterministic or exhausted
                       else retry.delay(backoff_rng, consecutive))
            ev = FailureEvent(
                step=good_step + n,
                kind=sig[0],
                detail=detail,
                rolled_back_to=good_step,
                attempt=consecutive,
                wall_time_s=_time.perf_counter() - t0,
                classification=("deterministic" if deterministic
                                else "transient"),
                backoff_s=backoff,
            )
            events.append(ev)
            tracer.instant("supervise.failure", kind=ev.kind,
                           step=ev.step, attempt=ev.attempt,
                           detail=ev.detail,
                           rolled_back_to=ev.rolled_back_to,
                           classification=ev.classification)
            if on_event is not None:
                on_event(ev)
            if deterministic:
                raise SimulationFailure(
                    f"deterministic failure at step {good_step + n}: the "
                    "same fault recurred identically after rollback "
                    f"(failing fast; max_failures={max_failures} "
                    f"unspent); last: {ev.detail}", events) from exc
            if exhausted:
                raise SimulationFailure(
                    f"{consecutive} consecutive failures at step "
                    f"{good_step + n} (max_failures={max_failures}); "
                    f"last: {ev.detail}", events) from exc
            if backoff > 0.0:
                _time.sleep(backoff)
            continue  # roll back: re-run the chunk from the good state

        consecutive = 0
        last_sig = None
        good_space, good_step = out_space, good_step + n
        if manager is not None:
            kw = {}
            if getattr(manager, "layout", None) == "delta":
                # the active executor's export covers exactly this chunk
                # (the interval since the last save); None (dense impls, a
                # poisoned chunk) makes the writer diff
                kw["dirty_tiles"] = getattr(executor, "last_dirty_tiles",
                                            None)
            manager.save(good_space, good_step,
                         extra={"initial_totals": initial}, **kw)

    return SupervisedResult(space=good_space, step=good_step, report=report,
                            events=events, initial_totals=initial)
