"""Scenario tiering: hibernate and wake paging through the delta stream
(counterpart of ``mpi_model_tpu/ensemble/tiering.py``, with its names, its
files and its journal records).

A serving facade with a residency budget keeps at most that many bytes of
scenario state live; the rest HIBERNATE to a vault directory and WAKE when
capacity frees, so overload costs latency instead of sheds.

- **State** pages through ``io.delta.DeltaChain``: each hibernated scenario
  owns a chain in the vault (``t<ticket>/hib_*``). The first hibernation
  writes a keyframe; a re-hibernation of the same unchanged scenario writes
  a delta with zero dirty tiles. Every piece is CRC32'd, and a wake replays
  keyframe → deltas as a checkpoint restore does. The vault's chains keep
  their last state on the host (``DeltaChain(host_last=True)``), as the
  JAX package's chain keeps numpy arrays: once a scenario is paged out,
  nothing of it stays on the card, and the budget meters memory the card
  really frees.
- **Lifecycle** rides a TJ1 journal (``hibernation.journal``):
  ``hibernate`` (the intent: ticket, chain seq, steps, the model's wire
  recipe) before the chain write, ``hibernated`` (the commit: seq, disk
  bytes) after it, ``wake`` and ``reclaim`` on the way back, ``requeue``
  when a woken scenario found no placement. The reader stops at the first
  byte that does not verify, so a crash costs the torn suffix.

Crash contract (``ScenarioTiering.recover``): intent and commit with no
wake → hibernated, woken from its chain (the newest record that verifies:
for a queued scenario every record is the same bytes); intent without
commit → the chain's newest record may be torn, and the wake walks back,
then asks the caller's journal source, then raises
:class:`HibernationError`, never a fresh start; a wake after the last
hibernate → resident at the crash, the fleet journal's business (its chain
directory is swept).

The residency policy is LRU over the resident set (``admit`` and ``touch``
refresh a ticket; ``lru_candidates`` gives page-out victims oldest first);
the hibernated tier wakes FIFO. A woken scenario lands on ``device`` when
the tiering has one (the fleet passes its own), else on the device it was
hibernated from; a scenario recovered after a restart lands on ``device``,
the card unless the caller names the CPU.

Chaos seams (``resilience.inject``): ``hibernate_torn`` tears the chain
record a hibernation just wrote, ``wake_corrupt`` damages the newest record
before a restore, ``residency_pressure`` forces the paging path with the
budget not exhausted.

The lock is ``lockdep.lock("ScenarioTiering._lock")``, the JAX package's
key; it is a leaf of the serving stack's acquisition graph. The spans are
``tiering.hibernate`` and ``tiering.wake``, the flight records ``hibernate``
and ``wake``, and each wake's wall seconds feed the counter's wake-latency
reservoir.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import shutil
import time
import warnings
from typing import Callable, Optional

import torch

from ..core.cellular_space import CellularSpace, resolve_device
from ..io.checkpoint import CheckpointCorruptionError
from ..io.delta import DeltaChain
from ..obs.flight import get_recorder
from ..resilience import inject, lockdep
from ..utils.metrics import ThroughputCounter
from ..utils.tracing import get_tracer
from .journal import TicketJournal, model_from_meta, model_meta, read_records
from .lifecycle import HIBERNATE, HIBERNATED, RECLAIM, REQUEUE, TIERING, WAKE

__all__ = ["CHAIN_PREFIX", "HIBERNATE_JOURNAL", "HibernatedScenario",
           "HibernationError", "ScenarioTiering", "scenario_nbytes"]

#: the TJ1 lifecycle journal inside a vault directory (the declared
#: machine's name, ``lifecycle.TIERING``)
HIBERNATE_JOURNAL = TIERING.journal_name
#: chain file prefix inside each per-ticket chain directory
CHAIN_PREFIX = "hib"


class HibernationError(RuntimeError):
    """A hibernated scenario could not be woken: no chain record verified
    and no journal source held its state. The ticket resolves with this
    error; the tiering never hands back fresh or wrong state in its
    place."""


def scenario_nbytes(space: CellularSpace) -> int:
    """Resident byte cost of one scenario's channel state: what the
    residency budget meters."""
    return int(sum(int(v.nbytes) for v in space.values.values()))


@dataclasses.dataclass
class HibernatedScenario:
    """One paged-out scenario: everything needed to wake it except the
    state itself (that lives in its chain or the journal)."""

    ticket: int
    steps: int
    #: the live model object; after a restart, rebuilt from the journaled
    #: wire recipe (``model_meta``), else the template
    model: object
    nbytes: int
    #: newest chain seq written for this ticket (committed, or the
    #: in-flight intent a crash interrupted: the wake walks back)
    seq: int
    submitted_at: float
    hibernated_at: float
    #: structure key for the wake's affinity placement (None after
    #: recovery: recomputed from the restored state)
    skey: Optional[tuple] = None
    #: bytes this ticket's chain holds on disk
    disk_bytes: int = 0
    #: the device the scenario was paged out from (None after recovery)
    device: Optional[torch.device] = None


class ScenarioTiering:
    """The hibernate/wake engine (module docstring). One instance per
    serving facade; thread-safe behind one lock. Hibernations and wakes
    serialize against each other (intent before commit before wake on each
    ticket's stream), never against the caller's admission lock, which must
    not be held across a call that does I/O."""

    def __init__(self, directory: str, *, residency_budget: int,
                 hibernate_budget: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 counter: Optional[ThroughputCounter] = None,
                 keyframe_every: int = 8, device=None):
        if residency_budget < 1:
            raise ValueError(
                f"residency_budget={residency_budget} must be >= 1 byte")
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.residency_budget = int(residency_budget)
        #: on-disk budget of the hibernation tier (None: unbounded); when it
        #: is exhausted the caller sheds, the only refusal left with paging
        self.hibernate_budget = (None if hibernate_budget is None
                                 else int(hibernate_budget))
        self.keyframe_every = int(keyframe_every)
        #: where woken scenarios land (None: where each was paged out from)
        self.device = None if device is None else torch.device(device)
        self._clock = clock
        self.counter = counter if counter is not None else ThroughputCounter()
        self._lock = lockdep.lock("ScenarioTiering._lock")
        #: ticket → resident nbytes, in LRU order (oldest first)
        self._resident: collections.OrderedDict = collections.OrderedDict()
        self._resident_bytes = 0
        #: ticket → HibernatedScenario, in FIFO wake order
        self._hibernated: collections.OrderedDict = collections.OrderedDict()
        self._hibernated_bytes = 0
        #: per-ticket chain handles, kept across a wake so that a
        #: re-hibernation in this process writes a delta, not a keyframe
        self._chains: dict = {}
        self._next_seq: dict = {}
        self.journal = TicketJournal(
            os.path.join(directory, HIBERNATE_JOURNAL))

    # -- residency accounting (LRU over the resident set) -------------------

    def admit(self, ticket: int, nbytes: int) -> None:
        """Track one scenario as resident (submitted or woken)."""
        with self._lock:
            if ticket not in self._resident:
                self._resident_bytes += int(nbytes)
            self._resident[ticket] = int(nbytes)
            self._resident.move_to_end(ticket)

    def touch(self, ticket: int) -> None:
        """LRU refresh: a polled scenario is a bad page-out victim."""
        with self._lock:
            if ticket in self._resident:
                self._resident.move_to_end(ticket)

    def fits(self, nbytes: int) -> bool:
        with self._lock:
            return self._resident_bytes + int(nbytes) \
                <= self.residency_budget

    def pressure(self, nbytes: int) -> Optional[str]:
        """Why this admission must page, or None: ``"injected"`` (an armed
        ``residency_pressure`` fault: the paging path runs though the budget
        would fit) or ``"budget"`` (the budget cannot take the scenario)."""
        st = inject.active()
        if st is not None and st.take(
                "tiering", st.bump("tiering"),
                kinds=("residency_pressure",)) is not None:
            return "injected"
        return None if self.fits(nbytes) else "budget"

    def room_for(self, nbytes: int) -> bool:
        """Has the hibernation tier disk budget for about one more keyframe
        of this size? (The upper bound: a re-hibernation writes a
        near-empty delta.)"""
        if self.hibernate_budget is None:
            return True
        with self._lock:
            return self._hibernated_bytes + int(nbytes) \
                <= self.hibernate_budget

    def lru_candidates(self) -> list:
        """Resident tickets, least recently touched first: the page-out
        victim preference."""
        with self._lock:
            return list(self._resident)

    def release(self, ticket: int) -> None:
        """The ticket resolved: free its residency and reclaim its chain."""
        with self._lock:
            n = self._resident.pop(ticket, None)
            if n is not None:
                self._resident_bytes -= n
            self._reclaim_locked(ticket)

    def drop(self, ticket: int) -> None:
        """Resolve a ticket that is still hibernated without waking it (a
        deadline expiry, an unwakeable chain): forget the entry and reclaim
        the chain. The caller publishes the outcome."""
        with self._lock:
            e = self._hibernated.pop(ticket, None)
            if e is not None:
                self._hibernated_bytes -= e.disk_bytes
            self._reclaim_locked(ticket)

    def _reclaim_locked(self, ticket: int) -> None:
        chain = self._chains.pop(ticket, None)
        self._next_seq.pop(ticket, None)
        e = self._hibernated.pop(ticket, None)
        if e is not None:
            self._hibernated_bytes -= e.disk_bytes
        d = self._chain_dir(ticket)
        if chain is None and not os.path.isdir(d):
            return
        self._append_locked(RECLAIM, {"ticket": ticket})
        if os.path.isdir(d):
            shutil.rmtree(d, ignore_errors=True)

    # -- the paging primitives ----------------------------------------------

    def _chain_dir(self, ticket: int) -> str:
        return os.path.join(self.directory, f"t{int(ticket):08d}")

    def _chain_for_locked(self, ticket: int) -> DeltaChain:
        chain = self._chains.get(ticket)
        if chain is None:
            chain = DeltaChain(self._chain_dir(ticket), prefix=CHAIN_PREFIX,
                               keyframe_every=self.keyframe_every,
                               host_last=True)
            self._chains[ticket] = chain
        return chain

    def _append_locked(self, kind: str, meta: dict) -> None:
        try:
            # analysis: ignore[blocking-under-lock] — the tiering journal's
            # per-ticket record ordering (intent before commit before wake) is
            # exactly what this lock provides; same documented trade as the
            # fleet journal's appends
            self.journal.append(kind, meta)
        except (OSError, ValueError) as e:
            self.counter.bump("loop_faults")
            warnings.warn(
                f"hibernation journal append ({kind}) failed: {e}; paging "
                "continues, and a crash-restart recovery falls back to the "
                "fleet journal for what this record described",
                RuntimeWarning)

    def hibernate(self, ticket: int, space: CellularSpace, model,
                  steps: int, *, submitted_at: Optional[float] = None,
                  skey: Optional[tuple] = None) -> HibernatedScenario:
        """Page one scenario out: journal the intent (with the model's wire
        recipe), write the chain record (a keyframe the first time, a
        near-empty delta on a re-hibernation), journal the commit. Dropping
        the caller's reference to the state is the caller's part: after
        this returns the chain and the journal are the scenario."""
        nbytes = scenario_nbytes(space)
        with self._lock, get_tracer().span(
                "tiering.hibernate", ticket=int(ticket)) as sm:
            if ticket in self._hibernated:
                raise ValueError(f"ticket {ticket} is already hibernated")
            seq = self._next_seq.get(ticket, 0)
            rehib = seq > 0
            self._append_locked(HIBERNATE, {
                "ticket": int(ticket), "seq": seq, "steps": int(steps),
                "nbytes": nbytes, "model": model_meta(model)})
            chain = self._chain_for_locked(ticket)
            # analysis: ignore[blocking-under-lock] — the chain write must
            # land between this ticket's intent and commit journal records (the
            # crash contract recover() replays); paging I/O serializes against
            # other paging I/O only
            # the chain write lands between this ticket's intent and commit
            # records (the crash contract); it serializes against other
            # paging I/O only
            path = chain.save(space, seq)
            inject.hibernate_torn(path, seq)
            self._next_seq[ticket] = seq + 1
            disk = self._dir_bytes(ticket)
            self._append_locked(HIBERNATED, {
                "ticket": int(ticket), "seq": seq, "disk_bytes": disk})
            now = self._clock()
            entry = HibernatedScenario(
                ticket=int(ticket), steps=int(steps), model=model,
                nbytes=nbytes, seq=seq,
                submitted_at=(now if submitted_at is None
                              else float(submitted_at)),
                hibernated_at=now, skey=skey, disk_bytes=disk,
                device=space.device)
            self._hibernated[ticket] = entry
            self._hibernated_bytes += disk
            n = self._resident.pop(ticket, None)
            if n is not None:
                self._resident_bytes -= n
            sm["seq"] = seq
            sm["rehibernation"] = rehib
        self.counter.bump("hibernations")
        if rehib:
            self.counter.bump("rehibernations")
        get_recorder().record("hibernate", ticket=int(ticket), seq=seq,
                              rehibernation=rehib)
        return entry

    def is_hibernated(self, ticket: int) -> bool:
        with self._lock:
            return ticket in self._hibernated

    def hibernated_count(self) -> int:
        with self._lock:
            return len(self._hibernated)

    def peek_next(self) -> Optional[tuple]:
        """(ticket, nbytes) of the next FIFO wake candidate, or None."""
        with self._lock:
            for t, e in self._hibernated.items():
                return t, e.nbytes
            return None

    def entry(self, ticket: int) -> Optional[HibernatedScenario]:
        with self._lock:
            return self._hibernated.get(ticket)

    def _wake_device(self, e: HibernatedScenario) -> torch.device:
        if self.device is not None:
            return self.device
        return e.device if e.device is not None else resolve_device(None)

    def wake(self, ticket: int, fallback: Optional[Callable] = None
             ) -> tuple[CellularSpace, HibernatedScenario]:
        """Materialize one hibernated scenario: the newest chain record that
        verifies (a torn or corrupt newest record costs nothing for a queued
        scenario: every record is the same bytes), else
        ``fallback(ticket)`` (the fleet journal's submit record), else
        :class:`HibernationError`. On success the entry leaves the tier
        (the chain stays on disk until the ticket resolves: it is the
        re-hibernation base and the crash source); on failure it stays for
        the caller to ``drop`` after publishing the error. The wall seconds
        feed the wake-latency reservoir (wall, whatever the facade's
        clock)."""
        # analysis: ignore[naked-timer] — the wake-latency reservoir's
        # anchor: wake p50/p99 must stay real wall seconds even under a fake
        # scheduler clock, and the reservoir is what stats() publishes
        t0 = time.perf_counter()
        with self._lock, get_tracer().span(
                "tiering.wake", ticket=int(ticket)) as sm:
            e = self._hibernated.get(ticket)
            if e is None:
                raise KeyError(f"ticket {ticket} is not hibernated")
            fault = inject.wake_corrupt(ticket)
            chain = self._chain_for_locked(ticket)
            if fault is not None:
                self._corrupt_newest_locked(chain, fault)
            dev = self._wake_device(e)
            space = None
            source = None
            last_err: Optional[Exception] = None
            # analysis: ignore[blocking-under-lock] — the wake's chain walk
            # (manifest read + restore) IS the paging tier's I/O; it serializes
            # only against other paging operations, and the caller's admission
            # lock is never held across wake
            for s in sorted(chain.steps(), reverse=True):
                try:
                    # analysis: ignore[blocking-under-lock] — the wake
                    # restore is the paging tier's I/O; it serializes only
                    # against other paging I/O
                    ck = chain.restore(s, device=dev)
                except (CheckpointCorruptionError, FileNotFoundError) as ex:
                    last_err = ex
                    continue
                space, source = ck.space, f"chain:{s}"
                break
            if space is None and last_err is not None:
                warnings.warn(
                    f"wake of ticket {ticket}: no chain record verified "
                    f"({last_err}); falling back to the journal source",
                    RuntimeWarning)
            if space is None and fallback is not None:
                space = fallback(ticket)
                source = "journal"
            if space is None:
                self.counter.bump("wake_faults")
                raise HibernationError(
                    f"ticket {ticket} cannot wake: no chain record "
                    f"verified ({last_err}) and no journal source holds "
                    "its state; resolving loudly instead of resuming fresh "
                    "or wrong state")
            if source == "journal":
                self.counter.bump("wake_faults")
            self._append_locked(WAKE, {
                "ticket": int(ticket), "seq": e.seq, "source": source})
            self._hibernated.pop(ticket)
            self._hibernated_bytes -= e.disk_bytes
            sm["source"] = source
        self.counter.bump("wakes")
        # analysis: ignore[naked-timer] — closes the reservoir anchor
        self.counter.record_wake_latency(time.perf_counter() - t0)
        get_recorder().record("wake", ticket=int(ticket), source=source)
        return space, e

    def requeue(self, ticket: int, entry: HibernatedScenario) -> None:
        """A woken scenario found no placement: put it back at the head of
        the wake queue without rewriting its chain (the state on disk is
        unchanged); the journal records the round trip."""
        with self._lock:
            self._append_locked(REQUEUE, {
                "ticket": int(ticket), "seq": entry.seq})
            self._hibernated[ticket] = entry
            self._hibernated.move_to_end(ticket, last=False)
            self._hibernated_bytes += entry.disk_bytes

    def _corrupt_newest_locked(self, chain: DeltaChain, fault) -> None:
        # analysis: ignore[blocking-under-lock] — chaos-only path (an armed
        # wake_corrupt fault): damages the chain under the same vault lock the
        # wake it targets holds, by design
        steps = chain.steps()
        if not steps:
            return
        for kind in ("delta", "keyframe"):
            p = chain.record_path(max(steps), kind)
            if os.path.exists(p):
                inject.tear_file(p, fault.offset, fault.nbytes, fault.tear)
                return

    def _dir_bytes(self, ticket: int) -> int:
        d = self._chain_dir(ticket)
        total = 0
        for fn in os.listdir(d):
            try:
                total += os.path.getsize(os.path.join(d, fn))
            except OSError:  # pragma: no cover - racing reclaim
                continue
        return total

    # -- crash-restart recovery ----------------------------------------------

    def recover(self, template_model=None) -> dict:
        """Fold the vault journal's verified prefix to the tickets that were
        hibernated at the crash (the module docstring's contract) and
        re-enter them, FIFO order kept. Models rebuild from their journaled
        wire recipes (``template_model`` where a recipe is absent). Returns
        ticket → entry; in-flight hibernations (intent, no commit) are
        included, and their wake walks the chain back or falls through to
        the caller's journal source. Chain directories of tickets not
        recovered are swept."""
        records, torn = read_records(self.journal.path)
        if torn:
            warnings.warn(
                f"hibernation journal {self.journal.path} had a torn tail; "
                "recovered the verified prefix", RuntimeWarning)
        # the fold follows the declared machine: each record moves its
        # ticket to the transition's target state, and a ticket is
        # recoverable iff the prefix leaves it on the hibernate side
        state: dict = {}
        for rec in records:
            t = rec.meta.get("ticket")
            tr = TIERING.transition(rec.kind)
            if t is None or tr is None:
                continue
            if tr.terminal:
                state.pop(t, None)
            elif rec.kind == HIBERNATE:
                state[t] = {"meta": rec.meta, "seq": rec.meta["seq"],
                            "committed": False, "state": tr.target,
                            "order": rec.index}
            elif t in state:
                if rec.kind == HIBERNATED:
                    state[t]["committed"] = True
                    state[t]["disk"] = rec.meta.get("disk_bytes", 0)
                state[t]["state"] = tr.target
        out: dict = {}
        now = self._clock()
        with self._lock:
            for t, st in sorted(state.items(),
                                key=lambda kv: kv[1]["order"]):
                if st["state"] not in ("hibernating", "hibernated"):
                    continue
                meta = st["meta"]
                model = model_from_meta(meta.get("model"), template_model)
                if model is None:
                    warnings.warn(
                        f"hibernated ticket {t} has no model recipe and no "
                        "template; it cannot be recovered here",
                        RuntimeWarning)
                    continue
                disk = st.get("disk") if st["committed"] else None
                if disk is None:
                    disk = (self._dir_bytes(t)
                            if os.path.isdir(self._chain_dir(t)) else 0)
                e = HibernatedScenario(
                    ticket=int(t), steps=int(meta.get("steps", 0)),
                    model=model, nbytes=int(meta.get("nbytes", 0)),
                    seq=int(st["seq"]), submitted_at=now,
                    hibernated_at=now, skey=None, disk_bytes=int(disk))
                self._hibernated[t] = e
                self._hibernated_bytes += e.disk_bytes
                self._next_seq[t] = e.seq + 1
                out[t] = e
            # the orphan sweep: a ticket whose last record was a wake was
            # resident at the crash (the fleet journal recovers it); its
            # chain directory would otherwise stay on disk forever
            for fn in os.listdir(self.directory):
                if not (fn.startswith("t") and fn[1:].isdigit()):
                    continue
                t = int(fn[1:])
                if t in self._hibernated:
                    continue
                self._append_locked(RECLAIM, {"ticket": t})
                shutil.rmtree(os.path.join(self.directory, fn),
                              ignore_errors=True)
                self._next_seq.pop(t, None)
        return out

    # -- observability --------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "resident_scenarios": len(self._resident),
                "resident_bytes": self._resident_bytes,
                "residency_budget": self.residency_budget,
                "hibernated_scenarios": len(self._hibernated),
                "hibernated_bytes": self._hibernated_bytes,
                "hibernate_budget": self.hibernate_budget,
            }

    def close(self) -> None:
        self.journal.close()
