"""Runtime protocol witness (counterpart of
``mpi_model_tpu/resilience/protocolcheck.py``; stdlib only): live journal
streams held against the declared lifecycle machines
(``ensemble.lifecycle``), as ``lockdep`` holds live lock orders against a
graph.

``TicketJournal.append`` calls :func:`journal_append` after every durable
write; disarmed, that is one module-global read. Per observed append,
keyed by ``(stream, ticket)`` (the stream from the journal file's basename,
``lifecycle.machine_for_journal``), the witness records:

- **undeclared-kind**: a record kind the stream's machine has no transition
  for;
- **missing-ticket**: a per-ticket kind appended without a ticket id;
- **duplicate-terminal**: a terminal for a ticket already resolved;
- **wake-without-commit**: a tiering ``wake`` for a ticket whose
  ``hibernate`` intent was seen and whose ``hibernated`` commit was not;
- **illegal-transition**: any other declared kind from a state its
  transition does not list.

A ticket first seen mid-lifecycle is adopted at the record's target state.
Violations are recorded, not raised mid-serve; ``assert_clean()`` raises
them afterwards.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

__all__ = [
    "ProtocolViolation",
    "ProtocolWitness",
    "active",
    "armed",
    "journal_append",
]


class ProtocolViolation(AssertionError):
    """Raised by ``ProtocolWitness.assert_clean``; carries the recorded
    violations."""

    def __init__(self, violations: list):
        super().__init__(
            "protocolcheck witnessed %d violation(s):\n%s" % (
                len(violations),
                "\n".join(
                    f"  [{v['kind']}] {v['stream']} ticket="
                    f"{v['ticket']} record={v['record']!r} "
                    f"state={v['state']!r}" for v in violations)))
        self.violations = violations


def _default_machines() -> dict:
    # loaded when a witness arms: the disarmed path imports nothing
    from ..ensemble.lifecycle import MACHINES

    return dict(MACHINES)


class ProtocolWitness:
    """One armed witness: per-(stream, ticket) state, the observed-record
    count and the violation log."""

    def __init__(self, machines: Optional[dict] = None):
        #: stream name → LifecycleMachine (default: the declared pair)
        self.machines = (_default_machines() if machines is None
                         else dict(machines))
        self._by_name = {m.journal_name: m
                         for m in self.machines.values()}
        self._mu = threading.Lock()  # leaf lock guarding the records
        self._state: dict = {}
        #: observed (classified) appends, so "zero violations" never means
        #: "witnessed nothing"
        self.records = 0
        #: [{"kind", "stream", "ticket", "record", "state"}]
        self.violations: list = []
        self._flagged: set = set()

    def observe(self, path: str, kind: str, meta: dict) -> None:
        """Classify one live append against its stream's machine."""
        import os

        machine = self._by_name.get(os.path.basename(path))
        if machine is None:
            return  # not a declared stream
        with self._mu:
            self.records += 1
            t = machine.transition(kind)
            ticket = (meta or {}).get("ticket")
            if t is None:
                self._violation("undeclared-kind", machine.stream,
                                ticket, kind, None)
                return
            if t.ticketless:
                return
            if ticket is None:
                self._violation("missing-ticket", machine.stream,
                                None, kind, None)
                return
            key = (machine.stream, ticket)
            cur = self._state.get(key)
            if cur is None and "new" not in t.sources:
                # first sighting mid-lifecycle: adopt, never guess
                self._state[key] = t.target
                return
            state = cur if cur is not None else "new"
            if not machine.legal(kind, state):
                if t.terminal and state == t.target:
                    label = "duplicate-terminal"
                elif (machine.stream == "tiering" and kind == "wake"
                        and state == "hibernating"):
                    label = "wake-without-commit"
                else:
                    label = "illegal-transition"
                self._violation(label, machine.stream, ticket, kind,
                                state)
            # the target either way: one bad record does not cascade
            self._state[key] = t.target

    def _violation(self, label: str, stream: str, ticket, record,
                   state) -> None:
        sig = (label, stream, ticket, record, state)
        if sig in self._flagged:
            return
        self._flagged.add(sig)
        self.violations.append({
            "kind": label, "stream": stream, "ticket": ticket,
            "record": record, "state": state})

    # -- assertions ----------------------------------------------------------

    def assert_clean(self) -> None:
        if self.violations:
            raise ProtocolViolation(list(self.violations))


_ACTIVE: Optional[ProtocolWitness] = None


def active() -> Optional[ProtocolWitness]:
    """The armed witness, or None (one global read when disarmed)."""
    return _ACTIVE


@contextlib.contextmanager
def armed(machines: Optional[dict] = None):
    """Arm a witness for the block (one at a time). Nests with
    ``lockdep.armed`` and ``inject.armed``: each has its own global."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a protocol witness is already armed")
    w = ProtocolWitness(machines)
    _ACTIVE = w
    try:
        yield w
    finally:
        _ACTIVE = None


def journal_append(path: str, kind: str, meta: dict) -> None:
    """The seam ``TicketJournal.append`` fires after every durable write."""
    st = _ACTIVE
    if st is None:
        return
    st.observe(path, kind, meta)
