"""Runtime lock-order witness (counterpart of
``mpi_model_tpu/resilience/lockdep.py``; stdlib only, the port keeps its own
copy).

The serving modules make their locks through the factories below
(``lock``/``rlock``/``condition``), keyed by a stable string that names the
lock's class and attribute (``"EnsembleScheduler._lock"``, the JAX package's
keys letter for letter, so its static acquisition graph
``mpi_model_tpu.analysis.concurrency.static_lock_graph()`` speaks about the
same locks). While no witness is armed each factory returns the plain
``threading`` primitive: no wrapper, one global read. Objects built inside
an ``armed()`` block get witnessed locks, which report only while that same
witness stays armed, so a test keeps the work it wants witnessed
(``stop()`` included) inside the block.

What the witness records per acquisition:

- **edges**: ``(held_key, acquired_key)`` for every distinct lock held at
  acquisition time (re-entry on the same instance is not an edge);
- **inversions**: an edge whose reverse was already observed, from any
  thread (the two orders together are a deadlock waiting for its
  interleaving);
- **same-key nesting**: the same key on two different instances, which a
  static graph cannot tell from a legal re-entry;
- **unknown edges**: with ``armed(allowed=...)``, any observed order the
  given graph does not contain.

``Condition.wait`` releases the lock for the wait; the wrapper takes the
key out of the thread's held set around it, so a parked waiter never makes
an edge up. Violations are recorded, never raised mid-serve;
``assert_clean()`` raises them afterwards.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

__all__ = [
    "LockOrderViolation",
    "LockWitness",
    "active",
    "armed",
    "condition",
    "lock",
    "rlock",
]


class LockOrderViolation(AssertionError):
    """Raised by ``LockWitness.assert_clean``; carries the recorded
    violations, so a failing run prints the actual orders."""

    def __init__(self, violations: list):
        super().__init__(
            "lockdep witnessed %d ordering violation(s):\n%s" % (
                len(violations),
                "\n".join(f"  [{v['kind']}] {v['a']} vs {v['b']} "
                          f"(thread {v['thread']})" for v in violations)))
        self.violations = violations


class LockWitness:
    """One armed witness: per-thread held stacks, the observed edge set and
    the violation log."""

    def __init__(self, allowed: Optional[set] = None):
        #: the graph to assert against (None: learn only)
        self.allowed = None if allowed is None else set(allowed)
        self._mu = threading.Lock()  # leaf lock guarding the records
        self._tls = threading.local()
        #: (held_key, acquired_key) → name of the first witnessing thread
        self.edges: dict = {}
        #: [{"kind", "a", "b", "thread"}] in observation order
        self.violations: list = []
        self._flagged: set = set()

    # -- bookkeeping (called by the wrappers) --------------------------------

    def _stack(self) -> list:
        s = getattr(self._tls, "stack", None)
        if s is None:
            s = []
            self._tls.stack = s
        return s

    def note_acquiring(self, lk: "_WitnessLock") -> None:
        stack = self._stack()
        if any(h is lk for h in stack):
            stack.append(lk)  # same-instance re-entry: never an edge
            return
        held: list = []
        seen: set = set()
        for h in stack:
            if id(h) not in seen:
                seen.add(id(h))
                held.append(h)
        if held:
            with self._mu:
                for h in held:
                    self._edge(h.key, lk.key)
        stack.append(lk)

    def note_release(self, lk: "_WitnessLock") -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is lk:
                del stack[i]
                return

    def suspend(self, lk: "_WitnessLock") -> int:
        """Remove every held entry of ``lk`` (``Condition.wait`` releases
        the lock fully, saved re-entries included); returns the count for
        ``resume``."""
        stack = self._stack()
        n = sum(1 for h in stack if h is lk)
        if n:
            self._tls.stack = [h for h in stack if h is not lk]
        return n

    def resume(self, lk: "_WitnessLock", n: int) -> None:
        """Hold again after a wait, with no new edges: every ordering fact
        was recorded at the original acquire."""
        if n:
            self._stack().extend([lk] * n)

    def _violation(self, kind: str, a: str, b: str) -> None:
        sig = (kind, a, b) if kind != "inversion" else (
            kind, *sorted((a, b)))
        if sig in self._flagged:
            return
        self._flagged.add(sig)
        self.violations.append({
            "kind": kind, "a": a, "b": b,
            "thread": threading.current_thread().name})

    def _edge(self, held_key: str, new_key: str) -> None:
        if held_key == new_key:
            # same key on a different instance (same-instance re-entry was
            # filtered upstream)
            self._violation("same-key-nesting", held_key, new_key)
            return
        e = (held_key, new_key)
        if e not in self.edges:
            self.edges[e] = threading.current_thread().name
        if (new_key, held_key) in self.edges:
            self._violation("inversion", held_key, new_key)
        if self.allowed is not None and e not in self.allowed:
            self._violation("unknown-edge", held_key, new_key)

    # -- assertions ----------------------------------------------------------

    def assert_clean(self) -> None:
        if self.violations:
            raise LockOrderViolation(list(self.violations))


class _WitnessLock:
    """Wraps one threading primitive with the surface the serving modules
    use: ``with``, acquire/release, wait, wait_for, notify, notify_all."""

    __slots__ = ("key", "_inner", "_witness")

    def __init__(self, key: str, inner, witness: LockWitness):
        self.key = key
        self._inner = inner
        self._witness = witness

    def acquire(self, blocking: bool = True, timeout: float = -1):
        st = _ACTIVE
        if st is self._witness and st is not None:
            # recorded before blocking: an inversion is witnessed even if
            # this acquire is the one that deadlocks
            st.note_acquiring(self)
        ok = self._inner.acquire(blocking, timeout)
        if not ok and _ACTIVE is self._witness and _ACTIVE is not None:
            self._witness.note_release(self)
        return ok

    def release(self):
        if _ACTIVE is self._witness and _ACTIVE is not None:
            self._witness.note_release(self)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # the Condition surface (an AttributeError on a plain lock, as threading
    # gives)

    def wait(self, timeout: Optional[float] = None):
        st = _ACTIVE if _ACTIVE is self._witness else None
        n = st.suspend(self) if st is not None else 0
        try:
            return self._inner.wait(timeout)
        finally:
            if st is not None:
                st.resume(self, n)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        st = _ACTIVE if _ACTIVE is self._witness else None
        n = st.suspend(self) if st is not None else 0
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            if st is not None:
                st.resume(self, n)

    def notify(self, n: int = 1):
        return self._inner.notify(n)

    def notify_all(self):
        return self._inner.notify_all()


_ACTIVE: Optional[LockWitness] = None


def active() -> Optional[LockWitness]:
    """The armed witness, or None (one global read when disarmed)."""
    return _ACTIVE


@contextlib.contextmanager
def armed(allowed: Optional[set] = None):
    """Arm a witness for the block (one at a time). Locks made inside the
    block are witnessed; ``allowed`` (an edge set) also flags any observed
    order outside it."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a lockdep witness is already armed")
    w = LockWitness(allowed)
    _ACTIVE = w
    try:
        yield w
    finally:
        _ACTIVE = None


def lock(key: str):
    """A mutex: the plain ``threading.Lock()`` while no witness is armed,
    a witnessed wrapper otherwise."""
    st = _ACTIVE
    inner = threading.Lock()
    return inner if st is None else _WitnessLock(key, inner, st)


def rlock(key: str):
    """A re-entrant mutex (``threading.RLock``), witnessed when armed."""
    st = _ACTIVE
    inner = threading.RLock()
    return inner if st is None else _WitnessLock(key, inner, st)


def condition(key: str):
    """A ``threading.Condition`` (re-entrant underneath), witnessed when
    armed; ``wait`` takes the key out of the held set."""
    st = _ACTIVE
    inner = threading.Condition()
    return inner if st is None else _WitnessLock(key, inner, st)
