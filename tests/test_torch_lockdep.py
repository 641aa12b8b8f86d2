"""The port's lock-order witness (``resilience/lockdep.py``) on the CPU:
counterparts of the JAX package's ``tests/test_lockdep.py`` (plain
primitives when disarmed; edges, inversions, cross-instance same-key
nesting, unknown edges and ``Condition.wait`` when armed; the deliberate
Ping/Pong inversion caught by the port's static layer and by its
witness), then the port's serving locks under the armed witness: the async
service, manual and threaded under ``run_soak``, serves with zero
violations, and every edge it shows lies in the port's own
``mpi_model_tpu_torch.analysis.concurrency.static_lock_graph()``, which
the witness is armed with. That graph equals JAX's edge for edge (the one
test that imports JAX's).
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from mpi_model_tpu.analysis.concurrency import \
    static_lock_graph as jax_static_lock_graph

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch.analysis.concurrency import (
    lint_concurrency_source, static_lock_graph)
from mpi_model_tpu_torch.analysis.registry import Severity
from mpi_model_tpu_torch.ensemble import (AsyncEnsembleService,
                                          EnsembleService, run_soak)
from mpi_model_tpu_torch.resilience import lockdep

#: the port's serving lock keys: the JAX package's, letter for letter
SERVING_KEYS = {"EnsembleScheduler._lock", "AsyncEnsembleService._lock_cv",
                "EnsembleExecutor._cache_lock", "ThroughputCounter._lock"}


@pytest.fixture(scope="module")
def static_graph():
    return static_lock_graph()


def test_the_port_s_static_graph_is_jax_s_edge_for_edge(static_graph):
    """The port's concurrency audit over its own sources finds the same
    acquisition edges, over the same lock keys, as JAX's over JAX's."""
    assert static_graph == jax_static_lock_graph()
    assert len(static_graph) >= 10


@pytest.fixture(autouse=True)
def _no_witness_left():
    yield
    assert lockdep.active() is None


def scen(i, g=16):
    v = np.random.default_rng(40 + i).uniform(0.5, 2.0, (g, g))
    return mt.CellularSpace.create(g, g, 1.0, dtype="float64",
                                   device="cpu").with_values(
        {"value": torch.from_numpy(v)})


def model():
    return mt.Model(mt.Diffusion(0.1), 4.0, 1.0)


# -- disarmed: plain primitives, no wrapper ------------------------------------

def test_factories_return_plain_primitives_when_disarmed():
    assert not isinstance(lockdep.lock("K"), lockdep._WitnessLock)
    assert not isinstance(lockdep.rlock("K"), lockdep._WitnessLock)
    assert not isinstance(lockdep.condition("K"), lockdep._WitnessLock)
    assert isinstance(lockdep.condition("K"), threading.Condition)
    assert lockdep.active() is None


def test_disarmed_serving_locks_are_plain_threading_primitives():
    svc = AsyncEnsembleService(model(), steps=2, start=False)
    sched = svc.scheduler
    for lk in (svc._lock_cv, sched._lock, sched.executor._cache_lock,
               sched.counter._lock):
        assert not isinstance(lk, lockdep._WitnessLock)
    assert isinstance(svc._lock_cv, threading.Condition)
    assert type(sched._lock) is type(threading.RLock())
    assert type(sched.counter._lock) is type(threading.Lock())
    svc.stop()


def test_armed_is_exclusive_and_clears():
    with lockdep.armed() as w:
        assert lockdep.active() is w
        with pytest.raises(RuntimeError, match="already armed"):
            with lockdep.armed():
                pass
    assert lockdep.active() is None


# -- armed: edges, re-entry, violations ---------------------------------------

def test_witness_records_edges_and_same_instance_reentry_is_free():
    with lockdep.armed() as w:
        a = lockdep.lock("A")
        b = lockdep.rlock("B")
        with a:
            with b:
                with b:  # same-instance re-entry: never an edge
                    pass
    assert set(w.edges) == {("A", "B")}
    assert w.violations == []
    w.assert_clean()


def test_inversion_is_caught_and_raises_on_assert():
    with lockdep.armed() as w:
        a = lockdep.lock("A")
        b = lockdep.lock("B")
        with a:
            with b:
                pass
        with b:
            with a:
                pass
    assert [v["kind"] for v in w.violations] == ["inversion"]
    with pytest.raises(lockdep.LockOrderViolation, match="inversion"):
        w.assert_clean()


def test_same_key_nesting_across_instances_is_flagged():
    with lockdep.armed() as w:
        a1 = lockdep.rlock("EnsembleScheduler._lock")
        a2 = lockdep.rlock("EnsembleScheduler._lock")
        with a1:
            with a2:
                pass
    assert [v["kind"] for v in w.violations] == ["same-key-nesting"]


def test_edge_outside_the_static_graph_is_flagged():
    with lockdep.armed(allowed={("A", "B")}) as w:
        a = lockdep.lock("A")
        c = lockdep.lock("C")
        with a:
            with c:
                pass
    assert [v["kind"] for v in w.violations] == ["unknown-edge"]


def test_condition_wait_suspends_and_resumes_the_held_key():
    with lockdep.armed() as w:
        c = lockdep.condition("C")
        with c:
            c.wait(timeout=0.01)  # releases fully; no edge made up
            a = lockdep.lock("A")
            with a:  # still held after the wait: a real edge
                pass
    assert set(w.edges) == {("C", "A")}
    assert w.violations == []


def test_cross_thread_inversion_is_caught():
    with lockdep.armed() as w:
        a = lockdep.lock("A")
        b = lockdep.lock("B")
        with a:
            with b:
                pass

        def inverted():
            with b:
                with a:
                    pass

        t = threading.Thread(target=inverted)
        t.start()
        t.join()
    assert [v["kind"] for v in w.violations] == ["inversion"]


# -- the deliberate inversion, caught by both layers ---------------------------

INVERSION_FIXTURE = (
    "import threading\n"
    "class Pong:\n"
    "    def __init__(self):\n"
    "        self._pong_lock = threading.Lock()\n"
    "        self.peer: 'Ping' = None\n"
    "    def absorb(self):\n"
    "        with self._pong_lock:\n"
    "            pass\n"
    "    def rally(self):\n"
    "        with self._pong_lock:\n"
    "            self.peer.absorb()\n"
    "class Ping:\n"
    "    def __init__(self):\n"
    "        self._ping_lock = threading.Lock()\n"
    "        self.peer = Pong()\n"
    "    def absorb(self):\n"
    "        with self._ping_lock:\n"
    "            pass\n"
    "    def serve(self):\n"
    "        with self._ping_lock:\n"
    "            self.peer.absorb()\n")


def test_inversion_fixture_flagged_by_the_static_layer():
    out = [f for f in lint_concurrency_source(INVERSION_FIXTURE)
           if f.rule == "lock-order"]
    assert len(out) == 2
    assert all(f.severity is Severity.ERROR for f in out)


def test_inversion_fixture_trips_the_runtime_witness():
    class Pong:
        def __init__(self):
            self._pong_lock = lockdep.lock("Pong._pong_lock")
            self.peer = None

        def absorb(self):
            with self._pong_lock:
                pass

        def rally(self):
            with self._pong_lock:
                self.peer.absorb()

    class Ping:
        def __init__(self):
            self._ping_lock = lockdep.lock("Ping._ping_lock")
            self.peer = Pong()

        def absorb(self):
            with self._ping_lock:
                pass

        def serve(self):
            with self._ping_lock:
                self.peer.absorb()

    with lockdep.armed() as w:
        ping = Ping()
        ping.peer.peer = ping
        ping.serve()       # ping → pong
        ping.peer.rally()  # pong → ping: the inversion
    assert [v["kind"] for v in w.violations] == ["inversion"]


# -- the port's serving stack under the witness --------------------------------

def test_async_service_serves_clean_against_the_static_graph(static_graph):
    """A witnessed service (built inside the armed block) serves by manual
    pump with every observed order inside the port's static graph."""
    with lockdep.armed(allowed=static_graph) as w:
        svc = AsyncEnsembleService(model(), steps=4, start=False)
        assert isinstance(svc._lock_cv, lockdep._WitnessLock)
        t = svc.submit(scen(0))
        while svc.pump_once(force=True):
            pass
        assert svc.poll(t) is not None
        svc.stats()
        svc.stop()
    assert w.edges, "the witness saw no acquisitions at all"
    assert set(w.edges) <= static_graph
    assert {k for e in w.edges for k in e} <= SERVING_KEYS
    w.assert_clean()


def test_threaded_soak_serves_clean_against_the_static_graph(static_graph):
    """The pump thread and the submitting thread under ``run_soak`` (an
    injectable clock): zero inversions, zero same-key nesting, no edge
    outside the static graph, and the results bit for bit the synchronous
    service's."""
    clock = {"t": 0.0}

    def sleep(s):
        clock["t"] += s

    spaces = [scen(i) for i in range(6)]
    with lockdep.armed(allowed=static_graph) as w:
        with AsyncEnsembleService(model(), steps=4, max_batch=2,
                                  buckets=(1, 2)) as svc:
            rep = run_soak(svc, [(s, None, None) for s in spaces],
                           arrival_rate_hz=100.0,
                           clock=lambda: clock["t"], sleep=sleep)
            svc.stats()
    assert rep["ledger_complete"] and rep["served"] == 6
    assert rep["degraded_from"] is None
    assert w.edges
    assert set(w.edges) <= static_graph, set(w.edges) - static_graph
    w.assert_clean()
    sync = EnsembleService(model(), steps=4)
    want = [sync.result(sync.submit(s))[0].values["value"] for s in spaces]
    with AsyncEnsembleService(model(), steps=4, max_batch=2,
                              buckets=(1, 2)) as svc:
        got = [svc.result(svc.submit(s), timeout=60)[0].values["value"]
               for s in spaces]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_the_ladder_runs_clean_under_the_witness(static_graph):
    """A rung (the executor swapped under the scheduler's lock, the warning
    outside it) adds no edge outside the static graph."""
    from mpi_model_tpu_torch.resilience import inject
    from mpi_model_tpu_torch.resilience.inject import Fault, FaultPlan

    with lockdep.armed(allowed=static_graph) as w:
        svc = AsyncEnsembleService(model(), steps=4, impl="active",
                                   degrade_after=1, max_batch=2,
                                   start=False)
        with inject.armed(FaultPlan((Fault("batch_exc", at=0),))):
            ts = [svc.submit(scen(i)) for i in range(2)]
            with pytest.warns(RuntimeWarning, match="degraded to 'xla'"):
                svc.stop()
        assert all(svc.poll(t) is not None for t in ts)
        assert isinstance(svc.scheduler.executor._cache_lock,
                          lockdep._WitnessLock)
    assert set(w.edges) <= static_graph
    w.assert_clean()
