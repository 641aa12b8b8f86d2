"""The port's scenario tiering (``ensemble/tiering.py`` and the paging of
``AsyncEnsembleService`` and ``FleetSupervisor``) on the CPU: a counterpart
of each tier-1 test of the JAX package's ``tests/test_tiering.py`` but its
bench and ladder rows (``:506``, ``:520``: the port's benchmark), each
feeding the same numpy-seeded scenarios through JAX's classes and the
port's.

- Paged states, woken or served, are bit for bit JAX's at f64. The rates
  are powers of two: XLA on the CPU contracts ``v - rate*v`` into a
  multiply-add, which changes nothing when the product is exact
  (``tests/test_torch_fleet.py``), so the served states of the two packages
  agree bit for bit, and each equals its never-hibernated twin from the
  package's own synchronous service.
- The ``stats()`` ledgers agree field for field (``hibernated_scenarios``,
  ``hibernations``, ``wakes``, ``shed`` and the others a test reads).
- A vault written by either package is recovered by the other: ``recover``
  re-enters its hibernated tickets FIFO and each wakes bit for bit, one of
  them through a chain record torn by ``hibernate_torn``.
- The acceptance soak runs under the port's lockdep witness, held to the
  JAX package's static acquisition graph.

Grids are 16² and 8², the clock is injectable, and no test sleeps.
"""

import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_model_tpu as mm
import mpi_model_tpu.ensemble as jens
from mpi_model_tpu.ensemble import journal as jjournal
from mpi_model_tpu.ensemble import lifecycle as jlifecycle
from mpi_model_tpu.ensemble import tiering as jtiering
from mpi_model_tpu.resilience import inject as jinject

import mpi_model_tpu_torch as mt
import mpi_model_tpu_torch.ensemble as tens
from mpi_model_tpu_torch.ensemble import journal as tjournal
from mpi_model_tpu_torch.ensemble import lifecycle as tlifecycle
from mpi_model_tpu_torch.ensemble import tiering as ttiering
from mpi_model_tpu_torch.io.delta import DeltaChain
from mpi_model_tpu_torch.resilience import inject as tinject
from mpi_model_tpu_torch.resilience import lockdep

#: powers of two: the packages' served states agree bit for bit
RATES = (0.0625, 0.125, 0.03125, 0.25)
#: the stats fields every paired test holds equal
LEDGER = ("hibernated_scenarios", "hibernations", "wakes", "shed")


def raw(i, g=16):
    return np.random.default_rng((53, i, g)).uniform(0.5, 2.0, (g, g))


class Pkg:
    """One package's side of a paired test: its classes, its scenarios
    (the same numpy values) and the CPU placement the port needs."""

    def __init__(self, name: str):
        self.name = name
        self.jax = name == "jax"
        self.ens = jens if self.jax else tens
        self.journal = jjournal if self.jax else tjournal
        self.inject = jinject if self.jax else tinject
        self.tiering_mod = jtiering if self.jax else ttiering

    def space(self, i, g=16):
        if self.jax:
            return mm.CellularSpace.create(
                g, g, 1.0, dtype=jnp.float64).with_values(
                {"value": jnp.asarray(raw(i, g))})
        return mt.CellularSpace.create(g, g, 1.0, dtype="float64",
                                       device="cpu").with_values(
            {"value": torch.from_numpy(raw(i, g))})

    def model(self, i=0):
        m = mm if self.jax else mt
        return m.Model(m.Diffusion(RATES[i % len(RATES)]), 4.0, 1.0)

    @staticmethod
    def vals(space) -> np.ndarray:
        v = space.values["value"]
        return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    def plan(self, *faults):
        return self.inject.FaultPlan(tuple(
            self.inject.Fault(kind, **kw) for kind, kw in faults))

    def vault(self, d, **kw):
        if not self.jax:
            kw.setdefault("device", "cpu")
        return self.ens.ScenarioTiering(str(d), **kw)

    def service(self, tmp_path, budget, **kw):
        kw.setdefault("steps", 4)
        kw.setdefault("max_queue", 64)
        if self.jax:
            kw.setdefault("compile_cache", None)
        return self.ens.AsyncEnsembleService(
            self.model(), start=False, residency_budget=budget,
            hibernate_dir=str(tmp_path / f"vault-{self.name}"), **kw)

    def fleet(self, tmp_path, budget, **kw):
        kw.setdefault("services", 2)
        kw.setdefault("steps", 4)
        if not self.jax:
            kw.setdefault("device", "cpu")
        return self.ens.FleetSupervisor(
            self.model(), start=False, residency_budget=budget,
            hibernate_dir=str(tmp_path / f"fvault-{self.name}"), **kw)

    def recover_fleet(self, jd, **kw):
        if not self.jax:
            kw.setdefault("device", "cpu")
        return self.ens.FleetSupervisor.recover(jd, self.model(), **kw)

    def sync_twin(self, spaces, models, steps=4):
        svc = self.ens.EnsembleService(models[0], steps=steps)
        ts = [svc.submit(s, model=m) for s, m in zip(spaces, models)]
        svc.flush()
        return [self.vals(svc.result(t)[0]) for t in ts]

    def nbytes(self, g=16):
        return self.ens.scenario_nbytes(self.space(0, g))


BOTH = (Pkg("jax"), Pkg("torch"))


@pytest.fixture(autouse=True)
def _one_thread_and_no_plan():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
        tinject._ACTIVE = None
        lockdep._ACTIVE = None


def paired(run, tmp_path):
    """Run ``run(pkg, dir)`` for JAX, then for the port, in directories of
    their own; returns both results."""
    out = []
    for p in BOTH:
        d = tmp_path / p.name
        d.mkdir()
        out.append(run(p, d))
    return out


def assert_same_states(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def assert_same_ledger(sa, sb, keys=LEDGER):
    for k in keys:
        assert sa[k] == sb[k], (k, sa[k], sb[k])


# -- unit: the vault ----------------------------------------------------------

def test_hibernate_wake_roundtrip_bitwise(tmp_path):
    def run(p, d):
        vault = p.vault(d, residency_budget=1)
        sp = p.space(0)
        vault.hibernate(7, sp, p.model(), 4)
        assert vault.is_hibernated(7)
        st = vault.stats()
        assert st["hibernated_scenarios"] == 1
        assert st["hibernated_bytes"] > 0
        out, entry = vault.wake(7)
        np.testing.assert_array_equal(p.vals(out), p.vals(sp))
        assert entry.steps == 4 and not vault.is_hibernated(7)
        records, torn = p.journal.read_records(
            str(d / p.tiering_mod.HIBERNATE_JOURNAL))
        assert not torn
        kinds = [r.kind for r in records]
        assert vault.counter.hibernations == 1 and vault.counter.wakes == 1
        vault.release(7)
        assert vault.stats()["hibernated_bytes"] == 0
        return p.vals(out), kinds, st

    (ja, jk, js), (ta, tk, ts) = paired(run, tmp_path)
    np.testing.assert_array_equal(ja, ta)
    assert jk == tk == ["hibernate", "hibernated", "wake"]
    assert js == ts


def test_rehibernation_writes_near_empty_delta(tmp_path):
    def run(p, d):
        vault = p.vault(d, residency_budget=1)
        sp = p.space(1)
        vault.hibernate(3, sp, p.model(), 4)
        kf_bytes = vault.stats()["hibernated_bytes"]
        out, _ = vault.wake(3)
        vault.hibernate(3, out, p.model(), 4)
        delta_bytes = vault.stats()["hibernated_bytes"] - kf_bytes
        assert 0 < delta_bytes < kf_bytes / 2, (kf_bytes, delta_bytes)
        assert vault.counter.rehibernations == 1
        out2, _ = vault.wake(3)
        np.testing.assert_array_equal(p.vals(out2), p.vals(sp))
        if not p.jax:
            # the re-hibernation's record carries zero dirty tiles, and the
            # chain's last state is on the host
            chain = vault._chains[3]
            with np.load(chain.record_path(1, "delta")) as z:
                meta = json.loads(bytes(z["meta"]).decode())
            assert meta["kind"] == "delta" and meta["pieces"] == []
            assert all(v.device.type == "cpu"
                       for v in chain._last_values.values())
        return p.vals(out2), kf_bytes, delta_bytes

    (ja, jkf, jd), (ta, tkf, td) = paired(run, tmp_path)
    np.testing.assert_array_equal(ja, ta)
    assert (jkf, jd) == (tkf, td)


def test_lru_order_follows_touch(tmp_path):
    def run(p, d):
        vault = p.vault(d, residency_budget=100)
        for t in (1, 2, 3):
            vault.admit(t, 10)
        vault.touch(1)
        order = vault.lru_candidates()
        vault.release(2)
        return (order, vault.lru_candidates(),
                vault.stats()["resident_bytes"], vault.fits(81),
                vault.fits(80))

    j, t = paired(run, tmp_path)
    assert j == t == ([2, 3, 1], [3, 1], 20, False, True)


def test_hibernate_torn_wakes_from_verified_prefix(tmp_path):
    def run(p, d):
        vault = p.vault(d, residency_budget=1)
        sp = p.space(2)
        vault.hibernate(5, sp, p.model(), 4)
        out, _ = vault.wake(5)
        with p.inject.armed(p.plan(("hibernate_torn",
                                    dict(at=1, nbytes=256)))) as st:
            vault.hibernate(5, out, p.model(), 4)
        assert [f["kind"] for f in st.fired] == ["hibernate_torn"]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            out2, _ = vault.wake(5)
        np.testing.assert_array_equal(p.vals(out2), p.vals(sp))
        # a chain recovery, not a journal fallback
        assert vault.counter.wake_faults == 0 and vault.counter.wakes == 2
        return p.vals(out2)

    j, t = paired(run, tmp_path)
    np.testing.assert_array_equal(j, t)


def test_wake_corrupt_falls_back_to_journal_source(tmp_path):
    def run(p, d):
        vault = p.vault(d, residency_budget=1)
        sp = p.space(3)
        vault.hibernate(9, sp, p.model(), 4)
        with p.inject.armed(p.plan(("wake_corrupt",
                                    dict(ticket=9, nbytes=65536)))) as st:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                out, _ = vault.wake(9, fallback=lambda t: sp)
        assert [f["kind"] for f in st.fired] == ["wake_corrupt"]
        np.testing.assert_array_equal(p.vals(out), p.vals(sp))
        assert vault.counter.wake_faults == 1
        return p.vals(out)

    j, t = paired(run, tmp_path)
    np.testing.assert_array_equal(j, t)


def test_wake_with_no_source_raises_loudly(tmp_path):
    def run(p, d):
        vault = p.vault(d, residency_budget=1)
        vault.hibernate(2, p.space(4), p.model(), 4)
        with p.inject.armed(p.plan(("wake_corrupt", dict(nbytes=65536)))):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                with pytest.raises(p.ens.HibernationError,
                                   match="cannot wake"):
                    vault.wake(2)
        assert vault.is_hibernated(2)  # the entry survives for drop()
        vault.drop(2)
        assert not vault.is_hibernated(2)
        return vault.counter.wake_faults

    assert paired(run, tmp_path) == [1, 1]


def test_recover_restores_hibernated_set_fifo(tmp_path):
    def run(p, d):
        vault = p.vault(d, residency_budget=1)
        sp1 = p.space(5)
        vault.hibernate(1, sp1, p.model(2), 4)
        vault.hibernate(2, p.space(7), p.model(), 4)
        vault.wake(2)                       # woken: not recovered
        vault.hibernate(3, p.space(6), p.model(), 6)
        vault.close()
        v2 = p.vault(d, residency_budget=1)
        hib = v2.recover(p.model())
        assert sorted(hib) == [1, 3]
        assert v2.peek_next()[0] == 1       # FIFO: oldest first
        assert hib[1].steps == 4 and hib[3].steps == 6
        assert hib[1].model.flows[0].flow_rate == RATES[2]
        out, _ = v2.wake(1)
        np.testing.assert_array_equal(p.vals(out), p.vals(sp1))
        return p.vals(out), v2.stats()

    (ja, js), (ta, ts) = paired(run, tmp_path)
    np.testing.assert_array_equal(ja, ta)
    assert js == ts


def test_recover_inflight_hibernation_wakes_from_prefix(tmp_path):
    def run(p, d):
        vault = p.vault(d, residency_budget=1)
        sp = p.space(8)
        vault.hibernate(4, sp, p.model(), 4)
        out, _ = vault.wake(4)
        # the re-hibernation: its chain record torn and its commit record
        # truncated off the journal, as a kill mid-hibernation leaves them
        with p.inject.armed(p.plan(
                ("hibernate_torn", dict(at=1, nbytes=256)),
                ("journal_torn", dict(at=4, tear="truncate", offset=0)))):
            vault.hibernate(4, out, p.model(), 4)
        vault.close()
        v2 = p.vault(d, residency_budget=1)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            hib = v2.recover(p.model())
            assert list(hib) == [4]
            out2, _ = v2.wake(4)
        np.testing.assert_array_equal(p.vals(out2), p.vals(sp))
        return p.vals(out2)

    j, t = paired(run, tmp_path)
    np.testing.assert_array_equal(j, t)


def test_tiering_validation(tmp_path):
    for p in BOTH:
        with pytest.raises(ValueError, match="residency_budget"):
            p.vault(tmp_path / "never-created", residency_budget=0)
        kw = {} if p.jax else {"device": "cpu"}
        with pytest.raises(ValueError, match="BOTH"):
            p.ens.AsyncEnsembleService(p.model(), steps=4, start=False,
                                       residency_budget=100)
        with pytest.raises(ValueError, match="BOTH"):
            p.ens.FleetSupervisor(p.model(), steps=4, start=False,
                                  hibernate_dir=str(tmp_path / "nope"),
                                  **kw)
    assert not (tmp_path / "never-created").exists()
    assert not (tmp_path / "nope").exists()


# -- service level: the paging overlay ---------------------------------------

def test_service_pages_instead_of_shedding_bitwise(tmp_path):
    def run(p, d):
        spaces = [p.space(i) for i in range(6)]
        models = [p.model(i) for i in range(6)]
        want = p.sync_twin(spaces, models)
        svc = p.service(d, 2 * p.nbytes() + 1)
        ts = [svc.submit(s, model=m) for s, m in zip(spaces, models)]
        mid = svc.stats()
        assert mid["hibernated_scenarios"] == 4 and mid["shed"] == 0
        got = []
        for i, t in enumerate(ts):
            out, _rep = svc.result(t)
            got.append(p.vals(out))
            np.testing.assert_array_equal(got[-1], want[i])
        st = svc.stats()
        assert st["wakes"] == 4 and st["shed"] == 0
        assert st["hibernated_scenarios"] == 0
        assert st["wake_latency_p99_s"] is not None
        svc.stop()
        return got, mid, st

    (jg, jm, js), (tg, tm, ts) = paired(run, tmp_path)
    assert_same_states(jg, tg)
    assert_same_ledger(jm, tm)
    assert_same_ledger(js, ts, LEDGER + ("rehibernations", "wake_faults",
                                         "resident_scenarios",
                                         "resident_bytes",
                                         "residency_budget", "scenarios"))


def test_service_lru_victim_pages_out(tmp_path):
    def run(p, d):
        svc = p.service(d, int(1.5 * p.nbytes()), max_wait_s=1e9,
                        max_batch=8)
        t_a = svc.submit(p.space(0))
        t_b = svc.submit(p.space(1))   # pressure: A is the LRU victim
        assert svc.tiering.is_hibernated(t_a)
        assert not svc.tiering.is_hibernated(t_b)
        assert svc.poll(t_a) is None   # a hibernated ticket polls None
        st = svc.stats()
        assert st["hibernations"] == 1 and st["shed"] == 0
        svc.stop()
        # the drain wakes and serves both
        return [p.vals(svc.poll(t)[0]) for t in (t_a, t_b)], st

    (jg, js), (tg, ts) = paired(run, tmp_path)
    assert_same_states(jg, tg)
    assert_same_ledger(js, ts)


def test_service_hibernation_tier_exhausted_sheds(tmp_path):
    def run(p, d):
        kw = {"compile_cache": None} if p.jax else {}
        svc = p.ens.AsyncEnsembleService(
            p.model(), steps=4, start=False, max_wait_s=1e9, max_batch=8,
            residency_budget=1, hibernate_dir=str(d / "v"),
            hibernate_budget=p.nbytes(), **kw)
        svc.submit(p.space(0))         # hibernates (budget: 1 byte)
        with pytest.raises(p.ens.ServiceOverloaded,
                           match="hibernation tier exhausted"):
            svc.submit(p.space(1))
        st = svc.stats()
        assert st["shed"] == 1
        svc.stop()
        return st

    j, t = paired(run, tmp_path)
    assert_same_ledger(j, t)


def test_service_deadline_expires_hibernated_ticket(tmp_path):
    def run(p, d):
        clock = {"t": 0.0}
        kw = {"compile_cache": None} if p.jax else {}
        svc = p.ens.AsyncEnsembleService(
            p.model(), steps=4, start=False, deadline_s=5.0,
            max_wait_s=1e9, max_batch=8, clock=lambda: clock["t"],
            residency_budget=1, hibernate_dir=str(d / "v"), **kw)
        t = svc.submit(p.space(0))
        assert svc.tiering.is_hibernated(t)
        clock["t"] = 10.0
        svc.pump_once()
        with pytest.raises(p.ens.TicketExpired,
                           match="hibernation tier") as ei:
            svc.poll(t)
        assert ei.value.failure_event.kind == "expired"
        assert ei.value.ticket == t
        st = svc.stats()
        assert st["expired"] == 1
        assert not svc.tiering.is_hibernated(t)
        svc.stop()
        return st

    j, t = paired(run, tmp_path)
    assert_same_ledger(j, t, LEDGER + ("expired",))


def test_service_residency_pressure_fault_forces_paging(tmp_path):
    def run(p, d):
        svc = p.service(d, 10 * p.nbytes())
        with p.inject.armed(p.plan(("residency_pressure", {}))) as st:
            t0 = svc.submit(p.space(0))
            t1 = svc.submit(p.space(1))
        assert [f["kind"] for f in st.fired] == ["residency_pressure"]
        assert svc.tiering.is_hibernated(t0)
        assert not svc.tiering.is_hibernated(t1)
        got = [p.vals(svc.result(t)[0]) for t in (t0, t1)]
        stats = svc.stats()
        assert stats["shed"] == 0
        svc.stop()
        return got, stats

    (jg, js), (tg, ts) = paired(run, tmp_path)
    assert_same_states(jg, tg)
    assert_same_ledger(js, ts)


def test_scheduler_allocate_ticket_is_monotonic(tmp_path):
    def run(p, d):
        svc = p.service(d, 10 * p.nbytes())
        t0 = svc.submit(p.space(0))
        reserved = svc.scheduler.allocate_ticket()
        t1 = svc.submit(p.space(1))
        assert t0 < reserved < t1
        with pytest.raises(KeyError):
            svc.scheduler.poll(reserved, pump=False)
        svc.stop()
        return t0, reserved, t1

    j, t = paired(run, tmp_path)
    assert j == t


# -- fleet level --------------------------------------------------------------

def test_fleet_pages_and_attributes_wakes_per_member(tmp_path):
    def run(p, d):
        spaces = [p.space(i) for i in range(8)]
        models = [p.model(i) for i in range(8)]
        want = p.sync_twin(spaces, models)
        f = p.fleet(d, 3 * p.nbytes() + 1, journal_dir=str(d / "fj"))
        ts = [f.submit(s, model=m) for s, m in zip(spaces, models)]
        mid = f.stats()
        assert mid["hibernated_scenarios"] == 5 and mid["shed"] == 0
        assert mid["pending"] == 8     # hibernated tickets are pending
        got = []
        for i, t in enumerate(ts):
            out, _rep = f.result(t)
            got.append(p.vals(out))
            np.testing.assert_array_equal(got[-1], want[i])
        st = f.stats()
        assert st["wakes"] == 5 and st["shed"] == 0
        assert sum(st["wakes_by_member"].values()) == 5
        assert all(k.startswith("m") for k in st["wakes_by_member"])
        f.stop()
        audit = p.journal.replay(p.journal.journal_path(str(d / "fj")))
        assert not audit.unresolved() and not audit.duplicate_terminals
        return got, mid, st

    (jg, jm, js), (tg, tm, ts) = paired(run, tmp_path)
    assert_same_states(jg, tg)
    assert_same_ledger(jm, tm, LEDGER + ("pending",))
    assert_same_ledger(js, ts)


def test_fleet_wake_survives_member_fence(tmp_path):
    def run(p, d):
        spaces = [p.space(i) for i in range(3)]
        models = [p.model(i) for i in range(3)]
        want = p.sync_twin(spaces, models)
        f = p.fleet(d, p.nbytes() + 1)
        ts = [f.submit(s, model=m) for s, m in zip(spaces, models)]
        assert f.stats()["hibernated_scenarios"] == 2
        with p.inject.armed(p.plan(("member_kill", {}))):
            f.pump_once()              # one member's pump dies
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            f.pump_once()              # fence and respawn gen 1
        assert f.counter.respawns >= 1
        got = []
        for i, t in enumerate(ts):
            out, _rep = f.result(t)
            got.append(p.vals(out))
            np.testing.assert_array_equal(got[-1], want[i])
        st = f.stats()
        assert st["shed"] == 0
        f.stop()
        return got, st

    (jg, js), (tg, ts) = paired(run, tmp_path)
    assert_same_states(jg, tg)
    assert_same_ledger(js, ts, LEDGER + ("respawns", "member_faults"))


def test_fleet_wake_corrupt_readmits_from_fleet_journal(tmp_path):
    def run(p, d):
        sp = p.space(0)
        want = p.sync_twin([sp], [p.model()])
        f = p.fleet(d, 1, services=1, max_queue=2,
                    journal_dir=str(d / "fj"))
        with p.inject.armed(p.plan(("wake_corrupt",
                                    dict(nbytes=65536)))) as st:
            t = f.submit(sp)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                out, _rep = f.result(t)
        assert [x["kind"] for x in st.fired] == ["wake_corrupt"]
        np.testing.assert_array_equal(p.vals(out), want[0])
        stats = f.stats()
        assert stats["wake_faults"] == 1
        f.stop()
        return p.vals(out), stats

    (jg, js), (tg, ts) = paired(run, tmp_path)
    np.testing.assert_array_equal(jg, tg)
    assert_same_ledger(js, ts, LEDGER + ("wake_faults",))


def test_fleet_recover_reenters_hibernated_tickets(tmp_path):
    def run(p, d):
        spaces = [p.space(i) for i in range(6)]
        models = [p.model(i) for i in range(6)]
        want = p.sync_twin(spaces, models)
        jd = str(d / "fj")
        budget = 2 * p.nbytes() + 1
        f = p.fleet(d, budget, journal_dir=jd, max_wait_s=1e9, max_batch=8)
        ts = [f.submit(s, model=m) for s, m in zip(spaces, models)]
        assert f.stats()["hibernated_scenarios"] == 4
        f.abandon()
        r2 = p.recover_fleet(jd, services=2, steps=4, start=False,
                             residency_budget=budget,
                             hibernate_dir=str(d / f"fvault-{p.name}"))
        mid = r2.stats()
        assert mid["hibernated_scenarios"] == 4
        got = []
        for i, t in enumerate(ts):
            out, _rep = r2.result(t)
            got.append(p.vals(out))
            np.testing.assert_array_equal(got[-1], want[i])
        r2.stop()
        audit = p.journal.replay(p.journal.journal_path(jd))
        assert not audit.unresolved() and not audit.duplicate_terminals
        return got, mid

    (jg, jm), (tg, tm) = paired(run, tmp_path)
    assert_same_states(jg, tg)
    assert_same_ledger(jm, tm, ("hibernated_scenarios", "readmitted"))


# -- the acceptance soak ------------------------------------------------------

def test_acceptance_soak_10x_working_set_lockdep_armed(tmp_path):
    """A working set 10× the residency budget completes with zero sheds,
    bounded measured wake latency, every woken scenario bit for bit its
    never-hibernated twin (the port's and JAX's), under the port's lockdep
    witness held to the port's static acquisition graph."""
    from mpi_model_tpu_torch.analysis.concurrency import static_lock_graph

    p, jp = BOTH[1], BOTH[0]
    n = 20
    spaces = [p.space(i % 4, g=8) for i in range(n)]
    models = [p.model(i % 4) for i in range(n)]
    want = p.sync_twin(spaces[:4], models[:4], steps=2)
    jwant = jp.sync_twin([jp.space(i, g=8) for i in range(4)],
                         [jp.model(i) for i in range(4)], steps=2)
    assert_same_states(want, jwant)
    one = tens.scenario_nbytes(spaces[0])
    budget = max(one, one * n // 10)
    clock = {"t": 0.0}
    with lockdep.armed(allowed=static_lock_graph()) as witness:
        f = tens.FleetSupervisor(
            p.model(), services=2, steps=2, start=False, max_queue=n,
            clock=lambda: clock["t"], journal_dir=str(tmp_path / "aj"),
            residency_budget=budget, hibernate_dir=str(tmp_path / "av"),
            device="cpu")
        ts = []
        for i in range(n):
            clock["t"] += 0.001
            ts.append(f.submit(spaces[i], model=models[i]))
        assert f.stats()["shed"] == 0
        assert f.stats()["hibernated_scenarios"] >= n // 2
        for i, t in enumerate(ts):
            out, _rep = f.result(t)
            np.testing.assert_array_equal(p.vals(out), want[i % 4])
        st = f.stats()
        f.stop()
    assert witness.edges, "the witness saw no acquisitions"
    witness.assert_clean()
    assert set(witness.edges) <= static_lock_graph()
    assert ("FleetSupervisor._cv", "ScenarioTiering._lock") in witness.edges
    assert st["shed"] == 0
    assert st["wakes"] >= n // 2
    assert st["wake_latency_p99_s"] is not None
    assert st["wake_latency_p99_s"] < 5.0
    audit = tjournal.replay(tjournal.journal_path(str(tmp_path / "aj")))
    assert not audit.unresolved() and not audit.duplicate_terminals


# -- the CLI ------------------------------------------------------------------

def test_cli_serve_tiering_json(tmp_path, capsys):
    from mpi_model_tpu.cli import main as jmain
    from mpi_model_tpu_torch.cli import main as tmain

    rows = []
    for name, main, extra in (("jax", jmain, []),
                              ("torch", tmain, ["--device=cpu"])):
        rc = main(["run", "--flow=diffusion", "--dimx=16", "--dimy=16",
                   "--steps=2", "--serve", "--serve-scenarios=6", "--json",
                   f"--hibernate-dir={tmp_path / name}",
                   "--residency-budget=1", *extra])
        assert rc == 0
        rows.append(json.loads(
            capsys.readouterr().out.strip().splitlines()[-1]))
    for row in rows:
        assert row["ledger_complete"] is True
        assert row["served"] == 6 and row["shed"] == 0
        assert row["hibernations"] >= 1 and row["wakes"] >= 1
        assert "wake_latency_p99_s" in row
        assert row["residency_budget"] == 1
    assert set(rows[0]) <= set(rows[1])


@pytest.mark.parametrize("argv,match", [
    (["run", "--serve", "--residency-budget=100"], "BOTH"),
    (["run", "--residency-budget=100", "--hibernate-dir={d}"], "add --serve"),
    (["run", "--serve", "--residency-budget=0", "--hibernate-dir={d}"],
     ">= 1 byte"),
], ids=["both", "needs-serve", "positive"])
def test_cli_tiering_flag_validation(tmp_path, argv, match):
    from mpi_model_tpu.cli import main as jmain
    from mpi_model_tpu_torch.cli import main as tmain

    argv = [a.format(d=tmp_path) for a in argv]
    for main in (jmain, tmain):
        with pytest.raises(SystemExit, match=match):
            main(argv)


def test_service_hibernation_write_failure_sheds_observably(tmp_path):
    def run(p, d):
        svc = p.service(d, 1, max_wait_s=1e9, max_batch=8)

        def broken_hibernate(*a, **kw):
            raise OSError("vault full")

        svc.tiering.hibernate = broken_hibernate
        with pytest.raises(p.ens.ServiceOverloaded,
                           match="hibernation write failed"):
            svc.submit(p.space(0))
        st = svc.stats()
        assert st["shed"] == 1 and st["pending"] == 0
        assert not svc._hib_meta
        svc.stop()
        return st

    j, t = paired(run, tmp_path)
    assert_same_ledger(j, t, LEDGER + ("pending",))


def test_manual_result_pages_one_at_a_time(tmp_path):
    def run(p, d):
        spaces = [p.space(i) for i in range(4)]
        want = p.sync_twin(spaces[:1], [p.model()])
        svc = p.service(d, 1)          # nothing fits: all 4 hibernate
        ts = [svc.submit(s) for s in spaces]
        assert svc.stats()["hibernated_scenarios"] == 4
        out, _rep = svc.result(ts[0])
        np.testing.assert_array_equal(p.vals(out), want[0])
        # serving the first woke no more than the idle rule allows
        mid = svc.stats()
        assert mid["hibernated_scenarios"] >= 2
        svc.stop()                     # the stop's drain wakes the rest
        assert svc.stats()["hibernated_scenarios"] == 0
        return p.vals(out), mid

    (jg, jm), (tg, tm) = paired(run, tmp_path)
    np.testing.assert_array_equal(jg, tg)
    assert_same_ledger(jm, tm)


def test_recover_sweeps_orphaned_chains(tmp_path):
    def run(p, d):
        vault = p.vault(d, residency_budget=1)
        vault.hibernate(1, p.space(0), p.model(), 4)
        vault.hibernate(2, p.space(1), p.model(), 4)
        vault.wake(2)                  # resident at the "crash"
        assert os.path.isdir(str(d / "t00000002"))
        vault.close()
        v2 = p.vault(d, residency_budget=1)
        hib = v2.recover(p.model())
        assert list(hib) == [1]
        assert os.path.isdir(str(d / "t00000001"))
        assert not os.path.isdir(str(d / "t00000002"))  # swept
        return sorted(os.listdir(d))

    j, t = paired(run, tmp_path)
    assert j == t


# -- across the packages ------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_vault_recovers_in_the_other_package(tmp_path, writer):
    """Three tickets hibernated by one package (the second woken and paged
    out again through a chain record torn by ``hibernate_torn``) are
    re-entered FIFO by the other package's ``recover`` and wake bit for bit
    (the torn one from its verified keyframe)."""
    w, r = (BOTH if writer == "jax" else BOTH[::-1])
    vault = w.vault(tmp_path, residency_budget=1)
    vault.hibernate(1, w.space(10), w.model(1), 4)
    vault.hibernate(2, w.space(11), w.model(2), 6)
    out, _ = vault.wake(2)
    with w.inject.armed(w.plan(("hibernate_torn",
                                dict(at=1, nbytes=256)))) as st:
        vault.hibernate(2, out, w.model(2), 6)
    assert [f["kind"] for f in st.fired] == ["hibernate_torn"]
    vault.hibernate(3, w.space(12), w.model(3), 2)
    vault.close()

    v2 = r.vault(tmp_path, residency_budget=1)
    hib = v2.recover(r.model())
    assert list(hib) == [1, 2, 3]
    assert [hib[t].steps for t in (1, 2, 3)] == [4, 6, 2]
    assert [hib[t].model.flows[0].flow_rate for t in (1, 2, 3)] == \
        [RATES[1], RATES[2], RATES[3]]
    woken = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        while v2.peek_next() is not None:
            t = v2.peek_next()[0]
            sp, _ = v2.wake(t)
            woken.append(t)
            np.testing.assert_array_equal(r.vals(sp), raw(9 + t))
            if not r.jax:
                assert sp.values["value"].device.type == "cpu"
    assert woken == [1, 2, 3]
    assert v2.counter.wake_faults == 0
    v2.close()
    # the reader's journal continues the writer's: both packages read it
    for p in BOTH:
        records, torn = p.journal.read_records(
            str(tmp_path / p.tiering_mod.HIBERNATE_JOURNAL))
        assert not torn
        assert [x.kind for x in records][-3:] == ["wake"] * 3


def test_tiering_constants_and_kinds_are_jax_s():
    assert ttiering.CHAIN_PREFIX == jtiering.CHAIN_PREFIX == "hib"
    assert ttiering.HIBERNATE_JOURNAL == jtiering.HIBERNATE_JOURNAL
    for k in ("HIBERNATE", "HIBERNATED", "WAKE", "REQUEUE", "RECLAIM"):
        assert getattr(tlifecycle, k) == getattr(jlifecycle, k)
    assert tlifecycle.TIERING.journal_name == jlifecycle.TIERING.journal_name
    for kind in ("hibernate", "hibernated", "wake", "requeue", "reclaim"):
        tt = tlifecycle.TIERING.transition(kind)
        jt = jlifecycle.TIERING.transition(kind)
        assert (tt.target, tt.terminal) == (jt.target, jt.terminal)
    assert sorted(tens.__all__) == sorted(
        set(tens.__all__) | {"ScenarioTiering", "HibernationError",
                             "scenario_nbytes"})
    assert [f for f in ttiering.HibernatedScenario.__dataclass_fields__
            if f != "device"] == list(
        jtiering.HibernatedScenario.__dataclass_fields__)


def test_vault_chains_keep_their_last_state_on_the_host(tmp_path):
    """The vault's chains copy the last saved or restored state to the host
    (never an alias of the scenario's tensor); a checkpoint chain keeps its
    copy where the state lives."""
    vault = BOTH[1].vault(tmp_path / "v", residency_budget=1)
    sp = BOTH[1].space(0)
    vault.hibernate(1, sp, BOTH[1].model(), 4)
    chain = vault._chains[1]
    assert chain.host_last
    last = chain._last_values["value"]
    assert last.device.type == "cpu"
    assert last.data_ptr() != sp.values["value"].data_ptr()
    out, _ = vault.wake(1)
    assert chain._last_values["value"].data_ptr() != \
        out.values["value"].data_ptr()
    assert not DeltaChain(str(tmp_path / "c")).host_last


class _FixedTime:
    """A journal module's clock, pinned: ``t_wall`` advances by 0.25 s an
    append, the same in both packages."""

    def __init__(self):
        self.t = 1_700_000_000.0

    def time(self):
        self.t += 0.25
        return self.t


def test_tiered_fleet_journals_match_jax_s(tmp_path, monkeypatch):
    """The same tiered fleet run in both packages (one member, a budget of
    one scenario, four arrivals, one ``wake_corrupt``): the vault's
    lifecycle journal is byte for byte JAX's with the journal clocks pinned,
    and the fleet journal holds JAX's records (kinds, tickets, members,
    states); only the measured wall times and the trace ids (each
    process's tracer's) differ, and the served records' totals, which each
    package sums in its own order, agree within 1e-12."""
    monkeypatch.setattr(tjournal, "time", _FixedTime())
    monkeypatch.setattr(jjournal, "time", _FixedTime())

    def run(p, d):
        f = p.fleet(d, p.nbytes() + 1, services=1,
                    journal_dir=str(d / "fj"))
        with p.inject.armed(p.plan(("wake_corrupt",
                                    dict(ticket=2, nbytes=65536)))):
            ts = [f.submit(p.space(i), model=p.model(i)) for i in range(4)]
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                got = [p.vals(f.result(t)[0]) for t in ts]
        f.stop()
        hib = (d / f"fvault-{p.name}" /
               p.tiering_mod.HIBERNATE_JOURNAL).read_bytes()
        records, torn = p.journal.read_records(
            p.journal.journal_path(str(d / "fj")))
        assert not torn
        view, totals = [], []
        for r in records:
            meta = {k: v for k, v in r.meta.items()
                    if k not in ("t_wall", "wall_time_s", "initial_total",
                                 "final_total", "trace")}
            totals.append([r.meta.get(k, {}).get("value", 0.0)
                           for k in ("initial_total", "final_total")])
            arrays = (None if r.arrays is None else
                      {k: np.asarray(a).tobytes()
                       for k, a in r.arrays.items()})
            view.append((r.kind, meta, arrays))
        return got, hib, view, totals

    (jg, jhib, jview, jtot), (tg, thib, tview, ttot) = paired(run, tmp_path)
    assert_same_states(jg, tg)
    assert thib == jhib
    assert [v[0] for v in tview] == [v[0] for v in jview]
    assert "wake" in [v[0] for v in tview]
    assert tview == jview
    np.testing.assert_allclose(ttot, jtot, rtol=0, atol=1e-12)
