"""Supervisor failover and epoch fencing in the port (``ensemble/fleet.py``:
the lease, ``StandbySupervisor``; ``member_proc``: the member-side fence)
on the CPU: a counterpart of each test of the JAX package's
``tests/test_failover.py`` that is not slow, on a fake clock, with
in-process or loopback members (no subprocess, no sleep), and a takeover
across the packages: a standby of either package takes over the other's
dead supervisor and serves its pending ticket exactly once.

The TCP members: a ``MemberServer`` behind ``wire.tcp_listener`` on
127.0.0.1 serves a fleet after the HMAC handshake, bit for bit; a wrong
secret is refused before any frame; ``_dial_supervisor`` of a
``host:port`` without ``$MMTPU_WIRE_SECRET`` raises as JAX's does; and the
row with real spawned TCP children (``test_failover.py:314``) is marked
``slow``, as JAX marks it.
"""

import functools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_model_tpu as mm
from mpi_model_tpu.ensemble import FleetSupervisor as JFleet
from mpi_model_tpu.ensemble.fleet import StandbySupervisor as JStandby
from mpi_model_tpu.ensemble.journal import audit_journal as jaudit

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch.ensemble import (FleetSupervisor, StandbySupervisor,
                                          lease_path, read_lease)
from mpi_model_tpu_torch.ensemble.journal import (StaleEpochError,
                                                  TicketJournal,
                                                  audit_journal,
                                                  current_epoch,
                                                  declare_epoch,
                                                  journal_path, replay)
from mpi_model_tpu_torch.ensemble.member_proc import spawn_loopback_member
from mpi_model_tpu_torch.ensemble.wire import RemoteError
from mpi_model_tpu_torch.resilience import inject
from mpi_model_tpu_torch.resilience.inject import Fault, FaultPlan

loopback = functools.partial(spawn_loopback_member, device="cpu")


def raw(i, g=16):
    return np.random.default_rng((103, i, g)).uniform(0.5, 2.0, (g, g))


def scen_space(i, g=16):
    return mt.CellularSpace.create(g, g, 1.0, dtype="float64",
                                   device="cpu").with_values(
        {"value": torch.from_numpy(raw(i, g))})


def jscen_space(i, g=16):
    return mm.CellularSpace.create(g, g, 1.0, dtype=jnp.float64).with_values(
        {"value": jnp.asarray(raw(i, g))})


def scen_model(i=0):
    return mt.Model(mt.Diffusion(0.05 + 0.01 * i), 4.0, 1.0)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def named_fleet(journal_dir, clock, sup="sup-a", **kw):
    kw.setdefault("services", 1)
    kw.setdefault("steps", 4)
    kw.setdefault("device", "cpu")
    return FleetSupervisor(scen_model(), start=False,
                           journal_dir=str(journal_dir), clock=clock,
                           supervisor_id=sup, lease_s=2.0, **kw)


def standby(journal_dir, clock=None, sup="sup-b", **kw):
    kw.setdefault("services", 1)
    kw.setdefault("steps", 4)
    kw.setdefault("start", False)
    kw.setdefault("device", "cpu")
    if clock is not None:
        kw["clock"] = clock
    return StandbySupervisor(str(journal_dir), scen_model(),
                             supervisor_id=sup, **kw)


@pytest.fixture(autouse=True)
def _no_plan():
    yield
    inject._ACTIVE = None


# -- the lease and the epoch ----------------------------------------------------

def test_named_supervisor_declares_epoch_and_renews_lease(tmp_path):
    clock = FakeClock()
    fleet = named_fleet(tmp_path, clock)
    assert fleet.journal.epoch == 1
    assert current_epoch(journal_path(str(tmp_path))) == 1
    rec = read_lease(lease_path(str(tmp_path)))
    assert rec["owner"] == "sup-a" and rec["epoch"] == 1
    assert rec["t"] == 0.0 and rec["lease_s"] == 2.0
    clock.t = 1.5
    fleet.tick()
    assert read_lease(lease_path(str(tmp_path)))["t"] == 1.5
    st = fleet.stats()
    assert st["supervisor_id"] == "sup-a" and st["epoch"] == 1
    assert st["supervisor_kills"] == 0
    assert st["stale_epoch_rejections"] == 0
    fleet.stop()
    aud = audit_journal(journal_path(str(tmp_path)))
    assert aud["ok"]
    assert [e["epoch"] for e in aud["epochs"]] == [1]
    assert aud["epochs"][0]["supervisor"] == "sup-a"
    assert aud["epochs"][0]["takeover_from"] is None


def test_supervisor_id_requires_journal_dir():
    with pytest.raises(ValueError, match="journal_dir"):
        FleetSupervisor(scen_model(), start=False, supervisor_id="sup-x",
                        device="cpu")


def test_anonymous_supervisor_keeps_unfenced_semantics(tmp_path):
    fleet = FleetSupervisor(scen_model(), start=False, services=1,
                            steps=4, journal_dir=str(tmp_path),
                            device="cpu")
    assert fleet.journal.epoch is None
    assert read_lease(lease_path(str(tmp_path))) is None
    t = fleet.submit(scen_space(0))
    fleet.pump_once()
    fleet.result(t, timeout=5)
    fleet.stop()
    aud = audit_journal(journal_path(str(tmp_path)))
    assert aud["ok"] and aud["epochs"] == []


def test_a_garbled_lease_reads_as_none(tmp_path):
    path = lease_path(str(tmp_path))
    assert read_lease(path) is None
    with open(path, "w") as fh:
        fh.write('{"owner": "sup-a", "t"')
    assert read_lease(path) is None
    with open(path, "w") as fh:
        fh.write("[1, 2]")
    assert read_lease(path) is None


# -- standby takeover -----------------------------------------------------------

def test_standby_holds_while_lease_is_fresh(tmp_path):
    clock = FakeClock()
    fleet = named_fleet(tmp_path, clock)
    sb = standby(tmp_path, clock)
    clock.t = 1.9
    assert not sb.should_takeover()
    assert sb.poll() is None
    clock.t = 1.0
    fleet.tick()
    clock.t = 2.9
    assert not sb.should_takeover()
    fleet.stop()


def test_standby_takeover_fences_zombie_and_serves_exactly_once(tmp_path):
    clock = FakeClock()
    f1 = named_fleet(tmp_path, clock)
    t_served = f1.submit(scen_space(0))
    f1.pump_once()
    f1.result(t_served, timeout=5)
    t_pending = f1.submit(scen_space(1))
    sb = standby(tmp_path, clock)
    clock.t = 2.5
    assert sb.should_takeover()
    f2 = sb.takeover()
    assert sb.fleet is f2 and sb.poll() is None
    assert f2.journal.epoch == 2
    f2.pump_once()
    space2, _ = f2.result(t_pending, timeout=5)
    assert space2.values["value"].shape == (16, 16)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        f1._journal_append_locked("shed", {"ticket": 999})
    assert f1.counter.snapshot()["stale_epoch_rejections"] == 1
    with pytest.raises(StaleEpochError):
        f1.journal.append("shed", {"ticket": 998})
    f2.stop()
    aud = audit_journal(journal_path(str(tmp_path)))
    assert aud["ok"]
    assert aud["duplicate_terminals"] == []
    assert aud["stale_epoch_records"] == []
    assert [e["epoch"] for e in aud["epochs"]] == [1, 2]
    assert aud["epochs"][1]["supervisor"] == "sup-b"
    assert aud["epochs"][1]["takeover_from"] == "sup-a"
    state = replay(journal_path(str(tmp_path)))
    assert sorted(state.terminal) == sorted([t_served, t_pending])
    assert state.unresolved() == []


def test_standby_claims_leaseless_journal(tmp_path):
    fleet = FleetSupervisor(scen_model(), start=False, services=1,
                            steps=4, journal_dir=str(tmp_path),
                            device="cpu")
    t = fleet.submit(scen_space(0))
    fleet.abandon()
    sb = standby(tmp_path)
    assert sb.should_takeover()
    f2 = sb.takeover()
    f2.pump_once()
    assert f2.result(t, timeout=5)
    f2.stop()
    assert audit_journal(journal_path(str(tmp_path)))["ok"]


def test_standby_without_journal_waits(tmp_path):
    sb = StandbySupervisor(str(tmp_path), scen_model(),
                           supervisor_id="sup-b")
    assert not sb.should_takeover()


@pytest.mark.parametrize("active", ["jax", "torch"])
def test_a_standby_of_one_package_takes_over_the_others_fleet(tmp_path,
                                                               active):
    """The active supervisor of one package dies with a ticket pending; a
    standby of the other takes over the journal (epoch 2, the takeover
    naming the dead owner), serves the ticket once, bit for bit the active
    package's own result (a dyadic rate: ``tests/test_torch_fleet.py``),
    and both packages' audits are clean."""
    clock = FakeClock()
    jdir = str(tmp_path / "j")
    rate = 0.125
    if active == "jax":
        jm = mm.Model(mm.Diffusion(rate), 4.0, 1.0)
        ref = JFleet(jm, services=1, steps=4, start=False)
        want = np.asarray(ref.result(ref.submit(jscen_space(1)))[0]
                          .values["value"])
        ref.stop()
        f1 = JFleet(jm, services=1, steps=4, start=False, journal_dir=jdir,
                    clock=clock, supervisor_id="sup-a", lease_s=2.0)
        t = f1.submit(jscen_space(1))
        clock.t = 2.5
        sb = StandbySupervisor(jdir, mt.Model(mt.Diffusion(rate), 4.0, 1.0),
                               supervisor_id="sup-b", clock=clock,
                               services=1, steps=4, start=False,
                               device="cpu")
        f2 = sb.poll()
        got = f2.result(t, timeout=5)[0].values["value"].numpy()
    else:
        tm = mt.Model(mt.Diffusion(rate), 4.0, 1.0)
        ref = FleetSupervisor(tm, services=1, steps=4, start=False,
                              device="cpu")
        want = ref.result(ref.submit(scen_space(1)))[0].values[
            "value"].numpy()
        ref.stop()
        f1 = FleetSupervisor(tm, services=1, steps=4, start=False,
                             journal_dir=jdir, clock=clock,
                             supervisor_id="sup-a", lease_s=2.0,
                             device="cpu")
        t = f1.submit(scen_space(1))
        clock.t = 2.5
        sb = JStandby(jdir, mm.Model(mm.Diffusion(rate), 4.0, 1.0),
                      supervisor_id="sup-b", clock=clock, services=1,
                      steps=4, start=False)
        f2 = sb.poll()
        got = np.asarray(f2.result(t, timeout=5)[0].values["value"])
    assert f2 is not None and f2.journal.epoch == 2
    f2.stop()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(Exception, match="epoch"):
        f1.journal.append("shed", {"ticket": 999})
    for aud in (audit_journal(journal_path(jdir)),
                jaudit(journal_path(jdir))):
        assert aud["ok"] and not aud["unresolved"]
        assert [e["epoch"] for e in aud["epochs"]] == [1, 2]
        assert aud["epochs"][1]["takeover_from"] == "sup-a"


# -- the member-side fence ------------------------------------------------------

def test_member_refuses_stale_epoch_rpc():
    client = loopback(scen_model(), service_id="m0g0",
                      member_kwargs=dict(steps=4, retry="solo"))
    client.epoch = 2
    assert client.heartbeat()
    client.epoch = 1
    with pytest.raises(RemoteError) as ei:
        client.submit(scen_space(0))
    assert ei.value.remote_type == "StaleEpochError"
    client.epoch = 3
    t = client.submit(scen_space(0))
    while client.poll(t) is None:
        client.pump_once(force=True)
    client.close()


def test_fleet_arms_member_epoch_on_spawn(tmp_path):
    clock = FakeClock()
    fleet = named_fleet(tmp_path, clock, member_transport="process",
                        member_spawner=loopback, retry="solo")
    svc = next(iter(fleet._members.values())).service
    assert svc.epoch == 1
    t = fleet.submit(scen_space(0))
    fleet.pump_once()
    assert fleet.result(t, timeout=5)
    fleet.stop()


# -- the seams ------------------------------------------------------------------

def test_supervisor_kill_seam_stops_supervision_dead(tmp_path):
    clock = FakeClock()
    fleet = named_fleet(tmp_path, clock, sup="sup-c")
    plan = FaultPlan((Fault("supervisor_kill", channel="sup-c", at=2),))
    with inject.armed(plan) as st:
        fleet.tick()
        assert not fleet._abandoned
        fleet.tick()
    assert [f["kind"] for f in st.fired] == ["supervisor_kill"]
    assert fleet._abandoned and fleet._stopped
    assert fleet.counter.snapshot()["supervisor_kills"] == 1
    assert fleet.journal is not None
    fleet.tick()


def test_supervisor_kill_then_standby_takeover_chaos_row(tmp_path):
    clock = FakeClock()
    f1 = named_fleet(tmp_path, clock, sup="sup-a")
    t1 = f1.submit(scen_space(0))
    with inject.armed(FaultPlan(
            (Fault("supervisor_kill", channel="sup-a", at=1),))):
        f1.tick()
    sb = standby(tmp_path, clock)
    clock.t = 2.5
    f2 = sb.poll()
    assert f2 is not None
    f2.pump_once()
    assert f2.result(t1, timeout=5)
    with pytest.raises(StaleEpochError):
        f1.journal.append("shed", {"ticket": 999})
    f2.stop()
    aud = audit_journal(journal_path(str(tmp_path)))
    assert aud["ok"]
    assert [e["epoch"] for e in aud["epochs"]] == [1, 2]


def test_stale_epoch_append_seam_fences_a_current_handle(tmp_path):
    clock = FakeClock()
    fleet = named_fleet(tmp_path, clock)
    jpath = journal_path(str(tmp_path))
    plan = FaultPlan((Fault("stale_epoch_append", channel=jpath),))
    with inject.armed(plan) as st:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            t = fleet.submit(scen_space(0))
    assert [f["kind"] for f in st.fired] == ["stale_epoch_append"]
    assert fleet.counter.snapshot()["stale_epoch_rejections"] == 1
    fleet.pump_once()
    assert fleet.result(t, timeout=5)
    fleet.stop()
    aud = audit_journal(jpath)
    assert aud["ok"]


def test_stale_epoch_records_fail_the_audit(tmp_path):
    jpath = journal_path(str(tmp_path))
    j1 = TicketJournal(jpath, epoch=0)
    declare_epoch(j1, supervisor="sup-a")
    j2 = TicketJournal(jpath, epoch=0)
    declare_epoch(j2, supervisor="sup-b", takeover_from="sup-a")
    j2.append("shed", {"ticket": 1, "epoch": 1})
    j2.close(), j1.close()
    aud = audit_journal(jpath)
    assert not aud["ok"]
    assert aud["stale_epoch_records"], aud


# -- the TCP members ------------------------------------------------------------

def _tcp_thread_member(monkeypatch, secrets_seen):
    """A spawner whose member is a ``MemberServer`` on a thread behind a
    real TCP listener on 127.0.0.1: the listener serves the handshake with a
    fresh secret, and the client dials through ``_dial_supervisor`` with
    that secret in its environment, as a spawned child would."""
    import secrets
    import threading

    from mpi_model_tpu_torch.ensemble import AsyncEnsembleService, member_proc
    from mpi_model_tpu_torch.ensemble.journal import (model_from_meta,
                                                      model_meta)
    from mpi_model_tpu_torch.ensemble.wire import (SECRET_ENV, FrameConn,
                                                   serve_handshake,
                                                   tcp_listener)

    def spawn(model, *, service_id, member_kwargs, clock,
              heartbeat_deadline_s, rpc_deadline_s, member_env=None,
              pump_mode="rpc", device=None):
        secret = secrets.token_hex(32)
        secrets_seen.append((heartbeat_deadline_s, rpc_deadline_s))
        listener = tcp_listener("127.0.0.1", 0)
        addr = "%s:%d" % listener.getsockname()[:2]
        kwargs = dict(member_kwargs)
        kwargs.setdefault("clock", clock)
        service = AsyncEnsembleService(
            model_from_meta(model_meta(model)), start=False,
            service_id=service_id, **kwargs)

        def serve():
            sock, _ = listener.accept()
            listener.close()
            serve_handshake(sock, secret)
            member_proc.MemberServer(service, FrameConn(sock),
                                     pump=pump_mode, ship_spans=False,
                                     device="cpu").serve_forever()

        t = threading.Thread(target=serve, daemon=True,
                             name=f"tcp-member-{service_id}")
        t.start()
        monkeypatch.setenv(SECRET_ENV, secret)
        sock = member_proc._dial_supervisor(addr)
        return member_proc.ProcessMemberClient(
            FrameConn(sock, chaos_id=service_id), service_id, clock=clock,
            heartbeat_deadline_s=heartbeat_deadline_s,
            rpc_deadline_s=rpc_deadline_s, server_thread=t, device="cpu")

    return spawn


def test_tcp_member_serves_after_the_handshake_bit_for_bit(monkeypatch,
                                                           tmp_path):
    """A fleet over ``member_transport="tcp"`` whose members sit behind a
    real TCP listener on 127.0.0.1: the TCP deadlines (5 s and 60 s) reach
    the spawner, every scenario crosses the authenticated wire and is served
    bit for bit the synchronous service's, and the wire counts its bytes."""
    seen: list = []
    spaces = [scen_space(i) for i in range(4)]
    sync = mt.EnsembleService(scen_model(), steps=4)
    ts = [sync.submit(sp) for sp in spaces]
    sync.flush()
    want = [sync.result(t)[0].values["value"] for t in ts]
    fleet = FleetSupervisor(scen_model(), services=2, steps=4, start=False,
                            member_transport="tcp", device="cpu",
                            member_spawner=_tcp_thread_member(monkeypatch,
                                                              seen))
    got = [fleet.result(fleet.submit(sp)) for sp in spaces]
    st = fleet.stats()
    fleet.stop()
    assert seen == [(5.0, 60.0), (5.0, 60.0)]
    for (out, rep), w in zip(got, want):
        assert torch.equal(out.values["value"], w)
        assert rep.steps == 4
    assert st["member_transport"] == "tcp"
    assert st["scenarios"] == 4 and st["pending"] == 0
    assert st["wire_bytes_in"] > 0 and st["wire_bytes_out"] > 0


def test_tcp_wrong_secret_is_refused_before_any_frame():
    """A dial with the wrong secret fails the handshake on both sides: the
    listener raises ``HandshakeError`` and closes the socket without reading
    a frame, and the dialer's handshake fails too."""
    import threading

    from mpi_model_tpu_torch.ensemble.wire import (HandshakeError,
                                                   client_handshake,
                                                   serve_handshake, tcp_dial,
                                                   tcp_listener)

    listener = tcp_listener("127.0.0.1", 0)
    addr = "%s:%d" % listener.getsockname()[:2]
    seen = {}

    def serve():
        sock, _ = listener.accept()
        try:
            serve_handshake(sock, "the-right-secret")
        except HandshakeError as e:
            seen["server"] = e
            seen["closed"] = sock.fileno() == -1

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    sock = tcp_dial(addr)
    with pytest.raises(HandshakeError):
        client_handshake(sock, "a-wrong-secret")
    t.join(timeout=30.0)
    listener.close()
    sock.close()
    assert isinstance(seen.get("server"), HandshakeError)
    assert seen["closed"]


def test_dial_without_the_secret_raises_like_jax(monkeypatch):
    """``_dial_supervisor`` of a ``host:port`` needs the secret in the
    environment; without it both packages raise the handshake error naming
    the variable, before dialing anything."""
    from mpi_model_tpu.ensemble import member_proc as jmember_proc
    from mpi_model_tpu.ensemble.wire import HandshakeError as JHandshake

    from mpi_model_tpu_torch.ensemble import member_proc
    from mpi_model_tpu_torch.ensemble.wire import SECRET_ENV, HandshakeError

    monkeypatch.delenv(SECRET_ENV, raising=False)
    assert SECRET_ENV == "MMTPU_WIRE_SECRET"
    msgs = []
    for mod, err in ((member_proc, HandshakeError),
                     (jmember_proc, JHandshake)):
        with pytest.raises(err, match=SECRET_ENV) as ei:
            mod._dial_supervisor("127.0.0.1:9")
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


@pytest.mark.slow
def test_tcp_fleet_serves_through_authenticated_members(tmp_path):
    """Real spawned children behind authenticated TCP (CPU children): the
    fleet leg of the wire handshake, end to end, under a named supervisor
    whose journal audit holds one epoch."""
    fleet = FleetSupervisor(scen_model(), services=2, steps=4,
                            member_transport="tcp",
                            journal_dir=str(tmp_path),
                            supervisor_id="sup-tcp", start=True,
                            device="cpu")
    try:
        assert fleet._heartbeat_deadline == 5.0
        assert fleet._rpc_deadline == 60.0
        tickets = [fleet.submit(scen_space(i)) for i in range(4)]
        for t in tickets:
            space, _ = fleet.result(t, timeout=60)
            assert space.values["value"].shape == (16, 16)
    finally:
        fleet.stop()
    aud = audit_journal(journal_path(str(tmp_path)))
    assert aud["ok"]
    assert [e["epoch"] for e in aud["epochs"]] == [1]
    st = fleet.stats()
    assert st["member_transport"] == "tcp"
    assert st["wire_bytes_in"] > 0 and st["wire_bytes_out"] > 0
    # each child passed the handshake at its spawn
    assert all(m.service.handshake_s is not None
               and m.service.handshake_s > 0
               for m in fleet._members.values())
