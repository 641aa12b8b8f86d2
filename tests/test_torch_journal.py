"""The fleet's formats in the port on the CPU: the lifecycle machines
(``ensemble/lifecycle.py``), the protocol witness
(``resilience/protocolcheck.py``), the TJ1 ticket journal
(``ensemble/journal.py``) and the post-mortem timeline
(``obs/postmortem.py``, ``obs.timeline``, ``python -m
mpi_model_tpu_torch.obs timeline``), held against the JAX package.

- ``FLEET``/``TIERING`` are equal to JAX's as data (states, transitions,
  terminals, meta keys), and so are the stamps and event kinds.
- Counterparts of JAX's ``tests/test_protocolcheck.py`` (its two jaxpr
  pins become a step held bit for bit with the witness armed), the journal
  tests of ``tests/test_fleet.py:361-413`` and the epoch tests of
  ``tests/test_failover.py`` that need no fleet.
- With ``t_wall`` pinned (in the meta, or through the journal module's
  clock), a journal file written by each package is byte for byte the
  other's (f64, f32, int and bf16 state; epoch records); each package
  replays the other's, torn tail and epoch fence included, to equal
  ``JournalState``s.
- ``reconstruct`` of the same journals and spans gives the same event list
  in both packages; a ticket served through the port's service, journaled
  with its trace context, has a complete timeline.

Record kinds are spelled through the port's ``lifecycle`` constants; no
wall clock is read.
"""

import dataclasses
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import mpi_model_tpu as mm
from mpi_model_tpu.ensemble import journal as jjournal
from mpi_model_tpu.ensemble import lifecycle as jlifecycle
from mpi_model_tpu.obs import postmortem as jpostmortem
from mpi_model_tpu.resilience import inject as jinject

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch import obs
from mpi_model_tpu_torch.ensemble import journal, lifecycle
from mpi_model_tpu_torch.ensemble.journal import (
    StaleEpochError, TicketJournal, audit_journal, current_epoch,
    declare_epoch, journal_path, model_from_meta, model_meta,
    read_records, replay, space_from_record, space_payload)
from mpi_model_tpu_torch.ensemble.lifecycle import (
    FLEET, HIBERNATE, HIBERNATED, MIGRATE, QUARANTINED,
    READMIT, RECLAIM, SERVED, SHED, SUBMIT, TIERING, WAKE)
from mpi_model_tpu_torch.obs import postmortem
from mpi_model_tpu_torch.obs.__main__ import main as obs_main
from mpi_model_tpu_torch.resilience import inject, protocolcheck
from mpi_model_tpu_torch.resilience.inject import Fault, FaultPlan
from mpi_model_tpu_torch.utils import Tracer, set_tracer

F = FLEET.journal_name        # tickets.journal
T = TIERING.journal_name      # hibernation.journal
RNG = np.random.default_rng(17)
GRID64 = RNG.uniform(0.5, 2.0, (8, 8))
GRID32 = RNG.uniform(0.5, 2.0, (8, 8)).astype(np.float32)
IDS = RNG.integers(0, 1000, (8,), dtype=np.int32)
BF16_BITS = RNG.integers(0, 1 << 16, (8, 8), dtype=np.uint16)


class FixedTime:
    """The journal modules' clock, pinned: ``t_wall`` advances by 0.25 s an
    append, the same in both packages."""

    def __init__(self):
        self.t = 1_700_000_000.0

    def time(self):
        self.t += 0.25
        return self.t


@pytest.fixture
def pinned_clocks(monkeypatch):
    monkeypatch.setattr(journal, "time", FixedTime())
    monkeypatch.setattr(jjournal, "time", FixedTime())


@pytest.fixture(autouse=True)
def _no_witness_left():
    yield
    assert protocolcheck.active() is None and inject.active() is None
    assert jinject.active() is None


def kinds_of(w):
    return [v["kind"] for v in w.violations]


# -- the lifecycle machines, as data ------------------------------------------

def test_machines_equal_jax_as_data():
    for mine, theirs in ((FLEET, jlifecycle.FLEET),
                         (TIERING, jlifecycle.TIERING)):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.kinds() == theirs.kinds()
        assert mine.terminal_kinds() == theirs.terminal_kinds()
        assert mine.attribution_kinds() == theirs.attribution_kinds()
        assert mine.meta_keys() == theirs.meta_keys()
    assert lifecycle.TERMINAL_KINDS == jlifecycle.TERMINAL_KINDS
    assert lifecycle.STAMPED_META == jlifecycle.STAMPED_META
    assert lifecycle.EVENT_KINDS == jlifecycle.EVENT_KINDS
    assert set(lifecycle.MACHINES) == set(jlifecycle.MACHINES)
    for name in jlifecycle.__all__:
        v = getattr(jlifecycle, name)
        if isinstance(v, str):
            assert getattr(lifecycle, name) == v, name


def test_machine_for_journal_and_legality():
    assert lifecycle.machine_for_journal("/x/tickets.journal") is FLEET
    assert lifecycle.machine_for_journal("hibernation.journal") is TIERING
    assert lifecycle.machine_for_journal("audit.log") is None
    assert FLEET.legal(SUBMIT, "new") and not FLEET.legal(SUBMIT,
                                                          "in-flight")
    assert FLEET.legal(SHED, "resolved")  # ticketless: from anywhere
    assert FLEET.is_terminal(SERVED) and not FLEET.is_terminal(MIGRATE)
    assert TIERING.legal(WAKE, "hibernated")
    assert not TIERING.legal(WAKE, "hibernating")


# -- the protocol witness (tests/test_protocolcheck.py) -----------------------

def test_disarmed_is_inert():
    assert protocolcheck.active() is None
    protocolcheck.journal_append(F, "meteor", {})
    assert protocolcheck.active() is None


def test_armed_exposes_witness_and_restores_on_exit():
    with protocolcheck.armed() as w:
        assert protocolcheck.active() is w
    assert protocolcheck.active() is None


def test_double_arming_is_refused():
    with protocolcheck.armed():
        with pytest.raises(RuntimeError, match="already armed"):
            with protocolcheck.armed():
                pass


def test_armed_clears_even_when_body_raises():
    with pytest.raises(ValueError):
        with protocolcheck.armed():
            raise ValueError("boom")
    assert protocolcheck.active() is None


def test_legal_lifecycle_is_clean_and_counted():
    with protocolcheck.armed() as w:
        w.observe(F, SUBMIT, {"ticket": "t0"})
        w.observe(F, MIGRATE, {"ticket": "t0"})
        w.observe(F, SERVED, {"ticket": "t0"})
    assert w.records == 3
    assert w.violations == []
    w.assert_clean()


def test_illegal_transition_flagged():
    with protocolcheck.armed() as w:
        w.observe(F, SUBMIT, {"ticket": "t0"})
        w.observe(F, SUBMIT, {"ticket": "t0"})
    assert kinds_of(w) == ["illegal-transition"]
    with pytest.raises(protocolcheck.ProtocolViolation,
                       match="illegal-transition"):
        w.assert_clean()


def test_duplicate_terminal_flagged():
    with protocolcheck.armed() as w:
        w.observe(F, SUBMIT, {"ticket": "t0"})
        w.observe(F, SERVED, {"ticket": "t0"})
        w.observe(F, SERVED, {"ticket": "t0"})
    assert kinds_of(w) == ["duplicate-terminal"]


def test_wake_without_commit_flagged():
    with protocolcheck.armed() as w:
        w.observe(T, HIBERNATE, {"ticket": "t0"})
        w.observe(T, WAKE, {"ticket": "t0"})
    assert kinds_of(w) == ["wake-without-commit"]


def test_committed_hibernation_wake_is_clean():
    with protocolcheck.armed() as w:
        w.observe(T, HIBERNATE, {"ticket": "t0"})
        w.observe(T, HIBERNATED, {"ticket": "t0"})
        w.observe(T, WAKE, {"ticket": "t0"})
        w.observe(T, RECLAIM, {"ticket": "t0"})
    w.assert_clean()


def test_undeclared_kind_flagged():
    with protocolcheck.armed() as w:
        w.observe(F, "meteor", {"ticket": "t0"})
    assert kinds_of(w) == ["undeclared-kind"]


def test_missing_ticket_flagged():
    with protocolcheck.armed() as w:
        w.observe(F, SUBMIT, {})
    assert kinds_of(w) == ["missing-ticket"]


def test_ticketless_shed_is_clean():
    with protocolcheck.armed() as w:
        w.observe(F, SHED, {"reason": "overload"})
    assert w.records == 1
    w.assert_clean()


def test_adoption_on_first_sighting_mid_lifecycle():
    with protocolcheck.armed() as w:
        w.observe(F, SERVED, {"ticket": "recovered"})
        assert w.violations == []
        w.observe(F, SERVED, {"ticket": "recovered"})
    assert kinds_of(w) == ["duplicate-terminal"]


def test_undeclared_stream_is_ignored():
    with protocolcheck.armed() as w:
        w.observe("delta.chain", SUBMIT, {"ticket": "t0"})
    assert w.records == 0
    w.assert_clean()


def test_violations_deduplicate():
    with protocolcheck.armed() as w:
        for _ in range(3):
            w.observe(F, "meteor", {"ticket": "t0"})
    assert w.records == 3
    assert kinds_of(w) == ["undeclared-kind"]


def test_one_bad_record_does_not_cascade():
    with protocolcheck.armed() as w:
        w.observe(F, SUBMIT, {"ticket": "t0"})
        w.observe(F, SUBMIT, {"ticket": "t0"})
        w.observe(F, SERVED, {"ticket": "t0"})
    assert kinds_of(w) == ["illegal-transition"]


def test_ticket_journal_feeds_the_witness(tmp_path):
    path = str(tmp_path / F)
    with protocolcheck.armed() as w:
        with TicketJournal(path) as j:
            j.append(SUBMIT, {"ticket": "t0", "steps": 2})
            j.append(SHED, {"reason": "overload"})
            j.append(SERVED, {"ticket": "t0", "steps": 2})
    assert w.records == 3
    w.assert_clean()


def test_ticket_journal_surfaces_live_duplicate_terminal(tmp_path):
    path = str(tmp_path / F)
    with protocolcheck.armed() as w:
        with TicketJournal(path) as j:
            j.append(SUBMIT, {"ticket": "t0"})
            j.append(SERVED, {"ticket": "t0"})
            j.append(SERVED, {"ticket": "t0"})
    assert kinds_of(w) == ["duplicate-terminal"]


def test_non_lifecycle_journal_not_witnessed(tmp_path):
    path = str(tmp_path / "audit.log")
    with protocolcheck.armed() as w:
        with TicketJournal(path) as j:
            j.append("anything", {"x": 1})
    assert w.records == 0
    w.assert_clean()


@pytest.mark.parametrize("witness", ["protocolcheck", "lockdep"])
def test_a_step_is_unchanged_with_a_witness_armed(witness):
    """Journals and locks are host-side: an armed witness leaves a model
    run bit for bit and launches nothing more (the port's counterpart of
    JAX's two jaxpr pins)."""
    from mpi_model_tpu_torch.models.model import kernel_launches
    from mpi_model_tpu_torch.resilience import lockdep

    arm = protocolcheck.armed if witness == "protocolcheck" else \
        lockdep.armed
    space = mt.CellularSpace.create(8, 8, 1.0, dtype="float64",
                                    device="cpu").with_values(
        {"value": torch.from_numpy(GRID64.copy())})
    model = mt.Model(mt.Diffusion(0.1), 4.0, 1.0)
    clean, _ = model.execute(space, steps=4)
    before = kernel_launches()
    with arm():
        armed_out, _ = mt.Model(mt.Diffusion(0.1), 4.0, 1.0).execute(
            space, steps=4)
    assert kernel_launches() == before
    assert torch.equal(clean.values["value"], armed_out.values["value"])


# -- the journal (tests/test_fleet.py:361-413, tests/test_failover.py) --------

def test_journal_roundtrip_records_and_arrays(tmp_path):
    path = str(tmp_path / F)
    arr = np.arange(12, dtype=np.float64).reshape(3, 4)
    with TicketJournal(path) as j:
        j.append(SUBMIT, {"ticket": 0, "steps": 4}, {"value": arr})
        j.append(SERVED, {"ticket": 0})
        assert j.count == 2
    records, torn = read_records(path)
    assert torn is False
    assert [r.kind for r in records] == [SUBMIT, SERVED]
    np.testing.assert_array_equal(records[0].arrays["value"].numpy(), arr)
    assert records[0].meta["steps"] == 4
    state = replay(path)
    assert state.unresolved() == [] and not state.duplicate_terminals


def test_journal_torn_tail_recovers_verified_prefix(tmp_path):
    path = str(tmp_path / F)
    with TicketJournal(path) as j:
        j.append(SUBMIT, {"ticket": 0})
        start_of_second = os.path.getsize(path)
        j.append(SUBMIT, {"ticket": 1})
    inject.tear_file(path, start_of_second + 5, tear="truncate")
    records, torn = read_records(path)
    assert torn is True
    assert [r.ticket for r in records] == [0]
    with TicketJournal(str(tmp_path / "j2")) as j:
        j.append(SUBMIT, {"ticket": 0})
        j.append(SUBMIT, {"ticket": 1})
    inject.tear_file(str(tmp_path / "j2"), 30, nbytes=4, tear="corrupt")
    records, torn = read_records(str(tmp_path / "j2"))
    assert torn is True and records == []


def test_journal_append_after_torn_tail_extends_verified_prefix(tmp_path):
    path = str(tmp_path / F)
    with TicketJournal(path) as j:
        j.append(SUBMIT, {"ticket": 0})
        second = os.path.getsize(path)
        j.append(SUBMIT, {"ticket": 1})
    inject.tear_file(path, second + 3, tear="truncate")
    with TicketJournal(path) as j:     # reopening truncates the torn tail
        assert j.count == 1
        j.append(SERVED, {"ticket": 0})
    records, torn = read_records(path)
    assert torn is False
    assert [(r.kind, r.ticket) for r in records] == [
        (SUBMIT, 0), (SERVED, 0)]


def test_journal_torn_chaos_seam_fires(tmp_path):
    path = str(tmp_path / F)
    plan = FaultPlan((Fault("journal_torn", at=1, offset=4,
                            tear="truncate"),))
    with inject.armed(plan) as st, TicketJournal(path) as j:
        j.append(SUBMIT, {"ticket": 0})
        j.append(SUBMIT, {"ticket": 1})   # torn right after this write
    assert [f["kind"] for f in st.fired] == ["journal_torn"]
    records, torn = read_records(path)
    assert torn is True and [r.ticket for r in records] == [0]


def test_stale_epoch_append_seam_fences_a_current_handle(tmp_path):
    """``tests/test_failover.py:275`` without the fleet: the seam makes one
    append behave as an older handle's; it raises ``StaleEpochError`` and
    writes nothing, and the audit stays clean."""
    jpath = journal_path(str(tmp_path))
    j = TicketJournal(jpath)
    assert declare_epoch(j, supervisor="sup-a") == 1
    plan = FaultPlan((Fault("stale_epoch_append", channel=jpath),))
    size = os.path.getsize(jpath)
    with inject.armed(plan) as st:
        with pytest.raises(StaleEpochError, match="fenced"):
            j.append(SUBMIT, {"ticket": 0})
    assert [f["kind"] for f in st.fired] == ["stale_epoch_append"]
    assert os.path.getsize(jpath) == size
    j.append(SUBMIT, {"ticket": 0})
    j.close()
    aud = audit_journal(jpath)
    assert aud["ok"] and aud["submits"] == 1
    assert [e["epoch"] for e in aud["epochs"]] == [1]


def test_takeover_fences_the_older_handle(tmp_path):
    jpath = journal_path(str(tmp_path))
    j1 = TicketJournal(jpath)
    declare_epoch(j1, supervisor="sup-a")
    j2 = TicketJournal(jpath)
    assert declare_epoch(j2, supervisor="sup-b",
                         takeover_from="sup-a") == 2
    assert current_epoch(jpath) == 2
    with pytest.raises(StaleEpochError):
        j1.append(SHED, {"ticket": 999})
    j1.close(), j2.close()
    aud = audit_journal(jpath)
    assert aud["ok"] and [e["epoch"] for e in aud["epochs"]] == [1, 2]
    assert aud["epochs"][1]["takeover_from"] == "sup-a"


def test_stale_epoch_records_fail_the_audit(tmp_path):
    """``tests/test_failover.py:294``: a record that lands with an older
    epoch stamp is flagged by replay and the audit."""
    jpath = journal_path(str(tmp_path))
    j1 = TicketJournal(jpath, epoch=0)
    declare_epoch(j1, supervisor="sup-a")
    j2 = TicketJournal(jpath, epoch=0)
    declare_epoch(j2, supervisor="sup-b", takeover_from="sup-a")
    j2.append(SHED, {"ticket": 1, "epoch": 1})
    j2.close(), j1.close()
    aud = audit_journal(jpath)
    assert not aud["ok"]
    assert aud["stale_epoch_records"], aud


def test_journal_cli_audits_like_jax(tmp_path, capsys):
    """``python -m mpi_model_tpu_torch.ensemble.journal``: the same audit
    line as JAX's command on the same file; exit 1 on a duplicate
    terminal, 2 with no journal."""
    path = journal_path(str(tmp_path))
    with TicketJournal(path) as j:
        j.append(SUBMIT, {"ticket": 0, "t_wall": 1.0}, {"v": GRID64})
        j.append(SERVED, {"ticket": 0, "t_wall": 2.0})
        j.append(SUBMIT, {"ticket": 1, "t_wall": 3.0})
    assert journal.main([str(tmp_path), "--json"]) == 0
    mine = capsys.readouterr().out
    assert jjournal.main([str(tmp_path), "--json"]) == 0
    assert mine == capsys.readouterr().out
    assert json.loads(mine)["unresolved"] == [1]
    assert journal.main([str(tmp_path)]) == 0
    listing = capsys.readouterr().out
    assert jjournal.main([str(tmp_path)]) == 0
    assert listing == capsys.readouterr().out
    with TicketJournal(path) as j:
        j.append(SERVED, {"ticket": 0, "t_wall": 4.0})
    assert journal.main([str(tmp_path), "--json"]) == 1
    assert json.loads(capsys.readouterr().out)["duplicate_terminals"] == [0]
    assert journal.main([str(tmp_path / "nowhere")]) == 2


# -- the formats across the packages ------------------------------------------

def _write_stream(mod, path, bf16, epoch_fence=False):
    """One record stream through a package's ``TicketJournal``: state of
    every dtype class, attribution, terminals, a shed and (optionally) the
    epoch records."""
    j = mod.TicketJournal(path)
    if epoch_fence:
        mod.declare_epoch(j, supervisor="sup-a")
    j.append(SUBMIT, {"ticket": 0, "steps": 4, "service_id": "m0g0",
                      "dim_x": 8, "dim_y": 8},
             {"value": GRID64, "ids": IDS})
    j.append(SUBMIT, {"ticket": 1, "steps": 4, "dim_x": 8, "dim_y": 8},
             {"value": GRID32, "b16": bf16})
    j.append(MIGRATE, {"ticket": 1, "from": "m0g0", "to": "m1g0",
                       "reason": "rebalance"})
    j.append(SHED, {"depth": 3, "members": 2})
    j.append(SERVED, {"ticket": 0, "steps": 4, "final_total": 64.0},
             {"value": GRID64})
    j.append(QUARANTINED, {"ticket": 1, "error": "InjectedFault",
                           "detail": "x"})
    if epoch_fence:
        mod.declare_epoch(j, supervisor="sup-b", takeover_from="sup-a")
    j.close()
    return j


def _bf16_for(mod):
    if mod is journal:
        return torch.from_numpy(BF16_BITS.copy()).view(torch.bfloat16)
    return BF16_BITS.view(ml_dtypes.bfloat16)


@pytest.mark.parametrize("epoch_fence", [False, True])
def test_journal_files_are_byte_identical_across_the_packages(
        tmp_path, pinned_clocks, epoch_fence):
    paths = {}
    for name, mod in (("port", journal), ("jax", jjournal)):
        paths[name] = str(tmp_path / name / F)
        _write_stream(mod, paths[name], _bf16_for(mod), epoch_fence)
    with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
        assert a.read() == b.read()
    if epoch_fence:
        assert current_epoch(paths["port"]) == \
            jjournal.current_epoch(paths["jax"]) == 2


def _state_view(state) -> dict:
    """A JournalState as comparable data (arrays as their bytes)."""
    def rec(r):
        arrays = None
        if r.arrays is not None:
            arrays = {}
            for k, a in r.arrays.items():
                if isinstance(a, torch.Tensor):
                    a = a.view(torch.int16).numpy()
                arrays[k] = np.asarray(a).tobytes()
        return (r.index, r.kind, json.dumps(r.meta, sort_keys=True), arrays)

    return {
        "submits": {t: rec(r) for t, r in state.submits.items()},
        "terminal": {t: rec(r) for t, r in state.terminal.items()},
        "duplicate_terminals": state.duplicate_terminals,
        "shed": state.shed, "torn": state.torn,
        "epochs": state.epochs,
        "stale_epoch_records": state.stale_epoch_records,
        "unresolved": state.unresolved(),
    }


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("damage", ["none", "torn", "fenced"])
def test_each_package_replays_the_others_journal(tmp_path, writer, damage):
    """A journal written by either package replays in both to equal
    states; a torn tail costs the same suffix in both, and the reopened
    handle of either package truncates it; an epoch-fenced zombie handle is
    refused by either package's fence."""
    mod = journal if writer == "port" else jjournal
    path = str(tmp_path / F)
    _write_stream(mod, path, _bf16_for(mod), epoch_fence=True)
    if damage == "torn":
        recs, _ = read_records(path)
        inject.tear_file(path, os.path.getsize(path) - 7, tear="truncate")
    states = {"port": replay(path), "jax": jjournal.replay(path)}
    assert _state_view(states["port"]) == _state_view(states["jax"])
    if damage == "torn":
        assert states["port"].torn and states["port"].epochs[-1][
            "supervisor"] == "sup-a"
        other = jjournal if writer == "port" else journal
        with other.TicketJournal(path) as j:   # truncates the torn tail
            assert j.count == len(recs) - 1
        assert not replay(path).torn and not jjournal.replay(path).torn
    if damage == "fenced":
        for m in (journal, jjournal):
            zombie = m.TicketJournal(path, epoch=1)
            with pytest.raises(m.StaleEpochError):
                zombie.append(SUBMIT, {"ticket": 5})
            zombie.close()
        assert audit_journal(path) == jjournal.audit_journal(path)
    sp = space_from_record(states["port"].submits[0], device="cpu")
    np.testing.assert_array_equal(sp.values["value"].numpy(), GRID64)
    b16 = states["port"].submits[1].arrays["b16"]
    assert b16.dtype == torch.bfloat16
    assert b16.view(torch.int16).numpy().view(np.uint16).tobytes() == \
        BF16_BITS.tobytes()


def test_space_payload_roundtrips_on_a_named_device(tmp_path):
    space = mt.CellularSpace.create(8, 8, 1.0, dtype="float32",
                                    device="cpu").with_values(
        {"value": torch.from_numpy(GRID32.copy())})
    meta, arrays = space_payload(space)
    jmeta, jarrays = jjournal.space_payload(
        mm.CellularSpace.create(8, 8, 1.0, dtype="float32").with_values(
            {"value": GRID32}))
    assert meta == jmeta
    path = str(tmp_path / F)
    with TicketJournal(path) as j:
        j.append(SUBMIT, dict(meta, ticket=0, t_wall=1.0), arrays)
    with jjournal.TicketJournal(str(tmp_path / "j" / F)) as j:
        j.append(SUBMIT, dict(jmeta, ticket=0, t_wall=1.0), jarrays)
    with open(path, "rb") as a, open(str(tmp_path / "j" / F), "rb") as b:
        assert a.read() == b.read()
    rec = read_records(path)[0][0]
    back = space_from_record(rec, device="cpu")
    assert back.values["value"].device.type == "cpu"
    assert torch.equal(back.values["value"], space.values["value"])
    with pytest.raises(ValueError, match="no state"):
        space_from_record(journal.JournalRecord(3, SERVED, {}), device="cpu")
    jback = jjournal.space_from_record(read_records(path)[0][0])
    np.testing.assert_array_equal(np.asarray(jback.values["value"]), GRID32)


def test_model_meta_equals_jax_and_rebuilds_the_ports_model():
    port_model = mt.Model([mt.Diffusion(0.1), mt.Coupled(0.05, "a", "b")],
                          8.0, 2.0)
    jax_model = mm.Model([mm.Diffusion(0.1), mm.Coupled(0.05, "a", "b")],
                         8.0, 2.0)
    meta = model_meta(port_model)
    assert meta == jjournal.model_meta(jax_model)
    back = model_from_meta(json.loads(json.dumps(meta)))
    assert [type(f).__name__ for f in back.flows] == ["Diffusion",
                                                      "Coupled"]
    assert dataclasses.asdict(back.flows[1]) == dataclasses.asdict(
        port_model.flows[1])
    assert (back.time, back.time_step, back.offsets) == (
        8.0, 2.0, port_model.offsets)
    assert model_from_meta(None, template=port_model) is port_model
    ref = mt.Model(mt.Exponencial(mt.Cell(1, 1, mt.Attribute(0, 1.0)),
                                  0.1))
    assert model_meta(ref) is None
    with pytest.raises(ValueError, match="unknown flow type"):
        model_from_meta({"flows": [{"type": "Meteor", "params": {}}],
                         "time": 1.0, "time_step": 1.0, "offsets": []})


# -- the timeline ----------------------------------------------------------------

def _timeline_fixture(root):
    """A fleet journal (three tickets: served, in flight, quarantined after
    a readmit) and a tiering journal, with stamped records, and span
    dicts."""
    jdir, vdir = root / "journal", root / "vault"
    trace = {"trace_id": "t" * 16, "span_id": "s" * 8}
    with TicketJournal(journal_path(str(jdir))) as j:
        j.append(SUBMIT, {"ticket": 0, "service_id": "m0g0", "steps": 4,
                          "trace": trace, "t_wall": 10.0})
        j.append(SUBMIT, {"ticket": 1, "service_id": "m0g0", "steps": 4,
                          "t_wall": 10.5})
        j.append(SUBMIT, {"ticket": 2, "service_id": "m1g0", "steps": 4,
                          "t_wall": 10.6})
        j.append(READMIT, {"ticket": 2, "from": "m1g0", "to": "m0g0",
                           "reason": "fenced", "service_id": "m0g0",
                           "t_wall": 10.7})
        j.append(SERVED, {"ticket": 0, "service_id": "m0g0", "steps": 4,
                          "t_wall": 12.0})
        j.append(QUARANTINED,
                 {"ticket": 2, "service_id": "m0g0", "error": "X",
                  "detail": "d", "t_wall": 13.0})
        j.append(WAKE, {"ticket": 1, "to": "m0g0", "t_wall": 11.0})
    with TicketJournal(str(vdir / T)) as j:
        j.append(HIBERNATE, {"ticket": 1, "seq": 0, "t_wall": 10.8})
        j.append(HIBERNATED, {"ticket": 1, "seq": 0, "t_wall": 10.9})
        j.append(WAKE, {"ticket": 1, "seq": 0, "source": "chain",
                        "t_wall": 11.0})
    spans = [
        {"name": "ensemble.launch", "start_wall_s": 11.5,
         "duration_s": 0.01, "pid": 7, "trace_id": "t" * 16,
         "meta": {"tickets": [0], "trace_ids": ["t" * 16],
                  "service_id": "m0g0"}},
        {"name": "ensemble.fetch", "start_wall_s": 11.6,
         "duration_s": 0.02, "pid": 7, "trace_id": "other",
         "meta": {"tickets": [1], "trace_ids": ["t" * 16, "other"]}},
        {"name": "ensemble.launch", "start_wall_s": 11.7,
         "duration_s": 0.01, "pid": 7, "trace_id": "zzz",
         "meta": {"tickets": [1]}},
    ]
    return str(jdir), str(vdir), spans


@pytest.mark.parametrize("ticket", [0, 1, 2, 7])
def test_reconstruct_gives_jax_s_events(tmp_path, ticket):
    jdir, vdir, spans = _timeline_fixture(tmp_path)
    mine = postmortem.reconstruct(ticket, journal_dir=jdir, vault_dir=vdir,
                                  spans=spans)
    theirs = jpostmortem.reconstruct(ticket, journal_dir=jdir,
                                     vault_dir=vdir, spans=spans)
    assert mine.to_dict() == theirs.to_dict()
    assert mine.complete == (ticket in (0, 2))
    if ticket == 1:
        assert [g.kind for g in mine.gaps] == ["uncertainty"]
        assert "m0g0" in mine.gaps[0].detail
    assert obs.timeline(ticket, journal_dir=jdir, vault_dir=vdir,
                        spans=spans).to_dict() == mine.to_dict()


def test_reconstruct_reads_span_files_like_jax(tmp_path):
    jdir, vdir, spans = _timeline_fixture(tmp_path)
    chrome = tmp_path / "spans.json"
    chrome.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "name": s["name"], "ts": s["start_wall_s"] * 1e6,
         "dur": s["duration_s"] * 1e6, "pid": s["pid"], "tid": 1,
         "args": dict(s["meta"], trace_id=s["trace_id"])}
        for s in spans]}))
    stream = tmp_path / "spans.jsonl"
    stream.write_text("".join(json.dumps(s) + "\n" for s in spans)
                      + '{"torn')
    for f in (str(chrome), str(stream)):
        mine = postmortem.reconstruct(0, journal_dir=jdir, spans=f)
        theirs = jpostmortem.reconstruct(0, journal_dir=jdir, spans=f)
        assert mine.to_dict() == theirs.to_dict()
        assert [e.kind for e in mine.events if e.source == "span"] == [
            "ensemble.launch", "ensemble.fetch"]


def test_torn_journal_timeline_says_so_like_jax(tmp_path):
    jdir, vdir, spans = _timeline_fixture(tmp_path)
    path = journal_path(jdir)
    inject.tear_file(path, os.path.getsize(path) - 5, tear="truncate")
    mine = postmortem.reconstruct(1, journal_dir=jdir).to_dict()
    theirs = jpostmortem.reconstruct(1, journal_dir=jdir).to_dict()
    # the unstamped torn-tail event brings the ordering note in both; only
    # the note's wording differs (JAX's names its changelog entry)
    for doc in (mine, theirs):
        for e in doc["events"]:
            if e["kind"] == "ordering-note":
                e["detail"] = "note"
    assert mine == theirs
    assert [e["kind"] for e in mine["events"]][-3:] == [
        "ordering-note", "journal-torn-tail", "uncertainty"]


def test_obs_cli_timeline(tmp_path, capsys):
    jdir, vdir, spans = _timeline_fixture(tmp_path)
    trace = tmp_path / "spans.jsonl"
    trace.write_text("".join(json.dumps(s) + "\n" for s in spans))
    assert obs_main(["timeline", "0", "--journal", jdir, "--vault", vdir,
                     "--trace", str(trace), "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["complete"] and doc == postmortem.reconstruct(
        0, journal_dir=jdir, vault_dir=vdir,
        spans=str(trace)).to_dict()
    assert obs_main(["timeline", "1", "--journal", jdir]) == 1
    out = capsys.readouterr().out
    assert "INCOMPLETE" in out and "uncertainty" in out
    from mpi_model_tpu.obs.__main__ import main as jobs_main

    assert obs_main(["timeline", "0", "--journal", jdir]) == 0
    mine = capsys.readouterr().out
    assert jobs_main(["timeline", "0", "--journal", jdir]) == 0
    assert mine == capsys.readouterr().out


def test_a_served_ticket_journaled_with_its_trace_has_a_complete_timeline(
        tmp_path):
    """A ticket served through the port's service under a submit span,
    journaled with its trace context: its timeline joins the journal and
    the dispatch spans (parented under the submit), gap-free, and JAX's
    reconstruct of the same files and spans gives the same events."""
    tracer = Tracer()
    old = set_tracer(tracer)
    try:
        model = mt.Model(mt.Diffusion(0.1), 4.0, 1.0)
        svc = mt.EnsembleService(model, steps=4)
        space = mt.CellularSpace.create(8, 8, 1.0, dtype="float64",
                                        device="cpu").with_values(
            {"value": torch.from_numpy(GRID64.copy())})
        jdir = str(tmp_path)
        with protocolcheck.armed() as w, \
                TicketJournal(journal_path(jdir)) as j:
            with tracer.span("fleet.submit"):
                ctx = tracer.current()
                t = svc.submit(space)
                meta, arrays = space_payload(space)
                j.append(SUBMIT, dict(meta, ticket=t, steps=4,
                                      model=model_meta(model),
                                      trace=ctx.to_meta()), arrays)
            out, rep = svc.result(t)
            meta, arrays = space_payload(out)
            j.append(SERVED, dict(meta, ticket=t, steps=4,
                                  initial_total=rep.initial_total,
                                  final_total=rep.final_total), arrays)
        w.assert_clean()
        assert w.records == 2
        spans = [s.to_dict() for s in tracer.spans]
    finally:
        set_tracer(old)
    tl = obs.timeline(t, journal_dir=jdir, spans=spans)
    assert tl.complete and tl.gaps == []
    assert tl.trace_id == ctx.trace_id
    kinds = [e.kind for e in tl.events]
    assert kinds[:2] == ["fleet.submit", SUBMIT] and kinds[-1] == SERVED
    assert {"ensemble.launch", "ensemble.fetch"} <= set(kinds)
    assert tl.to_dict() == jpostmortem.reconstruct(
        t, journal_dir=jdir, spans=spans).to_dict()
    st = replay(journal_path(jdir))
    assert torch.equal(space_from_record(st.terminal[t],
                                         device="cpu").values["value"],
                       out.values["value"])
