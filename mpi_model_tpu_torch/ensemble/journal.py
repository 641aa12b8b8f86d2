"""The append-only CRC'd ticket journal, TJ1 (counterpart of
``mpi_model_tpu/ensemble/journal.py``; its files are byte for byte the JAX
package's for the same records, and each package replays the other's).

A fleet writes one record at each seam a ticket crosses (the kinds and
their meta keys are declared in ``ensemble.lifecycle``): ``submit`` (the
ticket admitted, with its steps, model recipe and channel state),
``served`` (the harvested state and totals), ``quarantined``/``expired``
(the failure's kind and detail), ``shed`` (an admission refused; no
ticket), ``readmit``/``migrate``/``wake`` (attribution), ``epoch`` (a
supervisor declaring the stream its own).

Record: ``b"TJ1 <len:08x> <crc:08x>\\n" + payload + b"\\n"`` with the CRC32
over the payload, and the payload the wire's (``ensemble.wire``: JSON
metadata, then ``b"\\x00"`` and the arrays' bytes, each array with its own
CRC32). The reader verifies records in order and stops at the first that
fails: a torn tail costs exactly the unverifiable suffix. Opening a journal
for append first truncates it back to its verified prefix.

The epoch fence: a handle opened with ``epoch=`` re-reads the sidecar
``<journal>.epoch`` before each append and raises :class:`StaleEpochError`,
writing nothing, once a later supervisor declared a higher epoch
(:func:`declare_epoch`); its records carry the epoch.

Chaos seams (``resilience.inject``): ``journal_torn`` tears the file right
after the record it names (the byte offset relative to the record's start),
and ``stale_epoch_append`` makes one append behave as a one-epoch-older
handle's. ``resilience.protocolcheck`` observes every durable append.

``replay`` folds the verified records into per-ticket outcomes
(:class:`JournalState`); ``python -m mpi_model_tpu_torch.ensemble.journal
DIR`` prints the verified stream and the exactly-once audit.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
import zlib
from typing import Optional


from ..core.cellular_space import CellularSpace, resolve_device
from ..models.model import Model
from ..resilience import inject, protocolcheck
from .lifecycle import EPOCH, FLEET, SHED, SUBMIT, TERMINAL_KINDS
from .wire import encode_payload, parse_payload

__all__ = [
    "audit_journal",
    "current_epoch",
    "declare_epoch",
    "fold_records",
    "main",
    "StaleEpochError",
    "TicketJournal",
    "JournalRecord",
    "JournalState",
    "read_records",
    "replay",
    "journal_path",
    "space_payload",
    "space_from_record",
    "model_meta",
    "model_from_meta",
    "TERMINAL_KINDS",
]

_HEADER_RE = re.compile(rb"^TJ1 ([0-9a-f]{8}) ([0-9a-f]{8})\n$")
_HEADER_LEN = 22  # b"TJ1 " + 8 hex + b" " + 8 hex + b"\n"

#: the journal file's name inside a journal directory: the fleet machine's,
#: which is how the protocol witness maps an append stream to its machine
JOURNAL_NAME = FLEET.journal_name


def journal_path(journal_dir: str) -> str:
    return os.path.join(journal_dir, JOURNAL_NAME)


@dataclasses.dataclass
class JournalRecord:
    """One verified record: its 0-based ``index`` in the file, the
    ``kind``, the JSON ``meta`` and the CRC-verified ``arrays``, if the
    record carried state."""

    index: int
    kind: str
    meta: dict
    arrays: Optional[dict] = None

    @property
    def ticket(self) -> Optional[int]:
        return self.meta.get("ticket")


class StaleEpochError(ValueError):
    """An append was fenced: the handle's epoch is older than the fence
    file's. The append wrote nothing; the writer must stop."""


#: sidecar fence-file suffix: ``<journal>.epoch`` holds the current epoch
#: as ASCII digits, replaced atomically before the matching ``epoch`` record
_EPOCH_SUFFIX = ".epoch"


def current_epoch(path: str) -> int:
    """The fence: the highest epoch ever declared over this journal (0 when
    none was)."""
    try:
        with open(path + _EPOCH_SUFFIX, "rb") as fh:
            return int(fh.read().strip() or b"0")
    except (FileNotFoundError, ValueError):
        return 0


def _write_fence(path: str, epoch: int) -> None:
    tmp = path + _EPOCH_SUFFIX + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(b"%d\n" % epoch)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path + _EPOCH_SUFFIX)


class TicketJournal:
    """Append handle over one journal file. Not locked: its writer
    serializes appends under its own lock.

    ``epoch`` opts into the fence: every append first checks the sidecar
    and raises :class:`StaleEpochError`, writing nothing, once a later
    supervisor declared a higher epoch; every record carries the handle's
    epoch. ``epoch=None`` (the default): no check, no stamp."""

    def __init__(self, path: str, epoch: Optional[int] = None):
        self.path = path
        self.epoch = epoch
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._count = 0
        if os.path.exists(path) and os.path.getsize(path) > 0:
            # truncate a torn tail back to the verified prefix, so every
            # append extends good data
            records, _, verified_len = _scan(path)
            self._count = len(records)
            if verified_len < os.path.getsize(path):
                with open(path, "r+b") as fh:
                    fh.truncate(verified_len)
        self._fh = open(path, "ab")

    @property
    def count(self) -> int:
        """Records so far (the verified prefix and this handle's)."""
        return self._count

    def append(self, kind: str, meta: Optional[dict] = None,
               arrays: Optional[dict] = None) -> int:
        """Write one CRC'd record and flush; returns its index. Every
        record is stamped with ``t_wall`` (epoch seconds; a ``t_wall`` the
        caller put in ``meta`` is kept), the anchor ``obs.timeline`` merges
        journals and spans by. The protocol witness observes the append,
        then the ``journal_torn`` seam fires with the record's byte offset,
        so a torn tail lands where a crash mid-record would."""
        if self.epoch is not None:
            effective = self.epoch
            if inject.stale_epoch_append(self.path):
                effective -= 1
            fence = current_epoch(self.path)
            if effective < fence:
                raise StaleEpochError(
                    f"append fenced: handle epoch {effective} < "
                    f"journal fence {fence} (a newer supervisor owns "
                    f"{self.path})")
        body = dict(meta or {})
        if self.epoch is not None:
            body.setdefault("epoch", self.epoch)
        body["kind"] = kind
        body.setdefault("t_wall", time.time())
        payload = encode_payload(body, arrays)
        header = b"TJ1 %08x %08x\n" % (
            len(payload), zlib.crc32(payload) & 0xFFFFFFFF)
        start = self._fh.tell()
        self._fh.write(header + payload + b"\n")
        self._fh.flush()
        idx = self._count
        self._count += 1
        protocolcheck.journal_append(self.path, kind, body)
        inject.journal_torn(self.path, idx, start)
        return idx

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()

    def __enter__(self) -> "TicketJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def declare_epoch(journal: TicketJournal, *, supervisor: str,
                  takeover_from: Optional[str] = None,
                  lease_s: Optional[float] = None) -> int:
    """Bump the fence, then append the matching ``epoch`` record (first
    start or takeover): from the moment the fence moves, appends of older
    handles raise :class:`StaleEpochError`. Returns the new epoch and sets
    ``journal`` to it."""
    new = current_epoch(journal.path) + 1
    _write_fence(journal.path, new)
    journal.epoch = new
    journal.append(EPOCH, {
        "epoch": new,
        "supervisor": supervisor,
        "takeover_from": takeover_from,
        "lease_s": lease_s,
    })
    return new


def _parse_record(index: int, payload: bytes) -> JournalRecord:
    # WireError is a ValueError: _scan treats a malformed payload as torn
    meta, arrays = parse_payload(payload)
    return JournalRecord(index, meta["kind"], meta, arrays)


def _scan(path: str) -> tuple[list[JournalRecord], bool, int]:
    """(verified records, torn?, verified byte length): records in order,
    stopping at the first header, CRC or decode failure."""
    with open(path, "rb") as fh:
        data = fh.read()
    records: list[JournalRecord] = []
    pos = 0
    while pos < len(data):
        header = data[pos:pos + _HEADER_LEN]
        m = _HEADER_RE.match(header)
        if m is None:
            return records, True, pos
        n = int(m.group(1), 16)
        want = int(m.group(2), 16)
        payload = data[pos + _HEADER_LEN:pos + _HEADER_LEN + n]
        end = pos + _HEADER_LEN + n + 1
        if (len(payload) != n or end > len(data)
                or data[end - 1:end] != b"\n"
                or (zlib.crc32(payload) & 0xFFFFFFFF) != want):
            return records, True, pos
        try:
            records.append(_parse_record(len(records), payload))
        except (ValueError, KeyError):
            return records, True, pos
        pos = end
    return records, False, pos


def read_records(path: str) -> tuple[list[JournalRecord], bool]:
    """Every CRC-verified record in order, and whether the file had a torn
    or corrupt tail."""
    if not os.path.exists(path):
        return [], False
    records, torn, _ = _scan(path)
    return records, torn


@dataclasses.dataclass
class JournalState:
    """The journal folded to per-ticket outcomes."""

    #: ticket → its submit record
    submits: dict
    #: ticket → its first terminal record
    terminal: dict
    #: tickets with more than one terminal record (must stay empty)
    duplicate_terminals: list
    #: fleet-level admission refusals recorded
    shed: int
    #: the file had a torn tail (the suffix was discarded)
    torn: bool
    #: the meta of every ``epoch`` record, in stream order
    epochs: list = dataclasses.field(default_factory=list)
    #: indices of records stamped with an epoch older than the highest
    #: declared before them (a write the fence should have refused)
    stale_epoch_records: list = dataclasses.field(default_factory=list)

    def unresolved(self) -> list[int]:
        """Tickets submitted and never resolved, in submit order."""
        return [t for t in self.submits if t not in self.terminal]

    def max_ticket(self) -> int:
        return max(self.submits, default=-1)


def replay(path: str) -> JournalState:
    records, torn = read_records(path)
    return fold_records(records, torn)


def fold_records(records: list, torn: bool) -> JournalState:
    """Fold verified records to per-ticket outcomes; what resolves a
    ticket is what ``lifecycle.FLEET`` declares terminal."""
    submits: dict = {}
    terminal: dict = {}
    dup: list = []
    shed = 0
    epochs: list = []
    stale: list = []
    declared = 0
    for rec in records:
        stamped = rec.meta.get("epoch")
        if stamped is not None and stamped < declared:
            stale.append(rec.index)
        if rec.kind == EPOCH:
            epochs.append(rec.meta)
            declared = max(declared, rec.meta["epoch"])
        elif rec.kind == SUBMIT:
            submits[rec.ticket] = rec
        elif FLEET.is_terminal(rec.kind):
            if rec.ticket in terminal:
                dup.append(rec.ticket)
            else:
                terminal[rec.ticket] = rec
        elif rec.kind == SHED:
            shed += 1
    return JournalState(submits=submits, terminal=terminal,
                        duplicate_terminals=dup, shed=shed, torn=torn,
                        epochs=epochs, stale_epoch_records=stale)


# -- scenario (space/model) serialization -------------------------------------

def space_payload(space: CellularSpace) -> tuple[dict, dict]:
    """(meta, arrays) of a full-grid scenario space: what a submit or served
    record carries. The arrays are the channel tensors, copied to the host
    by the codec."""
    return {"dim_x": space.dim_x, "dim_y": space.dim_y}, dict(space.values)


def space_from_record(rec: JournalRecord, device=None) -> CellularSpace:
    """The record's CRC-verified channel state as a space on ``device`` (the
    card unless the caller names another)."""
    if rec.arrays is None:
        raise ValueError(
            f"record {rec.index} ({rec.kind}) carries no state arrays")
    dev = resolve_device(device)
    vals = {k: a.to(dev) for k, a in rec.arrays.items()}
    return CellularSpace(vals, rec.meta["dim_x"], rec.meta["dim_y"])


_SCALAR = (int, float, str, bool, type(None))


def model_meta(model) -> Optional[dict]:
    """JSON recipe of a model whose flows are dataclasses of scalar (or
    int-tuple) fields; None when a flow carries something richer (a
    ``Cell`` source)."""
    flows = []
    for f in model.flows:
        if not dataclasses.is_dataclass(f):
            return None
        params = {}
        for fld in dataclasses.fields(f):
            v = getattr(f, fld.name)
            if isinstance(v, tuple) and all(
                    isinstance(e, (int, float)) for e in v):
                params[fld.name] = {"__tuple__": list(v)}
            elif isinstance(v, _SCALAR):
                params[fld.name] = v
            else:
                return None
        flows.append({"type": type(f).__name__, "params": params})
    return {"flows": flows, "time": model.time,
            "time_step": model.time_step,
            "offsets": [list(o) for o in model.offsets]}


def model_from_meta(meta: Optional[dict], template=None):
    """The model a submit record described over the port's flows;
    ``template`` when the record carried none."""
    if meta is None:
        return template
    from ..ops import flow as flow_mod

    flows = []
    for fm in meta["flows"]:
        cls = getattr(flow_mod, fm["type"], None)
        if not (isinstance(cls, type) and issubclass(cls, flow_mod.Flow)):
            raise ValueError(
                f"journal names unknown flow type {fm['type']!r}")
        params = {
            k: tuple(v["__tuple__"])
            if isinstance(v, dict) and "__tuple__" in v else v
            for k, v in fm["params"].items()}
        flows.append(cls(**params))
    return Model(flows, meta["time"], meta["time_step"],
                 offsets=[tuple(o) for o in meta["offsets"]])


# -- inspection CLI -----------------------------------------------------------

def audit_journal(path: str, _records: Optional[list] = None,
                  _torn: Optional[bool] = None) -> dict:
    """The exactly-once audit: verified record counts per kind, the torn
    flag, unresolved and duplicate-terminal tickets, the epochs. ``ok`` is
    the verdict: no ticket resolved twice and no stale-epoch record
    (unresolved tickets are what a recovery re-admits, not a failure). A
    caller that already scanned the file passes ``_records``/``_torn``."""
    if _records is None:
        records, torn = read_records(path)
    else:
        records, torn = _records, bool(_torn)
    state = fold_records(records, torn)
    kinds: dict = {}
    for rec in records:
        kinds[rec.kind] = kinds.get(rec.kind, 0) + 1
    return {
        "path": path,
        "records": len(records),
        "kinds": kinds,
        "torn": torn,
        "submits": len(state.submits),
        "terminal": len(state.terminal),
        "shed": state.shed,
        "unresolved": state.unresolved(),
        "duplicate_terminals": list(state.duplicate_terminals),
        "epochs": [
            {"epoch": m["epoch"], "supervisor": m.get("supervisor"),
             "takeover_from": m.get("takeover_from"),
             "lease_s": m.get("lease_s"), "t_wall": m.get("t_wall")}
            for m in state.epochs],
        "stale_epoch_records": list(state.stale_epoch_records),
        "ok": (not state.duplicate_terminals
               and not state.stale_epoch_records),
    }


def main(argv: Optional[list] = None) -> int:
    """``python -m mpi_model_tpu_torch.ensemble.journal <dir-or-file>``:
    print the verified record stream and the exactly-once audit
    (``--json``: the audit as one line). Exit 1 on duplicate terminals or
    stale-epoch records, 2 when there is no journal, else 0 (a torn tail
    or unresolved tickets are reported, not fatal)."""
    import argparse
    import sys

    p = argparse.ArgumentParser(
        prog="python -m mpi_model_tpu_torch.ensemble.journal",
        description="Inspect a fleet ticket journal: verified record "
                    "stream + the replay() exactly-once audit.")
    p.add_argument("journal", help="journal directory (containing "
                   f"{JOURNAL_NAME}) or the journal file itself")
    p.add_argument("--json", action="store_true",
                   help="emit the audit as one JSON line (no record "
                        "listing)")
    args = p.parse_args(argv)
    path = args.journal
    if os.path.isdir(path):
        path = journal_path(path)
    if not os.path.exists(path):
        print(f"no journal at {path}", file=sys.stderr)
        return 2
    records, torn = read_records(path)
    audit = audit_journal(path, _records=records, _torn=torn)
    if args.json:
        print(json.dumps(audit, sort_keys=True))
    else:
        for rec in records:
            nbytes = sum(spec["nbytes"] for spec in
                         rec.meta.get("arrays", {}).values())
            t = "" if rec.ticket is None else f" ticket={rec.ticket}"
            extra = "" if nbytes == 0 else f" state={nbytes}B"
            sid = rec.meta.get("service_id")
            extra += "" if sid is None else f" member={sid}"
            print(f"[{rec.index:4d}] {rec.kind:<12}{t}{extra}")
        print(f"-- {audit['records']} verified records "
              f"({', '.join(f'{k}={v}' for k, v in sorted(audit['kinds'].items()))})"
              + ("; TORN TAIL discarded" if audit["torn"] else ""))
        for e in audit["epochs"]:
            src = ("first start" if e["takeover_from"] is None
                   else f"took over from {e['takeover_from']}")
            print(f"-- epoch {e['epoch']}: supervisor="
                  f"{e['supervisor']} ({src}, lease_s={e['lease_s']})")
        if audit["stale_epoch_records"]:
            print(f"-- STALE-EPOCH APPENDS (zombie writes past the "
                  f"fence): records {audit['stale_epoch_records']}")
        print(f"-- audit: submits={audit['submits']} "
              f"terminal={audit['terminal']} shed={audit['shed']} "
              f"unresolved={audit['unresolved']} "
              f"duplicate_terminals={audit['duplicate_terminals']}")
        print("-- exactly-once: " + (
            "OK" if audit["ok"] else
            "FAILED (duplicate terminals or stale-epoch appends)"))
    return 0 if audit["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
