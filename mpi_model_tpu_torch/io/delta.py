"""Incremental (dirty-tile) checkpointing and the live-migration stream
(counterpart of ``mpi_model_tpu/io/delta.py``; the records, the chain
manifest and the wire pieces are the JAX package's format, so a chain
written by either package replays in the other).

A full snapshot costs the grid: at 16384² f32 a 1 GiB copy, CRC and write
per interval. The active engine knows which tiles a run wrote, so:

- a chain is a sequence of records in the manager's directory: periodic
  full **keyframes** (``{prefix}_{step:010d}.kf.npz``) and per-interval
  **delta records** (``{prefix}_{step:010d}.d.npz``) holding only the
  dirty tiles. Each record is a piece table (``{channel, start, shape,
  key, crc32}`` per piece; a keyframe's pieces cover each channel whole, a
  delta's are the dirty tiles) and the pieces' raw little-endian bytes;
- dirtiness comes from ``SerialExecutor.last_dirty_tiles`` (the union of
  the tiles the active run wrote, a superset of the changed ones) when the
  caller vouches for it, else from ``ops.active.changed_tile_map``, a byte
  compare against the last saved state, made on the state's device;
- ``{prefix}_chain.json`` is the chain manifest and the commit record:
  records are linked by ``base`` step, and a record not in the manifest
  does not exist;
- restore replays: the nearest keyframe at or before the target, then each
  delta in order, every piece's CRC32 and every record's identity and base
  link checked. A torn, CRC-failing or missing record raises
  ``CheckpointCorruptionError``; ``CheckpointManager.latest()`` then falls
  back a step, which truncates the chain at the last record that verifies.
  A missing or unreadable manifest degrades the chain to its self-contained
  keyframes, with a warning.

On the card the writer keeps a device copy of the last saved state (the
diff runs there) and gathers a delta's dirty tiles on the device, so a
delta costs one device-to-host copy of those tiles; a keyframe copies each
channel once. Replay assembles host tensors and moves each channel to the
device once.

The same record format is the **live-migration stream**:
``migrate_scenario`` hands a running scenario between executors (serial ↔
sharded) by snapshotting a keyframe, letting the source keep stepping while
the copy is in flight, then shipping only the tiles that changed since, and
resuming on the target after a bitwise check. ``transfer_space`` is the
one-shot (keyframe-only) form behind ``EnsembleScheduler.migrate_ticket``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
import zipfile
from typing import Optional

import numpy as np
import torch

from ..core.cellular_space import CellularSpace, resolve_device
from ..ops.active import ActivePlan, changed_tile_map, plan_for
from ..resilience import inject
from .checkpoint import (Checkpoint, CheckpointCorruptionError,
                         _atomic_write, _geom_meta, crc32, dtype_name,
                         host_bytes, torch_dtype)

DELTA_FORMAT_VERSION = 1
SUFFIX_KEYFRAME = ".kf.npz"
SUFFIX_DELTA = ".d.npz"


class MigrationError(RuntimeError):
    """A live-migration handoff failed its bitwise check: the state
    materialized on the target does not reproduce the source's byte for
    byte. The source's state is untouched; the caller keeps running there."""


# -- piece encoding ------------------------------------------------------------

def _channels_meta(values: dict) -> dict:
    return {k: {"dtype": dtype_name(v.dtype), "shape": list(v.shape)}
            for k, v in values.items()}


def _piece(channel: str, start, shape, raw: np.ndarray, key: str) -> dict:
    return {"channel": channel, "start": [int(s) for s in start],
            "shape": [int(n) for n in shape], "key": key,
            "crc32": crc32(raw)}


def _full_pieces(values: dict) -> tuple[list, dict]:
    """One piece per channel covering it whole: a keyframe's table (one
    device-to-host copy a channel)."""
    pieces, payload = [], {}
    for name, t in values.items():
        raw = host_bytes(t)
        key = f"d:{len(pieces)}"
        pieces.append(_piece(name, (0,) * t.dim(), t.shape, raw, key))
        payload[key] = raw
    return pieces, payload


def _tile_pieces(values: dict, plan: ActivePlan,
                 dirty: dict) -> tuple[list, dict]:
    """The dirty tiles as pieces: ``dirty`` maps channel → bool ``[gi, gj]``
    host array (a superset of the tiles whose bytes changed). A channel's
    tiles are gathered on its device and copied to the host at once."""
    (th, tw), (gi, gj) = plan.tile, plan.grid
    pieces, payload = [], {}
    for name, t in values.items():
        ti, tj = np.nonzero(np.asarray(dirty[name], bool))
        if not len(ti):
            continue
        tiles = t.detach().reshape(gi, th, gj, tw).permute(0, 2, 1, 3)
        idx_i = torch.from_numpy(ti.astype(np.int64)).to(t.device)
        idx_j = torch.from_numpy(tj.astype(np.int64)).to(t.device)
        host = host_bytes(tiles[idx_i, idx_j]).reshape(len(ti), -1)
        for n, (i, j) in enumerate(zip(ti, tj)):
            raw = host[n]
            key = f"d:{len(pieces)}"
            pieces.append(_piece(name, (int(i) * th, int(j) * tw), (th, tw),
                                 raw, key))
            payload[key] = raw
    return pieces, payload


def _apply_pieces(arrays: dict, meta: dict, get_raw, where: str) -> None:
    """Apply a record's pieces onto ``arrays`` (host tensors) in place,
    checking every piece's CRC32 against the bytes read."""
    for piece in meta["pieces"]:
        ch = piece["channel"]
        dst = arrays.get(ch)
        if dst is None:
            raise CheckpointCorruptionError(
                f"record {where} carries channel {ch!r} the chain's "
                "keyframe does not (channel set changed mid-chain)")
        raw = np.asarray(get_raw(piece["key"])).reshape(-1)
        want = piece.get("crc32")
        if want is not None and crc32(raw) != want:
            raise CheckpointCorruptionError(
                f"piece {piece['key']} (channel {ch!r}) in {where} fails "
                "its CRC32 (bytes changed since the record was written)")
        start, shape = list(piece["start"]), list(piece["shape"])
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if (len(start) != dst.dim() or len(shape) != dst.dim()
                or any(s < 0 or s + k > d
                       for s, k, d in zip(start, shape, dst.shape))
                or raw.nbytes != n * dst.element_size()):
            raise CheckpointCorruptionError(
                f"piece {piece['key']} in {where} does not fit channel "
                f"{ch!r} ({tuple(dst.shape)}, {dst.dtype}): start {start}, "
                f"shape {shape}, {raw.nbytes} bytes")
        if not raw.flags.writeable:
            raw = raw.copy()
        sel = tuple(slice(s, s + k) for s, k in zip(start, shape))
        dst[sel] = torch.from_numpy(raw).view(dst.dtype).reshape(shape)


def _new_arrays(channels: dict) -> dict:
    """Host tensors for a record's channel table."""
    return {name: torch.empty(tuple(ch["shape"]),
                              dtype=torch_dtype(ch["dtype"]))
            for name, ch in channels.items()}


# -- the raw record writer ------------------------------------------------------

def write_chain_record(path: str, meta: dict, payload: dict) -> str:
    """Write one chain record atomically and fire the chaos seam for its
    kind. The raw writer: other code saves through ``CheckpointManager``,
    or the chain manifest stops being a commit record."""
    body = dict(payload)
    body["meta"] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                 dtype=np.uint8)
    _atomic_write(path, lambda f: np.savez(f, **body))
    # chaos seam: an armed "torn" fault damages the just-committed record,
    # part "keyframe" or "delta" (an unpinned fault matches either)
    inject.checkpoint_torn(path, int(meta["step"]), part=meta["kind"])
    return path


class _RecordReader:
    """One chain record file: the meta at once, piece bytes on demand
    (``np.load`` reads a zip member when it is indexed)."""

    def __init__(self, path: str):
        self.path = path
        try:
            self._z = np.load(path)
        except FileNotFoundError:
            # the manifest promised this record: the chain is broken here
            raise CheckpointCorruptionError(
                f"chain record {path} is missing (the chain manifest "
                "references it)")
        except (zipfile.BadZipFile, EOFError, KeyError, OSError,
                ValueError) as e:
            raise CheckpointCorruptionError(
                f"chain record {path} is torn/unreadable: "
                f"{type(e).__name__}: {e}") from e
        try:
            self.meta = json.loads(bytes(self._z["meta"]).decode("utf-8"))
            fmt = self.meta.get("format")
            if fmt != DELTA_FORMAT_VERSION:
                raise CheckpointCorruptionError(
                    f"chain record {path} has unsupported format {fmt!r}")
        except CheckpointCorruptionError:
            self._z.close()
            raise
        except (zipfile.BadZipFile, EOFError, KeyError, OSError,
                ValueError, UnicodeDecodeError) as e:
            self._z.close()
            raise CheckpointCorruptionError(
                f"chain record {path} is torn/unreadable: "
                f"{type(e).__name__}: {e}") from e

    def raw(self, key: str) -> np.ndarray:
        try:
            return self._z[key]
        except (zipfile.BadZipFile, KeyError, OSError, ValueError,
                EOFError) as e:
            # the zip member's own CRC may see the damage before the
            # piece's CRC32 does; both mean corruption
            raise CheckpointCorruptionError(
                f"piece {key} in {self.path} is unreadable: "
                f"{type(e).__name__}: {e}") from e

    def close(self) -> None:
        self._z.close()


# -- the chain ----------------------------------------------------------------

class DeltaChain:
    """One delta-checkpoint chain in a directory (the module docstring has
    the format). The writer's copy of the last saved state is what makes
    the tile diff local; after a restart it is empty, so the first save is
    a keyframe. ``keyframe_every`` bounds a segment to that many records (1
    keyframe + keyframe_every-1 deltas); 1 makes every save a keyframe.
    ``device`` is where restores land (the card by default)."""

    def __init__(self, directory: str, prefix: str = "ckpt",
                 keyframe_every: int = 8,
                 tile: Optional[tuple[int, int]] = None, device=None):
        self.directory = directory
        self.prefix = prefix
        self.keyframe_every = max(1, int(keyframe_every))
        #: delta tile dims (None: ``ops.active.plan_for``'s default)
        self.tile = tile
        self.device = device
        #: device copies of the last saved (or restored) state
        self._last_values: Optional[dict] = None
        self._last_step: Optional[int] = None
        #: (manifest stat signature, steps): see steps()
        self._steps_cache: Optional[tuple] = None

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.directory, f"{self.prefix}_chain.json")

    def record_path(self, step: int, kind: str) -> str:
        suffix = SUFFIX_KEYFRAME if kind == "keyframe" else SUFFIX_DELTA
        return os.path.join(self.directory,
                            f"{self.prefix}_{step:010d}{suffix}")

    def _manifest(self) -> tuple[Optional[list], Optional[str]]:
        """(records, error): records None when the manifest is missing;
        error carries an unreadable manifest's detail (records None too)."""
        try:
            with open(self.manifest_path) as f:
                doc = json.load(f)
            return list(doc["records"]), None
        except FileNotFoundError:
            return None, None
        except (json.JSONDecodeError, UnicodeDecodeError, KeyError,
                TypeError, OSError) as e:
            return None, f"{type(e).__name__}: {e}"

    def _write_manifest(self, records: list) -> None:
        doc = {"format": DELTA_FORMAT_VERSION, "prefix": self.prefix,
               "keyframe_every": self.keyframe_every, "records": records}
        _atomic_write(self.manifest_path,
                      lambda f: f.write(json.dumps(doc, indent=1).encode()))

    # -- save -----------------------------------------------------------------

    def save(self, space: CellularSpace, step: int,
             extra: Optional[dict] = None,
             dirty_tiles: Optional[dict] = None, *,
             timings: Optional[dict] = None) -> str:
        """Append one record for ``step``: a keyframe on the first save, at
        the ``keyframe_every`` cadence, or whenever the writer cannot vouch
        for a delta (restart, manifest damage, a new geometry); a
        dirty-tile delta otherwise, unless it would carry at least the
        grid's bytes. Records at steps >= ``step`` are retracted first (a
        resumed run recomputes them). ``dirty_tiles`` is the active
        engine's export ({"tile", "grid", "map"}), used when its tile grid
        is this chain's; else the byte diff runs. ``timings`` receives the
        copy/CRC/write seconds, the file's bytes, the kind, the dirty tiles
        and where they came from."""
        step = int(step)
        values = {k: v.detach() for k, v in space.values.items()}
        plan = plan_for(next(iter(values.values())).shape, tile=self.tile)
        records, _merr = self._manifest()
        if records is None:
            # adopt the surviving self-contained keyframes, so the next
            # prune's orphan sweep keeps the history the degraded mode kept
            records = [
                {"step": s, "kind": "keyframe",
                 "file": os.path.basename(self.record_path(s, "keyframe")),
                 "base": None}
                for s in self._keyframes_on_disk()]
        keep = [r for r in records if r["step"] < step]
        dropped = [r for r in records if r["step"] >= step]
        tail = keep[-1] if keep else None

        last = self._last_values
        prev_ok = (
            tail is not None
            and self._last_step == tail["step"]
            and last is not None
            and set(last) == set(values)
            and all(last[k].shape == values[k].shape
                    and last[k].dtype == values[k].dtype for k in values))
        since_kf, has_kf = 0, False
        for r in reversed(keep):
            if r["kind"] == "keyframe":
                has_kf = True
                break
            since_kf += 1
        kind = ("delta" if (prev_ok and has_kf
                            and since_kf + 1 < self.keyframe_every)
                else "keyframe")
        for dev in {t.device for t in values.values()}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        dirty = source = None
        if kind == "delta":
            dirty, source = self._dirty_maps(values, plan, dirty_tiles)
            th, tw = plan.tile
            dbytes = sum(int(dirty[k].sum()) * th * tw * v.element_size()
                         for k, v in values.items())
            if dbytes >= sum(v.numel() * v.element_size()
                             for v in values.values()):
                # a delta as dirty as the grid costs more than a keyframe:
                # write the keyframe, which also restarts the segment
                kind = "keyframe"
        if kind == "keyframe":
            pieces, payload = _full_pieces(values)
        else:
            pieces, payload = _tile_pieces(values, plan, dirty)
        copy_s = time.perf_counter() - t0
        meta = {
            "format": DELTA_FORMAT_VERSION,
            "kind": kind,
            "step": step,
            "base": tail["step"] if kind == "delta" else None,
            **_geom_meta(space),
            "channels": _channels_meta(values),
            "extra": extra or {},
            "tile": list(plan.tile),
            "pieces": pieces,
        }
        path = self.record_path(step, kind)
        entry = {"step": step, "kind": kind, "file": os.path.basename(path),
                 "base": meta["base"]}
        os.makedirs(self.directory, exist_ok=True)
        t0 = time.perf_counter()
        write_chain_record(path, meta, payload)
        self._write_manifest(keep + [entry])
        write_s = time.perf_counter() - t0
        # chaos seam: a "torn" fault pinned to part "chain" damages the
        # commit record itself
        inject.checkpoint_torn(self.manifest_path, step, part="chain")
        # retracted records and a stale other-kind file at this step are no
        # longer referenced
        other = self.record_path(
            step, "delta" if kind == "keyframe" else "keyframe")
        for p in [os.path.join(self.directory, r["file"])
                  for r in dropped] + [other]:
            if os.path.exists(p) and os.path.abspath(p) != \
                    os.path.abspath(path):
                os.unlink(p)
        self._last_values = {k: v.clone() for k, v in values.items()}
        self._last_step = step
        if timings is not None:
            timings.update(
                kind=kind, copy_s=copy_s, write_s=write_s,
                bytes=os.path.getsize(path),
                payload_bytes=sum(int(p.nbytes) for p in payload.values()),
                dirty_tiles=(None if dirty is None else
                             int(sum(int(m.sum()) for m in dirty.values()))),
                dirty_from=source)
        return path

    def _dirty_maps(self, values: dict, plan: ActivePlan,
                    dirty_tiles: Optional[dict]) -> tuple[dict, str]:
        """Per-channel dirty maps and their source: the supplied activity
        export when its tile grid is this chain's (one map for every
        channel: a superset of every write the run made, ``"executor"``),
        else the byte diff against the last saved state (``"diff"``)."""
        if (dirty_tiles is not None
                and tuple(dirty_tiles.get("tile", ())) == plan.tile
                and tuple(dirty_tiles.get("grid", ())) == plan.grid):
            dmap = np.asarray(dirty_tiles["map"], bool)
            return {k: dmap for k in values}, "executor"
        last = self._last_values
        return ({k: changed_tile_map(last[k].to(v.device), v, plan)
                 for k, v in values.items()}, "diff")

    # -- restore --------------------------------------------------------------

    def _keyframes_on_disk(self) -> list[int]:
        """Steps of the keyframe files present (the manifest-less view)."""
        out = []
        prefix = self.prefix + "_"
        if not os.path.isdir(self.directory):
            return out
        for fn in os.listdir(self.directory):
            if fn.startswith(prefix) and fn.endswith(SUFFIX_KEYFRAME):
                try:
                    out.append(int(fn[len(prefix):-len(SUFFIX_KEYFRAME)]))
                except ValueError:
                    continue
        return sorted(out)

    def steps(self) -> list[int]:
        """Committed (manifested) steps; with the manifest missing or
        unreadable, the keyframes found on disk. Cached against the
        manifest's stat signature (``latest()`` probes every step)."""
        sig = None
        try:
            st = os.stat(self.manifest_path)
            sig = (st.st_mtime_ns, st.st_size)
        except OSError:
            pass
        if sig is not None and self._steps_cache is not None \
                and self._steps_cache[0] == sig:
            return list(self._steps_cache[1])
        records, _ = self._manifest()
        if records is not None:
            out = sorted(r["step"] for r in records)
            if sig is not None:
                self._steps_cache = (sig, list(out))
            return out
        return self._keyframes_on_disk()

    def has_step(self, step: int) -> bool:
        return int(step) in self.steps()

    def restore(self, step: int, *, device=None) -> Checkpoint:
        """Replay the chain up to ``step`` onto ``device``: the nearest
        keyframe at or before it, then each delta in base-link order, every
        piece CRC-checked. Raises ``CheckpointCorruptionError`` on any
        torn, CRC-failing or missing record of the segment and
        ``FileNotFoundError`` for a step the chain never committed."""
        dev = resolve_device(device if device is not None else self.device)
        step = int(step)
        records, merr = self._manifest()
        if records is None:
            kfp = self.record_path(step, "keyframe")
            if os.path.exists(kfp):
                if merr is not None:
                    warnings.warn(
                        f"chain manifest {self.manifest_path} is "
                        f"unreadable ({merr}); restoring the self-"
                        "contained keyframe without delta replay",
                        RuntimeWarning, stacklevel=3)
                return self._restore_segment(
                    [({"kind": "keyframe", "step": step, "base": None},
                      kfp)], dev)
            if merr is not None:
                raise CheckpointCorruptionError(
                    f"chain manifest {self.manifest_path} is unreadable "
                    f"({merr}) and step {step} is not a keyframe — its "
                    "delta records cannot be validated")
            raise FileNotFoundError(
                f"no delta-chain record for step {step} in "
                f"{self.directory}")
        idx = next((i for i, r in enumerate(records)
                    if r["step"] == step), None)
        if idx is None:
            raise FileNotFoundError(
                f"no delta-chain record for step {step} in "
                f"{self.directory}")
        seg = [records[idx]]
        while seg[0]["kind"] != "keyframe":
            if idx == 0:
                raise CheckpointCorruptionError(
                    f"chain record for step {seg[0]['step']} has no "
                    "keyframe ancestor in the manifest")
            prev = records[idx - 1]
            if seg[0].get("base") != prev["step"]:
                raise CheckpointCorruptionError(
                    f"chain link broken at step {seg[0]['step']}: its "
                    f"base is {seg[0].get('base')} but the previous "
                    f"manifested record is step {prev['step']}")
            idx -= 1
            seg.insert(0, prev)
        return self._restore_segment(
            [(r, os.path.join(self.directory, r["file"])) for r in seg], dev)

    def _restore_segment(self, seg: list, dev: torch.device) -> Checkpoint:
        arrays: Optional[dict] = None
        meta: Optional[dict] = None
        for rec, path in seg:
            kind = rec["kind"]
            rd = _RecordReader(path)
            try:
                meta = rd.meta
                # every record's identity must be its manifest entry's: a
                # swapped record file of the right kind passes every CRC
                if (meta["kind"] != kind
                        or int(meta["step"]) != int(rec["step"])
                        or meta.get("base") != rec.get("base")):
                    raise CheckpointCorruptionError(
                        f"chain record {path} does not match its "
                        f"manifest entry (kind/step/base drift: file "
                        f"says {meta['kind']}@{meta['step']} base "
                        f"{meta.get('base')}, manifest says "
                        f"{kind}@{rec['step']} base {rec.get('base')})")
                if kind == "keyframe":
                    try:
                        arrays = _new_arrays(meta["channels"])
                    except ValueError as e:
                        raise CheckpointCorruptionError(
                            f"keyframe {path}: {e}") from e
                    covered = {k: False for k in arrays}
                    for piece in meta["pieces"]:
                        if list(piece["shape"]) != list(
                                meta["channels"][piece["channel"]]
                                ["shape"]):
                            raise CheckpointCorruptionError(
                                f"keyframe {path}: piece for channel "
                                f"{piece['channel']!r} does not cover "
                                "it whole")
                        covered[piece["channel"]] = True
                    if not all(covered.values()):
                        raise CheckpointCorruptionError(
                            f"keyframe {path} is missing channel pieces: "
                            f"{[k for k, v in covered.items() if not v]}")
                _apply_pieces(arrays, meta, rd.raw, path)
            finally:
                rd.close()
        values = {k: v.to(dev) for k, v in arrays.items()}
        space = CellularSpace(
            values, meta["dim_x"], meta["dim_y"], meta["x_init"],
            meta["y_init"], meta["global_dim_x"], meta["global_dim_y"])
        # seed the writer: a save right after this restore may continue the
        # chain with a delta (save() retracts records past this step first)
        self._last_values = {k: v.clone() for k, v in values.items()}
        self._last_step = int(meta["step"])
        return Checkpoint(space=space, step=int(meta["step"]),
                          extra=meta.get("extra", {}))

    # -- retention ------------------------------------------------------------

    def prune(self, keep: int) -> None:
        """Keep the newest ``keep`` records without breaking a live segment:
        the cut lands on a keyframe, so a keyframe that retained deltas
        replay from is never deleted (retention errs toward keeping more)."""
        records, merr = self._manifest()
        if records is None or merr is not None or keep <= 0:
            return
        cut = max(0, len(records) - int(keep))
        while cut > 0 and records[cut]["kind"] != "keyframe":
            cut -= 1
        live = records[cut:]
        if cut > 0:
            self._write_manifest(live)
            for r in records[:cut]:
                p = os.path.join(self.directory, r["file"])
                if os.path.exists(p):
                    os.unlink(p)
        # record files the manifest does not reference are leftovers
        referenced = {r["file"] for r in live}
        prefix = self.prefix + "_"
        for fn in os.listdir(self.directory):
            if (fn.startswith(prefix)
                    and (fn.endswith(SUFFIX_KEYFRAME)
                         or fn.endswith(SUFFIX_DELTA))
                    and fn not in referenced):
                os.unlink(os.path.join(self.directory, fn))


# -- live migration ---------------------------------------------------------------

def _materialize(channels: dict, tables: list, dev) -> dict:
    """Host tensors built from ``(pieces, payload, where)`` tables in order,
    every piece CRC-checked, then moved to ``dev``."""
    arrays = _new_arrays(channels)
    for pieces, payload, where in tables:
        _apply_pieces(arrays, {"channels": channels, "pieces": pieces},
                      lambda key, p=payload: p[key], where)
    return {k: v.to(dev) for k, v in arrays.items()}


def transfer_space(space: CellularSpace, device=None) -> CellularSpace:
    """One-shot (keyframe-only) handoff of a scenario's state through the
    stream's wire format, every piece CRC-checked, onto ``device`` (the
    space's own by default): what ``EnsembleScheduler.migrate_ticket``
    drains a queued scenario through."""
    dev = space.device if device is None else torch.device(device)
    values = {k: v.detach() for k, v in space.values.items()}
    pieces, payload = _full_pieces(values)
    out = _materialize(_channels_meta(values),
                       [(pieces, payload, "migration keyframe")], dev)
    return dataclasses.replace(space, values=out)


@dataclasses.dataclass
class MigrationResult:
    """What a live handoff produced: the final state (after the remaining
    steps ran on the target), provenance, and the stream's accounting: the
    cutover payload is ``delta_bytes``, not ``keyframe_bytes``."""

    space: CellularSpace
    step: int
    handoff_step: int
    keyframe_bytes: int
    delta_bytes: int
    dirty_tiles: int
    ntiles: int
    report: Optional[object] = None


def _bytes_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.to(a.device).contiguous().view(torch.uint8))


def migrate_scenario(model, space: CellularSpace, *, source=None,
                     target=None, steps: Optional[int] = None,
                     handoff_at: Optional[int] = None,
                     transfer_steps: int = 0,
                     tile: Optional[tuple[int, int]] = None,
                     verify: bool = True, device=None) -> MigrationResult:
    """Move a live scenario from the ``source`` executor to ``target``
    mid-run through the delta stream (serial ↔ sharded, any pair that steps
    bit for bit alike).

    Run ``handoff_at`` steps on the source; snapshot the keyframe (the bulk
    copy; while it is in flight the source runs ``transfer_steps`` more);
    at cutover ship only the tiles that changed since the keyframe;
    materialize keyframe + delta on the target's side, every piece
    CRC-checked, onto ``device`` (the live state's device by default) and,
    with ``verify``, check it equals the source's state byte for byte
    before resuming (``MigrationError`` otherwise: the source's state is
    untouched); then run the remaining steps on the target. The result's
    ``space`` equals an uninterrupted run of ``steps`` bit for bit."""
    steps = model.num_steps if steps is None else int(steps)
    if handoff_at is None:
        handoff_at = steps // 2
    handoff_at = int(handoff_at)
    transfer_steps = int(transfer_steps)
    if not 0 <= handoff_at <= steps:
        raise ValueError(
            f"handoff_at={handoff_at} outside [0, steps={steps}]")
    if transfer_steps < 0 or handoff_at + transfer_steps > steps:
        raise ValueError(
            f"transfer_steps={transfer_steps} overruns the run: "
            f"handoff_at + transfer_steps must be <= steps={steps}")

    live = space
    if handoff_at > 0:
        live, _ = model.execute(live, source, steps=handoff_at,
                                check_conservation=False)
    # the bulk copy: the keyframe at the handoff point (the device copy
    # stays with the source for the cutover diff)
    kf_values = {k: v.detach().clone() for k, v in live.values.items()}
    kf_pieces, kf_payload = _full_pieces(kf_values)
    keyframe_bytes = sum(int(p.nbytes) for p in kf_payload.values())

    cutover_step = handoff_at + transfer_steps
    if transfer_steps > 0:
        live, _ = model.execute(live, source, steps=transfer_steps,
                                check_conservation=False)
    cur_values = {k: v.detach() for k, v in live.values.items()}

    # cutover: only the tiles that changed while the copy was in flight
    plan = plan_for(next(iter(cur_values.values())).shape, tile=tile)
    dirty = {k: changed_tile_map(kf_values[k], cur_values[k], plan)
             for k in cur_values}
    d_pieces, d_payload = _tile_pieces(cur_values, plan, dirty)
    delta_bytes = sum(int(p.nbytes) for p in d_payload.values())
    ndirty = int(sum(int(m.sum()) for m in dirty.values()))
    del kf_values

    dev = live.device if device is None else torch.device(device)
    arrays = _materialize(
        _channels_meta(cur_values),
        [(kf_pieces, kf_payload, "migration keyframe"),
         (d_pieces, d_payload, "migration delta")], dev)
    if verify:
        for k, src in cur_values.items():
            if not _bytes_equal(src, arrays[k]):
                raise MigrationError(
                    f"migrated state for channel {k!r} is not bitwise "
                    "equal to the source at cutover — handoff aborted, "
                    "the scenario stays on the source")
    tspace = dataclasses.replace(live, values=arrays)

    remaining = steps - cutover_step
    report = None
    out = tspace
    if remaining > 0:
        out, report = model.execute(tspace, target, steps=remaining,
                                    check_conservation=False)
    return MigrationResult(
        space=out, step=steps, handoff_step=cutover_step,
        keyframe_bytes=keyframe_bytes, delta_bytes=delta_bytes,
        dirty_tiles=ndirty, ntiles=plan.ntiles * len(cur_values),
        report=report)
