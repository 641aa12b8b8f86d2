"""The per-shard checkpoint layout (counterpart of
``mpi_model_tpu/io/sharded.py``; the files are the JAX package's format, so
either package restores the other's directory bit for bit).

The reference writes per-rank files and merges them afterwards
(the reference's ``src/Model.hpp:246-260``). Here a checkpoint is a
directory:

- ``shards_p{proc:05d}.npz``, one per process: each piece's raw
  little-endian bytes under ``d:{i}`` and a JSON ``meta`` piece table
  (``channel``, ``start``, ``shape``, ``key``, ``crc32``);
- ``manifest.json`` (format 1), written last and atomically: its presence
  marks the checkpoint complete, so a crash mid-save never leaves a
  readable but partial checkpoint.

The port's ``CellularSpace`` holds global tensors, so a piece is cut from
them: given the run's mesh (``parallel.mesh.Mesh``) the pieces are the mesh
positions' blocks (``shard_bounds``), one per distinct block (a ``spec``
that replicates an axis writes each block once, as the JAX package's
``replica_id`` dedup does); without a mesh each channel is one piece, as
the JAX package writes an unsharded array. Each process writes its own
``shards_p{rank:05d}.npz`` with the pieces of its own mesh positions (in a
one-process run, ``shards_p00000.npz`` with every piece; without a mesh the
master writes the whole channels and the others empty files); the
manifest's ``process_count`` is the world's size, and the master commits
after the world's vote (``all_agree``) and barrier
(``parallel.multihost``).

Restore is assembly: without a mesh, whole channels on ``device`` (the card
by default); with a mesh (and an optional ``spec``), each position reads
only the pieces overlapping its block, onto its own device, and the blocks
are assembled into the same global tensor on ``device`` (the mesh's first
device by default). Across processes each process reads the blocks of its
own positions and receives the others' from their owners (one broadcast a
block), so every process restores the whole state. A ``spec`` is one
tuple of the mesh's axis names (``None`` for a dimension that is not cut),
or a mapping from channel to such a tuple: the port's ``PartitionSpec``.
Every piece read is checked against its CRC32.

A save is staged (the pieces copied to the host and checksummed, the stale
manifest retracted), written (``StagedShardSave.write``, any thread) and
committed (the manifest): ``CheckpointManager(layout="sharded",
async_writes=True)`` runs the write on a thread of its own, so it overlaps
the next chunk of compute.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import zipfile
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..core.cellular_space import CellularSpace, resolve_device
from ..resilience import inject
from .checkpoint import (Checkpoint, CheckpointCorruptionError, _atomic_write,
                         crc32, dtype_name, from_bytes, torch_dtype)

SHARDED_FORMAT_VERSION = 1
MANIFEST = "manifest.json"

#: one tuple of mesh axis names (or None per dimension), or per channel one
Spec = Union[None, Sequence[Optional[str]], Mapping[str, Sequence]]


def _shard_file(proc: int) -> str:
    return f"shards_p{proc:05d}.npz"


def _channel_spec(spec: Spec, name: str, mesh, ndim: int) -> tuple:
    """The spec of channel ``name``: the mapping's entry, the one tuple, or
    by default the mesh's axis names over the leading dimensions."""
    if isinstance(spec, Mapping):
        s = tuple(spec[name])
    elif spec is not None:
        s = tuple(spec)
    else:
        s = tuple(mesh.axis_names[:ndim])
    if len(s) > ndim:
        raise ValueError(f"spec {s} for channel {name!r} has more entries "
                         f"than its {ndim} dimensions")
    for a in s:
        if a is not None and a not in mesh.axis_names:
            raise ValueError(f"spec {s} names axis {a!r}, which mesh axes "
                             f"{mesh.axis_names} do not have")
    return s + (None,) * (ndim - len(s))


def _regions(shape: tuple, mesh, spec: tuple) -> list:
    """``[((i, j), device, start, sub_shape)]``: each distinct block the
    mesh positions hold of a ``shape`` array under ``spec``, once, at the
    first position (row-major) that holds it. Raises the JAX package's
    error for a dimension that an axis extent does not divide."""
    lines, columns = mesh.grid_shape
    extent = dict(zip(mesh.axis_names, (lines, columns)))
    for d, a in enumerate(spec):
        if a is not None and shape[d] % extent[a] != 0:
            raise ValueError(
                f"grid dim {shape[d]} along '{a}' not divisible by mesh "
                f"extent {extent[a]} (the reference's PROC_DIMX=DIMX/"
                "NWORKERS divisibility requirement, Defines.hpp:8)")
    seen, out = set(), []
    for i in range(lines):
        for j in range(columns):
            coord = dict(zip(mesh.axis_names, (i, j)))
            start, sub = [], []
            for d, a in enumerate(spec):
                if a is None:
                    start.append(0)
                    sub.append(shape[d])
                else:
                    n = shape[d] // extent[a]
                    start.append(coord[a] * n)
                    sub.append(n)
            key = tuple(start)
            if key in seen:
                continue
            seen.add(key)
            out.append(((i, j), mesh.device(i, j), tuple(start),
                        tuple(sub)))
    return out


def _host_piece(t: torch.Tensor, start: tuple, sub: tuple) -> np.ndarray:
    """The block of ``t`` at ``start`` as an owned contiguous host copy's
    flat bytes (a copy even for a CPU tensor, so a later in-place update of
    the state cannot reach the staged bytes)."""
    block = t.detach()[tuple(slice(s, s + n) for s, n in zip(start, sub))]
    host = block.to("cpu", copy=True).contiguous()
    return host.reshape(-1).view(torch.uint8).numpy()


@dataclasses.dataclass
class StagedShardSave:
    """A shard save whose device-to-host copies are done and whose file is
    not yet written: ``write()`` (any thread) makes this process's shard
    file durable, then ``commit_checkpoint_sharded`` publishes the
    manifest. ``timings`` holds ``stage_s`` (the copies and CRCs), ``bytes``
    (the pieces' bytes) and, once written, ``write_s``."""

    path: str
    manifest: dict
    _payload: dict
    _proc: int
    timings: dict = dataclasses.field(default_factory=dict)

    def write(self) -> None:
        t0 = time.perf_counter()
        target = os.path.join(self.path, _shard_file(self._proc))
        _atomic_write(target, lambda f: np.savez(f, **self._payload))
        self.timings["write_s"] = time.perf_counter() - t0
        # chaos seam (resilience.inject): an armed "torn" fault damages
        # this shard file; the per-piece CRC32s and latest()'s fallback
        # are what it exercises
        inject.checkpoint_torn(target, int(self.manifest["step"]))


def stage_checkpoint_sharded(path: str, space: CellularSpace, step: int = 0,
                             extra: Optional[dict] = None, *, mesh=None,
                             spec: Spec = None) -> StagedShardSave:
    """Phase 1 of a sharded save: retract any stale manifest (and clear
    shard files the new save will not list), then copy the pieces to host
    memory with their CRC32s. No file of grid data is written yet."""
    from ..parallel.multihost import master_only, process_count, \
        process_index

    t0 = time.perf_counter()
    proc = process_index()
    nprocs = process_count()
    os.makedirs(path, exist_ok=True)
    # re-saving into an existing checkpoint: the commit record goes first,
    # so a crash mid-rewrite never leaves a manifest over mixed shards
    new_files = {_shard_file(p) for p in range(nprocs)}
    with master_only("sharded-ckpt-retract") as master:
        if master:
            if os.path.exists(os.path.join(path, MANIFEST)):
                os.unlink(os.path.join(path, MANIFEST))
            for fn in os.listdir(path):
                if (fn.startswith("shards_p") and fn.endswith(".npz")
                        and fn not in new_files):
                    os.unlink(os.path.join(path, fn))

    devs = {t.device for t in space.values.values()}
    for dev in devs:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    pieces: list[dict] = []
    payload: dict[str, np.ndarray] = {}
    channels: dict[str, dict] = {}
    nbytes = 0
    for name, t in space.values.items():
        shape = tuple(t.shape)
        channels[name] = {"dtype": dtype_name(t.dtype), "shape": list(shape)}
        # this process's pieces: its own positions' blocks, or without a
        # mesh the whole channel on the master
        if mesh is None:
            regions = [((0,) * len(shape), shape)] if proc == 0 else []
        else:
            regions = [(start, sub) for pos, _, start, sub in _regions(
                shape, mesh, _channel_spec(spec, name, mesh, len(shape)))
                if mesh.owner(*pos) == proc]
        for start, sub in regions:
            raw = _host_piece(t, start, sub)
            key = f"d:{len(pieces)}"
            pieces.append({"channel": name, "start": list(start),
                           "shape": list(sub), "key": key,
                           "crc32": crc32(raw)})
            payload[key] = raw
            nbytes += raw.nbytes
    payload["meta"] = np.frombuffer(
        json.dumps({"pieces": pieces}).encode("utf-8"), dtype=np.uint8)
    manifest = {
        "format": SHARDED_FORMAT_VERSION,
        "layout": "sharded",
        "step": int(step),
        "dim_x": space.dim_x,
        "dim_y": space.dim_y,
        "x_init": space.x_init,
        "y_init": space.y_init,
        "global_dim_x": space.global_dim_x,
        "global_dim_y": space.global_dim_y,
        "channels": channels,
        "extra": extra or {},
        "process_count": nprocs,
        "files": [_shard_file(p) for p in range(nprocs)],
    }
    return StagedShardSave(path=path, manifest=manifest, _payload=payload,
                           _proc=proc,
                           timings={"stage_s": time.perf_counter() - t0,
                                    "bytes": nbytes})


def commit_checkpoint_sharded(staged: StagedShardSave) -> str:
    """Phase 2, after ``staged.write()`` returned: the barrier that proves
    every shard file durable, then the master publishes the manifest, the
    commit record."""
    from ..parallel.multihost import master_only, sync

    sync("sharded-ckpt-shards")
    with master_only("sharded-ckpt-manifest") as master:
        if master:
            mpath = os.path.join(staged.path, MANIFEST)
            _atomic_write(
                mpath,
                lambda f: f.write(
                    json.dumps(staged.manifest, indent=1).encode()))
            # chaos seam: a "torn" fault with channel="manifest" damages
            # the commit record itself; resume must fall back past it
            inject.checkpoint_torn(mpath, int(staged.manifest["step"]),
                                   part="manifest")
    return staged.path


def vote_writes_or_raise(err: Optional[BaseException],
                         step: Optional[int] = None) -> None:
    """The collective vote that every process's shard write succeeded; on
    any failure every process raises here together (the local error where
    there is one)."""
    from ..parallel.multihost import all_agree

    if all_agree(err is None):
        return
    if err is not None:
        raise err
    which = f"step {step}" if step is not None else "the step"
    raise RuntimeError(
        "a peer process failed to write its checkpoint shard; "
        f"{which} was not committed")


def save_checkpoint_sharded(path: str, space: CellularSpace, step: int = 0,
                            extra: Optional[dict] = None, *, mesh=None,
                            spec: Spec = None,
                            timings: Optional[dict] = None) -> str:
    """Write ``space`` as a sharded checkpoint directory at ``path``: stage,
    write and commit in one synchronous call. ``timings``, when given,
    receives the staged save's (``StagedShardSave.timings``)."""
    staged = stage_checkpoint_sharded(path, space, step, extra, mesh=mesh,
                                      spec=spec)
    if timings is not None:
        # the write's seconds land in the caller's dict
        timings.update(staged.timings)
        staged.timings = timings
    err: Optional[BaseException] = None
    try:
        staged.write()
    # analysis: ignore[broad-except] — vote boundary: the failure becomes
    # this process's vote and every process raises together
    # the vote boundary: the failure becomes this process's vote, and
    # every process raises together
    except BaseException as e:  # noqa: BLE001
        err = e
    vote_writes_or_raise(err, step)
    return commit_checkpoint_sharded(staged)


class _ShardFileReader:
    """Lazy reader of one shard file: the piece table up front, a piece's
    bytes only when an overlap asks for them."""

    def __init__(self, path: str):
        self.path = path
        try:
            self._z = np.load(path)
            self.pieces = json.loads(
                bytes(self._z["meta"]).decode("utf-8"))["pieces"]
        except (zipfile.BadZipFile, EOFError, KeyError, OSError,
                ValueError) as e:
            # a torn shard file is corruption, typed so latest() can fall
            # back to the previous verified step
            raise CheckpointCorruptionError(
                f"shard file {path} is torn/unreadable: "
                f"{type(e).__name__}: {e}") from e

    def read(self, piece: dict, dtype: str) -> np.ndarray:
        """The piece's CRC-checked bytes as an ``[*shape]`` array of
        ``dtype`` (a numpy name; bfloat16 stays raw 2-byte words)."""
        try:
            raw = self._z[piece["key"]]
        except (zipfile.BadZipFile, EOFError, KeyError, OSError,
                ValueError) as e:
            raise CheckpointCorruptionError(
                f"piece {piece['key']} in {self.path} is unreadable: "
                f"{type(e).__name__}: {e}") from e
        want = piece.get("crc32")
        if want is not None and crc32(raw) != want:
            raise CheckpointCorruptionError(
                f"piece {piece['key']} (channel {piece['channel']!r}) in "
                f"{self.path} fails its CRC32 (bytes changed since the "
                "shard was written)")
        return raw.view(_np_word(dtype)).reshape(piece["shape"])

    def close(self) -> None:
        self._z.close()


def _np_word(dtype: str) -> np.dtype:
    """The numpy dtype that holds ``dtype``'s bytes: itself, or the
    same-width unsigned word where numpy has no such type (bfloat16)."""
    if dtype == "bfloat16":
        return np.dtype(np.uint16)
    return np.dtype(dtype)


def _assemble(readers: list, channel: str, dtype: str,
              region_start: tuple, region_shape: tuple) -> np.ndarray:
    """Fill one requested region of ``channel`` from the overlapping pieces;
    incomplete coverage (a corrupt or mismatched checkpoint) is an error,
    not silent zeros."""
    out = np.empty(region_shape, dtype=_np_word(dtype))
    covered = np.zeros(region_shape, dtype=bool)
    for rd in readers:
        for piece in rd.pieces:
            if piece["channel"] != channel:
                continue
            src_sel, dst_sel = [], []
            empty = False
            for ps, pn, rs, rn in zip(piece["start"], piece["shape"],
                                      region_start, region_shape):
                lo, hi = max(ps, rs), min(ps + pn, rs + rn)
                if lo >= hi:
                    empty = True
                    break
                src_sel.append(slice(lo - ps, hi - ps))
                dst_sel.append(slice(lo - rs, hi - rs))
            if empty:
                continue
            data = rd.read(piece, dtype)
            out[tuple(dst_sel)] = data[tuple(src_sel)]
            covered[tuple(dst_sel)] = True
    if not covered.all():
        raise CheckpointCorruptionError(
            f"sharded checkpoint does not cover channel {channel!r} region "
            f"start={region_start} shape={region_shape} "
            f"({int(covered.sum())}/{covered.size} cells present)")
    return out


def _read_manifest(path: str) -> dict:
    mpath = os.path.join(path, MANIFEST)
    if not os.path.exists(mpath):
        raise FileNotFoundError(
            f"no {MANIFEST} in {path}: not a (complete) sharded checkpoint")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError, OSError) as e:
        raise CheckpointCorruptionError(
            f"manifest in {path} is torn/unreadable: "
            f"{type(e).__name__}: {e}") from e
    if manifest.get("format") != SHARDED_FORMAT_VERSION:
        raise ValueError(
            f"unsupported sharded checkpoint format "
            f"{manifest.get('format')!r} in {path}")
    return manifest


def load_checkpoint_sharded(path: str, *, mesh=None, spec: Spec = None,
                            device=None) -> Checkpoint:
    """Restore a sharded checkpoint directory (of either package).

    Without ``mesh``: whole channels, assembled on ``device`` (the card by
    default). With ``mesh`` (``parallel.mesh.Mesh``) and an optional
    ``spec`` (module docstring; by default each of the mesh's axes cuts one
    leading dimension): each distinct block is read from only the pieces
    that overlap it, onto its position's device, and the blocks are
    assembled into the global tensor on ``device`` (the mesh's first device
    by default). Raises ``CheckpointCorruptionError`` for a torn manifest
    or shard file, a piece that fails its CRC32, or a coverage gap."""
    from ..parallel import multihost

    manifest = _read_manifest(path)
    proc = multihost.process_index()
    if mesh is None:
        dev = resolve_device(device)
    else:
        dev = (torch.device(device) if device is not None
               else mesh.home_device())
    readers = []
    try:
        for fn in manifest["files"]:
            readers.append(_ShardFileReader(os.path.join(path, fn)))
        values: dict[str, torch.Tensor] = {}
        for name, ch in manifest["channels"].items():
            dt = ch["dtype"]
            shape = tuple(ch["shape"])
            torch_dtype(dt)  # an unknown dtype name raises before any read
            if mesh is None:
                full = _assemble(readers, name, dt, (0,) * len(shape), shape)
                values[name] = from_bytes(full.view(np.uint8), dt, shape,
                                          dev)
                continue
            out = torch.empty(shape, dtype=torch_dtype(dt), device=dev)
            for pos, pos_dev, start, sub in _regions(
                    shape, mesh, _channel_spec(spec, name, mesh,
                                               len(shape))):
                dst = out[tuple(slice(s, s + n) for s, n in zip(start, sub))]
                if mesh.owner(*pos) == proc:
                    block = _assemble(readers, name, dt, start, sub)
                    piece = from_bytes(block.view(np.uint8), dt, sub,
                                       pos_dev)
                else:
                    piece = torch.empty(sub, dtype=out.dtype)
                if multihost.process_count() > 1:
                    # the owner's block reaches every process
                    raw = multihost.broadcast_bytes(
                        multihost.as_bytes(piece), mesh.owner(*pos))
                    piece = multihost.from_bytes(raw, out.dtype, sub)
                dst.copy_(piece)
            values[name] = out
    finally:
        for rd in readers:
            rd.close()
    space = CellularSpace(
        values, manifest["dim_x"], manifest["dim_y"],
        manifest["x_init"], manifest["y_init"],
        manifest["global_dim_x"], manifest["global_dim_y"])
    return Checkpoint(space=space, step=manifest["step"],
                      extra=manifest["extra"])


def is_sharded_checkpoint(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(
        os.path.join(path, MANIFEST))
