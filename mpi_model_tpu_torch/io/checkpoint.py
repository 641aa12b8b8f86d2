"""Checkpoint / restore: simulation state to disk and back (counterpart of
``mpi_model_tpu/io/checkpoint.py``; the files are the JAX package's format,
so a checkpoint written by either package restores in the other).

The reference has no checkpointing; its nearest artifact is the end-of-run
per-rank state dump and the master's merge
(``/root/reference/src/Model.hpp:100-131, 246-260``). Here:

- one self-contained ``.npz`` per checkpoint holding every channel as raw
  little-endian bytes (``ch:<name>``, a flat ``uint8`` array: safe for
  bfloat16, which numpy cannot name) plus a JSON ``meta`` record (geometry,
  step, user extras, and per channel its numpy dtype name, shape and the
  CRC32 of its bytes);
- atomic writes (a temporary file, then ``os.replace``), so a crash
  mid-save never damages the newest checkpoint, and the per-channel CRC32,
  so a checkpoint torn or corrupted after the rename is detected at
  restore: every unreadable or CRC-failing read raises
  ``CheckpointCorruptionError``, and ``CheckpointManager.latest()`` falls
  back to the newest checkpoint that verifies;
- ``CheckpointManager`` for periodic save, prune and resume-from-latest,
  in the dense layout or the delta chain (``io.delta``);
- ``run_checkpointed``, the chunked loop whose restart yields the state of
  an uninterrupted run bit for bit.

A channel reaches the host with one device-to-host copy. In a world of
several processes (``parallel.multihost``) every process holds the whole
state (the sharded executor returns global tensors on every process, so
the JAX package's ``gather_global`` of a channel is its host copy): the
master copies and writes under ``master_only``, and every process reaches
the barrier, as the JAX package's ``save_checkpoint`` does. Restore
places each channel on the device the caller names (the card by default).
The per-shard layout (``layout="sharded"``, ``io.sharded``) writes one
piece per mesh block and can write on a thread of its own
(``async_writes=True``): the save copies the pieces to the host and
returns, and the next save or ``flush`` commits it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
import warnings
import zipfile
import zlib
from typing import Any, Optional

import numpy as np
import torch

from ..core.cellular_space import CellularSpace, resolve_device
from ..resilience import inject

FORMAT_VERSION = 1

#: torch dtype → the numpy dtype name the JAX package writes (``str(a.dtype)``)
DTYPE_NAMES = {
    torch.float64: "float64", torch.float32: "float32",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
    torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
}
_DTYPES = {v: k for k, v in DTYPE_NAMES.items()}


class CheckpointCorruptionError(ValueError):
    """A checkpoint failed verification at restore: unreadable (a torn
    write, a truncated archive) or a channel's bytes no longer match the
    CRC32 recorded when they were written. ``CheckpointManager.latest``
    falls back to the previous verified step; an explicit
    ``restore(step)`` propagates it."""


@dataclasses.dataclass
class Checkpoint:
    """A restored checkpoint: the space, its step counter, user extras."""

    space: CellularSpace
    step: int
    extra: dict


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy dtype name a file records for ``dtype``."""
    try:
        return DTYPE_NAMES[dtype]
    except KeyError:
        raise ValueError(f"no checkpoint dtype name for {dtype}") from None


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a recorded numpy dtype name."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported checkpoint dtype {name!r}") from None


def crc32(raw) -> int:
    """The unsigned CRC32 of a bytes-like object (``zlib``'s)."""
    return zlib.crc32(raw) & 0xFFFFFFFF


def host_bytes(t: torch.Tensor) -> np.ndarray:
    """``t``'s bytes on the host as a flat ``uint8`` array: one
    device-to-host copy for a card tensor (none for a contiguous CPU one,
    whose memory the array then shares)."""
    t = t.detach()
    if not t.is_contiguous():
        t = t.contiguous()
    if t.device.type != "cpu":
        t = t.cpu()
    return t.reshape(-1).view(torch.uint8).numpy()


def from_bytes(raw: np.ndarray, name: str, shape, device) -> torch.Tensor:
    """A tensor of dtype ``name`` and ``shape`` on ``device`` from its raw
    bytes (raises ``ValueError`` when the byte count does not fit)."""
    dt = torch_dtype(name)
    raw = np.asarray(raw).reshape(-1)
    if not raw.flags.writeable:
        raw = raw.copy()
    n = int(np.prod(shape, dtype=np.int64)) if len(shape) else 1
    if raw.nbytes != n * dt.itemsize:
        raise ValueError(f"{raw.nbytes} bytes do not hold {name} "
                         f"{tuple(shape)}")
    t = torch.from_numpy(raw).view(dt).reshape(tuple(shape))
    return t.to(device)


def _atomic_write(path: str, write_fn) -> None:
    """Write ``path`` through a temporary file in its directory and
    ``os.replace`` it into place; on any failure the temporary file is
    removed and the error propagates (a copy of
    ``mpi_model_tpu/io/sharded.py::_atomic_write``)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _sync(space: CellularSpace) -> None:
    """Wait for the card's queued work on the space's channels, so the
    copy's time is the copy's."""
    for dev in {t.device for t in space.values.values()}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _geom_meta(space: CellularSpace) -> dict:
    return {
        "dim_x": space.dim_x, "dim_y": space.dim_y,
        "x_init": space.x_init, "y_init": space.y_init,
        "global_dim_x": space.global_dim_x,
        "global_dim_y": space.global_dim_y,
    }


def save_checkpoint(path: str, space: CellularSpace, step: int = 0,
                    extra: Optional[dict] = None, *,
                    timings: Optional[dict] = None) -> str:
    """Write ``space`` (and its step counter) to ``path`` atomically: the
    master writes, and every process reaches the barrier even when the
    master's write fails (``multihost.master_only``). ``timings``, when
    given, receives the master's seconds of the device-to-host copies
    (``copy_s``), the CRCs (``crc_s``) and the write (``write_s``), and the
    file's ``bytes``."""
    from ..parallel.multihost import master_only

    with master_only("checkpoint-save") as master:
        if master:
            _write_checkpoint(path, space, step, extra, timings)
    return path


def _write_checkpoint(path: str, space: CellularSpace, step: int,
                      extra: Optional[dict],
                      timings: Optional[dict]) -> None:
    """The master's part of ``save_checkpoint``."""
    meta: dict[str, Any] = {
        "format": FORMAT_VERSION,
        "step": int(step),
        **_geom_meta(space),
        "channels": {},
        "extra": extra or {},
    }
    payload: dict[str, np.ndarray] = {}
    copy_s = crc_s = 0.0
    _sync(space)
    for name, t in space.values.items():
        t0 = time.perf_counter()
        raw = host_bytes(t)
        t1 = time.perf_counter()
        meta["channels"][name] = {"dtype": dtype_name(t.dtype),
                                  "shape": list(t.shape),
                                  "crc32": crc32(raw)}
        crc_s += time.perf_counter() - t1
        copy_s += t1 - t0
        payload[f"ch:{name}"] = raw
    payload["meta"] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                    dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                exist_ok=True)
    t0 = time.perf_counter()
    _atomic_write(path, lambda f: np.savez(f, **payload))
    write_s = time.perf_counter() - t0
    # chaos seam (resilience.inject): an armed "torn" fault damages the
    # just-committed file, which the CRC and fallback below exist to catch
    inject.checkpoint_torn(path, int(step))
    if timings is not None:
        timings.update(copy_s=copy_s, crc_s=crc_s, write_s=write_s,
                       bytes=os.path.getsize(path))


def load_checkpoint(path: str, device=None) -> Checkpoint:
    """Restore a checkpoint written by ``save_checkpoint`` (of either
    package) onto ``device`` (the card by default); raises
    ``CheckpointCorruptionError`` when the file is unreadable or a channel
    fails its CRC32. One channel's bytes are on the host at a time."""
    dev = resolve_device(device)
    values = {}
    try:
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode("utf-8"))
            fmt = meta.get("format")
            if fmt == FORMAT_VERSION:
                for name, ch in meta.get("channels", {}).items():
                    raw = z[f"ch:{name}"]
                    want = ch.get("crc32")
                    if want is not None and crc32(raw) != want:
                        raise CheckpointCorruptionError(
                            f"channel {name!r} in {path} fails its CRC32 "
                            "(bytes changed since the checkpoint was "
                            "written)")
                    values[name] = from_bytes(raw, ch["dtype"], ch["shape"],
                                              dev)
                    del raw
    except CheckpointCorruptionError:
        raise
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, EOFError, KeyError, OSError,
            ValueError) as e:
        # a torn archive surfaces as any of these, by where the damage
        # landed (the central directory, a member, the meta, a short buffer)
        raise CheckpointCorruptionError(
            f"checkpoint {path} is torn/unreadable: "
            f"{type(e).__name__}: {e}") from e
    if fmt != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint format {fmt!r} in {path} "
                         f"(expected {FORMAT_VERSION})")
    space = CellularSpace(values, meta["dim_x"], meta["dim_y"],
                          meta["x_init"], meta["y_init"],
                          meta["global_dim_x"], meta["global_dim_y"])
    return Checkpoint(space=space, step=meta["step"], extra=meta["extra"])


class CheckpointManager:
    """Periodic checkpoints in one directory, pruned to the newest ``keep``.

    ``layout="full"`` writes ``{prefix}_{step:010d}.npz``; ``"delta"`` the
    incremental chain of ``io.delta`` (keyframes and dirty-tile records
    linked by a chain manifest; restore replays the chain, so a snapshot
    costs the dirty tiles, not the grid). ``keyframe_every`` bounds a chain
    segment (1 keyframe + N-1 deltas); ``delta_tile`` overrides its tile
    (default: the active engine's 128²-preferred tiles). The step counter
    is the identity: ``latest()`` is a sort, not an mtime race, and
    ``restore`` finds the layout on disk, so a run that switches layouts
    still resumes. ``device`` is where restores land (the card by
    default; ``restore``/``latest`` may name another). ``last_save`` holds
    the timings of the newest save (``save_checkpoint``'s keys; the delta
    layout adds its record's kind and dirty tiles; the sharded layout has
    ``stage_s``, ``bytes`` and, once written, ``write_s``).

    ``layout="sharded"`` writes a ``{prefix}_{step:010d}.ckpt`` directory
    (``io.sharded``): with ``mesh=`` given to ``save``, one piece per mesh
    block. ``async_writes=True`` (sharded only) overlaps the shard file's
    write with the caller's next chunk: ``save`` stages the pieces on the
    host and starts a writer thread, and the commit (the manifest) happens
    at the next ``save`` or ``flush``; until then the step is invisible to
    ``steps()``/``latest()``."""

    def __init__(self, directory: str, keep: int = 3, prefix: str = "ckpt",
                 layout: str = "full", async_writes: bool = False,
                 keyframe_every: int = 8,
                 delta_tile: Optional[tuple] = None, device=None):
        if layout not in ("full", "sharded", "delta"):
            raise ValueError(
                f"layout must be 'full', 'sharded' or 'delta': {layout!r}")
        if async_writes and layout != "sharded":
            raise ValueError(
                "async_writes requires layout='sharded' (the staged "
                "write/deferred-manifest protocol is the sharded format's)")
        if keyframe_every < 1:
            raise ValueError(
                f"keyframe_every must be >= 1, got {keyframe_every}")
        self.directory = directory
        self.keep = int(keep)
        self.prefix = prefix
        self.layout = layout
        self.keyframe_every = int(keyframe_every)
        self.delta_tile = delta_tile
        self.device = device
        self.last_save: Optional[dict] = None
        self._chain_obj = None
        self.async_writes = bool(async_writes)
        #: the staged async save not yet committed: (thread, error box,
        #: staged save)
        self._pending = None
        os.makedirs(directory, exist_ok=True)

    @property
    def _chain(self):
        """The delta chain of this directory and prefix, built lazily so a
        full-layout manager never touches it."""
        if self._chain_obj is None:
            from .delta import DeltaChain

            self._chain_obj = DeltaChain(
                self.directory, prefix=self.prefix,
                keyframe_every=self.keyframe_every, tile=self.delta_tile)
        return self._chain_obj

    def path_for(self, step: int, layout: Optional[str] = None) -> str:
        layout = layout or self.layout
        if layout == "delta":
            # the kind on disk wins; the keyframe's name by default
            dp = self._chain.record_path(step, "delta")
            kp = self._chain.record_path(step, "keyframe")
            return dp if (os.path.exists(dp)
                          and not os.path.exists(kp)) else kp
        suffix = ".ckpt" if layout == "sharded" else ".npz"
        return os.path.join(self.directory,
                            f"{self.prefix}_{step:010d}{suffix}")

    def _exists(self, step: int, layout: str) -> bool:
        if layout == "delta":
            return self._chain.has_step(step)
        return os.path.exists(self.path_for(step, layout))

    def _layout_on_disk(self, step: int) -> str:
        """The layout holding ``step``, the configured one first when both
        do (the other may be stale from a run that switched layouts)."""
        order = [self.layout] + [ly for ly in ("full", "sharded", "delta")
                                 if ly != self.layout]
        if self.layout != "delta" and not self._scan_files()[1]:
            # a chain-free directory: a full manager never reads a manifest
            order.remove("delta")
        found = [ly for ly in order if self._exists(step, ly)]
        if not found:
            raise FileNotFoundError(
                f"no checkpoint for step {step} in {self.directory}")
        if len(found) > 1:
            warnings.warn(
                f"step {step} exists in BOTH layouts "
                f"({' and '.join(found)}); restoring the manager's "
                f"configured layout {found[0]!r} — the other file may "
                "be stale", stacklevel=3)
        return found[0]

    def _file_steps(self) -> list[int]:
        """Steps present as full or sharded per-step files (the chain's
        steps are the chain's to report and to prune)."""
        return self._scan_files()[0]

    def _scan_files(self) -> tuple[list[int], bool]:
        """(full/sharded steps on disk, whether any chain file was seen) in
        one pass over the directory. A ``.ckpt`` directory without its
        manifest is a save that never committed, not a checkpoint."""
        from .sharded import is_sharded_checkpoint

        out = set()
        saw_chain = os.path.exists(os.path.join(
            self.directory, f"{self.prefix}_chain.json"))
        for fn in os.listdir(self.directory):
            if not fn.startswith(self.prefix + "_"):
                continue
            if fn.endswith(".kf.npz") or fn.endswith(".d.npz"):
                saw_chain = True
                continue
            stem, ext = os.path.splitext(fn)
            if ext not in (".npz", ".ckpt"):
                continue
            if ext == ".ckpt" and not is_sharded_checkpoint(
                    os.path.join(self.directory, fn)):
                continue
            try:
                out.add(int(stem[len(self.prefix) + 1:]))
            except ValueError:
                continue
        return sorted(out), saw_chain

    def steps(self) -> list[int]:
        file_steps, saw_chain = self._scan_files()
        if self.layout != "delta" and not saw_chain:
            return file_steps
        return sorted(set(file_steps) | set(self._chain.steps()))

    def save(self, space: CellularSpace, step: int,
             extra: Optional[dict] = None, *,
             dirty_tiles: Optional[dict] = None, mesh=None) -> str:
        """``dirty_tiles`` (delta layout only) is the active engine's
        export for the interval since the last save, which lets the delta
        writer skip its full-grid diff; the other layouts ignore it.
        ``mesh`` (sharded layout only; the run's ``parallel.mesh.Mesh``)
        makes each mesh block one piece; the other layouts ignore it."""
        timings: dict = {}
        if self.layout == "delta":
            path = self._chain.save(space, step, extra,
                                    dirty_tiles=dirty_tiles, timings=timings)
        elif self.async_writes:
            import threading

            from .sharded import stage_checkpoint_sharded

            self.flush()  # the previous step commits first
            staged = stage_checkpoint_sharded(self.path_for(step), space,
                                              step, extra, mesh=mesh)
            err_box: list = []

            def _write():
                try:
                    staged.write()
                # analysis: ignore[broad-except] — async-writer boundary: the
                # thread must never die silently; every failure is boxed and
                # re-raised at the next flush
                # the writer thread's boundary: a failure is boxed and
                # raised at the next flush, never lost with the thread
                except BaseException as e:  # noqa: BLE001
                    err_box.append(e)

            t = threading.Thread(target=_write, daemon=True,
                                 name=f"ckpt-write-{step}")
            t.start()
            self._pending = (t, err_box, staged)
            # the staged save's own dict: write_s lands in it when written
            self.last_save = staged.timings
            staged.timings.update(step=int(step), path=staged.path)
            return staged.path
        elif self.layout == "sharded":
            from .sharded import save_checkpoint_sharded

            path = save_checkpoint_sharded(self.path_for(step), space, step,
                                           extra, mesh=mesh, timings=timings)
        else:
            path = save_checkpoint(self.path_for(step), space, step, extra,
                                   timings=timings)
        self.last_save = {"step": int(step), "path": path, **timings}
        self._prune(keep_path=path)
        return path

    def flush(self) -> None:
        """Commit the pending async save: join the writer thread, vote,
        publish the manifest, prune. A no-op when nothing is pending. A
        failed write raises here, and its step stays a manifest-less husk
        that the next prune clears (resume falls back past it)."""
        if self._pending is None:
            return
        t, err_box, staged = self._pending
        self._pending = None
        t.join()
        from .sharded import commit_checkpoint_sharded, vote_writes_or_raise

        vote_writes_or_raise(err_box[0] if err_box else None,
                             staged.manifest["step"])
        commit_checkpoint_sharded(staged)
        self._prune(keep_path=staged.path)

    def _prune(self, keep_path: str) -> None:
        import shutil

        from ..parallel.multihost import master_only
        from .sharded import is_sharded_checkpoint

        with master_only("checkpoint-prune") as master:
            if not master or self.keep <= 0:
                return
            if self.layout == "delta":
                # the chain keeps whole segments (a keyframe that retained
                # deltas replay from is never deleted)
                self._chain.prune(self.keep)
            for old in self._file_steps()[:-self.keep]:
                # a step a layout switch left in both layouts goes in both
                for layout in ("full", "sharded"):
                    p = self.path_for(old, layout)
                    if not os.path.exists(p) or os.path.abspath(p) == \
                            os.path.abspath(keep_path):
                        continue
                    shutil.rmtree(p) if os.path.isdir(p) else os.unlink(p)
            # manifest-less .ckpt directories are crash husks; a newer
            # checkpoint is durable now. Never one a pending write fills:
            # flush() clears _pending before it prunes, and an async save
            # does not prune
            for fn in os.listdir(self.directory):
                p = os.path.join(self.directory, fn)
                if (fn.startswith(self.prefix + "_") and fn.endswith(".ckpt")
                        and os.path.isdir(p) and not is_sharded_checkpoint(p)
                        and os.path.abspath(p) != os.path.abspath(keep_path)):
                    shutil.rmtree(p, ignore_errors=True)

    def latest(self, *, device=None, mesh=None,
               spec=None) -> Optional[Checkpoint]:
        """The newest checkpoint that VERIFIES: a torn or corrupt newest
        step falls back to the next older one (with a ``RuntimeWarning``).
        None when the directory holds none; raises when every step on disk
        fails verification (resuming from nothing would discard the run's
        history). ``mesh``/``spec`` reach a sharded step's restore
        (``io.sharded.load_checkpoint_sharded``); the dense and delta
        layouts restore whole channels and ignore them."""
        steps = self.steps()
        if not steps:
            return None
        # the placement reaches restore only when asked for
        kw = {} if mesh is None and spec is None else {"mesh": mesh,
                                                       "spec": spec}
        last_err: Optional[CheckpointCorruptionError] = None
        for step in reversed(steps):
            try:
                return self.restore(step, device=device, **kw)
            except CheckpointCorruptionError as e:
                warnings.warn(
                    f"checkpoint step {step} failed verification ({e}); "
                    "falling back to the previous verified checkpoint",
                    RuntimeWarning, stacklevel=2)
                last_err = e
        raise CheckpointCorruptionError(
            f"no verifiable checkpoint in {self.directory}: all "
            f"{len(steps)} step(s) on disk failed verification "
            f"(newest error: {last_err})") from last_err

    def restore(self, step: int, *, device=None, mesh=None,
                spec=None) -> Checkpoint:
        dev = device if device is not None else self.device
        layout = self._layout_on_disk(step)
        if layout == "delta":
            return self._chain.restore(step, device=dev)
        path = self.path_for(step, layout)
        if layout == "sharded":
            from .sharded import load_checkpoint_sharded

            return load_checkpoint_sharded(path, mesh=mesh, spec=spec,
                                           device=dev)
        return load_checkpoint(path, device=dev)


def run_checkpointed(model, space: CellularSpace, manager: CheckpointManager,
                     *, steps: Optional[int] = None, every: int = 1,
                     executor=None, check_conservation: bool = True,
                     tolerance: float = 1e-3, rtol: Optional[float] = None):
    """Run ``model`` for ``steps`` (default ``model.num_steps``), saving a
    checkpoint every ``every`` steps and resuming from ``manager.latest()``
    when there is one; returns ``(space, step, report)``. A restart after
    any interruption yields the state of an uninterrupted run bit for bit.

    This is ``resilience.supervised_run`` with recovery off
    (``max_failures=0``), so its checkpoints carry the run's conservation
    baseline and interoperate with supervised runs; a failure surfaces
    with its own type (``ConservationError``/``HealthError``, an executor's
    exception), not the supervisor's wrapper."""
    from ..resilience import SimulationFailure, supervised_run

    try:
        res = supervised_run(model, space, manager, steps=steps, every=every,
                             max_failures=0, executor=executor,
                             health_checks=check_conservation,
                             tolerance=tolerance, rtol=rtol)
    except SimulationFailure as e:
        if e.__cause__ is not None:
            raise e.__cause__
        raise
    return res.space, res.step, res.report
