"""The multi-process layer (counterpart of
``mpi_model_tpu/parallel/multihost.py``).

The reference scales across nodes with ``mpirun`` and per-rank
``MPI_Init``/``MPI_Comm_rank`` (the reference's ``src/Main.cpp:21-23``) and
funnels every result through the master rank. The JAX package runs one
process a host under ``jax.distributed``; process 0 plays the master. Here
the processes form a ``torch.distributed`` world:

- ``initialize`` joins (or forms) it, from its arguments or torchrun's
  variables (``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``), and
  is a no-op when a group exists or nothing asks for a world, so a
  one-process run may call it unconditionally. The backend is the
  caller's: ``"nccl"`` (the default) where each process has a card of its
  own, ``"gloo"`` on the CPU or where processes share a card. Nothing
  switches backend by itself; NCCL asked for where two processes would
  share one card raises here. The group's collectives time out after
  ``timeout_s`` (``GROUP_TIMEOUT_S``), so a rank that dies or hangs fails
  its peers instead of stranding them.
- ``process_index``/``process_count``/``is_master`` are the rank queries,
  ``all_agree`` the vote, ``sync`` the barrier, ``master_only`` the
  master-write-with-barrier idiom and ``broadcast_str`` the master's string
  on every process. With a group they take the collective path, a world of
  one included; without one they answer for one process.
- ``gather_global`` and ``host_local_to_global`` assemble a grid whose
  blocks live on several processes.
- ``dryrun_two_process`` and ``dryrun_supervised_kill`` start real
  processes on this host (CPU or one shared card) and run the sharded
  model, its checkpoints and its output across them.

The wire helpers below (``all_gather_bytes``, ``broadcast_bytes``,
``exchange_pieces``) are what the mesh, halo and collectives modules send
with. Gloo's point-to-point operations and gathers take CPU tensors only,
so under gloo every card tensor is staged through host memory: an
exchange packs what it sends into one buffer (one device-to-host copy)
and unpacks what it receives from one (one host-to-device copy). NCCL
carries card tensors as they are.
"""

from __future__ import annotations

import contextlib
import datetime
import ipaddress
import os
import subprocess
import sys
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["initialize", "process_index", "process_count", "is_master",
           "all_agree", "sync", "master_only", "broadcast_str",
           "gather_global", "host_local_to_global", "probe_free_port",
           "dryrun_two_process", "dryrun_supervised_kill"]

#: seconds a collective of the group waits before it fails
GROUP_TIMEOUT_S = 120.0
BACKENDS = ("nccl", "gloo")
_TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def has_group() -> bool:
    """Whether a ``torch.distributed`` group exists in this process."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _card_of(process_id: int, local_device_ids) -> int:
    """The card index an NCCL process uses: its first ``local_device_ids``
    entry, torchrun's ``LOCAL_RANK``, or its rank."""
    if local_device_ids is not None:
        ids = ([local_device_ids] if isinstance(local_device_ids, int)
               else list(local_device_ids))
        return int(ids[0])
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return int(process_id)


def _loopback(host: str) -> bool:
    if host == "localhost":
        return True
    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return False


def _check_nccl(host: str, num_processes: int, process_id: int,
                local_device_ids) -> int:
    """The card this NCCL process takes; raises where NCCL cannot run:
    no card, a card index past the visible ones, or every process on this
    host with fewer cards than processes (NCCL refuses two ranks on one
    GPU)."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    card = _card_of(process_id, local_device_ids)
    if cards == 0 or card >= cards or (_loopback(host)
                                       and num_processes > cards):
        raise ValueError(
            f"backend='nccl' needs a card of its own for each process: "
            f"{num_processes} processes on this host see {cards} card(s), "
            f"and process {process_id} would take card {card} — NCCL "
            "refuses two ranks on one GPU. Pass backend='gloo' to let "
            "processes share a card (or run on the CPU).")
    return card


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids=None, *, backend: Optional[str] = None,
               timeout_s: float = GROUP_TIMEOUT_S) -> None:
    """Join (or form) the multi-process world: ``coordinator_address`` is
    ``host:port`` of process 0, or torchrun's variables name it. A no-op
    when a group already exists, or when neither the arguments nor
    torchrun's variables ask for a world (the JAX package's
    ``JAX_COORDINATOR_ADDRESS`` rule). ``backend`` is ``"nccl"`` (the
    default: each process takes its own card, ``local_device_ids[0]`` or
    its local rank) or ``"gloo"``."""
    import torch.distributed as dist

    if has_group():
        return
    env = all(v in os.environ for v in _TORCHRUN_VARS)
    if coordinator_address is None and num_processes is None and not env:
        return  # a one-process run
    backend = "nccl" if backend is None else backend
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}: {backend!r}")
    if coordinator_address is None and env:
        host, port = os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"]
    elif coordinator_address is not None:
        host, _, port = coordinator_address.rpartition(":")
    else:
        raise ValueError("initialize needs coordinator_address (host:port) "
                         "or torchrun's MASTER_ADDR/MASTER_PORT")
    world = int(num_processes if num_processes is not None
                else os.environ["WORLD_SIZE"])
    rank = int(process_id if process_id is not None
               else os.environ["RANK"])
    if backend == "nccl":
        torch.cuda.set_device(_check_nccl(host, world, rank,
                                          local_device_ids))
    dist.init_process_group(
        backend, init_method=f"tcp://{host}:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=float(timeout_s)))


def process_index() -> int:
    """This process's rank (the reference's ``comm_rank``)."""
    import torch.distributed as dist

    return dist.get_rank() if has_group() else 0


def process_count() -> int:
    """The number of processes in the world."""
    import torch.distributed as dist

    return dist.get_world_size() if has_group() else 1


def is_master() -> bool:
    """Process 0, the reference's MASTER rank (``Defines.hpp:10``)."""
    return process_index() == 0


def backend() -> Optional[str]:
    """The group's backend name, or None without a group."""
    import torch.distributed as dist

    return dist.get_backend() if has_group() else None


def wire_device() -> torch.device:
    """Where the group's tensors must live: the host under gloo, this
    process's card under NCCL."""
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_agree(flag: bool) -> bool:
    """True iff every process passes True: a collective vote (a MIN over
    the world). Use it before a world-wide commit whose per-process
    preparation can fail, so every process raises (or commits) together
    rather than some waiting in a barrier for a peer that raised."""
    import torch.distributed as dist

    if not has_group():
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                     device=wire_device())
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def sync(name: str = "barrier") -> None:
    """Cross-process barrier ``name`` (one all-reduce of a word, which
    every backend runs; nothing to wait for without a group)."""
    import torch.distributed as dist

    if not has_group():
        return
    t = torch.zeros(1, dtype=torch.int32, device=wire_device())
    dist.all_reduce(t)
    t.item()


@contextlib.contextmanager
def master_only(barrier_name: str):
    """The master-write-with-barrier idiom: the body learns whether this
    process is the master, and every process reaches the barrier even when
    the master's body raises (a disk error on the master propagates
    instead of stranding the others in ``sync``)::

        with master_only("checkpoint-save") as master:
            if master:
                ...write files...
    """
    try:
        yield is_master()
    finally:
        sync(barrier_name)


def broadcast_str(s: str, max_len: int = 256) -> str:
    """Process 0's string, delivered to every process: values that must
    agree world-wide but come from per-process state (a wall-clock-stamped
    output filename)."""
    raw = s.encode("utf-8")
    if len(raw) > max_len:
        # truncating would silently corrupt a world-wide value (e.g. a
        # long output path used by every process)
        raise ValueError(
            f"broadcast_str: string is {len(raw)} bytes UTF-8, exceeding "
            f"max_len={max_len}; pass a larger max_len")
    if not has_group():
        return s
    buf = torch.zeros(max_len, dtype=torch.uint8)
    buf[:len(raw)] = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    out = broadcast_bytes(buf, 0)
    return bytes(out.cpu().numpy()).rstrip(b"\x00").decode("utf-8")


# -- the wire ----------------------------------------------------------------


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes as a flat ``uint8`` tensor on its device (a view of a
    contiguous tensor): every dtype crosses the wire the same way, bf16 and
    bool included."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def from_bytes(raw: torch.Tensor, dtype: torch.dtype,
               shape: Sequence[int]) -> torch.Tensor:
    """The tensor of ``dtype`` and ``shape`` whose bytes are ``raw``."""
    return raw.view(dtype).reshape(tuple(shape))


def all_gather_bytes(raw: torch.Tensor) -> list[torch.Tensor]:
    """Every process's equal-length ``uint8`` buffer, in rank order, on the
    wire device (under gloo: ``raw`` staged to the host, one device-to-host
    copy)."""
    import torch.distributed as dist

    dev = wire_device()
    src = raw.to(dev)
    out = [torch.empty_like(src) for _ in range(process_count())]
    dist.all_gather(out, src)
    return out


def all_gather_ints(values: Sequence[int]) -> list[list[int]]:
    """Every process's equal-length list of ints, in rank order (one
    all-gather; under NCCL the gathered words are read back to the
    host)."""
    t = torch.tensor(list(values), dtype=torch.int64)
    return [from_bytes(raw, torch.int64, (len(values),)).tolist()
            for raw in all_gather_bytes(as_bytes(t))]


def broadcast_bytes(raw: torch.Tensor, src: int) -> torch.Tensor:
    """Process ``src``'s ``uint8`` buffer on every process (the others pass
    a buffer of the same length), on the wire device."""
    import torch.distributed as dist

    buf = raw.to(wire_device(), copy=True)
    dist.broadcast(buf, src)
    return buf


def _packed(tensors: Sequence[torch.Tensor], dev: torch.device
            ) -> tuple[torch.Tensor, list[int]]:
    """The tensors' bytes back to back in one ``uint8`` buffer on ``dev``,
    and each one's offset: one concatenation on their device (when they
    share one) and one copy to ``dev``."""
    flat = [as_bytes(t) for t in tensors]
    if len({t.device for t in flat}) > 1:
        flat = [t.to(dev) for t in flat]
    offs = [0]
    for t in flat:
        offs.append(offs[-1] + t.numel())
    return torch.cat(flat).to(dev), offs


def exchange_pieces(sends: Sequence[tuple[int, int, torch.Tensor]],
                    recvs: Sequence[tuple]) -> list[torch.Tensor]:
    """Post every send ``(peer, tag, tensor)`` and receive ``(peer, tag,
    shape, dtype, device)`` of one exchange as one ``batch_isend_irecv``,
    wait for all, and return the received tensors (views of one buffer on
    each one's device). Gloo matches a receive by source and tag, so every
    piece between two processes carries a tag of its own. The pieces cross
    in one staging buffer each way: under gloo, one device-to-host copy of
    everything sent and one host-to-device copy of everything received
    (each a wait for the card) an exchange."""
    import torch.distributed as dist

    if not sends and not recvs:
        return []
    dev = wire_device()
    ops = []
    if sends:
        out_buf, offs = _packed([t for _, _, t in sends], dev)
        for k, (peer, tag, _) in enumerate(sends):
            ops.append(dist.P2POp(dist.isend, out_buf[offs[k]:offs[k + 1]],
                                  peer, tag=tag))
    sizes = [int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
             for _, _, shape, dtype, _ in recvs]
    in_offs = np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)])
    in_buf = torch.empty(int(in_offs[-1]), dtype=torch.uint8, device=dev)
    for k, (peer, tag, *_) in enumerate(recvs):
        ops.append(dist.P2POp(dist.irecv,
                              in_buf[int(in_offs[k]):int(in_offs[k + 1])],
                              peer, tag=tag))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    landed = {}
    for device in {torch.device(r[4]) for r in recvs}:
        landed[device] = in_buf.to(device)
    return [from_bytes(landed[torch.device(device)][
        int(in_offs[k]):int(in_offs[k + 1])], dtype, shape)
        for k, (_, _, shape, dtype, device) in enumerate(recvs)]


# -- gathers -----------------------------------------------------------------


def gather_global(x) -> np.ndarray:
    """A grid on every process as a host array (the master-side merge,
    ``Model.hpp:110-131``). ``x`` is a shard grid (``parallel.mesh``
    ``ShardGrid``; ``None`` where another process owns a position),
    gathered over the group; or a tensor or array, which the port holds
    whole on every process (``ShardMapExecutor.run_model`` returns global
    tensors), so its gather is its host copy. bf16 comes back as float32,
    which holds every bf16 value exactly."""
    if isinstance(x, list):
        from .collectives import gather_grid

        full = gather_grid(x, torch.device("cpu"), collective=has_group())
    elif isinstance(x, torch.Tensor):
        full = x.detach().cpu()
    else:
        return np.asarray(x)
    if full.dtype == torch.bfloat16:
        full = full.float()
    return full.numpy()


def host_local_to_global(local_np, mesh, spec, *,
                         device=None) -> torch.Tensor:
    """The global tensor whose block this process holds as ``local_np``
    (the typed replacement of the reference's descriptor scatter,
    ``Model.hpp:62-76``). ``spec`` names, per dimension, the mesh axis
    that cuts it (``None``: not cut); this process's positions must form a
    rectangle of the mesh, and its block is theirs. Every process's block
    is gathered (one all-gather), and the global tensor is returned on
    ``device`` (the mesh's first local device by default)."""
    local = torch.as_tensor(np.ascontiguousarray(local_np))
    spec = tuple(spec) + (None,) * (local.dim() - len(tuple(spec)))
    lines, columns = mesh.grid_shape
    extent = dict(zip(mesh.axis_names, (lines, columns)))
    nprocs = process_count()

    def block_of(rank: int) -> tuple[tuple[int, int], tuple[int, int]]:
        cells = mesh.cells_of(rank)
        rows = sorted({i for i, _ in cells})
        cols = sorted({j for _, j in cells})
        if len(cells) != len(rows) * len(cols):
            raise ValueError(
                f"process {rank}'s mesh positions {cells} are not a "
                "rectangle of the mesh")
        return (rows[0], len(rows)), (cols[0], len(cols))

    blocks = [block_of(r) for r in range(nprocs)]
    mine = blocks[process_index()]
    shape, starts = [], []
    for d, a in enumerate(spec):
        if a is None:
            shape.append(local.shape[d])
            continue
        k = mesh.axis_names.index(a)
        first, count = mine[k]
        if local.shape[d] % count:
            raise ValueError(f"local dim {local.shape[d]} along {a!r} does "
                             f"not divide over {count} mesh positions")
        shape.append(local.shape[d] // count * extent[a])
    dev = torch.device(device) if device is not None else mesh.home_device()
    out = torch.empty(shape, dtype=local.dtype, device=dev)
    parts = (all_gather_bytes(as_bytes(local)) if has_group()
             else [as_bytes(local)])
    for r, raw in enumerate(parts):
        sel = []
        for d, a in enumerate(spec):
            if a is None:
                sel.append(slice(None))
                continue
            first, count = blocks[r][mesh.axis_names.index(a)]
            per = shape[d] // extent[a]
            sel.append(slice(first * per, (first + count) * per))
        out[tuple(sel)] = from_bytes(raw, local.dtype, local.shape).to(dev)
    return out


# -- the dry runs: real processes on this host (the CPU or one shared card) --

_WORKER = r"""
import sys
sys.path.insert(0, {root!r})
import torch
from mpi_model_tpu_torch.parallel import multihost
multihost.initialize("127.0.0.1:{port}", num_processes=2,
                     process_id={pid}, backend="gloo")
import hashlib
import json
import os as _os
import numpy as np
from mpi_model_tpu_torch import CellularSpace, Diffusion, Model, PointFlow
from mpi_model_tpu_torch.parallel import ShardMapExecutor, make_mesh_2d
from mpi_model_tpu_torch.parallel.collectives import gather_to_host

assert multihost.process_count() == 2, multihost.process_count()
dev = torch.device({device!r})
# four positions on each process: one mesh row each (the JAX package's
# np.array(jax.devices()).reshape(2, 4) over two processes)
mesh = make_mesh_2d(2, 4, devices=[dev] * 8)
me = multihost.process_index()
assert mesh.local_cells() == [(me, j) for j in range(4)], mesh.local_cells()

h, w = 16, 32
space = CellularSpace.create(h, w, 1.0, dtype={dtype!r}, device=dev)
# a point source on a block edge: its share crosses a process boundary
model = Model([Diffusion(0.2), PointFlow(source=(7, 15), flow_rate=0.5)],
              3.0, 1.0)
# the product path: Model.execute with its conservation contract over a
# mesh spanning both processes
ex = ShardMapExecutor(mesh)
out, report = model.execute(space, ex)
assert report.comm_size == 8, report
assert report.rank_id == me, report
grid = out.values["value"]
full = grid.cpu().numpy()
assert full.shape == (h, w)
assert np.isfinite(full).all()
if {out_dir!r} and me == 0:
    np.save(_os.path.join({out_dir!r}, "grid.npy"), full)

# the whole-channel checkpoint: every process reaches the save, the master
# writes, all barrier; then every process restores the same bytes
from mpi_model_tpu_torch.io import load_checkpoint, save_checkpoint
ckpt_path = _os.path.join({ckpt_dir!r}, "mh_ckpt.npz")
save_checkpoint(ckpt_path, out, step=3)
assert _os.path.exists(ckpt_path), "checkpoint missing after save barrier"
ck = load_checkpoint(ckpt_path, device=dev)
assert ck.step == 3
assert torch.equal(ck.space.values["value"].cpu(), grid.cpu())

# the per-shard checkpoint: each process writes the pieces of its own
# positions to its own shards_p<rank>.npz; a restore onto the mesh reads
# each process's own pieces and gathers the rest
from mpi_model_tpu_torch.io import load_checkpoint_sharded
from mpi_model_tpu_torch.io.sharded import save_checkpoint_sharded
sck_path = _os.path.join({ckpt_dir!r}, "mh_sharded.ckpt")
save_checkpoint_sharded(sck_path, out, step=3, mesh=mesh)
with open(_os.path.join(sck_path, "manifest.json")) as f:
    manifest = json.load(f)
assert manifest["process_count"] == 2, manifest
assert manifest["files"] == ["shards_p00000.npz", "shards_p00001.npz"]
with np.load(_os.path.join(sck_path, f"shards_p{{me:05d}}.npz")) as z:
    pieces = json.loads(bytes(z["meta"]).decode())["pieces"]
assert sorted(tuple(p["start"]) for p in pieces) == [
    (me * 8, j * 8) for j in range(4)], pieces
sck = load_checkpoint_sharded(sck_path, mesh=mesh)
assert sck.step == 3
rest = sck.space.values["value"]
for i, j in mesh.local_cells():
    blk = (slice(i * 8, i * 8 + 8), slice(j * 8, j * 8 + 8))
    assert torch.equal(rest[blk].cpu(), grid[blk].cpu()), (i, j)
assert torch.equal(rest.cpu(), grid.cpu())

# async per-shard checkpoints across the process boundary: staged writes,
# the commit at the next save or flush, the vote — the staged step is
# invisible world-wide until committed
from mpi_model_tpu_torch.io import CheckpointManager
amgr = CheckpointManager(_os.path.join({ckpt_dir!r}, "amgr"),
                         layout="sharded", async_writes=True, device=dev)
amgr.save(out, step=3, mesh=mesh)
assert amgr.steps() == [], amgr.steps()   # staged, uncommitted
multihost.sync("async-staged")
amgr.save(out, step=6, mesh=mesh)         # commits 3
assert amgr.steps() == [3], amgr.steps()
amgr.flush()
assert amgr.steps() == [3, 6], amgr.steps()
ack = amgr.latest(mesh=mesh)
assert torch.equal(ack.space.values["value"].cpu(), grid.cpu())

# the kernel path across the process boundary: the halo kernel's step at
# depth 2 (K2 on the card, its plain version on the CPU), against the xla
# deep-halo step
fspace = CellularSpace.create(h, w, 1.0, dtype="float32", device=dev)
pal_model = Model(Diffusion(0.25), 4.0, 1.0)
pal_exec = ShardMapExecutor(mesh, step_impl="pallas", halo_depth=2)
pal_out, _ = pal_model.execute(fspace, pal_exec)
assert pal_exec.last_impl == "pallas", pal_exec.last_impl
xla_exec = ShardMapExecutor(mesh, step_impl="xla", halo_depth=2)
xla_out, _ = pal_model.execute(fspace, xla_exec)
np.testing.assert_allclose(pal_out.values["value"].cpu().numpy(),
                           xla_out.values["value"].cpu().numpy(),
                           atol=1e-5, rtol=1e-5)

# the output pipeline: the MASTER's filename (broadcast: clocks may skew
# across hosts), the master writes, all barrier; every process sees it
from mpi_model_tpu_torch.io import write_output
merged = write_output({ckpt_dir!r}, out, comm_size=2)
assert _os.path.exists(merged), merged

multihost.sync("after-run")
if multihost.is_master():
    # the master's conservation report (Model.hpp:88-95)
    sha = hashlib.sha256(full.tobytes()).hexdigest()
    print(f"MASTER ok: procs={{multihost.process_count()}} "
          f"total={{float(full.sum(dtype=np.float64))}} "
          f"conservation_err={{report.conservation_error():.3e}} "
          f"ckpt=saved sharded_ckpt=ok async_ckpt=ok "
          f"pallas_deep_halo=ok sha256={{sha}}", flush=True)
else:
    print(f"worker {{multihost.process_index()}} done", flush=True)
"""


_SUPKILL_WORKER = r"""
import os, sys
sys.path.insert(0, {root!r})
import torch
from mpi_model_tpu_torch.parallel import multihost
multihost.initialize("127.0.0.1:{port}", num_processes={nprocs},
                     process_id={pid}, backend="gloo")
import numpy as np
from mpi_model_tpu_torch import CellularSpace, Diffusion, Model, PointFlow
from mpi_model_tpu_torch.io import CheckpointManager
from mpi_model_tpu_torch.io.checkpoint import run_checkpointed
from mpi_model_tpu_torch.parallel import ShardMapExecutor, make_mesh_2d

N = {nprocs}
assert multihost.process_count() == N, multihost.process_count()
dev = torch.device({device!r})
mesh = make_mesh_2d(N, 2, devices=[dev] * (2 * N))  # a mesh row a process

h, w = 4 * N, 32
space = CellularSpace.create(h, w, 1.0, dtype="float64", device=dev)
# the point source sits on a shard corner: its Moore shares cross both
# mesh axes (and so process boundaries) every step
model = Model([Diffusion(0.2), PointFlow(source=(h // 2 - 1, 15),
                                         flow_rate=0.5)], 10.0, 1.0)
mgr = CheckpointManager({ckpt_dir!r}, layout="sharded", device=dev)
ex = ShardMapExecutor(mesh)

if {phase} == 1:
    class CrashingExecutor:
        '''Rank {kill_rank} dies hard after computing the third chunk
        (steps 5-6) but before its checkpoint commits: real work is lost
        past the last durable step. Its peers stop at the same logical
        point with a status of their own (the teardown of a job that lost
        a rank).'''

        def __init__(self, inner):
            self._inner = inner
            self._steps = 0

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def run_model(self, model, space, n):
            out = self._inner.run_model(model, space, n)
            self._steps += n
            if self._steps >= 6:
                if multihost.process_index() == {kill_rank}:
                    print("rank {kill_rank} dying mid-run", flush=True)
                    os._exit(17)
                # survivors linger so that the victim's death ends the
                # job, then stop; no collective is posted after the
                # chunk's gather, so none waits for the dead rank
                import time as _t
                _t.sleep(2.0)
                print(f"survivor {{multihost.process_index()}} torn down",
                      flush=True)
                os._exit(0)
            return out

    run_checkpointed(model, space, mgr, steps=10, every=2,
                     executor=CrashingExecutor(ex))
    raise AssertionError("phase 1 must die inside the crash chunk")

# ---- phase 2: a fresh world resumes the same checkpoint directory ----
committed = mgr.steps()
assert committed == [0, 2, 4], committed  # step 6 died before commit
out, step, report = run_checkpointed(model, space, mgr, steps=10, every=2,
                                     executor=ex)
assert step == 10, step
full = out.values["value"].cpu()

# ground truth: the same run uninterrupted (chunked identically), fresh
ex_ref = ShardMapExecutor(mesh)
cur = CellularSpace.create(h, w, 1.0, dtype="float64", device=dev)
for s in range(0, 10, 2):
    cur, _ = model.execute(cur, ex_ref, steps=2, check_conservation=False)
assert torch.equal(full, cur.values["value"].cpu())  # the resume is bitwise

multihost.sync("after-resume")
if multihost.is_master():
    err = abs(float(full.sum()) - float(h * w))
    assert err < 1e-9, err
    print(f"MASTER ok: procs={{N}} resumed_from={{committed[-1]}} "
          f"final_step={{step}} conservation_err={{err:.3e}} "
          f"bitwise_resume=ok", flush=True)
else:
    print(f"worker {{multihost.process_index()}} done", flush=True)
"""


def probe_free_port() -> int:
    """A coordinator port the OS just proved bindable: bind to port 0, read
    the assignment, close. The close→reuse window is a benign race; a
    real collision surfaces as the group-formation error it is."""
    import socket

    # analysis: ignore[raw-transport] — a bind-probe for a free coordinator
    # port (open, bind :0, read, close); no bytes are exchanged, so there
    # is nothing for the wire codec to frame
    s = socket.socket()
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])
    finally:
        s.close()


def _root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _dry_device(device) -> str:
    """The dry runs' device: the card unless the caller names another
    (raises without a card, as every entry point does)."""
    from ..core.cellular_space import resolve_device

    return str(resolve_device(device))


def _launch_workers(codes: list, timeout: float) -> list:
    """Start one process per code string (``python -c``, never a fork of
    this process, which may hold a CUDA context), with the checkout on
    ``PYTHONPATH``; return ``[(rc, stdout, stderr), ...]`` in order. When
    one outlives ``timeout`` seconds every process is killed and
    ``subprocess.TimeoutExpired`` raised; no process outlives the call."""
    root = _root()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    procs = []
    try:
        for code in codes:
            # analysis: ignore[raw-transport] — the multi-process dry-run
            # rig: the workers talk over torch.distributed, not the fleet
            # wire, and each is waited for with a deadline below
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], env=env, cwd=root,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _master_line(outs: list, what: str) -> str:
    """The master's report line; raises naming the first failed rank."""
    for pid, (rc, out, err) in enumerate(outs):
        if rc != 0:
            raise RuntimeError(
                f"{what}: rank {pid} failed (rc={rc}):\n"
                f"{out[-2000:]}\n{err[-4000:]}")
    master_out = outs[0][1]
    if "MASTER ok" not in master_out:
        raise RuntimeError(f"{what}: no master report in: {master_out!r}")
    return master_out.strip().splitlines()[-1]


def dryrun_supervised_kill(nprocs: int = 4, kill_rank: int = 2,
                           port: Optional[int] = None,
                           timeout: int = 300, *, device=None) -> str:
    """Failure injection across real process boundaries: an
    ``nprocs``-process gloo world runs a supervised run with per-shard
    checkpoints every 2 steps (f64, a ``(nprocs, 2)`` mesh, one mesh row a
    process); rank ``kill_rank`` dies hard (exit 17) after computing steps
    past the last durable checkpoint; then a fresh world resumes the same
    directory through ``run_checkpointed`` and must end bit for bit equal
    to an uninterrupted run. ``device`` is where every process runs (the
    card by default; the processes share it). Returns the second world's
    master line."""
    import shutil
    import tempfile

    if nprocs < 2:
        raise ValueError("dryrun_supervised_kill needs >= 2 processes")
    if not 0 <= kill_rank < nprocs:
        raise ValueError(f"kill_rank {kill_rank} outside 0..{nprocs - 1}")
    dev = _dry_device(device)
    explicit_port = port is not None
    if port is None:
        port = probe_free_port()
    ckpt_dir = tempfile.mkdtemp(prefix="mmtpu_torch_supkill_")
    try:
        def codes(phase, prt):
            return [_SUPKILL_WORKER.format(
                root=_root(), port=prt, pid=pid, nprocs=nprocs,
                kill_rank=kill_rank, ckpt_dir=ckpt_dir, phase=phase,
                device=dev) for pid in range(nprocs)]

        # phase 1: the crash run. The victim's rc 17 proves the injection
        # fired; the survivors stop on their own after it
        outs = _launch_workers(codes(1, port), timeout)
        rc_victim = outs[kill_rank][0]
        if rc_victim != 17 or "dying mid-run" not in outs[kill_rank][1]:
            raise RuntimeError(
                f"victim rank {kill_rank}: rc={rc_victim}, expected 17 "
                f"with the crash marker:\n{outs[kill_rank][1][-2000:]}\n"
                f"{outs[kill_rank][2][-4000:]}")
        # phase 2: a fresh world on a freshly probed port (phase 1's may
        # sit in TIME_WAIT), the same checkpoint directory; an explicit
        # port keeps port + 1
        port2 = (port + 1) if explicit_port else probe_free_port()
        return _master_line(_launch_workers(codes(2, port2), timeout),
                            "the resumed world")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def dryrun_two_process(port: Optional[int] = None, timeout: int = 300, *,
                       device=None, dtype: str = "float32",
                       out_dir: Optional[str] = None) -> str:
    """Start a real 2-process gloo world on this host (four mesh positions
    each: one 2x4 mesh, a mesh row a process), run ``Model.execute`` with a
    point flow across the process boundary, the whole-channel, per-shard
    and async per-shard checkpoints, the halo kernel's step at depth 2
    against the xla one, and ``write_output``; return the master's line.
    ``device`` is where both processes run (the card by default; they
    share it), ``dtype`` the first run's grid; with ``out_dir`` the master
    saves that run's grid there as ``grid.npy``."""
    import shutil
    import tempfile

    dev = _dry_device(device)
    if port is None:
        port = probe_free_port()
    ckpt_dir = tempfile.mkdtemp(prefix="mmtpu_torch_mh_")
    try:
        codes = [_WORKER.format(root=_root(), port=port, pid=pid,
                                ckpt_dir=ckpt_dir, device=dev, dtype=dtype,
                                out_dir=out_dir or "")
                 for pid in (0, 1)]
        return _master_line(_launch_workers(codes, timeout),
                            "multi-process dry run")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
