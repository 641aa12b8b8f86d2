"""The port's multi-process layer (``parallel/multihost.py`` and the
cross-process paths of ``parallel/mesh.py``, ``halo.py``,
``collectives.py``, ``executors.py`` and ``io/``) on the CPU, against the
JAX package's ``multihost`` and the port's own one-process runs.

- The counterparts of JAX's non-slow tests (``tests/test_multihost.py``):
  ``initialize`` without a world, ``gather_global`` of one process,
  ``broadcast_str``'s refusal.
- A world of one gloo process (a ``FileStore`` under ``tmp_path``, the
  group destroyed in ``finally`` so no later file in the worker sees it)
  runs every query and collective through the group's path.
- The exchange plan: for meshes laid over 2 and 4 processes, the pieces
  carried by hand between the ranks' partial grids in this one process
  rebuild ``exchange_ring``'s rings, ``pad_rings``'s padded shards and
  ``refresh_rings``'s buffers bit for bit.
- Slow (they start processes): the port's ``dryrun_two_process`` and
  ``dryrun_supervised_kill`` on CPU processes over gloo, and every runner
  of ``ShardMapExecutor`` and every route of ``AutoShardedExecutor``
  across two processes, each held bit for bit to its one-process run.
"""

import ast
import datetime
import hashlib
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

from mpi_model_tpu.parallel import multihost as jmultihost

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch import oracle
from mpi_model_tpu_torch.parallel import (ShardMapExecutor, exchange_ring,
                                          global_sum, make_mesh_2d,
                                          refresh_rings, shard_space)
from mpi_model_tpu_torch.parallel import halo, multihost
from mpi_model_tpu_torch.parallel import mesh as pmesh
from mpi_model_tpu_torch.parallel.collectives import gather_grid

CPU = torch.device("cpu")
TORCHRUN = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo group of one process for the test's duration."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture
def as_rank(monkeypatch):
    """Make this process answer as rank ``r`` of ``n`` (no group: the
    collectives are the test's own)."""
    def set_rank(r, n):
        monkeypatch.setattr(multihost, "process_index", lambda: r)
        monkeypatch.setattr(multihost, "process_count", lambda: n)
    return set_rank


# -- JAX's non-slow tests -----------------------------------------------------


def test_initialize_noop_single_process(monkeypatch):
    for v in TORCHRUN:
        monkeypatch.delenv(v, raising=False)
    multihost.initialize()
    assert not dist.is_initialized()
    assert multihost.process_count() == 1
    assert multihost.is_master()
    jmultihost.initialize()
    assert jmultihost.process_count() == multihost.process_count()


def test_gather_global_single_process():
    rng = np.random.default_rng(5)
    x = rng.uniform(-1.0, 1.0, (6, 10))
    want = jmultihost.gather_global(jnp.asarray(x))
    for got in (multihost.gather_global(torch.from_numpy(x)),
                multihost.gather_global(x)):
        np.testing.assert_array_equal(got, want)
    grid = shard_space(mt.CellularSpace({"value": torch.from_numpy(x)}, 6,
                                        10), make_mesh_2d(
        2, 2, devices=[CPU] * 4))["value"]
    np.testing.assert_array_equal(multihost.gather_global(grid), want)


def test_broadcast_str_rejects_overlong():
    assert multihost.broadcast_str("short") == "short"
    with pytest.raises(ValueError) as mine:
        multihost.broadcast_str("x" * 300)
    with pytest.raises(ValueError) as jax_s:
        jmultihost.broadcast_str("x" * 300)
    assert str(mine.value) == str(jax_s.value)
    assert "max_len" in str(mine.value)


# -- the backend rule ---------------------------------------------------------


def test_nccl_on_a_shared_card_raises_at_initialize(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for pid in (0, 1):
        with pytest.raises(ValueError, match="refuses two ranks on one GPU"):
            multihost.initialize("127.0.0.1:1", num_processes=2,
                                 process_id=pid)
    with pytest.raises(ValueError, match="backend must be one of"):
        multihost.initialize("127.0.0.1:1", num_processes=2, process_id=0,
                             backend="mpi")
    assert not dist.is_initialized()


def test_nccl_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="backend='gloo'"):
        multihost.initialize("10.0.0.1:1", num_processes=2, process_id=0,
                             backend="nccl")


# -- a world of one gloo process ----------------------------------------------


def test_world_of_one_takes_the_collective_path(tmp_path, monkeypatch):
    rng = np.random.default_rng(7)
    x = rng.uniform(0.5, 2.0, (8, 12))
    space = mt.CellularSpace({"value": torch.from_numpy(x)}, 8, 12)
    grid = shard_space(space, make_mesh_2d(2, 2,
                                           devices=[CPU] * 4))["value"]
    alone = global_sum(grid)  # no group: the partials added in place
    calls = []
    for name in ("all_reduce", "all_gather", "broadcast"):
        orig = getattr(dist, name)

        def rec(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(dist, name, rec)
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        assert multihost.process_index() == 0
        assert multihost.process_count() == 1
        assert multihost.backend() == "gloo"
        assert multihost.all_agree(True) is True
        assert multihost.all_agree(False) is False
        multihost.sync("x")
        with multihost.master_only("m") as master:
            assert master is True
        assert calls == ["all_reduce"] * 4
        assert multihost.broadcast_str("héllo") == "héllo"
        assert calls[-1] == "broadcast"
        n = len(calls)
        np.testing.assert_array_equal(multihost.gather_global(grid), x)
        assert calls[n:] == ["all_gather"]
        total = global_sum(grid)
        assert calls[n + 1:] == ["all_gather"]
        assert torch.equal(total, alone)  # bit for bit
        assert torch.equal(gather_grid(grid, CPU), torch.from_numpy(x))
    finally:
        dist.destroy_process_group()


def test_host_local_to_global_in_a_world_of_one(world_of_one):
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(8, 12)).astype(np.float32)
    mesh = make_mesh_2d(2, 2, devices=[CPU] * 4)
    got = multihost.host_local_to_global(x, mesh, ("x", "y"))
    assert torch.equal(got, torch.from_numpy(x))


def test_checkpoint_and_output_in_a_world_of_one(world_of_one, tmp_path):
    from mpi_model_tpu_torch.io import (load_checkpoint,
                                        load_checkpoint_sharded,
                                        save_checkpoint, write_output)
    from mpi_model_tpu_torch.io.sharded import save_checkpoint_sharded

    rng = np.random.default_rng(4)
    x = rng.uniform(0.5, 2.0, (8, 8))
    space = mt.CellularSpace({"value": torch.from_numpy(x)}, 8, 8)
    mesh = make_mesh_2d(2, 2, devices=[CPU] * 4)
    p = save_checkpoint(str(tmp_path / "c.npz"), space, step=2)
    assert torch.equal(load_checkpoint(p, device="cpu").space.values[
        "value"], space.values["value"])
    d = save_checkpoint_sharded(str(tmp_path / "s.ckpt"), space, 2,
                                mesh=mesh)
    assert sorted(os.listdir(d)) == ["manifest.json", "shards_p00000.npz"]
    with open(os.path.join(d, "manifest.json")) as f:
        assert json.load(f)["process_count"] == 1
    assert torch.equal(load_checkpoint_sharded(d, mesh=mesh).space.values[
        "value"], space.values["value"])
    merged = write_output(str(tmp_path / "out"), space, comm_size=2,
                          timestamp="T")
    assert os.path.basename(merged) == "output T.txt"


# -- the mesh over processes --------------------------------------------------


@pytest.mark.parametrize("shape,nprocs,want", [
    ((2, 4), 2, ((0, 0, 0, 0), (1, 1, 1, 1))),
    ((4, 2), 4, ((0, 0), (1, 1), (2, 2), (3, 3))),
    ((1, 4), 2, ((0, 0, 1, 1),)),
    ((2, 2), 2, ((0, 0), (1, 1))),
    ((2, 2), 1, None),
])
def test_positions_go_row_major_by_rank(shape, nprocs, want):
    assert pmesh.layout_owners(*shape, nprocs) == want


def test_a_mesh_that_does_not_divide_over_the_world_raises():
    with pytest.raises(ValueError, match="does not divide over 2"):
        pmesh.layout_owners(3, 1, 2)


def test_make_mesh_lays_positions_over_the_ranks(as_rank):
    as_rank(1, 2)
    mesh = make_mesh_2d(2, 4, devices=[CPU] * 8)
    assert mesh.multiprocess and mesh.owners == ((0,) * 4, (1,) * 4)
    assert mesh.local_cells() == [(1, j) for j in range(4)]
    assert mesh.cells_of(0) == [(0, j) for j in range(4)]
    space = mt.CellularSpace.create(8, 16, 1.0, dtype="float64",
                                    device="cpu")
    grid = shard_space(space, mesh)["value"]
    assert [t is None for t in grid[0]] == [True] * 4
    assert [t.shape for t in grid[1]] == [(4, 4)] * 4


# -- the exchange plan --------------------------------------------------------

PLANS = [((2, 4), 2), ((4, 2), 4), ((1, 4), 2), ((2, 2), 2)]


def _partials(full, owners, nprocs):
    """Each rank's partial grid: its own positions, None elsewhere."""
    return [[[t if owners[i][j] == r else None
              for j, t in enumerate(row)] for i, row in enumerate(full)]
            for r in range(nprocs)]


def _hand_carry(sources, rank):
    """The transport, by hand: rank ``rank``'s received pieces, cut from
    the full grid ``sources`` (what the senders hold)."""
    def carry(plan, grid, rank_=None):
        got = {}
        for p in plan:
            if p.remote and p.src_rank == rank:
                assert grid[p.src[0]][p.src[1]] is not None
            if p.remote and p.dst_rank == rank:
                assert grid[p.src[0]][p.src[1]] is None
                src = sources[p.src[0]][p.src[1]]
                got[p.dst, p.key] = src[p.rows[0]:p.rows[1],
                                        p.cols[0]:p.cols[1]].clone()
        return got
    return carry


def _full_grid(shape, shard, seed, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    return [[torch.rand(shard, generator=g, dtype=dtype)
             for _ in range(shape[1])] for _ in range(shape[0])]


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("shape,nprocs", PLANS)
def test_the_plan_rebuilds_every_ring(monkeypatch, as_rank, shape, nprocs,
                                      depth):
    owners = pmesh.layout_owners(*shape, nprocs)
    full = _full_grid(shape, (6, 5), seed=depth)
    plan = halo.ring_plan(shape, (6, 5), depth, owners)
    tags = [p.tag for p in plan]
    assert len(set(tags)) == len(tags)
    assert any(p.remote for p in plan)
    seen = 0
    for r, part in enumerate(_partials(full, owners, nprocs)):
        as_rank(r, nprocs)
        monkeypatch.setattr(halo, "carry", _hand_carry(full, r))
        rings = halo.exchange_rings(part, depth)
        pads = halo.pad_rings(part, depth, one_d=False)
        for (i, j), ring in rings.items():
            want = exchange_ring(full, i, j, depth)
            assert list(ring) == list(want)
            for k in want:
                assert torch.equal(ring[k], want[k]), (i, j, k)
            assert torch.equal(pads[i, j], halo.pad_with_halo_2d(
                full, i, j, depth))
            one = halo.exchange_ring(part, i, j, depth)
            assert all(torch.equal(one[k], want[k]) for k in want)
            seen += 1
        for (i, j) in [(i, j) for i in range(shape[0])
                       for j in range(shape[1]) if part[i][j] is None]:
            assert halo.exchange_ring(part, i, j, depth) is None
    assert seen == shape[0] * shape[1]


def test_a_one_d_mesh_pads_as_pad_with_halo_1d(monkeypatch, as_rank):
    owners = pmesh.layout_owners(4, 1, 2)
    full = _full_grid((4, 1), (5, 7), seed=9)
    for r, part in enumerate(_partials(full, owners, 2)):
        as_rank(r, 2)
        monkeypatch.setattr(halo, "carry", _hand_carry(full, r))
        pads = halo.pad_rings(part, 2, one_d=True)
        for (i, _), p in pads.items():
            assert torch.equal(p, halo.pad_with_halo_1d(full, i, 2))
            assert torch.equal(halo.pad_with_halo_1d(part, i, 2), p)


@pytest.mark.parametrize("shape,nprocs", PLANS + [((4, 1), 2)])
def test_refresh_rings_across_processes(monkeypatch, as_rank, shape,
                                        nprocs):
    owners = pmesh.layout_owners(*shape, nprocs)
    inner = _full_grid(shape, (4, 6), seed=13)
    one = [[torch.nn.functional.pad(t, (1, 1, 1, 1)) for t in row]
           for row in inner]
    refresh_rings(one)
    for r in range(nprocs):
        mine = [[torch.nn.functional.pad(t, (1, 1, 1, 1))
                 if owners[i][j] == r else None
                 for j, t in enumerate(row)] for i, row in enumerate(inner)]
        as_rank(r, nprocs)
        monkeypatch.setattr(halo, "carry", _hand_carry(inner, r))
        for _ in range(2):  # a second refresh rewrites the same values
            refresh_rings(mine)
        for i, row in enumerate(mine):
            for j, p in enumerate(row):
                if p is not None:
                    assert torch.equal(p, one[i][j]), (r, i, j)


def test_worker_strings_import_neither_jax_nor_the_jax_package():
    args = dict(root="/x", port=1, pid=0, ckpt_dir="/y", device="cpu",
                dtype="float32", out_dir="", nprocs=2, kill_rank=1, phase=1)
    for code in (multihost._WORKER, multihost._SUPKILL_WORKER,
                 RUNNERS_WORKER):
        tree = ast.parse(code.format(**args))
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                names.add(node.module.split(".")[0])
        assert "mpi_model_tpu_torch" in names
        assert not names & {"jax", "jaxlib", "mpi_model_tpu"}, names


# -- slow: real processes -----------------------------------------------------


def _step_oracle(v, steps):
    for _ in range(steps):
        out = 0.2 * v
        out[7, 15] += 0.5 * v[7, 15]
        v = oracle.transport_np(v, out)
    return v


@pytest.mark.slow
def test_two_process_cpu_dryrun(tmp_path):
    """Two gloo processes run JAX's dry-run program: the master's fields
    are JAX's; the grid (f64) is the one-process run's on the same 2x4
    mesh bit for bit, and the oracle's within 1e-12."""
    line = multihost.dryrun_two_process(device="cpu", dtype="float64",
                                        out_dir=str(tmp_path), timeout=240)
    assert "MASTER ok: procs=2" in line
    assert "conservation_err=0.000e+00" in line
    for field in ("ckpt=saved", "sharded_ckpt=ok", "async_ckpt=ok",
                  "pallas_deep_halo=ok"):
        assert field in line
    got = np.load(tmp_path / "grid.npy")
    space = mt.CellularSpace.create(16, 32, 1.0, dtype="float64",
                                    device="cpu")
    model = mt.Model([mt.Diffusion(0.2), mt.PointFlow(source=(7, 15),
                                                      flow_rate=0.5)],
                     3.0, 1.0)
    one, _ = model.execute(space, ShardMapExecutor(make_mesh_2d(
        2, 4, devices=[CPU] * 8)))
    want = one.values["value"].numpy()
    np.testing.assert_array_equal(got, want)
    assert f"sha256={hashlib.sha256(want.tobytes()).hexdigest()}" in line
    np.testing.assert_allclose(got, _step_oracle(np.ones((16, 32)), 3),
                               atol=1e-12, rtol=0)


@pytest.mark.slow
def test_four_process_kill_and_resume():
    """Four gloo processes checkpoint per shard every 2 steps; rank 2
    dies hard past the last commit; a fresh world of four resumes the
    directory and ends bit for bit equal to an uninterrupted run."""
    line = multihost.dryrun_supervised_kill(nprocs=4, device="cpu",
                                            timeout=300)
    assert "MASTER ok: procs=4" in line
    assert "resumed_from=4" in line
    assert "final_step=10" in line
    assert "conservation_err=0.000e+00" in line
    assert "bitwise_resume=ok" in line


#: every runner of ShardMapExecutor on meshes laid over the world; with
#: pid -1 it runs in the calling process, with no group
RUNNERS_WORKER = r"""
import sys
sys.path.insert(0, {root!r})
import hashlib
import json
import numpy as np
import torch
from mpi_model_tpu_torch.parallel import multihost
if {pid} >= 0:
    multihost.initialize("127.0.0.1:{port}", num_processes=2,
                         process_id={pid}, backend="gloo")
import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch.ops.flow import Flow
from mpi_model_tpu_torch.parallel import AutoShardedExecutor, \
    ShardMapExecutor, make_mesh, make_mesh_2d

cpu = torch.device("cpu")
rng = np.random.default_rng(17)
blob = np.zeros((32, 64))
blob[12:20, 28:36] = rng.uniform(0.5, 2.0, (8, 8))
dense = rng.uniform(0.5, 2.0, (32, 64))


def space(vals, dtype):
    return mt.CellularSpace({{k: torch.from_numpy(v).to(dtype)
                             for k, v in vals.items()}}, 32, 64)


diff = mt.Model(mt.Diffusion(0.2))
point = mt.Model([mt.Diffusion(0.2), mt.PointFlow((15, 31), 0.5)])
field = mt.Model([mt.Diffusion(0.1, attr="a"),
                  mt.Coupled(flow_rate=0.05, attr="a", modulator="b"),
                  mt.Diffusion(0.2, attr="b")])
frozen = mt.Model(mt.Exponencial(mt.Cell(15, 31, mt.Attribute(99, 2.2)),
                                 0.1))
two = {{"a": dense, "b": dense[::-1].copy()}}
cases = {{
    "xla point 2x4": (point, {{"value": dense}}, torch.float64,
                      lambda: make_mesh_2d(2, 4, devices=[cpu] * 8),
                      "xla", 1, 3),
    "xla point 1x4": (point, {{"value": dense}}, torch.float64,
                      lambda: make_mesh_2d(1, 4, devices=[cpu] * 4),
                      "xla", 1, 3),
    "deep uniform stripes": (diff, {{"value": dense}}, torch.float64,
                             lambda: make_mesh(4, devices=[cpu] * 4),
                             "xla", 3, 7),
    "deep general": (field, two, torch.float64,
                     lambda: make_mesh_2d(2, 2, devices=[cpu] * 4),
                     "xla", 2, 5),
    "pallas K2": (diff, {{"value": dense}}, torch.float32,
                  lambda: make_mesh_2d(2, 4, devices=[cpu] * 8),
                  "pallas", 4, 9),
    "pallas K4-halo": (field, two, torch.float32,
                       lambda: make_mesh_2d(2, 2, devices=[cpu] * 4),
                       "pallas", 2, 5),
    "composed K3-halo": (diff, {{"value": dense}}, torch.float32,
                         lambda: make_mesh_2d(2, 2, devices=[cpu] * 4),
                         "composed", 2, 4),
    "active": (diff, {{"value": blob}}, torch.float64,
               lambda: make_mesh_2d(2, 4, devices=[cpu] * 8),
               "active", 1, 12),
    "active_fused": (diff, {{"value": blob}}, torch.float32,
                     lambda: make_mesh_2d(1, 4, devices=[cpu] * 4),
                     "active_fused", 1, 12),
    "point subsystem": (frozen, {{"value": dense}}, torch.float64,
                        lambda: make_mesh(4, devices=[cpu] * 4),
                        "xla", 1, 5),
}}
rows = {{}}
for name, (model, vals, dtype, mk, impl, depth, steps) in cases.items():
    ex = ShardMapExecutor(mk(), impl, halo_depth=depth)
    out, rep = model.execute(space(vals, dtype), ex, steps=steps,
                             check_conservation=False)
    br = rep.backend_report or {{}}
    rows[name] = {{"impl": rep.impl,
                  "sha": {{k: hashlib.sha256(v.numpy().tobytes()).hexdigest()
                          for k, v in out.values.items()}},
                  "report": {{k: v for k, v in br.items() if k != "host_s"}},
                  "total": {{k: float(v)
                            for k, v in rep.final_total.items()}}}}
gs, gspace = mt.build_model("gray_scott", 32, device=cpu, dtype="float64")
out, rep = gs.execute(gspace, ShardMapExecutor(
    make_mesh_2d(2, 2, devices=[cpu] * 4), "xla"), steps=4,
    check_conservation=False)
rows["ir gray_scott"] = {{"impl": rep.impl, "sha": {{
    k: hashlib.sha256(v.numpy().tobytes()).hexdigest()
    for k, v in out.values.items()}}}}


class Undeclared(Flow):
    flow_rate = 0.1
    attr = "value"

    def outflow(self, values, origin=(0, 0)):
        return values[self.attr] * self.flow_rate


dynamic = mt.Model([mt.PointFlow((15, 31), 0.3, frozen_source_value=2.2),
                    mt.PointFlow((3, 3), 0.1)])
gspmd = {{
    "gspmd positions 2x4": (point, {{"value": dense}}, torch.float64,
                            lambda: make_mesh_2d(2, 4, devices=[cpu] * 8)),
    "gspmd positions stripes": (field, two, torch.float32,
                                lambda: make_mesh(4, devices=[cpu] * 4)),
    "gspmd whole 2x4": (mt.Model(Undeclared()), {{"value": dense}},
                        torch.float64,
                        lambda: make_mesh_2d(2, 4, devices=[cpu] * 8)),
    "gspmd point 2x4": (dynamic, {{"value": dense}}, torch.float64,
                        lambda: make_mesh_2d(2, 4, devices=[cpu] * 8)),
}}
for name, (model, vals, dtype, mk) in gspmd.items():
    ex = AutoShardedExecutor(mk())
    out, rep = model.execute(space(vals, dtype), ex, steps=5,
                             check_conservation=False)
    rows[name] = {{"impl": rep.impl, "route": ex.last_route,
                  "sha": {{k: hashlib.sha256(v.numpy().tobytes()).hexdigest()
                          for k, v in out.values.items()}}}}
if {pid} <= 0:
    print(json.dumps(rows), flush=True)
"""


@pytest.mark.slow
def test_every_runner_across_two_processes_is_its_one_process_run():
    """Each runner of ShardMapExecutor (the xla ring-1 and deep-halo
    steps, K2, K3-halo and K4-halo through their plain versions, the
    sharded active runners, the point subsystem, the IR runner) and each
    route of AutoShardedExecutor (per position, whole grid, point) on
    meshes laid over two gloo processes: the gathered grids, totals and
    kernel records are the one-process run's, bit for bit."""
    args = dict(root=multihost._root(), port=multihost.probe_free_port())
    outs = multihost._launch_workers(
        [RUNNERS_WORKER.format(pid=p, **args) for p in (0, 1)], 300)
    for rc, out, err in outs:
        assert rc == 0, err[-4000:]
    got = json.loads(outs[0][1].strip().splitlines()[-1])
    ns: dict = {}
    exec(RUNNERS_WORKER.format(pid=-1, **args), ns)
    want = ns["rows"]
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    assert want["active"]["report"]["shards"] == 8
    assert want["pallas K2"]["impl"] == "pallas"
    assert want["point subsystem"]["impl"] == "point"
    assert [want[f"gspmd {r} 2x4"]["route"] for r in (
        "positions", "whole", "point")] == ["positions", "whole", "point"]
    assert want["gspmd point 2x4"]["impl"] == "point"
