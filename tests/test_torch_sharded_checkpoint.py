"""The per-shard checkpoint layout of the port (``io/sharded.py``), the
manager's asynchronous writes, the supervisor's flush and mesh resume, the
CLI's ``--checkpoint-layout=sharded --async-checkpoints`` and the one-process
queries of ``parallel/multihost.py``.

One counterpart for each sharded or async test of the JAX package's
``tests/test_io.py:158-586``, for ``tests/test_chaos.py:246``/``:265`` and for
``tests/test_cli.py:124``/``:151``. Where the JAX test passes under jax 0.9
(the layout's round trips, its refusals, the async unit tests) the port is
held to the JAX package through the files themselves: either package
restores the other's directory bit for bit, and the two piece tables
agree. Where it fails (JAX's ``supervised_run`` steps through its broken
plain-Diffusion XLA step, ``compat.py:125``) the port is held to its own
uninterrupted run, which earlier tests hold bit for bit to the oracle; each
such test says so.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_model_tpu as mm
from mpi_model_tpu.io import sharded as jsh
from mpi_model_tpu.parallel import mesh as jmesh_mod

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch import cli as tcli
from mpi_model_tpu_torch.io import CheckpointManager, run_checkpointed
from mpi_model_tpu_torch.io import sharded as sh
from mpi_model_tpu_torch.io.checkpoint import CheckpointCorruptionError
from mpi_model_tpu_torch.parallel import ShardMapExecutor, make_mesh, \
    make_mesh_2d, multihost
from mpi_model_tpu_torch.resilience import SimulationFailure, inject, \
    supervised_run
from mpi_model_tpu_torch.resilience.inject import Fault, FaultPlan

CPU = torch.device("cpu")
DTYPES = {"float64": (torch.float64, jnp.float64),
          "float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def host(h, w, seed):
    return np.random.default_rng(seed).uniform(0.5, 2.0, (h, w))


def random_space(h, w, dtype="float64", attrs=("value",), seed=11):
    vals = {a: torch.from_numpy(host(h, w, seed + i)).to(DTYPES[dtype][0])
            for i, a in enumerate(attrs)}
    return mt.CellularSpace.create(h, w, {a: 1.0 for a in attrs},
                                   dtype=DTYPES[dtype][0],
                                   device="cpu").with_values(vals)


def jax_space(h, w, dtype="float64", attrs=("value",), seed=11):
    vals = {a: jnp.asarray(host(h, w, seed + i), dtype=DTYPES[dtype][1])
            for i, a in enumerate(attrs)}
    return mm.CellularSpace.create(h, w, {a: 1.0 for a in attrs},
                                   dtype=DTYPES[dtype][1]).with_values(vals)


def bits(x) -> np.ndarray:
    """The raw bytes of a port tensor or a JAX/numpy array."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def cpu_mesh_2d(lines, columns):
    return make_mesh_2d(lines, columns, devices=[CPU] * (lines * columns))


def piece_table(path):
    with np.load(os.path.join(path, "shards_p00000.npz")) as z:
        pieces = json.loads(bytes(z["meta"]).decode())["pieces"]
    return {(p["channel"], tuple(p["start"]), tuple(p["shape"]), p["crc32"])
            for p in pieces}


def model(time=10.0):
    return mt.Model(mt.Diffusion(0.1), time, 1.0)


def uninterrupted(space, steps, executor=None, every=2):
    """The run chunk for chunk as the supervisor runs it."""
    ex = executor if executor is not None else mt.SerialExecutor()
    cur = space
    for _ in range(0, steps, every):
        cur, _ = model().execute(cur, ex, steps=every,
                                 check_conservation=False)
    return cur


# -- the layout ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_sharded_roundtrip_unsharded_space(tmp_path, dtype):
    """A space saved without a mesh is one piece a channel; it restores bit
    for bit in the port and in the JAX package, and the JAX package's save
    of the same values writes the same piece table and manifest."""
    space = random_space(11, 13, dtype, attrs=("a", "b"))
    path = sh.save_checkpoint_sharded(str(tmp_path / "ck.ckpt"), space,
                                      step=4, extra={"k": 1})
    assert sh.is_sharded_checkpoint(path)
    ck = sh.load_checkpoint_sharded(path, device="cpu")
    assert ck.step == 4 and ck.extra == {"k": 1}
    jck = jsh.load_checkpoint_sharded(path)
    jpath = jsh.save_checkpoint_sharded(
        str(tmp_path / "j.ckpt"), jax_space(11, 13, dtype, ("a", "b")),
        step=4, extra={"k": 1})
    for k in ("a", "b"):
        assert ck.space.values[k].dtype == space.values[k].dtype
        np.testing.assert_array_equal(bits(ck.space.values[k]),
                                      bits(space.values[k]))
        np.testing.assert_array_equal(bits(jck.space.values[k]),
                                      bits(space.values[k]))
    assert piece_table(path) == piece_table(jpath)
    with open(os.path.join(path, sh.MANIFEST)) as f, \
            open(os.path.join(jpath, jsh.MANIFEST)) as g:
        assert json.load(f) == json.load(g)


def test_sharded_roundtrip_mesh_sharded_space(tmp_path, eight_devices):
    """Saved with a 2x4 mesh, a space is 8 pieces (one a block); it restores
    whole and onto the mesh, and the JAX package's save of the same values
    sharded over its own 2x4 mesh writes the same piece table."""
    mesh = cpu_mesh_2d(2, 4)
    space = random_space(16, 32)
    path = sh.save_checkpoint_sharded(str(tmp_path / "ck.ckpt"), space,
                                      step=2, mesh=mesh)
    assert len(piece_table(path)) == 8
    want = space.values["value"]
    dense = sh.load_checkpoint_sharded(path, device="cpu")
    assert torch.equal(dense.space.values["value"], want)
    placed = sh.load_checkpoint_sharded(path, mesh=mesh)
    assert torch.equal(placed.space.values["value"], want)
    jm = jmesh_mod.make_mesh_2d(devices=eight_devices)
    jpath = jsh.save_checkpoint_sharded(
        str(tmp_path / "j.ckpt"),
        jmesh_mod.shard_space(jax_space(16, 32), jm), step=2)
    assert piece_table(path) == piece_table(jpath)


def test_sharded_replicated_axis_dedups_pieces(tmp_path):
    """A spec that leaves the columns uncut writes each row block once (2
    pieces, not 4 positions), and restores under another spec."""
    mesh = cpu_mesh_2d(2, 2)
    space = random_space(8, 8)
    path = sh.save_checkpoint_sharded(str(tmp_path / "ck.ckpt"), space,
                                      mesh=mesh, spec=("x", None))
    assert len(piece_table(path)) == 2
    full = sh.load_checkpoint_sharded(path, mesh=mesh, spec=("x", "y"))
    assert torch.equal(full.space.values["value"], space.values["value"])


def test_sharded_missing_manifest_is_incomplete(tmp_path):
    d = tmp_path / "partial.ckpt"
    d.mkdir()
    (d / "shards_p00000.npz").write_bytes(b"junk")
    with pytest.raises(FileNotFoundError, match="manifest"):
        sh.load_checkpoint_sharded(str(d), device="cpu")
    with pytest.raises(FileNotFoundError, match="manifest"):
        jsh.load_checkpoint_sharded(str(d))
    assert not sh.is_sharded_checkpoint(str(d))


def test_sharded_coverage_gap_is_an_error(tmp_path):
    """A piece table that does not tile the grid raises the JAX package's
    error (a ``CheckpointCorruptionError``, so a ``ValueError``) in both
    packages, never uninitialised memory."""
    space = random_space(8, 8)
    path = sh.save_checkpoint_sharded(str(tmp_path / "ck.ckpt"), space,
                                      mesh=cpu_mesh_2d(2, 2))
    fn = os.path.join(path, "shards_p00000.npz")
    with np.load(fn) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        payload = {k: z[k] for k in z.files if k != "meta"}
    dropped = meta["pieces"].pop()
    payload.pop(dropped["key"])
    payload["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(fn, **payload)
    with pytest.raises(ValueError, match="does not cover") as got:
        sh.load_checkpoint_sharded(str(path), device="cpu")
    assert isinstance(got.value, CheckpointCorruptionError)
    with pytest.raises(ValueError) as want:
        jsh.load_checkpoint_sharded(str(path))
    assert str(got.value) == str(want.value)


def test_sharded_piece_crc_is_checked_on_read(tmp_path):
    """A piece whose bytes changed after the save fails its CRC32 on
    restore, whole or through a mesh."""
    path = sh.save_checkpoint_sharded(str(tmp_path / "ck.ckpt"),
                                      random_space(8, 8),
                                      mesh=cpu_mesh_2d(2, 2))
    fn = os.path.join(path, "shards_p00000.npz")
    with np.load(fn) as z:
        payload = {k: z[k].copy() for k in z.files}
    payload["d:1"][0] ^= 0xFF
    np.savez(fn, **payload)
    for kw in ({"device": "cpu"}, {"mesh": cpu_mesh_2d(2, 2)}):
        with pytest.raises(CheckpointCorruptionError, match="CRC32"):
            sh.load_checkpoint_sharded(path, **kw)


def test_manager_sharded_layout_resume_and_prune(tmp_path):
    """``run_checkpointed`` over the sharded layout: pruned directories and
    a resumed run bit for bit the uninterrupted one. JAX's run fails here,
    so the port is held to its own uninterrupted run."""
    space = random_space(16, 16)
    mgr = CheckpointManager(str(tmp_path / "ckpts"), keep=2,
                            layout="sharded", device="cpu")
    _, step6, _ = run_checkpointed(model(), space, mgr, steps=6, every=2,
                                   executor=mt.SerialExecutor())
    assert step6 == 6
    assert mgr.steps() == [4, 6]
    assert sh.is_sharded_checkpoint(mgr.path_for(6))
    out10, step10, _ = run_checkpointed(model(), space, mgr, steps=10,
                                        every=2,
                                        executor=mt.SerialExecutor())
    assert step10 == 10
    want = uninterrupted(space, 10)
    assert torch.equal(out10.values["value"], want.values["value"])


def test_manager_restore_autodetects_layout(tmp_path):
    space = random_space(6, 6)
    CheckpointManager(str(tmp_path / "ck"), layout="full",
                      device="cpu").save(space, step=3)
    ck = CheckpointManager(str(tmp_path / "ck"), layout="sharded",
                           device="cpu").latest()
    assert ck.step == 3
    assert torch.equal(ck.space.values["value"], space.values["value"])


def test_manager_prefers_configured_layout_when_both_exist(tmp_path):
    old, new = random_space(6, 6, seed=1), random_space(6, 6, seed=2)
    dense = CheckpointManager(str(tmp_path / "ck"), layout="full",
                              device="cpu")
    dense.save(old, step=5)
    sharded = CheckpointManager(str(tmp_path / "ck"), layout="sharded",
                                device="cpu")
    sharded.save(new, step=5)
    with pytest.warns(UserWarning, match="BOTH layouts"):
        ck = sharded.restore(5)
    assert torch.equal(ck.space.values["value"], new.values["value"])
    with pytest.warns(UserWarning, match="BOTH layouts"):
        ck = dense.restore(5)
    assert torch.equal(ck.space.values["value"], old.values["value"])


def test_prune_clears_both_layouts_of_an_aged_step(tmp_path):
    import warnings

    space = random_space(6, 6)
    CheckpointManager(str(tmp_path / "ck"), layout="full",
                      device="cpu").save(space, step=1)
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2, layout="sharded",
                            device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for step in (1, 2, 3):
            mgr.save(space, step=step)
    assert mgr.steps() == [2, 3]
    assert not os.path.exists(mgr.path_for(1, "full"))
    assert not os.path.exists(mgr.path_for(1, "sharded"))


def test_sharded_resave_clears_stale_shard_files(tmp_path):
    space = random_space(6, 6)
    path = str(tmp_path / "one.ckpt")
    sh.save_checkpoint_sharded(path, space, step=1)
    stale = tmp_path / "one.ckpt" / "shards_p00002.npz"
    stale.write_bytes(b"junk")
    sh.save_checkpoint_sharded(path, space, step=2)
    assert not stale.exists()
    with open(tmp_path / "one.ckpt" / "manifest.json") as f:
        manifest = json.load(f)
    on_disk = {p.name for p in (tmp_path / "one.ckpt").iterdir()}
    assert on_disk == set(manifest["files"]) | {"manifest.json"}


def test_incomplete_sharded_checkpoint_falls_back(tmp_path):
    space = random_space(6, 6)
    mgr = CheckpointManager(str(tmp_path / "ck"), layout="sharded",
                            device="cpu")
    mgr.save(space, step=2)
    husk = tmp_path / "ck" / "ckpt_0000000004.ckpt"
    husk.mkdir()
    (husk / "shards_p00000.npz").write_bytes(b"junk")
    assert mgr.steps() == [2]
    ck = mgr.latest()
    assert ck is not None and ck.step == 2
    mgr.save(space, step=6)
    assert not husk.exists()


# -- asynchronous writes ------------------------------------------------------

def test_async_save_defers_commit_until_flush(tmp_path):
    space = random_space(8, 8)
    mgr = CheckpointManager(str(tmp_path / "ck"), layout="sharded",
                            async_writes=True, device="cpu")
    mgr.save(space, step=2)
    assert 2 not in mgr.steps()
    mgr.save(space, step=4)
    assert mgr.steps() == [2]
    mgr.flush()
    assert mgr.steps() == [2, 4]
    mgr.flush()
    ck = mgr.latest()
    assert ck.step == 4
    assert torch.equal(ck.space.values["value"], space.values["value"])
    assert set(mgr.last_save) >= {"stage_s", "write_s", "bytes", "step"}


def test_async_snapshot_isolated_from_later_mutation(tmp_path):
    """The staged save holds its own host bytes: neither a rebound channel
    nor an in-place update of the very tensor before the writer joins
    reaches the checkpoint (a CPU tensor's bytes are copied, not
    shared)."""
    space = random_space(8, 8)
    mgr = CheckpointManager(str(tmp_path / "ck"), layout="sharded",
                            async_writes=True, device="cpu")
    want = space.values["value"].clone()
    mgr.save(space, step=1)
    space.values["value"].mul_(2.0)
    space.values["value"] = space.values["value"] * 2.0
    mgr.flush()
    assert torch.equal(mgr.latest().space.values["value"], want)


def test_async_requires_sharded_layout(tmp_path):
    with pytest.raises(ValueError, match="sharded"):
        CheckpointManager(str(tmp_path), async_writes=True)


def test_async_write_failure_surfaces_and_falls_back(tmp_path, monkeypatch):
    space = random_space(6, 6)
    mgr = CheckpointManager(str(tmp_path / "ck"), layout="sharded",
                            async_writes=True, device="cpu")
    mgr.save(space, step=1)
    mgr.flush()
    orig = sh.StagedShardSave.write

    def boom(self):
        raise OSError("disk full")

    monkeypatch.setattr(sh.StagedShardSave, "write", boom)
    mgr.save(space, step=2)
    with pytest.raises(OSError, match="disk full"):
        mgr.flush()
    monkeypatch.setattr(sh.StagedShardSave, "write", orig)
    assert mgr.steps() == [1]
    assert mgr.latest().step == 1
    mgr.save(space, step=3)
    mgr.flush()
    assert mgr.steps() == [1, 3]
    assert not (tmp_path / "ck" / "ckpt_0000000002.ckpt").exists()


def test_supervised_run_with_async_manager(tmp_path):
    """The final state is durable (the run's last flush) and a resumed run
    is bit for bit the uninterrupted one. JAX's run fails here, so the port
    is held to its own uninterrupted run."""
    space = random_space(16, 16)
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=3, layout="sharded",
                            async_writes=True, device="cpu")
    res = supervised_run(model(), space, mgr, steps=6, every=2,
                         executor=mt.SerialExecutor())
    assert res.step == 6 and mgr.steps()[-1] == 6
    mgr2 = CheckpointManager(str(tmp_path / "ck"), keep=3, layout="sharded",
                             async_writes=True, device="cpu")
    res2 = supervised_run(model(), space, mgr2, steps=10, every=2,
                          executor=mt.SerialExecutor())
    assert torch.equal(res2.space.values["value"],
                       uninterrupted(space, 10).values["value"])


class DiesAtStep4:
    comm_size = 1

    def __init__(self):
        self.inner = mt.SerialExecutor()
        self.done = 0

    def run_model(self, m, s, k):
        if self.done >= 2:
            raise RuntimeError("chip gone")
        self.done += 1
        return self.inner.run_model(m, s, k)


def test_async_manager_flushes_on_run_failure(tmp_path):
    """A run that fails does not strand its last good step staged: the
    supervisor's final flush commits it. JAX's run fails before this
    point, so the port is held to the contract alone."""
    mgr = CheckpointManager(str(tmp_path / "ck"), layout="sharded",
                            async_writes=True, device="cpu")
    with pytest.raises(SimulationFailure):
        supervised_run(model(6.0), random_space(8, 8), mgr, steps=6, every=2,
                       max_failures=1, executor=DiesAtStep4())
    assert mgr.steps()[-1] == 4


def test_async_flush_failure_propagates_on_successful_run(tmp_path,
                                                          monkeypatch):
    mgr = CheckpointManager(str(tmp_path / "ck"), layout="sharded",
                            async_writes=True, device="cpu")
    orig = sh.StagedShardSave.write

    def fail_step4(self):
        if self.manifest["step"] == 4:
            raise OSError("disk full at the end")
        orig(self)

    monkeypatch.setattr(sh.StagedShardSave, "write", fail_step4)
    with pytest.raises(OSError, match="disk full"):
        supervised_run(model(4.0), random_space(8, 8), mgr, steps=4, every=2,
                       executor=mt.SerialExecutor())
    assert mgr.steps()[-1] == 2


def test_supervised_run_flushes_preexisting_staged_save(tmp_path):
    space = random_space(8, 8)
    mgr = CheckpointManager(str(tmp_path / "ck"), layout="sharded",
                            async_writes=True, device="cpu")
    mgr.save(space, step=10)
    with pytest.raises(ValueError, match="step 10 > requested total 4"):
        supervised_run(model(4.0), space, mgr, steps=4, every=2,
                       executor=mt.SerialExecutor())
    assert mgr.steps() == [10]


def test_async_flush_failure_propagates_inside_caller_except(tmp_path,
                                                             monkeypatch):
    mgr = CheckpointManager(str(tmp_path / "ck"), layout="sharded",
                            async_writes=True, device="cpu")
    orig = sh.StagedShardSave.write

    def fail_step4(self):
        if self.manifest["step"] == 4:
            raise OSError("disk full")
        orig(self)

    monkeypatch.setattr(sh.StagedShardSave, "write", fail_step4)
    with pytest.raises(OSError, match="disk full"):
        try:
            raise KeyError("caller's own handled error")
        except KeyError:
            supervised_run(model(4.0), random_space(8, 8), mgr, steps=4,
                           every=2, executor=mt.SerialExecutor())


def test_supervised_resume_restores_onto_executor_mesh(tmp_path):
    """The supervisor saves one piece a block of the executor's mesh and
    resumes through it: the manager's ``latest`` gets the mesh, the run
    resumes at step 4, and ends bit for bit the uninterrupted sharded
    run. JAX's run fails here, so the port is held to itself."""
    mesh = make_mesh(4, devices=[CPU] * 4)
    space = random_space(16, 16)
    d = str(tmp_path / "ck")
    supervised_run(model(8.0), space,
                   CheckpointManager(d, layout="sharded", device="cpu"),
                   steps=4, every=2, executor=ShardMapExecutor(mesh))
    assert len(piece_table(os.path.join(d, "ckpt_0000000004.ckpt"))) == 4
    seen = {}

    class Recording(CheckpointManager):
        def latest(self, **kw):
            ck = super().latest(**kw)
            seen.update(kw=kw, step=ck.step if ck else None)
            return ck

    res = supervised_run(model(8.0), space,
                         Recording(d, layout="sharded", device="cpu"),
                         steps=8, every=2, executor=ShardMapExecutor(mesh))
    assert seen["kw"].get("mesh") is mesh and seen["step"] == 4
    want = uninterrupted(space, 8, ShardMapExecutor(mesh))
    assert torch.equal(res.space.values["value"], want.values["value"])


def test_sharded_restore_with_per_channel_specs(tmp_path):
    """A per-channel spec: each channel reads through its own layout (an
    uncut auxiliary channel beside the cut grid)."""
    mesh = cpu_mesh_2d(2, 4)
    space = random_space(16, 32, attrs=("value", "aux"))
    path = sh.save_checkpoint_sharded(str(tmp_path / "ck.ckpt"), space,
                                      mesh=mesh)
    ck = sh.load_checkpoint_sharded(path, mesh=mesh,
                                    spec={"value": ("x", "y"), "aux": ()})
    for k in ("value", "aux"):
        assert torch.equal(ck.space.values[k], space.values[k])
    with pytest.raises(ValueError, match="axes"):
        sh.load_checkpoint_sharded(path, mesh=mesh, spec=("z",))


def test_cut_async_sharded_run_resumes_bit_for_bit(tmp_path):
    """A 2x2 sharded run under async per-shard checkpoints, cut by a
    failure it may not recover from, resumes from the newest manifest and
    ends bit for bit the uninterrupted run (the CPU form of the card's
    K2 check)."""
    mesh = cpu_mesh_2d(2, 2)
    space = random_space(16, 16)
    d = str(tmp_path / "ck")

    class DiesAfter(ShardMapExecutor):
        calls = 0

        def run_model(self, m, s, k):
            DiesAfter.calls += 1
            if DiesAfter.calls == 3:
                raise RuntimeError("card lost")
            return super().run_model(m, s, k)

    mgr = CheckpointManager(d, layout="sharded", async_writes=True,
                            device="cpu")
    with pytest.raises(SimulationFailure):
        supervised_run(model(8.0), space, mgr, steps=8, every=2,
                       max_failures=0, executor=DiesAfter(mesh))
    assert mgr.steps() == [0, 2, 4]
    assert len(piece_table(os.path.join(d, "ckpt_0000000004.ckpt"))) == 4
    mgr2 = CheckpointManager(d, layout="sharded", async_writes=True,
                             device="cpu")
    res = supervised_run(model(8.0), space, mgr2, steps=8, every=2,
                         executor=ShardMapExecutor(mesh))
    want = uninterrupted(space, 8, ShardMapExecutor(mesh))
    assert torch.equal(res.space.values["value"], want.values["value"])


# -- across the two packages ---------------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_jax_mesh_sharded_save_restores_in_the_port(tmp_path, eight_devices,
                                                    dtype):
    """The JAX package's save of a 2x2 mesh-sharded array (``device_put``
    over four virtual devices, no step) restores in the port bit for bit,
    whole and through the port's 2x2 mesh, with the same piece table the
    port's own save of those values writes."""
    jm = jmesh_mod.make_mesh_2d(2, 2, devices=eight_devices[:4])
    jspace = jmesh_mod.shard_space(jax_space(16, 16, dtype, ("a", "b")), jm)
    path = jsh.save_checkpoint_sharded(str(tmp_path / "j.ckpt"), jspace,
                                       step=7, extra={"x": 2})
    mesh = cpu_mesh_2d(2, 2)
    for kw in ({"device": "cpu"}, {"mesh": mesh}):
        ck = sh.load_checkpoint_sharded(path, **kw)
        assert ck.step == 7 and ck.extra == {"x": 2}
        for k in ("a", "b"):
            assert ck.space.values[k].dtype == DTYPES[dtype][0]
            np.testing.assert_array_equal(bits(ck.space.values[k]),
                                          bits(jspace.values[k]))
    ppath = sh.save_checkpoint_sharded(
        str(tmp_path / "p.ckpt"), random_space(16, 16, dtype, ("a", "b")),
        step=7, mesh=mesh)
    assert piece_table(ppath) == piece_table(path)


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_port_mesh_save_restores_in_jax(tmp_path, eight_devices, dtype):
    """The port's 2x2 save restores in the JAX package bit for bit, whole
    and onto a JAX 2x2 mesh."""
    space = random_space(16, 16, dtype, ("a", "b"))
    path = sh.save_checkpoint_sharded(str(tmp_path / "p.ckpt"), space,
                                      step=3, mesh=cpu_mesh_2d(2, 2))
    jm = jmesh_mod.make_mesh_2d(2, 2, devices=eight_devices[:4])
    for kw in ({}, {"mesh": jm}):
        jck = jsh.load_checkpoint_sharded(path, **kw)
        assert jck.step == 3
        for k in ("a", "b"):
            np.testing.assert_array_equal(bits(jck.space.values[k]),
                                          bits(space.values[k]))


# -- chaos: torn shard files and manifests ------------------------------------

def test_torn_sharded_checkpoint_resume_falls_back(tmp_path):
    """A torn shard file at step 8 (the JAX package's
    ``test_chaos.py:246``): resume warns, falls back past it, and ends bit
    for bit the uninterrupted run (JAX's run fails; held to the port's)."""
    space = random_space(8, 8)
    want = uninterrupted(space, 8)
    mgr = CheckpointManager(str(tmp_path), keep=10, layout="sharded",
                            device="cpu")
    plan = FaultPlan((Fault("torn", at=8, tear="truncate", offset=100),))
    with inject.armed(plan) as st:
        supervised_run(model(8.0), space, mgr, steps=8, every=2,
                       executor=mt.SerialExecutor())
    assert [f["kind"] for f in st.fired] == ["torn"]
    mgr2 = CheckpointManager(str(tmp_path), keep=10, layout="sharded",
                             device="cpu")
    with pytest.warns(RuntimeWarning, match="failed verification"):
        res = supervised_run(model(8.0), random_space(8, 8), mgr2, steps=8,
                             every=2, executor=mt.SerialExecutor())
    assert res.step == 8
    assert torch.equal(res.space.values["value"], want.values["value"])


def test_torn_sharded_manifest_falls_back(tmp_path):
    """A corrupted manifest, the commit record itself (``:265``): the step
    is unreadable, resume falls back past it."""
    space = random_space(8, 8)
    want = uninterrupted(space, 8)
    mgr = CheckpointManager(str(tmp_path), keep=10, layout="sharded",
                            device="cpu")
    plan = FaultPlan((Fault("torn", at=8, channel="manifest",
                            tear="corrupt", offset=4),))
    with inject.armed(plan) as st:
        supervised_run(model(8.0), space, mgr, steps=8, every=2,
                       executor=mt.SerialExecutor())
    assert [f["kind"] for f in st.fired] == ["torn"]
    mgr2 = CheckpointManager(str(tmp_path), keep=10, layout="sharded",
                             device="cpu")
    with pytest.warns(RuntimeWarning, match="failed verification"):
        res = supervised_run(model(8.0), random_space(8, 8), mgr2, steps=8,
                             every=2, executor=mt.SerialExecutor())
    assert res.step == 8
    assert torch.equal(res.space.values["value"], want.values["value"])


# -- the CLI ------------------------------------------------------------------

def test_cli_sharded_async_checkpoints(tmp_path, capsys):
    """``--checkpoint-layout=sharded --async-checkpoints`` from the CLI (the
    JAX package's ``test_cli.py:124``), sharded over a 2x2 mesh: the run
    writes per-shard directories of 4 pieces, and a longer run resumes from
    them."""
    d = str(tmp_path / "ck")
    args = ["run", "--device=cpu", "--dimx=16", "--dimy=16",
            "--dtype=float64", "--flow=diffusion", "--steps=6",
            "--mesh=2x2", f"--checkpoint-dir={d}", "--checkpoint-every=2",
            "--checkpoint-layout=sharded", "--async-checkpoints", "--json"]
    assert tcli.main(args) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["conserved"] is True
    assert row["checkpoint_layout"] == "sharded"
    names = sorted(os.listdir(d))
    assert any(n.endswith(".ckpt") for n in names), names
    assert len(piece_table(os.path.join(d, names[-1]))) == 4
    args2 = [a if not a.startswith("--steps") else "--steps=10"
             for a in args]
    assert tcli.main(args2) == 0
    row2 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row2["steps"] == 10 and row2["conserved"] is True
    assert row2["checkpoint_steps"][-1] == 10


def test_cli_async_requires_sharded_layout(tmp_path):
    """The JAX package's guard (``test_cli.py:151``), message for message."""
    from mpi_model_tpu import cli as jcli

    argv = ["run", "--dimx=8", "--dimy=8", f"--checkpoint-dir={tmp_path}",
            "--async-checkpoints"]
    with pytest.raises(SystemExit, match="sharded") as got:
        tcli.main(argv + ["--device=cpu"])
    with pytest.raises(SystemExit) as want:
        jcli.main(argv)
    assert str(got.value) == str(want.value)


# -- the one-process queries ---------------------------------------------------

def test_multihost_one_process_values():
    """One process: rank 0 of 1, the master, the caller's vote, a barrier
    that waits for no one, and ``master_only`` reaching its barrier even
    when its body raises."""
    assert multihost.process_index() == 0
    assert multihost.process_count() == 1
    assert multihost.is_master() is True
    assert multihost.all_agree(True) is True
    assert multihost.all_agree(False) is False
    assert multihost.sync("x") is None
    with multihost.master_only("b") as master:
        assert master is True
    reached = []
    orig = multihost.sync

    def record(name="barrier"):
        reached.append(name)
        return orig(name)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(multihost, "sync", record)
        with pytest.raises(OSError):
            with multihost.master_only("after-raise"):
                raise OSError("disk")
    assert reached == ["after-raise"]


@pytest.mark.parametrize("query", ["process_index", "process_count",
                                   "is_master", "all_agree", "sync",
                                   "master_only"])
def test_multihost_refuses_a_world_above_one(monkeypatch, query):
    """Under a ``torch.distributed`` world of two processes no query
    answers for one process while others wait: the rank and size come from
    the group, and the vote, the barrier and ``master_only``'s barrier are
    collectives of the group (here recorded, on rank 1 of 2)."""
    import torch.distributed as dist

    calls = []

    def all_reduce(t, op=None, **kw):
        calls.append(("all_reduce", op))
        if op == dist.ReduceOp.MIN:
            t.zero_()  # the peer voted no

    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 2)
    monkeypatch.setattr(dist, "get_rank", lambda *a, **k: 1)
    monkeypatch.setattr(dist, "get_backend", lambda *a, **k: "gloo")
    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    fn = getattr(multihost, query)
    if query == "master_only":
        with fn("b") as master:
            assert master is False
        assert calls == [("all_reduce", None)]
    elif query == "all_agree":
        assert fn(True) is False
        assert calls == [("all_reduce", dist.ReduceOp.MIN)]
    elif query == "sync":
        assert fn() is None
        assert calls == [("all_reduce", None)]
    else:
        assert fn() == {"process_index": 1, "process_count": 2,
                        "is_master": False}[query]
        assert calls == []
    # a world of one is one process
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 1)
    assert multihost.process_count() == 1
