"""The port's dense checkpoints (``io/checkpoint.py``) on the CPU: the file
format against the JAX package's (a checkpoint written by either package
restores bit for bit in the other, CRCs equal, f32/f64/bf16/int32/bool
channels), the copied ``_atomic_write`` against JAX's, and the port's
versions of JAX's checkpoint cases (``tests/test_io.py``,
``tests/test_chaos.py``'s dense integrity rows). Runs are held bit for bit
to the port's own uninterrupted runs."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mpi_model_tpu as mm
from mpi_model_tpu.io import checkpoint as jck
from mpi_model_tpu.io import sharded as jsharded

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch.io import (CheckpointManager, load_checkpoint,
                                    run_checkpointed, save_checkpoint)
from mpi_model_tpu_torch.io import checkpoint as ck
from mpi_model_tpu_torch.io.checkpoint import CheckpointCorruptionError
from mpi_model_tpu_torch.resilience import inject, supervised_run
from mpi_model_tpu_torch.resilience.inject import Fault, FaultPlan

CPU = torch.device("cpu")
RNG = np.random.default_rng(11)

#: dtype name → (port dtype, JAX dtype, host values of a 12×17 channel)
DTYPES = {
    "float32": (torch.float32, jnp.float32),
    "float64": (torch.float64, jnp.float64),
    "bfloat16": (torch.bfloat16, jnp.bfloat16),
    "int32": (torch.int32, jnp.int32),
    "bool": (torch.bool, jnp.bool_),
}


def _host(name: str, shape=(12, 17), seed=3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if name == "int32":
        return rng.integers(-1000, 1000, shape).astype(np.int32)
    if name == "bool":
        return rng.uniform(size=shape) < 0.4
    return rng.uniform(0.5, 2.0, shape)


def _port_channel(name, v):
    tdt = DTYPES[name][0]
    t = torch.from_numpy(np.ascontiguousarray(v))
    return t.to(tdt)


def _jax_channel(name, v):
    return jnp.asarray(v, dtype=DTYPES[name][1])


def _bits(x) -> np.ndarray:
    """Raw bytes of a port tensor or a JAX/numpy array."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().reshape(-1)
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def port_space(vals: dict, **geom):
    h, w = next(iter(vals.values())).shape
    return mt.CellularSpace(dict(vals), h, w, **geom)


def random_space(h, w, dtype=torch.float64, attrs=("value",)):
    vals = {a: torch.from_numpy(RNG.uniform(0.5, 2.0, (h, w))).to(dtype)
            for a in attrs}
    return port_space(vals)


def _meta(path) -> dict:
    with np.load(path) as z:
        return json.loads(bytes(z["meta"]).decode("utf-8"))


# -- the format against the JAX package's ---------------------------------------

@pytest.mark.parametrize("name", list(DTYPES))
def test_jax_checkpoint_restores_bit_for_bit_in_the_port(tmp_path, name):
    v = _host(name)
    js = mm.CellularSpace({"a": _jax_channel(name, v),
                           "b": _jax_channel("float64", _host("float64"))},
                          12, 17, 3, 4, 40, 50)
    path = jck.save_checkpoint(str(tmp_path / "j.npz"), js, step=5,
                               extra={"note": "from jax"})
    got = load_checkpoint(path, device="cpu")
    assert got.step == 5 and got.extra == {"note": "from jax"}
    assert (got.space.x_init, got.space.y_init) == (3, 4)
    assert got.space.global_shape == (40, 50)
    t = got.space.values["a"]
    assert t.dtype == DTYPES[name][0] and t.device == CPU
    np.testing.assert_array_equal(_bits(t), _bits(js.values["a"]))
    np.testing.assert_array_equal(_bits(got.space.values["b"]),
                                  _bits(js.values["b"]))


@pytest.mark.parametrize("name", list(DTYPES))
def test_port_checkpoint_restores_bit_for_bit_in_jax(tmp_path, name):
    v = _host(name)
    sp = port_space({"a": _port_channel(name, v)}, x_init=2,
                    global_dim_x=30, global_dim_y=17)
    path = save_checkpoint(str(tmp_path / "p.npz"), sp, step=9,
                           extra={"k": [1, 2]})
    got = jck.load_checkpoint(path)
    assert got.step == 9 and got.extra == {"k": [1, 2]}
    assert got.space.x_init == 2 and got.space.global_shape == (30, 17)
    assert got.space.values["a"].dtype == jnp.dtype(DTYPES[name][1])
    np.testing.assert_array_equal(_bits(got.space.values["a"]),
                                  _bits(sp.values["a"]))


@pytest.mark.parametrize("name", list(DTYPES))
def test_channel_records_and_crcs_equal_jax(tmp_path, name):
    v = _host(name)
    jp = jck.save_checkpoint(str(tmp_path / "j.npz"), mm.CellularSpace(
        {"a": _jax_channel(name, v)}, 12, 17), step=1)
    pp = save_checkpoint(str(tmp_path / "p.npz"),
                         port_space({"a": _port_channel(name, v)}), step=1)
    jm, pm = _meta(jp), _meta(pp)
    assert jm == pm  # dtype name, shape, CRC32, geometry, step, extra
    with np.load(jp) as jz, np.load(pp) as pz:
        assert sorted(jz.files) == sorted(pz.files)
        np.testing.assert_array_equal(jz["ch:a"], pz["ch:a"])


def test_jax_manager_run_resumes_in_the_port(tmp_path):
    """A checkpoint directory a JAX manager wrote: the port's supervisor
    resumes from its newest step and finishes bit for bit the port's
    uninterrupted run."""
    v = RNG.uniform(0.5, 2.0, (16, 16))
    sp = port_space({"value": torch.from_numpy(v)})
    model = mt.Model(mt.Diffusion(0.1), 10.0, 1.0)
    mid, _ = model.execute(sp, steps=4)
    jmgr = jck.CheckpointManager(str(tmp_path), keep=5)
    jmid = mm.CellularSpace({"value": jnp.asarray(
        mid.values["value"].numpy())}, 16, 16)
    jmgr.save(jmid, 4, extra={"initial_totals": {"value": float(
        sp.total("value"))}})
    res = supervised_run(model, sp, CheckpointManager(str(tmp_path)),
                         steps=10, every=3)
    want, _ = model.execute(sp, steps=10)
    assert res.step == 10
    assert torch.equal(res.space.values["value"], want.values["value"])


# -- the copied _atomic_write --------------------------------------------------

@pytest.mark.parametrize("impl", ["port", "jax"])
def test_atomic_write_writes_and_cleans_up_like_jax(tmp_path, impl):
    write = ck._atomic_write if impl == "port" else jsharded._atomic_write
    path = str(tmp_path / "f.bin")
    write(path, lambda f: f.write(b"first"))
    assert open(path, "rb").read() == b"first"
    assert os.listdir(tmp_path) == ["f.bin"]

    def broken(f):
        f.write(b"half")
        raise OSError("disk full")

    with pytest.raises(OSError, match="disk full"):
        write(path, broken)
    # the old file is untouched and no temporary file is left behind
    assert open(path, "rb").read() == b"first"
    assert os.listdir(tmp_path) == ["f.bin"]
    # the replace is atomic: a second write swaps the whole file
    write(path, lambda f: f.write(b"second!"))
    assert open(path, "rb").read() == b"second!"


def test_atomic_write_copy_matches_the_original_source():
    import inspect

    def body(fn):
        src = inspect.getsource(fn)
        return src[src.index("d = os.path"):]

    assert body(ck._atomic_write) == body(jsharded._atomic_write)


# -- the port's checkpoint cases -------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
def test_checkpoint_roundtrip_bit_exact(tmp_path, dtype):
    space = random_space(12, 17, dtype=dtype, attrs=("a", "b"))
    path = save_checkpoint(str(tmp_path / "ck.npz"), space, step=7,
                           extra={"note": "hello"})
    got = load_checkpoint(path, device="cpu")
    assert got.step == 7 and got.extra == {"note": "hello"}
    assert got.space.shape == space.shape
    for k in ("a", "b"):
        assert got.space.values[k].dtype == dtype
        np.testing.assert_array_equal(_bits(got.space.values[k]),
                                      _bits(space.values[k]))


def test_checkpoint_preserves_partition_geometry(tmp_path):
    space = mt.CellularSpace.create(10, 10, 1.0, dtype="float64", x_init=20,
                                    y_init=30, global_dim_x=100,
                                    global_dim_y=100, device="cpu")
    got = load_checkpoint(save_checkpoint(str(tmp_path / "p.npz"), space),
                          device="cpu")
    assert (got.space.x_init, got.space.y_init) == (20, 30)
    assert got.space.global_shape == (100, 100)
    assert got.space.is_partition


def test_restore_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint("unused.npz")


def test_resume_equivalence(tmp_path):
    """5 steps + checkpoint + restore + 5 steps == 10 straight steps."""
    space = random_space(20, 24)
    model = mt.Model(mt.Diffusion(0.15), 10.0, 1.0)
    straight, _ = model.execute(space, steps=10)
    half, _ = model.execute(space, steps=5)
    path = save_checkpoint(str(tmp_path / "half.npz"), half, step=5)
    restored = load_checkpoint(path, device="cpu")
    assert restored.step == 5
    resumed, _ = model.execute(restored.space, steps=5)
    assert torch.equal(resumed.values["value"], straight.values["value"])


def test_run_checkpointed_resumes_from_latest(tmp_path):
    space = random_space(16, 16)
    model = mt.Model(mt.Diffusion(0.1), 10.0, 1.0)
    mgr = CheckpointManager(str(tmp_path / "ckpts"), keep=2, device="cpu")
    out6, step6, _ = run_checkpointed(model, space, mgr, steps=6, every=2)
    assert step6 == 6 and mgr.steps() == [4, 6]  # pruned to keep=2
    out10, step10, _ = run_checkpointed(model, space, mgr, steps=10,
                                        every=2)
    assert step10 == 10
    want, _ = model.execute(space, steps=10)
    assert torch.equal(out10.values["value"], want.values["value"])
    with pytest.raises(ValueError, match="checkpoint"):
        run_checkpointed(model, space, mgr, steps=5)


def test_save_records_its_timings(tmp_path):
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    path = mgr.save(random_space(8, 8), 3)
    ls = mgr.last_save
    assert ls["step"] == 3 and ls["path"] == path
    assert ls["bytes"] == os.path.getsize(path)
    assert all(ls[k] >= 0.0 for k in ("copy_s", "crc_s", "write_s"))


def test_manager_prefers_configured_layout_when_both_exist(tmp_path):
    sp = random_space(16, 16)
    full = CheckpointManager(str(tmp_path), keep=10, device="cpu")
    full.save(sp, 2)
    later = sp.with_values({"value": sp.values["value"] + 1.0})
    delta = CheckpointManager(str(tmp_path), keep=10, layout="delta",
                              delta_tile=(8, 8), device="cpu")
    delta.save(later, 2)
    with pytest.warns(UserWarning, match="BOTH layouts"):
        got = delta.restore(2)
    assert torch.equal(got.space.values["value"], later.values["value"])
    with pytest.warns(UserWarning, match="BOTH layouts"):
        got = full.restore(2)
    assert torch.equal(got.space.values["value"], sp.values["value"])


@pytest.mark.parametrize("kw,err", [
    ({"layout": "sharded"}, NotImplementedError),
    ({"layout": "sharded", "async_writes": True}, NotImplementedError),
    ({"async_writes": True}, ValueError),
    ({"layout": "zip"}, ValueError),
    ({"keyframe_every": 0}, ValueError),
])
def test_manager_refusals(tmp_path, monkeypatch, kw, err):
    """Bad arguments are refused as the JAX package refuses them. The
    sharded layout and its asynchronous writes (the ``NotImplementedError``
    rows, which a world above one process once refused) run in a
    ``torch.distributed`` world of two: on rank 1 (the group's collectives
    recorded, every peer agreeing) a save writes this process's own shard
    file and leaves the commit, the manifest, to the master."""
    if err is not NotImplementedError:
        with pytest.raises(err, match="layout|keyframe"):
            CheckpointManager(str(tmp_path), **kw)
        return
    import torch.distributed as dist

    mgr = CheckpointManager(str(tmp_path), device="cpu", **kw)
    sp = mt.CellularSpace.create(8, 8, 1.0, dtype="float64", device="cpu")
    reduced = []
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 2)
    monkeypatch.setattr(dist, "get_rank", lambda *a, **k: 1)
    monkeypatch.setattr(dist, "get_backend", lambda *a, **k: "gloo")
    monkeypatch.setattr(dist, "all_reduce",
                        lambda t, op=None, **k: reduced.append(op))
    path = mgr.save(sp, 0)
    mgr.flush()
    assert mgr.steps() == []
    assert sorted(os.listdir(path)) == ["shards_p00001.npz"]
    assert dist.ReduceOp.MIN in reduced and None in reduced


def test_prune_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, device="cpu")
    sp = random_space(8, 8)
    for s in (1, 2, 3, 4):
        mgr.save(sp, s)
    assert mgr.steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ["ckpt_0000000003.npz",
                                            "ckpt_0000000004.npz"]


# -- integrity: CRCs, torn writes, verified fallback ---------------------------

def make_model(time=8.0):
    return mt.Model(mt.Diffusion(0.1), time=time, time_step=1.0)


def test_checksums_written_and_roundtrip(tmp_path):
    space = random_space(12, 16)
    path = save_checkpoint(str(tmp_path / "c.npz"), space, step=3)
    assert all("crc32" in c for c in _meta(path)["channels"].values())
    got = load_checkpoint(path, device="cpu")
    assert torch.equal(got.space.values["value"], space.values["value"])


def test_corrupt_dense_checkpoint_fails_crc(tmp_path):
    path = save_checkpoint(str(tmp_path / "c.npz"), random_space(12, 16),
                           step=3)
    inject.tear_file(path, offset=300, nbytes=16, tear="corrupt")
    with pytest.raises(CheckpointCorruptionError, match="CRC"):
        load_checkpoint(path, device="cpu")


@pytest.mark.parametrize("tear,offset", [("truncate", 128),
                                         ("corrupt", 300)])
def test_torn_dense_checkpoint_resume_falls_back(tmp_path, tear, offset):
    """Corrupt-latest resume lands on the newest verified checkpoint and the
    run completes bit for bit."""
    space, model = random_space(12, 16), make_model()
    want, _ = model.execute(space, steps=8)
    mgr = CheckpointManager(str(tmp_path), keep=10, device="cpu")
    plan = FaultPlan((Fault("torn", at=8, tear=tear, offset=offset),))
    with inject.armed(plan) as st:
        supervised_run(model, space, mgr, steps=8, every=2)
    assert [f["kind"] for f in st.fired] == ["torn"]
    mgr2 = CheckpointManager(str(tmp_path), keep=10, device="cpu")
    with pytest.warns(RuntimeWarning, match="failed verification"):
        res = supervised_run(model, space, mgr2, steps=8, every=2)
    assert res.step == 8
    assert torch.equal(res.space.values["value"], want.values["value"])


def test_all_checkpoints_corrupt_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=10, device="cpu")
    for step in (2, 4):
        inject.tear_file(mgr.save(random_space(8, 8), step), offset=0,
                         tear="truncate")
    with pytest.warns(RuntimeWarning, match="failed verification"):
        with pytest.raises(CheckpointCorruptionError,
                           match="no verifiable checkpoint"):
            mgr.latest()


def test_explicit_restore_of_corrupt_step_propagates(tmp_path):
    space = random_space(8, 8)
    mgr = CheckpointManager(str(tmp_path), keep=10, device="cpu")
    mgr.save(space, 2)
    inject.tear_file(mgr.save(space, 4), offset=0, tear="truncate")
    with pytest.warns(RuntimeWarning):
        assert mgr.latest().step == 2
    with pytest.raises(CheckpointCorruptionError):
        mgr.restore(4)


def test_resume_checkpoint_without_initial_totals(tmp_path):
    space, model = random_space(12, 16), make_model()
    mid, _ = model.execute(space, steps=4)
    mgr = CheckpointManager(str(tmp_path), keep=10, device="cpu")
    save_checkpoint(mgr.path_for(4), mid, step=4, extra={})
    res = supervised_run(model, space, mgr, steps=8, every=2)
    assert res.step == 8 and set(res.initial_totals) == {"value"}
    want, _ = model.execute(mid, steps=4)
    assert torch.equal(res.space.values["value"], want.values["value"])


def test_latest_on_an_empty_directory_is_none(tmp_path):
    (tmp_path / "ckpt_0000000004.ckpt").mkdir()  # not a layout read here
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    assert mgr.latest() is None
    res = supervised_run(make_model(), random_space(8, 8), mgr, steps=4,
                         every=2)
    assert res.step == 4


# -- the CLI's checkpoint flags ----------------------------------------------------

def _cli(argv):
    from mpi_model_tpu_torch.cli import main

    return main(["run", "--device=cpu"] + argv)


@pytest.mark.parametrize("argv,msg", [
    (["--checkpoint-layout=delta"], "add --checkpoint-dir"),
    (["--async-checkpoints"], "requires --checkpoint-layout=sharded"),
    (["--checkpoint-dir=X", "--keyframe-every=4"],
     "--keyframe-every sets the delta chain"),
    (["--checkpoint-dir=X", "--checkpoint-layout=delta",
      "--keyframe-every=0"], "must be >= 1"),
    # the sharded layout runs (tests/test_torch_sharded_checkpoint.py), and
    # with the AutoShardedExecutor too, as the JAX CLI runs it (msg None:
    # the run exits 0, X a fresh directory)
    (["--checkpoint-dir=X", "--checkpoint-layout=sharded", "--mesh=2x1",
      "--executor=gspmd", "--flow=diffusion", "--steps=4",
      "--checkpoint-every=2"], None),
    (["--checkpoint-dir=X", "--checkpoint-layout=sharded",
      "--async-checkpoints", "--mesh=2x1", "--executor=gspmd",
      "--flow=diffusion", "--steps=4", "--checkpoint-every=2"], None),
    (["--ensemble=2", "--checkpoint-dir=X"], "ensemble"),
    (["--serve", "--checkpoint-dir=X"], "--serve does not compose"),
])
def test_cli_checkpoint_flag_checks(argv, msg, tmp_path):
    if msg is None:
        assert _cli([a.replace("=X", f"={tmp_path / 'ckpt'}")
                     for a in argv]) == 0
        return
    with pytest.raises(SystemExit, match=msg):
        _cli(argv)


@pytest.mark.parametrize("layout", ["full", "delta"])
def test_cli_checkpointed_run_resumes(tmp_path, capsys, layout):
    argv = ["--flow=diffusion", "--dimx=32", "--dimy=32", "--impl=active",
            "--blob=0.05", f"--checkpoint-dir={tmp_path}",
            "--checkpoint-every=2", f"--checkpoint-layout={layout}",
            "--json"]
    assert _cli(argv + ["--steps=4"]) == 0
    first = json.loads(capsys.readouterr().out)
    assert first["checkpoint_steps"][-1] == 4
    assert _cli(argv + ["--steps=8"]) == 0
    row = json.loads(capsys.readouterr().out)
    assert row["conserved"] and row["checkpoint_steps"][-1] == 8
    assert row["checkpoint_layout"] == layout
    # resumed at 4: the second run ran only the last 4 steps
    assert row["recovered_failures"] == 0 and row["events"] == []
