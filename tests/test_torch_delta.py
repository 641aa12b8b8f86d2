"""The port's delta chain and live migration (``io/delta.py``) on the CPU:
chains (keyframes, delta records, manifest) written by either package replay
in the other bit for bit, the migration wire pieces of either package
materialize in the other, and the port's versions of JAX's
``tests/test_delta.py`` and the delta rows of ``tests/test_chaos.py``.
Every restore and every handoff is held bit for bit to the port's own
uninterrupted run (serial and on CPU shards)."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mpi_model_tpu as mm
from mpi_model_tpu.io import delta as jdelta

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch.io import (CheckpointManager, MigrationError,
                                    migrate_scenario, run_checkpointed,
                                    transfer_space)
from mpi_model_tpu_torch.io import delta as dmod
from mpi_model_tpu_torch.io.checkpoint import CheckpointCorruptionError
from mpi_model_tpu_torch.io.delta import DeltaChain
from mpi_model_tpu_torch.ops.active import changed_tile_map, plan_for
from mpi_model_tpu_torch.parallel import (ShardMapExecutor, make_mesh,
                                          make_mesh_2d)
from mpi_model_tpu_torch.resilience import inject, supervised_run
from mpi_model_tpu_torch.resilience.inject import Fault, FaultPlan

CPU = torch.device("cpu")
RNG = np.random.default_rng(7)
G = 64
TILE = (8, 8)
SEED_BLOCK = RNG.uniform(0.5, 2.0, (4, 4))


def sparse_np(g=G, lo=4, hi=8, roll=0) -> np.ndarray:
    v = np.zeros((g, g))
    v[lo:hi, lo:hi] = np.roll(SEED_BLOCK[:hi - lo, :hi - lo], roll, axis=0)
    return v


def sparse_space(g=G, lo=4, hi=8, roll=0, dtype=torch.float64):
    v = torch.from_numpy(sparse_np(g, lo, hi, roll)).to(dtype)
    return mt.CellularSpace({"value": v}, g, g)


def make_model(time=10.0):
    return mt.Model(mt.Diffusion(0.1), time=time, time_step=1.0)


def active_ex():
    return mt.SerialExecutor(step_impl="active", active_opts={"tile": TILE})


def delta_mgr(path, keep=100, keyframe_every=4, **kw):
    return CheckpointManager(str(path), keep=keep, layout="delta",
                             keyframe_every=keyframe_every, delta_tile=TILE,
                             device="cpu", **kw)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().reshape(-1)
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def straight(model, space, steps, executor=None):
    out, _ = model.execute(space, executor, steps=steps,
                           check_conservation=False)
    return out.values["value"]


# -- chains across the two packages ----------------------------------------------

def _states(dtype_name: str, n: int = 5) -> list[dict]:
    """n host states of a sparse 64² field and a bool mask, each a few
    tiles away from the last (a chain with real delta records)."""
    base = sparse_np()
    mask = np.zeros((G, G), bool)
    mask[10:20, 10:20] = True
    out = []
    for i in range(n):
        v = base.copy()
        v[4 + 3 * i, 4 + 5 * i] += 1.0 + i
        m = mask.copy()
        m[30 + i, 30] = True
        out.append({"value": v, "mask": m})
    return out


@pytest.mark.parametrize("dtype_name", ["float64", "float32", "bfloat16"])
def test_jax_chain_replays_bit_for_bit_in_the_port(tmp_path, dtype_name):
    jdt = {"float64": jnp.float64, "float32": jnp.float32,
           "bfloat16": jnp.bfloat16}[dtype_name]
    chain = jdelta.DeltaChain(str(tmp_path), keyframe_every=3, tile=TILE)
    states = _states(dtype_name)
    jspaces = []
    for i, st in enumerate(states):
        js = mm.CellularSpace({"value": jnp.asarray(st["value"], jdt),
                               "mask": jnp.asarray(st["mask"])}, G, G)
        chain.save(js, 2 * i, extra={"i": i})
        jspaces.append(js)
    kinds = [r["kind"] for r in json.load(open(chain.manifest_path))[
        "records"]]
    assert kinds == ["keyframe", "delta", "delta", "keyframe", "delta"]
    port = DeltaChain(str(tmp_path), keyframe_every=3, tile=TILE,
                      device="cpu")
    assert port.steps() == [0, 2, 4, 6, 8]
    for i, js in enumerate(jspaces):
        got = port.restore(2 * i)
        assert got.step == 2 * i and got.extra == {"i": i}
        for k in ("value", "mask"):
            np.testing.assert_array_equal(_bits(got.space.values[k]),
                                          _bits(js.values[k]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
def test_port_chain_replays_bit_for_bit_in_jax(tmp_path, dtype):
    chain = DeltaChain(str(tmp_path), keyframe_every=3, tile=TILE)
    spaces = []
    for i, st in enumerate(_states(str(dtype))):
        sp = mt.CellularSpace({"value": torch.from_numpy(st["value"]).to(
            dtype), "mask": torch.from_numpy(st["mask"])}, G, G)
        chain.save(sp, 2 * i, extra={"i": i})
        spaces.append(sp)
    jchain = jdelta.DeltaChain(str(tmp_path), keyframe_every=3, tile=TILE)
    assert jchain.steps() == [0, 2, 4, 6, 8]
    for i, sp in enumerate(spaces):
        got = jchain.restore(2 * i)
        assert got.step == 2 * i and got.extra == {"i": i}
        for k in ("value", "mask"):
            np.testing.assert_array_equal(_bits(got.space.values[k]),
                                          _bits(sp.values[k]))


def test_records_and_manifest_equal_jax(tmp_path):
    """The same states through both writers: identical manifests and, per
    record, identical meta (piece tables with their CRCs) and payloads."""
    for who in ("jax", "port"):
        (tmp_path / who).mkdir()
    jc = jdelta.DeltaChain(str(tmp_path / "jax"), keyframe_every=3,
                           tile=TILE)
    pc = DeltaChain(str(tmp_path / "port"), keyframe_every=3, tile=TILE)
    for i, st in enumerate(_states("float64")):
        jc.save(mm.CellularSpace({k: jnp.asarray(v) for k, v in st.items()},
                                 G, G), 2 * i)
        pc.save(mt.CellularSpace({k: torch.from_numpy(v)
                                  for k, v in st.items()}, G, G), 2 * i)
    assert (open(jc.manifest_path).read() == open(pc.manifest_path).read())
    for fn in sorted(os.listdir(tmp_path / "jax")):
        if not fn.endswith(".npz"):
            continue
        with np.load(tmp_path / "jax" / fn) as a, \
                np.load(tmp_path / "port" / fn) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                np.testing.assert_array_equal(a[key], b[key])


def test_wire_pieces_materialize_across_the_packages():
    st = _states("float64")[2]
    jvals = {k: np.ascontiguousarray(v) for k, v in st.items()}
    pvals = {k: torch.from_numpy(v) for k, v in st.items()}
    # JAX's keyframe pieces → the port's materialization
    pieces, payload = jdelta._full_pieces(jvals)
    arrays = dmod._new_arrays(jdelta._channels_meta(jvals))
    dmod._apply_pieces(arrays, {"pieces": pieces}, lambda k: payload[k],
                       "jax wire")
    for k in st:
        np.testing.assert_array_equal(_bits(arrays[k]), _bits(jvals[k]))
    # the port's keyframe pieces → JAX's materialization
    pieces, payload = dmod._full_pieces(pvals)
    jarr = jdelta._new_arrays(dmod._channels_meta(pvals))
    jdelta._apply_pieces(jarr, {"pieces": pieces}, lambda k: payload[k],
                         "port wire")
    for k in st:
        np.testing.assert_array_equal(_bits(jarr[k]), _bits(pvals[k]))
    # and the two transfer_space outputs agree bit for bit
    jt = jdelta.transfer_space(mm.CellularSpace(
        {k: jnp.asarray(v) for k, v in st.items()}, G, G))
    pt = transfer_space(mt.CellularSpace(pvals, G, G))
    for k in st:
        np.testing.assert_array_equal(_bits(pt.values[k]),
                                      _bits(jt.values[k]))


# -- dirty-tile sources -----------------------------------------------------------

@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_changed_tile_map_is_exact(kind):
    plan = plan_for((16, 16), tile=(4, 4))
    a = RNG.uniform(0.5, 2.0, (16, 16))
    b = a.copy()
    b[5, 6] += 1.0
    b[12, 0] -= 0.5
    if kind == "tensor":
        a, b = torch.from_numpy(a), torch.from_numpy(b)
    m = changed_tile_map(a, b, plan)
    want = np.zeros((4, 4), bool)
    want[1, 1] = want[3, 0] = True
    np.testing.assert_array_equal(m, want)
    assert not changed_tile_map(a, a, plan).any()


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_changed_tile_map_sees_sign_and_nan_flips(kind):
    plan = plan_for((8, 8), tile=(4, 4))
    a = np.zeros((8, 8))
    b = a.copy()
    b[0, 0] = -0.0
    c = a.copy()
    c[7, 7] = np.nan
    if kind == "tensor":
        a, b, c = (torch.from_numpy(x) for x in (a, b, c))
    assert changed_tile_map(a, b, plan)[0, 0]
    assert changed_tile_map(a, c, plan)[1, 1]
    assert changed_tile_map(c, c, plan).sum() == 0


def test_serial_active_run_exports_dirty_tiles():
    space, model = sparse_space(), make_model()
    ex = active_ex()
    out = straight(model, space, 4, ex)
    dt = ex.last_dirty_tiles
    assert dt is not None and tuple(dt["tile"]) == TILE
    plan = plan_for((G, G), tile=TILE)
    changed = changed_tile_map(space.values["value"], out, plan)
    assert not np.any(changed & ~np.asarray(dt["map"]))
    dense = mt.SerialExecutor(step_impl="xla")
    straight(model, space, 1, dense)
    assert dense.last_dirty_tiles is None


@pytest.mark.parametrize("impl,source", [("active", "executor"),
                                         ("active_fused", "executor"),
                                         ("xla", "diff")])
def test_delta_records_take_dirty_tiles_from_the_executor(tmp_path, impl,
                                                          source):
    model = make_model()
    ex = mt.SerialExecutor(step_impl=impl, active_opts={"tile": TILE})
    mgr = delta_mgr(tmp_path, keyframe_every=8)
    run_checkpointed(model, sparse_space(), mgr, steps=2, every=2,
                     executor=ex)
    ls = mgr.last_save
    assert ls["kind"] == "delta" and ls["dirty_from"] == source
    assert 0 < ls["dirty_tiles"] < plan_for((G, G), tile=TILE).ntiles


# -- chain round trip / replay restore ------------------------------------------

def test_delta_chain_restore_bitwise_equals_full_layout(tmp_path):
    model = make_model()
    mf = CheckpointManager(str(tmp_path / "full"), keep=100, device="cpu")
    md = delta_mgr(tmp_path / "delta")
    run_checkpointed(model, sparse_space(), mf, steps=8, every=2,
                     executor=active_ex())
    run_checkpointed(model, sparse_space(), md, steps=8, every=2,
                     executor=active_ex())
    assert md.steps() == mf.steps()
    for s in md.steps():
        np.testing.assert_array_equal(
            _bits(md.restore(s).space.values["value"]),
            _bits(mf.restore(s).space.values["value"]))
    files = sorted(os.listdir(tmp_path / "delta"))
    kfs = [f for f in files if f.endswith(".kf.npz")]
    dds = [f for f in files if f.endswith(".d.npz")]
    assert kfs and dds
    assert (max(os.path.getsize(tmp_path / "delta" / f) for f in dds)
            < min(os.path.getsize(tmp_path / "delta" / f) for f in kfs))


def test_delta_resume_equivalence(tmp_path):
    model = make_model()
    mgr = delta_mgr(tmp_path, keyframe_every=8)
    _, step6, _ = run_checkpointed(model, sparse_space(), mgr, steps=6,
                                   every=2, executor=active_ex())
    assert step6 == 6
    mgr2 = delta_mgr(tmp_path, keyframe_every=8)
    out10, step10, _ = run_checkpointed(model, sparse_space(), mgr2,
                                        steps=10, every=2,
                                        executor=active_ex())
    assert step10 == 10
    assert torch.equal(out10.values["value"],
                       straight(model, sparse_space(), 10))
    assert "ckpt_0000000008.d.npz" in set(os.listdir(tmp_path))


def test_delta_diff_fallback_without_active_executor(tmp_path):
    model = make_model()
    mgr = delta_mgr(tmp_path)
    run_checkpointed(model, sparse_space(), mgr, steps=6, every=2,
                     executor=mt.SerialExecutor(step_impl="xla"))
    got = mgr.latest()
    assert got.step == 6
    assert torch.equal(got.space.values["value"],
                       straight(model, sparse_space(), 6))


def test_delta_chain_keyframe_cadence_and_degeneration(tmp_path):
    chain = DeltaChain(str(tmp_path), keyframe_every=3, tile=(8, 8))
    sp = sparse_space()
    v = sp.values["value"]
    for step, cell in ((0, None), (1, 4), (2, 5), (3, 6)):
        w = v.clone()
        if cell is not None:
            w[cell, cell] += 1.0
        chain.save(sp.with_values({"value": w}), step)
    with open(chain.manifest_path) as f:
        kinds = [r["kind"] for r in json.load(f)["records"]]
    assert kinds == ["keyframe", "delta", "delta", "keyframe"]
    dense = sp.with_values({"value": torch.from_numpy(
        RNG.uniform(0.5, 2.0, (G, G)))})
    chain.save(dense, 4)
    with open(chain.manifest_path) as f:
        assert json.load(f)["records"][-1]["kind"] == "keyframe"


def test_delta_chain_multi_channel_with_int_mask(tmp_path):
    mask = np.zeros((G, G), bool)
    mask[10:20, 10:20] = True
    sp = mt.CellularSpace({"value": sparse_space().values["value"],
                           "mask": torch.from_numpy(mask),
                           "count": torch.arange(G * G, dtype=torch.int32)
                           .reshape(G, G)}, G, G)
    model = make_model()
    mgr = delta_mgr(tmp_path)
    run_checkpointed(model, sp, mgr, steps=6, every=2,
                     executor=mt.SerialExecutor(step_impl="xla"),
                     check_conservation=False)
    got = mgr.latest()
    want, _ = model.execute(sp, steps=6, check_conservation=False)
    for k in ("value", "mask", "count"):
        assert got.space.values[k].dtype == want.values[k].dtype
        assert torch.equal(got.space.values[k], want.values[k])


def test_delta_layout_autodetected_by_other_managers(tmp_path):
    run_checkpointed(make_model(), sparse_space(), delta_mgr(tmp_path),
                     steps=4, every=2, executor=active_ex())
    got = CheckpointManager(str(tmp_path), device="cpu").latest()
    assert got.step == 4
    assert torch.equal(got.space.values["value"],
                       straight(make_model(), sparse_space(), 4))


# -- retention ------------------------------------------------------------------

def test_prune_mid_chain_keeps_the_supporting_keyframe(tmp_path):
    mgr = delta_mgr(tmp_path, keep=2, keyframe_every=4)
    model = make_model()
    run_checkpointed(model, sparse_space(), mgr, steps=10, every=2,
                     executor=active_ex())
    steps = mgr.steps()
    assert steps[-2:] == [8, 10]
    for s in steps:
        assert torch.equal(mgr.restore(s).space.values["value"],
                           straight(model, sparse_space(), s))
    with open(tmp_path / "ckpt_chain.json") as f:
        assert json.load(f)["records"][0]["kind"] == "keyframe"
    assert steps[0] >= 4


def test_prune_whole_segments_go(tmp_path):
    mgr = delta_mgr(tmp_path, keep=2, keyframe_every=2)
    run_checkpointed(make_model(), sparse_space(), mgr, steps=10, every=2,
                     executor=active_ex())
    with open(tmp_path / "ckpt_chain.json") as f:
        referenced = {r["file"] for r in json.load(f)["records"]}
    on_disk = {f for f in os.listdir(tmp_path) if f.endswith(".npz")}
    assert on_disk == referenced
    assert len(mgr.steps()) <= 4


# -- chain validation ---------------------------------------------------------------

def test_restore_unknown_step_is_filenotfound(tmp_path):
    mgr = delta_mgr(tmp_path)
    mgr.save(sparse_space(), 2)
    with pytest.raises(FileNotFoundError, match="step 7"):
        mgr.restore(7)


def test_missing_delta_record_truncates_chain(tmp_path):
    mgr = delta_mgr(tmp_path, keyframe_every=8)
    model = make_model()
    run_checkpointed(model, sparse_space(), mgr, steps=8, every=2,
                     executor=active_ex())
    os.unlink(tmp_path / "ckpt_0000000006.d.npz")
    mgr2 = delta_mgr(tmp_path, keyframe_every=8)
    with pytest.raises(CheckpointCorruptionError, match="missing"):
        mgr2.restore(8)
    with pytest.warns(RuntimeWarning, match="failed verification"):
        got = mgr2.latest()
    assert got.step == 4
    assert torch.equal(got.space.values["value"],
                       straight(model, sparse_space(), 4))


def test_save_after_manifest_loss_adopts_surviving_keyframes(tmp_path):
    mgr = delta_mgr(tmp_path, keep=3, keyframe_every=2)
    model = make_model()
    run_checkpointed(model, sparse_space(), mgr, steps=8, every=2,
                     executor=active_ex())  # kf0 d2 kf4 d6 kf8
    os.unlink(tmp_path / "ckpt_chain.json")
    mgr2 = delta_mgr(tmp_path, keep=3, keyframe_every=2)
    got = mgr2.latest()
    assert got.step == 8
    out, _ = model.execute(got.space, steps=2)
    mgr2.save(out, 10)
    steps = mgr2.steps()
    assert 10 in steps and len(steps) >= 3
    for s in steps:
        assert torch.equal(mgr2.restore(s).space.values["value"],
                           straight(model, sparse_space(), s))


def test_swapped_record_file_detected_mid_chain(tmp_path):
    mgr = delta_mgr(tmp_path, keyframe_every=8)
    model = make_model()
    run_checkpointed(model, sparse_space(), mgr, steps=8, every=2,
                     executor=active_ex())
    shutil.copyfile(tmp_path / "ckpt_0000000006.d.npz",
                    tmp_path / "ckpt_0000000004.d.npz")
    mgr2 = delta_mgr(tmp_path, keyframe_every=8)
    with pytest.raises(CheckpointCorruptionError, match="drift"):
        mgr2.restore(8)
    with pytest.warns(RuntimeWarning, match="failed verification"):
        got = mgr2.latest()
    assert got.step == 2
    assert torch.equal(got.space.values["value"],
                       straight(model, sparse_space(), 2))


def test_broken_base_link_is_corruption(tmp_path):
    run_checkpointed(make_model(), sparse_space(), delta_mgr(tmp_path),
                     steps=6, every=2, executor=active_ex())
    mp = tmp_path / "ckpt_chain.json"
    doc = json.loads(mp.read_text())
    doc["records"][-1]["base"] = 999
    mp.write_text(json.dumps(doc))
    with pytest.raises(CheckpointCorruptionError, match="link broken"):
        delta_mgr(tmp_path).restore(6)


# -- chain chaos: torn records, torn manifest ----------------------------------------

def _chaos_model():
    return mt.Model(mt.Diffusion(0.1), time=8.0, time_step=1.0)


def _sparse48():
    return sparse_space(g=48)


@pytest.mark.parametrize("part,kf_every,tear,offset", [
    ("delta", 8, "truncate", 64),
    ("keyframe", 2, "corrupt", 200),
])
def test_torn_record_resume_falls_back_bitwise(tmp_path, part, kf_every,
                                               tear, offset):
    model = _chaos_model()
    want = straight(model, _sparse48(), 8)
    plan = FaultPlan((Fault("torn", at=8, channel=part, tear=tear,
                            offset=offset),))
    with inject.armed(plan) as st:
        supervised_run(model, _sparse48(), delta_mgr(
            tmp_path, keyframe_every=kf_every), steps=8, every=2,
            executor=active_ex())
    assert [f["kind"] for f in st.fired] == ["torn"]
    with pytest.warns(RuntimeWarning, match="failed verification"):
        res = supervised_run(model, _sparse48(), delta_mgr(
            tmp_path, keyframe_every=kf_every), steps=8, every=2,
            executor=active_ex())
    assert res.step == 8
    assert torch.equal(res.space.values["value"], want)


def test_crc_mismatched_delta_piece_detected(tmp_path):
    model = _chaos_model()
    supervised_run(model, _sparse48(), delta_mgr(tmp_path, keyframe_every=8),
                   steps=8, every=2, executor=active_ex())
    inject.tear_file(str(tmp_path / "ckpt_0000000008.d.npz"), offset=300,
                     nbytes=16, tear="corrupt")
    mgr2 = delta_mgr(tmp_path, keyframe_every=8)
    with pytest.raises(CheckpointCorruptionError):
        mgr2.restore(8)
    with pytest.warns(RuntimeWarning, match="failed verification"):
        got = mgr2.latest()
    assert got.step == 6
    assert torch.equal(got.space.values["value"],
                       straight(model, _sparse48(), 6))


def test_torn_chain_manifest_degrades_to_keyframes(tmp_path):
    model = _chaos_model()
    plan = FaultPlan((Fault("torn", at=8, channel="chain", tear="corrupt",
                            offset=2),))
    with inject.armed(plan) as st:
        supervised_run(model, _sparse48(), delta_mgr(tmp_path,
                                                     keyframe_every=4),
                       steps=8, every=2, executor=active_ex())
    assert [f["kind"] for f in st.fired] == ["torn"]
    mgr2 = delta_mgr(tmp_path, keyframe_every=4)
    assert mgr2.steps() == [0, 8]
    with pytest.warns(RuntimeWarning, match="unreadable"):
        got = mgr2.latest()
    assert got.step == 8
    assert torch.equal(got.space.values["value"],
                       straight(model, _sparse48(), 8))


def test_delta_all_records_corrupt_fails_fast(tmp_path):
    mgr = delta_mgr(tmp_path, keyframe_every=1)
    mgr.save(_sparse48(), 2)
    mgr.save(_sparse48(), 4)
    for fn in os.listdir(tmp_path):
        if fn.endswith(".npz"):
            inject.tear_file(str(tmp_path / fn), offset=0, tear="truncate")
    with pytest.warns(RuntimeWarning, match="failed verification"):
        with pytest.raises(CheckpointCorruptionError,
                           match="no verifiable checkpoint"):
            delta_mgr(tmp_path, keyframe_every=1).latest()


@pytest.mark.parametrize("where", ["serial", "sharded"])
def test_delta_layout_heals_injected_executor_fault(tmp_path, where):
    model = _chaos_model()
    if where == "serial":
        def ex():
            return active_ex()
    else:
        def ex():
            return ShardMapExecutor(make_mesh(4, devices=[CPU] * 4))
    want = straight(model, _sparse48(), 8, ex())
    with inject.armed(FaultPlan((Fault("exc", at=2),))):
        res = supervised_run(model, _sparse48(), delta_mgr(tmp_path),
                             steps=8, every=2, executor=ex())
    assert len(res.events) == 1 and res.events[0].kind == "exception"
    assert torch.equal(res.space.values["value"], want)


# -- migration ------------------------------------------------------------------------

MESHES = {"1d4": lambda: make_mesh(4, devices=[CPU] * 4),
          "2x2": lambda: make_mesh_2d(2, 2, devices=[CPU] * 4)}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_migrate_serial_to_sharded_and_back_bitwise(mesh, impl):
    """Serial ↔ sharded at a chunk-aligned depth: the K1/K2 plain versions
    on the CPU (f32) and the plain transport (f64)."""
    dtype = torch.float32 if impl == "pallas" else torch.float64
    depth = 2 if impl == "pallas" else 1
    model = make_model()
    sp = sparse_space(dtype=dtype)
    serial = mt.SerialExecutor(impl, substeps=depth)
    sharded = ShardMapExecutor(MESHES[mesh](), impl, halo_depth=depth)
    want = straight(model, sp, 8, serial)
    for src, tgt in ((serial, sharded), (sharded, serial)):
        res = migrate_scenario(model, sp, source=src, target=tgt, steps=8,
                               handoff_at=2, transfer_steps=2, tile=TILE)
        assert torch.equal(res.space.values["value"], want)
        assert res.handoff_step == 4
        assert 0 < res.delta_bytes < res.keyframe_bytes
        assert 0 < res.dirty_tiles < res.ntiles


def test_migrate_zero_transfer_steps_is_plain_handoff():
    model = make_model()
    res = migrate_scenario(model, sparse_space(),
                           source=mt.SerialExecutor(), target=active_ex(),
                           steps=6, handoff_at=3, tile=TILE)
    assert torch.equal(res.space.values["value"],
                       straight(model, sparse_space(), 6))
    assert res.delta_bytes == 0 and res.dirty_tiles == 0


def test_migrate_validates_bounds():
    model = make_model()
    with pytest.raises(ValueError, match="handoff_at"):
        migrate_scenario(model, sparse_space(), steps=4, handoff_at=9)
    with pytest.raises(ValueError, match="transfer_steps"):
        migrate_scenario(model, sparse_space(), steps=4, handoff_at=2,
                         transfer_steps=5)


def test_migrate_detects_a_corrupted_handoff(monkeypatch):
    """A dirty map that misses a changed tile: the bitwise check refuses
    the handoff."""
    def blind(prev, new, plan):
        return np.zeros(plan.grid, bool)

    monkeypatch.setattr(dmod, "changed_tile_map", blind)
    with pytest.raises(MigrationError, match="not bitwise"):
        migrate_scenario(make_model(), sparse_space(), steps=6,
                         handoff_at=2, transfer_steps=2, tile=TILE)
    assert issubclass(MigrationError, RuntimeError)


def test_transfer_space_roundtrip_and_corruption_detection():
    sp = sparse_space()
    t = transfer_space(sp)
    np.testing.assert_array_equal(_bits(sp.values["value"]),
                                  _bits(t.values["value"]))
    assert t.values["value"].data_ptr() != sp.values["value"].data_ptr()
    values = dict(sp.values)
    pieces, payload = dmod._full_pieces(values)
    key = pieces[0]["key"]
    payload[key] = payload[key].copy()
    payload[key][100] ^= 0xFF
    arrays = dmod._new_arrays(dmod._channels_meta(values))
    with pytest.raises(CheckpointCorruptionError, match="CRC32"):
        dmod._apply_pieces(arrays, {"pieces": pieces},
                           lambda k: payload[k], "wire")


def test_migration_unaffected_by_armed_foreign_chaos():
    model = _chaos_model()
    plan = FaultPlan((Fault("torn", at=999), Fault("lane_nan", lane=7)))
    with inject.armed(plan) as st:
        res = migrate_scenario(model, _sparse48(),
                               source=mt.SerialExecutor(),
                               target=active_ex(), steps=8, handoff_at=3,
                               transfer_steps=2, tile=TILE)
    assert st.fired == []
    assert torch.equal(res.space.values["value"],
                       straight(model, _sparse48(), 8))


# -- ensemble migration ----------------------------------------------------------------

def test_scheduler_migrate_ticket_bitwise():
    model = make_model(4.0)
    spaces = [sparse_space(roll=i) for i in range(3)]
    src = mt.EnsembleScheduler(max_batch=8)
    tgt = mt.EnsembleScheduler(max_batch=2, buckets=(1, 2))
    t0, t1, t2 = (src.submit(s, model, steps=4) for s in spaces)
    nt = src.migrate_ticket(t1, tgt)
    with pytest.raises(KeyError):
        src.poll(t1)
    src.pump(force=True)
    tgt.pump(force=True)
    moved = tgt.poll(nt)
    want = straight(model, spaces[1], 4, mt.SerialExecutor())
    assert torch.equal(moved[0].values["value"], want)
    for t in (t0, t2):
        assert src.poll(t) is not None
    assert src.stats()["migrated_out"] == 1
    assert tgt.stats()["migrated_in"] == 1
    assert any("migrated_ticket" in d for d in src.dispatch_log)


def test_scheduler_migrate_ticket_guards():
    model = make_model(4.0)
    sch = mt.EnsembleScheduler(max_batch=4)
    other = mt.EnsembleScheduler(max_batch=4)
    t = sch.submit(sparse_space(), model, steps=2)
    with pytest.raises(ValueError, match="DIFFERENT"):
        sch.migrate_ticket(t, sch)
    with pytest.raises(KeyError, match="unknown"):
        sch.migrate_ticket(999, other)
    sch.pump(force=True)
    with pytest.raises(KeyError, match="already served"):
        sch.migrate_ticket(t, other)
    assert sch.poll(t) is not None


def test_claimed_ticket_is_not_migratable():
    from mpi_model_tpu_torch.ensemble import TicketNotMigratable

    model = make_model(4.0)
    sch = mt.EnsembleScheduler(max_batch=4, inline_dispatch=False)
    other = mt.EnsembleScheduler(max_batch=4)
    t = sch.submit(sparse_space(), model, steps=2)
    flight = sch.launch_due(force=True)
    assert flight is not None
    with pytest.raises(TicketNotMigratable, match="claimed"):
        sch.migrate_ticket(t, other)
    sch.finish_flight(flight)
    assert sch.poll(t) is not None
    assert sch.stats()["migrated_out"] == 0


@pytest.mark.parametrize("impl", ["xla", "pipeline"])
def test_service_migrate_bitwise_the_ticket_served_in_place(impl):
    """K5's plain version on the CPU (32 × 128: whole 16 × 128 strips)."""
    dtype = torch.float32 if impl == "pipeline" else torch.float64
    model = make_model(4.0)
    v = np.zeros((32, 128))
    v[8:12, 60:64] = SEED_BLOCK
    sp = mt.CellularSpace({"value": torch.from_numpy(v).to(dtype)}, 32, 128)
    a = mt.EnsembleService(model, steps=4, max_batch=8, impl=impl)
    b = mt.EnsembleService(model, steps=4, max_batch=2, impl=impl)
    here = mt.EnsembleService(model, steps=4, max_batch=8, impl=impl)
    t = a.submit(sp)
    nt = a.migrate(t, b)
    out, _ = b.result(nt)
    want, _ = here.result(here.submit(sp))
    assert torch.equal(out.values["value"], want.values["value"])
    assert a.stats()["migrated_out"] == 1 and b.stats()["migrated_in"] == 1


def test_scheduler_migration_with_chaos_on_target():
    model = make_model(4.0)
    src = mt.EnsembleScheduler(max_batch=8)
    tgt = mt.EnsembleScheduler(max_batch=2, retry="solo")
    t = src.submit(_sparse48(), model, steps=4)
    plan = FaultPlan((Fault("lane_nan", ticket=0, once=True),))
    with inject.armed(plan):
        nt = src.migrate_ticket(t, tgt)
        assert nt == 0
        other = tgt.submit(_sparse48(), model, steps=4)
        res = tgt.poll(nt)
        assert tgt.poll(other) is not None
    assert res is not None
    assert torch.equal(res[0].values["value"],
                       straight(model, _sparse48(), 4, mt.SerialExecutor()))
    st = tgt.stats()
    assert st["recovered_failures"] == 1 and st["migrated_in"] == 1


def test_delta_chain_roundtrips_ensemble_scenario_state(tmp_path):
    model = make_model(8.0)
    spaces = [sparse_space(roll=i) for i in range(3)]
    half = mt.run_ensemble(model, spaces, steps=4, check_conservation=False)
    for i, (sp, _rep) in enumerate(half):
        m = CheckpointManager(str(tmp_path / f"lane{i}"), keep=10,
                              layout="delta", keyframe_every=4,
                              delta_tile=TILE, device="cpu")
        m.save(sp, 4)
        got = m.latest()
        np.testing.assert_array_equal(_bits(got.space.values["value"]),
                                      _bits(sp.values["value"]))
        resumed = straight(model, got.space, 4, mt.SerialExecutor())
        whole = mt.run_ensemble(model, [spaces[i]], steps=8,
                                check_conservation=False)[0][0]
        assert torch.equal(resumed, whole.values["value"])
