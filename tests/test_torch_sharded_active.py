"""The port's shard-local active sets (``ShardMapExecutor(mesh, "active" |
"active_fused")``, ``ops.active.ghost_flags``,
``ops.active.dense_from_ghost_padded``) on the CPU, where K6/K7 run their
plain versions, against the JAX package's sharded active engines, the
port's serial active runs and sharded ``xla``, and the oracle.

Tolerances:

- ``ghost_flags``: bit for bit JAX's;
- against the port's serial active runs, its sharded ``xla`` and
  ``oracle.dense_flow_step_np``: bit for bit (the same operations per cell
  whatever the shard edges, counts from global coordinates);
- ``dense_from_ghost_padded`` and the sharded ``"active_fused"`` run
  against JAX's: ``2·eps·max|v|`` a step (XLA on the CPU contracts
  ``v - rate·v`` into one FMA), the counters equal.

Under jax 0.9 the JAX package's sharded ``"active"`` fails in its own
runner (``compat.optimization_barrier``), so nothing here runs it; its
sharded ``"active_fused"`` runs in Pallas interpret mode.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mpi_model_tpu as mm
from mpi_model_tpu.ops import active as jact
from mpi_model_tpu.parallel import ShardMapExecutor as JShardMap
from mpi_model_tpu.parallel import make_mesh as jmake_mesh
from mpi_model_tpu.parallel import make_mesh_2d as jmake_mesh_2d

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch import oracle
from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS, VON_NEUMANN_OFFSETS
from mpi_model_tpu_torch.ops import active as act
from mpi_model_tpu_torch.ops.stencil import neighbor_counts
from mpi_model_tpu_torch.parallel import (ShardMapExecutor, make_mesh,
                                          make_mesh_2d)
from mpi_model_tpu_torch.parallel.halo import (pad_with_halo_1d,
                                               pad_with_halo_2d)
from mpi_model_tpu_torch.parallel.mesh import shard_tensor

CPU = torch.device("cpu")
EPS = {"float64": 2.0 ** -52, "float32": 2.0 ** -23}
CUSTOM_OFFSETS = ((-1, 0), (1, 1), (0, -1))

#: (port mesh, JAX mesh) builders by name: 4 row stripes and 2x2 blocks
MESHES = {
    "stripes4": (lambda: make_mesh(4, devices=[CPU] * 4),
                 lambda: jmake_mesh(4, devices=jax.devices("cpu")[:4])),
    "2x2": (lambda: make_mesh_2d(2, 2, devices=[CPU] * 4),
            lambda: jmake_mesh_2d(2, 2, devices=jax.devices("cpu")[:4])),
}
#: sources at shard seams: (63, 5) and (64, 64) sit on the 128² grid's
#: stripe and block seams, (0, 127) in a grid corner
SEAM_SOURCES = ((63, 5, 1.7), (64, 64, 2.0), (0, 127, 1.1))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread keeps the runs' times steady on a
    shared machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def point_grid(g=128, sources=SEAM_SOURCES):
    v = np.zeros((g, g))
    for x, y, a in sources:
        v[x, y] = a
    return v


def tspace(vals, dtype="float64"):
    if isinstance(vals, np.ndarray):
        vals = {"value": vals}
    names = tuple(vals)
    h, w = vals[names[0]].shape
    s = mt.CellularSpace.create(h, w, {n: 0.0 for n in names}, dtype=dtype,
                                device="cpu")
    return s.with_values({k: torch.from_numpy(v).to(s.dtype)
                          for k, v in vals.items()})


def jspace(v, dtype="float64"):
    s = mm.CellularSpace.create(v.shape[0], v.shape[1], 0.0,
                                dtype=jnp.dtype(dtype))
    return s.with_values({"value": jnp.asarray(v, jnp.dtype(dtype))})


def oracle_steps(v, rate, steps, offsets=MOORE_OFFSETS):
    for _ in range(steps):
        v = oracle.dense_flow_step_np(v, rate, offsets)
    return v


# -- ghost_flags ---------------------------------------------------------------

@pytest.mark.parametrize("shape,tile", [((32, 128), (32, 128)),
                                        ((64, 64), (16, 32)),
                                        ((48, 96), (16, 16)),
                                        ((40, 30), (8, 10))])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ghost_flags_bitwise_jax(shape, tile, seed):
    rng = np.random.default_rng(seed)
    h, w = shape
    plan = act.plan_for(shape, tile=tile)
    jplan = jact.plan_for(shape, tile=tile)
    p = np.zeros((h + 2, w + 2))
    # a few ghost cells on each strip, cells on tile seams (one column or
    # row past a seam sits in two tiles' windows) and the corner ghosts
    for _ in range(3):
        p[0, rng.integers(1, w + 1)] = 1.0
        p[h + 1, rng.integers(1, w + 1)] = -2.0
        p[rng.integers(1, h + 1), 0] = 0.5
        p[rng.integers(1, h + 1), w + 1] = 3.0
    p[0, 1 + tile[1]] = 1.0
    p[1 + tile[0], w + 1] = 1.0
    corners = [(0, 0), (0, w + 1), (h + 1, 0), (h + 1, w + 1)]
    for c in corners:
        if rng.random() < 0.5:
            p[c] = 1.0
    p[1:-1, 1:-1] = rng.uniform(0, 1, (h, w)) * (rng.random((h, w)) < 0.01)
    none = torch.zeros(plan.grid, dtype=torch.bool)
    got = act.ghost_flags(torch.from_numpy(p), plan, none).numpy()
    want = np.asarray(jact.ghost_flags(jnp.asarray(p), jplan))
    np.testing.assert_array_equal(got, want)
    # with the shard's own tile map: its dilation OR the ring's flags
    tmap = torch.from_numpy(rng.random(plan.grid) < 0.2)
    got = act.ghost_flags(torch.from_numpy(p), plan, tmap).numpy()
    np.testing.assert_array_equal(
        got, act.dilate_tile_map(tmap).numpy() | want)
    # only the corner ghosts: exactly the corner tiles they touch
    q = np.zeros_like(p)
    q[0, 0] = q[h + 1, w + 1] = 1.0
    got = act.ghost_flags(torch.from_numpy(q), plan, none).numpy()
    assert got[0, 0] and got[-1, -1] and got.sum() == (
        1 if plan.grid == (1, 1) else 2)
    np.testing.assert_array_equal(
        got, np.asarray(jact.ghost_flags(jnp.asarray(q), jplan)))


# -- dense_from_ghost_padded ---------------------------------------------------

@pytest.mark.parametrize("meshname", ["stripes4", "2x2"])
@pytest.mark.parametrize("hood", ["moore", "von_neumann", "custom"])
def test_dense_from_ghost_padded_bitwise_oracle_close_to_jax(meshname, hood):
    offsets = {"moore": MOORE_OFFSETS, "von_neumann": VON_NEUMANN_OFFSETS,
               "custom": CUSTOM_OFFSETS}[hood]
    rng = np.random.default_rng(5)
    G = rng.uniform(0.5, 2.0, (64, 48))
    mesh = MESHES[meshname][0]()
    lines, columns = mesh.grid_shape
    h, w = 64 // lines, 48 // columns
    grid = shard_tensor(torch.from_numpy(G), mesh, h, w)
    out = np.zeros_like(G)
    for i in range(lines):
        for j in range(columns):
            p = (pad_with_halo_1d(grid, i) if columns == 1
                 else pad_with_halo_2d(grid, i, j))
            cnt = torch.clamp(neighbor_counts(
                (h + 2, w + 2), offsets, (i * h - 1, j * w - 1), G.shape,
                torch.float64, CPU), min=1)
            got = act.dense_from_ghost_padded(p, 0.13, cnt, offsets,
                                              torch.float64)
            assert got.shape == (h, w)
            want = jact.dense_from_ghost_padded(
                jnp.asarray(p.numpy()), 0.13, jnp.asarray(cnt.numpy()),
                offsets, jnp.float64)
            np.testing.assert_allclose(
                got.numpy(), np.asarray(want), rtol=0,
                atol=2 * EPS["float64"] * float(np.abs(G).max()))
            out[i * h:(i + 1) * h, j * w:(j + 1) * w] = got.numpy()
    np.testing.assert_array_equal(
        out, oracle.dense_flow_step_np(G, 0.13, offsets))


# -- the sharded runs ----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("impl", ["active", "active_fused"])
@pytest.mark.parametrize("meshname", ["stripes4", "2x2"])
def test_sharded_active_bitwise_serial_xla_and_oracle(meshname, impl,
                                                      dtype):
    v = point_grid()
    steps = 30
    model = mt.Model(mt.Diffusion(0.1))
    ex = ShardMapExecutor(MESHES[meshname][0](), impl)
    out, rep = model.execute(tspace(v, dtype), ex, steps=steps)
    got = out.values["value"]
    assert ex.last_impl == rep.impl == impl
    serial, _ = model.execute(tspace(v, dtype), mt.SerialExecutor(impl),
                              steps=steps)
    assert torch.equal(got, serial.values["value"])
    xla, _ = model.execute(tspace(v, dtype), ShardMapExecutor(
        MESHES[meshname][0](), "xla"), steps=steps)
    assert torch.equal(got, xla.values["value"])
    if dtype == "float64":
        np.testing.assert_array_equal(got.numpy(),
                                      oracle_steps(v, 0.1, steps))
    br = rep.backend_report
    assert br["impl"] == impl and br["steps"] == steps
    assert br["shards"] == 4
    assert br["tiles"] == br["tiles_per_shard"] * br["shards"]
    assert 0.0 < br["mean_active_fraction"] <= 1.0
    assert br["host_syncs"] == steps
    assert sorted(br["host_s"]) == ["count_read", "flags", "passes",
                                    "refresh"]
    assert all(t >= 0.0 for t in br["host_s"].values())
    keys = {"impl", "steps", "shards", "fallback_steps", "tile", "tiles",
            "tiles_per_shard", "capacity", "fallback_tiles",
            "mean_active_fraction"}
    assert keys <= br.keys()
    if impl == "active_fused":
        assert br["flags_fused"] + br["fallback_steps"] == steps * 4
    else:
        assert "flags_fused" not in br


@pytest.mark.parametrize("meshname", ["stripes4", "2x2"])
def test_sharded_active_fused_close_to_jax_with_its_counters(meshname):
    v = point_grid()
    steps = 30
    ex = ShardMapExecutor(MESHES[meshname][0](), "active_fused")
    out, rep = mt.Model(mt.Diffusion(0.1)).execute(tspace(v), ex,
                                                   steps=steps)
    jex = JShardMap(MESHES[meshname][1](), step_impl="active_fused")
    jout = jex.run_model(mm.Model(mm.Diffusion(0.1), 1.0, 1.0), jspace(v),
                         steps)
    np.testing.assert_allclose(
        out.values["value"].numpy(), np.asarray(jout["value"]), rtol=0,
        atol=2 * EPS["float64"] * steps * float(np.abs(v).max()))
    br, jbr = rep.backend_report, jex.last_backend_report
    for k in ("impl", "steps", "shards", "flags_fused", "fallback_steps",
              "tile", "tiles", "tiles_per_shard", "capacity",
              "fallback_tiles", "mean_active_fraction"):
        assert br[k] == jbr[k], k
    assert br["flags_fused"] == 120 and br["fallback_steps"] == 0
    assert br["mean_active_fraction"] == (0.75 if meshname == "stripes4"
                                          else 1.0)


def test_sharded_active_two_channels_and_a_frontier_crossing_seams():
    """Two channels at their own rates, a blob whose front crosses the
    2x4 mesh's seams while shards change between active and dense: every
    (channel, shard, step) is counted once, and the run is bitwise the
    serial and sharded xla runs."""
    rng = np.random.default_rng(11)
    a = np.zeros((64, 128))
    a[28:36, 60:68] = rng.uniform(0.5, 2.0, (8, 8))
    b = np.zeros((64, 128))
    b[0:3, 0:5] = rng.uniform(0.5, 2.0, (3, 5))
    model = mt.Model([mt.Diffusion(0.1, "a"), mt.Diffusion(0.2, "b")])
    steps = 12
    want, _ = model.execute(tspace({"a": a, "b": b}), mt.SerialExecutor(
        "xla"), steps=steps)
    for impl in ("active", "active_fused"):
        mesh = make_mesh_2d(2, 4, devices=[CPU] * 8)
        ex = ShardMapExecutor(mesh, impl)
        out, rep = model.execute(tspace({"a": a, "b": b}), ex, steps=steps)
        serial, _ = model.execute(tspace({"a": a, "b": b}),
                                  mt.SerialExecutor(impl), steps=steps)
        for k in ("a", "b"):
            assert torch.equal(out.values[k], want.values[k]), (impl, k)
            assert torch.equal(out.values[k], serial.values[k]), (impl, k)
        br = rep.backend_report
        assert br["shards"] == 8
        if impl == "active_fused":
            assert br["flags_fused"] + br["fallback_steps"] == steps * 2 * 8
        assert br["host_syncs"] == steps


@pytest.mark.parametrize("impl", ["active", "active_fused"])
def test_sharded_active_dense_fallback_counted(impl):
    """An everywhere-nonzero 512² grid over 4 stripes (4 tiles a shard, a
    threshold of 1) takes the dense step on every (shard, step), bitwise the
    xla shard step."""
    v = np.random.default_rng(7).uniform(0.5, 1.5, (512, 512))
    model = mt.Model(mt.Diffusion(0.1))
    steps = 4
    ex = ShardMapExecutor(make_mesh(4, devices=[CPU] * 4), impl)
    out, rep = model.execute(tspace(v), ex, steps=steps)
    br = rep.backend_report
    assert br["fallback_steps"] == steps * br["shards"] == 16
    assert br["mean_active_fraction"] == 1.0
    if impl == "active_fused":
        assert br["flags_fused"] == 0
    xla, _ = model.execute(tspace(v), ShardMapExecutor(
        make_mesh(4, devices=[CPU] * 4), "xla"), steps=steps)
    assert torch.equal(out.values["value"], xla.values["value"])
    np.testing.assert_array_equal(out.values["value"].numpy(),
                                  oracle_steps(v, 0.1, steps))


def _message(fn, exc):
    with pytest.raises(exc) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("impl", ["active", "active_fused"])
def test_sharded_active_validation_with_jax_texts(impl):
    M, JM = MESHES["stripes4"]
    t = _message(lambda: ShardMapExecutor(M(), impl, halo_depth=2),
                 ValueError)
    j = _message(lambda: JShardMap(JM(), impl, halo_depth=2), ValueError)
    assert t == j and "halo_depth" in t
    # a non-Diffusion flow
    ts = mt.CellularSpace.create(64, 64, {"a": 1.0, "b": 1.0},
                                 dtype="float32", device="cpu")
    js = mm.CellularSpace.create(64, 64, {"a": 1.0, "b": 1.0},
                                 dtype=jnp.float32)
    t = _message(lambda: ShardMapExecutor(M(), impl).run_model(
        mt.Model([mt.Diffusion(0.1, attr="a"),
                  mt.Coupled(flow_rate=0.05, attr="a", modulator="b")]),
        ts, 2), ValueError)
    j = _message(lambda: JShardMap(JM(), impl).run_model(
        mm.Model([mm.Diffusion(0.1, attr="a"),
                  mm.Coupled(flow_rate=0.05, attr="a", modulator="b")],
                 1.0, 1.0), js, 2), ValueError)
    assert t == j and "plain Diffusion" in t
    # a point flow beside the Diffusion
    t = _message(lambda: ShardMapExecutor(M(), impl).run_model(
        mt.Model([mt.Diffusion(0.1, attr="a"), mt.Exponencial(
            mt.Cell(3, 3, mt.Attribute(1, 2.0)), 0.1, attr="a")]), ts, 2),
        ValueError)
    assert "plain Diffusion" in t
    # an integer channel
    ts = mt.CellularSpace.create(64, 64, {"value": (1, "int64")},
                                 device="cpu")
    js = mm.CellularSpace.create(64, 64, {"value": (1, "int64")})
    t = _message(lambda: ShardMapExecutor(M(), impl).run_model(
        mt.Model(mt.Diffusion(0.1)), ts, 2), TypeError)
    j = _message(lambda: JShardMap(JM(), impl).run_model(
        mm.Model(mm.Diffusion(0.1), 1.0, 1.0), js, 2), TypeError)
    assert t == j and "floating dtype" in t
    # a flow channel outside the space dtype
    ts = mt.CellularSpace.create(
        64, 64, {"aux": (1.0, "float32"), "value": (1.0, "float64")},
        device="cpu")
    js = mm.CellularSpace.create(
        64, 64, {"aux": (1.0, "float32"), "value": (1.0, "float64")})
    t = _message(lambda: ShardMapExecutor(M(), impl).run_model(
        mt.Model(mt.Diffusion(0.1)), ts, 2), ValueError)
    j = _message(lambda: JShardMap(JM(), impl).run_model(
        mm.Model(mm.Diffusion(0.1), 1.0, 1.0), js, 2), ValueError)
    assert t == j and "space dtype" in t


def test_zero_halo_mode_drops_the_rings():
    """``halo_mode="zero"`` (the exchange-cost diagnostic) pads with zeros:
    a source on a seam loses its cross-seam shares."""
    v = point_grid(64, ((31, 10, 1.0),))
    model = mt.Model(mt.Diffusion(0.1))
    ex = ShardMapExecutor(make_mesh(4, devices=[CPU] * 4), "active_fused",
                          halo_mode="zero")
    out = ex.run_model(model, tspace(v), 1)["value"].numpy()
    assert out[32, 10] == 0.0 and out[30, 10] > 0.0
    full = ShardMapExecutor(make_mesh(4, devices=[CPU] * 4),
                            "active_fused").run_model(model, tspace(v), 1)
    assert full["value"].numpy()[32, 10] > 0.0
