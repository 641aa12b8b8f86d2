"""The port's sharded path (``parallel/``: mesh, collectives, halo,
``ShardMapExecutor``) on the CPU, against the JAX package's
``ShardMapExecutor`` on the conftest's forced host devices, the port's own
``SerialExecutor`` and the oracle.

The port's meshes here are ``[torch.device("cpu")] * n``. Tolerances:

- against the port's serial path and the oracle: bit for bit (the same
  operations per cell, whatever the shard edges);
- against JAX's f64 ``xla`` and deep-halo shard steps: ``2·eps·steps·max|v|``
  (XLA on the CPU contracts ``v - rate·v`` into one FMA);
- against JAX's halo kernels in interpret mode (f32): the dense twins'
  tests' ``1e-6·steps`` (K2, K3-halo) and ``4·eps·steps·max|v|`` (K4-halo).

Under jax 0.9 the JAX package's serial plain-Diffusion step fails
(``compat.optimization_barrier``), so nothing here runs it; its sharded
executor runs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mpi_model_tpu as mm
from mpi_model_tpu.parallel import ShardMapExecutor as JShardMap
from mpi_model_tpu.parallel import make_mesh as jmake_mesh
from mpi_model_tpu.parallel import make_mesh_2d as jmake_mesh_2d
from mpi_model_tpu.parallel.mesh import factor2d as jfactor2d
from mpi_model_tpu.parallel.mesh import resolve_grid2d as jresolve_grid2d

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch import oracle
from mpi_model_tpu_torch.ops.flow import Flow
from mpi_model_tpu_torch.parallel import (ShardMapExecutor, assemble,
                                          factor2d, gather_to_host,
                                          global_sum, make_mesh, make_mesh_2d,
                                          resolve_grid2d, shard_space)

CPU = torch.device("cpu")
EPS64 = 2.0 ** -52
EPS32 = 2.0 ** -23

#: (port mesh, JAX mesh) builders by name: 1-D row stripes and 2-D blocks
MESHES = {
    "1d4": (lambda: make_mesh(4, devices=[CPU] * 4),
            lambda: jmake_mesh(4, devices=jax.devices("cpu")[:4])),
    "2x2": (lambda: make_mesh_2d(2, 2, devices=[CPU] * 4),
            lambda: jmake_mesh_2d(2, 2, devices=jax.devices("cpu")[:4])),
    "2x4": (lambda: make_mesh_2d(2, 4, devices=[CPU] * 8),
            lambda: jmake_mesh_2d(2, 4, devices=jax.devices("cpu")[:8])),
}


def _np(shape, seed, names=("value",)):
    rng = np.random.default_rng(seed)
    return {n: rng.uniform(0.5, 2.0, shape) for n in names}


def tspace(vals, dtype="float64"):
    names = tuple(vals)
    h, w = vals[names[0]].shape
    s = mt.CellularSpace.create(h, w, {n: 1.0 for n in names}, dtype=dtype,
                                device="cpu")
    return s.with_values({k: torch.from_numpy(v).to(s.dtype)
                          for k, v in vals.items()})


def jspace(vals, dtype=jnp.float64):
    names = tuple(vals)
    h, w = vals[names[0]].shape
    s = mm.CellularSpace.create(h, w, {n: 1.0 for n in names}, dtype=dtype)
    return s.with_values({k: jnp.asarray(v, dtype) for k, v in vals.items()})


def assert_scaled(got, want, steps, eps):
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    tol = eps * steps * float(np.abs(w).max())
    assert float(np.abs(g - w).max()) <= tol


def config4(pkg):
    return [pkg.Diffusion(0.1, attr="a"),
            pkg.Coupled(flow_rate=0.05, attr="a", modulator="b"),
            pkg.Diffusion(0.2, attr="b")]


# -- meshes, sharding, collectives ----------------------------------------------

@pytest.mark.parametrize("n", [1, 4, 6, 7, 8, 12])
def test_factor2d_and_resolve_grid2d_are_the_jax_packages(n):
    assert factor2d(n) == jfactor2d(n)
    for lines, columns in ((None, None), (2, None), (None, 2), (3, 4)):
        assert (resolve_grid2d(lines, columns, n)
                == jresolve_grid2d(lines, columns, n))


def test_mesh_shapes_and_devices():
    m = make_mesh_2d(2, 3, devices=[CPU] * 6)
    assert m.shape == {"x": 2, "y": 3} and m.grid_shape == (2, 3)
    assert m.size == 6 and m.distinct_devices() == [CPU]
    assert make_mesh(4, devices=[CPU] * 4).shape == {"x": 4}
    assert make_mesh_2d(devices=[CPU] * 8).grid_shape == (2, 4)
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_mesh_2d(2, 4, devices=[CPU] * 6)
    if not torch.cuda.is_available():
        # the default placement is the card; nothing moves to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh_2d(2, 2)
    else:
        m = make_mesh_2d(2, 2)
        assert all(d.type == "cuda" for d in m.distinct_devices())


def test_shard_space_round_trip_and_collectives():
    vals = _np((16, 24), 1)
    space = tspace(vals)
    mesh = make_mesh_2d(2, 3, devices=[CPU] * 6)
    grid = shard_space(space, mesh)["value"]
    assert len(grid) == 2 and len(grid[0]) == 3
    assert all(t.shape == (8, 8) and t.is_contiguous()
               for row in grid for t in row)
    # copies: the space's tensor is never a shard's storage
    grid[0][0][0, 0] = -1.0
    assert space.values["value"][0, 0] != -1.0
    grid[0][0][0, 0] = vals["value"][0, 0]
    assert torch.equal(assemble(grid, CPU), space.values["value"])
    np.testing.assert_array_equal(gather_to_host(grid), vals["value"])
    # the shard-major sum: row-major over the positions
    want = None
    for row in grid:
        for t in row:
            s = t.sum(dtype=torch.float64)
            want = s if want is None else want + s
    assert torch.equal(global_sum(grid), want)
    assert abs(float(global_sum(grid)) - vals["value"].sum()) < 1e-9


def test_indivisible_grid_raises_the_jax_text():
    space = tspace(_np((15, 24), 2))
    jsp = jspace(_np((15, 24), 2))
    with pytest.raises(ValueError) as te:
        mt.Model(mt.Diffusion(0.1)).execute(
            space, ShardMapExecutor(MESHES["2x2"][0]()), steps=1)
    with pytest.raises(ValueError) as je:
        mm.Model(mm.Diffusion(0.1)).execute(
            jsp, JShardMap(MESHES["2x2"][1]()), steps=1)
    assert str(te.value) == str(je.value)


# -- the xla shard steps ------------------------------------------------------

@pytest.mark.parametrize("meshname", sorted(MESHES))
def test_xla_bitwise_serial_and_oracle_close_to_jax(meshname):
    vals = _np((16, 32), 3)
    model = mt.Model(mt.Diffusion(0.13))
    out, rep = model.execute(tspace(vals), ShardMapExecutor(
        MESHES[meshname][0]()), steps=5)
    serial, _ = model.execute(tspace(vals), mt.SerialExecutor("xla"),
                              steps=5)
    assert rep.impl == "xla" and rep.comm_size == (4 if meshname != "2x4"
                                                   else 8)
    assert torch.equal(out.values["value"], serial.values["value"])
    want = vals["value"]
    for _ in range(5):
        want = oracle.dense_flow_step_np(want, 0.13)
    np.testing.assert_array_equal(out.values["value"].numpy(), want)
    jout, _ = mm.Model(mm.Diffusion(0.13)).execute(
        jspace(vals), JShardMap(MESHES[meshname][1]()), steps=5)
    assert_scaled(out.values["value"].numpy(), np.asarray(
        jout.values["value"]), 5, 2 * EPS64)


@pytest.mark.parametrize("meshname", ["1d4", "2x2"])
@pytest.mark.parametrize("depth", [2, 4])
def test_deep_halo_uniform_with_remainder(meshname, depth):
    """10 steps at depth 4: two full chunks and a depth-2 remainder."""
    vals = _np((16, 32), 4)
    model = mt.Model(mt.Diffusion(0.2))
    out, rep = model.execute(tspace(vals), ShardMapExecutor(
        MESHES[meshname][0](), halo_depth=depth), steps=10)
    serial, _ = model.execute(tspace(vals), mt.SerialExecutor("xla"),
                              steps=10)
    assert rep.impl == "xla" and rep.backend_report is None
    assert torch.equal(out.values["value"], serial.values["value"])
    jout, _ = mm.Model(mm.Diffusion(0.2)).execute(
        jspace(vals), JShardMap(MESHES[meshname][1](), halo_depth=depth),
        steps=10)
    assert_scaled(out.values["value"].numpy(),
                  np.asarray(jout.values["value"]), 10, 2 * EPS64)


@pytest.mark.parametrize("depth", [1, 3])
def test_general_pointwise_flows_sharded(depth):
    """Coupled flows (the general deep chunk at depth 3): bit for bit the
    port's serial xla step, close to JAX's."""
    vals = _np((16, 32), 5, ("a", "b"))
    model = mt.Model(config4(mt))
    out, _ = model.execute(tspace(vals), ShardMapExecutor(
        MESHES["2x2"][0](), halo_depth=depth), steps=7)
    serial, _ = model.execute(tspace(vals), mt.SerialExecutor("xla"),
                              steps=7)
    jout, _ = mm.Model(config4(mm)).execute(
        jspace(vals), JShardMap(MESHES["2x2"][1](), halo_depth=depth),
        steps=7)
    for n in ("a", "b"):
        assert torch.equal(out.values[n], serial.values[n]), n
        assert_scaled(out.values[n].numpy(), np.asarray(jout.values[n]), 7,
                      4 * EPS64)


def test_ring1_flow_sharded_matches_serial():
    class NeighborMean(Flow):
        footprint = "ring1"
        flow_rate = 0.2
        attr = "value"

        def outflow_padded(self, padded, origin=(0, 0)):
            p = padded[self.attr]
            h, w = p.shape[0] - 2, p.shape[1] - 2
            acc = 0.0
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    acc = acc + p[1 + dx:1 + dx + h, 1 + dy:1 + dy + w]
            return torch.tensor(self.flow_rate, dtype=p.dtype) * acc / 9.0

    vals = _np((16, 32), 6)
    model = mt.Model(NeighborMean())
    for meshname in ("1d4", "2x4"):
        out, _ = model.execute(tspace(vals), ShardMapExecutor(
            MESHES[meshname][0]()), steps=3, check_conservation=False)
        want, _ = model.execute(tspace(vals), mt.SerialExecutor(), steps=3,
                                check_conservation=False)
        assert torch.equal(out.values["value"], want.values["value"])


def test_partition_space_and_runner_cache_keyed_by_origin():
    """A sharded PARTITION of a larger grid: edges follow the global
    bounds; two same-shaped partitions at different origins do not share a
    runner; one runner serves any step count."""
    vals = _np((16, 48), 7)["value"]
    model = mt.Model(mt.Diffusion(0.1))
    for depth in (1, 4):
        ex = ShardMapExecutor(MESHES["1d4"][0](), halo_depth=depth)
        for x0 in (0, 24):
            part = mt.CellularSpace.create(
                16, 48, 1.0, dtype="float64", x_init=x0,
                global_dim_x=64, global_dim_y=48,
                device="cpu").with_values({"value": torch.from_numpy(vals)})
            for steps in (3, 4):
                want, _ = model.execute(part, steps=steps,
                                        check_conservation=False)
                got, _ = model.execute(part, ex, steps=steps,
                                       check_conservation=False)
                assert torch.equal(got.values["value"],
                                   want.values["value"])
        assert len(ex._cache) == 2  # one runner per origin


# -- the reference's runs --------------------------------------------------------

@pytest.mark.parametrize("steps", [1, 50])
def test_frozen_reference_run_on_row_stripes_is_the_oracle(steps):
    """The reference's scenario on four row stripes of 25 rows: bit for bit
    the oracle."""
    space = mt.CellularSpace.create(100, 100, 1.0, dtype="float64",
                                    device="cpu")
    model = mt.Model(mt.Exponencial(mt.Cell(19, 3, mt.Attribute(99, 2.2)),
                                    0.1), 10.0, 0.2)
    out, rep = model.execute(space, ShardMapExecutor(MESHES["1d4"][0]()),
                             steps=steps)
    np.testing.assert_array_equal(out.values["value"].numpy(),
                                  oracle.reference_run_np(steps=steps))
    # a frozen point flow takes the point subsystem, as JAX's executor does
    assert rep.comm_size == 4 and rep.impl == "point"
    assert rep.final_total["value"] == pytest.approx(10000.0)


def test_reference_source_on_a_stripe_edge_crosses_the_ring():
    """The reference's deliberate halo-crossing source: (19, 3) on the last
    row of a 20-row stripe (a 1x5 mesh), its shares landing in stripe 1
    through the ring — bit for bit the oracle and the serial path."""
    space = mt.CellularSpace.create(100, 100, 1.0, dtype="float64",
                                    device="cpu")
    model = mt.Model(mt.Exponencial(mt.Cell(19, 3, mt.Attribute(99, 2.2)),
                                    0.1), 10.0, 0.2)
    out, _ = model.execute(space, ShardMapExecutor(
        make_mesh(5, devices=[CPU] * 5)), steps=7)
    np.testing.assert_array_equal(out.values["value"].numpy(),
                                  oracle.reference_run_np(steps=7))
    assert float(out.values["value"][20, 3]) > 1.0


def test_cross_shard_point_flow_is_the_oracle_and_jax():
    space = mt.CellularSpace.create(40, 24, 1.0, dtype="float64",
                                    device="cpu")
    flow = mt.PointFlow(source=(9, 3), flow_rate=0.5)  # stripe 0's last row
    out, _ = mt.Model(flow).execute(space, ShardMapExecutor(
        MESHES["1d4"][0]()), steps=3, check_conservation=False)
    want = np.ones((40, 24))
    for _ in range(3):
        want = oracle.point_flow_step_np(want, 9, 3, 0.5 * want[9, 3])
    np.testing.assert_array_equal(out.values["value"].numpy(), want)
    assert float(out.values["value"][10, 3]) > 1.0
    jout, _ = mm.Model(mm.PointFlow(source=(9, 3), flow_rate=0.5)).execute(
        mm.CellularSpace.create(40, 24, 1.0, dtype=jnp.float64),
        JShardMap(MESHES["1d4"][1]()), steps=3, check_conservation=False)
    np.testing.assert_allclose(out.values["value"].numpy(),
                               np.asarray(jout.values["value"]), atol=1e-12)


def test_corner_crossing_point_flow_is_the_oracle():
    """A source at a block corner on 2x4 (8x8 blocks): its diagonal share
    reaches the diagonally adjacent shard through the ring's corner."""
    space = mt.CellularSpace.create(16, 32, 1.0, dtype="float64",
                                    device="cpu")
    flow = mt.PointFlow(source=(7, 7), flow_rate=0.8)
    out, _ = mt.Model(flow).execute(space, ShardMapExecutor(
        MESHES["2x4"][0]()), steps=2, check_conservation=False)
    want = np.ones((16, 32))
    for _ in range(2):
        want = oracle.point_flow_step_np(want, 7, 7, 0.8 * want[7, 7])
    np.testing.assert_array_equal(out.values["value"].numpy(), want)
    assert float(out.values["value"][8, 8]) > 1.0
    serial, _ = mt.Model(flow).execute(space, steps=2,
                                       check_conservation=False)
    assert torch.equal(out.values["value"], serial.values["value"])


def test_all_point_model_reports_xla_where_jax_says_point():
    """An all-frozen-point model takes the point subsystem and reports
    "point", as JAX's does; the values agree bit for bit."""
    space = mt.CellularSpace.create(40, 24, 1.0, dtype="float64",
                                    device="cpu")
    ex = ShardMapExecutor(MESHES["1d4"][0](), step_impl="auto")
    out, rep = mt.Model(mt.Exponencial(mt.Cell(9, 3, mt.Attribute(1, 2.0)),
                                       0.1)).execute(space, ex, steps=2)
    jex = JShardMap(MESHES["1d4"][1](), step_impl="auto")
    jout, _ = mm.Model(mm.Exponencial(mm.Cell(9, 3, mm.Attribute(1, 2.0)),
                                      0.1)).execute(
        mm.CellularSpace.create(40, 24, 1.0, dtype=jnp.float64), jex,
        steps=2)
    assert ex.last_impl == rep.impl == jex.last_impl == "point"
    np.testing.assert_array_equal(out.values["value"].numpy(),
                                  np.asarray(jout.values["value"]))


# -- the kernel paths, against JAX's halo kernels in interpret mode -------------

@pytest.mark.parametrize("meshname,depth,steps", [("2x2", 4, 10),
                                                  ("1d4", 2, 5)])
def test_pallas_path_bitwise_serial_close_to_jax(meshname, depth, steps):
    vals = _np((32, 256), 8)
    model = mt.Model(mt.Diffusion(0.13))
    ex = ShardMapExecutor(MESHES[meshname][0](), "pallas", halo_depth=depth)
    out, rep = model.execute(tspace(vals, "float32"), ex, steps=steps)
    serial, _ = model.execute(tspace(vals, "float32"), mt.SerialExecutor(
        "pallas", substeps=depth), steps=steps)
    assert rep.impl == "pallas"
    br = rep.backend_report
    assert br["kernel"] == "K2 fused_stencil_halo"
    assert (br["full_chunks"], br["remainder_chunk_depth"]) == divmod(
        steps, depth)
    assert br["launches"] == 0  # the CPU runs the plain versions
    # The sharded run composes its remainder at its own depth, the serial
    # executor as single steps; K1 takes the closed form where the cell's
    # distance to the edge exceeds the call's depth, so the two agree bit
    # for bit only chunk for chunk: the serial run of the same chunks.
    q, r = divmod(steps, depth)
    chunked, _ = model.execute(tspace(vals, "float32"), mt.SerialExecutor(
        "pallas", substeps=depth), steps=q * depth)
    if r:
        chunked, _ = model.execute(chunked, mt.SerialExecutor(
            "pallas", substeps=r), steps=r)
    assert torch.equal(out.values["value"], chunked.values["value"])
    want = serial.values["value"]
    gap = float((out.values["value"] - want).abs().max())
    assert gap <= 2 * 2.0 ** -23 * steps * float(want.abs().max())
    jout, _ = mm.Model(mm.Diffusion(0.13)).execute(
        jspace(vals, jnp.float32), JShardMap(MESHES[meshname][1](), "pallas",
                                             halo_depth=depth), steps=steps)
    tol = 1e-6 * steps
    np.testing.assert_allclose(out.values["value"].numpy(),
                               np.asarray(jout.values["value"]), rtol=tol,
                               atol=tol)


def test_composed_path_bitwise_serial_close_to_jax():
    vals = _np((32, 256), 9)
    model = mt.Model(mt.Diffusion(0.1))
    ex = ShardMapExecutor(MESHES["2x2"][0](), "composed", halo_depth=4)
    out, rep = model.execute(tspace(vals, "float32"), ex, steps=8)
    serial, _ = model.execute(tspace(vals, "float32"), mt.SerialExecutor(
        "composed", substeps=4), steps=8)
    assert rep.impl == "composed"
    assert rep.backend_report["composed_k"] == 4
    assert torch.equal(out.values["value"], serial.values["value"])
    jex = JShardMap(MESHES["2x2"][1](), "composed", halo_depth=4)
    jout, _ = mm.Model(mm.Diffusion(0.1)).execute(
        jspace(vals, jnp.float32), jex, steps=8)
    assert jex.last_backend_report["composed_k"] == 4
    np.testing.assert_allclose(out.values["value"].numpy(),
                               np.asarray(jout.values["value"]),
                               rtol=1e-6 * 8, atol=1e-6 * 8)


def test_field_path_bitwise_serial_close_to_jax():
    vals = _np((32, 256), 10, ("a", "b"))
    model = mt.Model(config4(mt))
    ex = ShardMapExecutor(MESHES["2x2"][0](), "pallas", halo_depth=4)
    out, rep = model.execute(tspace(vals, "float32"), ex, steps=6)
    serial, _ = model.execute(tspace(vals, "float32"), mt.SerialExecutor(
        "pallas", substeps=4), steps=6)
    assert rep.backend_report["kernel"] == "K4-halo field_stencil"
    jout, _ = mm.Model(config4(mm)).execute(
        jspace(vals, jnp.float32), JShardMap(MESHES["2x2"][1](), "pallas",
                                             halo_depth=4), steps=6)
    for n in ("a", "b"):
        assert torch.equal(out.values[n], serial.values[n]), n
        assert_scaled(out.values[n].numpy(), np.asarray(jout.values[n]), 6,
                      4 * EPS32)


def test_auto_picks_the_kernel_by_static_rules_only():
    vals = _np((32, 256), 11)
    model = mt.Model(mt.Diffusion(0.1))
    sp = tspace(vals, "float32")
    ex = ShardMapExecutor(MESHES["2x2"][0](), "auto", halo_depth=8)
    model.execute(sp, ex, steps=8)
    assert ex.last_impl == "pallas"
    # a ring deeper than the 16x128 shard's slab capacity (8): xla
    ex = ShardMapExecutor(MESHES["2x2"][0](), "auto", halo_depth=12)
    model.execute(sp, ex, steps=12)
    assert ex.last_impl == "xla"
    # f64 stays on the xla step
    ex = ShardMapExecutor(MESHES["2x2"][0](), "auto")
    model.execute(tspace(vals), ex, steps=2)
    assert ex.last_impl == "xla"
    # a point flow runs xla under auto, as in the JAX package
    pm = mt.Model([mt.Diffusion(0.1), mt.PointFlow(source=(9, 3),
                                                   flow_rate=0.5)])
    ex = ShardMapExecutor(MESHES["2x2"][0](), "auto")
    pm.execute(sp, ex, steps=2, check_conservation=False)
    assert ex.last_impl == "xla"
    jex = JShardMap(MESHES["2x2"][1](), "auto")
    mm.Model([mm.Diffusion(0.1), mm.PointFlow(source=(9, 3),
                                              flow_rate=0.5)]).execute(
        jspace(vals, jnp.float32), jex, steps=2, check_conservation=False)
    assert jex.last_impl == "xla"


def test_zero_halo_mode_is_the_diagnostic():
    """halo_mode="zero": the same compute with all-zero rings, so shard
    edges lose their neighbours' shares (and mass) while cells far from
    every shard edge agree with the exchanging run."""
    vals = _np((32, 256), 12)
    model = mt.Model(mt.Diffusion(0.1))
    sp = tspace(vals, "float32")
    a, _ = model.execute(sp, ShardMapExecutor(MESHES["2x2"][0](), "pallas",
                                              halo_depth=4), steps=4)
    b, _ = model.execute(sp, ShardMapExecutor(
        MESHES["2x2"][0](), "pallas", halo_mode="zero", halo_depth=4),
        steps=4, check_conservation=False)
    va, vb = a.values["value"], b.values["value"]
    assert torch.equal(va[4:12, 4:124], vb[4:12, 4:124])
    assert not torch.equal(va[14:18], vb[14:18])


# -- refusals ------------------------------------------------------------------

def _pair(fn_t, fn_j):
    with pytest.raises(ValueError) as te:
        fn_t()
    with pytest.raises(ValueError) as je:
        fn_j()
    return str(te.value), str(je.value)


def test_refusals_with_the_jax_texts():
    vals = _np((32, 256), 13)
    sp, jsp = tspace(vals, "float32"), jspace(vals, jnp.float32)
    pt = [mt.Diffusion(0.1), mt.PointFlow(source=(3, 3), flow_rate=0.2)]
    jpt = [mm.Diffusion(0.1), mm.PointFlow(source=(3, 3), flow_rate=0.2)]
    M, JM = MESHES["2x2"]
    # a point flow under "pallas"
    t, j = _pair(lambda: mt.Model(pt).execute(
        sp, ShardMapExecutor(M(), "pallas"), steps=1),
        lambda: mm.Model(jpt).execute(jsp, JShardMap(JM(), "pallas"),
                                      steps=1))
    assert t == j and "requires all field flows" in t
    # halo_depth > 1 with point flows
    t, j = _pair(lambda: mt.Model(pt).execute(
        sp, ShardMapExecutor(M(), halo_depth=2), steps=2),
        lambda: mm.Model(jpt).execute(jsp, JShardMap(JM(), halo_depth=2),
                                      steps=2))
    assert t == j and "halo_depth > 1 requires POINTWISE" in t
    # depth beyond the shard (xla deep, and the kernel path)
    small, jsmall = tspace(_np((8, 16), 14)), jspace(_np((8, 16), 14))
    t, j = _pair(lambda: mt.Model(mt.Diffusion(0.1)).execute(
        small, ShardMapExecutor(M(), halo_depth=5), steps=5),
        lambda: mm.Model(mm.Diffusion(0.1)).execute(
            jsmall, JShardMap(JM(), halo_depth=5), steps=5))
    assert t == j and "exceeds the shard extent" in t
    small32 = tspace(_np((8, 16), 14), "float32")
    jsmall32 = jspace(_np((8, 16), 14), jnp.float32)
    t, j = _pair(lambda: mt.Model(mt.Diffusion(0.1)).execute(
        small32, ShardMapExecutor(M(), "pallas", halo_depth=5), steps=5),
        lambda: mm.Model(mm.Diffusion(0.1)).execute(
            jsmall32, JShardMap(JM(), "pallas", halo_depth=5), steps=5))
    assert t == j and "exceeds the shard extent" in t
    # depth beyond the slab capacity (16x128 shards: 8)
    t, j = _pair(lambda: mt.Model(mt.Diffusion(0.1)).execute(
        sp, ShardMapExecutor(M(), "pallas", halo_depth=12), steps=12),
        lambda: mm.Model(mm.Diffusion(0.1)).execute(
            jsp, JShardMap(JM(), "pallas", halo_depth=12), steps=12))
    assert t == j and "exceeds the slab capacity" in t
    # composed on a non-Diffusion model
    t, j = _pair(lambda: mt.Model(pt).execute(
        sp, ShardMapExecutor(M(), "composed"), steps=1),
        lambda: mm.Model(jpt).execute(jsp, JShardMap(JM(), "composed"),
                                      steps=1))
    assert t == j and "has nothing to compose" not in t


def test_undeclared_footprint_is_refused():
    class Undeclared(Flow):
        flow_rate = 0.1
        attr = "value"

        def outflow(self, values, origin=(0, 0)):
            return self.flow_rate * values[self.attr]

    with pytest.raises(ValueError, match="cannot prove flows "
                                         r"\['Undeclared'\] are shardable"):
        mt.Model(Undeclared()).execute(
            tspace(_np((16, 32), 15)), ShardMapExecutor(MESHES["1d4"][0]()),
            steps=1)


def test_unported_parts_raise_naming_the_roadmap():
    M = MESHES["2x2"][0]
    for impl in ("active", "active_fused"):
        # ported: both impls construct and run
        ex = ShardMapExecutor(M(), impl)
        vals = {"value": np.zeros((16, 32))}
        vals["value"][7, 15] = 1.0
        out, rep = mt.Model(mt.Diffusion(0.1)).execute(tspace(vals), ex,
                                                       steps=2)
        assert rep.impl == impl and rep.backend_report["impl"] == impl
        np.testing.assert_array_equal(
            out.values["value"].numpy(),
            oracle.dense_flow_step_np(oracle.dense_flow_step_np(
                vals["value"], 0.1), 0.1))
    # bf16 interior math is ported (accepted); a bad dtype is refused
    assert ShardMapExecutor(M(), "pallas", compute_dtype=torch.bfloat16) \
        .compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="compute_dtype"):
        ShardMapExecutor(M(), "pallas", compute_dtype="float16")

    # sharded Flow IR models are ported: a nonlinear one runs the general
    # lowering, bit for bit its serial run; the linear-stencil impls
    # refuse it, as the JAX package's do
    ir_model, ir_space = mt.build_model("sir", 16, 32, dtype="float64",
                                        device="cpu")
    want, _ = ir_model.execute(ir_space, steps=2)
    got, _ = ir_model.execute(ir_space, ShardMapExecutor(M()), steps=2)
    assert all(torch.equal(got.values[k], want.values[k])
               for k in want.values)
    with pytest.raises(ValueError, match="linear-stencil"):
        ir_model.execute(ir_space, ShardMapExecutor(M(), "composed"),
                         steps=1)
    with pytest.raises(ValueError, match="unknown step impl"):
        ShardMapExecutor(M(), "gspmd")
    with pytest.raises(ValueError, match="halo_depth must be >= 1"):
        ShardMapExecutor(M(), halo_depth=0)


def test_conservation_is_checked_on_the_assembled_totals():
    vals = _np((32, 256), 17)
    model = mt.Model(mt.Diffusion(0.1))
    ex = ShardMapExecutor(MESHES["2x2"][0](), "pallas", halo_mode="zero",
                          halo_depth=4)
    with pytest.raises(mt.ConservationError):
        model.execute(tspace(vals, "float32"), ex, steps=4, tolerance=0.0,
                      rtol=0.0)
    out, rep = model.execute(tspace(vals, "float32"), ShardMapExecutor(
        MESHES["2x2"][0](), "pallas", halo_depth=4), steps=4)
    assert rep.final_total["value"] == float(out.total("value"))
    assert ex.last_assembly_s is not None and ex.last_assembly_s >= 0.0
