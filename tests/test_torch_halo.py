"""The port's ghost rings (``parallel/halo.py``) and halo kernels' wrappers
(K2 ``pallas_halo_step``, K3-halo ``composed_halo_step``, K4-halo
``pallas_field_halo_step``) against the JAX package on the CPU.

- Rings: the port's ``exchange_ring`` cuts each shard's ring directly from
  its neighbours; it equals ``oracle.ring_from_global_np`` and the JAX
  package's two-stage ``exchange_ring`` under ``shard_map`` (on the
  conftest's forced host devices) bit for bit, at f64, for every shard of
  1-D and 2-D meshes and depths 1, 2, 4 and 8; so do ``zero_ring`` and
  ``pad_with_halo_1d/2d``. ``refresh_rings`` (the in-place depth-1
  exchange on padded buffers) gives the rings ``exchange_ring`` gives, bit
  for bit, step after step.
- Kernels: on a CPU shard each wrapper runs its plain version; the same
  shard and ring (carried across with ``interop.ring_from_numpy``) go
  through the JAX kernel in interpret mode, at edge, corner and interior
  origins, with Moore, von Neumann and a custom neighbourhood. Tolerances
  are the dense twins' tests': f32 ``1e-6·nsteps`` (K2, K3), one bf16 ulp,
  ``4·eps·nsteps·max|v|`` (K4).
- The mosaic property: shards stepped by the halo plain versions and put
  together equal the dense plain version on the whole grid bit for bit, at
  f32 and bf16 (the CPU stand-in for "K2 equals K1").
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

import mpi_model_tpu as mm
from mpi_model_tpu import oracle as joracle
from mpi_model_tpu.compat import shard_map
from mpi_model_tpu.ops import composed_stencil as jcs
from mpi_model_tpu.ops import pallas_stencil as jps
from mpi_model_tpu.parallel import halo as jhalo

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS, VON_NEUMANN_OFFSETS
from mpi_model_tpu_torch.interop import ring_from_numpy
from mpi_model_tpu_torch.ops import composed_stencil as cs
from mpi_model_tpu_torch.ops import field_stencil as k4
from mpi_model_tpu_torch.ops import fused_stencil as fs
from mpi_model_tpu_torch.ops.flow import Flow, cell_coords
from mpi_model_tpu_torch.parallel import (assemble, exchange_ring,
                                          make_mesh, make_mesh_2d,
                                          pad_with_halo_1d, pad_with_halo_2d,
                                          refresh_rings, zero_ring)
from mpi_model_tpu_torch.parallel.mesh import shard_tensor

CPU = torch.device("cpu")
CUSTOM = ((-1, 0), (1, 1), (0, -1))
HOODS = {"moore": MOORE_OFFSETS, "von_neumann": VON_NEUMANN_OFFSETS,
         "custom": CUSTOM}
PIECES = fs.RING_PIECES
EPS32 = 2.0 ** -23


def _grid(shape, seed):
    return np.random.default_rng(seed).uniform(0.5, 2.0, shape)


def _port_grid(G, mesh_shape, one_d):
    L, C = mesh_shape
    mesh = (make_mesh(L, devices=[CPU] * L) if one_d
            else make_mesh_2d(L, C, devices=[CPU] * (L * C)))
    h, w = G.shape[0] // L, G.shape[1] // C
    return shard_tensor(torch.from_numpy(G), mesh, h, w), (h, w)


def _jax_exchange(G, mesh_shape, d, one_d):
    """The JAX package's ring and padded shard of every shard, under
    shard_map on forced host devices: ({(i, j): ring}, {(i, j): padded})."""
    L, C = mesh_shape
    devs = jax.devices("cpu")[:L * C]
    if one_d:
        mesh, spec = JMesh(np.array(devs), ("x",)), P("x", None)

        def fn(loc):
            r = jhalo.exchange_ring(loc, "x", L, depth=d)
            return (tuple(r[p] for p in PIECES)
                    + (jhalo.pad_with_halo_1d(loc, "x", L, depth=d),))
    else:
        mesh = JMesh(np.array(devs).reshape(L, C), ("x", "y"))
        spec = P("x", "y")

        def fn(loc):
            r = jhalo.exchange_ring(loc, "x", L, "y", C, depth=d)
            return (tuple(r[p] for p in PIECES)
                    + (jhalo.pad_with_halo_2d(loc, "x", "y", L, C,
                                              depth=d),))
    out = jax.jit(shard_map(fn, mesh=mesh, in_specs=(spec,),
                            out_specs=tuple(spec for _ in range(9))))(
        jnp.asarray(G))
    h, w = G.shape[0] // L, G.shape[1] // C
    shapes = {"n": (d, w), "s": (d, w), "w": (h, d), "e": (h, d),
              "nw": (d, d), "ne": (d, d), "sw": (d, d), "se": (d, d)}
    rings, padded = {}, {}
    for i in range(L):
        for j in range(C):
            rings[i, j] = {}
            for k, p in enumerate(PIECES):
                a, b = shapes[p]
                rings[i, j][p] = np.asarray(out[k])[i * a:(i + 1) * a,
                                                    j * b:(j + 1) * b]
            a, b = h + 2 * d, w + 2 * d
            padded[i, j] = np.asarray(out[8])[i * a:(i + 1) * a,
                                              j * b:(j + 1) * b]
    return rings, padded


# -- rings -------------------------------------------------------------------

@pytest.mark.parametrize("mesh_shape,one_d", [((2, 2), False), ((2, 4), False),
                                              ((4, 2), False), ((4, 1), True)])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_rings_equal_oracle_and_jax_exchange(mesh_shape, one_d, d):
    G = _grid((32, 64), 11)
    grid, (h, w) = _port_grid(G, mesh_shape, one_d)
    jrings, jpadded = _jax_exchange(G, mesh_shape, d, one_d)
    L, C = mesh_shape
    for i in range(L):
        for j in range(C):
            ring = exchange_ring(grid, i, j, d)
            want = joracle.ring_from_global_np(G, i * h, j * w, h, w, d)
            if one_d:
                # unsplit columns: no west/east pieces (and no corners)
                want.update({p: np.zeros_like(want[p])
                             for p in ("w", "e", "nw", "ne", "sw", "se")})
            for p in PIECES:
                got = ring[p].numpy()
                assert ring[p].is_contiguous()
                np.testing.assert_array_equal(got, want[p], err_msg=p)
                np.testing.assert_array_equal(got, jrings[i, j][p],
                                              err_msg=p)
            padded = (pad_with_halo_1d(grid, i, d) if one_d
                      else pad_with_halo_2d(grid, i, j, d))
            np.testing.assert_array_equal(padded.numpy(), jpadded[i, j])


@pytest.mark.parametrize("mesh_shape,one_d", [((2, 2), False), ((3, 3), False),
                                              ((2, 4), False), ((4, 1), True),
                                              ((3, 1), True)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_refresh_rings_bitwise_exchange_ring(mesh_shape, one_d, dtype):
    """Padded buffers refreshed in place, twice with new interiors between:
    each time every ring is ``exchange_ring``'s (``pad_with_halo_*``'s),
    bit for bit; the first time also ``oracle.ring_from_global_np``'s and
    (up to the eight host devices) the JAX package's padded shard; the
    interiors are untouched."""
    L, C = mesh_shape
    G = _grid((L * 8, C * 12), 17)
    grid, (h, w) = _port_grid(G, mesh_shape, one_d)
    grid = [[t.to(dtype) for t in row] for row in grid]
    bufs = [[torch.nn.functional.pad(t, (1, 1, 1, 1)) for t in row]
            for row in grid]
    for rnd in range(2):
        refresh_rings(bufs)
        shards = [[b[1:-1, 1:-1].clone() for b in row] for row in bufs]
        jpadded = (_jax_exchange(G, mesh_shape, 1, one_d)[1]
                   if rnd == 0 and L * C <= 8 else None)
        for i in range(L):
            for j in range(C):
                want = (pad_with_halo_1d(shards, i) if one_d
                        else pad_with_halo_2d(shards, i, j))
                assert torch.equal(bufs[i][j], want), (rnd, i, j)
                if one_d:
                    ring = exchange_ring(shards, i, j, 1)
                    assert torch.equal(bufs[i][j][0, 1:-1], ring["n"][0])
                    assert torch.equal(bufs[i][j][-1, 1:-1], ring["s"][0])
                if rnd == 0:
                    b = bufs[i][j].numpy()
                    assert torch.equal(bufs[i][j][1:-1, 1:-1], grid[i][j])
                    ring = joracle.ring_from_global_np(
                        G.astype(b.dtype), i * h, j * w, h, w, 1)
                    if one_d:
                        ring = {p: ring[p] * 0 if p in ("w", "e") else
                                ring[p] for p in ring}
                    np.testing.assert_array_equal(b[0, 1:-1], ring["n"][0])
                    np.testing.assert_array_equal(b[-1, 1:-1], ring["s"][0])
                    np.testing.assert_array_equal(b[1:-1, 0], ring["w"][:, 0])
                    np.testing.assert_array_equal(b[1:-1, -1],
                                                  ring["e"][:, 0])
                    if jpadded is not None:
                        np.testing.assert_array_equal(
                            b, jpadded[i, j].astype(b.dtype))
        # a step's new values in every interior, as the runner writes them
        rng = np.random.default_rng(rnd)
        for row in bufs:
            for b in row:
                b[1:-1, 1:-1] = torch.from_numpy(
                    rng.uniform(-1.0, 1.0, (h, w))).to(dtype)


def test_zero_ring_matches_jax():
    x = torch.zeros((6, 10), dtype=torch.float64)
    got = zero_ring(x, 3)
    want = jhalo.zero_ring(jnp.zeros((6, 10)), 3)
    for p in PIECES:
        assert got[p].dtype == torch.float64
        np.testing.assert_array_equal(got[p].numpy(), np.asarray(want[p]))


def test_ring_deeper_than_the_shard_is_refused():
    grid, _ = _port_grid(_grid((16, 16), 1), (2, 2), False)
    with pytest.raises(ValueError, match="exceeds the shard extent"):
        exchange_ring(grid, 0, 0, 9)


# -- K2 against the JAX halo kernel -------------------------------------------

SHARD = (16, 128)
GLOBAL = (48, 384)
ORIGINS = {"nw_corner": (0, 0), "north_edge": (0, 128),
           "interior": (16, 128), "se_corner": (32, 256)}


def _case(pos, d, seed=23, dtype=np.float32):
    G = _grid(GLOBAL, seed)
    r0, c0 = ORIGINS[pos]
    h, w = SHARD
    shard = G[r0:r0 + h, c0:c0 + w].astype(dtype)
    ring = {k: v.astype(dtype) for k, v in
            joracle.ring_from_global_np(G, r0, c0, h, w, d).items()}
    return shard, ring, (r0, c0)


@pytest.mark.parametrize("pos", sorted(ORIGINS))
@pytest.mark.parametrize("hood", sorted(HOODS))
@pytest.mark.parametrize("d,ns", [(1, 1), (4, 4), (8, 3)])
def test_halo_step_matches_jax_interpret(pos, hood, d, ns):
    shard, ring, origin = _case(pos, d)
    offs = HOODS[hood]
    got = fs.pallas_halo_step(torch.from_numpy(shard),
                              ring_from_numpy(ring, "cpu"), origin, GLOBAL,
                              0.13, offs, nsteps=ns).numpy()
    want = np.asarray(jps.pallas_halo_step(
        jnp.asarray(shard), {k: jnp.asarray(v) for k, v in ring.items()},
        jnp.asarray(origin, jnp.int32), GLOBAL, 0.13, offs,
        interpret=True, nsteps=ns))
    tol = 1e-6 * ns
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_halo_step_bf16_within_one_ulp_of_jax():
    shard, ring, origin = _case("interior", 8)
    x = torch.from_numpy(shard).to(torch.bfloat16)
    r = {k: v.to(torch.bfloat16) for k, v in
         ring_from_numpy(ring, "cpu").items()}
    got = fs.pallas_halo_step(x, r, origin, GLOBAL, 0.1, nsteps=8)
    jr = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16)
          for k, v in r.items()}
    want = jps.pallas_halo_step(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                jr, jnp.asarray(origin, jnp.int32), GLOBAL,
                                0.1, interpret=True, nsteps=8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32), rtol=0,
                               atol=2.0 ** -7)


# -- K3-halo against the JAX composed halo step -----------------------------

@pytest.mark.parametrize("pos", sorted(ORIGINS))
@pytest.mark.parametrize("hood,k,variant", [("moore", 4, "auto"),
                                            ("von_neumann", 2, "vpu"),
                                            ("custom", 8, "vpu")])
def test_composed_halo_step_matches_jax_interpret(pos, hood, k, variant):
    shard, ring, origin = _case(pos, 8, seed=29)
    offs = HOODS[hood]
    got = cs.composed_halo_step(torch.from_numpy(shard),
                                ring_from_numpy(ring, "cpu"), origin,
                                GLOBAL, 0.13, k, offs,
                                variant=variant).numpy()
    want = np.asarray(jcs.composed_halo_step(
        jnp.asarray(shard), {kk: jnp.asarray(v) for kk, v in ring.items()},
        jnp.asarray(origin, jnp.int32), GLOBAL, 0.13, k, offs,
        interpret=True, variant=variant))
    tol = 1e-6 * k
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# -- K4-halo against the JAX field halo step ---------------------------------

class RowRate(Flow):
    footprint = "pointwise"
    attr = "a"

    def outflow(self, values, origin=(0, 0)):
        v = values[self.attr]
        rows, _ = cell_coords(v, origin)
        return 0.002 * rows.to(v.dtype) * v


class JRowRate(mm.Flow):
    footprint = "pointwise"
    attr = "a"

    def outflow(self, values, origin=(0, 0)):
        v = values[self.attr]
        rows = origin[0] + jax.lax.broadcasted_iota(jnp.int32, v.shape, 0)
        return 0.002 * rows.astype(v.dtype) * v

    def fingerprint(self):
        return ("RowRate", 0.002)


def _config4(pkg):
    return [pkg.Diffusion(0.1, attr="a"),
            pkg.Coupled(flow_rate=0.05, attr="a", modulator="b"),
            pkg.Diffusion(0.2, attr="b")]


def _field_case(pos, d, seed=31):
    r0, c0 = ORIGINS[pos]
    h, w = SHARD
    vals, rings = {}, {}
    for n, s in (("a", seed), ("b", seed + 1)):
        G = _grid(GLOBAL, s)
        vals[n] = G[r0:r0 + h, c0:c0 + w].astype(np.float32)
        rings[n] = {k: v.astype(np.float32) for k, v in
                    joracle.ring_from_global_np(G, r0, c0, h, w, d).items()}
    return vals, rings, (r0, c0)


@pytest.mark.parametrize("pos,flows,hood,ns", [
    ("nw_corner", "config4", "moore", 4),
    ("se_corner", "config4", "moore", 4),
    ("interior", "config4", "von_neumann", 1),
    ("north_edge", "row_rate", "custom", 3),
    ("interior", "row_rate", "custom", 3),
])
def test_field_halo_step_matches_jax_interpret(pos, flows, hood, ns):
    vals, rings, origin = _field_case(pos, 4)
    offs = HOODS[hood]
    tflows, jflows = {"config4": (_config4(mt), _config4(mm)),
                      "row_rate": ([RowRate()], [JRowRate()])}[flows]
    tv = {n: torch.from_numpy(v) for n, v in vals.items()}
    got = k4.pallas_field_halo_step(
        tv, {n: ring_from_numpy(r, "cpu") for n, r in rings.items()},
        origin, GLOBAL, tflows, offs, nsteps=ns)
    want = jps.pallas_field_halo_step(
        {n: jnp.asarray(v) for n, v in vals.items()},
        {n: {k: jnp.asarray(v) for k, v in r.items()}
         for n, r in rings.items()},
        jnp.asarray(origin, jnp.int32), GLOBAL, jflows, offs,
        interpret=True, nsteps=ns)
    for n in vals:
        w_ = np.asarray(want[n], np.float64)
        tol = 4 * EPS32 * ns * float(np.abs(w_).max())
        assert float(np.abs(got[n].numpy() - w_).max()) <= tol, n
    if flows == "row_rate":
        assert got["b"] is tv["b"]  # a modulator-only channel passes through


def test_field_halo_step_needs_a_ring_for_every_channel():
    vals, rings, origin = _field_case("interior", 2)
    tv = {n: torch.from_numpy(v) for n, v in vals.items()}
    tr = {"a": ring_from_numpy(rings["a"], "cpu")}
    jv = {n: jnp.asarray(v) for n, v in vals.items()}
    jr = {"a": {k: jnp.asarray(v) for k, v in rings["a"].items()}}
    with pytest.raises(ValueError) as te:
        k4.pallas_field_halo_step(tv, tr, origin, GLOBAL, _config4(mt))
    with pytest.raises(ValueError) as je:
        jps.pallas_field_halo_step(jv, jr, jnp.asarray(origin, jnp.int32),
                                   GLOBAL, _config4(mm), interpret=True)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("kw,what", [
    (dict(d=2, nsteps=3), "needs a ghost ring at least that deep"),
    (dict(d=9, nsteps=1), "exceeds the slab capacity"),
])
def test_halo_refusals_match_jax(kw, what):
    h, w = SHARD
    d = kw["d"]
    shard = np.ones((h, w), np.float32)
    ring = {p: np.zeros(s, np.float32) for p, s in
            {"n": (d, w), "s": (d, w), "w": (h, d), "e": (h, d),
             "nw": (d, d), "ne": (d, d), "sw": (d, d), "se": (d, d)}.items()}
    with pytest.raises(ValueError) as te:
        fs.pallas_halo_step(torch.from_numpy(shard),
                            ring_from_numpy(ring, "cpu"), (0, 0), GLOBAL,
                            0.1, nsteps=kw["nsteps"])
    with pytest.raises(ValueError) as je:
        jps.pallas_halo_step(jnp.asarray(shard),
                             {k: jnp.asarray(v) for k, v in ring.items()},
                             jnp.zeros(2, jnp.int32), GLOBAL, 0.1,
                             interpret=True, nsteps=kw["nsteps"])
    assert what in str(te.value) and str(te.value) == str(je.value)
    with pytest.raises(ValueError) as tc:
        cs.composed_halo_step(torch.from_numpy(shard),
                              ring_from_numpy(ring, "cpu"), (0, 0), GLOBAL,
                              0.1, kw["nsteps"])
    with pytest.raises(ValueError) as jc:
        jcs.composed_halo_step(jnp.asarray(shard),
                               {k: jnp.asarray(v) for k, v in ring.items()},
                               jnp.zeros(2, jnp.int32), GLOBAL, 0.1,
                               kw["nsteps"], interpret=True)
    assert str(tc.value) == str(jc.value)


def test_bf16_compute_is_not_ported():
    """bf16 interior math is now ported: K2 accepts the knob and computes
    its plain version (f32 at one step)."""
    shard, ring, origin = _case("interior", 2)
    x, rg = torch.from_numpy(shard), ring_from_numpy(ring, "cpu")
    got = fs.pallas_halo_step(x, rg, origin, GLOBAL, 0.1, nsteps=2,
                              compute_dtype=torch.bfloat16)
    assert torch.equal(got, fs.halo_step_plain(x, rg, origin, GLOBAL, 0.1,
                                               nsteps=2,
                                               compute_dtype="bfloat16"))
    assert torch.equal(
        fs.pallas_halo_step(x, rg, origin, GLOBAL, 0.1,
                            compute_dtype=torch.bfloat16),
        fs.pallas_halo_step(x, rg, origin, GLOBAL, 0.1))


# -- the mosaic property -----------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4), (4, 1), (2, 4)])
@pytest.mark.parametrize("hood", sorted(HOODS))
def test_mosaic_of_halo_plain_versions_is_the_dense_plain(dtype, mesh_shape,
                                                          hood):
    """Shards stepped by each halo plain version and put together equal the
    dense plain version on the whole grid bit for bit."""
    H, W = 48, 64
    L, C = mesh_shape
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(0.5, 2.0, (H, W))).to(dtype)
    y = torch.from_numpy(rng.uniform(0.5, 2.0, (H, W))).to(dtype)
    mesh = make_mesh_2d(L, C, devices=[CPU] * (L * C))
    h, w = H // L, W // C
    offs = HOODS[hood]
    g = shard_tensor(x, mesh, h, w)
    gb = shard_tensor(y, mesh, h, w)
    flows = _config4(mt)
    for ns in (1, 4, 8):
        k2 = [[fs.halo_step_plain(g[i][j], exchange_ring(g, i, j, ns),
                                  (i * h, j * w), (H, W), 0.13, offs, ns)
               for j in range(C)] for i in range(L)]
        assert torch.equal(assemble(k2, CPU),
                           fs.dense_step_plain(x, 0.13, offs, ns))
        k3 = [[cs.composed_halo_step_plain(
            g[i][j], exchange_ring(g, i, j, ns), (i * h, j * w), (H, W),
            0.13, ns, offs) for j in range(C)] for i in range(L)]
        assert torch.equal(assemble(k3, CPU),
                           cs.composed_dense_step_plain(x, 0.13, ns, offs))
        res = {"a": [[None] * C for _ in range(L)],
               "b": [[None] * C for _ in range(L)]}
        for i in range(L):
            for j in range(C):
                out = k4.field_halo_step_plain(
                    {"a": g[i][j], "b": gb[i][j]},
                    {"a": exchange_ring(g, i, j, ns),
                     "b": exchange_ring(gb, i, j, ns)},
                    (i * h, j * w), (H, W), flows, offs, ns)
                res["a"][i][j], res["b"][i][j] = out["a"], out["b"]
        want = k4.field_step_plain({"a": x, "b": y}, flows, offs, ns)
        for n in ("a", "b"):
            assert torch.equal(assemble(res[n], CPU), want[n]), (ns, n)
