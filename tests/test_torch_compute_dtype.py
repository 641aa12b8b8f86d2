"""bf16 interior math (``compute_dtype=bfloat16``) in the port against the
JAX package's kernels in interpret mode, on the CPU.

The JAX kernels compute their tiles that are not near the grid's edge in
bf16 and their near tiles in f32 (K1/K2/K3 over the window cast to bf16,
K4 and K5 over the plain f32 window); at one step K1/K2 ignore the knob.
The port's plain versions decide the bf16 cells by JAX's tile rule
(``fused_stencil.bf16_rect``), so each case splits the grid the same way.
Inputs come from a numpy seed; each JAX function runs in interpret mode, as
``tests/test_pallas.py`` runs the JAX package's own knob tests.

Tolerances, stated before any run:

- ``NEAR``: near tiles, an f32-level bound, ``4·eps32·n·max|v|`` (the
  port's per-cell forms round differently from the TPU kernel's per-tile
  forms near the edge; ``tests/test_torch_k1_interior.py``);
- ``interior``: bf16 tiles, one bf16 ulp of the value scale,
  ``2^(floor(log2 max|v|) - 7)`` (0.0078 for values in [1, 2)): XLA's CPU
  backend keeps some bf16 intermediates wider than the source order says,
  so the two differ by a rounding, not bit for bit. Readings on these
  cases: at most 0.0039 (2^-8) in every family; with the constants left in
  f32 (torch's ``bf16_tensor * float``, the fault this bound must catch)
  0.0117 to 0.039 in K1, K2, K3 vpu and K5. Far below JAX's own 0.05;
- one step of K1/K2, and K5 on a grid with no closed tile: bit for bit the
  f32-compute result.
"""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_model_tpu as mm
from mpi_model_tpu import cli as jcli
from mpi_model_tpu import oracle as joracle
from mpi_model_tpu.models.model import SerialExecutor as JSerial
from mpi_model_tpu.ops import composed_stencil as jcs
from mpi_model_tpu.ops import pallas_stencil as jps

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch.cli import main as cli_main
from mpi_model_tpu_torch.interop import ring_from_numpy
from mpi_model_tpu_torch.ops import composed_stencil as cs
from mpi_model_tpu_torch.ops import field_lower as fl
from mpi_model_tpu_torch.ops import field_stencil as k4
from mpi_model_tpu_torch.ops import fused_stencil as fs
from mpi_model_tpu_torch.ops import pipeline_stencil as ps
from mpi_model_tpu_torch.ops.flow import Flow

torch.set_num_threads(1)

BF = torch.bfloat16
EPS32 = 2.0 ** -23
RATE = 0.17
SHAPE, BLOCK = (64, 512), (16, 128)


def near_tol(n, v):
    return 4 * EPS32 * n * float(np.abs(v).max())


def interior_tol(v):
    return 2.0 ** (math.floor(math.log2(float(np.abs(v).max()))) - 7)


def _grid(shape=SHAPE, seed=3):
    return np.random.default_rng(seed).uniform(0.5, 2.0, shape).astype(
        np.float32)


def _split(shape, block, n, origin=(0, 0), gshape=None):
    """Bool mask of the cells JAX computes in bf16 (its interior tiles)."""
    r0, r1, c0, c1 = fs.bf16_rect(shape, block, n, origin, gshape)
    m = np.zeros(shape, bool)
    m[r0:r1, c0:c1] = True
    return m


def _held(got, want, mask, n):
    """Near cells within NEAR, bf16 cells within interior."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert mask.any() and (~mask).any()
    assert d[~mask].max() <= near_tol(n, want), d[~mask].max()
    assert d[mask].max() <= interior_tol(want), d[mask].max()


# -- K1 / K2 ---------------------------------------------------------------------

@pytest.mark.parametrize("ns", [2, 4])
def test_k1_bf16_interior_matches_jax(ns):
    v = _grid()
    got = fs.pallas_dense_step(torch.from_numpy(v), RATE, block=BLOCK,
                               nsteps=ns, compute_dtype=BF).numpy()
    want = np.asarray(jps.pallas_dense_step(
        jnp.asarray(v), RATE, block=BLOCK, nsteps=ns, interpret=True,
        compute_dtype=jnp.bfloat16))
    _held(got, want, _split(SHAPE, BLOCK, ns), ns)


def test_k1_one_step_ignores_the_knob_as_jax_does():
    v = _grid(seed=4)
    x = torch.from_numpy(v)
    got = fs.pallas_dense_step(x, RATE, block=BLOCK, compute_dtype=BF)
    assert torch.equal(got, fs.pallas_dense_step(x, RATE, block=BLOCK))
    j16 = jps.pallas_dense_step(jnp.asarray(v), RATE, block=BLOCK,
                                interpret=True, compute_dtype=jnp.bfloat16)
    j32 = jps.pallas_dense_step(jnp.asarray(v), RATE, block=BLOCK,
                                interpret=True)
    assert np.array_equal(np.asarray(j16), np.asarray(j32))


def test_k1_bf16_storage_matches_jax():
    v = _grid(seed=5)
    xb = torch.from_numpy(v).to(BF)
    got = fs.pallas_dense_step(xb, RATE, block=BLOCK, nsteps=8,
                               compute_dtype=BF).float().numpy()
    want = np.asarray(jps.pallas_dense_step(
        jnp.asarray(xb.float().numpy(), jnp.bfloat16), RATE, block=BLOCK,
        nsteps=8, interpret=True, compute_dtype=jnp.bfloat16)).astype(
        np.float32)
    # both round the result to bf16: one bf16 ulp below 4 on top
    tol = interior_tol(want) + 2.0 ** -7
    assert np.abs(got - want).max() <= tol


def test_k1_near_tiles_read_the_window_rounded_to_bf16():
    """A near tile of the bf16 call is the f32 call on the grid rounded to
    bf16, bit for bit (the TPU kernel's mwin() * mask)."""
    v = _grid(seed=6)
    got = fs.pallas_dense_step(torch.from_numpy(v), RATE, block=BLOCK,
                               nsteps=4, compute_dtype=BF)
    rounded = torch.from_numpy(v).to(BF).float()
    f32 = fs.pallas_dense_step(rounded, RATE, block=BLOCK, nsteps=4)
    near = ~torch.from_numpy(_split(SHAPE, BLOCK, 4))
    assert torch.equal(got[near], f32[near])
    assert not torch.equal(got[~near], f32[~near])


HALO_G = (192, 768)


@pytest.mark.parametrize("origin", [(64, 256), (0, 0), (128, 512)])
def test_k2_bf16_interior_matches_jax(origin):
    """An all-interior shard, a corner shard (tiles near and not), and the
    far corner; each shard's tiles at its global origin."""
    G = _grid(HALO_G, seed=8)
    h, w, d, ns = 64, 256, 8, 4
    r0, c0 = origin
    shard = G[r0:r0 + h, c0:c0 + w]
    ring = {k: v.astype(np.float32) for k, v in
            joracle.ring_from_global_np(G, r0, c0, h, w, d).items()}
    got = fs.pallas_halo_step(torch.from_numpy(shard),
                              ring_from_numpy(ring, "cpu"), origin, HALO_G,
                              RATE, block=BLOCK, nsteps=ns,
                              compute_dtype=BF).numpy()
    want = np.asarray(jps.pallas_halo_step(
        jnp.asarray(shard), {k: jnp.asarray(v) for k, v in ring.items()},
        jnp.asarray(origin, jnp.int32), HALO_G, RATE, block=BLOCK,
        interpret=True, nsteps=ns, compute_dtype=jnp.bfloat16))
    mask = _split((h, w), BLOCK, ns, origin, HALO_G)
    d_ = np.abs(got.astype(np.float64) - want)
    if (~mask).any():
        assert d_[~mask].max() <= near_tol(ns, want)
    if mask.any():
        assert d_[mask].max() <= interior_tol(want)
    if origin == (64, 256):
        assert mask.all()


def test_k2_one_step_is_f32():
    G = _grid(HALO_G, seed=9)
    shard = torch.from_numpy(G[64:128, 256:512].copy())
    ring = ring_from_numpy(joracle.ring_from_global_np(
        G, 64, 256, 64, 256, 1), "cpu")
    ring = {k: t.float() for k, t in ring.items()}
    a = fs.pallas_halo_step(shard, ring, (64, 256), HALO_G, RATE,
                            compute_dtype=BF)
    assert torch.equal(a, fs.pallas_halo_step(shard, ring, (64, 256),
                                              HALO_G, RATE))


# -- K3 ----------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["vpu", "mxu"])
@pytest.mark.parametrize("k", [1, 4])
def test_k3_bf16_interior_matches_jax(variant, k):
    v = _grid(seed=10)
    got = cs.composed_dense_step(torch.from_numpy(v), RATE, k, block=BLOCK,
                                 variant=variant, compute_dtype=BF).numpy()
    want = np.asarray(jcs.composed_dense_step(
        jnp.asarray(v), RATE, k, block=BLOCK, interpret=True,
        variant=variant, compute_dtype=jnp.bfloat16))
    _held(got, want, _split(SHAPE, BLOCK, k), k)


@pytest.mark.parametrize("variant", ["vpu", "mxu"])
def test_k3_halo_bf16_interior_matches_jax(variant):
    G = _grid(HALO_G, seed=12)
    h, w, d, k = 64, 256, 8, 4
    r0, c0 = 0, 256
    shard = G[r0:r0 + h, c0:c0 + w]
    ring = {kk: vv.astype(np.float32) for kk, vv in
            joracle.ring_from_global_np(G, r0, c0, h, w, d).items()}
    got = cs.composed_halo_step(torch.from_numpy(shard),
                                ring_from_numpy(ring, "cpu"), (r0, c0),
                                HALO_G, RATE, k, block=BLOCK,
                                variant=variant, compute_dtype=BF).numpy()
    want = np.asarray(jcs.composed_halo_step(
        jnp.asarray(shard), {kk: jnp.asarray(vv) for kk, vv in ring.items()},
        jnp.asarray((r0, c0), jnp.int32), HALO_G, RATE, k, block=BLOCK,
        interpret=True, variant=variant, compute_dtype=jnp.bfloat16))
    _held(got, want, _split((h, w), BLOCK, k, (r0, c0), HALO_G), k)


def test_k3_bf16_coefficients_round_from_f64():
    """JAX's weakly typed coefficients: each f64 coefficient rounded once,
    straight to bf16 (not through f32)."""
    coefs = cs.vpu_coefs_bf16(0.1, mt.core.cell.MOORE_OFFSETS, 16)
    for c in coefs:
        assert float(torch.tensor(c).to(BF).float()) == c
    x = 1.0 + 2.0 ** -8 + 2.0 ** -30   # just above a bf16 tie
    assert fs.round_bf16(x) == 1.0 + 2.0 ** -7
    assert fs.round_bf16(1.0 + 2.0 ** -8) == 1.0  # a tie: to even


# -- K5 ----------------------------------------------------------------------------

@pytest.mark.parametrize("ns", [1, 4])
def test_k5_bf16_interior_matches_jax(ns):
    """K5 takes the knob at every nsteps, on its closed tiles only; its near
    tiles are plain f32."""
    v = _grid(seed=14)
    got = fs.pallas_dense_step(torch.from_numpy(v), RATE, block=BLOCK,
                               nsteps=ns, pipeline=True,
                               compute_dtype=BF).numpy()
    want = np.asarray(jps.pallas_dense_step(
        jnp.asarray(v), RATE, block=BLOCK, nsteps=ns, interpret=True,
        pipeline=True, compute_dtype=jnp.bfloat16))
    mask = ps.interior_mask(SHAPE, BLOCK, ns).numpy()
    _held(got, want, mask, ns)
    f32 = ps.pipeline_dense_step(torch.from_numpy(v), RATE, block=BLOCK,
                                 nsteps=ns).numpy()
    assert np.array_equal(got[~mask], f32[~mask])


def test_k5_without_closed_tiles_is_the_f32_result():
    """JAX's blocks on 64 x 512 are the whole grid (one near tile), as they
    leave no closed tile at the ensemble's 4096²: bit for bit f32."""
    v = np.random.default_rng(15).uniform(0.5, 2.0, (2,) + SHAPE).astype(
        np.float32)
    x = torch.from_numpy(v)
    assert not bool(ps.interior_mask(SHAPE, ps.pipeline_block(SHAPE, 8),
                                     8).any())
    got = ps.pipeline_dense_step(x, RATE, nsteps=8, compute_dtype=BF)
    assert torch.equal(got, ps.pipeline_dense_step(x, RATE, nsteps=8))
    want = np.asarray(jps.pallas_dense_step(
        jnp.asarray(v[0]), RATE, nsteps=8, interpret=True, pipeline=True,
        compute_dtype=jnp.bfloat16))
    assert np.abs(got[0].numpy() - want).max() <= near_tol(8, want)


def test_ensemble_pipeline_takes_the_knob():
    """EnsembleExecutor('pipeline') with bf16 interior math: each lane is
    K5's bf16 plain version; the runner cache keeps f32 and bf16 apart."""
    h, w = 64, 512
    rng = np.random.default_rng(16)
    spaces = [mt.CellularSpace.create(h, w, 1.0, device="cpu").with_values(
        {"value": torch.from_numpy(rng.uniform(0.5, 2.0, (h, w)).astype(
            np.float32))}) for _ in range(2)]
    model = mt.Model(mt.Diffusion(RATE))
    ex = mt.EnsembleExecutor("pipeline", substeps=4, compute_dtype=BF)
    outs = model.execute_many(spaces, executor=ex, steps=4,
                              check_conservation=False)
    for sp, (o, _) in zip(spaces, outs):
        want = ps.pipeline_step_plain(sp.values["value"], RATE, nsteps=4,
                                      compute_dtype=BF)
        assert torch.equal(o.values["value"], want)
    ex32 = mt.EnsembleExecutor("pipeline", substeps=4)
    assert ex.runner_for(model, mt.ensemble.batch.EnsembleSpace.stack(
        spaces), {"value": RATE}) is not ex32.runner_for(
        model, mt.ensemble.batch.EnsembleSpace.stack(spaces),
        {"value": RATE})


# -- K4 ----------------------------------------------------------------------------

def _coupled(pkg, h=40, w=640, seed=5):
    rng = np.random.default_rng(seed)
    vals = {n: rng.uniform(0.5, 2.0, (h, w)).astype(np.float32)
            for n in ("a", "b")}
    flows = [pkg.Diffusion(0.1, "a"), pkg.Coupled(0.05, "a", "b"),
             pkg.Diffusion(0.2, "b")]
    return flows, vals


@pytest.mark.parametrize("ns", [1, 4])
def test_k4_bf16_interior_matches_jax(ns):
    """``Diffusion`` + ``Coupled`` (config 4's shape) at block (8, 128):
    near tiles plain f32, the rest the bf16 program."""
    tflows, vals = _coupled(mt)
    jflows, _ = _coupled(mm)
    block = (8, 128)
    got = k4.PallasFieldStep((40, 640), tflows, block=block, nsteps=ns,
                             compute_dtype=BF)(
        {k: torch.from_numpy(v) for k, v in vals.items()})
    want = jps.PallasFieldStep((40, 640), jflows, block=block,
                               interpret=True, nsteps=ns,
                               compute_dtype=jnp.bfloat16)(
        {k: jnp.asarray(v) for k, v in vals.items()})
    mask = _split((40, 640), block, ns)
    for n in ("a", "b"):
        _held(got[n].numpy(), np.asarray(want[n]), mask, ns)


@pytest.mark.parametrize("ns", [1, 4])
def test_k4_paired_walk_matches_jax(ns):
    """The paired walk K4 runs on its bf16 cells (two rows a bf16x2
    register, emulated in torch over the kernel's windows:
    ``tests/test_torch_field_codegen.py::paired_k4``), its near tiles the
    f32 plain version, against JAX's ``PallasFieldStep`` (interpret mode):
    near tiles within NEAR, bf16 tiles within one bf16 ulp."""
    from test_torch_field_codegen import paired_k4

    tflows, vals = _coupled(mt, seed=7)
    jflows, _ = _coupled(mm)
    block, shape = (8, 128), (40, 640)
    tv = {k: torch.from_numpy(v) for k, v in vals.items()}
    plan = k4.plan_field(tflows, ("a", "b"), shape, torch.float32, ns,
                         block, compute_dtype=BF)
    got = fs.with_bf16_rect(
        k4.field_step_plain(tv, tflows, nsteps=ns),
        lambda: paired_k4(plan.program16,
                          {n: fs.rb(tv[n]) for n in plan.program16.channels},
                          mt.core.cell.MOORE_OFFSETS, ns, plan.rows16),
        shape, torch.float32, block, ns)
    want = jps.PallasFieldStep(shape, jflows, block=block, interpret=True,
                               nsteps=ns, compute_dtype=jnp.bfloat16)(
        {k: jnp.asarray(v) for k, v in vals.items()})
    mask = _split(shape, block, ns)
    for n in ("a", "b"):
        _held(got[n].numpy(), np.asarray(want[n]), mask, ns)


def test_k4_near_tiles_are_plain_f32():
    tflows, vals = _coupled(mt, seed=6)
    tv = {k: torch.from_numpy(v) for k, v in vals.items()}
    got = k4.field_step_plain(tv, tflows, nsteps=4, compute_dtype=BF,
                              block=(8, 128))
    f32 = k4.field_step_plain(tv, tflows, nsteps=4)
    near = ~torch.from_numpy(_split((40, 640), (8, 128), 4))
    for n in ("a", "b"):
        assert torch.equal(got[n][near], f32[n][near])
        assert not torch.equal(got[n][~near], f32[n][~near])


class _NumpyScalar(Flow):
    """An outflow with a numpy f32 scalar: JAX promotes it to f32."""

    footprint = "pointwise"

    def __init__(self, attr="a"):
        self.attr = attr

    def outflow(self, values, origin=(0, 0)):
        return np.float32(0.05) * values[self.attr]

    def fingerprint(self):
        return ("np32", self.attr)


class _CastBack(Flow):
    """f32 intermediates cast back to the channel's dtype stay bf16."""

    footprint = "pointwise"

    def __init__(self, attr="a"):
        self.attr = attr

    def outflow(self, values, origin=(0, 0)):
        v = values[self.attr]
        return (v.to(torch.float32) * np.float32(0.05)).to(v.dtype)

    def fingerprint(self):
        return ("cast", self.attr)


def test_k4_lowering_follows_jax_promotion():
    """Python floats are weak (bf16 constants), numpy scalars strong (f32):
    an outflow left in f32 is refused (its channel would change type
    between steps); one cast back is a bf16 program with an f32 part."""
    prog = fl.lower_flows([mt.Diffusion(0.1, "a"),
                           mt.Coupled(0.05, "a", "b")], ("a", "b"), BF)
    consts = [x[2] for op, *_, a, b in prog.code for x in (a, b)
              if x[0] == fl.K_CONST and op != fl.OP_ACC]
    assert consts == [fs.round_bf16(0.1), fs.round_bf16(0.05)]
    assert all(prog.rounds)
    with pytest.raises(ValueError, match="float32 under bf16"):
        fl.lower_flows([_NumpyScalar()], ("a",), BF)
    p2 = fl.lower_flows([_CastBack()], ("a",), BF)
    ops = [c[0] for c in p2.code]
    assert ops == [fl.OP_MUL, fl.OP_RND, fl.OP_ACC]
    assert p2.rounds == (False, True, True)
    # the f32 lowering is unchanged by the typing: no rounding flags
    assert fl.lower_flows([_NumpyScalar()], ("a",)).rounds == ()
    with pytest.raises(k4.FieldPlanError):
        k4.plan_field([_NumpyScalar()], ("a",), (16, 128), torch.float32, 2,
                      compute_dtype=BF)


# -- the slice through its entry points ---------------------------------------------

def test_serial_executor_matches_jax_and_keeps_steps_apart():
    """``Model.execute`` through ``SerialExecutor("pallas", substeps=4)``
    with bf16 interior math: 8 steps (two K1 calls) against JAX's
    executor in interpret mode; the step cache keeps f32 and bf16 apart."""
    v = _grid(seed=20)
    ts = mt.CellularSpace.create(*SHAPE, 1.0, device="cpu").with_values(
        {"value": torch.from_numpy(v)})
    js = mm.CellularSpace.create(*SHAPE, 1.0, dtype=jnp.float32
                                 ).with_values({"value": jnp.asarray(v)})
    tmodel, jmodel = mt.Model(mt.Diffusion(RATE)), mm.Model(
        mm.Diffusion(RATE))
    out, rep = tmodel.execute(ts, mt.SerialExecutor(
        "pallas", substeps=4, compute_dtype=BF), steps=8,
        check_conservation=False)
    jout, _ = jmodel.execute(js, JSerial(
        "pallas", substeps=4, compute_dtype=jnp.bfloat16), steps=8,
        check_conservation=False)
    assert rep.impl == "pallas"
    got, want = out.values["value"].numpy(), np.asarray(jout.values["value"])
    mask = _split(SHAPE, fs.resolve_block(SHAPE, torch.float32), 4)
    d = np.abs(got.astype(np.float64) - want)
    assert d[~mask].max() <= near_tol(8, want)
    if mask.any():
        assert d[mask].max() <= interior_tol(want)
    s16 = tmodel.make_step(ts, impl="pallas", substeps=4, compute_dtype=BF)
    s32 = tmodel.make_step(ts, impl="pallas", substeps=4)
    assert s16 is not s32
    assert s16 is tmodel.make_step(ts, impl="pallas", substeps=4,
                                   compute_dtype="bfloat16")


def test_active_runners_take_the_knob_bit_for_bit():
    """The active runners' dense fallback is K1 at one step, where the knob
    changes nothing: the bf16 run is the f32 run bit for bit."""
    v = np.zeros((64, 128), np.float32)
    v[20:40, 40:80] = _grid((20, 40), seed=21)
    s = mt.CellularSpace.create(64, 128, 0.0, device="cpu").with_values(
        {"value": torch.from_numpy(v)})
    m = mt.Model(mt.Diffusion(RATE))
    for impl in ("active", "active_fused"):
        a, _ = m.execute(s, mt.SerialExecutor(impl, compute_dtype=BF),
                         steps=3)
        b, _ = m.execute(s, mt.SerialExecutor(impl), steps=3)
        assert torch.equal(a.values["value"], b.values["value"])


@pytest.mark.parametrize("impl", ["pallas", "composed"])
def test_shardmap_executor_takes_the_knob(impl):
    """ShardMapExecutor with bf16 interior math: each chunk is the halo
    plain version at the shard's origin (here the whole run against the
    shards stepped one by one)."""
    from mpi_model_tpu_torch.parallel import (ShardMapExecutor, assemble,
                                              exchange_ring, make_mesh_2d)
    from mpi_model_tpu_torch.parallel.mesh import shard_tensor

    G = _grid(HALO_G, seed=22)
    s = mt.CellularSpace.create(*HALO_G, 1.0, device="cpu").with_values(
        {"value": torch.from_numpy(G)})
    mesh = make_mesh_2d(2, 2, devices=[torch.device("cpu")] * 4)
    ex = ShardMapExecutor(mesh, impl, halo_depth=4, compute_dtype=BF)
    out, _ = mt.Model(mt.Diffusion(RATE)).execute(s, ex, steps=4,
                                                  check_conservation=False)
    h, w = HALO_G[0] // 2, HALO_G[1] // 2
    g = shard_tensor(torch.from_numpy(G), mesh, h, w)
    step = fs.pallas_halo_step if impl == "pallas" else None
    shards = [[None, None], [None, None]]
    for i in range(2):
        for j in range(2):
            ring = exchange_ring(g, i, j, 4)
            if step is not None:
                shards[i][j] = step(g[i][j], ring, (i * h, j * w), HALO_G,
                                    RATE, nsteps=4, compute_dtype=BF)
            else:
                shards[i][j] = cs.composed_halo_step(
                    g[i][j], ring, (i * h, j * w), HALO_G, RATE, 4,
                    compute_dtype=BF)
    assert torch.equal(out.values["value"],
                       assemble(shards, torch.device("cpu")))


def test_cli_compute_dtype_row_matches_jax(capsys):
    """The CLI row: at one step a call (JAX's own knob test) the run is
    conserved and equals the f32 run; at ``--substeps=4`` it is within
    the bf16 bound of JAX's CLI."""
    base = ["run", "--flow=diffusion", "--dimx=64", "--dimy=512",
            "--steps=8", "--impl=pallas", "--dtype=float32", "--json"]
    assert cli_main(base + ["--device=cpu", "--compute-dtype=bfloat16"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["impl"] == "pallas" and row["conserved"] is True
    assert cli_main(base + ["--device=cpu"]) == 0
    row32 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["final"] == row32["final"]
    cli_main(base + ["--device=cpu", "--compute-dtype=bfloat16",
                     "--substeps=4"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jcli.main(base + ["--compute-dtype=bfloat16", "--substeps=4"])
    jrow = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["impl"] == jrow["impl"] == "pallas"
    total = jrow["final"]["value"]
    assert abs(row["final"]["value"] - total) <= 2.0 ** -8 * abs(total)


@pytest.mark.parametrize("argv,match", [
    (["--impl=xla", "--compute-dtype=bfloat16"], "Pallas"),
    (["--mesh=4", "--executor=gspmd", "--compute-dtype=bfloat16"], "gspmd"),
])
def test_cli_refuses_the_knob_where_jax_does(argv, match):
    with pytest.raises(SystemExit, match=match):
        cli_main(["run", "--device=cpu", *argv])
    with pytest.raises(SystemExit, match=match):
        jcli.main(["run", *argv])


def test_resolve_compute_dtype():
    assert fs.resolve_compute_dtype(None) is None
    assert fs.resolve_compute_dtype(torch.float32) is None
    assert fs.resolve_compute_dtype("float32") is None
    assert fs.resolve_compute_dtype("bfloat16") is BF
    with pytest.raises(ValueError, match="compute_dtype"):
        fs.resolve_compute_dtype(torch.float16)


# -- the re-read of K4 against _field_call (sign of zero) ---------------------

def test_k4_inflow_starts_from_zero_like_jax_plain_transport():
    """K4 (and its plain version) sum a cell's inflow from 0 in ``offsets``
    order, as the JAX package's plain transport does
    (``ops/stencil.py::gather_neighbors``); its ``_field_call`` starts from
    the first share. The two differ only where every share is -0.0 and
    ``v - of`` is -0.0: JAX's kernel leaves -0.0 there, the plain
    transport and the port +0.0. Every value is equal."""
    from mpi_model_tpu.ops import stencil as jst

    h, w = 16, 128
    a = np.full((h, w), -0.0, np.float32)
    m = np.ones((h, w), np.float32)
    m[7, 60] = -1.0   # its outflow 0.05 * -0.0 * -1 = +0.0, its shares -0.0
    tflows = [mt.Coupled(0.05, "a", "m")]
    jflows = [mm.Coupled(0.05, "a", "m")]
    got = k4.field_step_plain({"a": torch.from_numpy(a),
                               "m": torch.from_numpy(m)}, tflows)["a"]
    want = np.asarray(jps.PallasFieldStep((h, w), jflows, interpret=True)(
        {"a": jnp.asarray(a), "m": jnp.asarray(m)})["a"])
    of = jflows[0].outflow({"a": jnp.asarray(a), "m": jnp.asarray(m)})
    counts = jst.neighbor_counts_traced((h, w))
    plain = np.asarray(jst.transport(jnp.asarray(a), of, counts))
    assert np.array_equal(got.numpy(), want)   # equal values
    diff = np.signbit(got.numpy()) != np.signbit(want)
    assert diff.sum() == 1 and diff[7, 60]
    assert not np.signbit(got.numpy()[7, 60]) and np.signbit(want[7, 60])
    assert np.array_equal(np.signbit(got.numpy()), np.signbit(plain))
