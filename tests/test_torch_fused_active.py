"""K6/K7's module in the port (``ops/fused_active.py``) against the JAX
package's ``ops/pallas_active.py`` (its Pallas kernels in interpret mode), on
the CPU.

On CPU tensors ``fused_compute``/``fused_scatter`` run their plain versions;
the CUDA kernels are held against those bit for bit on the card
(``chip_smoke.py`` and ``tests/test_torch_cuda.py``).

- ``choose_fused_k`` and ``pass_count`` equal JAX's; the same calls are
  refused with the same messages;
- k=1: a fused pass and the fused runner equal ``ops.active.active_pass``
  and the dense step (``oracle.dense_flow_step_np``) bit for bit at f64 and
  f32, with the in-kernel flags equal; against JAX's interpret-mode kernel
  they agree within ``2·eps·steps·max|v|`` (XLA's CPU compile contracts one
  multiply-add per step there; see ``tests/test_torch_active.py``);
- k>1: near-edge and frontier tiles take the iterated path and equal k
  dense steps bit for bit; interior tap tiles are held at
  ``atol = rtol = 1e-6·k`` (f32) and ``1e-12`` (f64);
- the slice: ``SerialExecutor("active_fused")`` against JAX's executor of
  the same name (values, report, counter identity, dirty tiles), the
  fallback, capacity overflow, point flows through ``make_step``.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mpi_model_tpu as mm
from mpi_model_tpu.models.model import SerialExecutor as JSerial
from mpi_model_tpu.ops import active as jact
from mpi_model_tpu.ops import pallas_active as jpa
from mpi_model_tpu.oracle import dense_flow_step_np, point_flow_step_np

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch import interop
from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS, VON_NEUMANN_OFFSETS
from mpi_model_tpu_torch.ops import active as act
from mpi_model_tpu_torch.ops import fused_active as fa
from mpi_model_tpu_torch.ops.stencil import neighbor_counts, transport

CUSTOM = ((-1, 0), (1, 1), (0, -1))


def blob(g, frac, seed=0, dtype=np.float64, corner=False):
    rng = np.random.default_rng(seed)
    side = max(1, int(g * np.sqrt(frac)))
    v = np.zeros((g, g))
    lo = (g - side) // 2
    v[lo:lo + side, lo:lo + side] = rng.uniform(0.5, 1.5, (side, side))
    if corner:
        v[0:4, 0:4] = rng.uniform(0.5, 1.5, (4, 4))
    return v.astype(dtype)


def oracle_steps(v, rate, n, offs=MOORE_OFFSETS):
    for _ in range(n):
        v = dense_flow_step_np(v, rate, offsets=offs)
    return v


def assert_near_jax(got, want, steps):
    got = np.asarray(got)
    tol = 2.0 * np.finfo(got.dtype).eps * steps * np.abs(got).max()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


def spaces(values: dict):
    first = next(iter(values.values()))
    ts = interop.space_from_numpy(values, device="cpu")
    js = mm.CellularSpace.create(*first.shape, {k: 0.0 for k in values},
                                 dtype=jnp.dtype(first.dtype))
    return ts, js.with_values({k: jnp.asarray(v) for k, v in values.items()})


def active_set(v, plan):
    tmap = act.tile_nonzero_map(v, plan)
    flags = act.dilate_tile_map(tmap)
    ids, count = act.compact_tile_ids(flags, plan)
    selfnz = tmap.reshape(-1)[ids.long()].to(torch.int32)
    return tmap, ids, count, selfnz


def test_choose_fused_k_and_pass_count_match_jax():
    for tile in ((8, 8), (16, 24), (4, 32), (128, 128)):
        plan = act.plan_for((256, 384), tile=tile)
        jplan = jact.plan_for((256, 384), tile=tile)
        for sub in (1, 2, 4, 6, 8, 11, 12, 16, 17, 32):
            assert fa.choose_fused_k(sub, plan) == \
                jpa.choose_fused_k(sub, jplan), (tile, sub)
    for steps in (0, 1, 7, 8, 20, 63):
        for k in (1, 3, 4, 8, 16):
            assert fa.pass_count(steps, k) == jpa.pass_count(steps, k)
    assert fa.MAX_FUSED_K == jpa.MAX_FUSED_K
    with pytest.raises(ValueError) as t_exc:
        fa.choose_fused_k(0, act.plan_for((64, 64)))
    with pytest.raises(ValueError) as j_exc:
        jpa.choose_fused_k(0, jact.plan_for((64, 64)))
    assert str(t_exc.value) == str(j_exc.value)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("offs", [MOORE_OFFSETS, CUSTOM])
def test_k1_pass_bitwise_against_active_pass_and_dense(dtype, offs):
    v = blob(64, 0.02, seed=4, dtype=dtype, corner=True)
    plan = act.plan_for((64, 64), tile=(16, 16), max_active_frac=1.0)
    x = torch.from_numpy(v)
    _, ids, count, selfnz = active_set(x, plan)
    padded = torch.nn.functional.pad(x, (1, 1, 1, 1))
    got_p, anyf = fa.fused_active_pass(padded.clone(), ids, count, selfnz,
                                       0.1, plan, (0, 0), (64, 64), offs,
                                       x.dtype)
    ref_p, _, ref_f = act.active_pass(
        padded.clone(), torch.zeros((plan.capacity, 16, 16), dtype=x.dtype),
        ids, count, 0.1, plan, (0, 0), (64, 64), offs, x.dtype)
    assert torch.equal(got_p, ref_p) and torch.equal(anyf, ref_f)
    assert np.array_equal(got_p[1:-1, 1:-1].numpy(),
                          dense_flow_step_np(v, 0.1, offsets=offs))
    jplan = jact.plan_for((64, 64), tile=(16, 16), max_active_frac=1.0)
    jp, jf = jax.jit(lambda p, i, c, s: jpa.fused_active_pass(
        p, i, c, s, 0.1, jplan, jnp.zeros((2,), jnp.int32), (64, 64), offs,
        jnp.dtype(dtype)))(jnp.pad(jnp.asarray(v), 1),
                           jnp.asarray(ids.numpy()), jnp.int32(int(count)),
                           jnp.asarray(selfnz.numpy()))
    assert_near_jax(got_p.numpy(), jp, 1)
    assert np.array_equal(anyf.numpy(), np.asarray(jf))


def test_empty_grid_pass_is_identity():
    # count == 0: lane 0 still computes (tile 0 of a zero grid is zero)
    plan = act.plan_for((32, 32), tile=(16, 16))
    padded = torch.zeros((34, 34), dtype=torch.float64)
    ids = torch.zeros(plan.capacity, dtype=torch.int32)
    out, anyf = fa.fused_active_pass(padded, ids, 0, ids, 0.1, plan, (0, 0),
                                     (32, 32), MOORE_OFFSETS, torch.float64)
    assert not out.any() and not anyf.any()


@pytest.mark.parametrize("kw", [dict(k=9), dict(k=2, ring=1)])
def test_pass_validation_matches_jax(kw):
    plan = act.plan_for((32, 32), tile=(8, 8))
    jplan = jact.plan_for((32, 32), tile=(8, 8))
    z = torch.zeros(plan.capacity, dtype=torch.int32)
    with pytest.raises(ValueError) as t_exc:
        fa.fused_active_pass(torch.zeros((34, 34), dtype=torch.float64), z,
                             0, z, 0.1, plan, (0, 0), (32, 32),
                             MOORE_OFFSETS, torch.float64, **kw)
    jz = jnp.zeros((plan.capacity,), jnp.int32)
    with pytest.raises(ValueError) as j_exc:
        jpa.fused_active_pass(jnp.zeros((34, 34)), jz, jnp.int32(0), jz,
                              0.1, jplan, jnp.zeros((2,), jnp.int32),
                              (32, 32), MOORE_OFFSETS, jnp.float64, **kw)
    assert str(t_exc.value) == str(j_exc.value)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 4e-6)])
def test_composed_k_pass_exact_band_and_interior_tolerance(dtype, tol):
    """k=4 on a ring-4 state: the near-edge corner tile and the frontier
    tiles take the iterated path (bitwise k dense steps); the interior
    self-lit tiles take the taps (``1e-12`` f64, ``1e-6·k`` f32)."""
    g, t, k = 96, 16, 4
    v = blob(g, 0.05, seed=3, dtype=dtype, corner=True)
    x = torch.from_numpy(v)
    plan = act.plan_for((g, g), tile=(t, t), max_active_frac=1.0)
    tmap, ids, count, selfnz = active_set(x, plan)
    padded = torch.nn.functional.pad(x, (k, k, k, k))
    taps = fa._fused_taps(0.1, MOORE_OFFSETS, k)
    got_p, anyf = fa.fused_active_pass(padded, ids, count, selfnz, 0.1,
                                       plan, (0, 0), (g, g), MOORE_OFFSETS,
                                       x.dtype, k=k, ring=k, taps=taps)
    got = got_p[k:-k, k:-k].numpy()
    want = oracle_steps(v, 0.1, k)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    # bitwise outside the interior self-lit tiles
    lit = tmap.numpy().repeat(t, 0).repeat(t, 1)
    edge = np.zeros_like(lit)
    edge[:t, :] = edge[-t:, :] = edge[:, :t] = edge[:, -t:] = True
    iterated = ~lit | edge
    assert np.array_equal(got[iterated], want[iterated])
    assert lit[~edge].any() and (got[lit & ~edge] != want[lit & ~edge]).any()
    # JAX's interpret-mode kernel: the same forms, the same tolerance
    jplan = jact.plan_for((g, g), tile=(t, t), max_active_frac=1.0)
    jp, jf = jax.jit(lambda p, i, c, s: jpa.fused_active_pass(
        p, i, c, s, 0.1, jplan, jnp.zeros((2,), jnp.int32), (g, g),
        MOORE_OFFSETS, jnp.dtype(dtype), k=k, ring=k, taps=taps))(
        jnp.pad(jnp.asarray(v), k), jnp.asarray(ids.numpy()),
        jnp.int32(int(count)), jnp.asarray(selfnz.numpy()))
    np.testing.assert_allclose(got, np.asarray(jp)[k:-k, k:-k], rtol=tol,
                               atol=tol)
    assert np.array_equal(anyf.numpy(), np.asarray(jf))


def test_bf16_plain_pass_rounds_every_operation_like_active_pass():
    """At bf16 the pass computes in bf16, every operation rounded: k=1
    equals the plain active step and the plain dense transport bit for
    bit."""
    v = blob(64, 0.05, seed=8, dtype=np.float32, corner=True)
    x = torch.from_numpy(v).to(torch.bfloat16)
    plan = act.plan_for((64, 64), tile=(16, 16), max_active_frac=1.0)
    _, ids, count, selfnz = active_set(x, plan)
    padded = torch.nn.functional.pad(x, (1, 1, 1, 1))
    got_p, _ = fa.fused_active_pass(padded.clone(), ids, count, selfnz, 0.1,
                                    plan, (0, 0), (64, 64), MOORE_OFFSETS,
                                    torch.bfloat16)
    ref_p, _, _ = act.active_pass(
        padded.clone(), torch.zeros((plan.capacity, 16, 16),
                                    dtype=torch.bfloat16),
        ids, count, 0.1, plan, (0, 0), (64, 64), MOORE_OFFSETS,
        torch.bfloat16)
    counts = neighbor_counts((64, 64), MOORE_OFFSETS, dtype=torch.bfloat16)
    dense = transport(x, torch.tensor(0.1, dtype=torch.bfloat16) * x, counts)
    assert torch.equal(got_p, ref_p)
    assert torch.equal(got_p[1:-1, 1:-1], dense)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("frac", [0.01, 0.08])
def test_k1_runner_bitwise_against_dense_and_near_jax(dtype, frac):
    v = blob(96, frac, seed=7, dtype=dtype)
    opts = dict(tile=(16, 16), max_active_frac=1.0)
    run = fa.build_fused_runner((96, 96), {"value": 0.1}, MOORE_OFFSETS,
                                torch.from_numpy(v).dtype,
                                plan=act.plan_for((96, 96), **opts),
                                track_dirty=True)
    out, (fb, at, ff, dirty) = run({"value": torch.from_numpy(v)}, 6)
    got = out["value"].numpy()
    assert np.array_equal(got, oracle_steps(v, 0.1, 6))
    jrun = jax.jit(jpa.build_fused_runner(
        (96, 96), {"value": 0.1}, MOORE_OFFSETS, jnp.dtype(dtype),
        plan=jact.plan_for((96, 96), **opts), track_dirty=True,
        interpret=True))
    jout, (jfb, jat, jff, jdirty) = jrun({"value": jnp.asarray(v)},
                                         jnp.int32(6))
    assert_near_jax(got, jout["value"], 6)
    assert (fb, float(at), ff) == (int(jfb), float(jat), int(jff)) == \
        (0, float(at), 6)
    np.testing.assert_array_equal(dirty.numpy(), np.asarray(jdirty))


@pytest.mark.parametrize("substeps,steps", [(1, 8), (4, 8), (4, 10)])
def test_executor_matches_jax_fused_executor(substeps, steps):
    v = blob(96, 0.02, seed=3, corner=True)
    ts, js = spaces({"value": v})
    opts = {"tile": (16, 16), "max_active_frac": 1.0}
    tex = mt.SerialExecutor("active_fused", substeps=substeps,
                            active_opts=opts)
    jex = JSerial("active_fused", substeps=substeps, active_opts=opts)
    tout, trep = mt.Model(mt.Diffusion(0.1)).execute(ts, tex, steps=steps)
    jout, jrep = mm.Model(mm.Diffusion(0.1)).execute(js, jex, steps=steps)
    got = tout.values["value"].numpy()
    want = oracle_steps(v, 0.1, steps)
    if substeps == 1:
        assert np.array_equal(got, want)
        assert_near_jax(got, jout.values["value"], steps)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
        np.testing.assert_allclose(got, np.asarray(jout.values["value"]),
                                   rtol=0, atol=1e-13)
    tb, jb = trep.backend_report, jrep.backend_report
    assert set(jb) <= set(tb) and {k: tb[k] for k in jb} == jb
    assert tb["flags_fused"] + tb["fallback_steps"] == tb["passes"]
    # the CPU ran the plain versions: no kernel launch is counted
    assert tb["launches"] == 0
    td, jd = tex.last_dirty_tiles, jex.last_dirty_tiles
    np.testing.assert_array_equal(td["map"], np.asarray(jd["map"]))


def test_fallback_capacity_and_counter_identity():
    # a fully lit grid trips the threshold every pass: dense fallback
    full = np.random.default_rng(3).uniform(0.5, 1.5, (64, 64))
    ts, _ = spaces({"value": full})
    ex = mt.SerialExecutor("active_fused", active_opts={
        "tile": (8, 8), "max_active_frac": 0.25})
    out, rep = mt.Model(mt.Diffusion(0.1)).execute(ts, ex, steps=5)
    br = rep.backend_report
    assert br["fallback_steps"] == 5 and br["flags_fused"] == 0
    assert np.array_equal(out.values["value"].numpy(),
                          oracle_steps(full, 0.1, 5))
    # capacity overflow falls back the same step, never truncates
    pt = np.zeros((96, 96))
    pt[64, 64], pt[10, 13] = 1.7, 2.2
    ts, _ = spaces({"value": pt})
    ex = mt.SerialExecutor("active_fused",
                           active_opts={"tile": (8, 8), "capacity": 2})
    out, rep = mt.Model(mt.Diffusion(0.1)).execute(ts, ex, steps=6)
    assert rep.backend_report["fallback_steps"] == 6
    assert np.array_equal(out.values["value"].numpy(),
                          oracle_steps(pt, 0.1, 6))
    # two live channels: flags_fused + fallback_steps == passes × attrs
    rng = np.random.default_rng(5)
    va, vb = np.zeros((64, 64)), np.zeros((64, 64))
    va[10:14, 10:14] = rng.uniform(0.5, 1.5, (4, 4))
    vb[40:44, 40:44] = rng.uniform(0.5, 1.5, (4, 4))
    ts, _ = spaces({"a": va, "b": vb})
    model = mt.Model([mt.Diffusion(0.1, attr="a"),
                      mt.Diffusion(0.3, attr="b")])
    ex = mt.SerialExecutor("active_fused", active_opts={
        "tile": (8, 8), "max_active_frac": 0.9})
    out, rep = model.execute(ts, ex, steps=6)
    br = rep.backend_report
    assert br["flags_fused"] + br["fallback_steps"] == br["passes"] * 2
    for key, rate, v in (("a", 0.1, va), ("b", 0.3, vb)):
        assert np.array_equal(out.values[key].numpy(),
                              oracle_steps(v, rate, 6)), key


def test_make_step_k_contract_and_point_flows():
    v = blob(64, 0.01, seed=6)
    ts, js = spaces({"value": v})
    tm = mt.Model(mt.Diffusion(0.1))
    jm = mm.Model(mm.Diffusion(0.1))
    for sub in (1, 4, 6):
        a = tm.make_step(ts, impl="active_fused", substeps=sub)
        b = jm.make_step(js, impl="active_fused", substeps=sub)
        assert (a.impl, a.composed_k, a.composed_passes) == \
            (b.impl, b.composed_k, b.composed_passes)
    with pytest.warns(RuntimeWarning, match="auto-k degenerated"):
        step = tm.make_step(ts, impl="active_fused", substeps=17)
    assert step.composed_k == 1 and step.composed_passes == 17
    pt = mt.Model([mt.Diffusion(0.1), mt.PointFlow((5, 60), 0.4)])
    jpt = mm.Model([mm.Diffusion(0.1), mm.PointFlow((5, 60), 0.4)])
    with pytest.raises(ValueError) as t_exc:
        pt.make_step(ts, impl="active_fused", substeps=2)
    with pytest.raises(ValueError) as j_exc:
        jpt.make_step(js, impl="active_fused", substeps=2)
    assert str(t_exc.value) == str(j_exc.value)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tstep = pt.make_step(ts, impl="active_fused")
    tv, want = dict(ts.values), v
    for _ in range(3):
        tv = tstep(tv)
        amount = 0.4 * want[5, 60]
        want = point_flow_step_np(dense_flow_step_np(want, 0.1), 5, 60,
                                  amount)
    np.testing.assert_allclose(tv["value"].numpy(), want, rtol=0,
                               atol=1e-15)
    out, rep = pt.execute(ts, mt.SerialExecutor("active_fused"), steps=3)
    assert rep.impl == "active_fused"
    assert rep.backend_report["composed_k"] == 1
    assert np.array_equal(out.values["value"].numpy(), tv["value"].numpy())


def test_wrappers_on_cpu_launch_nothing_and_check_shared_memory():
    v = blob(64, 0.05, seed=2, corner=True)
    x = torch.from_numpy(v)
    plan = act.plan_for((64, 64), tile=(16, 16), max_active_frac=1.0)
    _, ids, count, selfnz = active_set(x, plan)
    before = fa.launches()
    ex = mt.SerialExecutor("active_fused",
                           active_opts={"tile": (16, 16)})
    mt.Model(mt.Diffusion(0.1)).execute(
        interop.space_from_numpy({"value": v}, device="cpu"), ex, steps=3)
    assert fa.launches() == before
    # every admitted (dtype, k, tile) fits the 227 KB a block may use
    for dtype in fa.KERNEL_DTYPES:
        for k in range(1, fa.MAX_FUSED_K + 1):
            assert fa.smem_bytes(dtype, (128, 128), k) <= fa.SMEM_LIMIT
    assert fa.smem_bytes(torch.float64, (128, 128), 16) == 2 * 64 * 64 * 8
    upd, anyf = fa.fused_compute(
        torch.nn.functional.pad(x, (1, 1, 1, 1)), ids,
        count.reshape(1), selfnz, rate=0.1, plan=plan, origin=(0, 0),
        global_shape=(64, 64), offsets=MOORE_OFFSETS, dtype=x.dtype, k=1,
        ring=1)
    assert upd.shape == (plan.capacity, 16, 16) and anyf.dtype == torch.int32
    assert int(anyf.sum()) > 0
