"""The plain active-tile engine in the port (``ops/active.py``) against the
JAX package's ``ops/active.py``, on the CPU.

- the plan, the tile maps, the compaction and the next-step map equal the
  JAX package's;
- ``active_pass`` and ``build_active_runner`` equal the dense step
  (``oracle.dense_flow_step_np``) bit for bit at f64 and f32, and JAX's
  (jitted, as its executors run them) within ``2·eps·steps·max|v|``, with
  equal stats and dirty map. Under this jax, XLA's CPU compile contracts
  ``v - rate*v`` into an FMA inside the jitted JAX engines (their
  ``optimization_barrier`` does not stop it), which moves a cell by up to
  one ulp of the largest term per step; the port computes the
  uncontracted expression the engine's contract names;
- the slice: ``SerialExecutor("active")`` through ``Model.execute`` against
  the JAX executor of the same name (values, report, dirty tiles), and the
  dense side held to ``oracle.dense_flow_step_np``, never to a JAX
  ``impl="xla"`` run (which does not run under this jax);
- the fallback engaging and being counted, capacity overflow, point flows
  composing through ``make_step``, and the JAX package's refusals.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mpi_model_tpu as mm
from mpi_model_tpu.models.model import SerialExecutor as JSerial
from mpi_model_tpu.ops import active as jact
from mpi_model_tpu.oracle import dense_flow_step_np, point_flow_step_np

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch import interop
from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS, VON_NEUMANN_OFFSETS
from mpi_model_tpu_torch.ops import active as act

CUSTOM = ((-1, 0), (1, 1), (0, -1))
NP = {"float64": np.float64, "float32": np.float32}


def blob(g, frac, seed=0, dtype="float64", corner=False):
    """A centred square covering ~``frac`` of a g x g grid (and, with
    ``corner``, a patch on the top-left corner)."""
    rng = np.random.default_rng(seed)
    side = max(1, int(g * np.sqrt(frac)))
    v = np.zeros((g, g))
    lo = (g - side) // 2
    v[lo:lo + side, lo:lo + side] = rng.uniform(0.5, 1.5, (side, side))
    if corner:
        v[0:3, 0:4] = rng.uniform(0.5, 1.5, (3, 4))
    return v.astype(NP[dtype])


def oracle_steps(v, rate, n, offs=MOORE_OFFSETS):
    for _ in range(n):
        v = dense_flow_step_np(v, rate, offsets=offs)
    return v


def assert_near_jax(got, want, steps):
    """Within ``2·eps·steps·max|v|`` of the JAX package's jitted engines
    (their CPU compile contracts one multiply-add per step; see above)."""
    got = np.asarray(got)
    tol = 2.0 * np.finfo(got.dtype).eps * steps * np.abs(got).max()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


def spaces(values: dict):
    first = next(iter(values.values()))
    jdt = jnp.dtype(first.dtype)
    ts = interop.space_from_numpy(values, device="cpu")
    js = mm.CellularSpace.create(*first.shape, {k: 0.0 for k in values},
                                 dtype=jdt)
    return ts, js.with_values({k: jnp.asarray(v) for k, v in values.items()})


BENCH = (2 ** 14, 2 ** 14)  # the bench grid's plan; no grid is built


@pytest.mark.parametrize("shape,kw", [
    ((64, 64), {}), ((96, 120), {"tile": (24, 24)}),
    (BENCH, {}), (BENCH, {"max_active_frac": 0.05}),
    ((100, 60), {"capacity": 7}), ((37, 41), {"preferred_tile": 16}),
    ((64, 64), {"tile": (8, 8), "capacity": 2, "max_active_frac": 0.9}),
])
def test_plan_for_matches_jax_field_for_field(shape, kw):
    got = dataclasses.asdict(act.plan_for(shape, **kw))
    want = dataclasses.asdict(jact.plan_for(shape, **kw))
    assert got == want
    assert act.plan_for(shape, **kw).ntiles == jact.plan_for(shape, **kw).ntiles


@pytest.mark.parametrize("kw", [{"tile": (7, 8)}, {"capacity": 0},
                                {"max_active_frac": 0.0},
                                {"max_active_frac": 1.5}])
def test_plan_for_refuses_like_jax(kw):
    with pytest.raises(ValueError) as t_exc:
        act.plan_for((64, 64), **kw)
    with pytest.raises(ValueError) as j_exc:
        jact.plan_for((64, 64), **kw)
    assert str(t_exc.value) == str(j_exc.value)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tile_maps_and_compaction_match_jax(seed):
    rng = np.random.default_rng(seed)
    plan = act.plan_for((96, 120), tile=(8, 12), capacity=30)
    jplan = jact.plan_for((96, 120), tile=(8, 12), capacity=30)
    v = np.where(rng.uniform(size=(96, 120)) < 0.004,
                 rng.uniform(0.5, 1.5, (96, 120)), 0.0)
    tmap = act.tile_nonzero_map(torch.from_numpy(v), plan)
    jmap = jact.tile_nonzero_map(jnp.asarray(v), jplan)
    np.testing.assert_array_equal(tmap.numpy(), np.asarray(jmap))
    flags = act.dilate_tile_map(tmap)
    jflags = jact.dilate_tile_map(jmap)
    np.testing.assert_array_equal(flags.numpy(), np.asarray(jflags))
    ids, count = act.compact_tile_ids(flags, plan)
    jids, jcount = jact.compact_tile_ids(jflags, jplan)
    assert ids.dtype == torch.int32 and int(count) == int(jcount)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    anyf = torch.from_numpy(rng.uniform(size=plan.capacity) < 0.5)
    np.testing.assert_array_equal(
        act.next_tile_map(anyf, ids, count, plan).numpy(),
        np.asarray(jact.next_tile_map(jnp.asarray(anyf.numpy()), jids,
                                      jcount, jplan)))
    w = v.copy()
    w[rng.integers(0, 96), rng.integers(0, 120)] += 1.0
    w[5, 7] = -0.0 if w[5, 7] == 0.0 else w[5, 7]
    np.testing.assert_array_equal(
        act.changed_tile_map(torch.from_numpy(v), torch.from_numpy(w), plan),
        jact.changed_tile_map(v, w, jplan))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("offs", [MOORE_OFFSETS, VON_NEUMANN_OFFSETS, CUSTOM])
def test_active_pass_bitwise_against_jax(dtype, offs):
    v = blob(64, 0.02, seed=4, dtype=dtype, corner=True)
    plan = act.plan_for((64, 64), tile=(16, 16), max_active_frac=1.0)
    jplan = jact.plan_for((64, 64), tile=(16, 16), max_active_frac=1.0)
    flags = act.dilate_tile_map(act.tile_nonzero_map(torch.from_numpy(v),
                                                     plan))
    ids, count = act.compact_tile_ids(flags, plan)
    n = int(count)
    assert 0 < n <= plan.capacity
    padded = torch.nn.functional.pad(torch.from_numpy(v), (1, 1, 1, 1))
    upd = torch.zeros((plan.capacity, 16, 16), dtype=padded.dtype)
    p2, u2, anyf = act.active_pass(padded, upd, ids, count, 0.1, plan,
                                   (0, 0), (64, 64), offs, padded.dtype)
    # the step equals the dense oracle bit for bit
    assert np.array_equal(p2[1:-1, 1:-1].numpy(),
                          dense_flow_step_np(v, 0.1, offsets=offs))
    jp, ju, jf = jax.jit(lambda p, u, i, c: jact.active_pass(
        p, u, i, c, 0.1, jplan, (0, 0), (64, 64), offs, jnp.dtype(dtype)))(
        jnp.pad(jnp.asarray(v), 1), jnp.zeros((16, 16, 16), dtype),
        jnp.asarray(ids.numpy()), jnp.int32(n))
    assert_near_jax(p2.numpy(), jp, 1)
    assert_near_jax(u2[:n].numpy(), np.asarray(ju)[:n], 1)
    assert np.array_equal(anyf.numpy(), np.asarray(jf))
    assert not anyf[n:].any() and anyf[:n].any()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("frac,opts", [
    (0.01, {"tile": (12, 12), "max_active_frac": 1.0}),
    (0.08, {"tile": (24, 24), "max_active_frac": 1.0}),
    (0.3, {"tile": (24, 24), "max_active_frac": 0.25}),   # falls back
])
def test_runner_bitwise_against_jax(dtype, frac, opts):
    v = blob(120, frac, seed=7, dtype=dtype)
    plan = act.plan_for((120, 120), **opts)
    jplan = jact.plan_for((120, 120), **opts)
    run = act.build_active_runner((120, 120), {"value": 0.1}, MOORE_OFFSETS,
                                  torch.from_numpy(v).dtype, plan=plan,
                                  track_dirty=True)
    out, (fb, at, dirty) = run({"value": torch.from_numpy(v)}, 9)
    jrun = jax.jit(jact.build_active_runner(
        (120, 120), {"value": 0.1}, MOORE_OFFSETS, jnp.dtype(dtype),
        plan=jplan, track_dirty=True))
    jout, (jfb, jat, jdirty) = jrun({"value": jnp.asarray(v)}, jnp.int32(9))
    got = out["value"].numpy()
    assert np.array_equal(got, oracle_steps(v, 0.1, 9))
    assert_near_jax(got, jout["value"], 9)
    assert (fb, float(at)) == (int(jfb), float(jat))
    np.testing.assert_array_equal(dirty.numpy(), np.asarray(jdirty))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_executor_matches_jax_active_executor(dtype):
    v = blob(96, 0.03, seed=2, dtype=dtype, corner=True)
    ts, js = spaces({"value": v})
    opts = {"tile": (8, 8), "max_active_frac": 0.9}
    tex = mt.SerialExecutor("active", active_opts=opts)
    jex = JSerial("active", active_opts=opts)
    tout, trep = mt.Model(mt.Diffusion(0.1)).execute(ts, tex, steps=10)
    jout, jrep = mm.Model(mm.Diffusion(0.1)).execute(js, jex, steps=10)
    got = tout.values["value"].numpy()
    assert np.array_equal(got, oracle_steps(v, 0.1, 10))
    assert_near_jax(got, jout.values["value"], 10)
    tb, jb = trep.backend_report, jrep.backend_report
    assert set(jb) <= set(tb) and {k: tb[k] for k in jb} == jb
    assert tb["fallback_steps"] == 0 and tb["launches"] == 0
    assert trep.impl == "active" and tex.last_impl == "active"
    td, jd = tex.last_dirty_tiles, jex.last_dirty_tiles
    assert (td["tile"], td["grid"]) == (jd["tile"], jd["grid"])
    np.testing.assert_array_equal(td["map"], np.asarray(jd["map"]))


def test_fallback_engages_matches_and_is_counted():
    v = np.random.default_rng(3).uniform(0.5, 1.5, (64, 64))
    ts, js = spaces({"value": v})
    opts = {"tile": (8, 8), "max_active_frac": 0.25}
    tout, trep = mt.Model(mt.Diffusion(0.1)).execute(
        ts, mt.SerialExecutor("active", active_opts=opts), steps=5)
    jout, jrep = mm.Model(mm.Diffusion(0.1)).execute(
        js, JSerial("active", active_opts=opts), steps=5)
    assert trep.backend_report["fallback_steps"] == 5
    assert jrep.backend_report["fallback_steps"] == 5
    got = tout.values["value"].numpy()
    assert np.array_equal(got, oracle_steps(v, 0.1, 5))
    assert_near_jax(got, jout.values["value"], 5)


def test_capacity_overflow_falls_back_and_matches():
    v = np.zeros((96, 96))
    v[64, 64] = 1.7
    v[10, 13] = 2.2
    ts, _ = spaces({"value": v})
    ex = mt.SerialExecutor("active", active_opts={"tile": (8, 8),
                                                  "capacity": 2})
    out, rep = mt.Model(mt.Diffusion(0.1)).execute(ts, ex, steps=6)
    assert rep.backend_report["fallback_steps"] == 6
    assert rep.backend_report["capacity"] == 2
    assert np.array_equal(out.values["value"].numpy(),
                          oracle_steps(v, 0.1, 6))


def test_multi_channel_counters_and_quiet_ocean():
    rng = np.random.default_rng(5)
    va = np.zeros((64, 64))
    va[10:14, 10:14] = rng.uniform(0.5, 1.5, (4, 4))
    vb = np.zeros((64, 64))
    vb[40:44, 40:44] = rng.uniform(0.5, 1.5, (4, 4))
    ts, js = spaces({"a": va, "b": vb})
    tm = mt.Model([mt.Diffusion(0.1, attr="a"), mt.Diffusion(0.3, attr="b")])
    jm = mm.Model([mm.Diffusion(0.1, attr="a"), mm.Diffusion(0.3, attr="b")])
    opts = {"tile": (8, 8), "max_active_frac": 0.9}
    tout, trep = tm.execute(ts, mt.SerialExecutor("active",
                                                  active_opts=opts), steps=6)
    jout, jrep = jm.execute(js, JSerial("active", active_opts=opts),
                            steps=6)
    for key, rate, v in (("a", 0.1, va), ("b", 0.3, vb)):
        got = tout.values[key].numpy()
        assert np.array_equal(got, oracle_steps(v, rate, 6)), key
        assert_near_jax(got, jout.values[key], 6)
    assert trep.backend_report["mean_active_fraction"] == \
        jrep.backend_report["mean_active_fraction"]
    # tiles far from the blobs stay exactly zero
    assert (tout.values["a"].numpy()[30:, :30] == 0.0).all()


def test_make_step_composes_with_point_flows_and_partitions():
    v = blob(64, 0.01, seed=6)
    ts, js = spaces({"value": v})
    tm = mt.Model([mt.Diffusion(0.1), mt.PointFlow((5, 60), 0.4)])
    jm = mm.Model([mm.Diffusion(0.1), mm.PointFlow((5, 60), 0.4)])
    tstep = tm.make_step(ts, impl="active")
    jstep = jax.jit(jm.make_step(js, impl="active"))
    assert tstep.impl == "active"
    tv, jv = dict(ts.values), dict(js.values)
    want = v
    for _ in range(4):
        tv, jv = tstep(tv), jstep(jv)
        amount = 0.4 * want[5, 60]
        want = point_flow_step_np(dense_flow_step_np(want, 0.1), 5, 60,
                                  amount)
    got = tv["value"].numpy()
    assert_near_jax(got, jv["value"], 4)
    assert_near_jax(got, want, 4)
    # the executor takes the stateless form for a point-flow model
    out, rep = tm.execute(ts, mt.SerialExecutor("active"), steps=4)
    assert rep.impl == "active"
    assert np.array_equal(out.values["value"].numpy(), got)
    # a partition: counts against the global bounds, no global check
    part = interop.space_from_numpy({"value": v[:32]}, x_init=0, y_init=0,
                                    global_shape=(64, 64), device="cpu")
    pstep = mt.Model(mt.Diffusion(0.1)).make_step(part, impl="active")
    ref = mt.Model(mt.Diffusion(0.1)).make_step(part, impl="xla")
    assert torch.equal(pstep(dict(part.values))["value"],
                       ref(dict(part.values))["value"])


@pytest.mark.parametrize("impl", ["active", "active_fused"])
def test_refusals_match_jax(impl):
    ts, js = spaces({"a": np.ones((16, 16)), "b": np.ones((16, 16))})
    cases = [
        ([mt.Coupled(0.1, attr="a", modulator="b")],
         [mm.Coupled(0.1, attr="a", modulator="b")]),
        ([mt.Diffusion(0.0, attr="a")], [mm.Diffusion(0.0, attr="a")]),
    ]
    for tflows, jflows in cases:
        with pytest.raises(ValueError) as t_exc:
            mt.Model(tflows).make_step(ts, impl=impl)
        with pytest.raises(ValueError) as j_exc:
            mm.Model(jflows).make_step(js, impl=impl)
        assert str(t_exc.value) == str(j_exc.value)
    mixed = mt.CellularSpace.create(16, 16, {"a": 1.0, "b": (1.0, "float32")},
                                    dtype="float64", device="cpu")
    jmixed = mm.CellularSpace.create(16, 16, {"a": 1.0,
                                              "b": (1.0, "float32")},
                                     dtype=jnp.float64)
    with pytest.raises(ValueError) as t_exc:
        mt.Model(mt.Diffusion(0.1, attr="b")).make_step(mixed, impl=impl)
    with pytest.raises(ValueError) as j_exc:
        mm.Model(mm.Diffusion(0.1, attr="b")).make_step(jmixed, impl=impl)
    assert str(t_exc.value) == str(j_exc.value)


def test_all_point_models_take_the_point_path():
    s = mt.CellularSpace.create(32, 32, 1.0, dtype="float64", device="cpu")
    m = mt.Model(mt.PointFlow((3, 4), 0.2))
    for impl in ("active", "active_fused"):
        _, rep = m.execute(s, mt.SerialExecutor(impl), steps=3)
        assert rep.impl == "point"
