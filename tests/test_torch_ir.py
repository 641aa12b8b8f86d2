"""The port's Flow IR (``mpi_model_tpu_torch/ir``) against the JAX
package's (``mpi_model_tpu/ir``): the grammar, the registry, the library's
structures and seeded spaces, the budget reconciliation, and the port's
lowering held to JAX's on the same inputs.

Inputs are the library's seeded blobs with ``np.random.default_rng(seed)``
noise, the same numpy arrays fed to both packages, at 48×40 and f64.

The JAX side runs under the ``jax_ir`` fixture, which binds
``mpi_model_tpu.ir.lower.optimization_barrier`` to
``jax.lax.optimization_barrier`` for the test (``monkeypatch``): under the
installed jax the package's own bridge, ``compat.optimization_barrier``,
raises ``TypeError: argument of type 'PrimitiveBatchersProxy' is not
iterable`` (``mpi_model_tpu/compat.py:125``), so JAX's IR lowering cannot
run on the CPU without it. No file of the JAX package changes.

Tolerance against JAX: bit for bit is what the port aims at (every
operation one IEEE op in the JAX lowering's order); XLA on the CPU still
contracts some multiply-adds inside its fusions, so each channel is held
within ``2·eps64·steps·max|v|``. Readings at 10 steps are above 0 in every
channel, the same for the port's ``xla``, ``composed`` and ``active`` runs
(which are bit for bit each other): the largest 1.11e-15 (``predator_prey``
x, tolerance 9.4e-15), 4.44e-16 (``gray_scott`` u, 5.6e-15), 1.11e-16
(``sir`` S, 4.4e-15); the largest share of a tolerance 0.26
(``gray_scott`` v, 3.33e-16 against 1.3e-15).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_model_tpu as mm
from mpi_model_tpu.ir import lower as jlower

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch import interop
from mpi_model_tpu_torch.ir import expr as texpr
from mpi_model_tpu_torch.ir import lower as tlower

CPU = torch.device("cpu")
LIB = ("diffusion", "gray_scott", "sir", "predator_prey")
NONLINEAR = ("gray_scott", "sir", "predator_prey")
H, W = 48, 40
STEPS = 10
EPS64 = float(np.finfo(np.float64).eps)


@pytest.fixture
def jax_ir(monkeypatch):
    """JAX's IR lowering made runnable on the CPU (see the module
    docstring): its barrier bound to ``jax.lax.optimization_barrier``."""
    monkeypatch.setattr(jlower, "optimization_barrier",
                        jax.lax.optimization_barrier)
    return mm


def _same(a, b) -> bool:
    return all(torch.equal(a.values[k], b.values[k]) for k in b.values)


def _inputs(name: str, seed: int = 0):
    """The JAX library's (model, space) and the port's, on the same numpy
    arrays: the seeded blobs with up to 5% uniform noise taken off every
    state channel (values stay in the models' ranges: Gray-Scott's feed
    needs u <= 1; budgets start at zero)."""
    jm, js = mm.build_model(name, H, W, dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    arrays = {}
    for k, v in js.values.items():
        a = np.asarray(v, np.float64)
        if not k.startswith("_b_"):
            a = a * (1.0 - 0.05 * rng.uniform(0.0, 1.0, a.shape))
        arrays[k] = a
    js = js.with_values({k: jnp.asarray(a) for k, a in arrays.items()})
    tm = interop.ir_model_from_structure(
        jm.term_structure(), jm.term_rates(), time=jm.time,
        time_step=jm.time_step)
    ts = interop.space_from_numpy(arrays, device=CPU)
    return jm, js, tm, ts


# -- the grammar ----------------------------------------------------------------

def test_expr_whitelist_and_operators():
    u, v = mt.Chan("u"), mt.Chan("v")
    e = (1.0 - u) * v ** 2 + texpr.exp(-v) / 2.0
    env = {"u": torch.tensor([[0.5]], dtype=torch.float64),
           "v": torch.tensor([[2.0]], dtype=torch.float64)}
    got = float(texpr.evaluate(e, env, torch.float64)[0, 0])
    assert got == (1.0 - 0.5) * 4.0 + np.exp(-2.0) / 2.0
    assert texpr.channels(e) == {"u", "v"}
    m = texpr.maximum(texpr.minimum(u, v), texpr.abs_(-u))
    assert float(texpr.evaluate(m, env, torch.float64)[0, 0]) == 0.5


@pytest.mark.parametrize("case", ["fractional_power", "non_number",
                                  "unknown_op", "unknown_channel"])
def test_expr_rejects_non_whitelisted_shapes(case):
    u = mt.Chan("u")
    env = {"u": torch.ones((2, 2))}
    if case == "fractional_power":
        with pytest.raises(TypeError, match="integer exponent"):
            u ** 0.5
    elif case == "non_number":
        with pytest.raises(TypeError, match="cannot use"):
            texpr.as_expr("not a number")
    elif case == "unknown_op":
        with pytest.raises(ValueError, match="tanh"):
            texpr.evaluate(texpr.Unary("tanh", u), env, torch.float32)
    else:
        with pytest.raises(KeyError, match="'w'"):
            texpr.evaluate(mt.Chan("w"), env, torch.float32)


def _exprs(pkg_expr, Chan):
    u, v = Chan("u"), Chan("v")
    return [v, v ** 2 * u, 1.0 - u, -(v * 3.0), u + v, pkg_expr.exp(u),
            u - 2.5, pkg_expr.maximum(u, v) / 4.0, pkg_expr.abs_(u * v)]


@pytest.mark.parametrize("i", range(9))
def test_zero_point_and_fingerprint_match_jax(i):
    from mpi_model_tpu.ir import expr as jexpr

    je = _exprs(jexpr, mm.Chan)[i]
    te = _exprs(texpr, mt.Chan)[i]
    assert texpr.zero_point(te) == jexpr.zero_point(je)
    assert texpr.fingerprint(te) == jexpr.fingerprint(je)
    assert texpr.from_fingerprint(jexpr.fingerprint(je)) == te
    assert texpr.channels(te) == jexpr.channels(je)


def test_expr_evaluates_as_jax_does(jax_ir):
    """Every whitelisted op on the same f64 operands against JAX's
    ``evaluate``, within ``4·eps64·max|v|`` (``exp`` may differ by an ulp
    between the two libraries)."""
    from mpi_model_tpu.ir import expr as jexpr

    rng = np.random.default_rng(3)
    a = rng.uniform(-2.0, 2.0, (8, 8))
    b = rng.uniform(0.5, 2.0, (8, 8))
    for je, te in zip(_exprs(jexpr, mm.Chan), _exprs(texpr, mt.Chan)):
        got = texpr.evaluate(te, {"u": torch.from_numpy(a),
                                  "v": torch.from_numpy(b)}, torch.float64)
        want = np.asarray(jexpr.evaluate(
            je, {"u": jnp.asarray(a), "v": jnp.asarray(b)}, jnp.float64))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=4 * EPS64 * np.abs(want).max())


# -- terms and validation --------------------------------------------------------

@pytest.mark.parametrize("case", ["empty", "duplicate", "self_transfer",
                                  "budget_namespace", "not_a_term",
                                  "negative_weights"])
def test_term_validation_errors(case):
    if case == "empty":
        with pytest.raises(ValueError, match="at least one term"):
            mt.FlowIRModel([])
    elif case == "duplicate":
        with pytest.raises(ValueError, match="duplicate term name"):
            mt.FlowIRModel([mt.Transport("u", name="t"),
                            mt.Transport("v", name="t")])
    elif case == "self_transfer":
        with pytest.raises(ValueError, match="self-transfer"):
            mt.Transfer("u", "u", mt.Chan("u"))
    elif case == "budget_namespace":
        with pytest.raises(ValueError, match="_b_"):
            mt.Transport("u", name="_b_evil")
    elif case == "not_a_term":
        with pytest.raises(TypeError, match="not an IR Term"):
            mt.FlowIRModel([mt.Diffusion(0.1)])
    else:
        with pytest.raises(ValueError, match="non-negative"):
            mt.Transport("u", weights=(-1.0,) * 8)


def test_missing_channels_and_budgets_raise_clearly():
    m = mt.FlowIRModel([mt.Transport("u", rate=0.1),
                        mt.Source("u", 1.0 - mt.Chan("u"), rate=0.01,
                                  name="feed")])
    bare = mt.CellularSpace.create(8, 8, {"u": 1.0}, dtype="float64",
                                   device=CPU)
    with pytest.raises(ValueError, match="_b_feed"):
        m.make_step(bare)
    m.make_step(m.with_budget_channels(bare))
    sp = m.create_space(8, 8, {"u": 1.0}, dtype="float64", device=CPU)
    assert "_b_feed" in sp.values and sp.values["_b_feed"].dtype == \
        torch.float64


def test_written_channels_must_be_floating():
    m = mt.FlowIRModel([mt.Transport("mask", rate=0.1)])
    sp = mt.CellularSpace.create(8, 8, {"v": 1.0, "mask": (True, "bool")},
                                 dtype="float64", device=CPU)
    with pytest.raises(TypeError, match="floating"):
        m.make_step(sp)


def test_with_rates_preserves_active_opts():
    base, _ = mt.build_model("sir", 16, dtype="float64", device=CPU)
    m = mt.FlowIRModel(base.ir_terms, active_opts={"tile": (8, 8)})
    assert m.with_rates(m.term_rates()).active_opts == {"tile": (8, 8)}
    with pytest.raises(ValueError, match="rates for"):
        m.with_rates([0.1])


def test_unknown_registry_model_lists_options():
    with pytest.raises(ValueError, match="diffusion.*gray_scott"):
        mt.build_model("unknown_physics")


# -- the registry ----------------------------------------------------------------

def test_every_term_kind_has_exactly_one_lowering():
    assert set(tlower.LOWERINGS) == {mt.Transport, mt.Transfer, mt.Source,
                                     mt.Sink}
    for kind, low in tlower.LOWERINGS.items():
        assert low.__module__ == tlower.__name__
        assert tlower.lowering_for(kind.__new__(kind)) is low


def test_double_registration_refused():
    with pytest.raises(ValueError, match="exactly one"):
        tlower.register_lowering(mt.Transport)(object())
    assert tlower.LOWERINGS[mt.Transport].__module__ == tlower.__name__


def test_unregistered_term_kind_is_refused():
    class Rogue(mt.ir.Term):
        name = "rogue"
        rate = 1.0

    with pytest.raises(TypeError, match="no registered lowering"):
        tlower.lowering_for(Rogue())


# -- the library against JAX's -----------------------------------------------------

@pytest.mark.parametrize("name", LIB)
def test_structure_and_fingerprint_match_jax(name):
    jm, _ = mm.build_model(name, 16, dtype=jnp.float64)
    tm, _ = mt.build_model(name, 16, dtype="float64", device=CPU)
    assert tm.term_structure() == jm.term_structure()
    assert tm.term_rates() == jm.term_rates()
    assert tm._term_fingerprints() == jm._term_fingerprints()
    assert tm.ir_linear == jm.ir_linear
    # the round trip through plain tuples gives the same structure back
    back = interop.ir_model_from_structure(tm.term_structure(),
                                           tm.term_rates())
    assert back.term_structure() == tm.term_structure()


@pytest.mark.parametrize("name", LIB)
def test_activity_spec_and_channels_match_jax(name):
    jm, _ = mm.build_model(name, 16, dtype=jnp.float64)
    tm, _ = mt.build_model(name, 16, dtype="float64", device=CPU)
    js, ts = (jlower.activity_spec(jm.ir_terms),
              tlower.activity_spec(tm.ir_terms))
    assert (ts.probes, ts.always) == (js.probes, js.always)
    assert tlower.involved_channels(tm.ir_terms) == \
        jlower.involved_channels(jm.ir_terms)
    assert set(tlower.budget_channels(tm.ir_terms)) == \
        set(jlower.budget_channels(jm.ir_terms))
    assert tlower.max_footprint(tm.ir_terms) == \
        jlower.max_footprint(jm.ir_terms)
    assert tlower.uniform_rates(tm.ir_terms) == \
        jlower.uniform_rates(jm.ir_terms)


@pytest.mark.parametrize("name", LIB)
def test_library_spaces_match_jax(name):
    _, js = mm.build_model(name, H, W, dtype=jnp.float64)
    _, ts = mt.build_model(name, H, W, dtype="float64", device=CPU)
    assert list(ts.values) == list(js.values)
    for k, v in js.values.items():
        assert np.array_equal(ts.values[k].numpy(), np.asarray(v)), k


@pytest.mark.parametrize("name", NONLINEAR)
def test_conservation_view_matches_jax(name):
    jm, _ = mm.build_model(name, 16, dtype=jnp.float64)
    tm, _ = mt.build_model(name, 16, dtype="float64", device=CPU)
    rng = np.random.default_rng(5)
    chans = sorted(jlower.involved_channels(jm.ir_terms))
    totals = {k: float(rng.uniform(-3.0, 3.0)) for k in chans}
    jv, tv = jm.conservation_view(totals), tm.conservation_view(totals)
    assert set(tv) == set(jv)
    for k in jv:
        assert float(tv[k]) == float(jv[k]), k
    lanes = {k: rng.uniform(-3.0, 3.0, 4) for k in chans}
    jv, tv = jm.conservation_view(lanes), tm.conservation_view(lanes)
    for k in jv:
        assert np.array_equal(np.asarray(tv[k]), np.asarray(jv[k])), k


# -- the lowering against JAX's -----------------------------------------------------

_JAX_RUNS: dict = {}


def _jax_run(name):
    if name not in _JAX_RUNS:
        jm, js, tm, ts = _inputs(name)
        out, _ = jm.execute(js, mm.models.model.SerialExecutor("xla"),
                            steps=STEPS)
        _JAX_RUNS[name] = ({k: np.asarray(v) for k, v in js.values.items()},
                           {k: np.asarray(v) for k, v in out.values.items()},
                           tm, ts)
    return _JAX_RUNS[name]


@pytest.mark.parametrize("impl", ["xla", "composed", "active"])
@pytest.mark.parametrize("name", NONLINEAR)
def test_port_lowering_against_jax(name, impl, jax_ir):
    """JAX's ``SerialExecutor("xla")`` (its lowering, jitted) against the
    port's ``xla``, ``composed`` (k = 1) and ``active`` runs on the same
    inputs, per channel within ``2·eps64·steps·max|v|``."""
    init, want, tm, ts = _jax_run(name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ex = mt.SerialExecutor(impl, substeps=2 if impl == "composed"
                               else 1)
        out, rep = tm.execute(ts, ex, steps=STEPS)
    assert rep.impl == impl
    for k, w in want.items():
        got = out.values[k].numpy()
        scale = max(np.abs(w).max(), np.abs(init[k]).max(), 1e-300)
        err = float(np.abs(got - w).max())
        assert err <= 2 * EPS64 * STEPS * scale, (k, err)


@pytest.mark.parametrize("name", NONLINEAR)
def test_port_ensemble_lanes_against_jax(name, jax_ir):
    """JAX's ensemble ``xla`` engine (its lowering vmapped, per-lane rates
    as traced lanes) against the port's on the same lanes, within the same
    tolerance; the port's lanes are each its serial run bit for bit."""
    jm, js, tm, ts = _inputs(name, seed=11)
    scale = (1.0, 1.07)
    jmodels = [jm.with_rates([r * s for r in jm.term_rates()])
               for s in scale]
    tmodels = [tm.with_rates([r * s for r in tm.term_rates()])
               for s in scale]
    jres = jm.execute_many([js, js], models=jmodels, steps=6)
    tres = tm.execute_many([ts, ts], models=tmodels, steps=6)
    for m, (jsp, _), (tsp, trep) in zip(tmodels, jres, tres):
        serial, _ = m.execute(ts, steps=6)
        assert _same(tsp, serial)
        for k, v in jsp.values.items():
            w = np.asarray(v)
            err = float(np.abs(tsp.values[k].numpy() - w).max())
            assert err <= 2 * EPS64 * 6 * max(np.abs(w).max(), 1.0), (k, err)
        assert trep.last_execute == []


def test_weighted_transport_against_jax(jax_ir):
    """Anisotropic taps (N/S weight 1, the rest 0.25) on noise, against
    JAX's weighted lowering."""
    w = tuple(1.0 if (dx, dy) in ((-1, 0), (1, 0)) else 0.25
              for dx, dy in mm.Model.offsets)
    rng = np.random.default_rng(7)
    a = rng.uniform(0.0, 1.0, (H, W))
    jm = mm.FlowIRModel([mm.Transport("u", rate=0.2, weights=w)])
    tm = mt.FlowIRModel([mt.Transport("u", rate=0.2, weights=w)])
    js = mm.CellularSpace.create(H, W, {"u": 0.0}, dtype=jnp.float64)
    js = js.with_values({"u": jnp.asarray(a)})
    ts = interop.space_from_numpy({"u": a}, device=CPU)
    jout, _ = jm.execute(js, steps=STEPS)
    tout, trep = tm.execute(ts, steps=STEPS)
    want = np.asarray(jout.values["u"])
    err = float(np.abs(tout.values["u"].numpy() - want).max())
    assert err <= 2 * EPS64 * STEPS * np.abs(want).max()
    assert trep.conservation_error() < 1e-12


# -- the dense path is the lowering ---------------------------------------------

@pytest.mark.parametrize("dtype,impl,kw", [
    ("float64", "xla", {}), ("float64", "active", {}),
    ("float64", "auto", {}), ("float32", "pallas", {"substeps": 4}),
    ("float32", "composed", {"substeps": 4}),
    ("float32", "active_fused", {"substeps": 4}),
    ("float32", "active", {})])
def test_diffusion_ir_is_the_flow_model(dtype, impl, kw):
    m_ir, space = mt.build_model("diffusion", 64, dtype=dtype, device=CPU)
    m_flow = mt.Model(mt.Diffusion(0.1), 10.0, 1.0)
    a, ra = m_ir.execute(space, mt.SerialExecutor(impl, **kw), steps=8)
    b, rb = m_flow.execute(space, mt.SerialExecutor(impl, **kw), steps=8)
    assert _same(a, b)
    assert ra.impl == rb.impl
    assert ra.last_execute == rb.last_execute


def _dense_apply_spy(monkeypatch) -> list:
    calls = []
    real = tlower.dense_apply

    def spy(*a, **k):
        calls.append(a[0])
        return real(*a, **k)

    monkeypatch.setattr(tlower, "dense_apply", spy)
    return calls


@pytest.mark.parametrize("path", ["xla", "auto", "off_dtype_channel",
                                  "ensemble"])
def test_model_dense_branch_is_dense_apply(monkeypatch, path):
    """The plain path's dense transport of Diffusion flows is
    ``ir.lower.dense_apply`` on the impls that take it (``xla``, and
    ``auto`` off the kernel's dtypes; the kernel impls refuse what they
    cannot step), for a channel off the space dtype too, and in the
    ensemble's ``ScenarioStep``: bit for bit the hand-written
    ``transport`` of ``rate * v``, the rate rounded to the channel's
    dtype."""
    calls = _dense_apply_spy(monkeypatch)
    rate_a, rate_b = 0.1, 0.2
    rng = np.random.default_rng(3)
    a = rng.uniform(0.0, 1.0, (16, 12))
    b = rng.uniform(0.0, 1.0, (16, 12))
    sp = interop.space_from_numpy({"value": a, "b": b}, device=CPU)
    if path == "off_dtype_channel":
        sp = sp.with_values({**sp.values,
                             "b": sp.values["b"].to(torch.float32)})
    m = mt.Model([mt.Diffusion(rate_a), mt.Diffusion(rate_b, attr="b")])
    impl = "auto" if path == "auto" else "xla"
    if path == "ensemble":
        gots = [o.values for o, _ in m.execute_many([sp, sp], steps=2)]
        assert [t.channel for t in calls[0]] == ["value", "b"]
    else:
        out, _ = m.execute(sp, mt.SerialExecutor(impl), steps=2)
        assert len(calls) == 2
        assert [t.channel for t in calls[0]] == ["value", "b"]
        gots = [out.values]
    counts = mt.ops.stencil.neighbor_counts((16, 12), m.offsets,
                                            dtype=torch.float64)
    want = {}
    for attr, r in (("value", rate_a), ("b", rate_b)):
        v = sp.values[attr]
        for _ in range(2):
            v = mt.ops.stencil.transport(
                v, torch.tensor(r, dtype=v.dtype) * v, counts, m.offsets)
        want[attr] = v
    for g in gots:
        for k in want:
            assert g[k].dtype == want[k].dtype
            assert torch.equal(g[k], want[k]), k


def test_shared_channel_diffusions_keep_the_summed_outflow(monkeypatch):
    """Two Diffusions on one channel sum their outflows, which one
    Transport per term cannot reproduce bit for bit: that model keeps the
    summed-outflow path."""
    calls = _dense_apply_spy(monkeypatch)
    sp = mt.CellularSpace.create(16, 12, {"value": 1.0}, dtype="float64",
                                 device=CPU)
    mt.Model([mt.Diffusion(0.1), mt.Diffusion(0.05)]).execute(sp, steps=2)
    assert calls == []


# -- budget reconciliation --------------------------------------------------------

@pytest.mark.parametrize("name", ["gray_scott", "predator_prey"])
def test_budgets_reconcile_and_sign_contracts_hold(name):
    model, space = mt.build_model(name, 24, dtype="float64", device=CPU)
    out, rep = model.execute(space, steps=10)
    buds = model.budget_totals(out)
    for t in model.ir_terms:
        if t.conservation == "source":
            assert buds[t.name] >= -1e-9, t.name
        elif t.conservation == "sink":
            assert buds[t.name] <= 1e-9, t.name
    assert model.report_conservation_error(rep) <= \
        model.conservation_threshold(space)


def test_sir_is_fully_conserving():
    model, space = mt.build_model("sir", 24, dtype="float64", device=CPU)
    out, rep = model.execute(space, steps=10)
    assert model.budget_totals(out) == {}
    assert rep.conservation_error() > 1e-6  # the raw S drift is large
    assert model.report_conservation_error(rep) < 1e-9


@pytest.mark.parametrize("kind", ["sink", "source"])
def test_lying_term_raises_naming_the_term(kind):
    term = (mt.Sink("u", -mt.Chan("u"), rate=0.1, name="liar")
            if kind == "sink" else
            mt.Source("u", -mt.Chan("u"), rate=0.1, name="liar"))
    m = mt.FlowIRModel([mt.Transport("u", rate=0.1), term])
    space = m.create_space(16, 16, {"u": 1.0}, dtype="float64", device=CPU)
    with pytest.raises(mt.ConservationError, match="liar"):
        m.execute(space, steps=4)


def test_unreconciled_residual_names_conserving_terms():
    m = mt.FlowIRModel([mt.Transport("u", rate=0.1, name="mix")])
    space = m.create_space(8, 8, {"u": 1.0}, dtype="float64", device=CPU)
    with pytest.raises(mt.ConservationError, match="mix"):
        m._raise_if_violated(space, {"u": 64.0}, {"u": 32.0}, 1e-3, None)


def test_ensemble_violation_names_the_term_per_lane():
    m = mt.FlowIRModel([mt.Transport("u", rate=0.1),
                        mt.Sink("u", -mt.Chan("u"), rate=0.1, name="liar")])
    space = m.create_space(16, 16, {"u": 1.0}, dtype="float64", device=CPU)
    with pytest.raises(mt.EnsembleConservationError, match="liar") as ei:
        mt.run_ensemble(m, [space, space], steps=4)
    assert ei.value.scenario == 0
    res = mt.run_ensemble(m, [space, space], steps=4, on_violation="mark")
    assert all(isinstance(r, mt.EnsembleConservationError) for r in res)
    assert "liar" in str(res[1])


def test_time_varying_masked_source_integrates_exactly():
    """``amount = rate · t · mask`` from a ``Clock`` term's channel: the
    integrated budget is the analytic sum, on every serial impl alike."""
    mask = np.zeros((8, 8))
    mask[2:4, 2:4] = 1.0
    m = mt.FlowIRModel([
        mt.Clock("t"),
        mt.Source("u", mt.Chan("t") * mt.Chan("mask"), rate=0.5,
                  name="pulse"),
    ], 1.0, 1.0)
    space = m.create_space(8, 8, {"u": 0.0, "t": 0.0, "mask": 0.0},
                           dtype="float64", device=CPU)
    space = space.with_values({**space.values,
                               "mask": torch.from_numpy(mask)})
    n = 6
    out, _ = m.execute(space, steps=n)
    assert m.budget_totals(out)["pulse"] == 0.5 * sum(range(n)) * mask.sum()
    assert float(out.total("t")) == n * 64
    for impl in ("composed", "active"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            got, _ = m.execute(space, mt.SerialExecutor(impl), steps=n)
        assert _same(got, out), impl


def test_check_health_view_survives_pre_ir_baseline():
    from mpi_model_tpu_torch.resilience.supervisor import check_health

    model, space = mt.build_model("gray_scott", 16, dtype="float64",
                                  device=CPU)
    stale = {"u": float(space.total("u")), "v": float(space.total("v"))}
    assert check_health(space, stale, threshold=1e-6,
                        view=model.conservation_view) == []


# -- refusals ------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["pallas", "active_fused", "pipeline"])
def test_nonlinear_linear_stencil_impls_raise(impl):
    model, space = mt.build_model("gray_scott", 16, dtype="float32",
                                  device=CPU)
    with pytest.raises(ValueError, match="linear-stencil"):
        model.make_step(space, impl=impl)


def test_nonlinear_composed_forces_k1_with_warning():
    model, space = mt.build_model("sir", 16, dtype="float64", device=CPU)
    with pytest.warns(RuntimeWarning, match="k=1"):
        step = model.make_step(space, impl="composed", substeps=4)
    assert step.composed_k == 1 and step.composed_passes == 4
    want, _ = model.execute(space, steps=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out, rep = model.execute(
            space, mt.SerialExecutor("composed", substeps=4), steps=4)
    assert _same(out, want)
    assert rep.backend_report["composed_k"] == 1
    assert rep.backend_report["kernel"] is None
