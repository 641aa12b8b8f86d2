"""K4's slice on the CPU: the flow lowering (``ops/field_lower.py``), the
field step's plain version and wrapper (``ops/field_stencil.py``), K4's
selection in ``Model.make_step`` and ``SerialExecutor``, and the CLI's
coupled chain, against the JAX package.

- ``lower_flows`` + ``eval_program`` equal ``build_outflow`` bit for bit at
  f32 and f64, one whitelisted operation at a time; refused operations
  raise ``ValueError`` naming the flow and the operation.
- ``field_step_plain`` (what a CPU tensor runs in place of K4) against
  JAX's ``PallasFieldStep(..., interpret=True)`` for the field-kernel cases
  of ``tests/test_pallas.py`` (the unsharded ones), within
  ``4·eps·nsteps·max|v|`` at f32: the two compute the same sums, but XLA on
  the CPU may contract a multiply and an add into an FMA. bf16: one bf16
  ulp at values below 4 (both round once per call).
- ``field_step_plain`` equals the port's own ``impl="xla"`` step chained
  ``nsteps`` times, bit for bit at f32: they are the same function.
"""

import argparse
import ctypes
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mpi_model_tpu as mm
from mpi_model_tpu.cli import _build_model as jax_build_model
from mpi_model_tpu.models.model import SerialExecutor as JSerial
from mpi_model_tpu.ops.flow import Flow as JFlow
from mpi_model_tpu.ops.pallas_stencil import PallasFieldStep as JFieldStep

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch.cli import build_flows
from mpi_model_tpu_torch.cli import main as cli_main
from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS, VON_NEUMANN_OFFSETS
from mpi_model_tpu_torch.ops import field_lower as fl
from mpi_model_tpu_torch.ops import field_stencil as k4
from mpi_model_tpu_torch.ops.flow import Flow, build_outflow, cell_coords

EPS32 = 2.0 ** -23


# -- flows -------------------------------------------------------------------

@dataclasses.dataclass
class Fn(Flow):
    """A pointwise flow on channel ``a`` whose outflow is ``fn(a, b,
    origin)``; ``b`` is the modulator channel."""

    fn: object = None
    attr: str = "a"
    footprint = "pointwise"

    def outflow(self, values, origin=(0, 0)):
        return self.fn(values["a"], values["b"], origin)


@dataclasses.dataclass
class Affine(Flow):
    flow_rate: float = 0.05
    capacity: float = 3.0
    attr: str = "a"
    footprint = "pointwise"

    def outflow(self, values, origin=(0, 0)):
        return self.flow_rate * (self.capacity - values[self.attr])


class RowRate(Flow):
    footprint = "pointwise"
    attr = "a"

    def outflow(self, values, origin=(0, 0)):
        v = values[self.attr]
        rows, _ = cell_coords(v, origin)
        return 0.002 * rows.to(v.dtype) * v


@dataclasses.dataclass
class JAffine(JFlow):
    flow_rate: float = 0.05
    capacity: float = 3.0
    attr: str = "a"
    footprint = "pointwise"

    def outflow(self, values, origin=(0, 0)):
        return self.flow_rate * (self.capacity - values[self.attr])

    def fingerprint(self):
        return ("Affine", self.flow_rate, self.capacity, self.attr)


class JRowRate(JFlow):
    footprint = "pointwise"
    attr = "a"

    def outflow(self, values, origin=(0, 0)):
        v = values[self.attr]
        rows = origin[0] + jax.lax.broadcasted_iota(jnp.int32, v.shape, 0)
        return 0.002 * rows.astype(v.dtype) * v

    def fingerprint(self):
        return ("RowRate", 0.002)


def _ring(base):
    class Ring(base):
        footprint = "ring1"
        attr = "a"

        def outflow_padded(self, padded, origin=(0, 0)):
            return padded["a"][1:-1, 1:-1] * 0.1

    return Ring


Ring, JRing = _ring(Flow), _ring(JFlow)  # one name, so errors compare


def config4(pkg=mt):
    return [pkg.Diffusion(0.1, attr="a"),
            pkg.Coupled(flow_rate=0.05, attr="a", modulator="b"),
            pkg.Diffusion(0.2, attr="b")]


def chain3():
    return [mt.Diffusion(0.1, "a"), mt.Diffusion(0.1, "b"),
            mt.Diffusion(0.1, "c"), mt.Coupled(0.05, "a", "b"),
            mt.Coupled(0.05, "b", "c")]


def grids(shape, names=("a", "b"), seed=5):
    rng = np.random.default_rng(seed)
    return {n: rng.uniform(0.5, 2.0, shape) for n in names}


def tvals(np_vals, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) for k, v in np_vals.items()}


def jvals(np_vals, dtype=jnp.float32):
    return {k: jnp.asarray(v, dtype) for k, v in np_vals.items()}


def tspace(np_vals, dtype="float32"):
    names = tuple(np_vals)
    h, w = np_vals[names[0]].shape
    s = mt.CellularSpace.create(h, w, {n: 1.0 for n in names}, dtype=dtype,
                                device="cpu")
    return s.with_values(tvals(np_vals, s.dtype))


def jspace(np_vals, dtype=jnp.float32):
    names = tuple(np_vals)
    h, w = np_vals[names[0]].shape
    s = mm.CellularSpace.create(h, w, {n: 1.0 for n in names}, dtype=dtype)
    return s.with_values(jvals(np_vals, dtype))


def assert_close_scaled(got, want, ns, dtype=torch.float32):
    """|got - want| <= 4·eps·nsteps·max|want| (f32), or one bf16 ulp below
    4 (bf16, both rounded once per call)."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    tol = (2.0 ** -6 if dtype == torch.bfloat16
           else 4 * EPS32 * ns * float(np.abs(w).max()))
    assert float(np.abs(g - w).max()) <= tol


# -- the lowering ---------------------------------------------------------------

OPS = {
    "add": lambda a, b, o: a + b,
    "radd": lambda a, b, o: 0.25 + a,
    "sub": lambda a, b, o: a - 0.5 * b,
    "rsub": lambda a, b, o: 3.0 - a,
    "mul": lambda a, b, o: a * b,
    "div": lambda a, b, o: a / (b + 1.5),
    "rdiv": lambda a, b, o: 0.3 / b,
    "min": lambda a, b, o: torch.minimum(a, b) * 0.1,
    "max": lambda a, b, o: torch.maximum(a, 2.0 - b) * 0.1,
    "min_fn": lambda a, b, o: torch.min(a, b) * 0.1,
    "neg": lambda a, b, o: -a * -0.1,
    "exp": lambda a, b, o: torch.exp(-a) * 0.2,
    "exp_method": lambda a, b, o: (0.5 - b).exp() * a * 0.1,
    "abs": lambda a, b, o: (a - b).abs() * 0.1 + abs(1.0 - a) * 0.01,
    "pow2": lambda a, b, o: a ** 2 * 0.05,
    "pow3": lambda a, b, o: torch.pow(a, 3) * 0.01,
    "clamp": lambda a, b, o: torch.clamp(a - b, min=0.0, max=0.5),
    "clamp_min": lambda a, b, o: (a * 0.2).clamp_min(0.25),
    "rate_tensor": lambda a, b, o: torch.tensor(
        0.07, dtype=a.dtype, device=a.device) * a * b,
    "numpy_scalar": lambda a, b, o: np.float32(0.1) * a,
    "rows": lambda a, b, o: 0.002 * cell_coords(a, o)[0].to(a.dtype) * a,
    "cols_shifted": lambda a, b, o: (cell_coords(a, o)[1] + 1).to(
        a.dtype) * 1e-4 * b,
    "torch_fns": lambda a, b, o: torch.sub(torch.mul(a, 0.1), torch.div(
        b, 30.0)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("op", sorted(OPS))
def test_lowering_equals_build_outflow_bitwise(op, dtype):
    flows = [Fn(OPS[op]), mt.Coupled(0.05, "b", "a")]
    prog = fl.lower_flows(flows, ("a", "b"), dtype=dtype)
    vals = tvals(grids((24, 40), seed=3), dtype)
    origin = (2, 5)
    rows, cols = cell_coords(vals["a"], origin)
    got = fl.eval_program(prog, vals, rows, cols)
    want = build_outflow(flows, vals, origin)
    assert set(got) == set(want) == {"a", "b"}
    for k in want:
        assert got[k].dtype == dtype
        assert torch.equal(got[k], want[k]), k


def test_program_shape_and_limits():
    prog = fl.lower_flows(config4(), ("a", "b", "unused"))
    assert prog.channels == ("a", "b") and prog.outputs == ("a", "b")
    # 4 multiplies and 3 accs in one slot; the Coupled flow adds to "a"
    assert prog.n_slots == 1 and len(prog.code) == 7
    assert [c[0] for c in prog.code] == [
        fl.OP_MUL, fl.OP_ACC, fl.OP_MUL, fl.OP_MUL, fl.OP_ACC, fl.OP_MUL,
        fl.OP_ACC]
    assert [c[1:3] for c in prog.code if c[0] == fl.OP_ACC] == [
        (0, 1), (0, 0), (1, 1)]
    assert prog.flops() == 5
    # the traced rates are the f32 values (K4 computes in f32)
    consts = [c[3][2] for c in prog.code if c[3][0] == fl.K_CONST]
    assert consts == [float(np.float32(r)) for r in (0.1, 0.05, 0.2)]
    assert prog.describe()[1] == (
        "#1 Coupled(attr='a') -> a: s0 = mul(0.05000000074505806, a); "
        "s0 = mul(s0, b); += s0")
    fl.check_program(prog)
    many = fl.lower_flows([mt.Diffusion(0.01, "a")] * 9, ("a",))
    with pytest.raises(ValueError, match="at most 8 flows"):
        fl.check_program(many)
    def nested(a, b, o):
        x = a + 1.0
        for i in range(9):  # each level holds a result while x is computed
            x = (a * (b + i)) * x
        return x * 0.01

    deep = fl.lower_flows([Fn(nested)], ("a", "b"))
    assert deep.n_slots == 10
    with pytest.raises(ValueError, match="at most 8 intermediate slots"):
        fl.check_program(deep)


def test_symbolic_dtype_is_f32_for_bf16_storage():
    seen = []

    def spy(a, b, o):
        seen.append(a.dtype)
        return torch.tensor(0.1, dtype=a.dtype, device=a.device) * a

    space = tspace(grids((32, 256)), "bfloat16")
    model = mt.Model([Fn(spy), mt.Coupled(0.05, "a", "b")])
    step = model.make_step(space, impl="pallas")
    assert step.impl == "pallas" and seen == [torch.float32]
    consts = [c[3][2] for c in step.field_stepper.program.code
              if c[3][0] == fl.K_CONST]
    assert consts[0] == float(np.float32(0.1)) != 0.1
    assert consts[0] != float(torch.tensor(0.1, dtype=torch.bfloat16))


REFUSED = {
    "sum": (lambda a, b, o: a * a.sum(), "'sum'"),
    "mean": (lambda a, b, o: a - torch.mean(a), "'mean'"),
    "index": (lambda a, b, o: a[0] * 0.1, "indexing"),
    "shape": (lambda a, b, o: a * a.shape[0], "shape"),
    "compare": (lambda a, b, o: (a > 1.0) * 0.1, "'gt'"),
    "where": (lambda a, b, o: torch.where(b > 1.0, a, b), "'gt'"),
    "sin": (lambda a, b, o: torch.sin(a), "'sin'"),
    "float": (lambda a, b, o: a * float(b), "host read"),
    "item": (lambda a, b, o: a * b.item(), "'item'"),
    "branch": (lambda a, b, o: a if a else b, "host read"),
    "captured": (lambda a, b, o: a * torch.ones(4, 4), "non-scalar"),
    "pow4": (lambda a, b, o: a ** 4, "exponent 4"),
    "pow_half": (lambda a, b, o: a ** 0.5, "exponent 0.5"),
    "int_coords": (lambda a, b, o: cell_coords(a, o)[0] * 2 * a,
                   "integer cell coordinate"),
    "inplace": (lambda a, b, o: torch.add(a, b).add_(1.0), "add_"),
    "cast": (lambda a, b, o: a.to(torch.float64) * 0.1, "cast"),
    "zeros_like": (lambda a, b, o: torch.zeros_like(a), "'zeros_like'"),
    "raises": (lambda a, b, o: a * {}["missing"], "KeyError"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_operations_name_the_flow_and_op(case):
    fn, what = REFUSED[case]
    with pytest.raises(ValueError, match="flow #1 Fn") as exc:
        fl.lower_flows([mt.Diffusion(0.1, "a"), Fn(fn)], ("a", "b"))
    assert what in str(exc.value)


def test_cell_coords_on_tensors():
    v = torch.zeros((3, 4))
    rows, cols = cell_coords(v, (10, 20))
    assert rows.shape == cols.shape == (3, 4)
    assert rows.dtype == torch.int64
    assert rows[:, 0].tolist() == [10, 11, 12]
    assert cols[0].tolist() == [20, 21, 22, 23]


# -- the plain version against the JAX kernel ---------------------------------

@pytest.mark.parametrize("ns", [1, 4])
def test_config4_matches_jax_field_kernel(ns):
    g = grids((40, 256))
    got = k4.field_step_plain(tvals(g), config4(), nsteps=ns)
    want = JFieldStep((40, 256), config4(mm), interpret=True,
                      nsteps=ns)(jvals(g))
    for k in ("a", "b"):
        assert_close_scaled(got[k].numpy(), want[k], ns)


def test_interior_tiles_match_jax():
    """>= 3 tiles per dim on the JAX side, so its interior fast path runs."""
    g = grids((40, 640))
    got = k4.PallasFieldStep((40, 640), config4(), block=(8, 128),
                             nsteps=4)(tvals(g))
    want = JFieldStep((40, 640), config4(mm), block=(8, 128),
                      interpret=True, nsteps=4)(jvals(g))
    for k in ("a", "b"):
        assert_close_scaled(got[k].numpy(), want[k], 4)


def test_bf16_matches_jax_within_one_ulp():
    g = grids((32, 256))
    got = k4.PallasFieldStep((32, 256), config4(), nsteps=4)(
        tvals(g, torch.bfloat16))
    want = JFieldStep((32, 256), config4(mm), interpret=True,
                      nsteps=4)(jvals(g, jnp.bfloat16))
    for k in ("a", "b"):
        assert got[k].dtype == torch.bfloat16
        assert_close_scaled(got[k].float().numpy(),
                            np.asarray(want[k]).astype(np.float32), 4,
                            torch.bfloat16)


def test_modulator_untouched_like_jax():
    g = grids((40, 256))
    vals = tvals(g)
    got = k4.PallasFieldStep((40, 256), [mt.Coupled(0.05, "a", "b")],
                             nsteps=2)(vals)
    want = JFieldStep((40, 256), [mm.Coupled(flow_rate=0.05, attr="a",
                                             modulator="b")],
                      interpret=True, nsteps=2)(jvals(g))
    assert got["b"] is vals["b"]
    np.testing.assert_array_equal(np.asarray(want["b"]), got["b"].numpy())
    assert_close_scaled(got["a"].numpy(), want["a"], 2)


def test_point_flow_composition_like_jax():
    g = grids((40, 256))
    tm = mt.Model(config4() + [mt.PointFlow(source=(5, 5), flow_rate=0.3,
                                            attr="a")], 1.0, 1.0)
    jm = mm.Model(config4(mm) + [mm.PointFlow(source=(5, 5), flow_rate=0.3,
                                              attr="a")], 1.0, 1.0)
    ts = tstep = tm.make_step(tspace(g), impl="auto")
    assert ts.impl == "pallas" and ts.field_stepper is not None
    js = jm.make_step(jspace(g), impl="auto")
    assert js.impl == "pallas"
    got, want = tstep(tvals(g)), js(jvals(g))
    for k in ("a", "b"):
        assert_close_scaled(got[k].numpy(), want[k], 1)
    # and bit for bit the port's plain-op step (the same function at f32)
    ref = tm.make_step(tspace(g), impl="xla")(tvals(g))
    assert torch.equal(got["a"], ref["a"]) and torch.equal(got["b"],
                                                           ref["b"])
    with pytest.raises(ValueError, match="point flows"):
        tm.make_step(tspace(g), impl="pallas", substeps=2)
    assert tm.make_step(tspace(g), impl="auto", substeps=2).impl == "xla"


@pytest.mark.parametrize("ns", [1, 4])
def test_affine_flow_matches_jax(ns):
    g = grids((24, 256), names=("a",), seed=8)
    got = k4.PallasFieldStep((24, 256), [Affine()], block=(8, 128),
                             nsteps=ns)(tvals(g))
    want = JFieldStep((24, 256), [JAffine()], block=(8, 128),
                      interpret=True, nsteps=ns)(jvals(g))
    assert_close_scaled(got["a"].numpy(), want["a"], ns)


@pytest.mark.parametrize("ns", [1, 4])
def test_row_reading_flow_matches_jax(ns):
    g = grids((40, 256), names=("a",), seed=9)
    got = k4.PallasFieldStep((40, 256), [RowRate()], block=(8, 128),
                             nsteps=ns)(tvals(g))
    want = JFieldStep((40, 256), [JRowRate()], block=(8, 128),
                      interpret=True, nsteps=ns)(jvals(g))
    assert_close_scaled(got["a"].numpy(), want["a"], ns)


FLOW_SETS = {"config4": config4, "affine": lambda: [Affine()],
             "row_rate": lambda: [RowRate()], "chain3": chain3,
             "every_op": lambda: [Fn(OPS["exp"]), Fn(OPS["div"]),
                                  Fn(OPS["clamp"]), mt.Diffusion(0.1, "b")]}


@pytest.mark.parametrize("ns", [1, 3, 8])
@pytest.mark.parametrize("flows", sorted(FLOW_SETS))
def test_plain_equals_the_xla_step_chained_bitwise(flows, ns):
    space = tspace(grids((13, 37), names=("a", "b", "c"), seed=ns))
    model = mt.Model(FLOW_SETS[flows]())
    got = k4.field_step_plain(dict(space.values), model.flows, nsteps=ns)
    sx = model.make_step(space, impl="xla")
    want = dict(space.values)
    for _ in range(ns):
        want = sx(want)
    for k in ("a", "b", "c"):
        assert torch.equal(got[k], want[k]), k
    # and the kernel path's CPU stand-in is that same function
    sp = model.make_step(space, impl="pallas", substeps=ns)
    assert sp.impl == "pallas" and sp.field_stepper is not None
    out = sp(dict(space.values))
    for k in ("a", "b", "c"):
        assert torch.equal(out[k], want[k]), k


@pytest.mark.parametrize("offs", [MOORE_OFFSETS, VON_NEUMANN_OFFSETS,
                                  ((-1, 0), (1, 1), (0, -1))])
def test_neighborhoods_match_jax(offs):
    g = grids((24, 256))
    got = k4.PallasFieldStep((24, 256), config4(), offsets=offs,
                             block=(8, 128), nsteps=4)(tvals(g))
    want = JFieldStep((24, 256), config4(mm), offsets=offs, block=(8, 128),
                      interpret=True, nsteps=4)(jvals(g))
    for k in ("a", "b"):
        assert_close_scaled(got[k].numpy(), want[k], 4)


# -- selection and errors -------------------------------------------------------

@pytest.mark.parametrize("impl", ["pallas", "auto"])
def test_make_step_selects_k4_like_jax(impl):
    g = grids((40, 256))
    ts = mt.Model(config4()).make_step(tspace(g), impl=impl, substeps=4)
    js = mm.Model(config4(mm)).make_step(jspace(g), impl=impl, substeps=4)
    assert ts.impl == js.impl == "pallas"
    assert ts.field_stepper.program.outputs == ("a", "b")
    assert set(ts.steppers) == {"a", "b"}


def test_refusals_match_jax():
    g = grids((32, 256))
    ring_t = mt.Model([Ring(), mt.Coupled(0.05, "a", "b")])
    ring_j = mm.Model([JRing(), mm.Coupled(flow_rate=0.05, attr="a",
                                           modulator="b")])
    cases = [
        # a non-pointwise flow
        (ring_t, ring_j, tspace(g), jspace(g), 1, "POINTWISE"),
        # f64 stays on the plain path
        (mt.Model(config4()), mm.Model(config4(mm)),
         tspace(g, "float64"), jspace(g, jnp.float64), 1, "f32/bf16"),
    ]
    for tm, jm, ts, js, sub, match in cases:
        with pytest.raises(ValueError, match=match):
            tm.make_step(ts, impl="pallas", substeps=sub)
        with pytest.raises(ValueError, match=match):
            jm.make_step(js, impl="pallas", substeps=sub)
        assert tm.make_step(ts, impl="auto").impl == "xla"
        assert jm.make_step(js, impl="auto").impl == "xla"
    # a partition stays on the plain path
    part = mt.CellularSpace.create(16, 256, {"a": 1.0, "b": 1.0},
                                   global_dim_x=32, device="cpu")
    jpart = mm.CellularSpace.create(16, 256, {"a": 1.0, "b": 1.0},
                                    global_dim_x=32)
    with pytest.raises(ValueError, match="non-partition"):
        mt.Model(config4()).make_step(part, impl="pallas")
    with pytest.raises(ValueError, match="non-partition"):
        mm.Model(config4(mm)).make_step(jpart, impl="pallas")
    assert mt.Model(config4()).make_step(part, impl="auto").impl == "xla"
    # JAX's pointwise check at the stepper, word for word
    with pytest.raises(ValueError) as t_exc:
        k4.PallasFieldStep((8, 8), [Ring()])
    with pytest.raises(ValueError) as j_exc:
        JFieldStep((8, 8), [JRing()])
    assert str(t_exc.value) == str(j_exc.value)


def test_static_refusals_pick_xla_under_auto():
    """Each static reason K4 cannot take a call: "pallas" raises it,
    "auto" takes the plain path and says so in ``.impl``."""
    g3 = tspace(grids((32, 256), names=("a", "b", "c")))
    bad = mt.Model([Fn(lambda a, b, o: a * a.sum()),
                    mt.Coupled(0.05, "a", "b")])
    six = mt.Model([mt.Coupled(0.05, f"c{i}", f"c{(i + 1) % 6}")
                    for i in range(6)])
    wide = mt.CellularSpace.create(32, 256, {f"c{i}": 1.0 for i in range(6)},
                                   dtype="bfloat16", device="cpu")
    nine = mt.Model([mt.Coupled(0.01, "a", "b")] * 9)
    mixed = g3.with_values({**g3.values, "b": g3.values["b"].double()})
    cases = [
        (bad, g3, 1, "'sum'"),                   # cannot be lowered
        (nine, g3, 1, "at most 8 flows"),        # program limits
        (mt.Model(config4()), g3, 9, "ghost depth"),
        (mt.Model(config4()), mixed, 1, "space dtype"),
    ]
    for model, space, sub, match in cases:
        with pytest.raises(ValueError, match=match):
            model.make_step(space, impl="pallas", substeps=sub)
        assert model.make_step(space, impl="auto", substeps=sub).impl == \
            "xla"
    # six written channels at bf16 and 16 steps: past the interpreter's
    # shared memory, within the register walk's (40 window rows)
    for impl in ("pallas", "auto"):
        step = six.make_step(wide, impl=impl, substeps=16)
        assert step.impl == "pallas" and step.field_stepper.rows == 40
    # the plain path still runs the flow the kernel could not take
    out, rep = bad.execute(g3, mt.SerialExecutor("auto"), steps=2,
                           check_conservation=False)
    assert rep.impl == "xla" and torch.isfinite(out.values["a"]).all()
    # bf16 interior math is accepted
    step = mt.Model(config4()).make_step(g3, impl="pallas",
                                         compute_dtype=torch.bfloat16)
    assert step.impl == "pallas"


def _interpreter_tile_h(n_chan, n_out, n_slots, nsteps):
    """The shared-memory rule of the interpreter K4 replaced: a block held
    (n_chan + n_out + max(n_slots, 1)) f32 planes of (TILE_H + 2n) x
    (128 + 2n), TILE_H the tallest of 32, 16, 8 within 232,448 bytes."""
    for th in (32, 16, 8):
        if ((n_chan + n_out + max(n_slots, 1)) * (th + 2 * nsteps)
                * (128 + 2 * nsteps) * 4) <= 232_448:
            return th
    return None


def test_shared_memory_rule():
    # the block sizes the design names: config 4 (2 written channels, no
    # modulator) at f32 and bf16, and the walk's exchange region
    assert k4.stage_bytes(48, 4) == 48 * 260 * 4 == 49_920
    assert k4.stage_bytes(48, 2) == 48 * 264 * 2 == 25_344
    assert k4.smem_bytes(2, 0, 48, 4) == 2 * 49_920
    assert k4.smem_bytes(2, 0, 48, 2) == 2 * 25_344
    assert k4.smem_bytes(1, 1, 64, 4) == 2 * 64 * 260 * 4
    # the walk's exchange and outer columns fit in the written windows
    assert k4.smem_bytes(1, 0, 24, 2) == k4.stage_bytes(24, 2) > (
        2 * 20 * 24 + 8 * 2 * 25) * 4
    # the rows measured per written channels and depth, at least min_rows
    assert [k4.min_rows(n) for n in (1, 4, 8, 16)] == [16, 16, 24, 40]
    assert k4.window_rows(2, 0, 8, 4) == 48
    assert k4.window_rows(2, 0, 16, 2) == 48
    assert k4.window_rows(2, 0, 1, 4) == 32
    assert k4.window_rows(1, 1, 8, 4) == 48
    assert k4.window_rows(1, 1, 2, 4) == 32
    assert k4.window_rows(1, 1, 16, 2) == 64
    assert k4.window_rows(3, 0, 16, 2) == 40
    assert k4.window_rows(8, 0, 16, 2) == 40
    # seven modulators at f32: the rows come down until the block fits
    assert k4.window_rows(1, 7, 8, 4) == 24
    assert k4.smem_bytes(1, 7, 24, 4) <= k4.SMEM_LIMIT < k4.smem_bytes(
        1, 7, 32, 4)
    # every program within the limits fits at every admitted depth, so
    # nothing the interpreter's rule accepted is refused
    accepted = 0
    for n_chan in range(1, 9):
        for n_out in range(1, n_chan + 1):
            for key, deepest in k4.MAX_NSTEPS.items():
                itemsize = 4 if key == "f32" else 2
                for ns in range(1, deepest + 1):
                    rows = k4.window_rows(n_out, n_chan - n_out, ns,
                                          itemsize)
                    assert rows is not None and rows >= k4.min_rows(ns)
                    assert k4.smem_bytes(n_out, n_chan - n_out, rows,
                                         itemsize) <= k4.SMEM_LIMIT
                    assert rows in k4.unit_rows(n_out,
                                                n_chan - n_out)[key]
                    accepted += any(
                        _interpreter_tile_h(n_chan, n_out, slots, ns)
                        for slots in range(0, 9))
    assert accepted > 0
    step = k4.PallasFieldStep((32, 256), chain3(), dtype=torch.bfloat16,
                              nsteps=16, names=("a", "b", "c"))
    assert step.rows == 40 and step.planned.unit.rows_of("bf16") == (32, 40)
    assert step.planned.unit.rows_of("f32") == (32,)


def test_paired_walk_rows_rule():
    """The bf16 interior math's paired walk (its own launch) takes its own
    window rows: 32 at one or two steps, else the most rows up to
    ``MAX_ROWS16`` at which two blocks fit an SM in registers (pair words)
    and shared memory; every program within the limits gets rows at every
    admitted depth, within the block's shared memory."""
    # config 4 as measured: f32 storage is held to 48 by two blocks'
    # staged windows, bf16 storage takes 96
    assert k4.window_rows16(2, 0, 1, 4) == 32
    assert k4.window_rows16(2, 0, 8, 4) == 48
    assert k4.window_rows16(2, 0, 1, 2) == 32
    assert k4.window_rows16(2, 0, 16, 2) == 96
    assert k4.window_rows16(3, 0, 16, 2) == 64  # 96 pair words
    assert k4.smem_bytes16(2, 0, 96, 2) == 2 * k4.stage_bytes(96, 2) \
        <= k4.TWO_BLOCK_SMEM
    # the walk's pair words fit in the staged windows they reuse
    assert k4.smem_bytes16(1, 0, 24, 2) == k4.stage_bytes(24, 2) > (
        2 * 20 * 12 + 8 * 2 * 13) * 4
    for n_chan in range(1, 9):
        for n_out in range(1, n_chan + 1):
            n_mod = n_chan - n_out
            for key, deepest in k4.MAX_NSTEPS.items():
                itemsize = 4 if key == "f32" else 2
                for ns in range(1, deepest + 1):
                    rows = k4.window_rows16(n_out, n_mod, ns, itemsize)
                    assert rows is not None and rows >= k4.min_rows(ns)
                    assert rows % 8 == 0 and rows - 2 * ns >= 1
                    assert k4.smem_bytes16(n_out, n_mod, rows,
                                           itemsize) <= k4.SMEM_LIMIT
                    assert rows in k4.unit_rows16(n_out, n_mod)[key]
                    if ns > 2 and rows > k4.min_rows(ns):
                        assert n_out * rows // 2 <= k4.TWO_BLOCK_WORDS
                        assert k4.smem_bytes16(
                            n_out, n_mod, rows, itemsize) <= \
                            k4.TWO_BLOCK_SMEM
    plan = k4.plan_field(config4(), ("a", "b"), (64, 256), torch.bfloat16,
                         16, compute_dtype=torch.bfloat16)
    assert (plan.rows, plan.rows16) == (48, 96)
    assert "mm_field::Rows<32, 48>{}, mm_field::Rows<32, 96>{}" in \
        plan.unit.text
    # one threshold: the bf16 program's struct carries the rule's for the
    # header's launch bounds (min_blocks16)
    assert plan.unit.text.count(
        f"static constexpr int kTwoBlockWords = {k4.TWO_BLOCK_WORDS};") == 1
    assert "P::kTwoBlockWords" in (
        Path(k4.__file__).parent.parent / "csrc" / "field_stencil.cuh"
    ).read_text()


def test_pack_program_layout():
    """The launch argument: the written channels first, then the
    modulators; K4's ring depth 0 with the grid as the shard; K4-halo's
    rings in ``RING_PIECES`` order at the shard's origin."""
    flows = [mt.Coupled(0.05, "b", "a"), mt.Diffusion(0.1, "b")]
    plan = k4.plan_field(flows, ("a", "b", "c"), (40, 256), torch.float32,
                         8)
    assert plan.program.outputs == ("b",)
    assert k4.kernel_channels(plan.program) == ("b", "a")
    assert plan.rows == 48 and plan.unit.rows_of("f32") == (32, 48)
    vals = tvals(grids((40, 256), names=("a", "b")))
    out = torch.empty(40, 256)
    call = k4.pack_call(plan, 8, [vals["b"], vals["a"]], [out])
    assert (call.h, call.w, call.d, call.R0, call.C0, call.H, call.W) == (
        40, 256, 0, 0, 0, 40, 256)
    assert (call.nsteps, call.rows, call.vec) == (8, 48, 1)
    assert (call.inp[0], call.inp[1], call.inp[2]) == (
        vals["b"].data_ptr(), vals["a"].data_ptr(), None)
    assert call.out[0] == out.data_ptr() and call.out[1] is None
    assert all(call.ring[c][p] is None for c in range(8) for p in range(8))
    # a row pitch that is not a multiple of 16 bytes: no cp.async windows
    odd = tvals(grids((40, 255), names=("a", "b")))
    assert k4.pack_call(plan, 8, [odd["b"], odd["a"]],
                        [torch.empty(40, 255)]).vec == 0
    # K4-halo: each loaded channel's ring pieces, the shard in the grid
    rings = [{p: torch.zeros(1) + i for i, p in enumerate(k4.RING_PIECES)}
             for _ in range(2)]
    hcall = k4.pack_call(plan, 8, [vals["b"], vals["a"]], [out], rings,
                         (40, 512), (120, 1024), 8)
    assert (hcall.R0, hcall.C0, hcall.H, hcall.W, hcall.d) == (
        40, 512, 120, 1024, 8)
    assert [hcall.ring[1][i] for i in range(8)] == [
        rings[1][p].data_ptr() for p in k4.RING_PIECES]
    # the bf16 interior math's rectangle: empty unless a bf16 launch asks
    assert (call.br0, call.br1, call.bc0, call.bc1) == (0, 0, 0, 0)
    rcall = k4.pack_call(plan, 8, [vals["b"], vals["a"]], [out],
                         rect=(16, 24, 128, 256))
    assert (rcall.br0, rcall.br1, rcall.bc0, rcall.bc1) == (16, 24, 128, 256)
    # the paired walk's window rows: 0 for f32 compute, the plan's else
    assert call.rows16 == 0 and plan.rows16 is None
    plan16 = k4.plan_field(flows, ("a", "b", "c"), (40, 256), torch.float32,
                           8, compute_dtype=torch.bfloat16)
    assert plan16.rows == 48 and plan16.rows16 == 48
    assert plan16.unit.rows16_of("f32") == (32, 48)
    assert plan16.unit.rows16_of("bf16") == (32, 96)
    assert k4.pack_call(plan16, 8, [vals["b"], vals["a"]],
                        [out]).rows16 == 48
    # the C struct: pointers, then ints, 8-byte aligned, a kernel argument
    assert k4._FieldCall.inp.offset == 0 and k4._FieldCall.ring.offset == 64
    assert k4._FieldCall.out.offset == 576 and k4._FieldCall.h.offset == 640
    assert k4._FieldCall.br0.offset == 680
    assert k4._FieldCall.rows16.offset == 696
    assert ctypes.sizeof(k4._FieldCall) == 704 < 4096


def test_wrapper_contract_on_cpu():
    g = tvals(grids((40, 256)))
    out = {"a": torch.empty(40, 256), "b": torch.empty(40, 256)}
    before = k4.launches()
    step = k4.PallasFieldStep((40, 256), config4(), nsteps=2)
    res = step(g, out=out)
    assert res["a"] is out["a"] and res["b"] is out["b"]
    want = k4.field_step_plain(g, config4(), nsteps=2)
    assert torch.equal(out["a"], want["a"])
    # a CPU call runs the plain version: no kernel launched, none counted
    assert k4.launches() == before and step.launches == 0
    got = k4.pallas_field_step(g, config4(), nsteps=2)
    assert torch.equal(got["b"], want["b"])
    with pytest.raises(TypeError, match="float64"):
        step({k: v.double() for k, v in g.items()})
    with pytest.raises(ValueError, match="do not carry"):
        step({"a": g["a"]})
    # bf16 interior math is accepted and planned with its bf16 program
    step16 = k4.PallasFieldStep((40, 256), config4(), names=("a", "b"),
                                compute_dtype=torch.bfloat16)
    assert step16.planned.program16 is not None
    assert all(step16.planned.program16.rounds)
    with pytest.raises(ValueError, match="compute_dtype"):
        k4.PallasFieldStep((40, 256), config4(), compute_dtype="float16")


# -- the executor, the report and the CLI ---------------------------------------

def test_serial_executor_runs_k4_and_reports():
    g = grids((40, 256))
    space = tspace(g)
    model = mt.Model(config4(), 10.0, 1.0)
    out, rep = model.execute(space, mt.SerialExecutor("pallas", substeps=4),
                             steps=10)
    ref, _ = model.execute(space, mt.SerialExecutor("xla"), steps=10)
    for k in ("a", "b"):
        assert torch.equal(out.values[k], ref.values[k])
    assert rep.impl == "pallas"
    assert rep.backend_report == {"kernel": "K4 field_stencil",
                                  "substeps": 4, "launches": 0,
                                  "channels_written": ["a", "b"]}
    # the input space is left untouched
    np.testing.assert_array_equal(space.values["a"].numpy(),
                                  g["a"].astype(np.float32))
    # JAX's run of the same model agrees within the scaled tolerance
    jout, _ = mm.Model(config4(mm), 10.0, 1.0).execute(
        jspace(g), JSerial("pallas", substeps=4), steps=10)
    for k in ("a", "b"):
        assert_close_scaled(out.values[k].numpy(), jout.values[k], 10)


def test_auto_selected_and_conserves():
    space = tspace(grids((40, 256)))
    model = mt.Model(config4(), 4.0, 1.0)
    assert model.make_step(space, impl="auto").impl == "pallas"
    out, rep = model.execute(space, mt.SerialExecutor("auto"), steps=4)
    assert rep.impl == "pallas"
    assert rep.conservation_error() < model.conservation_threshold(space)


@pytest.mark.parametrize("channels", [2, 3])
def test_cli_coupled_chain_is_jax_chain(channels, capsys):
    ns = argparse.Namespace(model=None, flow="coupled", channels=channels,
                            rate=0.1, init=1.0, dimx=8, dimy=8,
                            dtype="float32", rect_grid=None, time=1.0,
                            time_step=1.0)
    _, jmodel = jax_build_model(ns)
    flows, init = build_flows(ns)
    assert [(type(f).__name__, f.attr, getattr(f, "modulator", None),
             f.flow_rate) for f in flows] == \
        [(type(f).__name__, f.attr, getattr(f, "modulator", None),
          f.flow_rate) for f in jmodel.flows]
    assert init == {f"c{i}": 1.0 for i in range(channels)}
    assert cli_main(["run", "--device=cpu", "--json", "--flow=coupled",
                     f"--channels={channels}", "--dimx=32", "--dimy=256",
                     "--impl=pallas", "--substeps=4", "--steps=9"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["impl"] == "pallas" and row["conserved"] is True
    assert row["kernel_launches"] == 0
    assert row["backend_report"]["kernel"] == "K4 field_stencil"
    assert row["backend_report"]["channels_written"] == [
        f"c{i}" for i in range(channels)]


def test_cli_refuses_bad_channel_counts():
    with pytest.raises(SystemExit, match="channels >= 2"):
        cli_main(["run", "--device=cpu", "--flow=coupled", "--channels=1"])
    with pytest.raises(SystemExit, match="applies to --flow=coupled"):
        cli_main(["run", "--device=cpu", "--flow=diffusion",
                  "--channels=3"])
