"""K4's code generator (``ops/field_codegen.py``) on the CPU, where there is
no nvcc: the generated text and the library name it gets, the constants'
literals, each operation's intrinsic, and, for every flow set the tests
lower, the generated outflow function evaluated line by line in torch
against ``eval_program`` bit for bit. Nothing here compiles."""

import re
import struct

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS, VON_NEUMANN_OFFSETS
from mpi_model_tpu_torch.ops import _build
from mpi_model_tpu_torch.ops import field_codegen as cg
from mpi_model_tpu_torch.ops import field_lower as fl
from mpi_model_tpu_torch.ops import field_stencil as k4
from mpi_model_tpu_torch.ops import fused_stencil as fs
from mpi_model_tpu_torch.ops.flow import Flow, cell_coords

import chip_smoke
from test_torch_field import OPS, Fn, chain3, config4

CUSTOM = ((-1, 0), (1, 1), (0, -1))
HOODS = {"moore": MOORE_OFFSETS, "von_neumann": VON_NEUMANN_OFFSETS,
         "custom": CUSTOM}
SMOKE_SETS = chip_smoke.field_flow_sets(mt, torch)


def unit(flows, names=("a", "b"), offsets=MOORE_OFFSETS):
    prog = fl.lower_flows(flows, names)
    return cg.unit_source(prog, offsets, k4.unit_rows(
        len(prog.outputs), len(cg.modulators(prog))))


# -- literals --------------------------------------------------------------------

def literal_bits(lit: str) -> int:
    """The f32 bits of a literal ``float_literal`` emitted, read back as a C
    compiler would."""
    m = re.fullmatch(r"__int_as_float\(0x([0-9a-f]{8})\)", lit)
    if m:
        return int(m.group(1), 16)
    m = re.fullmatch(r"(-?)(0x[0-9a-f]+(?:\.[0-9a-f]+)?p[+-]\d+)f", lit)
    assert m, lit
    v = float.fromhex(m.group(2))
    # the literal is exact in f32: packing must not round it
    assert struct.unpack("<f", struct.pack("<f", v))[0] == v, lit
    bits = struct.unpack("<I", struct.pack("<f", v))[0]
    return bits | (0x80000000 if m.group(1) else 0)


SPECIAL = [0.0, -0.0, 1.0, 0.1, 1.0 / 3.0, 1e-45, -1e-45, 3e-39,
           1.1754943508222875e-38, 3.4028234663852886e38, 1e39, -1e39,
           float("inf"), float("-inf"), float("nan"), 2.0 ** -149,
           -(2.0 ** 127)]


@pytest.mark.parametrize("x", SPECIAL, ids=repr)
def test_special_constants_round_trip(x):
    lit = cg.float_literal(x)
    assert literal_bits(lit) == cg.f32_bits(x)
    if cg.f32_bits(x) & 0x7F800000 == 0x7F800000:  # inf or NaN
        assert lit.startswith("__int_as_float(")


def test_literal_forms():
    assert cg.float_literal(0.1) == "0x1.99999ap-4f"
    assert cg.float_literal(1.0) == "0x1p+0f"
    assert cg.float_literal(-0.0) == "-0x0p+0f"
    assert cg.float_literal(0.0) == "0x0p+0f"
    assert cg.float_literal(1e-45) == "0x1p-149f"
    assert cg.float_literal(float("inf")) == "__int_as_float(0x7f800000)"
    assert cg.float_literal(float("-inf")) == "__int_as_float(0xff800000)"
    assert cg.float_literal(float("nan")) == "__int_as_float(0x7fc00000)"


def smoke_constants():
    out = []
    for flows in SMOKE_SETS.values():
        names = ("a", "b", "c")
        for op, _, _, a, b in fl.lower_flows(flows, names).code:
            out += [x[2] for x in (a, b) if x[0] == fl.K_CONST]
    return out


@pytest.mark.parametrize("x", smoke_constants(), ids=repr)
def test_smoke_flow_set_constants_round_trip(x):
    assert literal_bits(cg.float_literal(x)) == cg.f32_bits(x)


@settings(max_examples=300, deadline=None)
@given(st.floats(width=32, allow_nan=True, allow_infinity=True,
                 allow_subnormal=True))
def test_drawn_f32_constants_round_trip(x):
    assert literal_bits(cg.float_literal(x)) == cg.f32_bits(x)


@settings(max_examples=100, deadline=None)
@given(st.integers(min_value=0, max_value=2 ** 32 - 1))
def test_every_bit_pattern_round_trips(bits):
    x = struct.unpack("<f", struct.pack("<I", bits))[0]
    got = literal_bits(cg.float_literal(x))
    if x != x:  # NaN payloads go through the double; the class stays NaN
        assert (got & 0x7F800000) == 0x7F800000 and got & 0x7FFFFF
    else:
        assert got == bits


# -- the text and its library name -------------------------------------------------

def test_same_program_same_text_and_name():
    a = unit(config4())
    b = unit(config4())
    assert a.text == b.text
    assert _build.unit_name(a.text) == _build.unit_name(b.text)
    # names and flow labels are not in the text: one library for both
    renamed = [mt.Diffusion(0.1, "x"), mt.Coupled(0.05, "x", "y"),
               mt.Diffusion(0.2, "y")]
    assert unit(renamed, ("x", "y")).text == a.text
    assert "Diffusion" not in a.text and "Coupled" not in a.text
    # the library is named by the text, the headers and the flags
    assert _build.unit_name(a.text).startswith(_build.UNIT_STEM + "-")
    assert _build.unit_flags()[-1] == "--fmad=false"


CHANGED = {
    "constant": ([mt.Diffusion(0.1000001, "a"), mt.Coupled(0.05, "a", "b"),
                  mt.Diffusion(0.2, "b")], MOORE_OFFSETS),
    "operation": ([mt.Diffusion(0.1, "a"),
                   Fn(lambda a, b, o: 0.05 * a + b),
                   mt.Diffusion(0.2, "b")], MOORE_OFFSETS),
    "order": ([mt.Diffusion(0.2, "b"), mt.Coupled(0.05, "a", "b"),
               mt.Diffusion(0.1, "a")], MOORE_OFFSETS),
    "neighbourhood": (config4(), VON_NEUMANN_OFFSETS),
    "offset_order": (config4(), tuple(reversed(MOORE_OFFSETS))),
    "modulator": ([mt.Diffusion(0.1, "a"), mt.Coupled(0.05, "a", "b")],
                  MOORE_OFFSETS),
}


@pytest.mark.parametrize("change", sorted(CHANGED))
def test_a_change_changes_text_and_name(change):
    base = unit(config4())
    flows, offs = CHANGED[change]
    other = unit(flows, offsets=offs)
    assert other.text != base.text
    assert _build.unit_name(other.text) != _build.unit_name(base.text)


def test_header_edit_changes_name(tmp_path, monkeypatch):
    text = unit(config4()).text
    before = _build.unit_name(text)
    csrc = tmp_path / "csrc"
    import shutil
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert _build.unit_name(text) == before
    with open(csrc / "field_stencil.cuh", "a") as f:
        f.write("\n// edited\n")
    assert _build.unit_name(text) != before


# -- each operation's intrinsic ---------------------------------------------------

#: what the old interpreter's ``apply`` ran per opcode, and the lowered op
INTRINSICS = {
    "add": (lambda a, b, o: a + b, "__fadd_rn(w[0], m[0])"),
    "sub": (lambda a, b, o: a - b, "__fsub_rn(w[0], m[0])"),
    "mul": (lambda a, b, o: a * b, "__fmul_rn(w[0], m[0])"),
    "div": (lambda a, b, o: a / b, "__fdiv_rn(w[0], m[0])"),
    "min": (lambda a, b, o: torch.minimum(a, b),
            "mm_field::min_nan(w[0], m[0])"),
    "max": (lambda a, b, o: torch.maximum(a, b),
            "mm_field::max_nan(w[0], m[0])"),
    "neg": (lambda a, b, o: -a, "-(w[0])"),
    "exp": (lambda a, b, o: torch.exp(a), "expf(w[0])"),
    "abs": (lambda a, b, o: a.abs(), "fabsf(w[0])"),
    "row": (lambda a, b, o: (cell_coords(a, o)[0] - 2).to(a.dtype),
            "__int2float_rn(r - 2)"),
    "col": (lambda a, b, o: (cell_coords(a, o)[1] + 3).to(a.dtype) * a,
            "__fmul_rn(__int2float_rn(c + 3), w[0])"),
}


@pytest.mark.parametrize("op", sorted(INTRINSICS))
def test_each_operation_emits_its_intrinsic(op):
    fn, expr = INTRINSICS[op]
    prog = fl.lower_flows([Fn(fn)], ("a", "b"))
    lines = cg.outflow_source(prog)
    assert any(expr in line for line in lines), lines
    # one named register an instruction, and the acc that starts the sum
    assert sum(line.startswith("const float t") for line in lines) == \
        sum(c[0] != fl.OP_ACC for c in prog.code)
    assert lines[-1].startswith("of[0] = ")


def test_flows_of_one_channel_add_in_order():
    prog = fl.lower_flows(config4(), ("a", "b"))
    lines = cg.outflow_source(prog)
    assert "of[0] = t0;" in lines
    assert "of[0] = __fadd_rn(of[0], t3);" in lines
    assert lines.index("of[0] = t0;") < lines.index(
        "of[0] = __fadd_rn(of[0], t3);")


def test_config4_golden_text():
    prog = fl.lower_flows(config4(), ("a", "b"))
    assert cg.outflow_source(prog) == [
        "const float t0 = __fmul_rn(0x1.99999ap-4f, w[0]);",
        "of[0] = t0;",
        "const float t2 = __fmul_rn(0x1.99999ap-5f, w[0]);",
        "const float t3 = __fmul_rn(t2, w[1]);",
        "of[0] = __fadd_rn(of[0], t3);",
        "const float t5 = __fmul_rn(0x1.99999ap-3f, w[1]);",
        "of[1] = t5;",
    ]
    u = cg.unit_source(prog, MOORE_OFFSETS, {"f32": (48,), "bf16": (48,)})
    for line in ("static constexpr int kOut = 2;",
                 "static constexpr int kMod = 0;",
                 "static constexpr int kModSlots = 1;",
                 "static constexpr int kOffsets = 8;",
                 "static constexpr unsigned kOffCodes = 0x87653210u;",
                 '#include "field_stencil.cuh"',
                 "return mm_field::launch<Program, float, 48>(call, "
                 "stream);",
                 "return mm_field::launch<Program, __nv_bfloat16, 48>("
                 "call, stream);",
                 "MM_FIELD_COMMON_ENTRY_POINTS"):
        assert line in [x.strip() for x in u.text.splitlines()], line
    assert u.rows_of("f32") == (48,) and u.rows_of("bf16") == (48,)


def test_modulators_come_after_the_written_channels():
    prog = fl.lower_flows([mt.Coupled(0.05, "b", "a"),
                           mt.Coupled(0.05, "b", "c")], ("a", "b", "c"))
    assert prog.outputs == ("b",)
    assert cg.modulators(prog) == ("a", "c")
    assert k4.kernel_channels(prog) == ("b", "a", "c")
    text = "\n".join(cg.outflow_source(prog))
    assert "w[0]" in text and "m[0]" in text and "m[1]" in text
    assert "w[1]" not in text


# -- every lowered flow set generates, and computes eval_program ---------------------

def _evaluate(lines, w, m, r, c):
    """Run the generated outflow lines in torch, one C expression at a time,
    with the kernel's operations as torch's f32 operations."""
    env = {
        "__fadd_rn": torch.add, "__fsub_rn": torch.sub,
        "__fmul_rn": torch.mul, "__fdiv_rn": torch.div,
        "min_nan": torch.minimum, "max_nan": torch.maximum,
        "expf": torch.exp, "fabsf": torch.abs,
        "lit": lambda s: torch.tensor(float.fromhex(s), dtype=torch.float32),
        "bits": lambda b: torch.tensor(
            struct.unpack("<f", struct.pack("<I", b))[0],
            dtype=torch.float32),
        "__int2float_rn": lambda x: x.to(torch.float32),
        "w": w, "m": m, "r": r, "c": c, "of": [None] * len(w),
    }
    for line in lines:
        py = line.replace("const float ", "").rstrip(";")
        py = py.replace("mm_field::", "")
        py = re.sub(r"__int_as_float\((0x[0-9a-f]+)\)", r"bits(\1)", py)
        py = re.sub(r"(0x[0-9a-f]+(?:\.[0-9a-f]+)?p[+-]\d+)f", r"lit('\1')",
                    py)
        exec(py, env)
    return env["of"]


def lowered_flow_sets():
    sets = {f"smoke_{n}": f for n, f in SMOKE_SETS.items()}
    sets.update({f"op_{n}": [Fn(fn), mt.Coupled(0.05, "b", "a")]
                 for n, fn in OPS.items()})
    sets["config4"] = config4()
    sets["chain3"] = chain3()
    return sets


@pytest.mark.parametrize("name", sorted(lowered_flow_sets()))
def test_every_lowered_flow_set_generates_eval_program(name):
    flows = lowered_flow_sets()[name]
    names = ("a", "b", "c")
    prog = fl.lower_flows(flows, names)
    for offs in HOODS.values():
        u = cg.unit_source(prog, offs, k4.unit_rows(
            len(prog.outputs), len(cg.modulators(prog))))
        assert f"static constexpr int kOffsets = {len(offs)};" in u.text
        assert u.rows_of("f32") and u.rows_of("bf16")
    rng = np.random.default_rng(11)
    vals = {n: torch.from_numpy(rng.uniform(0.5, 2.0, (12, 20)).astype(
        np.float32)) for n in names}
    vals["a"][0, 0] = -0.0
    rows, cols = cell_coords(vals["a"], (3, 7))
    want = fl.eval_program(prog, vals, rows, cols)
    got = _evaluate(cg.outflow_source(prog),
                    [vals[n] for n in prog.outputs],
                    [vals[n] for n in cg.modulators(prog)], rows, cols)
    for i, n in enumerate(prog.outputs):
        g = torch.broadcast_to(got[i], want[n].shape)
        assert torch.equal(g.view(torch.int32),
                           torch.broadcast_to(want[n], g.shape)
                           .view(torch.int32)), n


class _Const(Flow):
    """A flow whose outflow is a constant (NaN, infinity, -0.0)."""

    footprint = "pointwise"
    attr = "a"

    def __init__(self, value):
        self.value = value

    def outflow(self, values, origin=(0, 0)):
        return values["a"] * 0.0 + self.value


@pytest.mark.parametrize("value", [float("nan"), float("inf"), -0.0, 1e-45])
def test_special_constants_in_a_unit(value):
    prog = fl.lower_flows([_Const(value)], ("a",))
    text = "\n".join(cg.outflow_source(prog))
    assert cg.float_literal(value) in text
    vals = {"a": torch.ones(2, 3)}
    rows, cols = cell_coords(vals["a"])
    want = fl.eval_program(prog, vals, rows, cols)["a"]
    got = _evaluate(cg.outflow_source(prog), [vals["a"]], [], rows, cols)[0]
    assert torch.equal(torch.broadcast_to(got, want.shape).view(torch.int32),
                       want.view(torch.int32))


# -- the paired bf16 program (outflow2) and the paired walk ---------------------
#
# A plain-torch emulation of what the kernel's bf16 interior math runs: the
# generated ``outflow2`` lines, each helper as its torch counterpart on a
# pair held as a [2, ...] tensor (index 0 the low half, window row 2m;
# index 1 the high half, row 2m+1): a pair instruction is ``rb`` of the f32
# operation on both halves, a half instruction the f32 operation on one
# half, ``pack_bf2`` rounds each half. Then the header's paired transport
# over the kernel's windows (``field_step_bf2``): shares, the rows above
# and below from the neighbouring pairs (``mm::straddle``), the inflow from
# +0 in ``offsets`` order, ``(v - of) + inflow``, each rounded. Held bit for
# bit to ``eval_program`` and to ``interior_steps_bf16`` (through
# ``field_step_plain(..., compute_dtype=bfloat16)``).

BF = torch.bfloat16
SIX = ((-1, -1), (-1, 0), (0, -1), (0, 1), (1, 0), (1, 1))
PAIR_HOODS = {"moore": MOORE_OFFSETS, "von_neumann": VON_NEUMANN_OFFSETS,
              "six": SIX, "custom": CUSTOM}


def _pair(x):
    """A [2P, ...] tensor as pairs: [2, P, ...] (rows 2m and 2m+1)."""
    return x.reshape(x.shape[0] // 2, 2, *x.shape[1:]).transpose(0, 1)


def _unpair(p):
    return p.transpose(0, 1).reshape(-1, *p.shape[2:])


def _pack(lo, hi):
    lo, hi = torch.broadcast_tensors(fs.rb(lo), fs.rb(hi))
    return torch.stack((lo, hi))


def _pair_const(bits_hex):
    v = struct.unpack("<f", struct.pack("<I", int(bits_hex, 16) << 16))[0]
    return torch.full((2, 1, 1), v, dtype=torch.float32)


def _evaluate2(lines, w, m, r, c):
    """Run the generated ``outflow2`` lines in torch: ``w``/``m`` are pairs
    ([2, P, W]), ``r`` the pairs' first rows and ``c`` their columns
    ([P, W] integer tensors)."""
    env = {
        "add_bf2": lambda a, b: fs.rb(a + b),
        "sub_bf2": lambda a, b: fs.rb(a - b),
        "mul_bf2": lambda a, b: fs.rb(a * b),
        "neg_bf2": lambda a: -a, "abs_bf2": lambda a: a.abs(),
        "lo_f32": lambda p: p[0], "hi_f32": lambda p: p[1],
        "pack_bf2": _pack, "pc": _pair_const,
        "__fadd_rn": torch.add, "__fsub_rn": torch.sub,
        "__fmul_rn": torch.mul, "__fdiv_rn": torch.div,
        "min_nan": torch.minimum, "max_nan": torch.maximum,
        "expf": torch.exp, "fabsf": torch.abs,
        "lit": lambda s: torch.tensor(float.fromhex(s), dtype=torch.float32),
        "bits": lambda b: torch.tensor(
            struct.unpack("<f", struct.pack("<I", b))[0],
            dtype=torch.float32),
        "__int2float_rn": lambda x: x.to(torch.float32),
        "w": w, "m": m, "r": r, "c": c, "of": [None] * len(w),
    }
    for line in lines:
        py = re.sub(r"^const (unsigned|float) ", "", line).rstrip(";")
        py = py.replace("mm_field::", "").replace("mm::", "")
        py = re.sub(r"\b0x([0-9a-f]{4})\1u\b", r"pc('\1')", py)
        py = re.sub(r"__int_as_float\((0x[0-9a-f]+)\)", r"bits(\1)", py)
        py = re.sub(r"(0x[0-9a-f]+(?:\.[0-9a-f]+)?p[+-]\d+)f", r"lit('\1')",
                    py)
        exec(py, env)
    return env["of"]


class _CastBack(Flow):
    """An f32 intermediate (a strongly typed numpy scalar) cast back to the
    channel's dtype: f32-typed instructions on the halves."""

    footprint = "pointwise"
    attr = "a"

    def outflow(self, values, origin=(0, 0)):
        v = values["a"]
        return (v.to(torch.float32) * np.float32(0.05)).to(v.dtype)


class _RowCol(Flow):
    """bf16 and f32 row and column operands, and a division by a cell."""

    footprint = "pointwise"
    attr = "b"

    def outflow(self, values, origin=(0, 0)):
        a, b = values["a"], values["b"]
        r, c = cell_coords(b, origin)
        f32 = (r + 1).to(torch.float32) * np.float32(1e-3)
        return (0.01 * b + (c - 1).to(b.dtype) * 1e-4 * a
                + f32.to(b.dtype) * b) / (a + 2.0)


def pair_flow_sets():
    """Every flow set of ``chip_smoke.field_flow_sets`` that lowers at bf16,
    a modulated flow, a strongly typed f32 scalar cast back, and row and
    column operands of both types."""
    sets = {}
    for name, flows in SMOKE_SETS.items():
        try:
            fl.lower_flows(flows, ("a", "b", "c"), BF)
        except ValueError:
            continue
        sets[f"smoke_{name}"] = flows
    sets["modulated"] = [mt.Coupled(0.05, "a", "c"),
                         mt.Coupled(0.1, "b", "a")]
    sets["f32_scalar"] = [_CastBack(), mt.Diffusion(0.2, "b")]
    sets["row_col"] = [mt.Diffusion(0.1, "a"), _RowCol()]
    return sets


PAIR_SETS = pair_flow_sets()


def test_every_smoke_flow_set_lowers_at_bf16():
    assert sorted(PAIR_SETS) == sorted(
        [f"smoke_{n}" for n in SMOKE_SETS]
        + ["modulated", "f32_scalar", "row_col"])


def _typed(prog):
    """Each instruction's operands' types (True: bf16-typed) and its own."""
    typed, out = {}, []
    for (op, dst, _, a, b), rnd in zip(prog.code, prog.rounds):
        ops = (a,) if op in (fl.OP_NEG, fl.OP_EXP, fl.OP_ABS, fl.OP_RND,
                             fl.OP_ACC) else (a, b)
        kinds = [typed[x[1]] if x[0] == fl.K_SLOT else
                 x[0] == fl.K_CHAN or (x[0] == fl.K_CONST and not
                                       cg.f32_bits(x[2]) & 0xFFFF)
                 or (x[0] in (fl.K_ROW, fl.K_COL) and bool(x[2]))
                 for x in ops]
        out.append((op, kinds, rnd))
        if op != fl.OP_ACC:
            typed[dst] = rnd
    return out


@pytest.mark.parametrize("name", sorted(PAIR_SETS))
def test_pair_plan_forms(name):
    """Rounded add/sub/mul/neg/abs/acc on bf16-typed operands run on the
    pair; every f32-typed instruction, div, exp, min, max and cast on the
    halves; the text has no fma, no ``mm_field::rb`` and no f32 pair
    instruction."""
    prog = fl.lower_flows(PAIR_SETS[name], ("a", "b", "c"), BF)
    plan = cg.pair_plan(prog)
    paired = {fl.OP_ADD, fl.OP_SUB, fl.OP_MUL, fl.OP_NEG, fl.OP_ABS,
              fl.OP_ACC}
    for (op, kinds, rnd), on_pair in zip(_typed(prog), plan):
        assert on_pair == (rnd and op in paired and all(kinds)), op
        if not rnd:
            assert not on_pair  # f32-typed: on the halves
    lines = cg.outflow2_source(prog)
    text = "\n".join(lines)
    assert "fma" not in text and "rb(" not in text
    assert "__fmul_rn" not in text or not all(plan)
    for pc, ((op, *_), on_pair) in enumerate(zip(prog.code, plan)):
        if op == fl.OP_ACC:
            continue
        mine = [x for x in lines if re.match(rf"const \w+ [plh]{pc} ", x)]
        if on_pair:
            assert len(mine) == 1 and mine[0].startswith("const unsigned")
        else:
            assert [x.split()[2] for x in mine][:2] == [f"l{pc}", f"h{pc}"]
            assert (len(mine) == 3) == bool(prog.rounds[pc])
    unit = k4.plan_field(PAIR_SETS[name], ("a", "b", "c"), (64, 128),
                         torch.float32, 2, compute_dtype=BF).unit.text
    assert unit.count("void outflow2(") == 1
    assert "mm_field::launch16<Program, ProgramBf16" in unit


def test_pair_plan_golden_text():
    prog = fl.lower_flows(config4(), ("a", "b"), BF)
    assert cg.outflow2_source(prog) == [
        "const unsigned p0 = mm::mul_bf2(0x3dcd3dcdu, w[0]);",
        "of[0] = p0;",
        "const unsigned p2 = mm::mul_bf2(0x3d4d3d4du, w[0]);",
        "const unsigned p3 = mm::mul_bf2(p2, w[1]);",
        "of[0] = mm::add_bf2(of[0], p3);",
        "const unsigned p5 = mm::mul_bf2(0x3e4d3e4du, w[1]);",
        "of[1] = p5;",
    ]
    rows = cg.outflow2_source(fl.lower_flows(
        [chip_smoke.field_flow_sets(mt, torch)["row_rate"][0]], ("a",), BF))
    # a bf16 row operand: rows r and r + 1, packed (each rounded)
    assert rows[0] == ("const unsigned p0 = mm::mul_bf2(0x3b033b03u, "
                       "mm::pack_bf2(__int2float_rn(r), "
                       "__int2float_rn(r + 1)));")
    with pytest.raises(ValueError, match="bf16 program"):
        cg.pair_plan(fl.lower_flows(config4(), ("a", "b")))


def _special(x, rng):
    """``x`` with some cells ±0, bf16 subnormals and ±inf."""
    flat = x.view(-1)
    vals = torch.tensor([0.0, -0.0, 2.0 ** -130, -(2.0 ** -128),
                         2.0 ** -133, float("inf"), float("-inf")])
    idx = torch.from_numpy(rng.choice(flat.numel(), 3 * len(vals),
                                      replace=False))
    flat[idx] = vals.repeat(3)
    return x


def _same(got, want):
    """Bit for bit, NaN compared by position."""
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan)) and torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32))


@pytest.mark.parametrize("special", [False, True], ids=["uniform", "special"])
@pytest.mark.parametrize("name", sorted(PAIR_SETS))
def test_paired_outflow_is_eval_program(name, special):
    names = ("a", "b", "c")
    prog = fl.lower_flows(PAIR_SETS[name], names, BF)
    rng = np.random.default_rng(17)
    vals = {n: fs.rb(torch.from_numpy(rng.uniform(0.5, 2.0, (14, 20))
                                      .astype(np.float32))) for n in names}
    if special:
        vals = {n: _special(v, rng) for n, v in vals.items()}
    origin = (255, 7)  # rows past 256, where bf16 rounds the row
    rows, cols = cell_coords(vals["a"], origin)
    want = fl.eval_program(prog, vals, rows, cols)
    got = _evaluate2(cg.outflow2_source(prog),
                     [_pair(vals[n]) for n in prog.outputs],
                     [_pair(vals[n]) for n in cg.modulators(prog)],
                     _pair(rows)[0], _pair(cols)[0])
    for i, n in enumerate(prog.outputs):
        shape = (2,) + _pair(want[n]).shape[1:]
        g = _unpair(torch.broadcast_to(got[i], shape))
        assert _same(g, want[n]), n


def paired_k4(prog16, chans, offsets, nsteps, rows, origin=(0, 0),
              depth=0):
    """The kernel's paired walk emulated in torch over its windows: tiles of
    ``rows - 2 nsteps`` output rows over the [h, w] array at global
    ``origin``, each window ``rows`` rows as pairs, ``nsteps`` interior-form
    steps of ``outflow2`` and the paired transport, the window's rows
    [n, rows - n) kept. ``chans`` hold the array with a ring ``depth``
    deep (K4-halo's ring; 0: K4), zeros past it. Columns are not tiled (a
    window column a thread changes no value). Returns the written channels
    over [h, w]; only cells whose n-cone is on the grid are the bf16
    interior math's."""
    hp, wp = next(iter(chans.values())).shape
    d, n, k = int(depth), int(nsteps), len(offsets)
    h, w = hp - 2 * d, wp - 2 * d
    th = rows - 2 * n
    lines = cg.outflow2_source(prog16)
    mods = cg.modulators(prog16)
    out = {a: torch.empty(h, w) for a in prog16.outputs}
    for t0 in range(0, h, th):
        pr0 = d + t0 - n  # the window's first row in the ringed array
        win = {}
        for name, x in chans.items():
            p = torch.zeros(rows, w + 2 * n)
            lo, hi = max(pr0, 0), min(pr0 + rows, hp)
            xc = torch.nn.functional.pad(x, (n, n))  # zeros past it
            p[lo - pr0:hi - pr0] = xc[lo:hi, d:d + w + 2 * n]
            win[name] = _pair(p)
        pr = torch.arange(rows // 2)[:, None].expand(rows // 2, w + 2 * n)
        r = origin[0] + t0 - n + 2 * pr
        c = (origin[1] - n + torch.arange(w + 2 * n))[None, :].expand_as(r)
        v = {a: win[a] for a in prog16.outputs}
        m = [win[u] for u in mods]
        for _ in range(n):
            of = _evaluate2(lines, [v[a] for a in prog16.outputs], m, r, c)
            for i, a in enumerate(prog16.outputs):
                o = torch.broadcast_to(of[i], v[a].shape)
                sh = (fs.rb(o * (1.0 / k)) if k & (k - 1) == 0
                      else _pack(o[0] / float(k), o[1] / float(k)))
                lo_, hi_ = sh[0], sh[1]
                zero = torch.zeros_like(lo_[:1])
                # rows above (2m-1, 2m) and below (2m+1, 2m+2): straddles
                up = torch.stack((torch.cat((zero, hi_[:-1])), lo_))
                dn = torch.stack((hi_, torch.cat((lo_[1:], zero))))
                by_dx = {-1: up, 0: sh, 1: dn}
                g = torch.zeros_like(sh)
                for dx, dy in offsets:
                    s = torch.nn.functional.pad(by_dx[dx], (1, 1))
                    g = fs.rb(g + s[..., 1 + dy:1 + dy + w + 2 * n])
                v[a] = fs.rb(fs.rb(v[a] - o) + g)
        for a in prog16.outputs:
            full = _unpair(v[a])[n:rows - n, n:n + w]
            out[a][t0:t0 + th] = full[:min(th, h - t0)]
    return out


#: (shape, block, nsteps, origin, global shape): JAX's bf16 rectangle of
#: each case; (225, 640) at block (45, 128) has an odd number of rows in
#: it, starting at an odd row; the shard cases sit at a global origin
PAIR_GRIDS = {
    "dense_ns1": ((48, 96), (8, 16), 1, (0, 0), None),
    "dense_ns4": ((64, 96), (8, 16), 4, (0, 0), None),
    "odd_rect_ns3": ((225, 64), (45, 16), 3, (0, 0), None),
    "shard_ns8": ((64, 64), (16, 16), 8, (64, 128), (192, 320)),
}


@pytest.mark.parametrize("grid", sorted(PAIR_GRIDS))
@pytest.mark.parametrize("hood", sorted(PAIR_HOODS))
@pytest.mark.parametrize("name", sorted(PAIR_SETS))
def test_paired_walk_is_interior_steps_bf16(name, hood, grid):
    """The paired walk, emulated over the kernel's windows at the rows the
    plan picks, equals ``interior_steps_bf16`` (and, on a whole grid, the
    plain version ``field_step_plain(..., compute_dtype=bfloat16)``) bit
    for bit on every cell of the bf16 rectangle. A shard case reads its
    values past the shard from the whole grid, as K4-halo reads its
    ring."""
    shape, block, ns, origin, gshape = PAIR_GRIDS[grid]
    offs = PAIR_HOODS[hood]
    flows = PAIR_SETS[name]
    names = ("a", "b", "c")
    gshape = gshape or shape
    rng = np.random.default_rng(23)
    full = {n: fs.rb(torch.from_numpy(rng.uniform(0.5, 2.0, gshape).astype(
        np.float32))) for n in names}
    plan = k4.plan_field(flows, names, shape, torch.float32, ns, block,
                         offs, BF)
    prog16 = plan.program16
    r0, r1, c0, c1 = fs.bf16_rect(shape, block, ns, origin, gshape)
    assert r1 > r0 and c1 > c0
    if grid == "odd_rect_ns3":
        assert (r1 - r0) % 2 == 1 and r0 % 2 == 1
    d = ns if gshape != shape else 0
    (R0, C0), (h, w) = origin, shape
    ringed = {n: full[n][R0 - d:R0 + h + d, C0 - d:C0 + w + d]
              for n in prog16.channels}
    want = k4.interior_steps_bf16(ringed, prog16, offs, ns,
                                  (R0 - d, C0 - d))
    got = paired_k4(prog16, ringed, offs, ns, plan.rows16, origin, d)
    for a in prog16.outputs:
        assert _same(got[a][r0:r1, c0:c1],
                     want[a][d + r0:d + r1, d + c0:d + c1]), a
    if d == 0:  # the whole plain version, through its entry point
        whole = k4.field_step_plain(full, flows, offs, ns,
                                    compute_dtype=BF, block=block)
        for a in prog16.outputs:
            assert _same(got[a][r0:r1, c0:c1], whole[a][r0:r1, c0:c1]), a
