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
