"""K4's code generator: one CUDA unit per lowered flow set.

The TPU field kernel (``mpi_model_tpu/ops/pallas_stencil.py::_field_call``)
calls each flow's own ``outflow`` in its body, so Mosaic compiles one kernel
per flow set. The port lowers the flows once (``ops.field_lower``) and turns
the lowered ``FieldProgram`` into the text of one CUDA unit:

- a struct holding the program's facts (written channels, modulators, the
  neighbourhood in ``offsets`` order) and one ``__device__`` function that
  computes every written channel's summed outflow at one cell from the
  cell's channel values and its global row and column. Each instruction
  becomes one named register and one ``_rn`` intrinsic, in program order;
  the ``acc`` sums follow the program's order, as ``eval_program`` adds
  them. ``min``/``max`` are ``min_nan``/``max_nan`` (torch's NaN rule),
  ``exp`` is ``expf``, a row or column operand is
  ``__int2float_rn(r + arg)``. Constants are exact hex-float literals of
  their f32 value; infinities and NaN are written by their bit pattern.
- for a bf16-compute plan, a second struct of the bf16 program (the TPU
  kernel's interior math under ``compute_dtype=bfloat16``) whose function
  ``outflow2`` is its paired form: two window rows a register (bf16x2, the
  low half row 2m, the high half row 2m+1), each instruction in the form
  ``pair_plan`` decides. On the pair: a rounded ``add``, ``sub``, ``mul``,
  ``neg``, ``abs`` or ``acc`` whose operands are all bf16-typed, as one
  ``add.rn``/``sub.rn``/``mul.rn`` ``.bf16x2`` or a sign-bit xor or mask
  (never ``fma``: the plain version rounds the product). On the f32 halves
  (``mm::lo_f32``/``mm::hi_f32``, exact): every other instruction (f32-typed
  ones, ``div``, ``exp``, ``min``/``max``, a cast to bf16), its result
  packed back to a pair (``mm::pack_bf2``, rounding each half) where
  ``rounds`` flags it. A row operand's halves are rows r and r+1; a
  bf16-typed coordinate is packed from its two halves.
- the C entry points, which launch ``csrc/field_stencil.cuh``'s body with
  that program at each window height the program can ask for (and the
  bf16-compute entry points ``mm_field_cbf16_*`` with both programs: the
  f32 walk at those heights, the paired walk at its own, ``rows16``).

The walk, the loads and the transport live in the header; only the program
is generated. The text names no channel and no flow, so flow sets that lower
to the same program share one library. ``ops._build.build_unit`` compiles a
unit, and names its library by a hash of the text, the headers it includes
and the flags.
"""

from __future__ import annotations

import dataclasses
import math
import struct
from typing import Optional, Sequence

import torch

from .field_lower import (K_CHAN, K_COL, K_CONST, K_ROW, K_SLOT, OP_ABS,
                          OP_ACC, OP_ADD, OP_DIV, OP_EXP, OP_MAX, OP_MIN,
                          OP_MUL, OP_NEG, OP_RND, OP_SUB, FieldProgram)

#: the header every unit includes (``csrc/``)
HEADER = "field_stencil.cuh"
#: pair words a thread holds, at most, in an instance of the paired walk
#: built for two blocks an SM (128 registers a thread). A bf16 program's
#: struct carries it (``kTwoBlockWords``) for the header's launch bounds,
#: and ``field_stencil.window_rows16`` picks the rows by it: one threshold.
#: Measured on config 4 alone (96 rows, ``k4_variants.py``).
TWO_BLOCK_WORDS = 96

#: the expression of each operation on operands ``x`` and ``y``
_BINARY = {OP_ADD: "__fadd_rn({x}, {y})", OP_SUB: "__fsub_rn({x}, {y})",
           OP_MUL: "__fmul_rn({x}, {y})", OP_DIV: "__fdiv_rn({x}, {y})",
           OP_MIN: "mm_field::min_nan({x}, {y})",
           OP_MAX: "mm_field::max_nan({x}, {y})"}
_UNARY = {OP_NEG: "-({x})", OP_EXP: "expf({x})", OP_ABS: "fabsf({x})",
          OP_RND: "{x}"}


def f32_bits(x: float) -> int:
    """The bits of ``x`` rounded to f32 as the kernel's and the plain
    version's constants are (``eval_program``: ``torch.tensor(x,
    dtype=float32)``)."""
    t = torch.tensor(float(x), dtype=torch.float32)
    return int(t.view(torch.int32).item()) & 0xFFFFFFFF


def float_literal(x: float) -> str:
    """``x`` rounded to f32, as a CUDA expression of exactly that value: a
    hex-float literal (``0x1.99999ap-4f``), or ``__int_as_float(0x...)``
    for an infinity or a NaN."""
    bits = f32_bits(x)
    v = struct.unpack("<f", struct.pack("<I", bits))[0]
    if math.isinf(v) or math.isnan(v):
        return f"__int_as_float(0x{bits:08x})"
    sign, mag = ("-", -v) if bits >> 31 else ("", v)
    mant, exp = mag.hex()[2:].split("p")  # "1.99999a0000000", "-4"
    mant = mant.rstrip("0").rstrip(".")
    return f"{sign}0x{mant}p{exp}f"


def offset_codes(offsets: Sequence[tuple[int, int]]) -> int:
    """The neighbourhood in ``offsets`` order, 4 bits an offset:
    ``(dx + 1) * 3 + (dy + 1)`` (the header's ``kOffCodes``)."""
    code = 0
    for i, (dx, dy) in enumerate(offsets):
        code |= ((dx + 1) * 3 + (dy + 1)) << (4 * i)
    return code


def modulators(prog: FieldProgram) -> tuple[str, ...]:
    """The loaded channels no flow writes, in ``channels`` order; the
    kernel loads the written channels first (``outputs``), then these."""
    return tuple(n for n in prog.channels if n not in prog.outputs)


def outflow_source(prog: FieldProgram) -> list[str]:
    """The body of an f32 program's outflow function, one line an
    instruction: ``w[i]`` is written channel i, ``m[i]`` modulator i,
    (``r``, ``c``) the cell's global row and column, ``of[i]`` written
    channel i's summed outflow."""
    mods = modulators(prog)
    chan = {i: (f"w[{prog.outputs.index(n)}]" if n in prog.outputs
                else f"m[{mods.index(n)}]")
            for i, n in enumerate(prog.channels)}
    slot: dict[int, str] = {}  # slot -> the register holding it

    def operand(x) -> str:
        kind, arg, val = x
        if kind == K_SLOT:
            return slot[arg]
        if kind == K_CHAN:
            return chan[arg]
        if kind == K_CONST:
            return float_literal(val)
        return _coord(kind, arg, 0)

    lines = []
    for pc, (op, dst, first, a, b) in enumerate(prog.code):
        if op == OP_ACC:
            x = operand(a)
            lines.append(f"of[{dst}] = {x};" if first
                         else f"of[{dst}] = __fadd_rn(of[{dst}], {x});")
            continue
        form = _UNARY.get(op) or _BINARY[op]
        expr = form.format(x=operand(a), y=operand(b) if op in _BINARY
                           else "")
        slot[dst] = f"t{pc}"
        lines.append(f"const float t{pc} = {expr};")
    return lines


#: the operations that run as one instruction on a bf16x2 pair
_PAIR = {OP_ADD: "mm::add_bf2({x}, {y})",
         OP_SUB: "mm_field::sub_bf2({x}, {y})",
         OP_MUL: "mm::mul_bf2({x}, {y})", OP_NEG: "mm_field::neg_bf2({x})",
         OP_ABS: "mm_field::abs_bf2({x})"}


def _operands(op: int, a, b) -> tuple:
    return (a,) if op in _UNARY or op == OP_ACC else (a, b)


def bf16_bits(val: float) -> Optional[int]:
    """The bf16 bits of ``val`` rounded to f32, or None when that f32
    value is not exactly a bf16 value."""
    bits = f32_bits(val)
    return None if bits & 0xFFFF else bits >> 16


def pair_plan(prog: FieldProgram) -> tuple[bool, ...]:
    """One flag an instruction of a bf16 program: True where it runs as one
    instruction on the pair, False where it runs on the two f32 halves.

    On the pair: a rounded ``add``, ``sub``, ``mul``, ``neg``, ``abs`` or
    ``acc`` whose operands are all bf16-typed: a channel, a slot some
    rounded instruction wrote, a constant that is exactly a bf16 value, a
    coordinate the program rounds to bf16. An f32 operation on bf16 values
    rounded once is the bf16 operation (f32 carries more than 2·8 + 2
    bits), so the pair's instruction gives the plain version's bits.
    Everything else runs on the halves: f32-typed operations (JAX's
    promotion rule), ``div`` and ``exp`` (no bf16x2 form), ``min``/``max``
    (the pair's ``min``/``max`` order ±0 and treat NaN otherwise than
    torch), and a cast to bf16 of an f32 value. An ``acc`` must run on the
    pair (the outflows are pairs): a bf16 program's flows end in bf16."""
    if not prog.rounds:
        raise ValueError("pair_plan takes a bf16 program (lower_flows(..., "
                         "torch.bfloat16))")
    typed: dict[int, bool] = {}  # slot -> bf16-typed (a rounded result)

    def bf16_typed(x) -> bool:
        kind, arg, val = x
        if kind == K_SLOT:
            return typed[arg]
        if kind == K_CHAN:
            return True
        if kind == K_CONST:
            return bf16_bits(val) is not None
        return bool(val)  # a coordinate: rounded to bf16 when flagged

    plan = []
    for (op, dst, _, a, b), rnd in zip(prog.code, prog.rounds):
        on_pair = (rnd and (op in _PAIR or op == OP_ACC)
                   and all(bf16_typed(x) for x in _operands(op, a, b)))
        if op == OP_ACC and not on_pair:
            raise ValueError("an outflow of a bf16 program ends in float32; "
                             "lower_flows refuses such a flow")
        plan.append(on_pair)
        if op != OP_ACC:
            typed[dst] = bool(rnd)
    return tuple(plan)


def _coord(kind: int, arg: int, half: int) -> str:
    """A coordinate operand in the pair's half ``half`` (0: row r, 1: row
    r + 1; a column is the same in both)."""
    coord = "r" if kind == K_ROW else "c"
    arg += half if kind == K_ROW else 0
    shift = f" + {arg}" if arg > 0 else f" - {-arg}" if arg < 0 else ""
    return f"__int2float_rn({coord}{shift})"


def outflow2_source(prog: FieldProgram) -> list[str]:
    """The body of a bf16 program's paired outflow function, one line an
    instruction on the pair, two or three on the halves, in the forms
    ``pair_plan`` gives: ``w[i]`` is written channel i's pair, ``m[i]``
    modulator i's, ``r`` the pair's first global row and ``c`` its column,
    ``of[i]`` written channel i's summed outflow pair. A pair result is
    register ``p<pc>``; an f32 result is the halves ``l<pc>``, ``h<pc>``."""
    mods = modulators(prog)
    chan = {i: (f"w[{prog.outputs.index(n)}]" if n in prog.outputs
                else f"m[{mods.index(n)}]")
            for i, n in enumerate(prog.channels)}
    slot: dict[int, tuple[str, ...]] = {}  # slot -> (pair,) or (lo, hi)

    def pair(x) -> str:
        kind, arg, val = x
        if kind == K_SLOT:
            return slot[arg][0]
        if kind == K_CHAN:
            return chan[arg]
        if kind == K_CONST:
            bits = bf16_bits(val)
            return f"0x{bits:04x}{bits:04x}u"
        return f"mm::pack_bf2({_coord(kind, arg, 0)}, {_coord(kind, arg, 1)})"

    def half(x, h: int) -> str:
        kind, arg, val = x
        if kind == K_SLOT and len(slot[arg]) == 2:
            return slot[arg][h]
        if kind == K_CONST:
            return float_literal(val)
        if kind in (K_ROW, K_COL) and not val:
            return _coord(kind, arg, h)
        return f"mm::{'hi' if h else 'lo'}_f32({pair(x)})"

    lines = []
    for pc, ((op, dst, first, a, b), rnd, on_pair) in enumerate(
            zip(prog.code, prog.rounds, pair_plan(prog))):
        if op == OP_ACC:
            x = pair(a)
            lines.append(f"of[{dst}] = {x};" if first
                         else f"of[{dst}] = mm::add_bf2(of[{dst}], {x});")
            continue
        if on_pair:
            expr = _PAIR[op].format(x=pair(a), y=pair(b) if op in _BINARY
                                    else "")
            slot[dst] = (f"p{pc}",)
            lines.append(f"const unsigned p{pc} = {expr};")
            continue
        form = _UNARY.get(op) or _BINARY[op]
        for h, reg in enumerate((f"l{pc}", f"h{pc}")):
            expr = form.format(x=half(a, h), y=half(b, h) if op in _BINARY
                               else "")
            lines.append(f"const float {reg} = {expr};")
        if rnd:
            slot[dst] = (f"p{pc}",)
            lines.append(f"const unsigned p{pc} = mm::pack_bf2(l{pc}, h{pc});")
        else:
            slot[dst] = (f"l{pc}", f"h{pc}")
    return lines


@dataclasses.dataclass(frozen=True)
class FieldUnit:
    """One generated unit: its text and the window heights it carries per
    storage dtype (``"f32"``, ``"bf16"``)."""

    text: str
    rows: tuple[tuple[str, tuple[int, ...]], ...]
    #: the paired walk's window heights (bf16-compute units; else empty)
    rows16: tuple[tuple[str, tuple[int, ...]], ...] = ()

    def rows_of(self, dtype: str) -> tuple[int, ...]:
        return dict(self.rows)[dtype]

    def rows16_of(self, dtype: str) -> tuple[int, ...]:
        return dict(self.rows16).get(dtype, ())


def _program_struct(name: str, prog: FieldProgram, offsets: tuple) -> str:
    """One program's struct: its facts and its outflow function (a bf16
    program's paired form, ``outflow2``)."""
    n_out, n_mod = len(prog.outputs), len(modulators(prog))
    two_block = ""
    if prog.rounds:
        two_block = (f"  static constexpr int kTwoBlockWords = "
                     f"{TWO_BLOCK_WORDS};\n")
        body = "\n".join(f"    {line}" for line in outflow2_source(prog))
        fn = """outflow2(
      const unsigned (&w)[kOut], const unsigned (&m)[kModSlots], int r,
      int c, unsigned (&of)[kOut])"""
    else:
        body = "\n".join(f"    {line}" for line in outflow_source(prog))
        fn = """outflow(
      const float (&w)[kOut], const float (&m)[kModSlots], int r, int c,
      float (&of)[kOut])"""
    return f"""\
struct {name} {{
  static constexpr int kOut = {n_out};
  static constexpr int kMod = {n_mod};
  static constexpr int kModSlots = {max(n_mod, 1)};
  static constexpr int kOffsets = {len(offsets)};
  static constexpr unsigned kOffCodes = 0x{offset_codes(offsets):x}u;
{two_block}
  static __device__ __forceinline__ void {fn} {{
{body}
  }}
}};
"""


def unit_source(prog: FieldProgram, offsets: Sequence[tuple[int, int]],
                rows: dict[str, Sequence[int]],
                prog16: Optional[FieldProgram] = None,
                rows16: Optional[dict[str, Sequence[int]]] = None
                ) -> FieldUnit:
    """The unit for ``prog`` over ``offsets``, with an instance for each
    window height in ``rows`` (``{"f32": (...), "bf16": (...)}``); with
    ``prog16`` (the same flows lowered at bf16) also the bf16-compute entry
    points, whose interior tiles run it on the paired walk at the heights
    in ``rows16`` (the same form of dict)."""
    offsets = tuple((int(dx), int(dy)) for dx, dy in offsets)
    hood = " ".join(f"({dx},{dy})" for dx, dy in offsets)
    rows = {k: tuple(sorted(set(int(r) for r in v))) for k, v in
            sorted(rows.items())}
    rows16 = {k: tuple(sorted(set(int(r) for r in v))) for k, v in
              sorted((rows16 or {}).items())} if prog16 is not None else {}
    entries = []
    for dname, ctype in (("f32", "float"), ("bf16", "__nv_bfloat16")):
        rs = ", ".join(str(r) for r in rows[dname])
        entries.append(
            f'extern "C" int mm_field_{dname}(const void* call, void* '
            f"stream) {{\n  return mm_field::launch<Program, {ctype}, {rs}>"
            f"(call, stream);\n}}\n"
            f'extern "C" int mm_field_smem_{dname}(int rows) {{\n'
            f"  return mm_field::smem_of<Program, {ctype}, {rs}>(rows);\n}}\n")
        if prog16 is not None:
            rs16 = ", ".join(str(r) for r in rows16[dname])
            entries.append(
                f'extern "C" int mm_field_cbf16_{dname}(const void* call, '
                f"void* stream) {{\n  return mm_field::launch16<Program, "
                f"ProgramBf16, {ctype}>(\n      call, stream, "
                f"mm_field::Rows<{rs}>{{}}, mm_field::Rows<{rs16}>{{}});\n}}\n"
                f'extern "C" int mm_field_smem16_{dname}(int rows) {{\n'
                f"  return mm_field::smem16_of<ProgramBf16, {ctype}, {rs16}>"
                f"(rows);\n}}\n")
    structs = _program_struct("Program", prog, offsets)
    if prog16 is not None:
        structs += "\n" + _program_struct("ProgramBf16", prog16, offsets)
    text = f"""\
// K4's outflow for one lowered flow set: {prog.n_flows} flows, {len(prog.code)} instructions.
// Generated by mpi_model_tpu_torch/ops/field_codegen.py; built with {HEADER}.
// Neighbourhood: {hood}.
#include "{HEADER}"

namespace {{

{structs}
}}  // namespace

{"".join(entries)}
MM_FIELD_COMMON_ENTRY_POINTS
"""
    return FieldUnit(text=text, rows=tuple(rows.items()),
                     rows16=tuple(rows16.items()))
