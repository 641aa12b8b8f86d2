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
  kernel's interior math under ``compute_dtype=bfloat16``): each result
  ``FieldProgram.rounds`` flags is wrapped in ``mm_field::rb`` (rounded to
  bf16), as ``eval_program`` rounds it.
- the C entry points, which launch ``csrc/field_stencil.cuh``'s body with
  that program at each window height the program can ask for (and the
  bf16-compute entry points ``mm_field_cbf16_*`` with both programs).

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

from .field_lower import (K_CHAN, K_CONST, K_ROW, K_SLOT, OP_ABS, OP_ACC,
                          OP_ADD, OP_DIV, OP_EXP, OP_MAX, OP_MIN, OP_MUL,
                          OP_NEG, OP_RND, OP_SUB, FieldProgram)

#: the header every unit includes (``csrc/``)
HEADER = "field_stencil.cuh"

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
    """The body of the program's outflow function, one line an
    instruction: ``w[i]`` is written channel i, ``m[i]`` modulator i,
    (``r``, ``c``) the cell's global row and column, ``of[i]`` written
    channel i's summed outflow. A bf16 program's flagged results are
    rounded to bf16 (``mm_field::rb``)."""
    mods = modulators(prog)
    rounds = prog.rounds or (False,) * len(prog.code)
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
        coord = "r" if kind == K_ROW else "c"
        shift = f" + {arg}" if arg > 0 else f" - {-arg}" if arg < 0 else ""
        x = f"__int2float_rn({coord}{shift})"
        return f"mm_field::rb({x})" if val else x

    lines = []
    for pc, (op, dst, first, a, b) in enumerate(prog.code):
        if op == OP_ACC:
            x = operand(a)
            add = f"__fadd_rn(of[{dst}], {x})"
            if rounds[pc]:
                add = f"mm_field::rb({add})"
            lines.append(f"of[{dst}] = {x};" if first
                         else f"of[{dst}] = {add};")
            continue
        form = _UNARY.get(op) or _BINARY[op]
        expr = form.format(x=operand(a), y=operand(b) if op in _BINARY
                           else "")
        if rounds[pc]:
            expr = f"mm_field::rb({expr})"
        slot[dst] = f"t{pc}"
        lines.append(f"const float t{pc} = {expr};")
    return lines


@dataclasses.dataclass(frozen=True)
class FieldUnit:
    """One generated unit: its text and the window heights it carries per
    storage dtype (``"f32"``, ``"bf16"``)."""

    text: str
    rows: tuple[tuple[str, tuple[int, ...]], ...]

    def rows_of(self, dtype: str) -> tuple[int, ...]:
        return dict(self.rows)[dtype]


def _program_struct(name: str, prog: FieldProgram, offsets: tuple) -> str:
    """One program's struct: its facts and its outflow function."""
    n_out, n_mod = len(prog.outputs), len(modulators(prog))
    body = "\n".join(f"    {line}" for line in outflow_source(prog))
    return f"""\
struct {name} {{
  static constexpr int kOut = {n_out};
  static constexpr int kMod = {n_mod};
  static constexpr int kModSlots = {max(n_mod, 1)};
  static constexpr int kOffsets = {len(offsets)};
  static constexpr unsigned kOffCodes = 0x{offset_codes(offsets):x}u;
{"  static constexpr bool kBf16 = true;" + chr(10) if prog.rounds else ""}
  static __device__ __forceinline__ void outflow(
      const float (&w)[kOut], const float (&m)[kModSlots], int r, int c,
      float (&of)[kOut]) {{
{body}
  }}
}};
"""


def unit_source(prog: FieldProgram, offsets: Sequence[tuple[int, int]],
                rows: dict[str, Sequence[int]],
                prog16: Optional[FieldProgram] = None) -> FieldUnit:
    """The unit for ``prog`` over ``offsets``, with an instance for each
    window height in ``rows`` (``{"f32": (...), "bf16": (...)}``); with
    ``prog16`` (the same flows lowered at bf16) also the bf16-compute entry
    points, whose interior tiles run it."""
    offsets = tuple((int(dx), int(dy)) for dx, dy in offsets)
    hood = " ".join(f"({dx},{dy})" for dx, dy in offsets)
    rows = {k: tuple(sorted(set(int(r) for r in v))) for k, v in
            sorted(rows.items())}
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
            entries.append(
                f'extern "C" int mm_field_cbf16_{dname}(const void* call, '
                f"void* stream) {{\n  return mm_field::launch16<Program, "
                f"ProgramBf16, {ctype}, {rs}>(call, stream);\n}}\n")
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
    return FieldUnit(text=text, rows=tuple(rows.items()))
