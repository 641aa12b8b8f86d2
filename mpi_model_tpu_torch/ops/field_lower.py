"""Lowering of pointwise flows to the programs the field kernel K4 runs.

The TPU field kernel (``mpi_model_tpu/ops/pallas_stencil.py::_field_call``)
calls each flow's own ``outflow(values, origin)`` on its VMEM windows, and
Pallas traces that Python into the kernel. A CUDA kernel cannot run Python,
so the port lowers every flow once, when the step is built:

- ``lower_flows`` calls ``flow.outflow`` with symbolic cell values
  (``Sym``). A ``Sym`` records what the flow computes through the Python
  operators and ``__torch_function__``; the recorded tree becomes a short
  program per flow.
- **Whitelist** (the primitives of ``mpi_model_tpu/ir/expr.py``): add, sub,
  mul, div, min, max, neg, exp, abs; integer powers 1 to 3 as repeated
  multiplication (torch computes ``x**2`` and ``x**3`` that way, and
  ``x**n`` for larger n through ``pow``, which rounds differently). Leaves
  are constants, channel reads and the cell's global row and column (from
  ``ops.flow.cell_coords``). Operand order is kept. A constant keeps the
  value it had when traced: a 0-d tensor its own value, a Python number
  is rounded to the traced dtype where it is used, as torch does.
- **Anything else is refused** with a ``ValueError`` that names the flow
  and the operation: a reduction, indexing, a shape read, a comparison,
  an unknown torch function, a host read (``float(v)``, ``bool(v)``,
  ``v.item()``) or a non-scalar tensor captured from outside the cell.
- The symbolic values report ``dtype=torch.float32`` by default, K4's
  compute dtype whatever the storage dtype, as the TPU kernel evaluates
  ``outflow`` on windows already cast to f32: a bf16 grid's
  ``Diffusion(0.1)`` sheds ``f32(0.1)·v``.
- Division is IEEE division in K4 and in ``eval_program``. A Python number
  divided by a cell value lowers as torch computes it, ``(1 / v) * c``.
  (Torch on the card divides by a Python-number divisor as a multiply by
  its reciprocal, so a flow written ``v / 3.0`` can differ there from K4
  by an ulp; a tensor divisor divides.)

A program is in **register form**: three-address instructions whose
operands are a slot (an intermediate result), a channel, a constant, or
the cell's row or column, and whose result goes to the lowest free slot or,
for the ``acc`` that ends each flow, is added to its channel's outflow. In
K4 every slot is a shared-memory plane over the block's window, and each
instruction is dispatched once and applied to all of a thread's cells; the
program travels in the launch argument (``field_stencil.pack_program``).
``eval_program`` runs a program in plain torch; the tests hold it bit for
bit to ``build_outflow`` at f32 and f64. Limits, checked by
``check_program``: ``MAX_FLOWS`` flows, ``MAX_CHANNELS`` channels,
``MAX_CODE`` instructions and ``MAX_SLOTS`` slots.
"""

from __future__ import annotations

import dataclasses
import numbers
from typing import Mapping, Optional, Sequence

import torch

# opcodes and operand kinds: csrc/field_stencil.cu's enums
OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_MIN, OP_MAX = 0, 1, 2, 3, 4, 5
OP_NEG, OP_EXP, OP_ABS = 6, 7, 8
#: adds operand ``a`` to the outflow of written channel ``dst``
OP_ACC = 9
OP_NAMES = ("add", "sub", "mul", "div", "min", "max", "neg", "exp", "abs",
            "acc")
_BINARY = {"add": OP_ADD, "sub": OP_SUB, "mul": OP_MUL, "div": OP_DIV,
           "min": OP_MIN, "max": OP_MAX}
_UNARY = {"neg": OP_NEG, "exp": OP_EXP, "abs": OP_ABS}
K_SLOT, K_CHAN, K_CONST, K_ROW, K_COL = 0, 1, 2, 3, 4
_UNUSED = (K_CONST, 0, 0.0)  # the ``b`` of unary operations and accs

#: K4's program limits (csrc/field_stencil.cu holds the same numbers)
MAX_FLOWS = 8
MAX_CHANNELS = 8
MAX_CODE = 64
MAX_SLOTS = 8


class LoweringError(ValueError):
    """A flow's outflow uses something the field kernel cannot evaluate."""


# -- the recorded tree ---------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Node:
    """``op`` is "const" (``value``), "chan" (``name``), "row"/"col"
    (``value`` = integer offset), "pow" (``args[0]`` to the ``value``-th
    power), or a whitelisted unary/binary op over ``args``."""

    op: str
    args: tuple = ()
    value: float = 0.0
    name: str = ""


class _Trace:
    """State of one flow's symbolic call: the traced dtype and the label
    errors name."""

    def __init__(self, dtype: torch.dtype, label: str):
        self.dtype = dtype
        self.label = label

    def refuse(self, what: str) -> LoweringError:
        return LoweringError(
            f"flow {self.label} cannot be lowered to the field kernel: "
            f"{what} (the lowering takes add, sub, mul, div, min, max, neg, "
            "exp, abs, integer powers 1-3, constants, channel reads and "
            "cell_coords)")


def _torch_op_name(func) -> str:
    return getattr(func, "__name__", repr(func))


class Sym:
    """A symbolic cell value. Float values carry a tree of whitelisted
    operations; integer values (``cell_coords``' rows and columns) carry a
    coordinate leaf and an integer offset, and must be cast to a float
    dtype with ``.to(...)`` before any other arithmetic."""

    __array_ufunc__ = None  # numpy scalars defer to the reflected operator
    __hash__ = object.__hash__

    def __init__(self, trace: _Trace, node: _Node, is_int: bool = False):
        self._trace = trace
        self._node = node
        self._is_int = is_int

    # -- what a flow may read ---------------------------------------------
    @property
    def dtype(self) -> torch.dtype:
        return torch.int64 if self._is_int else self._trace.dtype

    @property
    def device(self) -> torch.device:
        return torch.device("cpu")

    @property
    def shape(self):
        raise self._trace.refuse("it reads the shape of a cell value")

    def symbolic_cell_coords(self) -> tuple["Sym", "Sym"]:
        """``ops.flow.cell_coords`` on a symbolic value: the cell's global
        row and column."""
        return (Sym(self._trace, _Node("row", value=0), True),
                Sym(self._trace, _Node("col", value=0), True))

    # -- operands ---------------------------------------------------------
    def _operand(self, x, op: str) -> _Node:
        if isinstance(x, Sym):
            if x._is_int:
                raise self._trace.refuse(
                    f"{op} on an integer cell coordinate (cast it with "
                    ".to(v.dtype) first)")
            return x._node
        if isinstance(x, bool):
            raise self._trace.refuse(f"{op} with a bool operand")
        if isinstance(x, numbers.Real):
            return _Node("const", value=float(x))
        if isinstance(x, torch.Tensor):
            if x.dim() != 0:
                raise self._trace.refuse(
                    f"{op} with a non-scalar tensor of shape "
                    f"{tuple(x.shape)} (data from outside the cell)")
            if x.dtype == torch.bool or x.is_complex():
                raise self._trace.refuse(f"{op} with a {x.dtype} tensor")
            return _Node("const", value=float(x.item()))
        raise self._trace.refuse(f"{op} with a {type(x).__name__} operand")

    def _bin(self, op: str, a, b) -> "Sym":
        tr = self._trace
        return Sym(tr, _Node(op, (self._operand(a, op), self._operand(b, op))))

    def _un(self, op: str) -> "Sym":
        return Sym(self._trace, _Node(op, (self._operand(self, op),)))

    def _int_shift(self, k, sign: int) -> "Sym":
        if isinstance(k, bool) or not isinstance(k, numbers.Integral):
            raise self._trace.refuse(
                "arithmetic on an integer cell coordinate other than adding "
                "an int (cast it with .to(v.dtype) first)")
        n = self._node
        return Sym(self._trace, _Node(n.op, value=n.value + sign * int(k)),
                   True)

    # -- the Python operators ---------------------------------------------
    def __add__(self, o):
        if self._is_int:
            return self._int_shift(o, 1)
        return self._bin("add", self, o)

    def __radd__(self, o):
        if self._is_int:
            return self._int_shift(o, 1)
        return self._bin("add", o, self)

    def __sub__(self, o):
        if self._is_int:
            return self._int_shift(o, -1)
        return self._bin("sub", self, o)

    def __rsub__(self, o):
        return self._bin("sub", o, self)

    def __mul__(self, o):
        return self._bin("mul", self, o)

    def __rmul__(self, o):
        return self._bin("mul", o, self)

    def __truediv__(self, o):
        return self._bin("div", self, o)

    def __rtruediv__(self, o):
        # torch computes number / tensor as reciprocal(tensor) * number
        return self._bin("mul", self._bin("div", 1.0, self), o)

    def __neg__(self):
        return self._un("neg")

    def __pos__(self):
        return self

    def __abs__(self):
        return self._un("abs")

    def __pow__(self, n):
        if isinstance(n, float) and n.is_integer():
            n = int(n)
        if (isinstance(n, bool) or not isinstance(n, numbers.Integral)
                or not 1 <= n <= 3):
            raise self._trace.refuse(
                f"pow with exponent {n!r} (integer powers 1-3 only; write a "
                "larger power as a product)")
        return Sym(self._trace,
                   _Node("pow", (self._operand(self, "pow"),), value=int(n)))

    def __rpow__(self, o):
        raise self._trace.refuse("pow with a cell value as the exponent")

    # -- tensor methods -----------------------------------------------------
    def exp(self):
        return self._un("exp")

    def abs(self):
        return self._un("abs")

    def neg(self):
        return self._un("neg")

    def minimum(self, o):
        return self._bin("min", self, o)

    def maximum(self, o):
        return self._bin("max", self, o)

    def clamp(self, min=None, max=None):  # noqa: A002 (torch's names)
        out = self
        if min is not None:
            out = out._bin("max", out, min)
        if max is not None:
            out = out._bin("min", out, max)
        return out

    def clamp_min(self, m):
        return self._bin("max", self, m)

    def clamp_max(self, m):
        return self._bin("min", self, m)

    def to(self, *args, **kwargs):
        dtype = kwargs.get("dtype")
        for a in args:
            if isinstance(a, torch.dtype):
                dtype = a
            elif isinstance(a, (Sym, torch.Tensor)):
                dtype = a.dtype
        return self._cast(dtype)

    def _cast(self, dtype: Optional[torch.dtype]) -> "Sym":
        if dtype is None:
            return self
        if self._is_int:
            if dtype not in (torch.float32, torch.float64):
                raise self._trace.refuse(
                    f"a cast of a cell coordinate to {dtype} (f32 or f64)")
            return Sym(self._trace, self._node)
        if dtype != self._trace.dtype:
            raise self._trace.refuse(
                f"a cast from the traced {self._trace.dtype} to {dtype}")
        return self

    # -- refused ------------------------------------------------------------
    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        raise self._trace.refuse(f"the tensor method or attribute {name!r}")

    def __bool__(self):
        raise self._trace.refuse("a host read (bool of a cell value: "
                                 "data-dependent control flow)")

    def __float__(self):
        raise self._trace.refuse("a host read (float of a cell value)")

    def __int__(self):
        raise self._trace.refuse("a host read (int of a cell value)")

    def __index__(self):
        raise self._trace.refuse("a host read (a cell value as an index)")

    def __len__(self):
        raise self._trace.refuse("len() of a cell value")

    def __iter__(self):
        raise self._trace.refuse("iteration over a cell value")

    def __getitem__(self, key):
        raise self._trace.refuse("indexing")

    def __setitem__(self, key, value):
        raise self._trace.refuse("indexed assignment")

    def _compare(self, op):
        raise self._trace.refuse(f"the comparison {op!r}")

    def __lt__(self, o):
        self._compare("lt")

    def __le__(self, o):
        self._compare("le")

    def __gt__(self, o):
        self._compare("gt")

    def __ge__(self, o):
        self._compare("ge")

    def __eq__(self, o):
        self._compare("eq")

    def __ne__(self, o):
        self._compare("ne")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        name = _torch_op_name(func)
        sym = _find_sym((args, kwargs))
        tr = sym._trace
        if name.endswith("_"):
            raise tr.refuse(f"the in-place torch function {name!r}")
        if name in ("add", "sub", "subtract", "rsub") and \
                kwargs.pop("alpha", 1) != 1:
            raise tr.refuse(f"torch.{name} with alpha != 1")
        if name in ("div", "divide") and \
                kwargs.pop("rounding_mode", None) is not None:
            raise tr.refuse("division with a rounding_mode")
        if kwargs and name not in _CLAMPS:
            raise tr.refuse(f"torch.{name} with arguments {sorted(kwargs)}")
        if name in _TORCH_BINARY and len(args) == 2:
            op, swap = _TORCH_BINARY[name]
            a, b = (args[1], args[0]) if swap else args
            return sym._bin(op, a, b)
        if name in _TORCH_UNARY and len(args) == 1:
            return sym._un(_TORCH_UNARY[name])
        if name == "pow" and len(args) == 2 and args[0] is sym:
            return sym.__pow__(args[1])
        if name in _CLAMPS and args and args[0] is sym and len(args) <= 3:
            bounds = dict(zip(_CLAMPS[name], args[1:]))
            for k in _CLAMPS[name]:
                if k in kwargs:
                    bounds[k] = kwargs.pop(k)
            if kwargs:
                raise tr.refuse(f"torch.{name} with {sorted(kwargs)}")
            return sym.clamp(bounds.get("min"), bounds.get("max"))
        raise tr.refuse(f"the torch function {name!r}")


#: torch function name -> (whitelisted op, operands swapped); the names
#: torch passes for ``tensor <op> sym`` and for ``torch.<fn>(...)``
_TORCH_BINARY = {
    "add": ("add", False),
    "sub": ("sub", False), "subtract": ("sub", False), "rsub": ("sub", True),
    "mul": ("mul", False), "multiply": ("mul", False),
    "div": ("div", False), "divide": ("div", False),
    "true_divide": ("div", False),
    "minimum": ("min", False), "min": ("min", False),
    "maximum": ("max", False), "max": ("max", False),
}
_TORCH_UNARY = {"neg": "neg", "negative": "neg", "exp": "exp", "abs": "abs",
                "absolute": "abs"}
#: clamp-like torch functions -> their positional bound names
_CLAMPS = {"clamp": ("min", "max"), "clip": ("min", "max"),
           "clamp_min": ("min",), "clamp_max": ("max",)}


def _find_sym(obj) -> Optional[Sym]:
    """The first ``Sym`` among (nested) torch-function arguments."""
    if isinstance(obj, Sym):
        return obj
    items = obj.values() if isinstance(obj, dict) else (
        obj if isinstance(obj, (list, tuple)) else ())
    for x in items:
        found = _find_sym(x)
        if found is not None:
            return found
    return None


# -- programs ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FieldProgram:
    """Every flow's outflow as register-form code over the loaded channels.

    - ``channels``: the channels K4 loads (read by some flow or written),
      in the order given to ``lower_flows``; a ``K_CHAN`` operand indexes
      this tuple.
    - ``outputs``: the channels flows write, in ``channels`` order.
    - ``code``: ``(op, dst, first, a, b)`` per instruction, the flows in
      order, each ending in an ``acc``. Operands are ``(kind, arg, value)``:
      a slot or channel index, a constant, or a row/column offset. An
      operation writes slot ``dst``; an ``acc`` adds ``a`` to the outflow
      of ``outputs[dst]``, starting the sum when ``first`` is 1.
    - ``n_slots``: the slots the code uses.
    """

    channels: tuple[str, ...]
    outputs: tuple[str, ...]
    code: tuple
    n_slots: int
    labels: tuple[str, ...]
    dtype: torch.dtype

    @property
    def n_flows(self) -> int:
        return len(self.labels)

    def flops(self) -> int:
        """Arithmetic operations per cell: the flows' operations and the
        adds that sum flows of one channel."""
        return sum(op != OP_ACC or not first for op, _, first, _, _ in
                   self.code)

    def describe(self) -> list[str]:
        """One line per flow: target and instructions, for reports."""
        def show(x):
            kind, arg, val = x
            return (f"s{arg}" if kind == K_SLOT else self.channels[arg]
                    if kind == K_CHAN else repr(val) if kind == K_CONST
                    else ("row" if kind == K_ROW else "col")
                    + (f"{arg:+d}" if arg else ""))

        lines, ins = [], []
        for op, dst, first, a, b in self.code:
            if op == OP_ACC:
                lines.append(f"{self.labels[len(lines)]} -> "
                             f"{self.outputs[dst]}: {'; '.join(ins)}"
                             f"{'; ' if ins else ''}"
                             f"{'=' if first else '+='} {show(a)}")
                ins = []
            else:
                args = show(a) if op in _UNARY.values() else \
                    f"{show(a)}, {show(b)}"
                ins.append(f"s{dst} = {OP_NAMES[op]}({args})")
        return lines


def _flow_label(flow, i: int) -> str:
    return f"#{i} {type(flow).__name__}(attr={getattr(flow, 'attr', '?')!r})"


class _Compiler:
    """Register allocation for the trees of one program: each operation's
    result goes to the lowest free slot, and an operand's slot is freed
    once the operation that reads it is emitted (a result may overwrite
    an operand: each cell reads its operands before writing)."""

    def __init__(self, chan_index: dict[str, int]):
        self.chan_index = chan_index
        self.code: list = []
        self.free: set = set()
        self.n_slots = 0

    def emit(self, op: int, a, b=_UNUSED, keep=None) -> tuple:
        for x in (a, b):
            if x[0] == K_SLOT and x != keep:
                self.free.add(x[1])
        if self.free:
            dst = min(self.free)
            self.free.remove(dst)
        else:
            dst = self.n_slots
            self.n_slots += 1
        self.code.append((op, dst, 0, a, b))
        return (K_SLOT, dst, 0.0)

    def operand(self, node: _Node) -> tuple:
        op = node.op
        if op == "const":
            return (K_CONST, 0, node.value)
        if op == "chan":
            return (K_CHAN, self.chan_index[node.name], 0.0)
        if op in ("row", "col"):
            return (K_ROW if op == "row" else K_COL, int(node.value), 0.0)
        if op == "pow":
            # x**n as (x*x)*x..., torch's order; x stays live to the last
            x = self.operand(node.args[0])
            y = x
            for i in range(int(node.value) - 1):
                y = self.emit(OP_MUL, y, x,
                              keep=x if i < int(node.value) - 2 else None)
            return y
        if op in _UNARY:
            return self.emit(_UNARY[op], self.operand(node.args[0]))
        a = self.operand(node.args[0])
        return self.emit(_BINARY[op], a, self.operand(node.args[1]))

    def acc(self, node: _Node, target: int, first: bool) -> None:
        a = self.operand(node)
        if a[0] == K_SLOT:
            self.free.add(a[1])
        self.code.append((OP_ACC, target, int(first), a, _UNUSED))


def _reads(node: _Node, out: set) -> None:
    if node.op == "chan":
        out.add(node.name)
    for a in node.args:
        _reads(a, out)


def lower_flows(flows: Sequence, names: Sequence[str],
                dtype: torch.dtype = torch.float32,
                origin: tuple[int, int] = (0, 0)) -> FieldProgram:
    """Lower every flow's ``outflow`` to register-form code. ``names`` are
    the space's channels (a flow may read any of them); ``dtype`` is what
    the symbolic values report (K4 computes in f32; the tests also lower at
    f64). Raises ``ValueError`` naming the flow and the operation when a
    flow uses anything outside the whitelist."""
    names = tuple(names)
    trees, labels = [], []
    for i, f in enumerate(flows):
        label = _flow_label(f, i)
        if getattr(f, "footprint", "unknown") != "pointwise":
            raise LoweringError(
                f"flow {label} cannot be lowered to the field kernel: it "
                f"declares footprint={getattr(f, 'footprint', 'unknown')!r} "
                "(pointwise flows only)")
        if f.attr not in names:
            raise LoweringError(f"flow {label} targets channel {f.attr!r}, "
                                f"which is not among {names}")
        tr = _Trace(dtype, label)
        sym = {n: Sym(tr, _Node("chan", name=n)) for n in names}
        try:
            out = f.outflow(sym, origin)
        except LoweringError:
            raise
        except Exception as e:  # any failure of user code under tracing
            raise LoweringError(
                f"flow {label} cannot be lowered to the field kernel: its "
                f"outflow raised {type(e).__name__}: {e}") from e
        if isinstance(out, Sym):
            if out._is_int:
                raise tr.refuse("it returns an integer cell coordinate")
            node = out._node
        elif isinstance(out, (numbers.Real, torch.Tensor)) and not \
                isinstance(out, bool):
            node = Sym(tr, _Node("const"))._operand(out, "return")
        else:
            raise tr.refuse(f"it returns a {type(out).__name__}")
        trees.append(node)
        labels.append(label)
    read: set = set()
    for node in trees:
        _reads(node, read)
    written = {f.attr for f in flows}
    channels = tuple(n for n in names if n in read or n in written)
    outputs = tuple(n for n in channels if n in written)
    comp = _Compiler({n: i for i, n in enumerate(channels)})
    started: set = set()
    for f, node in zip(flows, trees):
        comp.acc(node, outputs.index(f.attr), f.attr not in started)
        started.add(f.attr)
    return FieldProgram(channels=channels, outputs=outputs,
                        code=tuple(comp.code), n_slots=comp.n_slots,
                        labels=tuple(labels), dtype=dtype)


def check_program(prog: FieldProgram) -> None:
    """Raise ``ValueError`` when a program exceeds K4's limits."""
    limits = ((prog.n_flows, MAX_FLOWS, "flows"),
              (len(prog.channels), MAX_CHANNELS, "channels"),
              (len(prog.code), MAX_CODE, "instructions"),
              (prog.n_slots, MAX_SLOTS, "intermediate slots"))
    for got, cap, what in limits:
        if got > cap:
            raise ValueError(
                f"the field kernel takes at most {cap} {what} per call; "
                f"these flows need {got}")
    if not prog.n_flows:
        raise ValueError("the field kernel needs at least one flow")


def eval_program(prog: FieldProgram, tensors: Mapping[str, torch.Tensor],
                 rows: torch.Tensor, cols: torch.Tensor
                 ) -> dict[str, torch.Tensor]:
    """Run a program in plain torch, as K4 does (without the off-grid
    mask): the summed outflow per written channel, flows added in order
    (``build_outflow``'s sums). ``tensors`` maps the program's channels to
    tensors of one dtype; ``rows``/``cols`` are the cells' global indices
    (integer tensors)."""
    dt = tensors[prog.channels[0]].dtype
    dev = tensors[prog.channels[0]].device
    slots: dict = {}
    out: dict[str, torch.Tensor] = {}

    def fetch(x):
        kind, arg, val = x
        if kind == K_SLOT:
            return slots[arg]
        if kind == K_CHAN:
            return tensors[prog.channels[arg]]
        if kind == K_CONST:
            return torch.tensor(val, dtype=dt, device=dev)
        return ((rows if kind == K_ROW else cols) + arg).to(dt)

    unary = {OP_NEG: torch.neg, OP_EXP: torch.exp, OP_ABS: torch.abs}
    binary = {OP_ADD: torch.add, OP_SUB: torch.sub, OP_MUL: torch.mul,
              OP_DIV: torch.div, OP_MIN: torch.minimum,
              OP_MAX: torch.maximum}
    for op, dst, first, a, b in prog.code:
        if op == OP_ACC:
            x, name = fetch(a), prog.outputs[dst]
            out[name] = x if first else out[name] + x
        elif op in unary:
            slots[dst] = unary[op](fetch(a))
        else:
            slots[dst] = binary[op](fetch(a), fetch(b))
    return out
