"""The Flow IR's pointwise expression grammar (counterpart of
``mpi_model_tpu/ir/expr.py``; the grammar is copied, not imported).

A term's *amount* (what a reaction transfers, a source injects, a sink
drains) is a small expression tree over a whitelist of primitives: channel
reads, constants and the arithmetic below. Every expression is pointwise by
construction (a cell's value depends only on that cell's own channels), so
one lowering (``ir.lower``) serves the dense, composed, active and sharded
engines from the same tree.

Grammar::

    expr := Const(float) | Chan(name)
          | expr + expr | expr - expr | expr * expr | expr / expr
          | -expr | expr ** k (integer k >= 1)
          | exp(expr) | abs_(expr) | minimum(a, b) | maximum(a, b)

``evaluate`` runs a tree on torch tensors: a constant is a 0-d tensor in
the space dtype (never a Python number, which torch would keep at another
precision for bf16 and turn into a reciprocal multiply when it divides on
the card), ``Power`` is repeated multiplication in the JAX package's order,
and every operation is one torch op in tree order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

#: the whitelisted primitive set: op name -> arity. ``evaluate`` refuses
#: anything else, by node type and by name
PRIMITIVES = {
    "add": 2, "sub": 2, "mul": 2, "div": 2,
    "min": 2, "max": 2,
    "neg": 1, "exp": 1, "abs": 1,
}


class Expr:
    """Base node; the operators build trees out of the whitelist."""

    def __add__(self, o): return Binary("add", self, as_expr(o))
    def __radd__(self, o): return Binary("add", as_expr(o), self)
    def __sub__(self, o): return Binary("sub", self, as_expr(o))
    def __rsub__(self, o): return Binary("sub", as_expr(o), self)
    def __mul__(self, o): return Binary("mul", self, as_expr(o))
    def __rmul__(self, o): return Binary("mul", as_expr(o), self)
    def __truediv__(self, o): return Binary("div", self, as_expr(o))
    def __rtruediv__(self, o): return Binary("div", as_expr(o), self)
    def __neg__(self): return Unary("neg", self)

    def __pow__(self, k):
        if not isinstance(k, int) or k < 1:
            raise TypeError(
                f"Expr ** k needs an integer exponent >= 1, got {k!r} "
                "(the whitelist has no general pow — square/cube by "
                "repeated multiplication)")
        return Power(self, k)


@dataclasses.dataclass(frozen=True)
class Const(Expr):
    """A structural numeric constant (part of the step; a per-scenario
    number belongs in the owning term's ``rate``)."""

    value: float

    def __post_init__(self):
        object.__setattr__(self, "value", float(self.value))


@dataclasses.dataclass(frozen=True)
class Chan(Expr):
    """Read of one attribute channel at the cell itself."""

    name: str


@dataclasses.dataclass(frozen=True)
class Unary(Expr):
    op: str
    a: Expr


@dataclasses.dataclass(frozen=True)
class Binary(Expr):
    op: str
    a: Expr
    b: Expr


@dataclasses.dataclass(frozen=True)
class Power(Expr):
    """Integer power, lowered as repeated multiplication."""

    a: Expr
    n: int


def as_expr(x: Union[Expr, float, int]) -> Expr:
    if isinstance(x, Expr):
        return x
    if isinstance(x, (int, float)):
        return Const(float(x))
    raise TypeError(f"cannot use {type(x).__name__} in an IR expression "
                    "(whitelist: Expr nodes and numbers)")


def exp(a) -> Expr:
    return Unary("exp", as_expr(a))


def abs_(a) -> Expr:
    return Unary("abs", as_expr(a))


def minimum(a, b) -> Expr:
    return Binary("min", as_expr(a), as_expr(b))


def maximum(a, b) -> Expr:
    return Binary("max", as_expr(a), as_expr(b))


_UNARY_FNS = {"neg": torch.neg, "exp": torch.exp, "abs": torch.abs}
_BINARY_FNS = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "min": torch.minimum,
    "max": torch.maximum,
}


def evaluate(e: Expr, env: dict[str, torch.Tensor], dtype,
             consts: Optional[dict] = None, device=None) -> torch.Tensor:
    """Evaluate ``e`` against the channel tensors ``env``. Constants are 0-d
    tensors in ``dtype`` on ``device`` (default: the first channel's),
    kept in ``consts`` (value -> tensor) when it is given, so a step made
    once makes each constant once. Every engine's context calls this
    function."""
    if isinstance(e, Const):
        t = consts.get(e.value) if consts is not None else None
        if t is None:
            if device is None:
                device = next(iter(env.values())).device
            t = torch.tensor(e.value, dtype=dtype, device=device)
            if consts is not None:
                consts[e.value] = t
        return t
    if isinstance(e, Chan):
        v = env.get(e.name)
        if v is None:
            raise KeyError(
                f"expression reads channel {e.name!r} which the space "
                f"does not carry (has {tuple(env)})")
        return v
    if isinstance(e, Power):
        base = evaluate(e.a, env, dtype, consts, device)
        acc = base
        for _ in range(e.n - 1):
            acc = acc * base
        return acc
    if isinstance(e, Unary):
        fn = _UNARY_FNS.get(e.op)
        if fn is None or e.op not in PRIMITIVES:
            raise ValueError(f"unknown/unwhitelisted unary op {e.op!r}")
        return fn(evaluate(e.a, env, dtype, consts, device))
    if isinstance(e, Binary):
        fn = _BINARY_FNS.get(e.op)
        if fn is None or e.op not in PRIMITIVES:
            raise ValueError(f"unknown/unwhitelisted binary op {e.op!r}")
        return fn(evaluate(e.a, env, dtype, consts, device),
                  evaluate(e.b, env, dtype, consts, device))
    raise TypeError(f"not an IR expression node: {type(e).__name__}")


def channels(e: Expr) -> frozenset[str]:
    """The set of channels the expression reads."""
    if isinstance(e, Chan):
        return frozenset((e.name,))
    if isinstance(e, Const):
        return frozenset()
    if isinstance(e, (Unary, Power)):
        return channels(e.a)
    if isinstance(e, Binary):
        return channels(e.a) | channels(e.b)
    raise TypeError(f"not an IR expression node: {type(e).__name__}")


def fingerprint(e: Expr) -> tuple:
    """Hashable structural identity, constants included (they are part of
    the step; only a term's ``rate`` is a per-scenario parameter)."""
    if isinstance(e, Const):
        return ("const", e.value)
    if isinstance(e, Chan):
        return ("chan", e.name)
    if isinstance(e, Power):
        return ("pow", fingerprint(e.a), e.n)
    if isinstance(e, Unary):
        return (e.op, fingerprint(e.a))
    if isinstance(e, Binary):
        return (e.op, fingerprint(e.a), fingerprint(e.b))
    raise TypeError(f"not an IR expression node: {type(e).__name__}")


def from_fingerprint(fp: tuple) -> Expr:
    """The expression a ``fingerprint`` tree describes (its inverse): how
    an expression crosses from the JAX package as plain tuples."""
    op = fp[0]
    if op == "const":
        return Const(fp[1])
    if op == "chan":
        return Chan(fp[1])
    if op == "pow":
        return Power(from_fingerprint(fp[1]), int(fp[2]))
    if PRIMITIVES.get(op) == 1:
        return Unary(op, from_fingerprint(fp[1]))
    if PRIMITIVES.get(op) == 2:
        return Binary(op, from_fingerprint(fp[1]), from_fingerprint(fp[2]))
    raise ValueError(f"unknown/unwhitelisted op {op!r} in a fingerprint")


def zero_point(e: Expr) -> Optional[tuple[str, float]]:
    """A ``(channel, ref)`` pair such that the expression is provably zero
    wherever ``channel == ref``: the root the active engine derives a
    term's activity predicate from. ``None`` means no such proof (the term
    keeps every tile active).

    Rules: ``Chan(c)`` is zero at ``c == 0``; a product is zero where
    either factor is; powers and negation keep roots; ``k - Chan(c)`` is
    zero at ``c == k``."""
    if isinstance(e, Chan):
        return (e.name, 0.0)
    if isinstance(e, Power):
        return zero_point(e.a)
    if isinstance(e, Unary) and e.op == "neg":
        return zero_point(e.a)
    if isinstance(e, Binary) and e.op == "mul":
        return zero_point(e.a) or zero_point(e.b)
    if isinstance(e, Binary) and e.op == "sub":
        if isinstance(e.a, Const) and isinstance(e.b, Chan):
            return (e.b.name, e.a.value)
        if isinstance(e.a, Chan) and isinstance(e.b, Const):
            return (e.a.name, e.b.value)
    return None
