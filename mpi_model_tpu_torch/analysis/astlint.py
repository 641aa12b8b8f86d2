"""AST lint layer (layer 1): structural rules over the port's Python
sources.

The engine parses each module once into a ``ModuleCtx`` (tree + parent
links + pragma map) and runs every registered rule whose scope matches.
Rules are pure AST walks — no imports of the analyzed code, so linting
never executes repo code and runs in milliseconds.

What a "step scope" is here
---------------------------
Three rules (``host-sync``, ``dtype-drift`` and ``traced-branch``) only
fire *inside step scopes* — the functions
that run once a step on the device's stream. The port has no trace, so
statically a function is a step scope when it

- is a nested ``def`` inside a *step builder* — a function named
  ``make_*``/``build_*``/``_build*`` (the package's convention for
  functions that RETURN the step: ``Model.make_step``'s closures, the
  executors' ``_build_*`` runner bodies, ``build_fused_runner``'s
  pass), or
- is decorated with, or handed by name (or as an inline ``lambda``) to,
  ``torch.func.vmap``/``functional_call``, whose bodies see batched
  tensors that cannot be read on the host.

The builder body itself runs once at build time — probing a kernel or
reading a shape there is exactly right. In torch, a host read inside a
step scope (``.item()``, ``.tolist()``, ``bool(t)``, ``if t:``) is a
device→host copy that waits for the stream: a sync a step. This is a
heuristic with an escape hatch (the pragma), not a proof; the step audit
(layer 2, ``step_audit``) is the ground-truth check of what a step does
on the device.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Iterable, Optional

from .registry import (RULES, SCOPE_ALL, SCOPE_PACKAGE, SCOPE_TESTS,
                       Finding, Severity, apply_pragmas, collect_pragmas,
                       rule)

# -- module context -----------------------------------------------------------


@dataclasses.dataclass
class ModuleCtx:
    """One parsed module, shared by every rule."""

    path: str
    tree: ast.Module
    lines: list[str]
    pragmas: dict
    is_test: bool
    #: resolved absolute path components, for package-scope matching
    #: (a bare relative path like ``ops/stencil.py`` passed from inside
    #: the package directory must still count as package code)
    resolved_parts: tuple
    #: node → enclosing node, for upward walks
    parents: dict[ast.AST, ast.AST]
    #: FunctionDef/AsyncFunctionDef/Lambda nodes considered traced
    traced_scopes: set[ast.AST]

    def enclosing_functions(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                yield cur
            cur = self.parents.get(cur)

    def in_traced_scope(self, node: ast.AST) -> bool:
        return any(fn in self.traced_scopes
                   for fn in self.enclosing_functions(node))


#: decorators / call targets whose function argument runs over batched
#: tensors (``torch.func``): its body is a step scope
TRACE_ENTRY_NAMES = {"vmap", "functional_call"}
#: call targets whose function arguments are step scopes
TRACE_COMBINATORS = TRACE_ENTRY_NAMES
#: step-builder naming convention: nested defs inside these are step
#: scopes
BUILDER_PREFIXES = ("make_", "build_", "_build")


def _dotted_last(node: ast.AST) -> Optional[str]:
    """Last identifier of a Name/Attribute chain (``torch.func.vmap`` →
    ``vmap``), else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _decorated_as_trace(fn: ast.AST) -> bool:
    for dec in getattr(fn, "decorator_list", []):
        for n in ast.walk(dec):
            if _dotted_last(n) in TRACE_ENTRY_NAMES:
                return True
    return False


def _find_traced_scopes(tree: ast.Module,
                        parents: dict) -> set[ast.AST]:
    funcs = [n for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Lambda))]
    by_name: dict[str, list[ast.AST]] = {}
    for f in funcs:
        if not isinstance(f, ast.Lambda):
            by_name.setdefault(f.name, []).append(f)

    traced: set[ast.AST] = set()
    for f in funcs:
        if _decorated_as_trace(f):
            traced.add(f)
            continue
        # nested def inside a step builder (but not the builder itself)
        cur = parents.get(f)
        while cur is not None:
            if (isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and cur.name.startswith(BUILDER_PREFIXES)):
                traced.add(f)
                break
            cur = parents.get(cur)

    # functions handed to a trace-entry call by name or inline lambda
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if _dotted_last(node.func) not in TRACE_COMBINATORS:
            continue
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(arg, ast.Lambda):
                traced.add(arg)
            elif isinstance(arg, ast.Name):
                traced.update(by_name.get(arg.id, []))
    return traced


def parse_module(source: str, path: str = "<string>") -> ModuleCtx:
    tree = ast.parse(source, filename=path)
    parents: dict[ast.AST, ast.AST] = {}
    for parent in ast.walk(tree):
        for child in ast.iter_child_nodes(parent):
            parents[child] = parent
    name = Path(path).name
    try:
        resolved = Path(path).resolve().parts
    except OSError:
        resolved = Path(path).parts
    return ModuleCtx(
        path=path,
        tree=tree,
        lines=source.splitlines(),
        pragmas=collect_pragmas(source.splitlines()),
        is_test=name.startswith("test_") and name.endswith(".py"),
        resolved_parts=resolved,
        parents=parents,
        traced_scopes=_find_traced_scopes(tree, parents),
    )


# -- rules --------------------------------------------------------------------

@rule("broad-except", Severity.ERROR,
      "`except Exception`/bare `except` hides tracer leaks and dtype "
      "bugs; only pragma'd supervisor boundaries may catch broadly "
      "(cleanup handlers ending in a bare `raise` are exempt)",
      fix_hint="narrow to the exceptions the handler can actually "
      "recover from, or pragma the supervisor boundary with its "
      "reason")
def check_broad_except(ctx: ModuleCtx):
    def is_broad(t) -> bool:
        if t is None:
            return True  # bare except:
        if isinstance(t, ast.Tuple):
            return any(is_broad(e) for e in t.elts)
        return _dotted_last(t) in ("Exception", "BaseException")

    def reraises(handler: ast.ExceptHandler) -> bool:
        # `except BaseException: <cleanup>; raise` supervises nothing —
        # it is the atomic-write/unwind idiom, and exempt
        last = handler.body[-1]
        return isinstance(last, ast.Raise) and last.exc is None

    for node in ast.walk(ctx.tree):
        if (isinstance(node, ast.ExceptHandler) and is_broad(node.type)
                and not reraises(node)):
            yield Finding(
                "broad-except", Severity.ERROR, ctx.path, node.lineno,
                "broad `except` — narrow to the exceptions this boundary "
                "actually supervises, or pragma a genuine supervisor "
                "boundary with its reason")


@rule("mutable-default", Severity.ERROR,
      "mutable default arguments ([] / {} / set()) alias across calls",
      fix_hint="default to None and create the container inside the "
      "function body")
def check_mutable_default(ctx: ModuleCtx):
    def is_mutable(d) -> bool:
        if isinstance(d, (ast.List, ast.Dict, ast.Set)):
            return True
        return (isinstance(d, ast.Call)
                and isinstance(d.func, ast.Name)
                and d.func.id in ("list", "dict", "set") and not d.args)

    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            continue
        a = node.args
        for d in list(a.defaults) + [d for d in a.kw_defaults if d]:
            if is_mutable(d):
                yield Finding(
                    "mutable-default", Severity.ERROR, ctx.path, d.lineno,
                    "mutable default argument — use None and construct "
                    "inside the function")


#: host-read call shapes: a method called as these inside a step copies
#: device memory to the host and waits for the stream
HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
#: module aliases whose ``.asarray`` materializes on host
NUMPY_ALIASES = {"np", "numpy", "onp"}


@rule("host-sync", Severity.ERROR,
      "host reads (`.item()`, `.tolist()`, `.cpu()`, `.numpy()`, "
      "`torch.cuda.synchronize()`, `np.asarray`) inside a step scope "
      "wait for the device's stream once a step and stall the pipeline",
      fix_hint="keep the value on the device and read it at the caller "
      "once a run, or pragma the step's declared host read (its "
      "step_audit contract counts it)")
def check_host_sync(ctx: ModuleCtx):
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        if not ctx.in_traced_scope(node):
            continue
        fn = node.func
        callee = _dotted_last(fn)
        msg = None
        if (callee in HOST_SYNC_METHODS and isinstance(fn, ast.Attribute)
                and not node.args):
            msg = f"`.{callee}()` inside a step scope"
        elif callee == "synchronize" and isinstance(fn, ast.Attribute):
            msg = f"`{_dotted_last(fn.value)}.synchronize()` inside a " \
                  "step scope"
        elif (callee == "asarray" and isinstance(fn, ast.Attribute)
              and isinstance(fn.value, ast.Name)
              and fn.value.id in NUMPY_ALIASES):
            msg = ("`np.asarray` inside a step scope copies the operand "
                   "to the host")
        if msg:
            yield Finding(
                "host-sync", Severity.ERROR, ctx.path, node.lineno,
                msg + " — a device→host read that waits for the stream "
                "every step")


#: torch constructors where an un-dtyped float literal takes torch's
#: default float dtype (f32), not the space dtype
DTYPE_DRIFT_CTORS = {"tensor", "as_tensor", "full", "arange", "linspace"}


def _has_float_literal(node: ast.AST) -> Optional[ast.Constant]:
    """First float literal in an arg expression, not descending into
    nested calls (their args are that call's concern)."""
    if isinstance(node, ast.Constant):
        return node if isinstance(node.value, float) else None
    if isinstance(node, (ast.Tuple, ast.List)):
        for e in node.elts:
            hit = _has_float_literal(e)
            if hit:
                return hit
        return None
    if isinstance(node, (ast.UnaryOp, ast.BinOp)):
        for child in ast.iter_child_nodes(node):
            hit = _has_float_literal(child)
            if hit:
                return hit
    return None


@rule("dtype-drift", Severity.WARNING,
      "a bare float literal in a torch constructor inside a step scope "
      "takes torch's default float dtype, not the space dtype — pin "
      "`dtype=`",
      scope=SCOPE_PACKAGE,
      fix_hint="pass dtype= explicitly (the space dtype, or the operand's "
      "`.dtype`)")
def check_dtype_drift(ctx: ModuleCtx):
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        if not (isinstance(node.func, ast.Attribute)
                and node.func.attr in DTYPE_DRIFT_CTORS
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "torch"):
            continue
        if not ctx.in_traced_scope(node):
            continue
        if any(kw.arg == "dtype" for kw in node.keywords):
            continue
        lit = None
        for a in list(node.args) + [kw.value for kw in node.keywords
                                    if kw.arg != "dtype"]:
            lit = _has_float_literal(a)
            if lit:
                break
        if lit is not None:
            yield Finding(
                "dtype-drift", Severity.WARNING, ctx.path, node.lineno,
                f"`torch.{node.func.attr}` with float literal {lit.value!r} "
                "and no dtype= — it is made in torch's default float dtype "
                "and promotes or truncates the step's values (pin the "
                "space/operand dtype)")


#: test-expression shapes that are STATIC even when they touch a step
#: parameter: structure, dtype/shape/device metadata, identity-vs-None
_STATIC_ATTRS = {"shape", "dtype", "ndim", "size", "impl", "substeps",
                 "keys", "values", "items", "device", "is_cuda", "numel",
                 "dim"}
#: calls whose result is static even over a tensor argument. NOTE:
#: bool() is deliberately NOT here — bool(tensor) is exactly the host
#: read this rule exists to catch
_STATIC_CALLS = {"isinstance", "len", "hasattr", "getattr",
                 "issubdtype", "tuple", "sorted", "list", "set"}


def _branch_on_traced(test: ast.AST, params: set[str]) -> Optional[str]:
    """Name of the step parameter the test genuinely branches on, or
    None when every reference is structural (is-None, isinstance, len,
    .shape/.dtype metadata, dict membership)."""
    static_roots: set[ast.AST] = set()
    for n in ast.walk(test):
        if isinstance(n, ast.Compare) and any(
                isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                for op in n.ops):
            static_roots.update(ast.walk(n))
        elif (isinstance(n, ast.Call)
              and _dotted_last(n.func) in _STATIC_CALLS):
            static_roots.update(ast.walk(n))
        elif isinstance(n, ast.Attribute) and n.attr in _STATIC_ATTRS:
            static_roots.update(ast.walk(n))
    for n in ast.walk(test):
        if (isinstance(n, ast.Name) and n.id in params
                and n not in static_roots):
            return n.id
    return None


@rule("traced-branch", Severity.WARNING,
      "a Python `if`/`while` on a step parameter's value inside a step "
      "scope reads the tensor on the host (`bool(t)`): a device→host "
      "sync every step; use torch.where or keep the decision on the "
      "device",
      fix_hint="select with torch.where / a mask, branch on static "
      "metadata (.shape/.dtype/is None) only, or pragma a host-side "
      "parameter with its reason")
def check_traced_branch(ctx: ModuleCtx):
    for fn in ctx.traced_scopes:
        if isinstance(fn, ast.Lambda):
            continue  # lambdas cannot contain statements
        params = {a.arg for a in (fn.args.args + fn.args.posonlyargs
                                  + fn.args.kwonlyargs)}
        for node in ast.walk(fn):
            if not isinstance(node, (ast.If, ast.While)):
                continue
            hit = _branch_on_traced(node.test, params)
            if hit:
                yield Finding(
                    "traced-branch", Severity.WARNING, ctx.path,
                    node.lineno,
                    f"Python branch on step parameter `{hit}` inside a "
                    "step scope — a tensor's truth value is a host read "
                    "(use torch.where, or branch on static metadata "
                    "only)")


# -- heavy-test rule (the marker audit, generalized) --------------------------
# The tier-1 wall stays thin only if every test that spawns a
# subprocess, runs a multihost/multichip dryrun, or steps a >= 2048²
# grid is marked slow; this rule is that marker audit.

#: referencing any of these names marks a function heavy
HEAVY_NAMES = {"subprocess", "Popen", "pexpect"}
#: calling anything whose name contains one of these marks it heavy
HEAVY_NAME_PARTS = ("dryrun",)
#: a call carrying >= 2 literal ints >= this constructs a >= GRID²
#: grid: ~17M+ cells per array on the CPU rig — inner-loop poison
GRID_LIMIT = 2048


def _marks_slow(node: ast.AST) -> bool:
    """True when the expression contains a ``...slow`` attribute (any
    spelling of pytest.mark.slow, including parametrized/called forms
    and marker lists)."""
    return any(isinstance(n, ast.Attribute) and n.attr == "slow"
               for n in ast.walk(node))


def _const_env(tree: ast.AST) -> dict[str, int]:
    """name → int for simple ``g = 4096``-style assignments anywhere in
    the module (module or function scope) — enough constant propagation
    to catch the idiomatic ``g = 4096; create(g, g, ...)`` shape. A
    name assigned two different ints keeps the LARGER (conservative:
    the audit must not under-flag)."""
    env: dict[str, int] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        if not (isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, int)
                and not isinstance(node.value.value, bool)):
            continue
        for t in node.targets:
            if isinstance(t, ast.Name):
                env[t.id] = max(env.get(t.id, 0), node.value.value)
    return env


def _call_int_literals(call: ast.Call, env: dict[str, int]) -> list[int]:
    """Integer literals carried by a call's args/keywords, tuples
    flattened, simple names resolved through ``env``."""
    out: list[int] = []

    def visit(node):
        if isinstance(node, ast.Constant) and isinstance(node.value, int) \
                and not isinstance(node.value, bool):
            out.append(node.value)
        elif isinstance(node, ast.Name) and node.id in env:
            out.append(env[node.id])
        elif isinstance(node, (ast.Tuple, ast.List)):
            for e in node.elts:
                visit(e)

    for a in call.args:
        visit(a)
    for kw in call.keywords:
        visit(kw.value)
    return out


def _builds_big_grid(fn: ast.AST, env: dict[str, int]) -> bool:
    """True when some call in ``fn`` carries >= 2 int literals >=
    GRID_LIMIT — the >= 2048² grid-construction shape (one big literal
    alone — a 1024x2048 strip, a byte count — does not trip it)."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            big = [v for v in _call_int_literals(node, env)
                   if v >= GRID_LIMIT]
            if len(big) >= 2:
                return True
    return False


def _directly_heavy(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        name = None
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):
            name = node.attr
        if name is None:
            continue
        if name in HEAVY_NAMES:
            return True
        if any(part in name for part in HEAVY_NAME_PARTS):
            return True
    return False


def _called_names(fn: ast.AST) -> set[str]:
    out = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name):
                out.add(f.id)
            elif isinstance(f, ast.Attribute):
                out.add(f.attr)
    return out


def _unmarked_heavy_tests(ctx: ModuleCtx) -> list[ast.AST]:
    tree = ctx.tree
    module_slow = any(
        isinstance(stmt, ast.Assign)
        and any(isinstance(t, ast.Name) and t.id == "pytestmark"
                for t in stmt.targets)
        and _marks_slow(stmt.value)
        for stmt in tree.body)
    if module_slow:
        return []

    # module-local function defs (incl. methods), for one-level-deep
    # transitive heaviness through helpers
    funcs: dict[str, ast.AST] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            funcs.setdefault(node.name, node)

    env = _const_env(tree)
    heavy = {name for name, fn in funcs.items()
             if _directly_heavy(fn) or _builds_big_grid(fn, env)}
    changed = True
    while changed:  # propagate through helper calls to a fixpoint
        changed = False
        for name, fn in funcs.items():
            if name in heavy:
                continue
            if _called_names(fn) & heavy:
                heavy.add(name)
                changed = True

    out = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not node.name.startswith("test_"):
            continue
        if node.name not in heavy:
            continue
        if any(_marks_slow(d) for d in node.decorator_list):
            continue
        out.append(node)
    return out


@rule("heavy-test", Severity.ERROR,
      "tests that spawn subprocesses, run dryrun rigs, or build >= "
      "2048² grids must carry @pytest.mark.slow (tier-1 870 s wall)",
      scope=SCOPE_TESTS,
      fix_hint="decorate the test with @pytest.mark.slow (or shrink the "
      "grid below 2048²)")
def check_heavy_test(ctx: ModuleCtx):
    for node in _unmarked_heavy_tests(ctx):
        yield Finding(
            "heavy-test", Severity.ERROR, ctx.path, node.lineno,
            f"`{node.name}` spawns subprocesses, runs a multihost/"
            "multichip dryrun, or constructs a >= 2048² grid but is not "
            "marked slow — it would fatten the tier-1 inner loop (mark "
            "it @pytest.mark.slow or set a module pytestmark)")


# -- naked-save rule --------------------------------------
# Checkpoint durability now includes INTEGRITY: the manager's save path
# writes per-array checksums and resume falls back to the newest step
# that verifies. That guarantee holds only if every checkpoint write in
# the package flows through the io writers / the supervisor-and-flush
# boundaries — a module calling the raw writers (or a manager's .save)
# from arbitrary code can reintroduce unverifiable checkpoints or break
# the async staged-commit protocol.

#: the raw checkpoint writers — callable only from the io layer itself
#: (the set includes the delta chain's raw record writer:
#: a record written outside the chain's save path never reaches the
#: chain manifest, so it would be an uncommitted — hence unrestorable —
#: husk at best and a chain-corrupting overwrite at worst)
CHECKPOINT_WRITERS = {"save_checkpoint", "save_checkpoint_sharded",
                      "stage_checkpoint_sharded", "write_chain_record"}
#: receiver names that read as a CheckpointManager, a DeltaChain or the
#: scenario-tiering vault (`mgr.save(...)`, `chain.save(...)`,
#: `vault.save(...)` / `tiering.hibernate` targets — the
#: one-format discipline covers hibernation writes: scenario state may
#: only reach disk through the io/delta.py chain writers driven from
#: the ensemble/tiering.py boundary)
_MANAGERISH = None  # compiled lazily; module-level re import kept local


def _managerish():
    global _MANAGERISH
    if _MANAGERISH is None:
        import re

        _MANAGERISH = re.compile(r"(manager|mgr|ckpt|chain|vault|tiering)",
                                 re.IGNORECASE)
    return _MANAGERISH


def _save_boundary_module(ctx: ModuleCtx) -> bool:
    """io/checkpoint.py, io/sharded.py, io/delta.py, the resilience
    package and ensemble/tiering.py (the hibernate/wake
    paging layer drives the delta-chain writers — the ONE sanctioned
    place a scenario's state is written outside a checkpoint) are the
    supervisor/flush boundaries the rule exempts."""
    parts = ctx.resolved_parts
    if "resilience" in parts:
        return True
    if (len(parts) >= 2 and parts[-2] == "ensemble"
            and parts[-1] == "tiering.py"):
        return True
    return (len(parts) >= 2 and parts[-2] == "io"
            and parts[-1] in ("checkpoint.py", "sharded.py", "delta.py"))


@rule("naked-save", Severity.ERROR,
      "checkpoint writes outside the supervisor/flush boundaries must "
      "go through CheckpointManager's checksum-writing path — raw "
      "writer calls can reintroduce unverifiable checkpoints",
      scope=SCOPE_PACKAGE,
      fix_hint="route the write through CheckpointManager.save so the "
      "checksum sidecar is written atomically")
def check_naked_save(ctx: ModuleCtx):
    if _save_boundary_module(ctx):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = _dotted_last(fn)
        if name in CHECKPOINT_WRITERS:
            yield Finding(
                "naked-save", Severity.ERROR, ctx.path, node.lineno,
                f"direct `{name}` call outside the io/resilience "
                "boundaries — route the write through "
                "CheckpointManager.save (the checksum-writing, "
                "prune-aware path), or pragma a genuine low-level "
                "boundary with its reason")
        elif (name == "save" and isinstance(fn, ast.Attribute)
              and (recv := _dotted_last(fn.value)) is not None
              and _managerish().search(recv)):
            # _dotted_last resolves chained receivers too (self.mgr.save,
            # cfg.manager.save) — a stored manager must not bypass the rule
            yield Finding(
                "naked-save", Severity.ERROR, ctx.path, node.lineno,
                f"`{recv}.save(...)` outside the supervisor/"
                "flush boundaries — checkpoint cadence belongs to "
                "resilience.supervised_run / io.run_checkpointed (they "
                "carry the conservation baseline and commit staged "
                "async writes); pragma a genuine boundary with its "
                "reason")


# -- raw-transport rule ----------------------------------
# The multi-process fleet's correctness rests on every byte that
# crosses a process boundary flowing through the ensemble.wire codec:
# CRC-framed, deadline-bounded, typed errors, chaos-seamed. A module
# opening its own socket or spawning its own subprocess bypasses all
# four — an unframed byte stream can hang the supervisor, and an
# unmanaged child is a process the fleet can neither heartbeat nor
# fence. This mirrors the naked-save boundary pattern: the codec
# modules are the sanctioned boundary, everything else pragmas a
# genuine low-level rig with its reason.

#: constructor/spawn entry points of the two transport modules
_SUBPROCESS_CALLS = {"Popen", "run", "call", "check_call", "check_output"}
_SOCKET_CALLS = {"socket", "socketpair", "create_connection",
                 "create_server"}
#: transport-AUTH primitives: the TCP members' shared-secret
#: HMAC challenge–response and its secret minting live in the wire
#: handshake — a module reaching for ``hmac``/``secrets`` elsewhere is
#: hand-rolling a second, unaudited authentication path beside it
_HMAC_CALLS = {"new", "compare_digest", "digest"}
_SECRETS_CALLS = {"token_hex", "token_bytes", "token_urlsafe"}
#: bare names that unambiguously mean a transport was opened even
#: through a from-import ("run"/"call"/"socket"/"new" alone are too
#: generic)
_TRANSPORT_BARE = {"Popen", "socketpair", "create_connection",
                   "create_server", "compare_digest", "token_hex",
                   "token_bytes", "token_urlsafe"}


def _transport_boundary_module(ctx: ModuleCtx) -> bool:
    """ensemble/wire.py and ensemble/member_proc.py are THE transport
    boundary: the codec and the member spawn/serve machinery."""
    parts = ctx.resolved_parts
    return (len(parts) >= 2 and parts[-2] == "ensemble"
            and parts[-1] in ("wire.py", "member_proc.py"))


@rule("raw-transport", Severity.ERROR,
      "raw socket/subprocess/transport-auth use outside the ensemble "
      "wire boundary — bytes crossing a process edge must ride the "
      "CRC-framed, deadline-bounded codec, and its HMAC handshake is "
      "the ONE auth path (ensemble/wire.py, member_proc.py)",
      scope=SCOPE_PACKAGE,
      fix_hint="send the bytes through the wire codec (ensemble/wire.py) "
      "or add the module to the transport boundary with a "
      "reasoned pragma")
def check_raw_transport(ctx: ModuleCtx):
    if _transport_boundary_module(ctx):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        hit = None
        if isinstance(fn, ast.Attribute):
            recv = _dotted_last(fn.value)
            if recv == "subprocess" and fn.attr in _SUBPROCESS_CALLS:
                hit = f"subprocess.{fn.attr}"
            elif recv == "socket" and fn.attr in _SOCKET_CALLS:
                hit = f"socket.{fn.attr}"
            elif recv == "hmac" and fn.attr in _HMAC_CALLS:
                hit = f"hmac.{fn.attr}"
            elif recv == "secrets" and fn.attr in _SECRETS_CALLS:
                hit = f"secrets.{fn.attr}"
        elif isinstance(fn, ast.Name) and fn.id in _TRANSPORT_BARE:
            hit = fn.id
        if hit is not None:
            yield Finding(
                "raw-transport", Severity.ERROR, ctx.path, node.lineno,
                f"raw `{hit}(...)` outside the wire boundary — route "
                "process/socket traffic through ensemble.wire/"
                "member_proc (CRC framing, RPC deadlines, chaos "
                "seams), or pragma a genuine low-level rig with its "
                "reason")


# -- unguarded-shared-mutation rule -----------------------
# The ensemble scheduler/service now run submit/poll on client threads
# while a pump thread dispatches: every class that owns a dispatch lock
# must route its shared-state writes through it. This rule is the
# structural enforcement: in any threaded module (imports ``threading``
# or the ``resilience.lockdep`` lock factories — one definition, shared
# with the concurrency layer), a class that binds a lock ANYWHERE in
# its body (an attribute whose name contains lock/mutex/cond/cv —
# __init__ or any other method: the fleet supervisor's
# state made late-bound locks a real shape) may only write ``self.*``
# state inside a ``with self.<lock>:`` block. Escapes: ``__init__``
# itself (construction happens-before publication), methods whose name
# ends in ``_locked`` (the caller-holds-the-lock convention,
# self-documenting), and the pragma. Writes = Assign/AugAssign/
# AnnAssign/Delete whose target is rooted at ``self`` (attribute or
# subscript chains included: ``self.x = ...``, ``self.d[k] = ...``,
# ``self.a.b += 1``, ``del self.d[k]``); method-CALL mutations
# (``self.list.append``) are out of scope — the rule catches the
# lost-update/torn-read shapes, the review catches the rest.
#
# The lock-detection machinery is shared: what counts as a
# lock, a threaded module, a self-rooted write or a guarded region is
# defined ONCE in ``analysis.concurrency`` (the shared lock model the
# acquisition-graph rules build on) and re-fronted here.

from .concurrency import (LOCKISH as _LOCKISH,  # noqa: F401
                          lock_attrs_bound_in_class as
                          _lock_attrs_bound_in_class,
                          module_is_threaded as _module_is_threaded,
                          self_write_targets as _self_write_targets,
                          under_lock_with as _under_lock_with_parents)


def _under_lock_with(ctx: ModuleCtx, node: ast.AST,
                     method: ast.AST) -> bool:
    return _under_lock_with_parents(ctx.parents, node, method)


@rule("unguarded-shared-mutation", Severity.ERROR,
      "in threaded modules, classes that bind a dispatch lock "
      "(anywhere in the class body) must write self.* state inside "
      "`with self.<lock>:` (escapes: __init__, *_locked methods, "
      "pragma) — an unlocked write races the pump thread",
      scope=SCOPE_PACKAGE,
      fix_hint="wrap the write in `with self.<lock>:` or rename the "
      "method *_locked and call it under the lock")
def check_unguarded_shared_mutation(ctx: ModuleCtx):
    if not _module_is_threaded(ctx.tree):
        return
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        locks = _lock_attrs_bound_in_class(cls)
        if not locks:
            continue
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                continue
            if method.name == "__init__" or method.name.endswith("_locked"):
                continue
            for node in ast.walk(method):
                for t in _self_write_targets(node):
                    if _under_lock_with(ctx, node, method):
                        continue
                    desc = (t.attr if isinstance(t, ast.Attribute)
                            else ast.dump(t)[:40])
                    yield Finding(
                        "unguarded-shared-mutation", Severity.ERROR,
                        ctx.path, node.lineno,
                        f"`{cls.name}.{method.name}` writes shared "
                        f"state `self.{desc}` outside `with "
                        f"self.{sorted(locks)[0]}:` — another thread "
                        "can race this write (guard it, rename the "
                        "method *_locked if the caller holds the lock, "
                        "or pragma a genuinely single-threaded path "
                        "with its reason)")


# -- wall-clock-in-test rule ------------------------------
# The zero-wall-sleeps discipline: every latency/
# deadline/backoff path in the serving stack runs on an injectable
# clock, so tier-1 tests drive time deterministically instead of
# sleeping through it. This rule makes the discipline structural:
# `time.sleep`/`time.time` in a test module is an ERROR — a test that
# needs time passing advances a fake clock (see tests/test_serving.py's
# `clock = {"t": ...}` idiom); a test that genuinely must touch the
# wall (none today) pragmas the call with its reason.
# `time.monotonic`/`time.perf_counter` stay legal: reading a clock for
# a coarse duration bound does not make a test timing-dependent the way
# sleeping or comparing wall timestamps does.

#: the `time` module attributes whose CALL in a test is wall-clock
#: dependence: sleeping burns tier-1 wall, and `time.time()` asserts
#: against a clock the test does not control
WALL_CLOCK_ATTRS = {"sleep", "time"}


def _time_module_imports(tree: ast.Module) -> tuple[set[str], set[str]]:
    """(function names, module aliases) bound in this module that
    resolve to the wall clock: ``from time import sleep, time as now``
    binds functions; ``import time`` / ``import time as _t`` binds the
    module under a (possibly aliased) name — both spellings are the
    same dependence and must lint the same."""
    funcs: set[str] = set()
    modules: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "time":
            for a in node.names:
                if a.name in WALL_CLOCK_ATTRS:
                    funcs.add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "time":
                    modules.add(a.asname or a.name)
    return funcs, modules


@rule("wall-clock-in-test", Severity.ERROR,
      "`time.sleep`/`time.time` in tests/ couples the suite to the "
      "wall clock — drive the injectable clock instead (pragma a "
      "genuine wall dependency with its reason)",
      scope=SCOPE_TESTS,
      fix_hint="drive the injectable clock (resilience.clock) instead of "
      "time.*")
def check_wall_clock_in_test(ctx: ModuleCtx):
    # only calls through an ACTUAL time import count: in a module that
    # never imports time, a name `time` is a local binding (e.g. a
    # fake-clock fixture — the very idiom this rule recommends), and
    # flagging it would be a false-positive ERROR
    from_imports, module_names = _time_module_imports(ctx.tree)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        hit = None
        if (isinstance(fn, ast.Attribute) and fn.attr in WALL_CLOCK_ATTRS
                and isinstance(fn.value, ast.Name)
                and fn.value.id in module_names):
            hit = f"{fn.value.id}.{fn.attr}"
        elif isinstance(fn, ast.Name) and fn.id in from_imports:
            hit = fn.id
        if hit is not None:
            yield Finding(
                "wall-clock-in-test", Severity.ERROR, ctx.path,
                node.lineno,
                f"`{hit}(...)` in a test module — tests drive the "
                "injectable clock (a fake `clock`/`sleep` advancing a "
                "dict value), never the wall; sleeping fattens the "
                "tier-1 wall and wall-time asserts flake (pragma a "
                "genuine wall dependency with its reason)")


# -- naked-timer rule ------------------------------------
# The serving stack now has a real observability layer: spans
# (utils.tracing — trace-context ids, cross-process propagation, the
# telemetry plane's per-stage rollups) and the shared LatencyReservoir
# (utils.metrics). A raw `time.perf_counter()` / `time.monotonic()`
# call in the ensemble modules is timing that BYPASSES both — it
# produces a number nobody can correlate with a ticket, a stage or a
# percentile. New timing should open a span or feed a reservoir; the
# handful of reasoned sites (the occupancy span bridge, client-facing
# wall deadlines, the wake-latency anchor, the wire's socket deadline
# arithmetic) carry pragmas naming why they are not spans.
# References (e.g. `clock=time.monotonic` as an injectable default)
# are NOT calls and stay legal.

#: the `time` attributes whose CALL in a serving module is naked timing
_TIMER_ATTRS = {"perf_counter", "monotonic"}


def _timer_imports(tree: ast.Module) -> tuple[set[str], set[str]]:
    """(function names, module aliases) bound in this module that
    resolve to the monotonic timers — same resolution discipline as
    the wall-clock-in-test rule (only calls through a REAL time import
    count; a fake-clock local named `time` cannot false-positive)."""
    funcs: set[str] = set()
    modules: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "time":
            for a in node.names:
                if a.name in _TIMER_ATTRS:
                    funcs.add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "time":
                    modules.add(a.asname or a.name)
    return funcs, modules


def _serving_module(ctx: ModuleCtx) -> bool:
    """The rule's scope: the ensemble serving modules. utils/tracing.py
    and utils/metrics.py are the sanctioned timing layer (not under
    ensemble/, so they are out of scope by construction)."""
    parts = ctx.resolved_parts
    return "ensemble" in parts[:-1]


@rule("naked-timer", Severity.WARNING,
      "direct time.perf_counter()/time.monotonic() timing in the "
      "serving/ensemble modules — new timing should flow through "
      "tracing spans or the metrics LatencyReservoir so it lands on "
      "the telemetry plane (pragma a reasoned site)",
      scope=SCOPE_PACKAGE,
      fix_hint="time the section with a tracing span or feed the sample "
      "into metrics.LatencyReservoir")
def check_naked_timer(ctx: ModuleCtx):
    if not _serving_module(ctx):
        return
    from_imports, module_names = _timer_imports(ctx.tree)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        hit = None
        if (isinstance(fn, ast.Attribute) and fn.attr in _TIMER_ATTRS
                and isinstance(fn.value, ast.Name)
                and fn.value.id in module_names):
            hit = f"{fn.value.id}.{fn.attr}"
        elif isinstance(fn, ast.Name) and fn.id in from_imports:
            hit = fn.id
        if hit is not None:
            yield Finding(
                "naked-timer", Severity.WARNING, ctx.path, node.lineno,
                f"`{hit}(...)` in a serving module — time through "
                "utils.tracing spans (correlatable, exported, rolled "
                "up by the telemetry plane) or the "
                "utils.metrics.LatencyReservoir, or pragma a reasoned "
                "exception")


def audit_test_module(path) -> list[str]:
    """Marker-audit compatibility surface for
    ``tests/test_marker_audit.py``: ``["file.py::test_name", ...]`` for
    every unmarked heavy test, in source order."""
    p = Path(path)
    ctx = parse_module(p.read_text(), str(p))
    nodes = _unmarked_heavy_tests(ctx)
    return [f"{p.name}::{n.name}"
            for n in sorted(nodes, key=lambda n: n.lineno)]


# -- engine entry points ------------------------------------------------------

#: directories never descended into
SKIP_DIRS = {".git", "__pycache__", ".claude", "build", "node_modules",
             ".pytest_cache"}


def iter_py_files(root) -> Iterable[Path]:
    root = Path(root)
    if root.is_file():
        if root.suffix == ".py":
            yield root
        return
    for p in sorted(root.rglob("*.py")):
        if not any(part in SKIP_DIRS for part in p.parts):
            yield p


def _scope_matches(scope: str, ctx: ModuleCtx, package_name: str) -> bool:
    if scope == SCOPE_ALL:
        return True
    if scope == SCOPE_TESTS:
        return ctx.is_test
    if scope == SCOPE_PACKAGE:
        return (package_name in ctx.resolved_parts
                and not ctx.is_test)
    return False


def lint_source(source: str, path: str = "<string>",
                rules: Optional[Iterable[str]] = None,
                package_name: str = "mpi_model_tpu_torch"
                ) -> list[Finding]:
    """All findings (suppressed ones included, flagged) for one module's
    source. ``rules`` restricts to a subset of rule ids."""
    ctx = parse_module(source, path)
    selected = [RULES[r] for r in rules] if rules else list(RULES.values())
    raw: list[Finding] = []
    for rl in selected:
        if _scope_matches(rl.scope, ctx, package_name):
            raw.extend(rl.check(ctx))
    raw.sort(key=lambda f: (f.line, f.rule))
    return apply_pragmas(raw, ctx.pragmas, ctx.lines)


def lint_file(path, rules: Optional[Iterable[str]] = None,
              rel_to=None) -> list[Finding]:
    p = Path(path)
    shown = str(p.relative_to(rel_to)) if rel_to else str(p)
    try:
        source = p.read_text()
    except (OSError, UnicodeDecodeError) as e:
        return [Finding("parse-error", Severity.ERROR, shown, 0,
                        f"unreadable: {e}")]
    try:
        return lint_source(source, shown, rules)
    except SyntaxError as e:
        return [Finding("parse-error", Severity.ERROR, shown,
                        e.lineno or 0, f"syntax error: {e.msg}")]


def run_astlint(roots, rules: Optional[Iterable[str]] = None,
                rel_to=None) -> list[Finding]:
    """Lint every ``.py`` under each root; findings keep file order."""
    findings: list[Finding] = []
    for root in roots:
        for p in iter_py_files(root):
            findings.extend(lint_file(p, rules, rel_to=rel_to))
    return findings


# -- hardcoded-physics rule ------------------------------
# The Flow IR exists so new physics is TERMS + one registered lowering,
# not four hand-mirrored step functions. This rule is the structural
# backstop: transport-shaped arithmetic (the stencil redistribution
# helpers) appearing in package code OUTSIDE the ops/ kernels and the
# ir/ lowering reads as a fifth hand-written step growing back. The
# pre-IR call sites that legitimately remain (the legacy flow paths the
# IR cannot represent exactly) carry pragmas with their reasons — new
# ones must either live in ir/lowerings or justify themselves the same
# way.

#: the transport-shaped helper surface: calling any of these builds a
#: stencil redistribution step (or a piece of one); ``weighted_counts``
#: is the port's name of ``weighted_counts_traced``
_PHYSICS_HELPERS = {"transport", "flow_step", "point_flow_step",
                    "gather_neighbors", "gather_from_padded", "shift2d",
                    "weighted_counts_traced", "weighted_counts"}


def _physics_boundary_module(ctx: ModuleCtx) -> bool:
    """ops/ (the kernel layer) and ir/ (the registered lowerings) are
    where transport arithmetic lives by design."""
    parts = ctx.resolved_parts
    return "ops" in parts or "ir" in parts


@rule("hardcoded-physics", Severity.WARNING,
      "transport-shaped arithmetic (stencil redistribution helpers) "
      "outside ops/ and ir/ lowerings — new physics belongs in IR "
      "terms lowered once, not in another hand-mirrored step",
      scope=SCOPE_PACKAGE,
      fix_hint="express the stencil as a Flow IR term and lower it in "
      "ir.lower")
def check_hardcoded_physics(ctx: ModuleCtx):
    if _physics_boundary_module(ctx):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted_last(node.func)
        if name in _PHYSICS_HELPERS:
            yield Finding(
                "hardcoded-physics", Severity.WARNING, ctx.path,
                node.lineno,
                f"`{name}(...)` outside ops/ and ir/: transport-shaped "
                "arithmetic belongs in an IR term's registered lowering "
                "(ir.lower) so every engine serves it — pragma a "
                "retained legacy path with its reason")


# -- journal-kind-literal rule ---------------------------
# The lifecycle refactor moved every journal record kind behind the
# constants in ensemble/lifecycle.py; this rule is what keeps them
# there. A raw string literal in an append or dispatch position
# compiles fine, runs fine, and silently re-forks the vocabulary the
# day it drifts from the declaration — exactly the failure class the
# layer-4 protocol audit exists for, caught here at the single-module
# level where the fix is one import away.

#: the helpers whose first argument IS a record kind (shared naming
#: with analysis.protocol's extraction)
_JOURNAL_APPEND_HELPERS = ("_journal_append_locked", "_append_locked")

_JOURNAL_VOCAB: Optional[frozenset] = None


def _journal_vocab() -> frozenset:
    """The declared record-kind strings, read off
    ``ensemble/lifecycle.py``'s AST (uppercase module-level string
    constants; ``INITIAL`` is a state, not a kind) — parsed, not
    imported, so the lint never executes package code."""
    global _JOURNAL_VOCAB
    if _JOURNAL_VOCAB is None:
        path = (Path(__file__).resolve().parent.parent
                / "ensemble" / "lifecycle.py")
        out = set()
        try:
            tree = ast.parse(path.read_text())
        except (OSError, SyntaxError):  # pragma: no cover - lifecycle
            # unreadable: the rule degrades to append-literals only
            tree = ast.Module(body=[], type_ignores=[])
        for node in tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id.isupper()
                    and node.targets[0].id != "INITIAL"
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str)):
                out.add(node.value.value)
        _JOURNAL_VOCAB = frozenset(out)
    return _JOURNAL_VOCAB


def _lifecycle_module(ctx: ModuleCtx) -> bool:
    parts = ctx.resolved_parts
    return (len(parts) >= 2 and parts[-2] == "ensemble"
            and parts[-1] == "lifecycle.py")


@rule("journal-kind-literal", Severity.ERROR,
      "a raw record-kind string literal in a journal append or "
      "dispatch position outside ensemble/lifecycle.py — the declared "
      "constants are the vocabulary's single spelling; a literal "
      "re-forks it invisibly",
      scope=SCOPE_PACKAGE,
      fix_hint="import the kind constant from ensemble.lifecycle "
               "(SUBMIT, SERVED, …) and use it instead of the literal")
def check_journal_kind_literal(ctx: ModuleCtx):
    if _lifecycle_module(ctx):
        return
    vocab = _journal_vocab()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            fn = node.func
            is_append = (
                (isinstance(fn, ast.Name)
                 and fn.id in _JOURNAL_APPEND_HELPERS)
                or (isinstance(fn, ast.Attribute)
                    and (fn.attr in _JOURNAL_APPEND_HELPERS
                         or (fn.attr == "append"
                             and "journal" in
                             (_dotted_last(fn.value) or "").lower()))))
            if (is_append and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                yield Finding(
                    "journal-kind-literal", Severity.ERROR, ctx.path,
                    node.lineno,
                    f"append site spells record kind "
                    f"{node.args[0].value!r} as a raw literal — use "
                    "the ensemble.lifecycle constant")
        elif isinstance(node, ast.Compare):
            left = node.left
            if not (isinstance(left, ast.Attribute)
                    and left.attr == "kind"):
                continue
            lits = [c.value for c in node.comparators
                    if isinstance(c, ast.Constant)
                    and isinstance(c.value, str)]
            for c in node.comparators:
                if isinstance(c, (ast.Tuple, ast.List, ast.Set)):
                    lits.extend(e.value for e in c.elts
                                if isinstance(e, ast.Constant)
                                and isinstance(e.value, str))
            hits = sorted(set(lits) & vocab)
            if hits:
                yield Finding(
                    "journal-kind-literal", Severity.ERROR, ctx.path,
                    node.lineno,
                    f"dispatch compares .kind against raw literal(s) "
                    f"{', '.join(map(repr, hits))} — use the "
                    "ensemble.lifecycle constants")
