"""Concurrency audit (layer 3): a whole-program lock model and
inter-procedural lock-acquisition graph over the threaded serving stack.

The AST lint (layer 1) checks one module at a time; the step audit
(layer 2) checks one step at a time. Neither can see the shape
that actually deadlocks a fleet: method A of one class acquiring lock L1
and then CALLING into another class whose method acquires L2, while some
other path nests them the opposite way. This layer builds that view:

**Lock model** — per class: which attributes are synchronization
primitives (the ``LOCKISH`` name test, shared with layer 1's
``unguarded-shared-mutation`` rule), whether each is re-entrant
(``RLock``/``Condition`` vs plain ``Lock`` — read off the constructor,
``threading.*`` or the ``resilience.lockdep`` factories), which methods
acquire them (``with self.<lock>:`` or the ``*_locked``
caller-holds-the-lock naming convention), and — for classes that spawn a
``threading.Thread(target=self.X)`` — which methods run on the
pump/supervisor thread vs the client surface.

**Call resolution** — receiver types are inferred from the code the repo
already writes: ``self.x = ClassName(...)`` bindings, ``self.x: T``
annotations (dataclass fields included, ``Optional[T]``/``dict[K, V]``/
``list[T]`` unwrapped), parameter and return annotations, and simple
local aliases (``sched = self.scheduler``). An attribute call whose
receiver does not resolve to a modeled class is treated as UNKNOWN —
never guessed by bare method name, so ``self.member_log.append`` can not
alias into ``TicketJournal.append``.

**Acquisition graph** — an edge ``A → B`` means some code path acquires
lock key ``B`` (directly or through any resolvable call chain) while
holding ``A``. Lock keys are the strings the runtime witness uses
(``"EnsembleScheduler._lock"`` — taken from the ``lockdep`` factory
argument when present, else ``Class.attr``), so the static graph and
``resilience.lockdep``'s recorded runtime orders are directly
comparable: ``static_lock_graph()`` is what the armed witness asserts
observed orders against.

Rules on top of the model (registered in the shared registry, reported
through the same CLI/pragma machinery as every other rule):

``lock-order`` (ERROR)
    a cycle in the acquisition graph — two paths nesting the same locks
    in opposite orders is a potential deadlock the instant both run
    concurrently. Same-key nesting is allowed only for re-entrant locks
    (the sync scheduler's submit→dispatch RLock re-entry); a plain Lock
    nested under itself is a self-deadlock and flags.
``blocking-under-lock`` (WARNING)
    device work (a host read: ``.item()``, ``.tolist()``,
    ``synchronize()``, ``np.asarray``; ``jnp.*``/``device_get`` keep
    their JAX meaning), file I/O (``open``/
    ``write``/``flush``), ``Thread.join`` or sleeps while a lock is
    held — directly, or through any resolvable call chain. Every thread
    that wants the lock stalls behind the blocked holder; the finding
    names the chain. ``Condition.wait`` is exempt (it releases the
    lock), and calls to a same-class ``*_locked`` helper are reported
    inside the helper, not at every caller.
``lock-leak`` (ERROR)
    a bare ``.acquire()`` on a lock outside ``with``/``try‥finally`` —
    any exception between acquire and release leaves the lock held
    forever.
``thread-shared-without-lock`` (WARNING)
    an attribute written on the pump/supervisor thread and read from the
    client surface (or vice versa) with NO lock discipline at any
    access site — the torn-read twin of layer 1's
    ``unguarded-shared-mutation`` (which only sees writes).

The analysis is conservative where it must be (a resolvable call's
transitive acquisitions all count) and silent where it cannot know (an
unresolvable receiver contributes nothing) — the escape hatch is the
same reasoned pragma every other rule uses.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Iterable, Optional

from .registry import (RULES, Finding, Rule, Severity, apply_pragmas,
                       collect_pragmas)

#: registry scope tag for the concurrency rules (run by THIS engine over
#: the whole program, never by the per-module AST engine)
SCOPE_CONCURRENCY = "concurrency"


def _register(name: str, severity: Severity, doc: str,
              fix_hint: str = "") -> None:
    if name not in RULES:
        RULES[name] = Rule(name, severity, doc,
                           check=lambda ctx: (), scope=SCOPE_CONCURRENCY,
                           fix_hint=fix_hint)


_register("lock-order", Severity.ERROR,
          "a cycle in the inter-procedural lock-acquisition graph (or a "
          "non-reentrant lock nested under itself) is a potential "
          "deadlock — keep every path acquiring locks in one global "
          "order",
          fix_hint="acquire the locks in the documented global order "
                   "(or release the outer lock before taking the "
                   "inner one)")
_register("blocking-under-lock", Severity.WARNING,
          "device work (host reads: .item()/.tolist()/synchronize()/"
          "np.asarray), "
          "file I/O, Thread.join or sleeps while holding a lock stall "
          "every thread contending for it — move the work outside the "
          "lock or pragma the reasoned exception",
          fix_hint="snapshot state under the lock, release it, then do "
                   "the blocking work on the snapshot")
_register("lock-leak", Severity.ERROR,
          "bare .acquire() outside with/try-finally leaks the lock on "
          "any exception between acquire and release",
          fix_hint="use `with lock:` (or wrap acquire/release in "
                   "try/finally)")
_register("thread-shared-without-lock", Severity.WARNING,
          "an attribute written on the pump/supervisor thread and read "
          "from the client surface with no common lock is a torn-read "
          "race (the read-side twin of unguarded-shared-mutation)",
          fix_hint="read the attribute under the same lock the writer "
                   "holds (a *_locked accessor keeps it explicit)")


# -- the shared lock model (layer 1's unguarded-shared-mutation re-fronts
# -- these — one definition of "what is a lock" for the whole subsystem)

#: attribute names that read as a synchronization primitive. The tokens
#: are anchored at name-segment boundaries: `_lock`, `lock_cv`,
#: `_condition` qualify; `_clock`, `block_size`, `seconds` must NOT — a
#: bare substring match would classify a scheduler's injectable
#: `self._clock` as a lock and emit `with self._clock:` guidance.
LOCKISH = re.compile(
    r"(?:^|_)(?:lock|mutex|condition|cond|cv)(?:$|_)", re.IGNORECASE)

#: constructor names that build a NON-re-entrant primitive; everything
#: else lockish (RLock, Condition, the lockdep condition/rlock
#: factories, unknowns) is treated as re-entrant — the permissive
#: default, so an unrecognized constructor can't fabricate a same-key
#: deadlock finding
_NONREENTRANT_CTORS = {"Lock", "lock"}


def target_root(node: ast.AST) -> Optional[ast.AST]:
    """The root expression of an assignment-target chain
    (``self.a.b[k]`` → the ``self`` Name), descending Attribute/
    Subscript/Starred wrappers."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Starred)):
        node = node.value
    return node


def self_write_targets(node: ast.AST) -> list[ast.AST]:
    """Assignment-target expressions rooted at ``self`` for a write
    statement (tuple targets unpacked), else []."""
    if isinstance(node, ast.Assign):
        targets = list(node.targets)
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        targets = [node.target]
    elif isinstance(node, ast.Delete):
        targets = list(node.targets)
    else:
        return []
    flat: list[ast.AST] = []
    for t in targets:
        if isinstance(t, (ast.Tuple, ast.List)):
            flat.extend(t.elts)
        else:
            flat.append(t)
    out = []
    for t in flat:
        if isinstance(t, ast.Name):
            continue  # plain local — never shared state
        root = target_root(t)
        if isinstance(root, ast.Name) and root.id == "self":
            out.append(t)
    return out


def module_is_threaded(tree: ast.Module) -> bool:
    """True when the module imports ``threading`` OR the runtime lock
    witness (``resilience.lockdep``) — a module whose locks come from
    the lockdep factories is exactly as threaded as one calling
    ``threading.RLock()`` directly, and the shared-mutation/concurrency
    rules must treat them identically."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                parts = a.name.split(".")
                if parts[0] == "threading" or parts[-1] == "lockdep":
                    return True
        elif isinstance(node, ast.ImportFrom):
            mod = (node.module or "").split(".")
            if mod[0] == "threading" or mod[-1] == "lockdep":
                return True
            if any(a.name == "lockdep" for a in node.names):
                return True
    return False


def lock_attrs_bound_in_class(cls: ast.ClassDef) -> set[str]:
    """Names of self.<attr> bound ANYWHERE in the class whose attr reads
    as a lock (``self._lock = threading.RLock()``, ``self._lock_cv =
    ...``). Scanning every method (not just __init__) is deliberate: a
    supervisor that creates or replaces a synchronization primitive
    outside construction is still lock-owning — a lock bound late
    protects state exactly as much as one bound in __init__."""
    out: set[str] = set()
    for stmt in cls.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for node in ast.walk(stmt):
                for t in self_write_targets(node):
                    if (isinstance(t, ast.Attribute)
                            and LOCKISH.search(t.attr)):
                        out.add(t.attr)
    return out


def under_lock_with(parents: dict, node: ast.AST, method: ast.AST) -> bool:
    """True when ``node`` sits inside a ``with self.<lockish>:`` (or
    Condition) block within ``method`` — layer 1's write-guard test."""
    cur = parents.get(node)
    while cur is not None and cur is not method:
        if isinstance(cur, (ast.With, ast.AsyncWith)):
            for item in cur.items:
                for n in ast.walk(item.context_expr):
                    if (isinstance(n, ast.Attribute)
                            and LOCKISH.search(n.attr)):
                        root = target_root(n)
                        if isinstance(root, ast.Name) and root.id == "self":
                            return True
        cur = parents.get(cur)
    return False


# -- blocking-primitive classification ----------------------------------------

#: call last-names that block wherever they appear: host syncs, sleeps,
#: the raw file open
_BLOCKING_NAMES = {"block_until_ready", "device_get", "device_put",
                   "sleep", "open"}
#: attribute calls that are file/host I/O on their receiver
_IO_ATTRS = {"write", "flush", "fsync", "tobytes"}
#: numpy module aliases whose asarray/save materialize on host
_NP_ALIASES = {"np", "numpy", "onp"}
_NP_BLOCKING_ATTRS = {"asarray", "ascontiguousarray", "save", "savez",
                      "load"}
#: tensor/stream methods that wait for the device: torch's host reads
_HOST_READ_ATTRS = {"item", "tolist", "synchronize"}
#: receivers whose .join is path assembly, not thread synchronization
_JOIN_SAFE_RECEIVERS = {"path", "os", "sep"}


def _dotted_last(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _blocking_reason(call: ast.Call) -> Optional[str]:
    """Why this call blocks (host sync / I/O / join / sleep / device
    dispatch), or None. ``Condition.wait`` is NOT blocking-under-lock:
    waiting releases the lock — that is its whole point."""
    fn = call.func
    name = _dotted_last(fn)
    if name is None:
        return None
    if name in _BLOCKING_NAMES:
        return f"`{name}` blocks the calling thread"
    if not isinstance(fn, ast.Attribute):
        return None
    recv = fn.value
    recv_name = _dotted_last(recv)
    if recv_name in _NP_ALIASES and name in _NP_BLOCKING_ATTRS:
        return (f"`{recv_name}.{name}` materializes device state on "
                "host (a device_get)")
    if recv_name == "jnp":
        return f"`jnp.{name}` dispatches device work eagerly"
    if name in _IO_ATTRS and not isinstance(recv, ast.Constant):
        return f"`.{name}()` is file/host I/O"
    if name in _HOST_READ_ATTRS and not isinstance(recv, ast.Constant):
        return f"`.{name}()` is a host sync"
    if (name == "join" and not isinstance(recv, ast.Constant)
            and recv_name not in _JOIN_SAFE_RECEIVERS):
        return "`.join()` waits for another thread"
    return None


# -- type references and annotation parsing -----------------------------------

# A TypeRef is ("cls", name) | ("list", TypeRef) | ("dict", value TypeRef)
# | None — just enough typing to resolve the receiver chains the serving
# stack actually writes.


def _ann_to_type(ann, classes: dict):
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return None
    if isinstance(ann, (ast.Name, ast.Attribute)):
        name = _dotted_last(ann)
        return ("cls", name) if name in classes else None
    if isinstance(ann, ast.Subscript):
        base = _dotted_last(ann.value)
        sl = ann.slice
        if base in ("Optional",):
            return _ann_to_type(sl, classes)
        if base in ("list", "List", "Sequence", "Iterable", "Iterator"):
            return _wrap("list", _ann_to_type(sl, classes))
        if base in ("dict", "Dict", "OrderedDict", "defaultdict"):
            if isinstance(sl, ast.Tuple) and len(sl.elts) == 2:
                return _wrap("dict", _ann_to_type(sl.elts[1], classes))
            return None
    return None


def _wrap(kind, inner):
    return (kind, inner) if inner is not None else None


# -- program model ------------------------------------------------------------


@dataclasses.dataclass
class ModuleInfo:
    path: str
    stem: str
    tree: ast.Module
    lines: list[str]
    pragmas: dict
    threaded: bool
    parents: dict
    #: module-level lock Name → (key, reentrant)
    module_locks: dict


@dataclasses.dataclass
class FuncInfo:
    qual: str
    node: ast.AST
    module: ModuleInfo
    cls: Optional["ClassInfo"] = None
    #: direct lock keys acquired by `with` in this body
    direct_acquires: set = dataclasses.field(default_factory=set)
    #: resolved callee quals (for the fixpoints)
    callees: set = dataclasses.field(default_factory=set)
    #: (line, reason) of directly blocking calls in this body
    direct_blocking: list = dataclasses.field(default_factory=list)
    #: transitive results (filled by the fixpoints)
    may_acquire: set = dataclasses.field(default_factory=set)
    blocking_chain: Optional[str] = None

    @property
    def name(self) -> str:
        return self.qual.rsplit(".", 1)[-1]

    @property
    def caller_holds(self) -> bool:
        return (self.cls is not None and bool(self.cls.locks)
                and self.name.endswith("_locked"))


@dataclasses.dataclass
class ClassInfo:
    name: str
    node: ast.ClassDef
    module: ModuleInfo
    #: lock attr → (key, reentrant)
    locks: dict = dataclasses.field(default_factory=dict)
    attr_types: dict = dataclasses.field(default_factory=dict)
    methods: dict = dataclasses.field(default_factory=dict)
    #: methods named as a Thread target= (the pump/supervisor entries)
    thread_targets: set = dataclasses.field(default_factory=set)


class Program:
    """Every modeled module, class and function, plus the resolved
    acquisition graph — built once per audit run."""

    def __init__(self):
        self.modules: list[ModuleInfo] = []
        self.classes: dict[str, ClassInfo] = {}
        self.functions: dict[str, FuncInfo] = {}  # module-level, by name
        self.funcs_by_qual: dict[str, FuncInfo] = {}
        #: lock key → re-entrant? (so a transitive same-key acquisition
        #: of a plain Lock still reads as the self-deadlock it is)
        self.lock_reentrant: dict = {}
        #: (from_key, to_key) → (path, line, description) first witness
        self.edges: dict = {}
        self.findings: list[Finding] = []

    # -- construction --------------------------------------------------------

    def add_module(self, source: str, path: str) -> None:
        tree = ast.parse(source, filename=path)
        parents: dict = {}
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                parents[child] = parent
        mod = ModuleInfo(
            path=path, stem=Path(path).stem, tree=tree,
            lines=source.splitlines(),
            pragmas=collect_pragmas(source.splitlines()),
            threaded=module_is_threaded(tree), parents=parents,
            module_locks={})
        self.modules.append(mod)
        for stmt in tree.body:
            if isinstance(stmt, ast.ClassDef):
                self._add_class(stmt, mod)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{mod.stem}.{stmt.name}"
                fi = FuncInfo(qual, stmt, mod)
                self.functions.setdefault(stmt.name, fi)
                self.funcs_by_qual[qual] = fi
            elif isinstance(stmt, ast.Assign):
                # module-level lock: `_default_lock = threading.Lock()`
                for t in stmt.targets:
                    if (isinstance(t, ast.Name) and LOCKISH.search(t.id)
                            and isinstance(stmt.value, ast.Call)):
                        ctor = _dotted_last(stmt.value.func)
                        info = (f"{mod.stem}.{t.id}",
                                ctor not in _NONREENTRANT_CTORS)
                        mod.module_locks[t.id] = info
                        self.lock_reentrant[info[0]] = info[1]

    def _add_class(self, node: ast.ClassDef, mod: ModuleInfo) -> None:
        ci = ClassInfo(node.name, node, mod)
        # name-based resolution is first-wins; a SHADOWED duplicate
        # class still gets analyzed (its methods carry a module-
        # qualified qual so the tables never disagree), it just can't
        # be resolved INTO by name from other code
        primary = node.name not in self.classes
        if primary:
            self.classes[node.name] = ci
        # dataclass-field annotations type the attrs directly
        for stmt in node.body:
            if (isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)):
                ci.attr_types[stmt.target.id] = stmt.annotation
        for stmt in node.body:
            if not isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            qual = (f"{node.name}.{stmt.name}" if primary
                    else f"{mod.stem}:{node.name}.{stmt.name}")
            fi = FuncInfo(qual, stmt, mod, cls=ci)
            ci.methods[stmt.name] = fi
            self.funcs_by_qual[qual] = fi
            for n in ast.walk(stmt):
                # self.x = Ctor(...) / self.x: T = ... bindings + locks
                if isinstance(n, ast.AnnAssign):
                    for t in self_write_targets(n):
                        if isinstance(t, ast.Attribute):
                            ci.attr_types.setdefault(t.attr, n.annotation)
                if isinstance(n, (ast.Assign, ast.AnnAssign)):
                    val = n.value
                    for t in self_write_targets(n):
                        if not isinstance(t, ast.Attribute):
                            continue
                        if LOCKISH.search(t.attr) and isinstance(
                                val, ast.Call):
                            info = self._lock_info(node.name, t.attr, val)
                            ci.locks[t.attr] = info
                            self.lock_reentrant[info[0]] = info[1]
                        ctor = self._ctor_name(val)
                        if ctor is not None:
                            ci.attr_types.setdefault(t.attr, ctor)
                # Thread(target=self.X) → X is a pump/supervisor entry
                if (isinstance(n, ast.Call)
                        and _dotted_last(n.func) == "Thread"):
                    for kw in n.keywords:
                        if kw.arg == "target" and isinstance(
                                kw.value, ast.Attribute):
                            root = target_root(kw.value)
                            if (isinstance(root, ast.Name)
                                    and root.id == "self"):
                                ci.thread_targets.add(kw.value.attr)

    @staticmethod
    def _ctor_name(val) -> Optional[ast.Name]:
        """The Name of a top-level constructor call in an attr binding,
        looking through the ``x if x is not None else Ctor()`` default
        idiom — NOT a deep walk, so ``self.x = foo(Bar())`` can never
        bind x to Bar."""
        if isinstance(val, ast.Call) and isinstance(val.func, ast.Name):
            if val.func.id != "Thread":
                return val.func
            return None
        if isinstance(val, ast.IfExp):
            return (Program._ctor_name(val.body)
                    or Program._ctor_name(val.orelse))
        return None

    @staticmethod
    def _lock_info(cls_name: str, attr: str, ctor: ast.Call):
        """(key, reentrant) for a lock binding. The lockdep factories
        carry the runtime key as their first argument — prefer it, so
        the static graph speaks the witness's language."""
        key = f"{cls_name}.{attr}"
        if (ctor.args and isinstance(ctor.args[0], ast.Constant)
                and isinstance(ctor.args[0].value, str)):
            key = ctor.args[0].value
        name = _dotted_last(ctor.func)
        return (key, name not in _NONREENTRANT_CTORS)

    # -- type inference ------------------------------------------------------

    def _infer_locals(self, fi: FuncInfo) -> dict:
        """name → TypeRef for a function's parameters and simple local
        bindings (flow-insensitive, last binding wins — enough for the
        ``sched = self.scheduler`` aliases the stack writes)."""
        classes = self.classes
        out: dict = {}
        args = fi.node.args
        for a in (args.args + args.posonlyargs + args.kwonlyargs):
            t = _ann_to_type(a.annotation, classes)
            if t is not None:
                out[a.arg] = t
        # nested defs are a different frame: their bindings must not
        # overwrite this frame's aliases (_walk_skip_nested prunes the
        # whole nested body, not just the def node)
        for n in _walk_skip_nested(fi.node, skip_root=True):
            if isinstance(n, ast.AnnAssign) and isinstance(
                    n.target, ast.Name):
                t = _ann_to_type(n.annotation, classes)
                if t is not None:
                    out[n.target.id] = t
            elif isinstance(n, ast.Assign) and len(n.targets) == 1 \
                    and isinstance(n.targets[0], ast.Name):
                t = self._infer_expr(n.value, out, fi)
                if t is not None:
                    out[n.targets[0].id] = t
            elif isinstance(n, ast.For):
                it = self._infer_iter_elem(n.iter, out, fi)
                if isinstance(n.target, ast.Name) and it is not None:
                    out[n.target.id] = it
                elif (isinstance(n.target, ast.Tuple) and it is not None
                      and isinstance(it, tuple) and it[0] == "pair"
                      and len(n.target.elts) == 2
                      and isinstance(n.target.elts[1], ast.Name)):
                    out[n.target.elts[1].id] = it[1]
        return out

    def _infer_iter_elem(self, expr, locals_, fi):
        """Element type of an iterated expression: list[T] → T,
        dict.values() → V, dict.items() → ("pair", V)."""
        if isinstance(expr, ast.Call):
            fn = expr.func
            if isinstance(fn, ast.Name) and fn.id in ("list", "sorted") \
                    and expr.args:
                return self._infer_iter_elem(expr.args[0], locals_, fi)
            if isinstance(fn, ast.Attribute):
                base = self._infer_expr(fn.value, locals_, fi)
                if base is not None and base[0] == "dict":
                    if fn.attr == "values":
                        return base[1]
                    if fn.attr == "items":
                        return ("pair", base[1])
        t = self._infer_expr(expr, locals_, fi)
        if t is not None and t[0] == "list":
            return t[1]
        return None

    def _infer_expr(self, expr, locals_, fi: FuncInfo):
        classes = self.classes
        if isinstance(expr, ast.Name):
            if expr.id == "self" and fi.cls is not None:
                return ("cls", fi.cls.name)
            if expr.id == "cls" and fi.cls is not None:
                return ("cls", fi.cls.name)
            return locals_.get(expr.id)
        if isinstance(expr, ast.Attribute):
            base = self._infer_expr(expr.value, locals_, fi)
            if base is not None and base[0] == "cls":
                ci = self._class_for(base[1], fi)
                if ci is not None and expr.attr in ci.attr_types:
                    ann = ci.attr_types[expr.attr]
                    if isinstance(ann, ast.Name) and ann.id in classes:
                        return ("cls", ann.id)
                    return _ann_to_type(ann, classes)
            return None
        if isinstance(expr, ast.Subscript):
            base = self._infer_expr(expr.value, locals_, fi)
            if base is not None and base[0] in ("list", "dict"):
                return base[1]
            return None
        if isinstance(expr, ast.Call):
            fn = expr.func
            if isinstance(fn, ast.Name) and fn.id in classes:
                return ("cls", fn.id)
            if isinstance(fn, ast.Attribute):
                if fn.attr in ("get", "pop"):
                    base = self._infer_expr(fn.value, locals_, fi)
                    if base is not None and base[0] == "dict":
                        return base[1]
                target = self._resolve_method(fn, locals_, fi)
                if target is not None:
                    return _ann_to_type(
                        getattr(target.node, "returns", None), classes)
            return None
        return None

    # -- call resolution -----------------------------------------------------

    def _class_for(self, name: str, fi: FuncInfo) -> Optional[ClassInfo]:
        """Resolve a class NAME, preferring the function's own class —
        so `self.` calls inside a shadowed duplicate class resolve to
        that class, not its primary namesake."""
        if fi.cls is not None and fi.cls.name == name:
            return fi.cls
        return self.classes.get(name)

    def _resolve_method(self, fn: ast.Attribute, locals_,
                        fi: FuncInfo) -> Optional[FuncInfo]:
        base = self._infer_expr(fn.value, locals_, fi)
        if base is None or base[0] != "cls":
            return None
        ci = self._class_for(base[1], fi)
        if ci is None:
            return None
        return ci.methods.get(fn.attr)

    def resolve_call(self, call: ast.Call, locals_,
                     fi: FuncInfo) -> list[FuncInfo]:
        fn = call.func
        if isinstance(fn, ast.Name):
            if fn.id in self.classes:
                init = self.classes[fn.id].methods.get("__init__")
                return [init] if init is not None else []
            f = self.functions.get(fn.id)
            return [f] if f is not None else []
        if isinstance(fn, ast.Attribute):
            target = self._resolve_method(fn, locals_, fi)
            return [target] if target is not None else []
        return []

    # -- per-function facts + fixpoints --------------------------------------

    def analyze(self) -> None:
        for fi in self.funcs_by_qual.values():
            self._collect_facts(fi)
        self._fix_acquires()
        self._fix_blocking()

    def _resolve_lock_item(self, expr, locals_, fi: FuncInfo):
        """(key, reentrant) for a with-item context expression that is a
        lock acquisition, (None, True) for an unresolvable lockish
        receiver (region still counts, no graph edge), or None when the
        with-item is not a lock at all."""
        if isinstance(expr, ast.Name):
            if LOCKISH.search(expr.id):
                return fi.module.module_locks.get(expr.id, (None, True))
            return None
        if not (isinstance(expr, ast.Attribute)
                and LOCKISH.search(expr.attr)):
            return None
        base = self._infer_expr(expr.value, locals_, fi)
        if base is not None and base[0] == "cls":
            ci = self.classes.get(base[1])
            if ci is not None and expr.attr in ci.locks:
                return ci.locks[expr.attr]
        # fall back to the attr name iff exactly one modeled class owns
        # a lock under it — `_cv` is unique, `_lock` is not
        owners = [ci.locks[expr.attr] for ci in self.classes.values()
                  if expr.attr in ci.locks]
        if len(owners) == 1:
            return owners[0]
        return (None, True)

    def _collect_facts(self, fi: FuncInfo) -> None:
        locals_ = self._infer_locals(fi)
        fi._locals = locals_
        for n in _walk_skip_nested(fi.node, skip_root=True):
            if isinstance(n, (ast.With, ast.AsyncWith)):
                for item in n.items:
                    lk = self._resolve_lock_item(
                        item.context_expr, locals_, fi)
                    if lk is not None and lk[0] is not None:
                        fi.direct_acquires.add(lk[0])
            elif isinstance(n, ast.Call):
                reason = _blocking_reason(n)
                if reason is not None and _dotted_last(n.func) not in (
                        "wait", "wait_for"):
                    fi.direct_blocking.append((n.lineno, reason))
                for callee in self.resolve_call(n, locals_, fi):
                    fi.callees.add(callee.qual)

    def _fix_acquires(self) -> None:
        for fi in self.funcs_by_qual.values():
            fi.may_acquire = set(fi.direct_acquires)
        changed = True
        while changed:
            changed = False
            for fi in self.funcs_by_qual.values():
                for c in fi.callees:
                    extra = self.funcs_by_qual[c].may_acquire - \
                        fi.may_acquire
                    if extra:
                        fi.may_acquire |= extra
                        changed = True

    def _fix_blocking(self) -> None:
        for fi in self.funcs_by_qual.values():
            if fi.direct_blocking:
                fi.blocking_chain = fi.direct_blocking[0][1]
        changed = True
        while changed:
            changed = False
            for fi in self.funcs_by_qual.values():
                if fi.blocking_chain is not None:
                    continue
                for c in fi.callees:
                    chain = self.funcs_by_qual[c].blocking_chain
                    if chain is not None:
                        fi.blocking_chain = f"{c} → {chain}"
                        changed = True
                        break


def _walk_skip_nested(root: ast.AST, skip_root: bool = False):
    """ast.walk that does not descend into nested function/lambda/class
    bodies — what lexically executes in THIS frame."""
    stack = [root]
    first = True
    while stack:
        n = stack.pop()
        if not (first and skip_root):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
                continue
            yield n
        first = False
        stack.extend(ast.iter_child_nodes(n))


# -- the audit engine ---------------------------------------------------------


class _Auditor:
    """Walks every threaded-module function with the lock-held region
    state, emitting acquisition-graph edges and the per-site findings."""

    def __init__(self, prog: Program):
        self.prog = prog
        self.raw: list[Finding] = []

    def run(self) -> None:
        for fi in self.prog.funcs_by_qual.values():
            if not fi.module.threaded:
                continue
            held: list = []
            if fi.caller_holds:
                locks = list(fi.cls.locks.values())
                if len(locks) == 1:
                    # *_locked: the caller holds THE class lock
                    held = [(locks[0][0], locks[0][1], fi.node.lineno)]
                else:
                    # multi-lock class: WHICH lock the caller holds is
                    # unknowable from the name — keep the lock-held
                    # region (blocking findings still fire) but
                    # fabricate no graph edges for it
                    held = [(None, True, fi.node.lineno)]
            self._walk(fi, list(fi.node.body), held)
        self._lock_order_findings()
        for mod in self.prog.modules:
            if mod.threaded:
                self._lock_leak(mod)
        self._shared_without_lock()

    # -- region walking ------------------------------------------------------

    def _walk(self, fi: FuncInfo, stmts: list, held: list) -> None:
        for s in stmts:
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                continue
            if isinstance(s, (ast.With, ast.AsyncWith)):
                new = []
                for item in s.items:
                    self._exprs(fi, item.context_expr, held)
                    lk = self.prog._resolve_lock_item(
                        item.context_expr, fi._locals, fi)
                    if lk is not None:
                        key, reentrant = lk
                        if key is not None:
                            self._acquire_edges(fi, key, reentrant,
                                                held, s.lineno)
                        new.append((key, reentrant, s.lineno))
                self._walk(fi, s.body, held + new)
                continue
            for _, value in ast.iter_fields(s):
                if isinstance(value, list) and value and isinstance(
                        value[0], ast.stmt):
                    self._walk(fi, value, held)
                elif isinstance(value, list):
                    for v in value:
                        if isinstance(v, ast.excepthandler):
                            self._walk(fi, v.body, held)
                        elif isinstance(v, ast.AST):
                            self._exprs(fi, v, held)
                elif isinstance(value, ast.AST):
                    self._exprs(fi, value, held)

    def _acquire_edges(self, fi: FuncInfo, key: str, reentrant: bool,
                       held: list, line: int) -> None:
        for hkey, hre, _ in held:
            if hkey is None:
                continue
            if hkey == key:
                if not reentrant:
                    self.raw.append(Finding(
                        "lock-order", Severity.ERROR, fi.module.path,
                        line,
                        f"`{fi.qual}` acquires non-reentrant lock "
                        f"`{key}` while already holding it — a "
                        "self-deadlock (use an RLock, or restructure)"))
                continue  # re-entrant same-key: the sanctioned re-entry
            self.prog.edges.setdefault(
                (hkey, key),
                (fi.module.path, line, f"`{fi.qual}` acquires `{key}` "
                 f"while holding `{hkey}`"))

    def _exprs(self, fi: FuncInfo, node: ast.AST, held: list) -> None:
        if not held:
            return
        for n in _walk_skip_nested(node):
            if not isinstance(n, ast.Call):
                continue
            callees = self.prog.resolve_call(n, fi._locals, fi)
            # graph edges: everything the callee may transitively acquire
            for c in callees:
                for key in c.may_acquire:
                    self._acquire_edges(
                        fi, key,
                        self.prog.lock_reentrant.get(key, True),
                        held, n.lineno)
            # blocking findings: direct primitive, or a resolved callee
            # that (transitively) blocks — same-class *_locked callees
            # report inside their own body, not at every caller
            reason = _blocking_reason(n)
            name = _dotted_last(n.func)
            if name in ("wait", "wait_for", "notify", "notify_all"):
                continue
            hkeys = sorted({k for k, _, _ in held if k is not None}) or \
                ["<unresolved lock>"]
            if reason is not None:
                self.raw.append(Finding(
                    "blocking-under-lock", Severity.WARNING,
                    fi.module.path, n.lineno,
                    f"`{fi.qual}` holds {', '.join(hkeys)} while "
                    f"{reason} — every contending thread stalls behind "
                    "it (move the work outside the lock, or pragma the "
                    "reasoned exception)"))
                continue
            for c in callees:
                if c.blocking_chain is None:
                    continue
                if (fi.cls is not None and c.cls is fi.cls
                        and c.name.endswith("_locked")):
                    continue  # reported inside the helper's own region
                self.raw.append(Finding(
                    "blocking-under-lock", Severity.WARNING,
                    fi.module.path, n.lineno,
                    f"`{fi.qual}` holds {', '.join(hkeys)} while "
                    f"calling `{c.qual}`, which blocks "
                    f"({c.blocking_chain}) — every contending thread "
                    "stalls behind it (move the call outside the lock, "
                    "or pragma the reasoned exception)"))
                break

    # -- lock-order (cycles) -------------------------------------------------

    def _lock_order_findings(self) -> None:
        graph: dict[str, set] = {}
        for (a, b) in self.prog.edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        for scc in _sccs(graph):
            if len(scc) < 2:
                continue
            cyc = " → ".join(sorted(scc)) + " → …"
            for (a, b), (path, line, desc) in sorted(
                    self.prog.edges.items(),
                    key=lambda kv: (kv[1][0], kv[1][1])):
                if a in scc and b in scc:
                    self.raw.append(Finding(
                        "lock-order", Severity.ERROR, path, line,
                        f"lock-order cycle [{cyc}]: {desc}, but another "
                        "path nests them the opposite way — a potential "
                        "deadlock; pick ONE global order"))

    # -- lock-leak -----------------------------------------------------------

    def _lock_leak(self, mod: ModuleInfo) -> None:
        for n in ast.walk(mod.tree):
            if not (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "acquire"):
                continue
            recv = n.func.value
            recv_name = _dotted_last(recv)
            if recv_name is None or not LOCKISH.search(recv_name):
                continue
            if self._released_in_finally(mod, n, recv):
                continue
            self.raw.append(Finding(
                "lock-leak", Severity.ERROR, mod.path, n.lineno,
                f"bare `.acquire()` on `{ast.unparse(recv)}` without a "
                "`with` block or try/finally release — any exception "
                "before the release leaves the lock held forever"))

    @staticmethod
    def _released_in_finally(mod: ModuleInfo, call: ast.Call,
                             recv: ast.AST) -> bool:
        """True when the enclosing function has SOME ``try`` whose
        ``finally`` releases this receiver — covers both the
        acquire-inside-try and the idiomatic acquire-then-try shapes."""
        want = ast.unparse(recv)
        cur = mod.parents.get(call)
        fn = None
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fn = cur
                break
            cur = mod.parents.get(cur)
        scope = fn if fn is not None else mod.tree
        for t in ast.walk(scope):
            if not (isinstance(t, ast.Try) and t.finalbody):
                continue
            for n in ast.walk(ast.Module(body=t.finalbody,
                                         type_ignores=[])):
                if (isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr == "release"
                        and ast.unparse(n.func.value) == want):
                    return True
        return False

    # -- thread-shared-without-lock ------------------------------------------

    def _shared_without_lock(self) -> None:
        for ci in self.prog.classes.values():
            if not ci.module.threaded or not ci.thread_targets:
                continue
            pump = self._role_closure(ci, ci.thread_targets)
            client = self._role_closure(
                ci, {m for m in ci.methods
                     if not m.startswith("_")} - pump)
            pump_only = pump - client
            client_only = client - pump
            # attr → {"w": [(method, line, locked)], "r": [...]}
            acc: dict[str, dict] = {}
            for mname, fi in ci.methods.items():
                locked_default = fi.caller_holds
                for n in _walk_skip_nested(fi.node, skip_root=True):
                    locked = locked_default or under_lock_with(
                        ci.module.parents, n, fi.node)
                    for t in self_write_targets(n):
                        if isinstance(t, ast.Attribute):
                            acc.setdefault(t.attr, {"w": [], "r": []})[
                                "w"].append((mname, n.lineno, locked))
                    if (isinstance(n, ast.Attribute)
                            and isinstance(n.ctx, ast.Load)
                            and isinstance(n.value, ast.Name)
                            and n.value.id == "self"):
                        acc.setdefault(n.attr, {"w": [], "r": []})[
                            "r"].append((mname, n.lineno, locked))
            for attr, sites in sorted(acc.items()):
                if attr in ci.locks or LOCKISH.search(attr):
                    continue
                writes = [s for s in sites["w"] if s[0] != "__init__"]
                if not writes:
                    continue  # construction happens-before thread start
                if any(locked for _, _, locked in
                       sites["w"] + sites["r"]):
                    continue  # some lock discipline exists → layer 1's
                w_roles = {self._role(m, pump_only, client_only)
                           for m, _, _ in writes}
                r_roles = {self._role(m, pump_only, client_only)
                           for m, _, _ in sites["r"]}
                if ("pump" in w_roles and "client" in r_roles) or \
                        ("client" in w_roles and "pump" in r_roles):
                    m, line, _ = writes[0]
                    self.raw.append(Finding(
                        "thread-shared-without-lock", Severity.WARNING,
                        ci.module.path, line,
                        f"`{ci.name}.{attr}` is written in "
                        f"`{m}` and read across the pump/client thread "
                        "boundary with no lock at ANY access site — a "
                        "torn read is a matter of scheduling (guard "
                        "both sides with the class lock)"))

    def _role_closure(self, ci: ClassInfo, seeds: set) -> set:
        out = set(seeds)
        changed = True
        while changed:
            changed = False
            for m in list(out):
                fi = ci.methods.get(m)
                if fi is None:
                    continue
                for c in fi.callees:
                    cfi = self.prog.funcs_by_qual.get(c)
                    if (cfi is not None and cfi.cls is ci
                            and cfi.name not in out):
                        out.add(cfi.name)
                        changed = True
        return out

    @staticmethod
    def _role(method: str, pump_only: set, client_only: set) -> str:
        if method in pump_only:
            return "pump"
        if method in client_only:
            return "client"
        return "shared"


def _sccs(graph: dict) -> list[set]:
    """Tarjan's strongly connected components, iterative."""
    index: dict = {}
    low: dict = {}
    on_stack: set = set()
    stack: list = []
    out: list[set] = []
    counter = [0]

    for root in graph:
        if root in index:
            continue
        work = [(root, iter(sorted(graph[root])))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(sorted(graph[nxt]))))
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = set()
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.add(w)
                    if w == node:
                        break
                out.append(comp)
    return out


# -- entry points -------------------------------------------------------------


def build_program(sources: Iterable[tuple[str, str]]) -> Program:
    """Parse ``(source, path)`` pairs into one analyzable Program."""
    prog = Program()
    for source, path in sources:
        prog.add_module(source, path)
    prog.analyze()
    return prog


def audit_program(prog: Program,
                  rules: Optional[Iterable[str]] = None) -> list[Finding]:
    """Run the four concurrency rules over a built program; findings
    carry pragma suppression exactly like the AST lint's."""
    auditor = _Auditor(prog)
    auditor.run()
    raw = auditor.raw
    if rules is not None:
        want = set(rules)
        raw = [f for f in raw if f.rule in want]
    raw.sort(key=lambda f: (f.path, f.line, f.rule))
    by_mod = {m.path: m for m in prog.modules}
    out: list[Finding] = []
    for path in sorted({f.path for f in raw}):
        mod = by_mod.get(path)
        group = [f for f in raw if f.path == path]
        if mod is None:
            out.extend(group)
        else:
            out.extend(apply_pragmas(group, mod.pragmas, mod.lines))
    return out


def lint_concurrency_source(source: str,
                            path: str = "mpi_model_tpu_torch/fake.py",
                            rules: Optional[Iterable[str]] = None
                            ) -> list[Finding]:
    """Single-module fixture surface for the tests."""
    return audit_program(build_program([(source, path)]), rules)


def _package_sources(roots, rel_to=None) -> list[tuple[str, str]]:
    from .astlint import iter_py_files

    out = []
    for root in roots:
        for p in iter_py_files(root):
            parts = p.resolve().parts
            if "mpi_model_tpu_torch" not in parts:
                continue
            name = p.name
            if name.startswith("test_"):
                continue
            shown = str(p.relative_to(rel_to)) if rel_to else str(p)
            try:
                source = p.read_text()
                ast.parse(source, filename=shown)
            except (OSError, UnicodeDecodeError, SyntaxError):
                continue  # astlint's parse-error rule owns broken files
            out.append((source, shown))
    return out


def _default_roots() -> list[Path]:
    pkg = Path(__file__).resolve().parent.parent
    return [pkg]


def run_concurrency_audit(roots=None, rules=None,
                          rel_to=None) -> list[Finding]:
    """The layer-3 entry point: model every package module (cross-module
    call resolution needs the callees too), audit the threaded ones."""
    roots = list(roots) if roots else _default_roots()
    sources = _package_sources(roots, rel_to)
    if not sources:
        return []
    return audit_program(build_program(sources), rules)


def static_lock_graph(roots=None) -> set:
    """The acquisition-order edge set ``{(held_key, acquired_key), …}``
    over the package — what ``resilience.lockdep``'s armed witness
    asserts runtime acquisition orders against. Same-key re-entries are
    not edges here, so the witness still flags real cross-instance
    same-key nesting."""
    roots = list(roots) if roots else _default_roots()
    prog = build_program(_package_sources(roots))
    auditor = _Auditor(prog)
    auditor.run()
    return set(prog.edges)
