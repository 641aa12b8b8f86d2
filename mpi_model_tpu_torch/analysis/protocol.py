"""Protocol audit (layer 4): journal/wire vocabulary
conformance against the DECLARED protocol surfaces.

The first three layers check code shape: layer 1 lints one module's
AST, layer 2 audits what one step does on the device, layer 3 models the
whole program's locks. None of them can see the failure mode this layer
is about: a protocol whose writer and reader drift apart. A journal
record kind appended that no replay fold dispatches on, a meta key a
timeline reads that no append site stamps, an RPC the server handles
that no client ever sends — each is invisible module-locally, type
checks fine, and silently corrupts recovery the day a crash crosses
it.

This layer extracts both sides of every protocol conversation from the
package AST and checks them against the single sources of truth:

- ``ensemble.lifecycle`` — the declared ticket-lifecycle machines
  (record kinds, transitions, per-kind meta keys, terminal set, the
  FailureEvent kind set). Loaded standalone (stdlib-only by contract),
  never through the torch-laden ensemble package init.
- ``ensemble.wire`` — the declared RPC vocabulary
  (``REQUEST_KINDS``/``REPLY_KINDS``), read off the module AST.

Rules (registered in the shared registry; same CLI, pragmas and repo
gate as every other layer):

``journal-kind-drift`` (ERROR)
    a journal append site writes a record kind no machine declares, a
    reader fold dispatches on one, or (whole-package runs only) a
    declared kind is never written anywhere — the declaration and the
    code disagree about the stream vocabulary.
``journal-meta-drift`` (WARNING)
    a reader pulls a meta key (``rec.meta.get(...)``) no transition
    declares and no universal stamp provides, or a literal append meta
    stamps a key its kind's transition does not declare — the key will
    be silently None (reader side) or silently unread (writer side).
``rpc-asymmetry`` (ERROR)
    the member wire protocol's two halves disagree: a request kind the
    server dispatches that no client call site sends (dead handler), a
    kind a client sends that the server never dispatches (runtime
    ``err`` reply), a reply kind outside the declared vocabulary
    (``wire.send`` raises at runtime), or a reply meta field a client
    reads that no server code path stamps.
``rpc-no-deadline`` (ERROR)
    a raw wire ``.send(...)``/``.recv(...)`` on a conn-ish receiver
    with no ``deadline_s=`` decision — a dead peer turns the call into
    an unbounded stall. Passing an explicit ``deadline_s=None`` is a
    recorded decision and passes; saying nothing is not.
``terminal-coverage`` (ERROR)
    in a journaling class, a method removes a ticket from a ledger
    (``_route``/``_resolved``/``_hibernated``/…) without emitting any
    declared terminal or re-admission transition, calling a sanctioned
    resolution helper (``*_finalize*``/``*_resolve*``/``*_reclaim*``/
    ``*_readmit*``), or being a ``poll``-style result handoff — the
    ticket leaves the ledger with no journal evidence, so replay
    reconstructs a state the process never had.
``event-kind-coverage`` (ERROR)
    a ``FailureEvent(kind=...)`` constructed with a kind outside the
    declared :data:`lifecycle.EVENT_KINDS` — the supervisor taxonomy,
    the obs timeline and the analysis all dispatch on that set.

Extraction is resolution-based, never guessed: record kinds resolve
through string literals, lifecycle constants (``SERVED``,
``lifecycle.SERVED``), module-level constant assignments, single-
function local assignments and ``IfExp`` branches; an unresolvable
kind contributes nothing (the astlint ``journal-kind-literal`` rule
separately forbids raw literals at append sites, so the two rules
squeeze from both ends). Reader dispatch is anchored on the package's
journal-record convention (``rec.kind`` / ``record.kind``), so
``FailureEvent.kind`` and fault-plan dispatches never alias in.

The whole-package entry point is :func:`run_protocol_audit`;
:func:`lint_protocol_source` is the single-module fixture surface
(package-completeness directions — declared-but-never-written,
declared-but-unused request kinds — stay quiet there).
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, Optional

from .registry import (RULES, Finding, Rule, Severity, apply_pragmas,
                       collect_pragmas)

#: registry scope tag for the protocol rules (run by THIS engine over
#: writer/reader pairs, never by the per-module AST engine)
SCOPE_PROTOCOL = "protocol"


def _register(name: str, severity: Severity, doc: str,
              fix_hint: str = "") -> None:
    if name not in RULES:
        RULES[name] = Rule(name, severity, doc,
                           check=lambda ctx: (), scope=SCOPE_PROTOCOL,
                           fix_hint=fix_hint)


_register("journal-kind-drift", Severity.ERROR,
          "a journal record kind written or dispatched on that the "
          "declared lifecycle machines do not know (or, package-wide, "
          "a declared kind nothing writes) — writers, readers and the "
          "declaration must share one vocabulary",
          fix_hint="declare the kind as a lifecycle.Transition on its "
                   "machine (and write the site through the constant), "
                   "or fix the drifted literal")
_register("journal-meta-drift", Severity.WARNING,
          "a journal meta key read that no transition declares and no "
          "universal stamp provides (silently None forever), or a "
          "literal append meta stamping a key its kind does not "
          "declare (silently unread forever)",
          fix_hint="add the key to the owning Transition's meta tuple "
                   "in ensemble/lifecycle.py, or stop reading/stamping "
                   "it")
_register("rpc-asymmetry", Severity.ERROR,
          "the member RPC protocol's halves disagree: a handled "
          "request kind no client sends, a sent kind no server "
          "handles, an undeclared reply kind, or a reply field read "
          "that no server stamps",
          fix_hint="make the server dispatch, the client call sites "
                   "and wire.REQUEST_KINDS/REPLY_KINDS agree — delete "
                   "the dead half or add the missing one")
_register("rpc-no-deadline", Severity.ERROR,
          "a raw wire .send()/.recv() with no deadline_s decision "
          "turns a dead peer into an unbounded stall; an explicit "
          "deadline_s=None records the decision to block",
          fix_hint="pass deadline_s=<seconds> (or an explicit "
                   "deadline_s=None with the blocking rationale in a "
                   "comment)")
_register("terminal-coverage", Severity.ERROR,
          "a journaling class removes a ticket from a ledger on a "
          "path that journals no terminal or re-admission transition "
          "— replay would reconstruct a ticket state the process "
          "never had",
          fix_hint="journal a declared terminal/re-admission kind on "
                   "that path, or route the removal through a "
                   "*_finalize/*_resolve/*_reclaim/*_readmit helper "
                   "that does")
_register("event-kind-coverage", Severity.ERROR,
          "a FailureEvent constructed with a kind outside the "
          "declared lifecycle.EVENT_KINDS set — the supervisor, the "
          "timeline and the failure taxonomy all dispatch on it",
          fix_hint="use a declared EVENT_KINDS member, or extend the "
                   "set in ensemble/lifecycle.py if the taxonomy "
                   "genuinely grew")


# -- declared-vocabulary loaders ----------------------------------------------

_LIFECYCLE = None


def _lifecycle():
    """The declared machines, loaded STANDALONE from
    ``ensemble/lifecycle.py`` (stdlib-only by contract) — importing it
    through the package would execute ``ensemble/__init__`` and pull
    torch into a lint run."""
    global _LIFECYCLE
    if _LIFECYCLE is None:
        import importlib.util
        import sys

        path = (Path(__file__).resolve().parent.parent
                / "ensemble" / "lifecycle.py")
        spec = importlib.util.spec_from_file_location(
            "_mpi_model_torch_lifecycle_decl", path)
        mod = importlib.util.module_from_spec(spec)
        # dataclass construction resolves the defining module through
        # sys.modules — register before exec, like importlib itself
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        _LIFECYCLE = mod
    return _LIFECYCLE


_WIRE_VOCAB = None


def _wire_vocab() -> tuple[tuple, tuple]:
    """``(REQUEST_KINDS, REPLY_KINDS)`` read off ``ensemble/wire.py``'s
    AST — the declaration is a pair of literal tuples, and parsing
    keeps the audit import-free."""
    global _WIRE_VOCAB
    if _WIRE_VOCAB is None:
        path = (Path(__file__).resolve().parent.parent
                / "ensemble" / "wire.py")
        found = {"REQUEST_KINDS": (), "REPLY_KINDS": ()}
        for node in ast.parse(path.read_text()).body:
            if not isinstance(node, ast.Assign):
                continue
            for tgt in node.targets:
                if (isinstance(tgt, ast.Name) and tgt.id in found
                        and isinstance(node.value, ast.Tuple)):
                    found[tgt.id] = tuple(
                        e.value for e in node.value.elts
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str))
        _WIRE_VOCAB = (found["REQUEST_KINDS"], found["REPLY_KINDS"])
    return _WIRE_VOCAB


def _declared_kinds() -> frozenset:
    lc = _lifecycle()
    out = set()
    for m in lc.MACHINES.values():
        out.update(m.kinds())
    return frozenset(out)


def _declared_meta_keys() -> frozenset:
    lc = _lifecycle()
    out = set()
    for m in lc.MACHINES.values():
        out |= m.meta_keys()
    return frozenset(out)


def _kind_meta(kind: str) -> Optional[frozenset]:
    """Declared meta keys for ``kind`` (union over machines declaring
    it) plus the universal stamps; None when no machine declares it."""
    lc = _lifecycle()
    out: Optional[set] = None
    for m in lc.MACHINES.values():
        t = m.transition(kind)
        if t is not None:
            out = (out or set(lc.STAMPED_META)) | set(t.meta)
    return frozenset(out) if out is not None else None


def _resolution_kinds() -> frozenset:
    """Kinds whose journal record accounts for a ticket leaving a
    ledger: every terminal plus every declared re-admission/attribution
    transition (non-initial sources — migrate/readmit/wake/requeue)."""
    lc = _lifecycle()
    out = set()
    for m in lc.MACHINES.values():
        out.update(m.terminal_kinds())
        out.update(m.attribution_kinds())
    return frozenset(out)


# -- expression → record-kind resolution --------------------------------------

#: same-class helpers that append a journal record (the package's two
#: naming conventions; ``.append`` on a journal-ish receiver also
#: counts — see ``_append_call_kind``)
_APPEND_HELPERS = ("_journal_append_locked", "_append_locked")

_JOURNALISH = ("journal",)


def _terminal_name(node: ast.AST) -> str:
    """The last name segment of a receiver chain (``self.a.journal`` →
    ``journal``)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _is_append_call(call: ast.Call) -> bool:
    fn = call.func
    if isinstance(fn, ast.Attribute):
        if fn.attr in _APPEND_HELPERS:
            return True
        if fn.attr == "append":
            recv = _terminal_name(fn.value).lower()
            return any(tok in recv for tok in _JOURNALISH)
        return False
    if isinstance(fn, ast.Name):
        return fn.id in _APPEND_HELPERS
    return False


def _module_const_map(tree: ast.Module) -> dict:
    """Module-level ``NAME = "literal"`` assignments (how a module may
    alias a kind without importing the constant)."""
    out: dict = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            out[node.targets[0].id] = {node.value.value}
    return out


def _local_str_map(fn: ast.AST, module_map: dict) -> dict:
    """name → set of possible string values for single-name locals
    assigned from resolvable expressions inside ``fn`` (multiple
    assignments union — the if/elif kind-classifier shape); a name with
    ANY unresolvable assignment maps to None."""
    out: dict = {}
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        name = node.targets[0].id
        vals = _const_strs(node.value, module_map, {})
        if name in out and out[name] is not None and vals is not None:
            out[name] = out[name] | vals
        else:
            out[name] = vals if name not in out else None
    return out


def _const_strs(node: ast.AST, module_map: dict,
                local_map: dict) -> Optional[set]:
    """All string values ``node`` can take, resolved through literals,
    IfExp branches, module constants, function locals and lifecycle
    declarations — None when any path is unresolvable."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, ast.IfExp):
        a = _const_strs(node.body, module_map, local_map)
        b = _const_strs(node.orelse, module_map, local_map)
        return a | b if a is not None and b is not None else None
    if isinstance(node, ast.Name):
        if node.id in local_map:
            return local_map[node.id]
        if node.id in module_map:
            return module_map[node.id]
        if node.id.isupper():
            v = getattr(_lifecycle(), node.id, None)
            if isinstance(v, str):
                return {v}
        return None
    if isinstance(node, ast.Attribute) and node.attr.isupper():
        v = getattr(_lifecycle(), node.attr, None)
        if isinstance(v, str):
            return {v}
    return None


# -- per-module fact extraction -----------------------------------------------

#: ticket ledgers whose removals must leave journal evidence
_LEDGERS = frozenset({
    "_route", "_resolved", "_results", "_pending",
    "_hib_meta", "_hib_resolved", "_hibernated",
})

#: same-class helpers sanctioned to own the journal evidence for a
#: removal routed through them
_RESOLUTION_HELPER = ("finalize", "resolve", "reclaim", "readmit")

#: method names that hand an ALREADY-journaled resolution to the caller
#: (the terminal record landed before the result entered the ledger)
_HANDOFF_METHODS = ("poll",)


class _ModuleFacts:
    """Everything the six rules need from one module, in one walk."""

    def __init__(self, source: str, path: str):
        self.path = path
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.pragmas = collect_pragmas(self.lines)
        self.module_map = _module_const_map(self.tree)
        #: (kinds | None, line, literal_meta_keys | None)
        self.appends: list = []
        #: (literal, line) — ``rec.kind == "x"`` reader dispatches
        self.dispatches: list = []
        #: (key, line) — ``rec.meta.get("k")`` / ``rec.meta["k"]``
        self.meta_reads: list = []
        #: (kinds | None, line) — FailureEvent(kind=...) sites
        self.event_kinds: list = []
        #: (kind, line) — request kinds a *Server class dispatches on
        self.server_kinds: list = []
        #: (kind, line) — request kinds client call sites send
        self.client_kinds: list = []
        #: (kind, line) — reply kinds *Server classes send
        self.reply_kinds: list = []
        #: literal meta keys any server code path could stamp in a reply
        self.reply_sent_keys: set = set()
        #: (key, line) — reply meta fields read at client call sites
        self.reply_reads: list = []
        #: (line, attr) — .send/.recv on conn-ish receiver, no deadline
        self.no_deadline: list = []
        #: (ledger, line, method) — uncovered ledger removals
        self.uncovered_removals: list = []
        self._walk()

    # -- walking --------------------------------------------------------------

    def _walk(self) -> None:
        for node in self.tree.body:
            if isinstance(node, ast.ClassDef):
                self._walk_class(node)
        # module-level / free-function facts (fold helpers live outside
        # classes in journal.py)
        for fn in self._functions(self.tree, top_only=True):
            self._walk_function(fn, in_server=False)

    def _functions(self, root, top_only=False):
        out = []
        body = root.body if top_only else [root]
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append(node)
        return out

    def _walk_class(self, cls: ast.ClassDef) -> None:
        is_server = cls.name.endswith("Server")
        methods = [n for n in cls.body
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))]
        journaling = any(
            _is_append_call(c) for m in methods
            for c in ast.walk(m) if isinstance(c, ast.Call))
        for m in methods:
            self._walk_function(m, in_server=is_server)
            if journaling:
                self._check_removals(m)
        if is_server:
            self._collect_server_facts(cls, methods)

    def _walk_function(self, fn, in_server: bool) -> None:
        local_map = _local_str_map(fn, self.module_map)
        reply_vars = self._rpc_result_names(fn)
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                self._visit_call(node, local_map, in_server, reply_vars)
            elif isinstance(node, ast.Compare):
                self._visit_compare(node, in_server)
            elif isinstance(node, ast.Subscript):
                self._visit_subscript(node, reply_vars)
        # meta reads via literal for-loops: for k in ("a", "b"): m.get(k)
        self._visit_meta_loops(fn)

    # -- call/compare/subscript visitors --------------------------------------

    def _visit_call(self, node: ast.Call, local_map: dict,
                    in_server: bool, reply_vars: set) -> None:
        fn = node.func
        if _is_append_call(node) and node.args:
            kinds = _const_strs(node.args[0], self.module_map, local_map)
            meta_keys = None
            if len(node.args) > 1 and isinstance(node.args[1], ast.Dict):
                meta_keys = {k.value for k in node.args[1].keys
                             if isinstance(k, ast.Constant)
                             and isinstance(k.value, str)}
            self.appends.append((kinds, node.lineno, meta_keys))
            return
        if (isinstance(fn, ast.Name) and fn.id == "FailureEvent") or (
                isinstance(fn, ast.Attribute)
                and fn.attr == "FailureEvent"):
            for kw in node.keywords:
                if kw.arg == "kind":
                    kinds = _const_strs(kw.value, self.module_map,
                                        local_map)
                    if kinds is not None:  # unresolvable: never guessed
                        self.event_kinds.append((kinds, node.lineno))
            return
        if isinstance(fn, ast.Attribute) and fn.attr == "_rpc":
            if node.args and isinstance(node.args[0], ast.Constant):
                self.client_kinds.append(
                    (node.args[0].value, node.lineno))
            return
        if isinstance(fn, ast.Attribute) and fn.attr in ("send", "recv"):
            recv = _terminal_name(fn.value).lower()
            if "conn" not in recv:
                return
            if not any(kw.arg == "deadline_s" for kw in node.keywords):
                self.no_deadline.append((node.lineno, fn.attr))
            requests, replies = _wire_vocab()
            if (fn.attr == "send" and node.args
                    and isinstance(node.args[0], ast.Constant)):
                kind = node.args[0].value
                if in_server:
                    self.reply_kinds.append((kind, node.lineno))
                elif kind in requests:
                    self.client_kinds.append((kind, node.lineno))

    def _visit_compare(self, node: ast.Compare, in_server: bool) -> None:
        left = node.left
        lits = [c.value for c in node.comparators
                if isinstance(c, ast.Constant)
                and isinstance(c.value, str)]
        # tuple membership: kind in ("a", "b")
        for c in node.comparators:
            if isinstance(c, (ast.Tuple, ast.List, ast.Set)):
                lits.extend(e.value for e in c.elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, str))
        if not lits:
            return
        if (isinstance(left, ast.Attribute) and left.attr == "kind"
                and isinstance(left.value, ast.Name)
                and left.value.id in ("rec", "record")):
            for lit in lits:
                self.dispatches.append((lit, node.lineno))
        elif (in_server and isinstance(left, ast.Name)
                and left.id == "kind"):
            for lit in lits:
                self.server_kinds.append((lit, node.lineno))

    def _visit_subscript(self, node: ast.Subscript,
                         reply_vars: set) -> None:
        if not (isinstance(node.slice, ast.Constant)
                and isinstance(node.slice.value, str)):
            return
        v = node.value
        if isinstance(v, ast.Attribute) and v.attr == "meta":
            self.meta_reads.append((node.slice.value, node.lineno))
        elif isinstance(v, ast.Name) and v.id in reply_vars:
            self.reply_reads.append((node.slice.value, node.lineno))

    def _visit_meta_loops(self, fn) -> None:
        """``rec.meta.get("k")`` calls, plus key-Name resolution
        through literal for-loop tuples (the postmortem detail loop)."""
        loop_keys: dict = {}
        for node in ast.walk(fn):
            if (isinstance(node, ast.For)
                    and isinstance(node.target, ast.Name)
                    and isinstance(node.iter, (ast.Tuple, ast.List))):
                vals = {e.value for e in node.iter.elts
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)}
                if vals:
                    loop_keys[node.target.id] = vals
        reply_vars = self._rpc_result_names(fn)
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "get" and node.args):
            # .get on something other than a meta/reply mapping is not
            # this layer's business
                continue
            recv = node.func.value
            keys: set = set()
            if isinstance(node.args[0], ast.Constant) and isinstance(
                    node.args[0].value, str):
                keys = {node.args[0].value}
            elif (isinstance(node.args[0], ast.Name)
                    and node.args[0].id in loop_keys):
                keys = loop_keys[node.args[0].id]
            if not keys:
                continue
            if isinstance(recv, ast.Attribute) and recv.attr == "meta":
                for k in keys:
                    self.meta_reads.append((k, node.lineno))
            elif isinstance(recv, ast.Name) and recv.id in reply_vars:
                for k in keys:
                    self.reply_reads.append((k, node.lineno))

    # -- RPC plumbing ---------------------------------------------------------

    def _rpc_result_names(self, fn) -> set:
        """Local names bound to the meta slot of an RPC result
        (``kind, meta, arrays = self._rpc(...)`` /
        ``... = self._conn.recv(...)``)."""
        out: set = set()
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Tuple)
                    and len(node.targets[0].elts) == 3
                    and isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Attribute)):
                continue
            attr = node.value.func.attr
            recv = _terminal_name(node.value.func.value).lower()
            if attr == "_rpc" or (attr == "recv" and "conn" in recv):
                meta_t = node.targets[0].elts[1]
                if isinstance(meta_t, ast.Name) and meta_t.id != "_":
                    out.add(meta_t.id)
        return out

    def _collect_server_facts(self, cls: ast.ClassDef,
                              methods: list) -> None:
        """Every literal meta key any server path could stamp into a
        reply: dict-literal keys plus ``body["k"] = ...`` augmentations
        (a conservative superset — the asymmetry rule flags only reads
        OUTSIDE it, never a read it cannot prove missing)."""
        for node in ast.walk(cls):
            if isinstance(node, ast.Dict):
                self.reply_sent_keys.update(
                    k.value for k in node.keys
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str))
            elif (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Subscript)
                    and isinstance(node.targets[0].slice, ast.Constant)
                    and isinstance(node.targets[0].slice.value, str)):
                self.reply_sent_keys.add(node.targets[0].slice.value)

    # -- terminal-coverage ----------------------------------------------------

    def _check_removals(self, fn) -> None:
        removals = []
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "pop"
                    and isinstance(node.func.value, ast.Attribute)
                    and node.func.value.attr in _LEDGERS):
                removals.append((node.func.value.attr, node.lineno))
            elif isinstance(node, ast.Delete):
                for tgt in node.targets:
                    if (isinstance(tgt, ast.Subscript)
                            and isinstance(tgt.value, ast.Attribute)
                            and tgt.value.attr in _LEDGERS):
                        removals.append((tgt.value.attr, node.lineno))
        if not removals:
            return
        if any(fn.name == h or fn.name.startswith(h + "_")
               for h in _HANDOFF_METHODS):
            return
        local_map = _local_str_map(fn, self.module_map)
        resolution = _resolution_kinds()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if _is_append_call(node) and node.args:
                kinds = _const_strs(node.args[0], self.module_map,
                                    local_map)
                # an unresolvable kind still counts as evidence — the
                # rule flags silence, not ambiguity
                if kinds is None or kinds & resolution:
                    return
            if (isinstance(node.func, ast.Attribute)
                    and any(tok in node.func.attr
                            for tok in _RESOLUTION_HELPER)):
                return
        for ledger, line in removals:
            self.uncovered_removals.append((ledger, line, fn.name))


# -- the audit ----------------------------------------------------------------


def _audit(facts: list, rules: Optional[Iterable[str]],
           complete: bool) -> list:
    lc = _lifecycle()
    requests, replies = _wire_vocab()
    declared = _declared_kinds()
    declared_meta = _declared_meta_keys()
    raw: list[Finding] = []

    def emit(rule_id, path, line, msg):
        raw.append(Finding(rule_id, RULES[rule_id].severity, path,
                           line, msg))

    written: set = set()
    server_seen = any(m.server_kinds for m in facts)
    client_seen = any(m.client_kinds for m in facts)
    for m in facts:
        for kinds, line, meta_keys in m.appends:
            for k in sorted(kinds or ()):
                written.add(k)
                if k not in declared:
                    emit("journal-kind-drift", m.path, line,
                         f"append site writes record kind {k!r} that "
                         "no declared lifecycle machine knows")
                elif meta_keys is not None:
                    allowed = _kind_meta(k) or frozenset()
                    for key in sorted(meta_keys - allowed):
                        emit("journal-meta-drift", m.path, line,
                             f"append meta stamps key {key!r} that the "
                             f"{k!r} transition does not declare — no "
                             "reader can rely on it")
        for lit, line in m.dispatches:
            if lit not in declared:
                emit("journal-kind-drift", m.path, line,
                     f"reader dispatches on record kind {lit!r} that "
                     "no declared lifecycle machine knows")
        for key, line in m.meta_reads:
            if key not in declared_meta:
                emit("journal-meta-drift", m.path, line,
                     f"reader pulls meta key {key!r} that no declared "
                     "transition stamps — it will be None forever")
        for kinds, line in m.event_kinds:
            for k in sorted(kinds):
                if k not in lc.EVENT_KINDS:
                    emit("event-kind-coverage", m.path, line,
                         f"FailureEvent kind {k!r} is outside the "
                         "declared EVENT_KINDS set")
        for kind, line in m.client_kinds:
            if kind not in requests:
                emit("rpc-asymmetry", m.path, line,
                     f"client sends request kind {kind!r} outside "
                     "wire.REQUEST_KINDS — wire.send raises at "
                     "runtime")
        for kind, line in m.reply_kinds:
            if kind not in replies:
                emit("rpc-asymmetry", m.path, line,
                     f"server sends reply kind {kind!r} outside "
                     "wire.REPLY_KINDS — wire.send raises at runtime")
        for line, attr in m.no_deadline:
            emit("rpc-no-deadline", m.path, line,
                 f"wire .{attr}() with no deadline_s decision — a "
                 "dead peer stalls this call forever")
        for ledger, line, fname in m.uncovered_removals:
            emit("terminal-coverage", m.path, line,
                 f"{fname}() removes a ticket from {ledger} without "
                 "journaling any terminal/re-admission transition or "
                 "routing through a resolution helper")

    if server_seen and client_seen:
        handled = {k for m in facts for k, _ in m.server_kinds}
        called = {k for m in facts for k, _ in m.client_kinds}
        sent_keys = set()
        for m in facts:
            sent_keys |= m.reply_sent_keys
        for m in facts:
            for kind, line in m.server_kinds:
                if kind not in called:
                    emit("rpc-asymmetry", m.path, line,
                         f"server handles request kind {kind!r} that "
                         "no client call site ever sends (dead "
                         "handler)")
            for kind, line in m.client_kinds:
                if kind not in handled:
                    emit("rpc-asymmetry", m.path, line,
                         f"client sends request kind {kind!r} the "
                         "server never dispatches on — every call "
                         "gets the unknown-RPC err reply")
            for key, line in m.reply_reads:
                if key not in sent_keys:
                    emit("rpc-asymmetry", m.path, line,
                         f"client reads reply field {key!r} that no "
                         "server code path stamps — it is never "
                         "present")
        if complete:
            anchor = next((m for m in facts if m.server_kinds), None)
            for kind in requests:
                if kind not in handled and kind not in called:
                    emit("rpc-asymmetry", anchor.path, 1,
                         f"wire.REQUEST_KINDS declares {kind!r} but "
                         "nothing handles or sends it")

    if complete and written:
        lc_path = None
        for m in facts:
            if m.path.replace("\\", "/").endswith(
                    "ensemble/lifecycle.py"):
                lc_path = m.path
        for kind in sorted(declared - written):
            emit("journal-kind-drift",
                 lc_path or "mpi_model_tpu_torch/ensemble/lifecycle.py", 1,
                 f"lifecycle declares record kind {kind!r} but no "
                 "append site ever writes it")

    if rules is not None:
        want = set(rules)
        raw = [f for f in raw if f.rule in want]
    raw.sort(key=lambda f: (f.path, f.line, f.rule))
    by_mod = {m.path: m for m in facts}
    out: list[Finding] = []
    for path in sorted({f.path for f in raw}):
        mod = by_mod.get(path)
        group = [f for f in raw if f.path == path]
        if mod is None:
            out.extend(group)
        else:
            out.extend(apply_pragmas(group, mod.pragmas, mod.lines))
    return out


# -- entry points -------------------------------------------------------------


def lint_protocol_source(source: str,
                         path: str = "mpi_model_tpu_torch/fake.py",
                         rules: Optional[Iterable[str]] = None
                         ) -> list[Finding]:
    """Single-module fixture surface for the tests
    (package-completeness directions stay quiet here)."""
    return _audit([_ModuleFacts(source, path)], rules, complete=False)


def _default_roots() -> list[Path]:
    pkg = Path(__file__).resolve().parent.parent
    return [pkg]


def run_protocol_audit(roots=None, rules=None,
                       rel_to=None) -> list[Finding]:
    """The layer-4 entry point: extract writer/reader facts from every
    package module and audit them against the declared vocabularies."""
    from .concurrency import _package_sources

    roots = list(roots) if roots else _default_roots()
    facts = [_ModuleFacts(source, shown)
             for source, shown in _package_sources(roots, rel_to)]
    if not facts:
        return []
    return _audit(facts, rules, complete=True)
