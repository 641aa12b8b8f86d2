"""Rule registry, findings, severities and pragma suppressions — the
shared spine of the port's static-analysis subsystem.

Every check in the subsystem — AST lint rules (``astlint``), the
concurrency and protocol audits and the step contract audit
(``step_audit``) — registers here with a stable rule
id, a severity, and a one-line contract statement. The registry is what
makes the analyzer extensible: a new invariant is a ``@rule(...)``
function, and the CLI, the pragma machinery, the repo-gate test and the
docs rule table all pick it up without further wiring.

Suppressions are explicit and carry their justification in the source::

    except Exception as e:  # analysis: ignore[broad-except] — supervisor boundary

A pragma with no reason still suppresses its target (so a stale finding
cannot block an emergency fix) but raises a ``bare-pragma`` finding of
its own: the acceptance bar is *zero unsuppressed findings AND every
suppression carries a reason*.
"""

from __future__ import annotations

import dataclasses
import enum
import re
from typing import Callable, Optional


class Severity(enum.Enum):
    """``ERROR`` gates every run; ``WARNING`` gates ``--strict`` runs
    (the tier-1 repo gate runs strict, so both block a PR — the split
    exists so ad-hoc non-strict runs surface the hard invariants
    first)."""

    ERROR = "error"
    WARNING = "warning"

    def __str__(self) -> str:  # "error", not "Severity.ERROR", in reports
        return self.value


#: which files a rule runs over: the whole tree, only package sources,
#: or only test modules (``tests/test_*.py``)
SCOPE_ALL = "all"
SCOPE_PACKAGE = "package"
SCOPE_TESTS = "tests"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One concrete violation, anchored to a file line (AST rules) or a
    pseudo-path like ``step:<impl>`` (contract audits)."""

    rule: str
    severity: Severity
    path: str
    line: int
    message: str
    suppressed: bool = False
    suppress_reason: Optional[str] = None

    def format(self) -> str:
        sup = "  [suppressed]" if self.suppressed else ""
        return (f"{self.path}:{self.line}: {self.severity}"
                f" [{self.rule}] {self.message}{sup}")

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "severity": str(self.severity),
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "suppressed": self.suppressed,
            "suppress_reason": self.suppress_reason,
        }


@dataclasses.dataclass(frozen=True)
class Rule:
    """A registered check. ``check`` receives a ``ModuleCtx`` (see
    ``astlint``) and yields raw findings; the engine applies pragma
    suppression afterwards, so rules never reason about pragmas."""

    name: str
    severity: Severity
    doc: str
    check: Callable
    scope: str = SCOPE_ALL
    #: one actionable sentence — what to change (or which pragma to
    #: write) when the rule fires; rides every ``--json`` finding as
    #: ``fix_hint`` so a CI consumer can surface the remedy inline
    fix_hint: str = ""


#: rule-id → Rule, in registration order (reports keep this order)
RULES: dict[str, Rule] = {}

#: registry scope tag for findings the ENGINE synthesizes (never run as
#: checks themselves, but registered so --list-rules/--rule know them)
SCOPE_ENGINE = "engine"

RULES["bare-pragma"] = Rule(
    "bare-pragma", Severity.ERROR,
    "a suppression pragma with no reason (synthesized by the engine "
    "whenever a reasonless pragma actually fires)",
    check=lambda ctx: (), scope=SCOPE_ENGINE,
    fix_hint="append the justification: `# analysis: ignore[rule] — "
             "why this is safe`")
RULES["parse-error"] = Rule(
    "parse-error", Severity.ERROR,
    "a scanned file failed to parse or read (synthesized by the "
    "engine; a broken file cannot be linted and must not pass silently)",
    check=lambda ctx: (), scope=SCOPE_ENGINE,
    fix_hint="fix the syntax error (or delete the file) — a broken "
             "module can neither run nor be audited")


def rule(name: str, severity: Severity, doc: str,
         scope: str = SCOPE_ALL, fix_hint: str = "") -> Callable:
    """Register an AST rule::

        @rule("broad-except", Severity.ERROR, "…contract…")
        def check_broad_except(ctx): ...
    """
    if scope not in (SCOPE_ALL, SCOPE_PACKAGE, SCOPE_TESTS):
        raise ValueError(f"unknown rule scope {scope!r}")

    def deco(fn: Callable) -> Callable:
        if name in RULES:
            raise ValueError(f"duplicate rule id {name!r}")
        RULES[name] = Rule(name, severity, doc, fn, scope,
                           fix_hint=fix_hint)
        return fn

    return deco


# -- pragma suppressions ------------------------------------------------------

#: ``# analysis: ignore[rule-a, rule-b] — reason`` (reason separator may
#: be an em/en dash, a hyphen run, or a colon; the reason is REQUIRED
#: for a clean strict run — see ``bare-pragma``)
PRAGMA_RE = re.compile(
    r"#\s*analysis:\s*ignore\[([A-Za-z0-9_\-, ]+)\]"
    r"(?:\s*(?:[—–]|--+|-|:)\s*(\S.*))?")


@dataclasses.dataclass(frozen=True)
class Pragma:
    line: int
    rules: tuple[str, ...]
    reason: Optional[str]
    own_line: bool  # a comment-only line also covers the NEXT code line


def _comment_lines(lines: list[str]) -> Optional[dict[int, int]]:
    """1-indexed line → column of the REAL comment token on it, via the
    tokenizer — so pragma text inside a string/docstring (e.g. pasted
    documentation of the pragma syntax) can never suppress a finding.
    None when tokenization fails (caller falls back to the line scan)."""
    import io
    import tokenize
    out: dict[int, int] = {}
    try:
        for tok in tokenize.generate_tokens(
                io.StringIO("\n".join(lines)).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.start[1]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return None
    return out


def collect_pragmas(lines: list[str]) -> dict[int, Pragma]:
    """1-indexed line → Pragma for every suppression comment in the
    module source."""
    comments = _comment_lines(lines)
    out: dict[int, Pragma] = {}
    for i, text in enumerate(lines, start=1):
        if comments is None:  # tokenizer fallback: line heuristic
            comment, own = text, text.lstrip().startswith("#")
        else:
            col = comments.get(i)
            if col is None:
                continue  # no real comment token on this line
            comment, own = text[col:], text[:col].strip() == ""
        m = PRAGMA_RE.search(comment)
        if not m:
            continue
        names = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        reason = m.group(2).strip() if m.group(2) else None
        out[i] = Pragma(i, names, reason, own)
    return out


def pragma_for(pragmas: dict[int, Pragma], rule_name: str, line: int,
               lines: Optional[list[str]] = None) -> Optional[Pragma]:
    """The pragma suppressing ``rule_name`` at ``line``: a trailing
    pragma on the line itself, or a comment-only pragma in the
    contiguous comment block directly above it."""
    p = pragmas.get(line)
    if p is not None and rule_name in p.rules:
        return p
    # scan upward through the comment block above the construct
    cand = line - 1
    while cand >= 1:
        text = lines[cand - 1] if lines and cand <= len(lines) else ""
        if not text.lstrip().startswith("#"):
            break
        p = pragmas.get(cand)
        if p is not None and p.own_line and rule_name in p.rules:
            return p
        cand -= 1
    return None


def apply_pragmas(findings: list[Finding], pragmas: dict[int, Pragma],
                  lines: Optional[list[str]] = None) -> list[Finding]:
    """Mark suppressed findings and append a ``bare-pragma`` finding for
    every suppression that actually fired without carrying a reason."""
    out: list[Finding] = []
    bare_seen: set[int] = set()
    for f in findings:
        p = pragma_for(pragmas, f.rule, f.line, lines)
        if p is None:
            out.append(f)
            continue
        out.append(dataclasses.replace(
            f, suppressed=True, suppress_reason=p.reason))
        if p.reason is None and p.line not in bare_seen:
            bare_seen.add(p.line)
            out.append(Finding(
                "bare-pragma", Severity.ERROR, f.path, p.line,
                f"suppression of [{', '.join(p.rules)}] carries no reason "
                "— write `# analysis: ignore[rule] — why this is safe`"))
    return out
