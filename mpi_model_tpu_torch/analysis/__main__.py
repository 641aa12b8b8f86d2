"""``python -m mpi_model_tpu_torch.analysis`` — run the static-analysis
gate over the port.

Default mode runs the AST lint, the concurrency audit and the protocol
audit and gates on ERROR-severity findings. ``--strict`` is the bar
(what the tier-1 test runs with ``--device cpu``, and ``chip_smoke.py``
on the card): WARNINGs gate too, and the step audit runs every
registered step contract on ``--device`` (the card by default). Exit
status 0 means zero unsuppressed findings at the selected bar.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .registry import RULES, SCOPE_ENGINE, Severity
from .astlint import run_astlint
from .concurrency import SCOPE_CONCURRENCY, run_concurrency_audit
from .protocol import SCOPE_PROTOCOL, run_protocol_audit
# registering the step contract rules is import-time cheap (torch loads
# lazily inside the audit) and makes --rule/--list-rules see the full
# rule table
from .step_audit import SCOPE_STEP, run_step_audit  # noqa: E402

#: what a bare invocation scans, relative to the repo root (the tests
#: stay under the JAX package's gate, which lints tests/ whole)
DEFAULT_ROOTS = ("mpi_model_tpu_torch", "chip_smoke.py")


def _repo_root() -> Path:
    # the package sits at <root>/mpi_model_tpu_torch/analysis
    return Path(__file__).resolve().parent.parent.parent


def _within(findings, paths):
    wanted = [Path(p).resolve() for p in paths]
    return [f for f in findings
            if any(rp == w or w in rp.parents
                   for w in wanted for rp in (Path(f.path).resolve(),))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="mpi-model-analyze-torch",
        description="AST lint + step contract audit + concurrency and "
        "protocol audits for mpi_model_tpu_torch")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the port and "
                    "chip_smoke.py)")
    ap.add_argument("--strict", action="store_true",
                    help="gate WARNINGs too and run the step audit")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable findings on stdout")
    ap.add_argument("--no-step", action="store_true",
                    help="skip the step audit even under --strict")
    ap.add_argument("--device", default=None,
                    help="where the step audit runs its steps: cuda "
                    "(default; raises with no card) or cpu")
    ap.add_argument("--rule", action="append", dest="rules",
                    metavar="RULE-ID",
                    help="restrict the analysis to these rule ids")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in RULES.values():
            print(f"{r.name:26} {r.severity!s:8} {r.scope:11} {r.doc}")
        return 0

    ast_rules = step_rules = conc_rules = proto_rules = None
    if args.rules:
        unknown = [r for r in args.rules if r not in RULES]
        if unknown:
            import difflib

            for u in unknown:
                hint = difflib.get_close_matches(u, RULES, n=1)
                print(f"unknown rule id: {u!r}"
                      + (f" — did you mean {hint[0]!r}?" if hint
                         else " (see --list-rules)"),
                      file=sys.stderr)
            return 2
        ast_rules = [r for r in args.rules
                     if RULES[r].scope not in (SCOPE_STEP,
                                               SCOPE_CONCURRENCY,
                                               SCOPE_PROTOCOL,
                                               SCOPE_ENGINE)]
        step_rules = [r for r in args.rules
                      if RULES[r].scope == SCOPE_STEP]
        conc_rules = [r for r in args.rules
                      if RULES[r].scope == SCOPE_CONCURRENCY]
        proto_rules = [r for r in args.rules
                       if RULES[r].scope == SCOPE_PROTOCOL]
        if not (ast_rules or step_rules or conc_rules or proto_rules):
            # engine-scope rules (bare-pragma, parse-error) are
            # SYNTHESIZED alongside real checks — selecting only them
            # would scan nothing and report a hollow pass
            print("rule selection contains only engine-synthesized "
                  f"rule(s) ({', '.join(args.rules)}) — they fire "
                  "alongside real checks and cannot run alone; add a "
                  "checkable rule id or drop --rule",
                  file=sys.stderr)
            return 2

    root = _repo_root()
    if args.paths:
        roots = [Path(p) for p in args.paths]
        rel_to = None
    else:
        roots = [root / p for p in DEFAULT_ROOTS if (root / p).exists()]
        rel_to = root

    findings = []
    if ast_rules or not args.rules:
        findings.extend(run_astlint(roots, rules=ast_rules,
                                    rel_to=rel_to))
    # layers 3 and 4 are whole-program: they always model the FULL
    # package (a path-scoped model would lose cross-module call
    # resolution and writer/reader pairs); named paths only filter the
    # report
    if conc_rules or not args.rules:
        conc = run_concurrency_audit(
            rules=conc_rules, rel_to=None if args.paths else rel_to)
        findings.extend(_within(conc, args.paths) if args.paths else conc)
    if proto_rules or not args.rules:
        proto = run_protocol_audit(
            rules=proto_rules, rel_to=None if args.paths else rel_to)
        findings.extend(_within(proto, args.paths) if args.paths
                        else proto)
    run_audit = (step_rules
                 or (args.strict and not args.no_step and not args.rules))
    if run_audit:
        audit = run_step_audit(device=args.device)
        if step_rules:
            audit = [f for f in audit if f.rule in step_rules]
        findings.extend(audit)

    gate = (lambda f: True) if args.strict else (
        lambda f: f.severity is Severity.ERROR)
    blocking = [f for f in findings if not f.suppressed and gate(f)]
    advisory = [f for f in findings if not f.suppressed and not gate(f)]
    suppressed = [f for f in findings if f.suppressed]

    if args.as_json:
        def enrich(f):
            # every JSON finding carries its rule's contract and the
            # remedy inline — a CI annotation needs no registry lookup
            d = f.to_json()
            r = RULES.get(f.rule)
            d["rule_doc"] = r.doc if r else ""
            d["fix_hint"] = r.fix_hint if r else ""
            return d

        print(json.dumps({
            "strict": args.strict,
            "blocking": [enrich(f) for f in blocking],
            "advisory": [enrich(f) for f in advisory],
            "suppressed": [enrich(f) for f in suppressed],
        }, indent=2))
    else:
        for f in blocking:
            print(f.format())
        for f in advisory:
            print(f.format() + "  [advisory — gates under --strict]")
        print(f"analysis: {len(blocking)} blocking, "
              f"{len(advisory)} advisory, "
              f"{len(suppressed)} suppressed"
              + (" [strict]" if args.strict else ""))
    return 1 if blocking else 0


if __name__ == "__main__":
    raise SystemExit(main())
