"""Static analysis of the port: an AST lint layer, a step contract
audit, a concurrency audit and a protocol audit over one rule registry.

Quick use::

    python -m mpi_model_tpu_torch.analysis --strict     # the gate (card)
    python -m mpi_model_tpu_torch.analysis --strict --device cpu
    python -m mpi_model_tpu_torch.analysis --json       # machine-readable
    mpi-model-analyze-torch --strict                    # console script

Library surface: ``run_astlint`` / ``lint_source`` (layer 1, pure AST,
no torch import), ``run_step_audit`` (layer 2: each registered step run
once under a dispatch recorder, on the card unless ``device="cpu"``),
``run_concurrency_audit`` (layer 3, whole-program lock/phase audit),
``run_protocol_audit`` / ``lint_protocol_source`` (layer 4,
journal/wire vocabulary conformance against the declared lifecycle
machines), ``RULES``/``Severity``/``Finding`` from the registry.
Suppress a finding in source with
``# analysis: ignore[rule-id] — reason``. The rule ids and the pragma
grammar are the JAX package's, so one pragma reads the same in either.
"""

from .registry import (RULES, Finding, Pragma, Rule,  # noqa: F401
                       Severity, collect_pragmas, rule)
from .astlint import (audit_test_module, iter_py_files,  # noqa: F401
                      lint_file, lint_source, parse_module, run_astlint)
from .concurrency import (SCOPE_CONCURRENCY,  # noqa: F401
                          lint_concurrency_source, run_concurrency_audit,
                          static_lock_graph)
from .protocol import (SCOPE_PROTOCOL,  # noqa: F401
                       lint_protocol_source, run_protocol_audit)

__all__ = [
    "RULES", "Finding", "Pragma", "Rule", "Severity", "collect_pragmas",
    "rule", "audit_test_module", "iter_py_files", "lint_file",
    "lint_source", "parse_module", "run_astlint", "run_step_audit",
    "SCOPE_CONCURRENCY", "lint_concurrency_source",
    "run_concurrency_audit", "static_lock_graph",
    "SCOPE_PROTOCOL", "lint_protocol_source", "run_protocol_audit",
    "main",
]


def run_step_audit(impls=None, device=None):
    """Layer 2 entry point (imports torch lazily — layer 1 stays
    millisecond-fast without it)."""
    from .step_audit import run_step_audit as _run
    return _run(impls, device=device)


def main(argv=None) -> int:
    from .__main__ import main as _main
    return _main(argv)
