"""The port's analysis layers (``mpi_model_tpu_torch.analysis``) on the CPU.

- Layers 1, 3 and 4 against the JAX package's: every fixture source of
  ``tests/test_analysis.py`` (read off its AST; those of the three rules
  the port checks in torch idiom, ``host-sync``, ``dtype-drift`` and
  ``traced-branch``, left out), its path retargeted from
  ``mpi_model_tpu/`` to ``mpi_model_tpu_torch/``, gives the same rule
  ids, lines and suppressions in either package.
- The three torch-shaped rules, each with positive and negative cases.
- The step audit (layer 2): each rule fires on a bad step built here, and
  every registered contract is clean on the port as it stands.
- The gate: ``python -m mpi_model_tpu_torch.analysis --strict --device
  cpu``'s findings over the port and ``chip_smoke.py``, in process: none
  unsuppressed, every suppression with a reason.
- The CLI's ``--list-rules``, ``--rule``, ``--json`` and exit codes.
"""

from __future__ import annotations

import ast
import gc
import io
import json
import re
import textwrap
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest
import torch

from mpi_model_tpu.analysis import concurrency as jax_conc
from mpi_model_tpu.analysis import protocol as jax_proto
from mpi_model_tpu.analysis.astlint import lint_source as jax_lint_source

from mpi_model_tpu_torch.analysis import (RULES, Severity, lint_source,
                                          main, run_astlint)
from mpi_model_tpu_torch.analysis import concurrency as port_conc
from mpi_model_tpu_torch.analysis import protocol as port_proto
from mpi_model_tpu_torch.analysis import step_audit as sa
from mpi_model_tpu_torch.ops import seam

REPO = Path(__file__).resolve().parent.parent
JAX_TESTS = REPO / "tests" / "test_analysis.py"
PKG = "mpi_model_tpu_torch/fake.py"
CPU = torch.device("cpu")

#: the rules the port checks in torch idiom (their fixtures differ)
TORCH_SHAPED = ("host-sync", "dtype-drift", "traced-branch")


def rules_of(findings, unsuppressed=True):
    return [f.rule for f in findings if not (unsuppressed and f.suppressed)]


# -- cross-package parity over JAX's fixtures ---------------------------------

#: layer entry point → (JAX's, the port's)
LAYERS = {
    "lint_source": (jax_lint_source, lint_source),
    "lint_concurrency_source": (jax_conc.lint_concurrency_source,
                                port_conc.lint_concurrency_source),
    "lint_protocol_source": (jax_proto.lint_protocol_source,
                             port_proto.lint_protocol_source),
}


class _Unknown(Exception):
    """A fixture expression that needs more than literals and strings."""


def _eval(node, env):
    try:
        return eval(compile(ast.Expression(node), "<fixture>", "eval"),
                    {"__builtins__": {}}, dict(env))
    except (NameError, AttributeError, TypeError, ValueError, KeyError,
            IndexError, SyntaxError) as e:
        raise _Unknown(repr(e)) from e


def _calls_in(node):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            name = (sub.func.id if isinstance(sub.func, ast.Name)
                    else getattr(sub.func, "attr", None))
            if name in LAYERS:
                yield name, sub


def _cases_in(stmts, env, test, out):
    for stmt in stmts:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name):
            name = stmt.targets[0].id
            try:
                env[name] = _eval(stmt.value, env)
            except _Unknown:
                env.pop(name, None)
        if isinstance(stmt, ast.For):
            try:
                items = list(_eval(stmt.iter, env))
            except (_Unknown, TypeError):
                items = []
            for item in items:
                # bind the loop target (a name or a tuple of names)
                loc = {"_item": item}
                try:
                    exec(f"{ast.unparse(stmt.target)} = _item",
                         {"__builtins__": {}}, loc)
                except (SyntaxError, TypeError, ValueError):
                    continue
                loc.pop("_item")
                _cases_in(stmt.body, dict(env) | loc, test, out)
            continue
        if isinstance(stmt, (ast.With, ast.If, ast.Try)):
            _cases_in(stmt.body, env, test, out)
            continue
        for layer, call in _calls_in(stmt):
            try:
                src = _eval(call.args[0], env)
                kw = {k.arg: k.value for k in call.keywords}
                path = (_eval(call.args[1], env) if len(call.args) > 1
                        else _eval(kw["path"], env) if "path" in kw
                        else None)
                rules = _eval(kw["rules"], env) if "rules" in kw else None
            except (_Unknown, IndexError):
                continue
            if not isinstance(src, str) or not (
                    path is None or isinstance(path, str)):
                continue
            if rules is not None and any(
                    r in TORCH_SHAPED or r.startswith("jaxpr-")
                    for r in rules):
                continue
            out.append((f"{test}:{call.lineno}", layer, src, path,
                        None if rules is None else tuple(rules)))


def _fixtures():
    tree = ast.parse(JAX_TESTS.read_text())
    env: dict = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            try:
                env[node.targets[0].id] = _eval(node.value, env)
            except _Unknown:
                pass
    out: list = []
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name.startswith("test_")):
            continue
        if any(r.replace("-", "_") in fn.name for r in TORCH_SHAPED):
            continue
        _cases_in(fn.body, dict(env), fn.name, out)
    seen, cases = set(), []
    for case in out:
        key = case[1:]
        if key not in seen:
            seen.add(key)
            cases.append(case)
    return cases


FIXTURES = _fixtures()


def _retarget(path):
    return None if path is None else path.replace("mpi_model_tpu/",
                                                  "mpi_model_tpu_torch/")


def _run(fn, src, path, rules):
    kw = {} if rules is None else {"rules": rules}
    got = fn(src, **kw) if path is None else fn(src, path, **kw)
    return sorted((f.rule, f.line, f.suppressed) for f in got
                  if f.rule not in TORCH_SHAPED)


def test_the_fixture_reader_reads_every_layer_call():
    """Every call of a layer in JAX's tests outside the three torch-shaped
    rules' tests is read as (at least) one case."""
    assert {c[1] for c in FIXTURES} == set(LAYERS)
    tree = ast.parse(JAX_TESTS.read_text())
    read = {c[0].split(" ")[0] for c in FIXTURES}
    calls = [f"{fn.name}:{call.lineno}" for fn in tree.body
             if isinstance(fn, ast.FunctionDef)
             and fn.name.startswith("test_")
             and not any(r.replace("-", "_") in fn.name
                         for r in TORCH_SHAPED)
             for _, call in _calls_in(fn)]
    assert len(calls) >= 80
    assert [c for c in calls if c not in read] == []


@pytest.mark.parametrize("case", FIXTURES, ids=[c[0] for c in FIXTURES])
def test_port_layers_match_jax_on_jax_fixtures(case):
    _, layer, src, path, rules = case
    jax_fn, port_fn = LAYERS[layer]
    assert _run(port_fn, src, _retarget(path), rules) == \
        _run(jax_fn, src, path, rules)


def test_every_jax_rule_id_but_the_trace_audits_is_the_port_s():
    from mpi_model_tpu.analysis.jaxpr_audit import SCOPE_JAXPR
    from mpi_model_tpu.analysis.registry import RULES as JAX_RULES

    jax_ids = {r for r, rule in JAX_RULES.items()
               if rule.scope != SCOPE_JAXPR}
    assert jax_ids <= set(RULES)
    for r in jax_ids:
        assert RULES[r].severity.value == JAX_RULES[r].severity.value, r
    assert {r for r in RULES if r.startswith("step-")} == {
        "step-dtype", "step-sync", "step-consts", "step-halo",
        "step-term-registry", "step-fused-flags", "step-batch-sum",
        "step-launches"}


def test_a_pragma_reads_the_same_in_either_package():
    src = ("def f():\n"
           "    try:\n"
           "        pass\n"
           "    # analysis: ignore[broad-except] — the supervisor\n"
           "    except Exception:\n"
           "        pass\n")
    for fn, path in ((lint_source, PKG),
                     (jax_lint_source, "mpi_model_tpu/fake.py")):
        out = fn(src, path)
        assert [(f.rule, f.suppressed, f.suppress_reason) for f in out] == [
            ("broad-except", True, "the supervisor")]


# -- the three torch-shaped rules ---------------------------------------------

HOST_READS = ("v.item()", "v.tolist()", "v.cpu()", "v.numpy()",
              "torch.cuda.synchronize()", "np.asarray(v)",
              "stream.synchronize()")


@pytest.mark.parametrize("stmt", HOST_READS)
def test_host_sync_fires_in_a_step_scope(stmt):
    src = ("def make_step(space):\n"
           "    def step(v):\n"
           f"        x = {stmt}\n"
           "        return v\n"
           "    return step\n")
    assert rules_of(lint_source(src, PKG)) == ["host-sync"]


def test_host_sync_fires_under_vmap():
    src = ("import torch\n"
           "def lane(v):\n"
           "    return v * v.sum().item()\n"
           "f = torch.func.vmap(lane)\n")
    assert rules_of(lint_source(src, PKG)) == ["host-sync"]


def test_host_sync_negative():
    src = ("def make_step(space):\n"
           "    n = int(space.values['v'].sum().item())  # build time\n"
           "    def step(v):\n"
           "        return v.to(v.device) * v.sum(dim=0)\n"
           "    return step\n"
           "def report(v):\n"
           "    return v.tolist(), v.cpu().numpy()\n")
    assert rules_of(lint_source(src, PKG)) == []


def test_host_sync_pragma_with_reason():
    src = ("def make_step(space):\n"
           "    def step(v):\n"
           "        # analysis: ignore[host-sync] — the declared read\n"
           "        n = v.tolist()\n"
           "        return v\n"
           "    return step\n")
    out = lint_source(src, PKG)
    assert rules_of(out) == [] and rules_of(out, False) == ["host-sync"]


def test_dtype_drift_fires_in_a_step_scope():
    src = ("import torch\n"
           "def make_step(space):\n"
           "    def step(v):\n"
           "        a = torch.tensor(0.5, device=v.device)\n"
           "        b = torch.full(v.shape, -1.5)\n"
           "        c = torch.arange(0.0, 4.0)\n"
           "        d = torch.linspace(0, 1.0, 5)\n"
           "        e = torch.as_tensor([0.25, 1])\n"
           "        return v * a\n"
           "    return step\n")
    assert rules_of(lint_source(src, PKG)) == ["dtype-drift"] * 5


def test_dtype_drift_negative():
    src = ("import torch\n"
           "def make_step(space):\n"
           "    half = torch.tensor(0.5)  # build time, not the step\n"
           "    def step(v):\n"
           "        a = torch.tensor(0.5, dtype=v.dtype, device=v.device)\n"
           "        b = torch.full(v.shape, 2, device=v.device)\n"
           "        c = torch.zeros_like(v) + 1.5\n"
           "        return v * a + b + c\n"
           "    return step\n")
    assert rules_of(lint_source(src, PKG)) == []


def test_dtype_drift_is_package_scoped():
    src = ("import torch\n"
           "def make_step(space):\n"
           "    def step(v):\n"
           "        return v * torch.tensor(0.5)\n"
           "    return step\n")
    assert rules_of(lint_source(src, PKG)) == ["dtype-drift"]
    assert rules_of(lint_source(src, "tests/test_fake.py")) == []
    assert rules_of(lint_source(src, "examples/fake.py")) == []


def test_traced_branch_fires_on_a_tensor_s_value():
    src = ("def make_step(space):\n"
           "    def step(v, flags):\n"
           "        if flags.any():\n"
           "            return v\n"
           "        while v.sum() > 0:\n"
           "            v = v - 1\n"
           "        if bool(flags):\n"
           "            return v\n"
           "        return v\n"
           "    return step\n")
    assert rules_of(lint_source(src, PKG)) == ["traced-branch"] * 3


def test_traced_branch_negative_static_metadata():
    src = ("def make_step(space):\n"
           "    def step(v, out=None):\n"
           "        if out is None:\n"
           "            out = v\n"
           "        if v.shape[0] > 2 and v.dtype.is_floating_point:\n"
           "            pass\n"
           "        if isinstance(v, dict) or len(v) > 1:\n"
           "            pass\n"
           "        if v.device.type == 'cuda' and v.numel() > 4:\n"
           "            pass\n"
           "        return out\n"
           "    return step\n"
           "def plain(v):\n"
           "    if v.any():\n"
           "        return v\n")
    assert rules_of(lint_source(src, PKG)) == []


# -- the step audit: each rule on a bad step ----------------------------------

def _step(fn, args, dtype=torch.float64, grid=(16, 16), **kw):
    nbytes = torch.empty((), dtype=dtype).element_size() * grid[0] * grid[1]
    kw.setdefault("consts_check", False)
    return sa.BuiltStep("bad", fn, args, dtype, nbytes, ((0, 1), (1, 0)), 1,
                        **kw)


def _v(dtype=torch.float64, shape=(16, 16)):
    return torch.arange(shape[0] * shape[1], dtype=dtype).reshape(shape)


def _rules(built):
    return [f.rule for f in sa.audit_built(built, CPU)[0]]


def test_step_dtype_fires_on_an_f32_output_of_an_f64_space():
    assert _rules(_step(lambda v: {"value": v.float()}, (_v(),))) == [
        "step-dtype"]
    assert _rules(_step(lambda v: {"value": v * 2}, (_v(),))) == []


def test_step_sync_fires_past_the_declared_count():
    def two_reads(v):
        n = int(v.sum()) + int(v.max())
        return v * n

    assert _rules(_step(two_reads, (_v(),), host_reads=1)) == ["step-sync"]
    assert _rules(_step(two_reads, (_v(),), host_reads=1, units=2)) == []
    assert _rules(_step(lambda v: v[v.nonzero(as_tuple=True)].sum() + v,
                        (_v(),))) == ["step-sync"]


def test_step_sync_leaves_a_kernel_s_plain_version_alone():
    def kernel_plain(v):
        return v * int(v.sum())

    def step(v):
        return seam.plain_version("K1", kernel_plain, v)

    assert _rules(_step(step, (_v(),))) == []


def test_step_consts_fires_on_a_closed_over_grid():
    grid = _v() * 0.5

    def step(v):
        return v + grid

    assert _rules(_step(step, (_v(),), consts_check=True)) == [
        "step-consts"]
    kept = _step(step, (_v(),), consts_check=True,
                 kept={"grid": "a divisor the port keeps"})
    assert _rules(kept) == []


def test_step_consts_fires_on_a_closure_over_budget():
    tables = [torch.zeros(4096, dtype=torch.float64) for _ in range(40)]

    class Holder:
        def __init__(self):
            self.tables = tables

        def __call__(self, v):
            return v + self.tables[0][0]

    fn = Holder().__call__
    found = sa.audit_built(_step(fn, (_v(),), consts_check=True,
                                 grid=(256, 256)), CPU)[0]
    assert [f.rule for f in found] == ["step-consts"]
    assert "budget" in found[0].message
    paths = [p for p, _ in sa.closure_tensors(fn)]
    assert len(paths) == 40 and paths[0].endswith("tables[0]")


def test_step_halo_fires_when_k_times_passes_is_not_substeps():
    built = _step(lambda v: v, (_v(),), composed_k=2, composed_passes=3,
                  substeps=4, )
    built.halo_depth = 2
    assert _rules(built) == ["step-halo"]
    deep = _step(lambda v: v, (_v(),), composed_k=4, composed_passes=1,
                 substeps=4)
    deep.halo_depth = 2
    assert _rules(deep) == ["step-halo"]
    assert sa.stencil_radius(((0, 2), (-1, 1))) == 2


def test_step_term_registry_fires_on_an_unlowered_term():
    from mpi_model_tpu_torch.ir.terms import Term

    assert sa.check_term_registry() == []

    class Unlowered(Term):
        pass

    try:
        found = sa.check_term_registry()
        assert [f.rule for f in found] == ["step-term-registry"]
        assert "Unlowered" in found[0].message
    finally:
        del Unlowered
        gc.collect()
    assert sa.check_term_registry() == []


def test_step_batch_sum_fires_on_a_total_over_the_batch_axis():
    vb = torch.rand((3, 8, 8), dtype=torch.float64)
    spec = {"count": 3, "min_elems": 64, "out_numel": 1}

    def per_lane(v):
        return torch.stack([torch.sum(v[b], dtype=torch.float64)
                            for b in range(v.shape[0])])

    def over_batch(v):
        return torch.sum(v, dim=0, dtype=torch.float64)

    def f32_lanes(v):
        return torch.stack([torch.sum(v[b], dtype=torch.float32)
                            for b in range(v.shape[0])])

    ok = _step(per_lane, (vb,), grid=(8, 8), batch_sum=spec)
    assert _rules(ok) == []
    assert _rules(_step(over_batch, (vb,), grid=(8, 8), batch_sum=spec,
                        dtype_check=False)) == ["step-batch-sum"] * 2
    assert _rules(_step(f32_lanes, (vb,), grid=(8, 8), batch_sum=spec,
                        dtype_check=False)) == ["step-batch-sum"] * 3


def test_step_fused_flags_fires_on_a_tile_reduction_outside_the_kernel():
    tile = 64

    def k6(v):
        return v * 2, (v != 0).any()  # inside the kernel: allowed

    def runner(v, rescan):
        for _ in range(2):
            v, _flag = seam.plain_version("K6", k6, v)
            if rescan:
                v = v + v.abs().amax()  # a tile-size reduction outside
            seam.plain_version("K7", lambda x: x, v)
        return v

    base = dict(fused_flags_tile_elems=tile, dtype_check=False)
    x = torch.rand((8, 8), dtype=torch.float64)
    assert _rules(_step(runner, (x, False), grid=(8, 8), **base)) == []
    assert _rules(_step(runner, (x, True), grid=(8, 8), **base)) == [
        "step-fused-flags"] * 2
    # a single kernel call cannot show what runs between passes
    one = _step(lambda v: seam.plain_version("K6", k6, v)[0], (x,),
                grid=(8, 8), **base)
    assert _rules(one) == ["step-fused-flags"]


def test_step_launches_checks_nothing_on_the_cpu():
    built = _step(lambda v: v, (_v(),), launches={"fused_stencil": 1},
                  kernels=("fused_stencil_kernel",))
    found, rep = sa.audit_built(built, CPU)
    assert found == [] and rep["launches"] == {}
    assert rep["launch_check"].startswith("not checked")


def test_a_broken_contract_is_a_finding_of_its_own_and_the_rest_run(
        monkeypatch):
    def broken(device):
        raise RuntimeError("no such builder")

    monkeypatch.setitem(sa.CONTRACTS, "broken", broken)
    found, reports = sa.audit_contracts(("broken", "dense"), device="cpu")
    assert [(f.rule, f.path) for f in found] == [("step-dtype",
                                                  "step:broken")]
    assert sorted(r["contract"] for r in reports) == ["broken", "dense"]


def test_the_step_audit_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sa.run_step_audit(("dense",))


# -- the contracts on the port as it stands -----------------------------------

@pytest.mark.parametrize("name", list(sa.CONTRACTS))
def test_contract_is_clean_on_the_cpu(name):
    found, reports = sa.audit_contracts((name,), device="cpu")
    assert found == []
    (rep,) = reports
    assert rep["host_reads"] <= rep["host_reads_allowed"]


def test_declared_counts_are_today_s_reads_and_launches():
    """0 host reads for the dense, composed, ensemble and IR xla/composed
    steps; 1 a pass or step for the active engines; each kernel route's
    launches."""
    reads = {}
    for name, build in sa.CONTRACTS.items():
        b = build(CPU)
        reads[name] = (b.host_reads, b.sync_unit)
    for name in ("dense", "composed", "ensemble", "ensemble_mesh",
                 "ir_diffusion_xla", "k1_dense", "k3_vpu", "k3_mxu",
                 "k4_coupled", "k5_pipeline"):
        assert reads[name][0] == 0, name
    for m in ("gray_scott", "sir", "predator_prey"):
        assert reads[f"ir_{m}_xla"][0] == reads[f"ir_{m}_composed"][0] == 0
        assert reads[f"ir_{m}_active"] == (1, "step")
    for name in ("active", "active_fused", "active_fused_runner",
                 "k67_active_fused"):
        assert reads[name] == (1, "pass"), name
    k1 = sa.CONTRACTS["k1_dense"](CPU)
    assert k1.launches == {"fused_stencil": 1}
    assert sa.CONTRACTS["k2_sharded"](CPU).launches == {
        "fused_stencil_halo": 4}


def test_every_declared_read_points_at_a_host_read():
    seen = set()
    for build in sa.CONTRACTS.values():
        b = build(CPU)
        if not b.reads_at:
            continue
        path, line = b.reads_at.rsplit(":", 1)
        text = (REPO / path).read_text().splitlines()[int(line) - 1]
        assert re.search(r"int\(|\.tolist\(\)|_synchronize\(\)", text), (
            b.reads_at, text)
        seen.add(b.reads_at)
    assert len(seen) >= 4


def test_kernel_names_are_the_sources_kernels():
    csrc = REPO / "mpi_model_tpu_torch" / "csrc"
    text = "\n".join(p.read_text() for p in sorted(csrc.iterdir()))
    declared = set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*"
        r"\)\s*)?(\w+)", text))
    assert declared == set(sa.KERNEL_NAMES)


def test_a_cached_step_does_not_hold_the_space_it_was_built_for():
    """A step closes over its build space's dtype and static point-source
    tensors, never the space: the state a step was built from is freed
    with the caller's last reference (the step-consts finding that found
    it held ``single.counts.space``)."""
    import mpi_model_tpu_torch as mt

    space = mt.CellularSpace.create(32, 32, 1.0, dtype="float64",
                                    device="cpu")
    model = mt.Model([mt.Diffusion(0.1), mt.Exponencial((3, 3), 0.05)],
                     10.0, 0.2)
    step = model.make_step(space, impl="xla")
    step(space.values)
    ptr = space.values["value"].untyped_storage().data_ptr()
    held = [p for p, t in sa.closure_tensors(step)
            if isinstance(t, torch.Tensor)
            and t.untyped_storage().data_ptr() == ptr]
    assert held == []


def test_the_point_path_makes_no_tensor_from_host_values_a_step():
    import mpi_model_tpu_torch as mt
    from mpi_model_tpu_torch.core.cell import Cell
    from mpi_model_tpu_torch.core.attribute import Attribute

    space = mt.CellularSpace.create(32, 32, 1.0, dtype="float64",
                                    device="cpu")
    model = mt.Model([mt.Diffusion(0.1), mt.Exponencial((3, 3), 0.05),
                      mt.Exponencial(Cell(19, 3, Attribute(99, 2.2)), 0.1)],
                     10.0, 0.2)
    step = model.make_step(space, impl="xla")
    step(space.values)
    _, ops, _, _ = sa.record(step, (space.values,), CPU)
    assert not [op.name for op in ops if op.name == "lift_fresh"]


# -- the gate ------------------------------------------------------------------

def _main(argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_the_port_is_clean_under_its_strict_gate():
    rc, out, _ = _main(["--strict", "--json", "--device", "cpu"])
    doc = json.loads(out)
    assert doc["blocking"] == [] and doc["advisory"] == []
    assert rc == 0
    sup = doc["suppressed"]
    assert len(sup) >= 80
    assert all(f["suppress_reason"] for f in sup)
    paths = {f["path"].split("/")[0] for f in sup}
    assert paths == {"mpi_model_tpu_torch"}


def test_the_gate_scans_the_port_and_chip_smoke():
    from mpi_model_tpu_torch.analysis.__main__ import DEFAULT_ROOTS

    assert DEFAULT_ROOTS == ("mpi_model_tpu_torch", "chip_smoke.py")
    files = {p.relative_to(REPO).as_posix() for p in (
        pp for r in DEFAULT_ROOTS
        for pp in (REPO / r).rglob("*.py") if (REPO / r).is_dir())}
    assert "mpi_model_tpu_torch/analysis/step_audit.py" in files
    out = run_astlint([REPO / "chip_smoke.py"], rel_to=REPO)
    assert rules_of(out) == []


# -- the CLI -------------------------------------------------------------------

def test_cli_list_rules_names_every_rule():
    rc, out, _ = _main(["--list-rules"])
    assert rc == 0
    names = [line.split()[0] for line in out.splitlines()]
    assert names == list(RULES)


def test_cli_json_rule_filter_and_exit_codes(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def f(x=[]):\n    try:\n        pass\n"
                   "    except Exception:\n        pass\n")
    rc, out, _ = _main([str(bad), "--json", "--rule", "broad-except"])
    doc = json.loads(out)
    assert rc == 1
    assert [f["rule"] for f in doc["blocking"]] == ["broad-except"]
    assert doc["blocking"][0]["fix_hint"] == RULES["broad-except"].fix_hint
    rc, out, _ = _main([str(bad), "--rule", "mutable-default"])
    assert rc == 1 and "mutable-default" in out
    good = tmp_path / "good.py"
    good.write_text("def f(x=None):\n    return x\n")
    rc, out, _ = _main([str(good), "--strict", "--no-step"])
    assert rc == 0 and "0 blocking" in out


def test_cli_refuses_unknown_and_engine_only_rules():
    rc, _, err = _main(["--rule", "broad-excep"])
    assert rc == 2 and "broad-except" in err
    rc, _, err = _main(["--rule", "bare-pragma"])
    assert rc == 2 and "engine" in err


def test_cli_step_rule_runs_the_step_audit_on_the_named_device(tmp_path):
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    rc, out, _ = _main([str(good), "--rule", "step-term-registry",
                        "--device", "cpu"])
    assert rc == 0 and "0 blocking" in out


def test_cli_warnings_gate_only_under_strict(tmp_path):
    src = textwrap.dedent("""\
        import time
        def f():
            return time.perf_counter()
        """)
    serve = tmp_path / "mpi_model_tpu_torch" / "ensemble"
    serve.mkdir(parents=True)
    (serve / "fake.py").write_text(src)
    rc, out, _ = _main([str(serve / "fake.py")])
    assert rc == 0 and "advisory" in out
    rc, out, _ = _main([str(serve / "fake.py"), "--strict", "--no-step"])
    assert rc == 1 and "naked-timer" in out
    assert RULES["naked-timer"].severity is Severity.WARNING
