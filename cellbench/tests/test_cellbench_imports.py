"""Nothing the benchmark runs loads JAX or the JAX package, by top-level
module name compared whole (the port's name begins with the JAX
package's); the reference and the work count import nothing of the
program; nothing reads the JAX package's benchmarks."""

import ast
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest

from cellbench import registry
from cellbench.run import FORBIDDEN, forbidden_modules

ROOT = registry.ROOT
REPO = ROOT.parent
SOURCES = sorted(p for p in ROOT.rglob("*.py") if ".cache" not in p.parts)
#: the JAX package's benchmarks and smoke scripts: never read
NOT_READ = ("bench", "benchmarks", "chip_smoke")


def imported(path: Path) -> set:
    """Top-level names of every absolute import, and the cellbench modules
    a relative import reaches."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                out.add("cellbench")
            else:
                out.add(node.module.split(".")[0])
    return out


def cellbench_deps(path: Path) -> set:
    """The cellbench source files ``path`` imports (absolute ``cellbench.x``
    or relative), and theirs, and so on."""
    seen, todo = set(), [path]
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.ImportFrom):
                if node.level:
                    base = p.parent
                    for _ in range(node.level - 1):
                        base = base.parent
                    parts = (node.module or "").split(".") if node.module \
                        else []
                elif node.module and node.module.split(".")[0] == "cellbench":
                    base, parts = REPO, node.module.split(".")
                else:
                    continue
                names = [[*parts, a.name] for a in node.names] + [parts]
                for n in names:
                    for cand in (base.joinpath(*n).with_suffix(".py"),
                                 base.joinpath(*n) / "__init__.py"):
                        if n and cand.is_file():
                            todo.append(cand)
    return seen


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    names = imported(path)
    assert not names & set(FORBIDDEN), names
    assert not names & set(NOT_READ), names


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if p.parent.name in ("reference", "work")],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_reference_and_work_import_nothing_of_the_program(path):
    for dep in cellbench_deps(path):
        assert "mpi_model_tpu_torch" not in imported(dep), dep
        assert dep.parent.name != "traffic" and dep.name != "program.py"


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mpi_model_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mpi_model_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert forbidden_modules() == ["jax.numpy", "mpi_model_tpu.ops"]


def test_a_run_loads_no_forbidden_module():
    code = ("import cellbench.harness, cellbench.run, mpi_model_tpu_torch, "
            "mpi_model_tpu_torch.ensemble, mpi_model_tpu_torch.models; "
            "from cellbench import registry; "
            "[registry.traffic(k) for k in "
            "('grid_calls', 'batch_rounds')]; "
            "[registry.metric(p.stem) for p in "
            "registry.ROOT.joinpath('metrics').glob('*.py')]; "
            "print(cellbench.run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_without_the_program_the_command_fails(tmp_path):
    import shutil

    shutil.copytree(ROOT, tmp_path / "cellbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "cellbench.run", "--workload",
         "moore8.grid16k", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


class _Run:
    """What ``harness.execute`` hands ``run.main``: a run that measured
    nothing, with every check held."""

    def __init__(self):
        from cellbench.check import Checks

        self.window_t0 = 0.0
        self.e2e, self.record, self.notes = {}, {}, {}
        self.memory_peak_bytes = 0
        self.checks = Checks({})
        self.attempted, self.failed = 1, 0
        self.timeline = None


@pytest.mark.parametrize("loads_jax", [False, True])
def test_a_reader_that_loads_jax_stops_the_result(loads_jax, tmp_path,
                                                  monkeypatch, capsys):
    """The guard runs after the per-layer readers: a reader that loads a
    (stub) ``jax`` leaves the run with no result line."""
    import time

    import torch

    from cellbench import harness, run

    (tmp_path / "stub" / "jax").mkdir(parents=True)
    (tmp_path / "stub" / "jax" / "__init__.py").write_text("")
    reader = tmp_path / "reader.py"
    reader.write_text(("import jax  # noqa: F401\n" if loads_jax else "")
                      + "\n\ndef read(record):\n    return 1.0\n")
    spec = importlib.util.spec_from_file_location("stub_reader", reader)
    monkeypatch.syspath_prepend(str(tmp_path / "stub"))
    for name in [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)

    def metric(name, root=None):
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    monkeypatch.setattr(registry, "metric", metric)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(run, "card_line", lambda: "a card")
    monkeypatch.setattr(run, "set_caches", lambda: str(tmp_path))

    def execute(*a, **k):
        ctx = _Run()
        ctx.window_t0 = time.perf_counter()
        return ctx
    monkeypatch.setattr(harness, "execute", execute)
    try:
        rc = run.main(["--workload", "moore8.grid16k", "--seed", "3",
                       "--seconds", "1", "--trace", "1"])
        out = capsys.readouterr()
        loaded = forbidden_modules()
    finally:
        sys.modules.pop("jax", None)
    if loads_jax:
        assert loaded == ["jax"]
        assert rc != 0 and out.out.strip() == ""
        assert "jax" in out.err
    else:
        assert rc == 0
        line = json.loads(out.out.strip().splitlines()[-1])
        assert line["correct"] is True and line["metrics"]
