"""The port's public surface against the JAX package's.

For each module of ``mpi_model_tpu/`` with a counterpart at the same path
in ``mpi_model_tpu_torch/``, every name of the JAX module's ``__all__`` (or,
where it has none, every public name it defines at top level: functions,
classes and assignments, not what it imports) exists in the port's module.
The only exceptions are ``JAX_ONLY``, each with its reason; the JAX modules
without a same-path counterpart are ``RENAMED``, each with the port's files
that hold its work. The numpy helpers the port copies
(``oracle.cut_np``, ``oracle.ring_from_global_np``, the examples'
``render``) are held to the originals byte for byte on seeded inputs, and
the dtype seam's ``to_numpy``/``to_native``/``itemsize`` to JAX's for every
``DataType``.
"""

import ast
import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import mpi_model_tpu.abstraction as jabs
from mpi_model_tpu import oracle as joracle

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch import abstraction as tabs
from mpi_model_tpu_torch import oracle, resilience
from mpi_model_tpu_torch.models.model import Executor
from mpi_model_tpu_torch.parallel import (AutoShardedExecutor,
                                          ShardMapExecutor, make_mesh,
                                          make_mesh_2d, mesh_spans_processes,
                                          put_global, shard_space)

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "mpi_model_tpu"
PORT_PKG = REPO / "mpi_model_tpu_torch"

#: (module path under the package, name) -> why the port has no such name
JAX_ONLY = {
    ("abstraction.py", "to_jax"):
        "a jnp dtype; the port's counterpart is to_torch",
    ("analysis/__init__.py", "run_jaxpr_audit"):
        "audits jaxprs; the port audits its steps' torch ops "
        "(analysis.step_audit)",
    ("ir/lower.py", "maybe_pin"):
        "pins an XLA optimization_barrier; torch has none, and the port's "
        "lowering keeps the operation order without one",
    ("ops/stencil.py", "neighbor_counts_traced"):
        "builds counts inside a jax trace; the port builds them eagerly "
        "(ops.stencil.neighbor_counts)",
    ("ops/stencil.py", "weighted_counts_traced"):
        "as neighbor_counts_traced: a traced form with no torch meaning",
    ("analysis/astlint.py", "HOST_SYNC_CALLEES"):
        "jax's host-sync callees (block_until_ready, item); the port's "
        "host-sync rule keys on torch's (HOST_SYNC_METHODS)",
    ("utils/roofline.py", "CHIP_PEAKS"):
        "a table of TPU peaks by device kind; the port reads the card's "
        "peaks from the card (utils.roofline.chip_peaks)",
    ("utils/roofline.py", "KIND_ALIASES"):
        "aliases of TPU device kinds for CHIP_PEAKS",
}

#: JAX modules with no same-path counterpart -> the port's files that hold
#: their work (empty: JAX-only, with the reason in the key's comment)
RENAMED = {
    "compat.py": (),  # bridges across jax versions: nothing to bridge
    "ops/pallas_stencil.py": ("ops/fused_stencil.py", "ops/field_stencil.py",
                              "ops/pipeline_stencil.py"),
    "ops/pallas_active.py": ("ops/fused_active.py",),
    "analysis/jaxpr_audit.py": ("analysis/step_audit.py",),
}


def _jax_modules() -> list[str]:
    return sorted(p.relative_to(JAX_PKG).as_posix()
                  for p in JAX_PKG.rglob("*.py"))


def _public(path: Path) -> list[str]:
    """``__all__`` of the module, else its public top-level definitions."""
    tree = ast.parse(path.read_text(), filename=str(path))
    if any(isinstance(t, ast.Name) and t.id == "__all__"
           for node in tree.body if isinstance(node, ast.Assign)
           for t in node.targets):
        return list(_module("mpi_model_tpu",
                            path.relative_to(JAX_PKG).as_posix()).__all__)
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name):
                    names.append(t.id)
    return [n for n in names if not n.startswith("_")]


def _module(package: str, rel: str):
    """The module of ``package`` at path ``rel`` (``a/b.py``), imported."""
    parts = rel[:-3].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return importlib.import_module(".".join([package, *parts]))


def _port_module(rel: str):
    return _module("mpi_model_tpu_torch", rel)


COUNTERPARTS = [m for m in _jax_modules() if (PORT_PKG / m).exists()]


def test_every_jax_module_has_a_counterpart_or_a_reason():
    missing = [m for m in _jax_modules()
               if not (PORT_PKG / m).exists() and m not in RENAMED]
    assert missing == []
    for m, files in RENAMED.items():
        assert (JAX_PKG / m).exists() and not (PORT_PKG / m).exists()
        assert all((PORT_PKG / f).exists() for f in files)
    assert len(COUNTERPARTS) > 50


@pytest.mark.parametrize("rel", COUNTERPARTS)
def test_port_module_has_every_jax_name(rel):
    port = _port_module(rel)
    lacking = [n for n in _public(JAX_PKG / rel)
               if (rel, n) not in JAX_ONLY and not hasattr(port, n)]
    assert lacking == [], f"{rel}: the port lacks {lacking}"


@pytest.mark.parametrize("key", sorted(JAX_ONLY))
def test_jax_only_names_are_jaxs_and_only_jaxs(key):
    rel, name = key
    assert JAX_ONLY[key]
    assert name in _public(JAX_PKG / rel)
    assert not hasattr(_port_module(rel), name)


@pytest.mark.parametrize("name", ["FailureEvent", "SimulationFailure",
                                  "check_health", "supervised_run"])
def test_top_level_resilience_names_are_the_subpackages(name):
    assert name in mt.__all__
    assert getattr(mt, name) is getattr(resilience, name)


def test_version_and_ops_reexports():
    from mpi_model_tpu_torch import ops
    from mpi_model_tpu_torch.ops import composed_stencil, fused_active

    assert "__version__" in mt.__all__ and mt.__version__ == "0.1.0"
    assert ops.choose_k is composed_stencil.choose_k
    assert ops.choose_fused_k is fused_active.choose_fused_k
    assert {"choose_k", "choose_fused_k"} <= set(ops.__all__)


# -- the copied numpy helpers, byte for byte -------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
def test_cut_np_is_jaxs_byte_for_byte(dtype):
    rng = np.random.default_rng(3)
    G = (rng.uniform(-5, 5, (13, 17)) * 100).astype(dtype)
    for rs, re, cs, ce in ((0, 13, 0, 17), (-3, 4, -2, 5), (10, 16, 14, 20),
                           (-4, -1, 2, 6), (13, 15, 0, 17), (2, 9, -6, 0),
                           (5, 5, 3, 8)):
        got = oracle.cut_np(G, rs, re, cs, ce)
        want = joracle.cut_np(G, rs, re, cs, ce)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("d", [1, 2, 4])
def test_ring_from_global_np_is_jaxs_byte_for_byte(d):
    rng = np.random.default_rng(10 + d)
    G = rng.uniform(0.5, 2.0, (24, 36))
    for r0, c0, h, w in ((0, 0, 8, 12), (8, 12, 8, 12), (16, 24, 8, 12),
                         (0, 24, 24, 12), (12, 0, 12, 36)):
        got = oracle.ring_from_global_np(G, r0, c0, h, w, d)
        want = joracle.ring_from_global_np(G, r0, c0, h, w, d)
        assert list(got) == list(want)
        for k in want:
            assert got[k].shape == want[k].shape
            assert got[k].tobytes() == want[k].tobytes(), k


def test_render_is_jaxs_byte_for_byte():
    spec = importlib.util.spec_from_file_location(
        "_jax_example_rd", REPO / "examples" / "reaction_diffusion.py")
    jrd = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jrd)
    from mpi_model_tpu_torch.examples.reaction_diffusion import render

    rng = np.random.default_rng(5)
    for shape, width in (((96, 96), 48), ((24, 200), 64), ((30, 30), 10)):
        f = rng.uniform(0.0, 1.0, shape)
        assert render(f, width).encode() == jrd.render(f, width).encode()


# -- the dtype seam ---------------------------------------------------------------

@pytest.mark.parametrize("dt", list(jabs.DataType), ids=lambda d: d.name)
def test_dtype_seam_agrees_with_jaxs(dt):
    tdt = tabs.DataType(int(dt))
    assert tabs.to_native(tdt) == jabs.to_native(dt) == int(dt)
    assert tabs.itemsize(tdt) == jabs.itemsize(dt)
    torch_dt = tabs.to_torch(tdt)
    assert tabs.itemsize(torch_dt) == tabs.itemsize(tdt)
    assert tabs.to_native(torch_dt) == int(dt)
    if dt == jabs.DataType.BFLOAT16:
        # numpy has no bfloat16 without ml_dtypes, which the port never loads
        with pytest.raises(tabs.UnsupportedDataTypeError, match="bfloat16"):
            tabs.to_numpy(tdt)
    else:
        assert tabs.to_numpy(tdt) == jabs.to_numpy(dt)
        assert tabs.to_numpy(torch_dt) == jabs.to_numpy(dt)


# -- the mesh's names and the Executor protocol ----------------------------------

def test_put_global_places_the_blocks_shard_space_places():
    mesh = make_mesh_2d(2, 3, devices=["cpu"] * 6)
    x = torch.arange(4 * 9, dtype=torch.float64).view(4, 9)
    grid = put_global(x, mesh)
    space = mt.CellularSpace({"value": x}, 4, 9)
    want = shard_space(space, mesh)["value"]
    for i in range(2):
        for j in range(3):
            assert torch.equal(grid[i][j], x[2 * i:2 * i + 2, 3 * j:3 * j + 3])
            assert torch.equal(grid[i][j], want[i][j])
            assert grid[i][j].is_contiguous()
            assert grid[i][j].data_ptr() != x.data_ptr()
    with pytest.raises(ValueError, match="not divisible by mesh extent 3"):
        put_global(torch.zeros(4, 10), mesh)


def test_mesh_spans_processes_in_one_process():
    assert mesh_spans_processes(make_mesh(4, devices=["cpu"] * 4)) is False
    assert mesh_spans_processes(
        make_mesh_2d(2, 2, devices=["cpu"] * 4)) is False


def test_executors_satisfy_the_executor_protocol():
    mesh = make_mesh(2, devices=["cpu"] * 2)

    class Mine:
        comm_size = 1

        def run_model(self, model, space, num_steps):
            return dict(space.values)

    for ex in (mt.SerialExecutor(), ShardMapExecutor(mesh),
               AutoShardedExecutor(mesh), Mine()):
        assert isinstance(ex, Executor)
    assert not isinstance(object(), Executor)
    space = mt.CellularSpace.create(4, 4, 1.0, device="cpu")
    out, rep = mt.Model(mt.Diffusion(0.1)).execute(space, Mine(), steps=2)
    assert rep.comm_size == 1 and torch.equal(out.values["value"],
                                              space.values["value"])
