"""K1's wrapper in the port (``ops/fused_stencil.py``) against the JAX
package's ``pallas_dense_step`` run in interpret mode, on the CPU.

On a CPU tensor the port's ``pallas_dense_step`` runs its plain version,
``dense_step_plain``; the CUDA kernel itself is held against that plain
version on the card (``chip_smoke.py`` and ``tests/test_torch_cuda.py``).
Tolerances are the JAX package's own tests': 1e-6 for one step, 1e-5 for
fused steps, 0.02 for bf16 against the f64 oracle. The two sides differ
only in summation order (the JAX kernel's interior takes a closed form)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpi_model_tpu.ops.pallas_stencil import pallas_dense_step as jax_step
from mpi_model_tpu.oracle import dense_flow_step_np

from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS, VON_NEUMANN_OFFSETS
from mpi_model_tpu_torch.ops import fused_stencil as fs

CUSTOM = ((-1, 0), (1, 1), (0, -1))


def _grid(h, w, seed=42):
    return np.random.default_rng(seed).uniform(0.5, 2.0, (h, w)).astype(
        np.float32)


def _both(v, rate, **kw):
    got = fs.pallas_dense_step(torch.from_numpy(v), rate, **kw)
    want = jax_step(jnp.asarray(v), rate, interpret=True, **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("shape,block,ns,offs,tol", [
    ((13, 17), None, 1, MOORE_OFFSETS, 1e-6),
    ((13, 17), None, 1, VON_NEUMANN_OFFSETS, 1e-6),
    ((64, 96), None, 1, MOORE_OFFSETS, 1e-6),
    ((64, 96), (16, 32), 1, CUSTOM, 1e-6),
    ((40, 640), (8, 128), 4, MOORE_OFFSETS, 1e-5),   # genuine interior
    ((40, 640), (8, 128), 4, CUSTOM, 1e-5),
    ((24, 256), (8, 128), 8, MOORE_OFFSETS, 1e-5),   # every tile near ring
    ((24, 256), (8, 128), 8, VON_NEUMANN_OFFSETS, 1e-5),
    ((13, 160), (13, 32), 4, MOORE_OFFSETS, 1e-5),   # odd rows
])
def test_matches_jax_pallas_interpret(shape, block, ns, offs, tol):
    v = _grid(*shape)
    got, want = _both(v, 0.13, offsets=offs, block=block, nsteps=ns)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    # and both against ns sequential f64 oracle steps
    ref = v.astype(np.float64)
    for _ in range(ns):
        ref = dense_flow_step_np(ref, 0.13, offsets=offs)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("ns", [1, 4])
def test_bfloat16_matches_oracle_and_jax(ns):
    v = _grid(32, 128)
    x = torch.from_numpy(v).to(torch.bfloat16)
    got = fs.pallas_dense_step(x, 0.1, nsteps=ns).float().numpy()
    want = np.asarray(jax_step(jnp.asarray(v, jnp.bfloat16), 0.1,
                               interpret=True, nsteps=ns)).astype(np.float32)
    ref = np.asarray(x.float().numpy(), np.float64)
    for _ in range(ns):
        ref = dense_flow_step_np(ref, 0.1)
    np.testing.assert_allclose(got, ref, rtol=0.02, atol=0.02)
    # the same f32 math rounded once: at most one bf16 ulp apart (values < 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -7)


def test_bf16_rounds_once_per_call():
    """The kernel (TPU and CUDA alike) rounds to bf16 once per CALL, so
    ``substeps`` changes bf16 results: 4 fused steps equal 4 f32 steps
    rounded once, not 4 rounded steps."""
    x = torch.from_numpy(_grid(32, 128, seed=7)).to(torch.bfloat16)
    fused = fs.pallas_dense_step(x, 0.1, nsteps=4)
    once = fs.dense_step_plain(x.float(), 0.1, MOORE_OFFSETS, 4).to(
        torch.bfloat16)
    assert torch.equal(fused, once)
    stepped = x
    for _ in range(4):
        stepped = fs.pallas_dense_step(stepped, 0.1)
    assert not torch.equal(fused, stepped)
    jfused = np.asarray(jax_step(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                 0.1, interpret=True, nsteps=4))
    np.testing.assert_allclose(fused.float().numpy(),
                               jfused.astype(np.float32), atol=2.0 ** -7)


@pytest.mark.parametrize("kw", [
    dict(block=(2, 7)), dict(block=(0, 7)), dict(offsets=((2, 0),)),
    dict(offsets=((0, 0),)), dict(offsets=((1, 0), (1, 0))),
    dict(offsets=()), dict(nsteps=0),
])
def test_same_calls_refused_with_same_messages(kw):
    v = _grid(5, 7)
    with pytest.raises(ValueError) as t_exc:
        fs.pallas_dense_step(torch.from_numpy(v), 0.1, **kw)
    with pytest.raises(ValueError) as j_exc:
        jax_step(jnp.asarray(v), 0.1, interpret=True, **kw)
    assert str(t_exc.value) == str(j_exc.value)


@pytest.mark.parametrize("dtype,shape,block,ns", [
    ("float32", (32, 256), (8, 128), 9),     # ghost depth 8 (f32 sublane)
    ("bfloat16", (32, 256), (16, 128), 17),  # ghost depth 16 (bf16 sublane)
    ("float32", (13, 17), None, 9),          # small grid, auto block
])
def test_ghost_depth_refused_like_jax(dtype, shape, block, ns):
    v = _grid(*shape)
    t = torch.from_numpy(v).to(getattr(torch, dtype))
    with pytest.raises(ValueError, match="ghost depth") as t_exc:
        fs.pallas_dense_step(t, 0.1, block=block, nsteps=ns)
    with pytest.raises(ValueError, match="ghost depth") as j_exc:
        jax_step(jnp.asarray(v, dtype), 0.1, block=block, interpret=True,
                 nsteps=ns)
    assert str(t_exc.value) == str(j_exc.value)
    # one step fewer is accepted by both
    fs.pallas_dense_step(t, 0.1, block=block, nsteps=ns - 1)
    assert fs.ghost_depth(shape, t.dtype, block) == ns - 1


def test_wrapper_contract_on_cpu():
    x = torch.from_numpy(_grid(16, 32))
    with pytest.raises(TypeError, match="float64"):
        fs.pallas_dense_step(x.double(), 0.1)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        fs.pallas_dense_step(x, 0.1, compute_dtype=torch.bfloat16)
    before = fs.launches()
    step = fs.PallasDiffusionStep((16, 32), 0.1, nsteps=4)
    out = torch.empty_like(x)
    res = step(x, out=out)
    assert res is out and torch.equal(out, fs.dense_step_plain(x, 0.1,
                                                               nsteps=4))
    # a CPU call runs the plain version: no kernel launched, none counted
    assert fs.launches() == before and step.launches == 0


def test_empty_grid_launches_nothing():
    # the launch site counts only a kernel it queues; an empty grid has
    # none to queue (and needs no built library to say so)
    step = fs.PallasDiffusionStep((0, 8), 0.1)
    before = fs.launches()
    fs._launch(torch.empty((0, 8)), torch.empty((0, 8)), 0.1,
               fs.check_offsets(fs.MOORE_OFFSETS), 1, step)
    assert fs.launches() == before and step.launches == 0
