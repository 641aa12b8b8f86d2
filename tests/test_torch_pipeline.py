"""K5's wrapper in the port (``ops/pipeline_stencil.py``) against the JAX
package's ``_pipeline_call``, run through ``pallas_dense_step(...,
pipeline=True, interpret=True)``, on the CPU.

On a CPU tensor the port's wrapper runs its plain version,
``pipeline_step_plain``; the CUDA kernel is held bit for bit against that
plain version on the card (``chip_smoke.py`` and
``tests/test_torch_cuda.py``). Against JAX the two sides compute the same
expressions in the same order, but XLA on the CPU contracts multiply-adds:
f32 is held within ``2·eps·nsteps·max|v|``, bf16 (f32 math rounded once)
within one bf16 ulp of the value scale."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mpi_model_tpu as mm
from mpi_model_tpu.ops.pallas_stencil import _pipeline_blocks as jax_blocks
from mpi_model_tpu.ops.pallas_stencil import pallas_dense_step as jax_step

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS, VON_NEUMANN_OFFSETS
from mpi_model_tpu_torch.ops import fused_stencil as fs
from mpi_model_tpu_torch.ops import pipeline_stencil as ps

CUSTOM = ((-1, 0), (1, 1), (0, -1))
EPS32 = 2.0 ** -23


def _grid(shape, seed=42):
    return np.random.default_rng(seed).uniform(0.5, 2.0, shape).astype(
        np.float32)


def _bf16_ulp(scale: float) -> float:
    return 2.0 ** (math.floor(math.log2(scale)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ns", [1, 3, 8])
@pytest.mark.parametrize("offs", [MOORE_OFFSETS, VON_NEUMANN_OFFSETS],
                         ids=["moore", "von_neumann"])
@pytest.mark.parametrize("shape,block", [((32, 256), None),
                                         ((64, 512), (16, 128))])
def test_plain_k5_matches_jax_pipeline_interpret(dtype, ns, offs, shape,
                                                 block):
    v = _grid(shape)
    got = fs.pallas_dense_step(
        torch.from_numpy(v).to(getattr(torch, dtype)), 0.13, offs,
        block=block, nsteps=ns, pipeline=True).float().numpy()
    want = np.asarray(jax_step(jnp.asarray(v, dtype), 0.13, offsets=offs,
                               block=block, nsteps=ns, pipeline=True,
                               interpret=True)).astype(np.float32)
    gap = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    tol = (2 * EPS32 * ns * scale if dtype == "float32"
           else _bf16_ulp(scale))
    print(f"{dtype} {shape} block={block} ns={ns} k={len(offs)}: "
          f"largest gap {gap:.3e} (tolerance {tol:.3e})")
    assert gap <= tol


@pytest.mark.parametrize("ns", [1, 3, 8])
def test_explicit_block_grid_has_interior_tiles(ns):
    """64×512 at block (16, 128) holds closed-form tiles at every depth the
    parity test uses; the auto block of 32×256 holds none."""
    blk = ps.pipeline_block((64, 512), ns, (16, 128))
    assert blk == (16, 128)
    assert bool(ps.interior_mask((64, 512), blk, ns).any())
    auto = ps.pipeline_block((32, 256), ns)
    assert auto == jax_blocks(32, 256) == (32, 256)
    assert not bool(ps.interior_mask((32, 256), auto, ns).any())


@pytest.mark.parametrize("h,w", [(16, 128), (48, 384), (1024, 1536),
                                 (20, 50), (32, 100), (528, 640)])
def test_pipeline_blocks_are_jax_blocks(h, w):
    assert ps._pipeline_blocks(h, w) == jax_blocks(h, w)


@pytest.mark.parametrize("shape,kw", [
    ((20, 50), {}),                              # no strip tiling
    ((32, 256), dict(nsteps=9)),                 # deeper than the strips
    ((32, 256), dict(block=(8, 128))),           # explicit non-strip block
    ((32, 256), dict(block=(16, 100))),          # block not tiling the grid
    ((32, 256), dict(nsteps=0)),
    ((32, 256), dict(offsets=((2, 0),))),
])
def test_refusals_match_jax_texts(shape, kw):
    v = _grid(shape)
    with pytest.raises(ValueError) as t_exc:
        fs.pallas_dense_step(torch.from_numpy(v), 0.1, pipeline=True, **kw)
    with pytest.raises(ValueError) as j_exc:
        jax_step(jnp.asarray(v), 0.1, pipeline=True, interpret=True, **kw)
    assert str(t_exc.value) == str(j_exc.value)


def test_f64_refused_like_jax():
    """f64 is refused where the JAX package refuses it, at the ensemble's
    pipeline engine, with the same text; the wrapper refuses it too."""
    v = _grid((16, 128)).astype(np.float64)
    tsp = mt.CellularSpace.create(16, 128, 1.0, dtype="float64",
                                  device="cpu").with_values(
        {"value": torch.from_numpy(v)})
    jsp = mm.CellularSpace.create(16, 128, 1.0, dtype=jnp.float64)
    with pytest.raises(ValueError, match="f32") as t_exc:
        mt.Model(mt.Diffusion(0.1)).execute_many(
            [tsp], executor=mt.EnsembleExecutor(impl="pipeline"), steps=1)
    with pytest.raises(ValueError, match="f32") as j_exc:
        mm.Model(mm.Diffusion(0.1)).execute_many(
            [jsp], executor=mm.EnsembleExecutor(impl="pipeline"), steps=1)
    assert str(t_exc.value) == str(j_exc.value)
    with pytest.raises(TypeError, match="float64"):
        ps.pipeline_dense_step(torch.from_numpy(v), 0.1)


@pytest.mark.parametrize("ns", [1, 4, 8])
@pytest.mark.parametrize("offs", [MOORE_OFFSETS, VON_NEUMANN_OFFSETS, CUSTOM],
                         ids=["moore", "von_neumann", "custom"])
def test_plain_k5_equals_exact_dense_step_plain(ns, offs):
    """Where every tile is near (the auto block of 32×256), K5's plain
    version is K1's exact path bit for bit; with closed-form tiles it stays
    within the f32 tolerance of it."""
    x = torch.from_numpy(_grid((32, 256), seed=3))
    assert torch.equal(ps.pipeline_step_plain(x, 0.13, offs, ns),
                       fs.exact_dense_step_plain(x, 0.13, offs, ns))
    y = torch.from_numpy(_grid((64, 512), seed=4))
    got = ps.pipeline_step_plain(y, 0.13, offs, ns, (16, 128))
    want = fs.exact_dense_step_plain(y, 0.13, offs, ns)
    gap = float((got - want).abs().max())
    assert 0.0 < gap <= 2 * EPS32 * ns * float(want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_equals_lane_by_lane(dtype):
    x = torch.from_numpy(_grid((3, 64, 512), seed=5)).to(dtype)
    got = ps.pipeline_dense_step(x, 0.1, block=(16, 128), nsteps=4)
    assert got.shape == x.shape and got.dtype == dtype
    for b in range(3):
        assert torch.equal(got[b], ps.pipeline_dense_step(
            x[b], 0.1, block=(16, 128), nsteps=4))


def test_closed_form_constants_are_jax_weak_floats():
    """The closed form's constants are formed in f64 (the TPU kernel's
    Python floats) and rounded to f32 once."""
    moore, a, b = fs.closed_constants(0.1, MOORE_OFFSETS)
    assert moore and a == 1.0 - 0.1 - 0.1 / 8.0 and b == 0.1 / 8.0
    moore, a, b = fs.closed_constants(0.1, tuple(reversed(MOORE_OFFSETS)))
    assert moore  # Moore in any order
    moore, a, b = fs.closed_constants(0.1, VON_NEUMANN_OFFSETS)
    assert not moore and a == 1.0 - 0.1 and b == 0.1 / 4.0


def test_wrapper_contract_on_cpu():
    x = torch.from_numpy(_grid((16, 128)))
    # bf16 interior math is accepted; at 16 x 128 no TPU tile is closed,
    # so it is the f32 result bit for bit
    assert torch.equal(fs.pallas_dense_step(x, 0.1, pipeline=True,
                                            compute_dtype=torch.bfloat16),
                       ps.pipeline_step_plain(x, 0.1))
    with pytest.raises(ValueError, match=r"\[B, H, W\]"):
        ps.pipeline_dense_step(x[0], 0.1)
    before = ps.launches()
    out = torch.empty_like(x)
    res = ps.pipeline_dense_step(x, 0.1, nsteps=2, out=out)
    assert res is out and torch.equal(out, ps.pipeline_step_plain(x, 0.1,
                                                                  nsteps=2))
    # a CPU call runs the plain version: no kernel launched, none counted
    assert ps.launches() == before
    assert mt.models.model.kernel_launches()["pipeline_stencil"] == before


def test_empty_batch_launches_nothing():
    before = ps.launches()
    ps._launch(torch.empty((0, 16, 128)), torch.empty((0, 16, 128)), 0.1,
               MOORE_OFFSETS, 1, (16, 128))
    assert ps.launches() == before
