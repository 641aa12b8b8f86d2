"""K1's per-cell form choice (``ops/fused_stencil.py``) on the CPU.

After ``n`` fused steps a cell whose distance ``d = min(R, H-1-R, C,
W-1-C)`` to the grid's edge exceeds ``n`` takes the closed form
(``closed_steps_plain``: Moore through separable band sums, other
neighbourhoods ``v·(1-r) + (r/k)·Σ``); every other cell takes the exact
masked path (``exact_dense_step_plain``). The CUDA kernels K1 and K2 are
held against these plain versions bit for bit on the card
(``chip_smoke.py``).

- ``dense_step_plain`` is, cell for cell, one of its two forms, bit for
  bit, and the choice is ``closed_mask``'s.
- Against the JAX package's ``pallas_dense_step`` in interpret mode (which
  chooses per TPU tile and, at nsteps=1, takes the closed form everywhere
  with a divisor correction on ring tiles): within ``2·eps32·n·max|v|``,
  plus one bf16 ulp of the scale at bf16, where the two round a value to
  different sides.
- Against the f64 oracle (``oracle.dense_flow_step_np``, n steps): within
  ``4·eps·n·max|v|`` of the storage dtype (the two forms each round about
  four times a cell-step); with a symmetric neighbourhood the f32 total
  moves by at most ``4·eps32·n·Σ|v|``.
- Shards stepped by ``halo_step_plain`` and put together equal
  ``dense_step_plain`` bit for bit, on 2-D and 1-D meshes whose seams fall
  both inside the edge band (``d <= n``) and beyond it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpi_model_tpu.oracle import dense_flow_step_np
from mpi_model_tpu.ops.pallas_stencil import pallas_dense_step as jax_step

from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS, VON_NEUMANN_OFFSETS
from mpi_model_tpu_torch.ops import fused_stencil as fs
from mpi_model_tpu_torch.parallel import exchange_ring

CUSTOM = ((-1, 0), (1, 1), (0, -1))
HOODS = {"moore": MOORE_OFFSETS, "von_neumann": VON_NEUMANN_OFFSETS,
         "custom": CUSTOM}
EPS = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -8}
NSTEPS = (1, 2, 4, 8, 16)
RATE = 0.13


@pytest.fixture(autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread keeps the file steady under
    xdist."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _grid(shape, seed, dtype=torch.float32):
    v = np.random.default_rng(seed).uniform(0.5, 2.0, shape)
    return torch.from_numpy(v.astype(np.float32)).to(dtype)


def _bf16_ulp(scale: float) -> float:
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hood", list(HOODS))
@pytest.mark.parametrize("ns", NSTEPS)
def test_each_cell_takes_its_form_bit_for_bit(ns, hood, dtype):
    offs = HOODS[hood]
    for shape, seed in (((40, 300), 1), ((64, 512), 2)):
        x = _grid(shape, seed, dtype)
        got = fs.dense_step_plain(x, RATE, offs, ns)
        assert got.dtype == dtype and got.shape == x.shape
        exact = fs.exact_dense_step_plain(x, RATE, offs, ns)
        closed = fs.closed_steps_plain(x.float(), RATE, offs, ns).to(dtype)
        inside = fs.closed_mask(shape, ns)
        h, w = shape
        rows = torch.arange(h)[:, None]
        cols = torch.arange(w)[None, :]
        d = torch.minimum(torch.minimum(rows, h - 1 - rows),
                          torch.minimum(cols, w - 1 - cols))
        assert torch.equal(inside, d > ns)
        assert bool(inside.any()) == (min(h, w) > 2 * ns + 2)
        assert torch.equal(got[inside], closed[inside])
        assert torch.equal(got[~inside], exact[~inside])


@pytest.mark.parametrize("hood", list(HOODS))
@pytest.mark.parametrize("dtype,ns", [
    (torch.float32, 1), (torch.float32, 2), (torch.float32, 4),
    (torch.float32, 8), (torch.bfloat16, 1), (torch.bfloat16, 2),
    (torch.bfloat16, 4), (torch.bfloat16, 8), (torch.bfloat16, 16)],
    ids=lambda v: str(v).removeprefix("torch."))
def test_close_to_jax_pallas_interpret(dtype, ns, hood):
    """Blocks small enough that the JAX kernel has interior tiles: (8, 128)
    at f32, (16, 128) at bf16 (its ghost depth is the block's sublane)."""
    offs = HOODS[hood]
    block = (8, 128) if dtype == torch.float32 else (16, 128)
    x = _grid((64, 512), 5, dtype)
    got = fs.pallas_dense_step(x, RATE, offs, block=block, nsteps=ns)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jax_step(jnp.asarray(x.float().numpy(), jdt), RATE,
                               offsets=offs, block=block, interpret=True,
                               nsteps=ns)).astype(np.float32)
    g32 = got.float().numpy()
    scale = float(np.abs(want).max())
    tol = 2 * EPS[torch.float32] * ns * scale
    if dtype == torch.bfloat16:
        tol += _bf16_ulp(scale)
    assert float(np.abs(g32 - want).max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hood", list(HOODS))
@pytest.mark.parametrize("ns", NSTEPS)
def test_matches_oracle_and_conserves(ns, hood, dtype):
    offs = HOODS[hood]
    x = _grid((64, 512), 7, dtype)
    got = fs.dense_step_plain(x, RATE, offs, ns)
    ref = x.double().numpy()
    for _ in range(ns):
        ref = dense_flow_step_np(ref, RATE, offsets=offs)
    scale = float(np.abs(ref).max())
    err = float(np.abs(got.double().numpy() - ref).max())
    assert err <= 4 * EPS[dtype] * ns * scale + (
        _bf16_ulp(scale) if dtype == torch.bfloat16 else 0.0)
    if dtype == torch.float32 and hood != "custom":
        # the total, summed in f64 so the sum adds no error of its own (a
        # cell gathers its neighbours' shares at +d, so only a symmetric
        # neighbourhood conserves mass)
        moved = abs(float(got.double().sum()) - float(x.double().sum()))
        assert moved <= 4 * EPS[dtype] * ns * float(x.double().abs().sum())


def _mosaic(x, row_cuts, col_cuts, offs, ns):
    """Cut ``x`` at the given rows and columns, step every shard with
    ``halo_step_plain`` and its exchanged ring, put the shards together."""
    g = [[x[r0:r1, c0:c1].contiguous()
          for c0, c1 in zip(col_cuts, col_cuts[1:])]
         for r0, r1 in zip(row_cuts, row_cuts[1:])]
    out = [[fs.halo_step_plain(g[i][j], exchange_ring(g, i, j, ns),
                               (row_cuts[i], col_cuts[j]), tuple(x.shape),
                               RATE, offs, ns)
            for j in range(len(g[0]))] for i in range(len(g))]
    return torch.cat([torch.cat(row, dim=1) for row in out], dim=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hood", list(HOODS))
@pytest.mark.parametrize("mesh", ["2d", "1d"])
@pytest.mark.parametrize("ns", NSTEPS)
def test_halo_mosaic_equals_the_whole_grid(ns, mesh, hood, dtype):
    """Seams at row and column ``ns`` (the first shard exactly as deep as
    the ring, every cell beside the seam in the exact band) and deep inside
    the grid (the closed form on both sides of the seam)."""
    H, W = 4 * ns + 40, 4 * ns + 90
    x = _grid((H, W), 11 + ns, dtype)
    rows = [0, ns, H // 2 + 3, H]
    cols = [0, ns, W // 2 - 5, W] if mesh == "2d" else [0, W]
    offs = HOODS[hood]
    whole = fs.dense_step_plain(x, RATE, offs, ns)
    assert bool(fs.closed_mask((H, W), ns).any())
    assert torch.equal(_mosaic(x, rows, cols, offs, ns), whole)
