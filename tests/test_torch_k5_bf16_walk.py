"""K5's bf16 interior math as two launches, and K7's lane walk, on the CPU.

On the card a K5 call with ``compute_dtype=bfloat16`` and Moore in its
row-major order is two launches (``csrc/pipeline_stencil.cu``): the near
launch steps the windows of JAX's near TPU tiles (the exact path), and the
paired launch tiles each lane's rectangle of closed tiles from its origin
with K1's paired walk (two rows a bf16x2 register, the bands kept between a
step's passes). K7 (``csrc/fused_active.cu``) is a persistent grid whose
warps walk the live lanes' rows. Here, without a card:

- (a) the rectangle the paired launch covers (``ps.plan_of``,
  ``ps.paired_tiles``) is exactly the closed cells of ``ps.interior_mask``,
  over JAX's blocks at 4096² (no closed tile) and 8192², grids of two and
  three TPU tiles a side and callers' blocks, at ns 1, 2, 3 and 8;
- (b) a mirror of both launches' geometry with the lane axis writes every
  output cell of every lane exactly once;
- (c) an emulation of the paired walk in torch, tile by tile on the
  kernel's tiling, every lane at once (the lane axis), with the near cells
  from the plain exact path: bit for bit ``pipeline_step_plain(...,
  compute_dtype=bfloat16)`` at ns 1, 2 and 8;
- (d) the same emulation against JAX's ``_pipeline_call`` in interpret mode
  within ``tests/test_torch_compute_dtype.py``'s tolerances (near cells
  ``4·eps32·n·max|v|``, bf16 cells one bf16 ulp of the value scale);
- K7: the walk's mirror (``fa.scatter_blocks``, ``fa.scatter_rows``: the
  rows of the ``clip(count, 1, K)`` live lanes, each once) and
  ``fused_scatter_plain``
  against JAX's ``_fused_scatter_call`` in interpret mode, bit for bit, at
  count 0, 1, some and K, rings 1 and 8, itemsizes 2, 4 and 8.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mpi_model_tpu.ops import active as jact
from mpi_model_tpu.ops import pallas_active as jpa
from mpi_model_tpu.ops import pallas_stencil as jps

from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS, VON_NEUMANN_OFFSETS
from mpi_model_tpu_torch.ops import active as act
from mpi_model_tpu_torch.ops import fused_active as fa
from mpi_model_tpu_torch.ops import fused_stencil as fs
from mpi_model_tpu_torch.ops import pipeline_stencil as ps

torch.set_num_threads(1)

BF = torch.bfloat16
RATE = 0.13
EPS32 = 2.0 ** -23

#: (grid, block) of the geometry cases: JAX's blocks (512, 2048) at the
#: ensemble's 4096² (every tile near) and at 8192² (28 closed tiles of 64),
#: two TPU tiles a side (none closed), three (one), a caller's block, and
#: an odd grid whose 1152-wide tiles the windows do not divide
K5_GEOMETRIES = {"jax_4096": ((4096, 4096), None),
                 "jax_8192": ((8192, 8192), None),
                 "two_tiles": ((64, 256), (32, 128)),
                 "three_tiles": ((96, 384), (32, 128)),
                 "caller": ((1024, 1024), (128, 256)),
                 "odd": ((240, 3456), (48, 1152))}


def _chain(tiles, region):
    """The tiles (each ``(r0, r1, c0, c1)``) partition ``region``: their
    row spans chain from its first row to its last without a gap or an
    overlap, their column spans likewise, and every (row span, column
    span) pair is one tile."""
    r0, r1, c0, c1 = region
    if r0 >= r1 or c0 >= c1:
        return tiles == []
    rows = sorted({(t[0], t[1]) for t in tiles})
    cols = sorted({(t[2], t[3]) for t in tiles})
    return (rows[0][0] == r0 and rows[-1][1] == r1
            and all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
            and cols[0][0] == c0 and cols[-1][1] == c1
            and all(a[1] == b[0] for a, b in zip(cols, cols[1:]))
            and len(tiles) == len(rows) * len(cols)
            and {tuple(t[:4]) for t in tiles}
            == {(a, b, c, d) for a, b in rows for c, d in cols})


# -- (a) the paired launch's rectangle ----------------------------------------

@pytest.mark.parametrize("ns", [1, 2, 3, 8])
@pytest.mark.parametrize("geometry", sorted(K5_GEOMETRIES))
def test_k5_paired_rectangle_is_the_closed_tiles(geometry, ns):
    shape, block = K5_GEOMETRIES[geometry]
    blk = ps.pipeline_block(shape, ns, block)
    plan = ps.plan_of(shape, blk, ns, MOORE_OFFSETS, BF)
    two, rows, _, rows16, tiles, r0, r1, c0, c1, _ = plan
    assert two == 1 and rows == ps.window_rows(MOORE_OFFSETS, ns)
    assert rows16 == (64 if ns <= 2 else 96)
    mask = ps.interior_mask(shape, blk, ns)
    rect = torch.zeros_like(mask)
    rect[r0:r1, c0:c1] = True
    assert torch.equal(rect, mask)
    paired = ps.paired_tiles(shape, blk, ns)
    assert len(paired) == tiles
    assert _chain(paired, (r0, r1, c0, c1))
    closed = {"jax_4096": False, "two_tiles": False}.get(geometry, True)
    assert bool(mask.any()) == closed and (tiles > 0) == closed
    if geometry == "jax_8192":
        assert (r0, r1, c0, c1) == (512, 7680, 2048, 6144)
    # the f32-compute call and other offsets: one launch, every window
    for offs, cd in ((MOORE_OFFSETS, None), (VON_NEUMANN_OFFSETS, BF),
                     (tuple(reversed(MOORE_OFFSETS)), BF)):
        one = ps.plan_of(shape, blk, ns, offs, cd)
        assert one[0] == 0 and one[3:] == (0,) * 7
        assert one[2] == len(ps.launch_windows(shape, blk, ns, offs))


# -- (b) both launches cover every cell of every lane once ----------------------

def _launch_writes(shape, block, ns, lanes):
    """What the two launches write, in their grids' order (lane = grid y):
    ``(lane, r0, r1, c0, c1)`` for every near window and paired tile."""
    near = ps.near_launch_windows(shape, block, ns)
    paired = ps.paired_tiles(shape, block, ns)
    return ([(b, *w[:4]) for b in range(lanes) for w in near],
            [(b, *t) for b in range(lanes) for t in paired])


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("ns", [1, 2, 3, 8])
@pytest.mark.parametrize("geometry", sorted(K5_GEOMETRIES))
def test_k5_launches_cover_every_lane_once(geometry, ns, lanes, dtype):
    shape, block = K5_GEOMETRIES[geometry]
    h, w = shape
    blk = ps.pipeline_block(shape, ns, block)
    near, paired = _launch_writes(shape, blk, ns, lanes)
    plan = ps.plan_of(shape, blk, ns, MOORE_OFFSETS, BF)
    assert len(near) == lanes * plan[2] and len(paired) == lanes * plan[4]
    assert plan[9] == len(ps.near_tiles(shape, blk, ns))
    # every near window lies in one near TPU tile, and writes only it
    br, bc = blk
    tiles = set(ps.near_tiles(shape, blk, ns))
    mask = ps.interior_mask(shape, blk, ns)
    for _, r0, r1, c0, c1 in near[:len(near) // lanes]:
        g = (r0 // br * br, c0 // bc * bc)
        assert g in tiles and r1 <= g[0] + br and c1 <= g[1] + bc
        assert not bool(mask[g[0], g[1]])
    if h * w <= 1 << 22:
        # the writes, made on a NaN-filled batch of the storage type: each
        # cell written once (NaN before its write), every cell written
        x = _lanes(lanes, shape, dtype, ns)
        out = torch.full_like(x, float("nan"))
        for b, r0, r1, c0, c1 in near + paired:
            assert bool(torch.isnan(out[b, r0:r1, c0:c1]).all())
            out[b, r0:r1, c0:c1] = x[b, r0:r1, c0:c1]
        assert torch.equal(out, x)
    else:
        # the near windows of each near TPU tile partition it; the near
        # tiles and the rectangle partition the grid
        by_tile = {}
        for _, r0, r1, c0, c1 in near[:len(near) // lanes]:
            by_tile.setdefault((r0 // br * br, c0 // bc * bc), []).append(
                (r0, r1, c0, c1))
        assert set(by_tile) == tiles
        for (a, c), ws in by_tile.items():
            assert _chain(ws, (a, a + br, c, c + bc))
        r0, r1, c0, c1 = plan[5:9]
        assert len(tiles) * br * bc + (r1 - r0) * (c1 - c0) == h * w


# -- (c) the paired walk, emulated with the lane axis --------------------------

def _paired_walk(win, a, b, nsteps):
    """The paired launch's walk on a batch of windows ([lanes, rows, 256]
    bf16 values in f32, zeros beyond each window) in the kernel's order:
    pair m holds window rows 2m (low) and 2m + 1 (high); the rows above and
    below a pair straddle it and its neighbour (the window's first pair has
    0 above, its last 0 below); band = (above + pair) + below; the columns
    beside from the neighbouring threads (0 beyond the window); nine =
    (left + band) + right; v * a + nine * b; every operation rounded to
    bf16."""
    lanes, rows, cols = win.shape
    w = win.reshape(lanes, rows // 2, 2, cols)
    zero = torch.zeros(lanes, 1, cols)
    for _ in range(nsteps):
        lo, hi = w[:, :, 0], w[:, :, 1]
        up = torch.stack([torch.cat([zero, hi[:, :-1]], 1), lo], 2)
        dn = torch.stack([hi, torch.cat([lo[:, 1:], zero], 1)], 2)
        band = fs.rb(fs.rb(up + w) + dn)
        left = F.pad(band, (1, 0))[..., :cols]
        right = F.pad(band, (0, 1))[..., 1:]
        nine = fs.rb(fs.rb(left + band) + right)
        w = fs.rb(fs.rb(w * a) + fs.rb(nine * b))
    return w.reshape(lanes, rows, cols)


def _emulated(x, block, ns):
    """What the two launches write on every lane of ``x`` ([B, H, W]): the
    near cells from the plain exact path over the f32 grid (the near
    launch's form), the rectangle's cells from the paired walk over the
    grid rounded to bf16, tile by tile on the paired launch's tiling, all
    lanes of a tile at once."""
    _, a, b = fs.closed_constants(RATE, MOORE_OFFSETS)
    a, b = fs.round_bf16(a), fs.round_bf16(b)
    rows = fs.paired_rows(ns, MOORE_OFFSETS)
    v = x.float()
    out = fs.exact_dense_step_plain(v, RATE, MOORE_OFFSETS, ns)
    src = F.pad(fs.rb(v), (0, fs.WINDOW_COLS, 0, rows))  # past the end
    for r0, r1, c0, c1 in ps.paired_tiles(tuple(x.shape[-2:]), block, ns):
        win = src[:, r0 - ns:r0 - ns + rows, c0 - ns:c0 - ns + fs.WINDOW_COLS]
        res = _paired_walk(win.clone(), a, b, ns)
        out[:, r0:r1, c0:c1] = res[:, ns:ns + r1 - r0, ns:ns + c1 - c0]
    return out.to(x.dtype)


def _lanes(lanes, shape, dtype, seed):
    v = np.random.default_rng(seed).uniform(0.5, 2.0, (lanes,) + shape)
    return torch.from_numpy(v.astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("ns", [1, 2, 8])
@pytest.mark.parametrize("geometry", ["caller_cut", "odd"])
def test_k5_paired_walk_emulation_is_the_plain_version(geometry, ns, dtype):
    lanes, shape, block = {"caller_cut": (2, (512, 1024), (128, 256)),
                           "odd": (3, (240, 3456), (48, 1152))}[geometry]
    x = _lanes(lanes, shape, dtype, 17 + ns)
    blk = ps.pipeline_block(shape, ns, block)
    assert ps.paired_tiles(shape, blk, ns)
    got = _emulated(x, blk, ns)
    want = ps.pipeline_step_plain(x, RATE, MOORE_OFFSETS, ns, block, BF)
    bits = torch.int16 if dtype == BF else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))


# -- (d) against the JAX kernel -----------------------------------------------

@pytest.mark.parametrize("ns", [1, 4])
def test_k5_paired_walk_emulation_against_jax(ns):
    """The emulated two launches against JAX's ``_pipeline_call`` in
    interpret mode (through ``pallas_dense_step(pipeline=True)``): near
    cells within ``4·eps32·n·max|v|``, bf16 cells within one bf16 ulp of
    the value scale (``tests/test_torch_compute_dtype.py``)."""
    shape, block = (64, 512), (16, 128)
    x = _lanes(1, shape, torch.float32, 14)
    got = _emulated(x, block, ns)[0].numpy().astype(np.float64)
    want = np.asarray(jps.pallas_dense_step(
        jnp.asarray(x[0].numpy()), RATE, block=block, nsteps=ns,
        interpret=True, pipeline=True,
        compute_dtype=jnp.bfloat16)).astype(np.float64)
    inner = ps.interior_mask(shape, block, ns).numpy()
    assert inner.any() and (~inner).any()
    d = np.abs(got - want)
    scale = float(np.abs(want).max())
    assert d[~inner].max() <= 4 * EPS32 * ns * scale
    assert d[inner].max() <= 2.0 ** (math.floor(math.log2(scale)) - 7)


# -- K7 -----------------------------------------------------------------------

@pytest.mark.parametrize("capacity,tile_h", [(1, 128), (7, 16), (264, 128),
                                             (300, 40), (4096, 128)])
@pytest.mark.parametrize("sms", [1, 132])
def test_k7_walk_lands_each_live_row_once(capacity, tile_h, sms):
    """K7's grid (``scatter_blocks``) and its walk over the live lanes'
    rows (``scatter_rows``): every row of the lanes ``l < clip(count, 1,
    K)`` once, no row of another lane, each warp's rows in runs of
    ``SCATTER_ROWS``."""
    blocks = fa.scatter_blocks(capacity, sms)
    assert 1 <= blocks == min(capacity, fa.SCATTER_BLOCKS_PER_SM * sms)
    warps = blocks * 8
    for count in (0, 1, capacity // 2, capacity, capacity + 5, -3):
        walk = fa.scatter_rows(count, capacity, tile_h, warps)
        assert len(walk) == warps
        n = int(np.clip(count, 1, capacity))  # JAX's jnp.clip
        landed = sorted(x for w in walk for x in w)
        assert landed == [(l, i) for l in range(n) for i in range(tile_h)]
        for w, rows in enumerate(walk):
            flat = [l * tile_h + i for l, i in rows]
            assert all(r // fa.SCATTER_ROWS % warps == w for r in flat)


_K7_DTYPES = {2: (torch.bfloat16, jnp.bfloat16),
              4: (torch.float32, np.float32),
              8: (torch.float64, np.float64)}


@pytest.mark.parametrize("itemsize", [2, 4, 8])
@pytest.mark.parametrize("ring", [1, 8])
@pytest.mark.parametrize("count", ["zero", "one", "some", "all"])
def test_k7_plain_is_jax_bit_for_bit(itemsize, ring, count):
    """``fused_scatter_plain`` against JAX's ``_fused_scatter_call``
    (interpret mode): the live lanes' tiles land at their places, the rest
    of the state (NaN here) keeps its bits."""
    tdt, jdt = _K7_DTYPES[itemsize]
    tile, grid = (8, 16), (3, 4)
    shape = (grid[0] * tile[0], grid[1] * tile[1])
    plan = act.plan_for(shape, tile=tile, max_active_frac=1.0)
    jplan = jact.plan_for(shape, tile=tile, max_active_frac=1.0)
    K = plan.capacity
    n = {"zero": 0, "one": 1, "some": K // 3, "all": K}[count]
    rng = np.random.default_rng(itemsize * 10 + ring + n)
    upd = rng.uniform(-2.0, 2.0, (K,) + tile)
    ids = rng.permutation(K).astype(np.int32)
    padded = np.full((shape[0] + 2 * ring, shape[1] + 2 * ring), np.nan)
    # the quiet NaN of the type (a bf16 one by its bits: torch's f64 to
    # bf16 conversion may give another NaN, which JAX's copy makes quiet)
    tp = (torch.full(padded.shape, 0x7FC0, dtype=torch.int16).view(tdt)
          if itemsize == 2 else torch.from_numpy(padded).to(tdt))
    tu = torch.from_numpy(upd).to(tdt)
    got = fa.fused_scatter_plain(tp.clone(), tu, torch.from_numpy(ids), n,
                                 plan, ring)
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[itemsize]

    def to_jax(t):  # the same bits, as JAX's dtype
        return jnp.asarray(t.view(bits).numpy().view(jdt))

    want = jpa._fused_scatter_call(
        to_jax(tp), to_jax(tu), jnp.asarray(ids),
        jnp.asarray([n], dtype=jnp.int32), plan=jplan, ring=ring,
        interpret=True)
    want_bits = torch.from_numpy(np.array(want).view(
        {2: np.int16, 4: np.int32, 8: np.int64}[itemsize]))
    assert torch.equal(got.view(bits), want_bits)
    live = int(np.clip(n, 1, K))
    assert int(torch.isnan(got.float()).sum()) == (
        padded.size - live * tile[0] * tile[1])
