"""K1/K2's bf16 interior math as two launches, on the CPU.

On the card a K1/K2 call with ``compute_dtype=bfloat16`` at ``nsteps > 1``
is two launches: the near launch tiles the four bands of the array around
the bf16 rectangle with the f32 walk's windows, and the paired launch tiles
the rectangle with windows of its own rows, walking two rows a bf16x2
register (``csrc/fused_stencil.cu``). Here, without a card:

- the split and the tilings (``fs.bf16_regions``, ``fs.region_tiles``):
  the paired launch's tiles cover exactly the rectangle, the near launch's
  exactly its complement, every cell once between them, on K1 grids and
  on the shards of K2's 2×2 and 4-stripe meshes (an empty rectangle, an
  empty near band);
- the paired rows rule (``fs.paired_rows``);
- an emulation of the paired walk in torch, tile by tile on the kernel's
  tiling, in the kernel's pair order (rows 2m and 2m + 1 a word, the rows
  above and below by straddling two words, every operation rounded to
  bf16), with the near cells from the f32 forms over the grid rounded to
  bf16: bit for bit ``dense_step_plain`` / ``halo_step_plain(...,
  compute_dtype=bfloat16)`` at nsteps 2, 4 and 16, and against the JAX
  kernel in interpret mode within ``tests/test_torch_compute_dtype.py``'s
  tolerances (near cells ``4·eps32·n·max|v|``, bf16 cells one bf16 ulp of
  the value scale).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mpi_model_tpu.ops import pallas_stencil as jps

from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS, VON_NEUMANN_OFFSETS
from mpi_model_tpu_torch.ops import fused_stencil as fs
from mpi_model_tpu_torch.parallel.halo import exchange_ring

torch.set_num_threads(1)

BF = torch.bfloat16
RATE = 0.13

#: (grid, block) of the K1 cases: a rectangle whose edges cut the tiles, an
#: odd one (block columns of 200), the main path's grid at JAX's blocks
K1_GEOMETRIES = {"cut": ((512, 1024), (64, 128)),
                 "odd": ((336, 1000), (48, 200)),
                 "main": ((16384, 16384), None)}


def _covers_exactly(tiles, region):
    """The tiles (each ``(r0, r1, c0, c1)``) partition ``region``: each
    lies in it, their row spans chain from its first row to its last
    without a gap or an overlap, their column spans likewise, and every
    (row span, column span) pair is one tile."""
    r0, r1, c0, c1 = region
    if r0 >= r1 or c0 >= c1:
        return tiles == []
    rows = sorted({(t[0], t[1]) for t in tiles})
    cols = sorted({(t[2], t[3]) for t in tiles})
    chain = (rows[0][0] == r0 and rows[-1][1] == r1
             and all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
             and cols[0][0] == c0 and cols[-1][1] == c1
             and all(a[1] == b[0] for a, b in zip(cols, cols[1:])))
    return (chain and len(tiles) == len(rows) * len(cols)
            and {(t[0], t[1], t[2], t[3]) for t in tiles}
            == {(a, b, c, d) for a, b in rows for c, d in cols})


def _area(region):
    r0, r1, c0, c1 = region
    return max(r1 - r0, 0) * max(c1 - c0, 0)


def _overlap(a, b):
    return (max(a[0], b[0]) < min(a[1], b[1])
            and max(a[2], b[2]) < min(a[3], b[3]))


def _check_split(shape, rect, nsteps, offsets=MOORE_OFFSETS):
    """The two launches' tiles write every cell of the [h, w] array once:
    the paired launch's exactly the rectangle, the near launch's exactly
    the rest. Returns (paired tiles, near tiles)."""
    h, w = shape
    inner, bands = fs.bf16_regions(shape, rect)
    regions = [inner, *bands]
    assert sum(_area(r) for r in regions) == h * w
    for i, a in enumerate(regions):
        assert 0 <= a[0] and a[1] <= h and 0 <= a[2] and a[3] <= w
        for b in regions[i + 1:]:
            assert not (_area(a) and _area(b) and _overlap(a, b))
    r0, r1, c0, c1 = rect
    if r0 < r1 and c0 < c1:
        assert inner == tuple(rect)
    else:
        assert _area(inner) == 0
    paired = fs.region_tiles(inner, fs.paired_rows(nsteps, offsets), nsteps)
    assert _covers_exactly(paired, inner)
    near = []
    for band in bands:
        tiles = fs.region_tiles(band, fs.window_rows(nsteps, offsets),
                                nsteps)
        assert _covers_exactly(tiles, band)
        near += tiles
    if h * w <= 1 << 22:
        seen = np.zeros(shape, np.int32)
        for a, b, c, d in paired + near:
            seen[a:b, c:d] += 1
        assert (seen == 1).all()
        want = np.zeros(shape, bool)
        if _area(inner):
            want[r0:r1, c0:c1] = True
        got = np.zeros(shape, bool)
        for a, b, c, d in paired:
            got[a:b, c:d] = True
        assert (got == want).all()
    return paired, near


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("geometry", sorted(K1_GEOMETRIES))
def test_k1_launches_cover_the_grid_once(geometry, dtype):
    shape, block = K1_GEOMETRIES[geometry]
    blk = fs.resolve_block(shape, dtype, block)
    for ns in range(2, fs.ghost_depth(shape, dtype, block) + 1):
        for offs in (MOORE_OFFSETS, VON_NEUMANN_OFFSETS):
            rect = fs.bf16_rect(shape, blk, ns)
            paired, near = _check_split(shape, rect, ns, offs)
            assert paired and near


def _shard_rects(gshape, mesh, dtype, ns, block=None):
    lines, columns = mesh
    h, w = gshape[0] // lines, gshape[1] // columns
    out = {}
    for i in range(lines):
        for j in range(columns):
            org = (i * h, j * w)
            blk = fs.resolve_block((h, w), dtype, block)
            out[org] = ((h, w), fs.bf16_rect((h, w), blk, ns, org, gshape))
    return out


#: (global grid, mesh, block) of the K2 cases; only the tilings' index
#: arithmetic runs at these shapes, no grid is built
K2_MESHES = {"main_2x2": ((16384, 16384), (2, 2), None),
             "main_stripes": ((16384, 16384), (4, 1), None),
             "cut_2x2": ((2048, 2560), (2, 2), None),
             # every tile near: no rectangle
             "near_stripes": ((96, 768), (4, 1), None),
             # the inner shards lie in the rectangle: no near band
             "inner_4x4": ((4096, 4096), (4, 4), (512, 512))}


@pytest.mark.parametrize("mesh_name", sorted(K2_MESHES))
@pytest.mark.parametrize("ns", [2, 8])
def test_k2_launches_cover_every_shard_once(mesh_name, ns):
    gshape, mesh, block = K2_MESHES[mesh_name]
    kinds = set()
    for org, (shape, rect) in _shard_rects(gshape, mesh, torch.float32, ns,
                                           block).items():
        paired, near = _check_split(shape, rect, ns)
        kinds.add((bool(paired), bool(near)))
        # the kernel's rectangle is the shard's, moved to its origin
        got = fs.kernel_rect(shape, torch.float32, block, ns, BF, org,
                             gshape)
        assert tuple(g - o for g, o in zip(got, (org[0], org[0], org[1],
                                                 org[1]))) == rect
    if mesh_name == "near_stripes":
        assert kinds == {(False, True)}   # one launch: the near walk alone
    if mesh_name == "inner_4x4":
        assert (True, False) in kinds     # one launch: the paired walk alone


def test_paired_rows_rule():
    for ns in range(2, 17):
        rows = fs.paired_rows(ns, MOORE_OFFSETS)
        assert rows in fs.PAIRED_ROWS
        # pairs published four at a time, a tile left between the halos,
        # the pairs and their bands at most 96 words a thread (two blocks
        # an SM)
        assert rows % 8 == 0 and rows - 2 * ns >= 1 and rows <= 96
        assert fs.paired_rows(ns, VON_NEUMANN_OFFSETS) == 48
        assert fs.window_rows(ns, VON_NEUMANN_OFFSETS) == 48
        assert fs.window_rows(ns, MOORE_OFFSETS) == (64 if ns > 2 else 48)
    assert all(r % 8 == 0 for r in fs.PAIRED_ROWS)


# -- the paired walk, emulated ------------------------------------------------

def _paired_walk(win, a, b, nsteps):
    """The paired launch's walk on one window ([rows, 256] bf16 values in
    f32, zeros beyond the window) in the kernel's order: pair m holds
    window rows 2m (low) and 2m + 1 (high); the rows above and below a pair
    straddle it and its neighbour (the window's first pair has 0 above,
    its last 0 below); band = (above + pair) + below; the columns beside
    from the neighbouring threads (0 beyond the window); nine = (left +
    band) + right; v * a + nine * b; every operation rounded to bf16."""
    rows, cols = win.shape
    w = win.reshape(rows // 2, 2, cols)
    zero = torch.zeros(1, cols)
    for _ in range(nsteps):
        lo, hi = w[:, 0], w[:, 1]
        up = torch.stack([torch.cat([zero, hi[:-1]]), lo], 1)
        dn = torch.stack([hi, torch.cat([lo[1:], zero])], 1)
        band = fs.rb(fs.rb(up + w) + dn)
        left = F.pad(band, (1, 0))[..., :cols]
        right = F.pad(band, (0, 1))[..., 1:]
        nine = fs.rb(fs.rb(left + band) + right)
        w = fs.rb(fs.rb(w * a) + fs.rb(nine * b))
    return w.reshape(rows, cols)


def _emulated(padded, d, shape, rect, nsteps, near):
    """What the two launches write on the [h, w] array whose padded form
    (the array with d cells of ring, bf16 values in f32, zero off the grid)
    is ``padded``: ``near`` (the f32 forms over it) with the rectangle's
    cells from the paired walk, tile by tile on the kernel's tiling."""
    _, a, b = fs.closed_constants(RATE, MOORE_OFFSETS)
    a, b = fs.round_bf16(a), fs.round_bf16(b)
    rows = fs.paired_rows(nsteps, MOORE_OFFSETS)
    inner, _ = fs.bf16_regions(shape, rect)
    src = F.pad(padded, (0, fs.WINDOW_COLS, 0, rows))  # reads past the end
    out = near.clone()
    n = nsteps
    for r0, r1, c0, c1 in fs.region_tiles(inner, rows, n):
        wr, wc = r0 - n + d, c0 - n + d  # the window in padded coordinates
        win = src[wr:wr + rows, wc:wc + fs.WINDOW_COLS]
        res = _paired_walk(win.clone(), a, b, n)
        out[r0:r1, c0:c1] = res[n:n + r1 - r0, n:n + c1 - c0]
    return out


def _grid(shape, dtype, seed):
    v = np.random.default_rng(seed).uniform(0.5, 2.0, shape)
    return torch.from_numpy(v.astype(np.float32)).to(dtype)


def _k1_emulated(x, block, ns):
    v = fs.rb(x.float())
    near = fs.dense_step_plain(v, RATE, MOORE_OFFSETS, ns)
    rect = fs.bf16_rect(tuple(x.shape), fs.resolve_block(
        tuple(x.shape), x.dtype, block), ns)
    return _emulated(v, 0, tuple(x.shape), rect, ns, near).to(x.dtype)


@pytest.mark.parametrize("ns", [2, 4, 16])
@pytest.mark.parametrize("geometry", ["cut", "odd"])
def test_paired_walk_emulation_is_the_plain_version(geometry, ns):
    shape, block = K1_GEOMETRIES[geometry]
    dtype = BF if ns > 8 else torch.float32  # f32's ghost depth is 8
    x = _grid(shape, dtype, 11 + ns)
    want = fs.dense_step_plain(x, RATE, MOORE_OFFSETS, ns, BF, block)
    got = _k1_emulated(x, block, ns)
    bits = torch.int16 if dtype == BF else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.parametrize("ns", [2, 4, 16])
@pytest.mark.parametrize("mesh", [(2, 2), (4, 1)])
def test_paired_walk_emulation_on_shards_is_the_plain_version(mesh, ns):
    gshape = (1024, 2048)
    dtype = BF if ns > 8 else torch.float32
    x = _grid(gshape, dtype, 5)
    lines, columns = mesh
    h, w = gshape[0] // lines, gshape[1] // columns
    g = [[x[i * h:(i + 1) * h, j * w:(j + 1) * w].contiguous()
          for j in range(columns)] for i in range(lines)]
    # one block for the grid and its shards: the same bf16 cells
    block = (64, 128)
    whole = fs.dense_step_plain(x, RATE, MOORE_OFFSETS, ns, BF, block)
    for i in range(lines):
        for j in range(columns):
            org = (i * h, j * w)
            ring = exchange_ring(g, i, j, ns)
            vr = fs.rb(g[i][j].float())
            ringr = {p: fs.rb(t.float()) for p, t in ring.items()}
            _, mask, _ = fs.padded_region(vr, ringr, org, gshape,
                                          MOORE_OFFSETS)
            padded = torch.where(mask, fs.pad_from_ring(vr, ringr), 0.0)
            near = fs.halo_step_plain(vr, ringr, org, gshape, RATE,
                                      MOORE_OFFSETS, ns)
            rect = fs.bf16_rect((h, w), block, ns, org, gshape)
            got = _emulated(padded, ns, (h, w), rect, ns, near).to(dtype)
            want = fs.halo_step_plain(g[i][j], ring, org, gshape, RATE,
                                      MOORE_OFFSETS, ns, BF, block)
            assert torch.equal(got, want), org
            # and the mosaic is K1's whole grid
            assert torch.equal(got, whole[i * h:(i + 1) * h,
                                          j * w:(j + 1) * w]), org


@pytest.mark.parametrize("ns", [2, 4])
def test_paired_walk_emulation_against_jax(ns):
    """The emulated two launches against the JAX kernel in interpret mode:
    near cells within ``4·eps32·n·max|v|``, bf16 cells within one bf16 ulp
    of the value scale (``tests/test_torch_compute_dtype.py``)."""
    shape, block = (64, 512), (16, 128)
    x = _grid(shape, torch.float32, 3)
    got = _k1_emulated(x, block, ns).numpy().astype(np.float64)
    want = np.asarray(jps.pallas_dense_step(
        jnp.asarray(x.numpy()), RATE, block=block, nsteps=ns,
        interpret=True, compute_dtype=jnp.bfloat16)).astype(np.float64)
    r0, r1, c0, c1 = fs.bf16_rect(shape, block, ns)
    inner = np.zeros(shape, bool)
    inner[r0:r1, c0:c1] = True
    assert inner.any() and (~inner).any()
    d = np.abs(got - want)
    scale = float(np.abs(want).max())
    assert d[~inner].max() <= 4 * 2.0 ** -23 * ns * scale
    assert d[inner].max() <= 2.0 ** (math.floor(math.log2(scale)) - 7)
