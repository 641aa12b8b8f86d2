"""K3/K3-halo vpu's bf16 interior math as two launches, on the CPU.

On the card a vpu call with ``compute_dtype=bfloat16`` is two launches
(``csrc/composed_stencil.cu``): the near launch tiles the four bands of the
array around the bf16 rectangle with the f32 walk's windows
(``cs.window_rows``), and the paired launch tiles the rectangle with windows
of its own rows and row halo OFF (``cs.paired_rows``), walking two rows a
bf16x2 register with the bands of a step's first pass kept for its second
and the accumulator in pairs. Here, without a card:

- the split and both tilings (``fs.bf16_regions``, ``fs.region_tiles`` with
  the row halo, ``cs.plan_of``): the paired launch's tiles cover exactly
  the rectangle, the near launch's exactly its complement, every cell once
  between them, on K3 grids and on the shards of K3-halo's 2×2 and 4-stripe
  meshes (an empty rectangle, an empty band, an odd rectangle), at k = 1,
  2, 3, 8 and 16, Moore and von Neumann; every cell of the rectangle has
  d > k (the paired launch makes no distance test);
- the rows rule (``cs.window_rows``, ``cs.paired_rows``);
- an emulation of the paired binomial walk in torch, tile by tile on the
  kernel's tiling, in the kernel's pair order (rows 2m and 2m + 1 a word,
  the rows above and below by straddling two words, the accumulator's pairs
  over the tile's rows, every operation rounded to bf16), with the near
  cells from the f32 sum over the grid rounded to bf16: bit for bit
  ``composed_dense_step_plain`` / ``composed_halo_step_plain(...,
  variant="vpu", compute_dtype=bfloat16)``, and against JAX's composed vpu
  hook in interpret mode within ``tests/test_torch_compute_dtype.py``'s
  tolerances (near cells ``4·eps32·k·max|v|``, bf16 cells one bf16 ulp of
  the value scale).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mpi_model_tpu.ops import composed_stencil as jcs

from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS, VON_NEUMANN_OFFSETS
from mpi_model_tpu_torch.ops import composed_stencil as cs
from mpi_model_tpu_torch.ops import fused_stencil as fs
from mpi_model_tpu_torch.parallel.halo import exchange_ring

torch.set_num_threads(1)

BF = torch.bfloat16
RATE = 0.13
HOODS = {"moore": MOORE_OFFSETS, "von_neumann": VON_NEUMANN_OFFSETS}

#: (grid, block) of the K3 cases: a rectangle whose edges cut the tiles,
#: block columns of 200, an odd rectangle (rows [45, 180), columns
#: [333, 666)), the main path's grid at JAX's blocks
K3_GEOMETRIES = {"cut": ((512, 1024), (64, 256)),
                 "odd": ((336, 1000), (48, 200)),
                 "odd_rect": ((225, 999), (45, 333)),
                 "main": ((16384, 16384), None)}


def _area(region):
    r0, r1, c0, c1 = region
    return max(r1 - r0, 0) * max(c1 - c0, 0)


def _covers_exactly(tiles, region):
    """The tiles (each ``(r0, r1, c0, c1)``) partition ``region``: their row
    spans chain from its first row to its last without a gap or an overlap,
    their column spans likewise, and every (row span, column span) pair is
    one tile."""
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
            and {tuple(t) for t in tiles}
            == {(a, b, c, d) for a, b in rows for c, d in cols})


def _check_split(shape, rect, k, offsets, origin=(0, 0), gshape=None):
    """The two launches' tiles write every cell of the [h, w] array once:
    the paired launch's exactly the rectangle (each of its cells at d > k
    from the global edge), the near launch's exactly the rest. ``rect`` is
    local. Returns (paired tiles, near tiles)."""
    h, w = shape
    gh, gw = gshape or shape
    grect = (rect[0] + origin[0], rect[1] + origin[0], rect[2] + origin[1],
             rect[3] + origin[1])
    (rows, off), (rows16, off16), regions = cs.plan_of(shape, grect, k,
                                                       offsets, origin)
    inner, bands = fs.bf16_regions(shape, rect)
    assert [r[:4] for r in regions] == [inner, *bands]
    assert sum(_area(r[:4]) for r in regions) == h * w
    paired = fs.region_tiles(inner, rows16, k, off16)
    assert _covers_exactly(paired, inner) and len(paired) == regions[0][4]
    if _area(inner):
        r0, r1, c0, c1 = inner
        assert min(origin[0] + r0, gh - origin[0] - r1,
                   origin[1] + c0, gw - origin[1] - c1) >= k + 1
    near = []
    for band, reg in zip(bands, regions[1:]):
        tiles = fs.region_tiles(band, rows, k, off)
        assert _covers_exactly(tiles, band) and len(tiles) == reg[4]
        near += tiles
    if h * w <= 1 << 22:
        seen = np.zeros(shape, np.int32)
        for a, b, c, d in paired + near:
            seen[a:b, c:d] += 1
        assert (seen == 1).all()
    return paired, near


def _ks(dtype, shape, block):
    return [k for k in (1, 2, 3, 8, 16) if k <= cs.max_k(shape, dtype, block)]


@pytest.mark.parametrize("hood", sorted(HOODS))
@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("geometry", sorted(K3_GEOMETRIES))
def test_k3_launches_cover_the_grid_once(geometry, dtype, hood):
    shape, block = K3_GEOMETRIES[geometry]
    blk = fs.resolve_block(shape, dtype, block)
    for k in _ks(dtype, shape, block):
        rect = fs.bf16_rect(shape, blk, k)
        paired, near = _check_split(shape, rect, k, HOODS[hood])
        assert paired and near


#: (global grid, mesh, block) of the K3-halo cases; only the tilings' index
#: arithmetic runs at these shapes, no grid is built
K3_HALO_MESHES = {"main_2x2": ((16384, 16384), (2, 2), None),
                  "main_stripes": ((16384, 16384), (4, 1), None),
                  "cut_2x2": ((2048, 2560), (2, 2), None),
                  # every tile near: no rectangle
                  "near_stripes": ((96, 768), (4, 1), None),
                  # the inner shards lie in the rectangle: no near band
                  "inner_4x4": ((4096, 4096), (4, 4), (512, 512))}


@pytest.mark.parametrize("hood", sorted(HOODS))
@pytest.mark.parametrize("mesh_name", sorted(K3_HALO_MESHES))
@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_k3_halo_launches_cover_every_shard_once(mesh_name, k, hood):
    gshape, (lines, columns), block = K3_HALO_MESHES[mesh_name]
    h, w = gshape[0] // lines, gshape[1] // columns
    kinds = set()
    for i in range(lines):
        for j in range(columns):
            org = (i * h, j * w)
            blk = fs.resolve_block((h, w), torch.float32, block)
            rect = fs.bf16_rect((h, w), blk, k, org, gshape)
            paired, near = _check_split((h, w), rect, k, HOODS[hood], org,
                                        gshape)
            kinds.add((bool(paired), bool(near)))
    if mesh_name == "near_stripes":
        assert kinds == {(False, True)}   # one launch: the near walk alone
    if mesh_name == "inner_4x4":
        assert (True, False) in kinds     # one launch: the paired walk alone


def test_rows_rule():
    for k in range(1, 17):
        rows16, off16 = cs.paired_rows(k, MOORE_OFFSETS)
        rows, off = cs.window_rows(k, MOORE_OFFSETS)
        # the row halo holds the k steps' reach and whole pairs, the least
        # such halo the source is built for; pairs move four at a time; a
        # tile of at least one pair between the halos
        assert off16 % 2 == 0 and k <= off16 <= 16
        assert off16 == min(o for o in cs.PAIRED_ROWS if o >= k)
        assert rows16 == cs.PAIRED_ROWS[off16] and rows16 % 8 == 0
        assert rows16 - 2 * off16 >= 2
        # the window's pairs and their kept bands: at most 96 words a
        # thread (two blocks an SM at 128 registers)
        assert rows16 <= 96
        assert (rows, off) == ((48, 8) if k <= 8 else (64, 16))
        for fn in (cs.window_rows, cs.paired_rows):
            assert fn(k, VON_NEUMANN_OFFSETS) == (48, 16)


# -- the paired walk, emulated ------------------------------------------------

def _paired_binomial(win, coefs, k, off):
    """The paired launch's walk on one window ([rows, 256] bf16 values in
    f32) in the kernel's order: pair m holds window rows 2m (low) and
    2m + 1 (high); the rows above and below a pair straddle it and its
    neighbour (the window's first pair has 0 above, its last 0 below); band
    = (above + pair) + below, kept for the step's second pass; the columns
    beside from the neighbouring threads (0 beyond the window); cur = (left
    + band) + right; the accumulator's pairs (the tile's rows [off, rows -
    off)) acc = coef_0 * v, then acc = acc + coef_j * cur; every operation
    rounded to bf16. Returns the tile's rows of every window column."""
    rows, cols = win.shape
    h0, ht = off // 2, (rows - 2 * off) // 2
    w = win.reshape(rows // 2, 2, cols)
    zero = torch.zeros(1, cols)
    acc = fs.rb(coefs[0] * w[h0:h0 + ht])
    for j in range(1, k + 1):
        lo, hi = w[:, 0], w[:, 1]
        up = torch.stack([torch.cat([zero, hi[:-1]]), lo], 1)
        dn = torch.stack([hi, torch.cat([lo[1:], zero])], 1)
        band = fs.rb(fs.rb(up + w) + dn)
        left = F.pad(band, (1, 0))[..., :cols]
        right = F.pad(band, (0, 1))[..., 1:]
        w = fs.rb(fs.rb(left + band) + right)
        acc = fs.rb(acc + fs.rb(coefs[j] * w[h0:h0 + ht]))
    return acc.reshape(2 * ht, cols)


def _emulated(padded, d, shape, rect, k, near):
    """What the two launches write on the [h, w] array whose padded form
    (the array with d cells of ring, bf16 values in f32, zero off the grid)
    is ``padded``: ``near`` (the f32 sum over it) with the rectangle's
    cells (``rect``, local) from the paired walk, tile by tile on the
    kernel's tiling. Window cells past the ring read 0, as the kernel's
    sources give them."""
    coefs = cs.vpu_coefs_bf16(RATE, MOORE_OFFSETS, k)
    rows, off = cs.paired_rows(k, MOORE_OFFSETS)
    inner, _ = fs.bf16_regions(shape, rect)
    z = 16  # the largest row halo
    src = F.pad(padded, (z, z + fs.WINDOW_COLS, z, z + rows))
    out = near.clone()
    for r0, r1, c0, c1 in fs.region_tiles(inner, rows, k, off):
        wr, wc = r0 - off + d + z, c0 - k + d + z
        win = src[wr:wr + rows, wc:wc + fs.WINDOW_COLS]
        res = _paired_binomial(win.clone(), coefs, k, off)
        out[r0:r1, c0:c1] = res[:r1 - r0, k:k + c1 - c0]
    return out


def _grid(shape, dtype, seed):
    v = np.random.default_rng(seed).uniform(0.5, 2.0, shape)
    return torch.from_numpy(v.astype(np.float32)).to(dtype)


def _k3_emulated(x, block, k):
    v = fs.rb(x.float())
    near = cs.composed_dense_step_plain(v, RATE, k, MOORE_OFFSETS, "vpu")
    rect = fs.bf16_rect(tuple(x.shape), fs.resolve_block(
        tuple(x.shape), x.dtype, block), k)
    return _emulated(v, 0, tuple(x.shape), rect, k, near).to(x.dtype)


#: (storage, k): f32 storage composes up to k = 8, bf16 up to 16
_DEPTHS = [(torch.float32, 1), (torch.float32, 2), (torch.float32, 3),
           (torch.float32, 8), (BF, 2), (BF, 16)]


@pytest.mark.parametrize("dtype,k", _DEPTHS)
@pytest.mark.parametrize("geometry", ["cut", "odd", "odd_rect"])
def test_paired_walk_emulation_is_the_plain_version(geometry, dtype, k):
    shape, block = K3_GEOMETRIES[geometry]
    if k > cs.max_k(shape, dtype, block):
        pytest.skip("k past the window's ghost depth")
    x = _grid(shape, dtype, 11 + k)
    want = cs.composed_dense_step_plain(x, RATE, k, MOORE_OFFSETS, "vpu", BF,
                                        block)
    got = _k3_emulated(x, block, k)
    bits = torch.int16 if dtype == BF else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.parametrize("dtype,k", [(torch.float32, 2), (torch.float32, 8),
                                     (BF, 16)])
@pytest.mark.parametrize("mesh", [(2, 2), (4, 1)])
def test_paired_walk_emulation_on_shards_is_the_plain_version(mesh, dtype,
                                                              k):
    gshape = (1024, 2048)
    x = _grid(gshape, dtype, 5)
    lines, columns = mesh
    h, w = gshape[0] // lines, gshape[1] // columns
    g = [[x[i * h:(i + 1) * h, j * w:(j + 1) * w].contiguous()
          for j in range(columns)] for i in range(lines)]
    # one block for the grid and its shards: the same bf16 cells
    block = (64, 256)
    whole = cs.composed_dense_step_plain(x, RATE, k, MOORE_OFFSETS, "vpu", BF,
                                         block)
    for i in range(lines):
        for j in range(columns):
            org = (i * h, j * w)
            ring = exchange_ring(g, i, j, k)
            vr = fs.rb(g[i][j].float())
            ringr = {p: fs.rb(t.float()) for p, t in ring.items()}
            _, mask, _ = fs.padded_region(vr, ringr, org, gshape,
                                          MOORE_OFFSETS)
            padded = torch.where(mask, fs.pad_from_ring(vr, ringr), 0.0)
            near = cs.composed_halo_step_plain(vr, ringr, org, gshape, RATE,
                                               k, MOORE_OFFSETS, "vpu")
            rect = fs.bf16_rect((h, w), block, k, org, gshape)
            got = _emulated(padded, k, (h, w), rect, k, near).to(dtype)
            want = cs.composed_halo_step_plain(g[i][j], ring, org, gshape,
                                               RATE, k, MOORE_OFFSETS, "vpu",
                                               BF, block)
            assert torch.equal(got, want), org
            # and the mosaic is K3's whole grid
            assert torch.equal(got, whole[i * h:(i + 1) * h,
                                          j * w:(j + 1) * w]), org


@pytest.mark.parametrize("k", [2, 4])
def test_paired_walk_emulation_against_jax(k):
    """The emulated two launches against JAX's composed vpu hook in
    interpret mode: near cells within ``4·eps32·k·max|v|``, bf16 cells
    within one bf16 ulp of the value scale
    (``tests/test_torch_compute_dtype.py``)."""
    shape, block = (64, 512), (16, 128)
    x = _grid(shape, torch.float32, 3)
    got = _k3_emulated(x, block, k).numpy().astype(np.float64)
    want = np.asarray(jcs.composed_dense_step(
        jnp.asarray(x.numpy()), RATE, k, block=block, interpret=True,
        variant="vpu", compute_dtype=jnp.bfloat16)).astype(np.float64)
    r0, r1, c0, c1 = fs.bf16_rect(shape, block, k)
    inner = np.zeros(shape, bool)
    inner[r0:r1, c0:c1] = True
    assert inner.any() and (~inner).any()
    d = np.abs(got - want)
    scale = float(np.abs(want).max())
    assert d[~inner].max() <= 4 * 2.0 ** -23 * k * scale
    assert d[inner].max() <= 2.0 ** (math.floor(math.log2(scale)) - 7)
