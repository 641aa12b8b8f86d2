"""The host-side geometry of K5 and K6 on the CPU (no card, no nvcc): what
their kernels rely on, the kernels' loops replayed over it.

- K5 (``ops/pipeline_stencil.py::launch_windows``, the windows a lane's
  launch steps, in the kernel's order): they cover every cell of the grid
  exactly once; each window's outputs fit the kernel's window and lie in
  one TPU tile; each takes its TPU tile's form (``interior_mask``, the
  plain version's rule); and a window the kernel runs without grid tests
  has every output more than ``nsteps`` from the global edge. Over every
  ``_pipeline_blocks`` shape of ``tests/test_torch_pipeline.py``, the
  ensemble path's (512, 2048) TPU tiles (on 1024 x 4096), and explicit
  blocks.
- K6 (``ops/fused_active.py::launch_geometry``): the exact walk's row and
  column bands and the tap sum's chunks and runs, looped over as the kernel
  loops, cover every cell of a tile exactly once and read only what they
  stage, for every tile ``chip_smoke.py`` runs K6 on and every
  ``k <= min(tile, 16)``.
- ``smem_bytes`` is that layout's shared memory, within the block limit for
  every call the kernel admits.
"""

import math

import numpy as np
import pytest
import torch

from mpi_model_tpu.ops.pallas_stencil import _pipeline_blocks as jax_blocks

from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS, VON_NEUMANN_OFFSETS
from mpi_model_tpu_torch.ops import fused_active as fa
from mpi_model_tpu_torch.ops import pipeline_stencil as ps

CUSTOM = ((-1, 0), (1, 1), (0, -1))
#: K6's tiles on the card: chip_smoke.py phases 3c (and 3c-halo's (16, 32)),
#: the main paths' 128², and one wider than a walk window
K6_TILES = [(40, 24), (64, 64), (16, 16), (16, 32), (128, 128), (256, 512)]


def _edge_distance(h: int, w: int) -> np.ndarray:
    r = np.arange(h)[:, None]
    c = np.arange(w)[None, :]
    return np.minimum(np.minimum(r, h - 1 - r), np.minimum(c, w - 1 - c))


@pytest.mark.parametrize("shape,block", [
    ((16, 128), None), ((48, 384), None), ((1024, 1536), None),
    ((528, 640), None), ((32, 256), None), ((1024, 4096), None),
    ((48, 384), (16, 128)), ((64, 512), (16, 128)), ((96, 640), (32, 128))])
@pytest.mark.parametrize("ns", [1, 2, 3, 8])
@pytest.mark.parametrize("offs", [MOORE_OFFSETS, VON_NEUMANN_OFFSETS],
                         ids=["moore", "von_neumann"])
def test_k5_windows_partition_the_grid_by_tpu_tile(shape, block, ns, offs):
    h, w = shape
    blk = ps.pipeline_block(shape, ns, block)
    if block is None:
        assert blk == jax_blocks(h, w)
    br, bc = blk
    rows = ps.window_rows(offs, ns)
    wins = ps.launch_windows(shape, blk, ns, offs)
    oh, ow = rows - 2 * ns, ps.WINDOW_COLS - 2 * ns
    assert len(wins) == (h // br) * math.ceil(br / oh) * (
        w // bc) * math.ceil(bc / ow)
    cover = np.zeros(shape, np.int32)
    closed = ps.interior_mask(shape, blk, ns).numpy()
    dist = _edge_distance(h, w)
    for r0, r1, c0, c1, near, inner in wins:
        assert 0 < r1 - r0 <= oh and 0 < c1 - c0 <= ow
        # one TPU tile
        assert r0 // br == (r1 - 1) // br and c0 // bc == (c1 - 1) // bc
        cover[r0:r1, c0:c1] += 1
        # the tile's form, the same on every output
        part = closed[r0:r1, c0:c1]
        assert bool(part.all()) == (not near) and bool(part.any()) == (
            not near)
        assert inner == bool((dist[r0:r1, c0:c1] > ns).all())
        if not near:
            assert inner
    assert (cover == 1).all()


def test_k5_window_rows_follow_the_neighbourhood_and_depth():
    for ns in range(1, ps.MAX_STEPS + 1):
        assert ps.window_rows(MOORE_OFFSETS, ns) == (64 if ns > 2 else 48)
        for offs in (VON_NEUMANN_OFFSETS, CUSTOM,
                     tuple(reversed(MOORE_OFFSETS))):
            assert ps.window_rows(offs, ns) == 48


def _cases():
    for dtype in fa.KERNEL_DTYPES:
        for tile in K6_TILES:
            for k in range(1, min(min(tile), fa.MAX_FUSED_K) + 1):
                yield dtype, tile, k


def _ids(case):
    dtype, tile, k = case
    return f"{str(dtype).removeprefix('torch.')}-{tile[0]}x{tile[1]}-k{k}"


@pytest.mark.parametrize("dtype", fa.KERNEL_DTYPES,
                         ids=lambda d: str(d).removeprefix("torch."))
@pytest.mark.parametrize("tile", K6_TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_k6_walk_bands_cover_each_cell_once(dtype, tile):
    th, tw = tile
    for k in range(1, min(min(tile), fa.MAX_FUSED_K) + 1):
        g = fa.launch_geometry(dtype, tile, k)
        assert 1 <= g.nw <= 8
        orows, ocols = fa.WALK_ROWS - 2 * k, 32 * g.nw - 2 * k
        assert orows >= 1 and ocols >= 1 and g.bands_c * ocols >= tw
        cover = np.zeros(tile, np.int32)
        for b in range(math.ceil(th / orows) * g.bands_c):
            wr0 = b // g.bands_c * orows  # the band's window in the lane's
            wc0 = b % g.bands_c * ocols
            # outputs: window rows [k, WALK_ROWS - k) and columns
            # [k, 32 nw - k), each k from the window's edge, within the tile
            r1, c1 = min(wr0 + orows, th), min(wc0 + ocols, tw)
            assert wr0 < th and wc0 < tw
            cover[wr0:r1, wc0:c1] += 1
        assert (cover == 1).all(), (tile, k)


@pytest.mark.parametrize("dtype", fa.KERNEL_DTYPES,
                         ids=lambda d: str(d).removeprefix("torch."))
@pytest.mark.parametrize("tile", K6_TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_k6_tap_chunks_cover_each_cell_once(dtype, tile):
    th, tw = tile
    item = 8 if dtype == torch.float64 else 4
    seg, rows = fa.TAP_SEG, fa.TAP_ROWS
    for k in range(2, min(min(tile), fa.MAX_FUSED_K) + 1):
        g = fa.launch_geometry(dtype, tile, k)
        assert g.pitch % 2 == 1  # loads a row group apart spread over banks
        cover = np.zeros(tile, np.int32)
        for r0 in range(0, th, g.ch):
            for c0 in range(0, tw, g.cw):
                hh, cw = min(g.ch, th - r0), min(g.cw, tw - c0)
                staged_rows = hh + 2 * k
                assert staged_rows * g.pitch * item <= fa.smem_bytes(
                    dtype, tile, k)
                assert cw + 2 * k <= g.pitch  # the staged columns
                nseg, ngrp = math.ceil(cw / seg), math.ceil(hh / rows)
                for e in range(ngrp * nseg):
                    i0, p0 = e % ngrp * rows, e // ngrp * seg
                    # a thread's reads: columns p0 .. p0 + seg + 2k - 1;
                    # output row i0 + r reads staged rows i0 + r .. + 2k,
                    # inside the chunk for every row it writes
                    assert p0 + seg + 2 * k <= g.pitch
                    p1 = min(p0 + seg, cw)
                    for r in range(rows):
                        if i0 + r < hh:
                            assert i0 + r + 2 * k < staged_rows
                            cover[r0 + i0 + r, c0 + p0:c0 + p1] += 1
        assert (cover == 1).all(), (tile, k)


@pytest.mark.parametrize("case", list(_cases()), ids=_ids)
def test_k6_smem_bytes_is_the_layout(case):
    dtype, tile, k = case
    item = 8 if dtype == torch.float64 else 4
    g = fa.launch_geometry(dtype, tile, k)
    exchange = 2 * g.nw * 2 * fa.WALK_ROWS  # [parity][warp][side][rows]
    staged = (g.ch + 2 * k) * g.pitch if k > 1 else 0
    assert fa.smem_bytes(dtype, tile, k) == max(exchange, staged) * item
    assert fa.smem_bytes(dtype, tile, k) <= fa.SMEM_LIMIT
    if k > 1:
        # within the chunk budget, or one output row with its ring
        assert g.ch >= 1 and (staged * 4 <= fa.TAP_SMEM or (
            g.ch == 1 and staged == (1 + 2 * k) * g.pitch))
    # a launch without a tap table stages nothing
    assert fa.launch_geometry(dtype, tile, k, taps=False).ch == 0
    assert fa.smem_bytes(dtype, tile, k, taps=False) == exchange * item


@pytest.mark.parametrize("tile", [(1, 1), (7, 3), (128, 1000), (1000, 128),
                                  (1536, 1536)])
def test_k6_admits_every_tile_it_admitted(tile):
    """The sub-tile design took any tile at any k <= min(tile, 16); the
    whole-tile walk and the chunked tap sum fit the block limit for all."""
    for dtype in fa.KERNEL_DTYPES:
        for k in range(1, min(min(tile), fa.MAX_FUSED_K) + 1):
            g = fa.launch_geometry(dtype, tile, k)
            assert fa.smem_bytes(dtype, tile, k) <= fa.SMEM_LIMIT
            assert g.bands_c * (32 * g.nw - 2 * k) >= tile[1]
            if k > 1:
                assert g.ch >= 1 and g.cw >= 1
