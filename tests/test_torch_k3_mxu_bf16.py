"""The mxu form's bf16 interior math (``ops/composed_stencil.py``), on the
CPU: what its kernel's design rests on, held without a card.

- The f32 pass over a window rounded to bf16 drops the window's low TF32
  term: for every finite bf16 value, the kernel's split (``split_tf32`` in
  ``csrc/composed_stencil.cu``, copied here in numpy's integers) gives a
  high term equal to the value and a low term of exactly 0.
- The bf16 pass's one-term B table (``mxu_fragments16``, resident in shared
  memory), decoded by mma.sync's B fragment layout and laid out by the
  kernel's walk of (A block, n8 tile) pairs, is the banded matrix
  ``B_dr[m, c] = bf16(taps[dr][m - c])`` of ``composed_taps``.
- ``mxu_mma_flops`` / ``mxu_tensor_flops`` count the MMAs of the layout
  that runs, against an explicit walk of every tile, warp, row offset and
  (A block, n8 tile) pair.
- ``MXU_LAYOUT_BF16`` tiles each grid with the f32-compute form's block
  origins (the precondition of K3-halo's mosaic equalling K3).
"""

import numpy as np
import pytest
import torch

from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS
from mpi_model_tpu_torch.ops import composed_stencil as cs
from mpi_model_tpu_torch.ops import fused_stencil as fs

CUSTOM = ((-1, 0), (1, 1), (0, -1))
HOODS = {"moore": MOORE_OFFSETS, "custom": CUSTOM}


def _split_tf32(x_bits: np.ndarray):
    """The kernel's integer split of f32 bits into TF32 terms: hi clears the
    13 low significand bits; lo = x - hi in f32, rounded half away from
    zero to TF32 by adding half a TF32 ulp to its bits and clearing them."""
    x_bits = x_bits.astype(np.uint32)
    hi = x_bits & np.uint32(0xFFFFE000)
    r = (x_bits.view(np.float32) - hi.view(np.float32)).astype(np.float32)
    lo = (r.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return hi, lo


@pytest.mark.parametrize("sign", [0, 1])
def test_every_finite_bf16_value_splits_with_a_zero_low_term(sign):
    """Each of the 2^15 bf16 bit patterns of one sign whose exponent is
    not all ones (zeros, subnormals, normals) as an f32 value."""
    b = np.arange(1 << 15, dtype=np.uint32) | np.uint32(sign << 15)
    b = b[(b >> 7 & 0xFF) != 0xFF]
    assert b.size == (1 << 15) - (1 << 7)
    x = b << np.uint32(16)
    hi, lo = _split_tf32(x)
    assert np.array_equal(hi, x)
    assert not np.any(lo)
    # the kernel reads A[g][t] as the bf16 bits << 16: the same TF32 term
    assert np.array_equal(b << np.uint32(16), hi)


def _bf16(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16 (nearest even) by torch, as f64."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).to(torch.float64).numpy()


@pytest.mark.parametrize("k", range(1, 17))
@pytest.mark.parametrize("hood", sorted(HOODS))
def test_resident_table_rebuilds_the_banded_matrices(k, hood):
    """Decode each lane's two registers (``B[2t, g] | B[2t + 1, g] << 16``,
    ``B[2t + 8, g] | B[2t + 9, g] << 16``), place each block where the
    kernel's walk uses it (A block a, n8 tile nt, block (16a - 8nt -
    REL_MIN) / 8), and compare with the band of the taps rounded to
    bf16."""
    kb, kmax, rel_min = cs.MXU_LAYOUT_BF16[torch.float32][:3]
    nb = (2 * kmax + 7 - rel_min) // 8 + 1
    tab = cs.mxu_fragments16(0.13, HOODS[hood], k)
    assert tab.shape == (2 * k + 1, nb, 32, 2) and tab.dtype == np.uint32
    assert tab.flags["C_CONTIGUOUS"]
    blocks = np.zeros((2 * k + 1, nb, kb, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for reg, rows in ((0, (2 * t, 2 * t + 1)), (1, (2 * t + 8, 2 * t + 9))):
            r = tab[:, :, lane, reg]
            for half, row in enumerate(rows):
                bits = ((r >> np.uint32(16 * half)) & np.uint32(0xFFFF)) << \
                    np.uint32(16)
                blocks[:, :, row, g] = bits.view(np.float32)
    n = cs.MXU_WARP_COLS
    na = -(-(n + 2 * kmax) // kb)
    band = np.zeros((2 * k + 1, na * kb, n))
    covered = np.zeros((na * kb, n), bool)
    for a in range(na):
        if a * kb >= n + 2 * k:
            break
        for nt in range(n // 8):
            rel = a * kb - 8 * nt
            if rel < rel_min or rel > 2 * k + 7 or (rel - rel_min) // 8 >= nb:
                continue
            band[:, a * kb:(a + 1) * kb, 8 * nt:8 * nt + 8] = \
                blocks[:, (rel - rel_min) // 8]
            covered[a * kb:(a + 1) * kb, 8 * nt:8 * nt + 8] = True
    taps = _bf16(cs.composed_taps(0.13, HOODS[hood], k))
    m = np.arange(na * kb)[:, None]
    c = np.arange(n)[None, :]
    d = m - c
    in_band = (d >= 0) & (d <= 2 * k)
    assert covered[in_band].all()
    want = np.where(in_band[None], taps[:, np.clip(d, 0, 2 * k)], 0.0)
    assert np.array_equal(band, want)


def _walk_flops(shape, k, dtype, origin, rect):
    """The kernel's MMAs, walked one by one: every block tile aligned to the
    global grid; a tile whose part of the array meets ``rect`` runs the bf16
    pass (one m16n8k16 a pair, ``MXU_LAYOUT_BF16``'s warp tiles), one whose
    part does not lie in ``rect`` the f32 pass (two MMAs a pair: TF32
    m16n8k8 at f32 storage, bf16 m16n8k16 at bf16); ``rect`` None: the
    f32-compute form (three TF32 or two bf16 MMAs a pair)."""
    f32 = dtype == torch.float32
    out = {"tf32": 0, "bf16": 0}
    bh, bw = cs.MXU_LAYOUT[dtype][3:]
    (h, w), (r0, c0) = shape, origin

    def pass_flops(layout, mmas, kind):
        kb, kmax, rel_min = layout[:3]
        lbh, lbw = layout[3:]
        nb = (2 * kmax + 7 - rel_min) // 8 + 1
        n = cs.MXU_WARP_COLS
        for _warp_row in range(lbh // 16):
            for _warp_col in range(lbw // n):
                for _dr in range(2 * k + 1):
                    a = 0
                    while a * kb < n + 2 * k:
                        for nt in range(n // 8):
                            rel = a * kb - 8 * nt
                            if (rel_min <= rel <= 2 * k + 7
                                    and (rel - rel_min) // 8 < nb):
                                out[kind] += mmas * 2 * 16 * 8 * kb
                        a += 1

    for i in range(r0 // bh, -(-(r0 + h) // bh)):
        for j in range(c0 // bw, -(-(c0 + w) // bw)):
            cells = {(r, c) for r in range(max(i * bh, r0),
                                           min((i + 1) * bh, r0 + h))
                     for c in range(max(j * bw, c0),
                                    min((j + 1) * bw, c0 + w))}
            if rect is None:
                pass_flops(cs.MXU_LAYOUT[dtype], 3 if f32 else 2,
                           "tf32" if f32 else "bf16")
                continue
            q0, q1, p0, p1 = rect
            inq = {(r, c) for r, c in cells if q0 <= r < q1 and p0 <= c < p1}
            if inq:
                pass_flops(cs.MXU_LAYOUT_BF16[dtype], 1, "bf16")
            if inq != cells:
                pass_flops(cs.MXU_LAYOUT[dtype], 2,
                           "tf32" if f32 else "bf16")
    return {kind: float(v) for kind, v in out.items() if v}


@pytest.mark.parametrize("dtype,k", [(torch.float32, 1), (torch.float32, 3),
                                     (torch.float32, 8), (torch.bfloat16, 4),
                                     (torch.bfloat16, 16)])
@pytest.mark.parametrize("shape,origin,gshape,block", [
    ((256, 512), (0, 0), (256, 512), (64, 128)),
    ((200, 300), (70, 130), (400, 600), (40, 100)),
    ((128, 256), (0, 0), (128, 256), None)])
def test_mma_flops_count_the_layout_that_runs(dtype, k, shape, origin,
                                              gshape, block):
    """bf16 interior math (the rectangle of ``kernel_rect``: straddling
    tiles run both passes, a shard's partial tiles count once) and f32
    compute, against the walk."""
    blk = fs.resolve_block(shape, dtype, block)
    if k > cs.max_k(shape, dtype, blk):
        pytest.skip("k past the window's ghost depth")
    rect = fs.kernel_rect(shape, dtype, blk, k, torch.bfloat16, origin,
                          gshape)
    for r in (rect, None):
        want = _walk_flops(shape, k, dtype, origin, r)
        got = cs.mxu_mma_flops(shape, k, dtype, origin, gshape, r)
        assert {t: v for t, v in got.items() if v} == want
        assert cs.mxu_tensor_flops(shape, k, dtype, origin, gshape, r) == \
            sum(want.values())


def test_mma_flops_of_the_bf16_pass_and_the_f32_pass():
    """One f32 tile in the rectangle: (64 / 16)(128 / 32) warp tiles, 17 row
    offsets, 8 pairs of one bf16 MMA at k = 8 (the taps' first term only);
    one outside: 12 pairs of two TF32 MMAs (the f32-compute form's three)."""
    bh, bw = cs.MXU_LAYOUT[torch.float32][3:]
    per = (bh // 16) * (bw // 32) * 17
    assert cs.mxu_mma_flops((bh, bw), 8, torch.float32,
                            rect=(0, bh, 0, bw)) == {
        "tf32": 0.0, "bf16": float(per * 8 * 2 * 16 * 8 * 16)}
    assert cs.mxu_mma_flops((bh, bw), 8, torch.float32,
                            rect=(0, 0, 0, 0)) == {
        "tf32": float(per * 12 * 2 * 2 * 16 * 8 * 8), "bf16": 0.0}
    assert cs.mxu_mma_flops((bh, bw), 8, torch.float32) == {
        "tf32": float(per * 12 * 3 * 2 * 16 * 8 * 8)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("origin", [(0, 0), (64, 128), (50, 70), (8192, 0)])
def test_bf16_layout_tiles_as_the_f32_form(dtype, origin):
    """The bf16 pass's block tile is the f32-compute form's, so a shard at
    any origin starts its tiles where the whole grid's lie (a partial first
    tile at an unaligned origin), and its B table's shape follows its
    layout."""
    kb, kmax, rel_min, bh, bw = cs.MXU_LAYOUT_BF16[dtype]
    assert (bh, bw) == cs.MXU_LAYOUT[dtype][3:]
    assert (kb, kmax, rel_min) == cs.MXU_LAYOUT[torch.bfloat16][:3]
    r0, c0 = origin
    first = (r0 // bh * bh, c0 // bw * bw)
    f32_bh, f32_bw = cs.MXU_LAYOUT[dtype][3:]
    assert first == (r0 // f32_bh * f32_bh, c0 // f32_bw * f32_bw)
    nb = (2 * kmax + 7 - rel_min) // 8 + 1
    assert cs.mxu_fragments16(0.1, MOORE_OFFSETS, 4).shape == (9, nb, 32, 2)
