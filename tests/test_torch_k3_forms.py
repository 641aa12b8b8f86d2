"""K3's two forms in the port (``ops/composed_stencil.py``), on the CPU:
the plain version of each JAX variant, the B table of the tensor-core
form, the shard mosaics and the variant plumbing of the executors.

- ``"vpu"``: the plain version is the JAX hook's binomial order. It is held
  bit for bit to an independent numpy f32 replica of that order, and to
  JAX's ``composed_dense_step(variant="vpu", interpret=True)`` within
  ``1e-6·k``: XLA on the CPU contracts ``acc + coef·cur`` into fused
  multiply-adds (and the JAX kernel chooses the form per tile, not per
  cell), so the two round differently.
- ``"mxu"``: the tap correlation, accumulated from zero in row-major tap
  order, unchanged bit for bit from the earlier single-loop plain version
  (kept here as ``_taps_plain``), and within ``1e-6·k`` of JAX's
  ``variant="mxu"``.
- The mxu kernel's B table (``mxu_fragments``): each fragment decoded by
  mma.sync's documented layout gives the band blocks back, and the
  kernel's block walk, replayed in f64 on the decoded blocks, is the tap
  correlation.
- Shards of both forms put together equal the whole grid bit for bit, on
  meshes whose shard origins are not multiples of the kernels' tiles.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpi_model_tpu.ops import composed_stencil as jcs
from mpi_model_tpu.oracle import dense_flow_step_np

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS, VON_NEUMANN_OFFSETS
from mpi_model_tpu_torch.ops import composed_stencil as cs
from mpi_model_tpu_torch.ops import fused_stencil as fs
from mpi_model_tpu_torch.parallel import (ShardMapExecutor, assemble,
                                          exchange_ring, make_mesh_2d)
from mpi_model_tpu_torch.parallel.mesh import shard_tensor

CUSTOM = ((-1, 0), (1, 1), (0, -1))
HOODS = {"moore": MOORE_OFFSETS, "von_neumann": VON_NEUMANN_OFFSETS,
         "custom": CUSTOM}
CPU = torch.device("cpu")


def _grid(h, w, seed=42):
    return np.random.default_rng(seed).uniform(0.5, 2.0, (h, w)).astype(
        np.float32)


def _oracle(v, rate, offs, n):
    ref = v.astype(np.float64)
    for _ in range(n):
        ref = dense_flow_step_np(ref, rate, offsets=offs)
    return ref


def _vpu_replica(v, rate, offs, k):
    """The binomial order in numpy f32, written from the JAX hook: the
    interior ``[h - 2k - 2, w - 2k - 2]`` block of cells at distance > k."""
    kk = len(offs)
    moore = set(offs) == set(MOORE_OFFSETS)
    alpha = 1.0 - rate - rate / kk if moore else 1.0 - rate
    beta = rate / kk
    coefs = [np.float32(math.comb(k, j) * alpha ** (k - j) * beta ** j)
             for j in range(k + 1)]
    region = v[1:-1, 1:-1].astype(np.float32)
    mh, mw = region.shape
    acc = coefs[0] * region[k:mh - k, k:mw - k]
    cur = region
    for j in range(1, k + 1):
        hs, ws = cur.shape
        if moore:
            band = (cur[0:hs - 2] + cur[1:hs - 1]) + cur[2:hs]
            cur = (band[:, 0:ws - 2] + band[:, 1:ws - 1]) + band[:, 2:ws]
        else:
            nxt = None
            for dx, dy in offs:
                t = cur[1 + dx:hs - 1 + dx, 1 + dy:ws - 1 + dy]
                nxt = t if nxt is None else nxt + t
            cur = nxt
        m = k - j
        hs, ws = cur.shape
        acc = acc + coefs[j] * cur[m:hs - m, m:ws - m]
        assert acc.dtype == np.float32
    return acc


def _taps_plain(values, rate, k, offs):
    """The earlier plain version of K3 (one tap loop for every variant)."""
    h, w = values.shape
    v = values.to(torch.float32)
    out = fs.exact_dense_step_plain(v, rate, offs, k)
    m = k + 1
    ih, iw = h - 2 * m, w - 2 * m
    taps = torch.from_numpy(np.array(cs.composed_taps(rate, offs, k))).to(
        torch.float32)
    acc = torch.zeros((ih, iw), dtype=torch.float32)
    n = 2 * k + 1
    for dr in range(n):
        for dc in range(n):
            acc = acc + taps[dr, dc] * v[1 + dr:1 + dr + ih,
                                         1 + dc:1 + dc + iw]
    out[m:h - m, m:w - m] = acc
    return out.to(values.dtype)


# -- the vpu form --------------------------------------------------------------

@pytest.mark.parametrize("hood", sorted(HOODS))
@pytest.mark.parametrize("k", [1, 3, 8])
def test_vpu_plain_is_the_numpy_replica_bit_for_bit(hood, k):
    v = _grid(48, 70, seed=k)
    offs = HOODS[hood]
    got = cs.composed_dense_step_plain(torch.from_numpy(v), 0.13, k, offs,
                                       "vpu")
    m = k + 1
    inner = got[m:-m, m:-m].numpy()
    assert np.array_equal(inner, _vpu_replica(v, 0.13, offs, k))
    # the edge band is K1's exact path
    band = torch.ones_like(got, dtype=torch.bool)
    band[m:-m, m:-m] = False
    it = fs.exact_dense_step_plain(torch.from_numpy(v), 0.13, offs, k)
    assert torch.equal(got[band], it[band])
    # the tap form computes the same interior to within k ulp
    mxu = cs.composed_dense_step_plain(torch.from_numpy(v), 0.13, k, offs,
                                       "mxu")
    np.testing.assert_allclose(got.numpy(), mxu.numpy(), rtol=1e-6 * k,
                               atol=1e-6 * k)


@pytest.mark.parametrize("shape,block,k,hood", [
    ((64, 256), None, 8, "moore"),
    ((64, 256), None, 4, "von_neumann"),
    ((40, 640), (8, 128), 4, "custom"),
    ((48, 96), (48, 32), 2, "moore"),
])
def test_vpu_matches_jax_interpret_and_the_oracle(shape, block, k, hood):
    v = _grid(*shape, seed=11)
    offs = HOODS[hood]
    got = cs.composed_dense_step(torch.from_numpy(v), 0.13, k, offs,
                                 block=block, variant="vpu")
    assert torch.equal(got, cs.composed_dense_step_plain(
        torch.from_numpy(v), 0.13, k, offs, "vpu"))
    want = np.asarray(jcs.composed_dense_step(
        jnp.asarray(v), 0.13, k, offs, block=block, interpret=True,
        variant="vpu"))
    tol = 1e-6 * k
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.numpy(), _oracle(v, 0.13, offs, k),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("rate,k,hood", [(0.1, 8, "moore"),
                                         (0.01, 16, "moore"),
                                         (0.3, 5, "von_neumann"),
                                         (0.13, 16, "custom")])
def test_coefficients_are_jax_hooks_rounded_once(rate, k, hood):
    offs = HOODS[hood]
    moore, coefs = cs.vpu_coefs(rate, offs, k)
    assert moore == (hood == "moore") and len(coefs) == k + 1
    hook = jcs._make_vpu_hook(rate, offs, k)
    jcoefs = dict(zip(hook.__code__.co_freevars,
                      (c.cell_contents for c in hook.__closure__)))["coefs"]
    assert [np.float32(c) for c in jcoefs] == [np.float32(c) for c in coefs]
    # each is an f32 value, rounded once from f64
    for c, c64 in zip(coefs, jcoefs):
        assert c == float(np.float32(c64))
    if rate == 0.01:
        # beta^16 = (r/8)^16 underflows f32 in both packages; beta^14's
        # coefficient is subnormal and kept
        assert jcoefs[16] > 0.0 and coefs[16] == 0.0
        assert 0.0 < coefs[14] < np.finfo(np.float32).tiny


def test_bf16_vpu_rounds_once_per_call():
    x = torch.from_numpy(_grid(40, 72, seed=9)).to(torch.bfloat16)
    got = cs.composed_dense_step(x, 0.1, 8, variant="vpu")
    once = cs.composed_dense_step_plain(x.float(), 0.1, 8,
                                        variant="vpu").to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, once)


# -- the mxu form ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hood", sorted(HOODS))
@pytest.mark.parametrize("variant", ["auto", "mxu"])
def test_mxu_and_auto_unchanged_bit_for_bit(dtype, hood, variant):
    x = torch.from_numpy(_grid(64, 256, seed=4)).to(dtype)
    offs = HOODS[hood]
    for k in (4, 8):
        got = cs.composed_dense_step(x, 0.13, k, offs, variant=variant)
        assert torch.equal(got, _taps_plain(x, 0.13, k, offs)), k


@pytest.mark.parametrize("k,hood", [(8, "moore"), (4, "custom")])
def test_mxu_plain_matches_jax_interpret(k, hood):
    v = _grid(64, 256, seed=13)
    offs = HOODS[hood]
    got = cs.composed_dense_step(torch.from_numpy(v), 0.13, k, offs,
                                 variant="mxu").numpy()
    want = np.asarray(jcs.composed_dense_step(
        jnp.asarray(v), 0.13, k, offs, interpret=True, variant="mxu"))
    tol = 1e-6 * k
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _decode(frags, dtype):
    """The [2k+1, NB, 2 terms, KB, 8] blocks a B table encodes, decoded by
    mma.sync's B fragment layout (g = lane // 4, t = lane % 4)."""
    kb = cs.MXU_LAYOUT[dtype][0]
    out = np.zeros(frags.shape[:3] + (kb, 8), np.float64)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        r0, r1 = frags[..., lane, 0], frags[..., lane, 1]
        if dtype == torch.float32:
            out[..., t, g] = r0.view(np.float32)
            out[..., t + 4, g] = r1.view(np.float32)
        else:
            for reg, rows in ((r0, (2 * t, 2 * t + 1)),
                              (r1, (2 * t + 8, 2 * t + 9))):
                lo = (reg & 0xFFFF).astype(np.uint32) << 16
                hi = (reg >> 16).astype(np.uint32) << 16
                out[..., rows[0], g] = lo.view(np.float32)
                out[..., rows[1], g] = hi.view(np.float32)
    return out


@pytest.mark.parametrize("dtype,k", [(torch.float32, 1), (torch.float32, 8),
                                     (torch.bfloat16, 5),
                                     (torch.bfloat16, 16)])
@pytest.mark.parametrize("hood", ["moore", "custom"])
def test_mxu_table_decodes_to_the_band_and_the_walk_is_the_correlation(
        dtype, k, hood):
    offs = HOODS[hood]
    frags = cs.mxu_fragments(0.13, offs, k, dtype)
    kb, kmax, rel_min = cs.MXU_LAYOUT[dtype][:3]
    nb = (2 * kmax + 7 - rel_min) // 8 + 1
    assert frags.shape == (2 * k + 1, nb, 2, 32, 2)
    assert frags.dtype == np.uint32
    blocks = _decode(frags, dtype)
    # each term is exact in the MMA's input type; the two add up to the
    # band blocks within the split's precision
    low = 0x1FFF if dtype == torch.float32 else 0xFFFF
    bits = blocks.astype(np.float32).view(np.uint32)
    assert not np.any(bits & low)
    want = cs.mxu_blocks(0.13, offs, k, dtype).astype(np.float64)
    split = 2.0 ** -21 if dtype == torch.float32 else 2.0 ** -16
    np.testing.assert_allclose(blocks.sum(axis=2), want, rtol=split,
                               atol=0)
    # the kernel's walk: a warp's 16 x N tile, for each row offset dr and
    # each A block a of KB columns, an MMA group with every n8 tile nt
    # whose band it meets (rel = KB a - 8 nt), B block (rel - REL_MIN) / 8
    n = cs.MXU_WARP_COLS
    taps = np.asarray(cs.composed_taps(0.13, offs, k), np.float32)
    rng = np.random.default_rng(k)
    na = -(-(n + 2 * kmax) // kb)
    win = rng.uniform(0.5, 2.0, (16 + 2 * k, (na + 1) * kb))
    win[:, n + 2 * k:] = 0.0
    out = np.zeros((16, n))
    for dr in range(2 * k + 1):
        for a in range(na):
            if a * kb >= n + 2 * k:
                break
            A = win[dr:dr + 16, a * kb:(a + 1) * kb]
            for nt in range(n // 8):
                rel = a * kb - 8 * nt
                if rel < rel_min or rel > 2 * k + 7:
                    continue
                q = (rel - rel_min) // 8
                if q >= nb:
                    continue
                out[:, 8 * nt:8 * nt + 8] += A @ blocks[dr, q].sum(axis=0)
    ref = np.zeros((16, n))
    for dr in range(2 * k + 1):
        for dc in range(2 * k + 1):
            ref += float(taps[dr, dc]) * win[dr:dr + 16, dc:dc + n]
    np.testing.assert_allclose(out, ref, rtol=8 * split, atol=0)


def test_operation_counts():
    shape = (64, 256)
    for k in (1, 8):
        inner = cs.composed_cells(shape, k)
        mask = fs.closed_mask(shape, k)
        assert inner == int(mask.sum())
        assert cs.vpu_ops(shape, k) == inner * (6 * k + 1) + \
            (64 * 256 - inner) * k * 11
    # one block tile: (bh / 16) (bw / 32) m16 x 32 sub-tiles, 17 row
    # offsets, 12 MMA groups of three m16n8k8 TF32 products each at k = 8
    bh, bw = cs.MXU_LAYOUT[torch.float32][3:]
    assert cs.mxu_tensor_flops((bh, bw), 8, torch.float32) == \
        (bh // 16) * (bw // 32) * 17 * 12 * 3 * 2 * 16 * 8 * 8
    # a shard at an unaligned origin straddles more tiles
    assert cs.mxu_tensor_flops((bh, bw), 8, torch.float32, (10, 0),
                               (2 * bh, 2 * bw)) == \
        2 * cs.mxu_tensor_flops((bh, bw), 8, torch.float32)


# -- shards: both forms, unaligned origins ---------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mesh_shape,shape", [((2, 2), (50, 70)),
                                              ((2, 3), (42, 105))])
@pytest.mark.parametrize("form", ["vpu", "mxu"])
def test_halo_mosaic_bit_for_bit_the_whole_grid(dtype, mesh_shape, shape,
                                                form):
    L, C = mesh_shape
    x = torch.from_numpy(_grid(*shape, seed=L * 10 + C)).to(dtype)
    mesh = make_mesh_2d(L, C, devices=[CPU] * (L * C))
    h, w = shape[0] // L, shape[1] // C
    g = shard_tensor(x, mesh, h, w)
    for hood, offs in HOODS.items():
        for k in (2, 5, 8):
            parts = [[cs.composed_halo_step_plain(
                g[i][j], exchange_ring(g, i, j, k), (i * h, j * w), shape,
                0.13, k, offs, form) for j in range(C)] for i in range(L)]
            assert torch.equal(assemble(parts, CPU),
                               cs.composed_dense_step_plain(
                                   x, 0.13, k, offs, form)), (hood, k)


def test_refusals_and_resolution_follow_jax():
    for k in (1, 3, 4, 8):
        for bw in (96, 128, 256):
            for var in ("auto", "vpu", "mxu"):
                want = jcs._resolve_variant(var, k, bw)
                if want == "mxu" and bw % 128:
                    with pytest.raises(ValueError, match="128"):
                        cs.resolve_form(var, k, bw)
                else:
                    assert cs.resolve_form(var, k, bw) == want
    step = cs.ComposedDiffusionStep((64, 256), 0.1, 8)
    assert (step.variant, step.form) == ("auto", "mxu")
    step = cs.ComposedDiffusionStep((64, 256), 0.1, 2)
    assert (step.variant, step.form) == ("auto", "vpu")
    with pytest.raises(ValueError, match="plain versions take"):
        cs.composed_dense_step_plain(torch.zeros(8, 8), 0.1, 1,
                                     variant="auto")


# -- the slice: executors pass the variant through -------------------------------

@pytest.mark.parametrize("variant,form", [("vpu", "vpu"), ("mxu", "mxu"),
                                          ("auto", "mxu")])
def test_executors_run_the_asked_form(variant, form):
    v = _grid(64, 256, seed=21)
    space = mt.CellularSpace.create(64, 256, 1.0, device="cpu").with_values(
        {"value": torch.from_numpy(v)})
    model = mt.Model(mt.Diffusion(0.1))
    out, rep = model.execute(space, mt.SerialExecutor(
        "composed", substeps=4, composed_variant=variant), steps=8)
    want = torch.from_numpy(v)
    for _ in range(2):
        want = cs.composed_dense_step_plain(want, 0.1, 4, variant=form)
    assert torch.equal(out.values["value"], want)
    br = rep.backend_report
    assert (br["variant"], br["form"]) == (variant, form)
    mesh = make_mesh_2d(2, 2, devices=[CPU] * 4)
    sout, srep = model.execute(space, ShardMapExecutor(
        mesh, "composed", halo_depth=4, composed_variant=variant), steps=8)
    assert torch.equal(sout.values["value"], want)
    assert (srep.backend_report["variant"],
            srep.backend_report["form"]) == (variant, form)
