"""The port's kernels on the card against their plain versions: K1, K3, K4,
K5, K6 and K7 (also on ghost-padded shards). Needs a CUDA device and skips
without one. It imports neither jax nor the JAX package, so it also runs
where only torch is installed:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py

Tolerances: K1 is held bit for bit (each cell's form, closed or exact,
chosen as its plain version chooses it, every operation rounded in the
plain version's order). K3's vpu form bit for bit (the binomial order in
``_rn`` intrinsics, no contraction); its mxu form, on tensor cores, f32
``1e-6 * k * max|v|``, bf16 one ulp at values below 4. K6 and K7 are held
bit for bit: K6 computes in the storage dtype with every operation
rounded, in the plain version's order, and K7 moves bits. K4 is generated
per flow set (the card tests use a fixed handful of flow sets, one library
each) and held bit for bit (f32 and bf16 both compute in f32 and round
once per call; -0.0 cells included), except flows using exp: CUDA's expf
and torch's exp may differ by an ulp, so those are held to
``8·eps·nsteps·max|v|``.
K5 is held bit for bit (f32 math in the plain version's order, no FMA
contraction, rounded once per call). The Flow IR's nonlinear terms run
plain torch ops on the card, one kernel an operation: its active, composed
and ensemble runs are held bit for bit to its ``xla`` run there, and a
linear IR model to ``Model([Diffusion])`` on K1. K6's and K5's launch geometry
(``launch_geometry``, ``window_rows``) is held to the library's."""

import dataclasses

import numpy as np
import pytest
import torch

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS, VON_NEUMANN_OFFSETS
from mpi_model_tpu_torch.ops import active as act
from mpi_model_tpu_torch.ops import composed_stencil as cs
from mpi_model_tpu_torch.ops import field_stencil as k4
from mpi_model_tpu_torch.ops import fused_active as fa
from mpi_model_tpu_torch.ops import fused_stencil as fs
from mpi_model_tpu_torch.ops import pipeline_stencil as ps
from mpi_model_tpu_torch.ops.flow import Flow, cell_coords

CUSTOM = ((-1, 0), (1, 1), (0, -1))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,ns", [(torch.float32, 1), (torch.float32, 2),
                                      (torch.float32, 8), (torch.bfloat16, 4),
                                      (torch.bfloat16, 16)])
@pytest.mark.parametrize("offs", [MOORE_OFFSETS, VON_NEUMANN_OFFSETS, CUSTOM])
@pytest.mark.parametrize("shape", [(256, 512), (333, 1001), (40, 48)])
def test_kernel_matches_plain_on_the_card(dtype, ns, offs, shape):
    """Interior and edge tiles (256×512, 333×1001 with ragged tiles) and a
    grid where few or no cells take the closed form (40×48)."""
    dev = _card()
    v = np.random.default_rng(42).uniform(0.5, 2.0, shape)
    x = torch.from_numpy(v).to(dev, dtype)
    before = fs.launches()
    got = fs.pallas_dense_step(x, 0.13, offs, nsteps=ns)
    assert fs.launches() == before + 1
    want = fs.dense_step_plain(x, 0.13, offs, ns)
    assert torch.equal(got, want)
    # out of place: the input is untouched
    torch.testing.assert_close(x, torch.from_numpy(v).to(dev, dtype),
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,k", [(torch.float32, 1), (torch.float32, 4),
                                     (torch.float32, 8), (torch.bfloat16, 8),
                                     (torch.bfloat16, 16)])
@pytest.mark.parametrize("offs", [MOORE_OFFSETS, VON_NEUMANN_OFFSETS, CUSTOM])
@pytest.mark.parametrize("shape", [(256, 512), (77, 131)])
def test_composed_kernel_matches_plain_on_the_card(dtype, k, offs, shape):
    """``"auto"``: the form JAX's rule picks (vpu on 131 columns and below
    9 taps, mxu on 512 columns from 9)."""
    dev = _card()
    v = np.random.default_rng(7).uniform(0.5, 2.0, shape)
    x = torch.from_numpy(v).to(dev, dtype)
    form = cs.resolve_form("auto", k, fs.resolve_block(shape, dtype)[1])
    before = cs.launches(form)
    got = cs.composed_dense_step(x, 0.13, k, offs)
    assert cs.launches(form) == before + 1
    want = cs.composed_dense_step_plain(x, 0.13, k, offs, form)
    _held_to_plain(got, want, form, k)


def _held_to_plain(got, want, form, k):
    """vpu bit for bit; mxu f32 within 1e-6·k·max|v|, bf16 one ulp."""
    if form == "vpu":
        assert torch.equal(got, want)
        return
    tol = (1e-6 * k * float(want.float().abs().max())
           if got.dtype == torch.float32 else 2.0 ** -6)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["vpu", "mxu"])
@pytest.mark.parametrize("dtype,k", [(torch.float32, 1), (torch.float32, 4),
                                     (torch.float32, 8), (torch.bfloat16, 3),
                                     (torch.bfloat16, 8),
                                     (torch.bfloat16, 16)])
@pytest.mark.parametrize("offs", [MOORE_OFFSETS, VON_NEUMANN_OFFSETS, CUSTOM])
@pytest.mark.parametrize("shape", [(256, 512), (300, 1280), (40, 128)])
def test_composed_forms_on_the_card(form, dtype, k, offs, shape):
    """Each form asked for by name: interior and edge tiles, ragged tiles,
    and a grid with few composed cells."""
    dev = _card()
    if k > cs.max_k(shape, dtype):
        pytest.skip("k beyond the window's ghost depth")
    v = np.random.default_rng(k).uniform(0.5, 2.0, shape)
    x = torch.from_numpy(v).to(dev, dtype)
    before = cs.launches(form)
    got = cs.composed_dense_step(x, 0.13, k, offs, variant=form)
    assert cs.launches(form) == before + 1
    _held_to_plain(got, cs.composed_dense_step_plain(x, 0.13, k, offs, form),
                   form, k)
    torch.testing.assert_close(x, torch.from_numpy(v).to(dev, dtype),
                               rtol=0, atol=0)


def _active_case(dev, dtype, shape, tile, k, seed):
    """A sparse state padded to ring k, its plan and compacted active set:
    two blobs, one touching the top-left corner, one inside."""
    h, w = shape
    rng = np.random.default_rng(seed)
    v = np.zeros(shape)
    v[0:5, 0:7] = rng.uniform(0.5, 2.0, (5, 7))
    r0, c0 = h // 2 - 9, w // 2 - 13
    v[r0:r0 + 30, c0:c0 + 40] = rng.uniform(0.5, 2.0, (30, 40))
    x = torch.from_numpy(v).to(dev, dtype)
    plan = act.plan_for(shape, tile=tile, max_active_frac=1.0)
    tmap = act.tile_nonzero_map(x, plan)
    flags = act.dilate_tile_map(tmap)
    ids, count = act.compact_tile_ids(flags, plan)
    selfnz = tmap.reshape(-1)[ids.long()].to(torch.int32)
    padded = torch.nn.functional.pad(x, (k, k, k, k)).contiguous()
    return padded, plan, ids, count, selfnz


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,k", [
    (torch.float64, 1), (torch.float32, 1), (torch.bfloat16, 1),
    (torch.float64, 4), (torch.float32, 8), (torch.bfloat16, 16)])
@pytest.mark.parametrize("offs", [MOORE_OFFSETS, CUSTOM])
@pytest.mark.parametrize("shape,tile", [((256, 320), (64, 64)),
                                        ((200, 264), (40, 24))])
def test_fused_active_kernels_bitwise_on_the_card(dtype, k, offs, shape,
                                                  tile):
    dev = _card()
    if k > min(tile):
        pytest.skip("k beyond the tile")
    padded, plan, ids, count, selfnz = _active_case(dev, dtype, shape, tile,
                                                    k, 3)
    taps = fa._fused_taps(0.13, offs, k)
    kw = dict(rate=0.13, plan=plan, origin=(0, 0), global_shape=shape,
              offsets=offs, dtype=dtype, k=k, ring=k, taps=taps)
    cnt1 = count.reshape(1).to(torch.int32)
    before = fa.launches()
    upd, anyf = fa.fused_compute(padded, ids, cnt1, selfnz, **kw)
    want_u, want_f = fa.fused_compute_plain(
        padded, ids, count, selfnz, 0.13, plan, (0, 0), shape, offs, dtype,
        k, k, taps)
    n = min(max(int(count), 1), plan.capacity)
    assert torch.equal(upd[:n], want_u[:n])
    assert torch.equal(anyf, want_f)
    got_p = fa.fused_scatter(padded.clone(), upd, ids, cnt1, plan=plan,
                             ring=k)
    want_p = fa.fused_scatter_plain(padded.clone(), upd, ids, count, plan, k)
    assert torch.equal(got_p, want_p)
    assert fa.launches() == {"fused_compute": before["fused_compute"] + 1,
                             "fused_scatter": before["fused_scatter"] + 1}


@pytest.mark.cuda
def test_fused_active_geometry_matches_the_library():
    """The wrapper's launch geometry asks the kernel for the shared memory
    ``smem_bytes`` states, and its walk rows and tap run are the source's."""
    _card()
    lib = fa._kernel_lib()
    assert lib.mm_fused_walk_rows() == fa.WALK_ROWS
    assert lib.mm_fused_tap_seg() == fa.TAP_SEG
    assert lib.mm_fused_tap_rows() == fa.TAP_ROWS
    for dtype in fa.KERNEL_DTYPES:
        item = 8 if dtype == torch.float64 else 4
        for tile in ((128, 128), (40, 24), (16, 16), (64, 64), (16, 32),
                     (256, 512)):
            for k in range(1, min(min(tile), fa.MAX_FUSED_K) + 1):
                for taps in (True, False):
                    g = fa.launch_geometry(dtype, tile, k, taps)
                    assert lib.mm_fused_smem_bytes(
                        item, g.nw, k, g.ch, g.pitch) == fa.smem_bytes(
                            dtype, tile, k, taps)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,k", [(torch.float32, 1), (torch.float32, 2),
                                     (torch.float64, 8), (torch.bfloat16, 3)])
@pytest.mark.parametrize("offs", [MOORE_OFFSETS, CUSTOM])
@pytest.mark.parametrize("shape,tile,origin,gshape", [
    ((512, 1024), (256, 512), (0, 0), (512, 1024)),
    ((256, 256), (128, 128), (128, 256), (640, 768))])
@pytest.mark.parametrize("use_taps", [True, False])
def test_fused_active_bands_and_origins_on_the_card(dtype, k, offs, shape,
                                                    tile, origin, gshape,
                                                    use_taps):
    """Tiles wider than one walk window (column bands) and taller than a
    tap chunk, and a shard's state at a global origin whose ring holds its
    neighbours' values: every lane live, self-lit or not, bit for bit; with
    the tap table and without it (every lane exact, as the ensemble's
    lanes run)."""
    dev = _card()
    rng = np.random.default_rng(11)
    h, w = shape
    ring = k
    v = rng.uniform(0.5, 2.0, (h + 2 * ring, w + 2 * ring))
    v *= rng.random(v.shape) < 0.7
    rows = np.arange(h + 2 * ring) + origin[0] - ring
    cols = np.arange(w + 2 * ring) + origin[1] - ring
    v[(rows < 0) | (rows >= gshape[0]), :] = 0.0  # the global zero border
    v[:, (cols < 0) | (cols >= gshape[1])] = 0.0
    padded = torch.from_numpy(v).to(dev, dtype)
    plan = act.plan_for(shape, tile=tile, max_active_frac=1.0)
    nt = plan.grid[0] * plan.grid[1]
    ids = torch.randperm(nt, generator=torch.Generator().manual_seed(2)).to(
        dev, torch.int32)
    count = torch.tensor(nt - 1, device=dev)
    selfnz = (torch.arange(nt, device=dev) % 3 != 0).to(torch.int32)
    taps = fa._fused_taps(0.13, offs, k) if use_taps else None
    upd, anyf = fa.fused_compute(
        padded, ids, count.reshape(1).to(torch.int32), selfnz, rate=0.13,
        plan=plan, origin=origin, global_shape=gshape, offsets=offs,
        dtype=dtype, k=k, ring=ring, taps=taps)
    want_u, want_f = fa.fused_compute_plain(
        padded, ids, count, selfnz, 0.13, plan, origin, gshape, offs, dtype,
        k, ring, taps)
    assert torch.equal(upd[:nt - 1], want_u[:nt - 1])
    assert torch.equal(anyf, want_f)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_active_paths_bitwise_against_dense_on_the_card(dtype):
    dev = _card()
    g = 384
    v = np.zeros((g, g), np.float32)
    v[150:200, 170:230] = np.random.default_rng(5).uniform(0.5, 2.0,
                                                           (50, 60))
    space = mt.CellularSpace.create(g, g, 0.0, dtype=dtype, device=dev)
    space = space.with_values({"value": torch.from_numpy(v).to(
        dev, space.dtype)})
    model = mt.Model(mt.Diffusion(0.1))
    opts = {"tile": (32, 32)}
    want, _ = model.execute(space, mt.SerialExecutor("xla"), steps=12)
    got_a, rep_a = model.execute(
        space, mt.SerialExecutor("active", active_opts=opts), steps=12)
    got_f, rep_f = model.execute(
        space, mt.SerialExecutor("active_fused", active_opts=opts),
        steps=12)
    assert torch.equal(got_a.values["value"], want.values["value"])
    assert torch.equal(got_f.values["value"], want.values["value"])
    br = rep_f.backend_report
    assert br["fallback_steps"] == 0 and br["flags_fused"] == 12
    assert br["kernel_launches"]["fused_compute"] == 12
    assert br["kernel_launches"]["fused_scatter"] == 12
    assert rep_a.backend_report["fallback_steps"] == 0


@dataclasses.dataclass
class _Affine(Flow):
    """outflow(0) != 0: the off-grid mask must keep ghosts from shedding."""
    flow_rate: float = 0.05
    capacity: float = 3.0
    attr: str = "a"
    footprint = "pointwise"

    def outflow(self, values, origin=(0, 0)):
        return self.flow_rate * (self.capacity - values[self.attr])


class _RowRate(Flow):
    footprint = "pointwise"
    attr = "a"

    def outflow(self, values, origin=(0, 0)):
        v = values[self.attr]
        rows, _ = cell_coords(v, origin)
        return 0.002 * rows.to(v.dtype) * v


class _EveryOp(Flow):
    """Every whitelisted operation once; exp makes it a tolerance case."""
    footprint = "pointwise"
    attr = "a"

    def outflow(self, values, origin=(0, 0)):
        a, b = values["a"], values["b"]
        r, c = cell_coords(a, origin)
        x = torch.minimum(a, b) * 0.3 + torch.maximum(a, 2.0 - b) / (b + 1.5)
        y = (-a).abs() * torch.exp(-b) + a ** 2 * 0.01 - b ** 3 * 0.001
        z = ((c + 1).to(a.dtype) * 1e-4 * a
             - (r - 2).to(a.dtype) * 1e-5 * torch.clamp(b, 0.7, 1.8))
        return (x + y + z).clamp(min=0.0) * 0.05


_FLOW_SETS = {
    "config4": [mt.Diffusion(0.1, "a"), mt.Coupled(0.05, "a", "b"),
                mt.Diffusion(0.2, "b")],
    "coupled_alone": [mt.Coupled(0.05, "a", "b")],
    "affine": [_Affine()],
    "row_rate": [_RowRate()],
    "chain3": [mt.Diffusion(0.1, "a"), mt.Diffusion(0.1, "b"),
               mt.Diffusion(0.1, "c"), mt.Coupled(0.05, "a", "b"),
               mt.Coupled(0.05, "b", "c")],
    "every_op": [_EveryOp(), mt.Diffusion(0.1, "b")],
}


def _field_values(dev, dtype, shape, seed):
    rng = np.random.default_rng(seed)
    return {n: torch.from_numpy(rng.uniform(0.5, 2.0, shape)).to(dev, dtype)
            for n in ("a", "b", "c")}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,ns", [(torch.float32, 1), (torch.float32, 8),
                                      (torch.bfloat16, 16)])
@pytest.mark.parametrize("flows", sorted(_FLOW_SETS))
@pytest.mark.parametrize("shape", [(5, 7), (37, 300), (256, 512)])
def test_field_kernel_matches_plain_on_the_card(dtype, ns, flows, shape):
    dev = _card()
    fl = _FLOW_SETS[flows]
    ns = min(ns, fs.ghost_depth(shape, dtype))
    vals = _field_values(dev, dtype, shape, 13)
    step = k4.PallasFieldStep(shape, fl, nsteps=ns)
    before = k4.launches()
    got = step(vals)
    assert k4.launches() == before + 1 and step.launches == 1
    want = k4.field_step_plain(vals, fl, nsteps=ns)
    assert set(got) == set(vals)
    for n in vals:
        if n not in {f.attr for f in fl}:
            assert got[n] is vals[n]  # modulators pass through
        elif flows == "every_op" and n == "a":
            g, w = got[n].float(), want[n].float()
            tol = 8 * 2.0 ** -23 * ns * float(w.abs().max())
            if dtype == torch.bfloat16:
                tol += 2.0 ** -6  # one bf16 ulp below 4 on top
            assert float((g - w).abs().max()) <= tol
        else:
            assert torch.equal(got[n], want[n]), n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,ns", [(torch.float32, 1), (torch.float32, 8),
                                      (torch.bfloat16, 16)])
def test_field_kernel_negative_zero_on_the_card(dtype, ns):
    """Cells holding -0.0, at the grid's corner and edges and inside
    interior windows: a -0 share enters its neighbours' inflow as +0 (the
    sum starts from 0), bit for bit as the plain version."""
    dev = _card()
    shape = (256, 512)
    vals = _field_values(dev, dtype, shape, 16)
    for n in ("a", "b"):
        for r, c in ((0, 0), (0, 300), (255, 511), (100, 260), (101, 261),
                     (128, 0)):
            vals[n][r, c] = -0.0
    vals["b"][60:64, 300:310] = -0.0  # a -0 modulator under a -0 value
    vals["a"][60:62, 300:305] = -0.0
    for fl in (_FLOW_SETS["config4"], _FLOW_SETS["coupled_alone"]):
        got = k4.PallasFieldStep(shape, fl, nsteps=ns)(vals)
        want = k4.field_step_plain(vals, fl, nsteps=ns)
        for n in {f.attr for f in fl}:
            assert torch.equal(got[n].view(torch.int16 if dtype ==
                                           torch.bfloat16 else torch.int32),
                               want[n].view(torch.int16 if dtype ==
                                            torch.bfloat16 else torch.int32)
                               ), n


@pytest.mark.cuda
@pytest.mark.parametrize("offs", [VON_NEUMANN_OFFSETS, CUSTOM])
def test_field_kernel_neighborhoods_on_the_card(offs):
    dev = _card()
    vals = _field_values(dev, torch.float32, (77, 131), 14)
    fl = _FLOW_SETS["config4"]
    got = k4.PallasFieldStep((77, 131), fl, offsets=offs, nsteps=4)(vals)
    want = k4.field_step_plain(vals, fl, offs, 4)
    assert torch.equal(got["a"], want["a"]) and torch.equal(got["b"],
                                                            want["b"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,sub", [("float32", 4), ("bfloat16", 16)])
def test_field_path_on_the_card(dtype, sub):
    """Config 4's flows through SerialExecutor("pallas"): one K4 launch per
    call, equal to the plain version chained call by call, and at f32 to
    the plain-op path (the same function)."""
    dev = _card()
    g = 192
    vals = _field_values(dev, getattr(torch, dtype), (g, g), 15)
    vals.pop("c")
    space = mt.CellularSpace.create(g, g, {"a": 1.0, "b": 1.0}, dtype=dtype,
                                    device=dev).with_values(vals)
    model = mt.Model(_FLOW_SETS["config4"])
    assert model.make_step(space, impl="auto", substeps=sub).impl == "pallas"
    k4.reset_launches()
    out, rep = model.execute(space, mt.SerialExecutor("pallas",
                                                      substeps=sub),
                             steps=4 * sub)
    assert k4.launches() == 4 and rep.backend_report == {
        "kernel": "K4 field_stencil", "substeps": sub, "launches": 4,
        "channels_written": ["a", "b"]}
    want = dict(vals)
    for _ in range(4):
        want = k4.field_step_plain(want, model.flows, nsteps=sub)
    for n in ("a", "b"):
        assert torch.equal(out.values[n], want[n])
    if dtype == "float32":
        ref, _ = model.execute(space, mt.SerialExecutor("xla"),
                               steps=4 * sub)
        for n in ("a", "b"):
            assert torch.equal(out.values[n], ref.values[n])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ns", [1, 4, 8])
@pytest.mark.parametrize("offs", [MOORE_OFFSETS, VON_NEUMANN_OFFSETS, CUSTOM])
@pytest.mark.parametrize("B,shape,block", [(1, (16, 128), None),
                                           (3, (48, 384), (16, 128)),
                                           (3, (64, 512), (32, 256))])
def test_pipeline_kernel_bitwise_on_the_card(dtype, ns, offs, B, shape,
                                             block):
    dev = _card()
    v = np.random.default_rng(17).uniform(0.5, 2.0, (B,) + shape)
    x = torch.from_numpy(v).to(dev, dtype)
    before = ps.launches()
    got = ps.pipeline_dense_step(x, 0.13, offs, block=block, nsteps=ns)
    assert ps.launches() == before + 1  # one launch for every lane
    want = ps.pipeline_step_plain(x, 0.13, offs, ns, block)
    assert torch.equal(got, want)
    # out of place: the input is untouched
    assert torch.equal(x, torch.from_numpy(v).to(dev, dtype))


@pytest.mark.cuda
def test_pipeline_rows_match_the_library():
    _card()
    lib = ps._kernel_lib()
    for offs in (MOORE_OFFSETS, VON_NEUMANN_OFFSETS, CUSTOM,
                 tuple(reversed(MOORE_OFFSETS))):
        moore, _, _ = fs.closed_constants(0.1, offs)
        for ns in range(1, ps.MAX_STEPS + 1):
            assert lib.mm_pipeline_rows(ns, fs._offset_codes(offs),
                                        int(moore)) == ps.window_rows(offs,
                                                                      ns)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ns", [1, 3, 8])
@pytest.mark.parametrize("offs", [MOORE_OFFSETS,
                                  tuple(reversed(MOORE_OFFSETS)), CUSTOM])
@pytest.mark.parametrize("B,shape,block", [(2, (96, 640), (32, 128)),
                                           (2, (160, 2304), None)])
def test_pipeline_windows_clip_to_tpu_tiles_on_the_card(dtype, ns, offs, B,
                                                        shape, block):
    """Closed-form tiles beside near ones (96×640 in (32, 128) tiles), and
    TPU tiles whose width the windows do not divide (2304 columns in
    1152-wide tiles): bit for bit, every output written."""
    dev = _card()
    v = np.random.default_rng(29).uniform(0.5, 2.0, (B,) + shape)
    x = torch.from_numpy(v).to(dev, dtype)
    out = torch.full_like(x, float("nan"))
    ps.pipeline_dense_step(x, 0.13, offs, block=block, nsteps=ns, out=out)
    assert torch.equal(out, ps.pipeline_step_plain(x, 0.13, offs, ns, block))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pipeline_ensemble_on_the_card(dtype):
    """EnsembleExecutor("pipeline") on the card: steps/substeps K5 launches
    per dispatch, lanes equal to the plain version chained call by call,
    and a result never aliases a buffer of a later dispatch."""
    dev = _card()
    rng = np.random.default_rng(19)
    spaces = [mt.CellularSpace.create(48, 384, 1.0, dtype=dtype, device=dev)
              .with_values({"value": torch.from_numpy(rng.uniform(
                  0.5, 2.0, (48, 384))).to(dev, getattr(torch, dtype))})
              for _ in range(3)]
    model = mt.Model(mt.Diffusion(0.1))
    svc = mt.EnsembleService(model, steps=9, impl="pipeline", substeps=4)
    before = ps.launches()
    first = [svc.result(t) for t in [svc.submit(s) for s in spaces]]
    assert ps.launches() == before + 3  # 2 calls of 4 steps, 1 of 1
    kept = [sp.values["value"].clone() for sp, _ in first]
    for (sp, rep), s in zip(first, spaces):
        want = s.values["value"]
        for n in (4, 4, 1):
            want = ps.pipeline_step_plain(want, 0.1, MOORE_OFFSETS, n)
        assert torch.equal(sp.values["value"], want)
        assert rep.backend_report["launches"] == 3
    second = [svc.result(t) for t in [svc.submit(s) for s in spaces]]
    assert svc.stats()["runner_cache_hits"] == 1
    _no_rung(svc.stats())
    ptrs = {sp.values["value"].untyped_storage().data_ptr()
            for sp, _ in second}
    for (sp, _), k in zip(first, kept):
        assert torch.equal(sp.values["value"], k)
        assert sp.values["value"].untyped_storage().data_ptr() not in ptrs


@pytest.mark.cuda
def test_xla_ensemble_lanes_bitwise_serial_on_the_card():
    dev = _card()
    rng = np.random.default_rng(23)
    spaces = [mt.CellularSpace.create(64, 64, 1.0, device=dev).with_values(
        {"value": torch.from_numpy(rng.uniform(0.5, 2.0, (64, 64))).to(
            dev, torch.float32)}) for _ in range(3)]
    models = [mt.Model(mt.Diffusion(0.1 * (1 + 0.05 * i))) for i in range(3)]
    out = models[0].execute_many(spaces, models=models, steps=6)
    for i, (sp, rep) in enumerate(out):
        want, wrep = models[i].execute(spaces[i], mt.SerialExecutor("xla"),
                                       steps=6)
        assert torch.equal(sp.values["value"], want.values["value"])
        assert rep.final_total == wrep.final_total


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["pipeline", "xla"])
def test_launch_queues_without_a_synchronization(impl):
    """``launch_ensemble`` queues a dispatch on the stream and waits for
    nothing (torch's sync debug mode raises on any synchronizing call);
    ``complete_ensemble`` then waits on the flight's event."""
    from mpi_model_tpu_torch.ensemble.batch import (complete_ensemble,
                                                    launch_ensemble)

    dev = _card()
    rng = np.random.default_rng(29)
    spaces = [mt.CellularSpace.create(48, 384, 1.0, device=dev).with_values(
        {"value": torch.from_numpy(rng.uniform(0.5, 2.0, (48, 384))).to(
            dev, torch.float32)}) for _ in range(3)]
    if impl == "pipeline":
        models = [mt.Model(mt.Diffusion(0.1))] * 3
    else:
        models = [mt.Model([mt.Diffusion(0.1 * (1 + 0.05 * i)),
                            mt.PointFlow(source=(5, 7), flow_rate=0.1)])
                  for i in range(3)]
    ex = mt.EnsembleExecutor(impl, substeps=4)
    kw = dict(models=models, executor=ex, steps=9)
    warm = complete_ensemble(launch_ensemble(models[0], spaces, **kw))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        flight = launch_ensemble(models[0], spaces, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = complete_ensemble(flight)
    for (a, _), (b, _) in zip(got, warm):
        assert torch.equal(a.values["value"], b.values["value"])


# -- the always-on serving loop ----------------------------------------------

def _no_rung(stats):
    """The degradation ladder did not stand in for the kernel: no rung and
    no impl-level fault (the kernel's counter is the caller's check)."""
    assert stats["degraded_from"] is None and stats["impl_faults"] == 0
    assert not stats["intake_gated"]


def _lanes(dev, B, side, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [mt.CellularSpace.create(side, side, 1.0, device=dev).with_values(
        {"value": torch.from_numpy(rng.uniform(0.5, 2.0, (side, side))).to(
            dev, dtype)}) for _ in range(B)]


@pytest.mark.cuda
def test_a_flight_finishes_while_a_later_flight_runs():
    """``complete_ensemble`` waits on its own flight's event: a pipeline
    flight finishes while an xla flight queued behind it on the same
    stream is still running, and both then give their synchronous
    results."""
    from mpi_model_tpu_torch.ensemble.batch import (complete_ensemble,
                                                    launch_ensemble)

    dev = _card()
    model = mt.Model(mt.Diffusion(0.1))
    first = _lanes(dev, 8, 1024, 41)
    second = _lanes(dev, 32, 1024, 43)
    k5 = mt.EnsembleExecutor("pipeline", substeps=8)
    xla = mt.EnsembleExecutor("xla")
    want1 = complete_ensemble(launch_ensemble(model, first, executor=k5,
                                              steps=8))
    want2 = complete_ensemble(launch_ensemble(model, second, executor=xla,
                                              steps=64))
    torch.cuda.synchronize()
    f1 = launch_ensemble(model, first, executor=k5, steps=8)
    f2 = launch_ensemble(model, second, executor=xla, steps=64)
    got1 = complete_ensemble(f1)
    pending = not f2.done.query()
    got2 = complete_ensemble(f2)
    assert pending, "finishing the first flight waited for the second"
    for got, want in ((got1, want1), (got2, want2)):
        for (a, ra), (b, rb) in zip(got, want):
            assert torch.equal(a.values["value"], b.values["value"])
            assert ra.final_total == rb.final_total


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_async_pipeline_bitwise_sync_on_the_card(compute_dtype):
    """The loop's pump thread serves ``impl="pipeline"`` (K5) bit for bit as
    the synchronous service does, steps/substeps K5 launches a dispatch."""
    dev = _card()
    model = mt.Model(mt.Diffusion(0.1))
    spaces = _lanes(dev, 8, 1024, 47)
    kw = dict(steps=8, impl="pipeline", substeps=8,
              buckets=mt.buckets_for(8), retry="solo",
              compute_dtype=compute_dtype)
    sync = mt.EnsembleService(model, **kw)
    want = [sync.result(t) for t in [sync.submit(s) for s in spaces]]
    with mt.AsyncEnsembleService(model, **kw) as svc:
        before = ps.launches()
        got = [svc.result(t, timeout=300)
               for t in [svc.submit(s) for s in spaces]]
        launched = ps.launches() - before
    # the pump dispatches whatever is queued when it looks: one K5 launch
    # a dispatch, however the 8 submissions were cut
    assert launched == svc.stats()["dispatches"] >= 1
    _no_rung(svc.stats())
    _no_rung(sync.stats())
    for (a, ra), (b, rb) in zip(got, want):
        assert torch.equal(a.values["value"], b.values["value"])
        assert ra.final_total == rb.final_total


@pytest.mark.cuda
def test_a_k5_launch_error_reaches_the_ticket_on_the_card(monkeypatch):
    """A K5 launch error in the pump reaches each ticket as that error
    (the solo retry, then quarantine) at the default ``degrade_after``: it
    steps no rung of the degradation ladder, and the plain version never
    runs on the card in its place."""
    from mpi_model_tpu_torch.ops import KernelError

    dev = _card()
    model = mt.Model(mt.Diffusion(0.1))
    spaces = _lanes(dev, 2, 256, 53)
    svc = mt.AsyncEnsembleService(model, steps=8, impl="pipeline",
                                  substeps=8, start=False)

    class FailingLib:
        def mm_pipeline_stencil_f32(self, *args):
            return 98

        mm_pipeline_stencil_bf16 = mm_pipeline_stencil_f32

        def mm_cuda_error_string(self, err):
            return b"invalid device function"

    plain = []
    monkeypatch.setattr(ps, "_kernel_lib", FailingLib)
    monkeypatch.setattr(ps, "pipeline_step_plain",
                        lambda *a, **k: plain.append(a))
    tickets = [svc.submit(s) for s in spaces]
    svc.stop()
    for t in tickets:
        with pytest.raises(KernelError,
                           match="invalid device function") as ei:
            svc.poll(t)
        assert ei.value.failure_event.attempt == 2
    assert plain == []
    st = svc.stats()
    assert (st["quarantined"], st["impl_faults"], st["degraded_from"],
            st["impl"]) == (2, 3, None, "pipeline")


# -- the halo kernels K2, K3-halo and K4-halo, and the sharded path ---------

def _shards(dev, dtype, shape, mesh_shape, seed, names=("value",)):
    """A global grid per channel from a numpy seed, cut into the shards of
    an L x C mesh over one card."""
    from mpi_model_tpu_torch.parallel import make_mesh_2d
    from mpi_model_tpu_torch.parallel.mesh import shard_tensor

    rng = np.random.default_rng(seed)
    lines, columns = mesh_shape
    mesh = make_mesh_2d(lines, columns, devices=[dev] * (lines * columns))
    h, w = shape[0] // lines, shape[1] // columns
    full = {n: torch.from_numpy(rng.uniform(0.5, 2.0, shape)).to(dev, dtype)
            for n in names}
    return mesh, full, {n: shard_tensor(t, mesh, h, w)
                        for n, t in full.items()}, (h, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,ns", [(torch.float32, 1), (torch.float32, 4),
                                      (torch.float32, 8),
                                      (torch.bfloat16, 16)])
@pytest.mark.parametrize("offs", [MOORE_OFFSETS, VON_NEUMANN_OFFSETS, CUSTOM])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4), (3, 2)])
def test_halo_kernel_bitwise_plain_on_the_card(dtype, ns, offs, mesh_shape):
    """K2 on every shard (edge, corner and interior origins) equals
    ``halo_step_plain`` bit for bit, and the shards put together equal K1
    on the whole grid bit for bit."""
    from mpi_model_tpu_torch.parallel import assemble, exchange_ring

    dev = _card()
    mesh, full, g, (h, w) = _shards(dev, dtype, (96, 768), mesh_shape, 31)
    g = g["value"]
    lines, columns = mesh_shape
    before = fs.halo_launches()
    out = [[None] * columns for _ in range(lines)]
    for i in range(lines):
        for j in range(columns):
            ring = exchange_ring(g, i, j, ns)
            got = fs.pallas_halo_step(g[i][j], ring, (i * h, j * w),
                                      (96, 768), 0.13, offs, nsteps=ns)
            want = fs.halo_step_plain(g[i][j], ring, (i * h, j * w),
                                      (96, 768), 0.13, offs, ns)
            assert torch.equal(got, want), (i, j)
            out[i][j] = got
    assert fs.halo_launches() == before + lines * columns
    assert torch.equal(assemble(out, dev),
                       fs.pallas_dense_step(full["value"], 0.13, offs,
                                            nsteps=ns))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,k", [(torch.float32, 1), (torch.float32, 8),
                                     (torch.bfloat16, 16)])
@pytest.mark.parametrize("offs", [MOORE_OFFSETS, CUSTOM])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
def test_composed_halo_kernel_on_the_card(dtype, k, offs, mesh_shape):
    """K3-halo (``"auto"``) on every shard against
    ``composed_halo_step_plain`` in the resolved form, at K3's tolerance;
    the shards put together equal K3 on the whole grid bit for bit (the
    interior/band choice is per cell, the mxu tiles are aligned to the
    global grid)."""
    from mpi_model_tpu_torch.parallel import assemble, exchange_ring

    dev = _card()
    mesh, full, g, (h, w) = _shards(dev, dtype, (192, 1024), mesh_shape, 37)
    g = g["value"]
    lines, columns = mesh_shape
    out = [[None] * columns for _ in range(lines)]
    form = cs.resolve_form("auto", k, fs.resolve_block((h, w), dtype)[1])
    for i in range(lines):
        for j in range(columns):
            ring = exchange_ring(g, i, j, k)
            got = cs.composed_halo_step(g[i][j], ring, (i * h, j * w),
                                        (192, 1024), 0.13, k, offs)
            want = cs.composed_halo_step_plain(g[i][j], ring, (i * h, j * w),
                                               (192, 1024), 0.13, k, offs,
                                               form)
            _held_to_plain(got, want, form, k)
            out[i][j] = got
    assert torch.equal(assemble(out, dev),
                       cs.composed_dense_step(full["value"], 0.13, k, offs))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["vpu", "mxu"])
@pytest.mark.parametrize("dtype,k", [(torch.float32, 4), (torch.float32, 8),
                                     (torch.bfloat16, 16)])
@pytest.mark.parametrize("mesh_shape,shape", [((2, 2), (300, 1024)),
                                              ((2, 3), (150, 768))])
def test_composed_halo_forms_unaligned_on_the_card(form, dtype, k,
                                                   mesh_shape, shape):
    """Each form on shards whose row origins are not multiples of the
    kernels' tiles (150, 75): every shard against its plain version, the
    mosaic bit for bit the whole grid."""
    from mpi_model_tpu_torch.parallel import assemble, exchange_ring

    dev = _card()
    mesh, full, g, (h, w) = _shards(dev, dtype, shape, mesh_shape, 41)
    g = g["value"]
    lines, columns = mesh_shape
    out = [[None] * columns for _ in range(lines)]
    before = cs.halo_launches(form)
    for i in range(lines):
        for j in range(columns):
            ring = exchange_ring(g, i, j, k)
            out[i][j] = cs.composed_halo_step(
                g[i][j], ring, (i * h, j * w), shape, 0.13, k, variant=form)
            _held_to_plain(out[i][j], cs.composed_halo_step_plain(
                g[i][j], ring, (i * h, j * w), shape, 0.13, k,
                variant=form), form, k)
    assert cs.halo_launches(form) == before + lines * columns
    assert torch.equal(assemble(out, dev), cs.composed_dense_step(
        full["value"], 0.13, k, variant=form))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,ns", [(torch.float32, 1), (torch.float32, 8),
                                      (torch.bfloat16, 16)])
@pytest.mark.parametrize("flows", ["config4", "row_rate", "chain3",
                                   "affine"])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
def test_field_halo_kernel_bitwise_plain_on_the_card(dtype, ns, flows,
                                                     mesh_shape):
    """K4-halo on every shard equals ``field_halo_step_plain`` bit for bit
    (coordinates global), modulators pass through, and the shards put
    together equal K4 on the whole grid bit for bit."""
    from mpi_model_tpu_torch.parallel import assemble, exchange_ring

    dev = _card()
    fl = _FLOW_SETS[flows]
    names = ("a", "b", "c")
    mesh, full, g, (h, w) = _shards(dev, dtype, (128, 512), mesh_shape, 41,
                                    names)
    lines, columns = mesh_shape
    step = k4.PallasFieldStep((h, w), fl, nsteps=ns)
    written = {f.attr for f in fl}
    out = {n: [[None] * columns for _ in range(lines)] for n in written}
    before = k4.halo_launches()
    for i in range(lines):
        for j in range(columns):
            vals = {n: g[n][i][j] for n in names}
            rings = {n: exchange_ring(g[n], i, j, ns) for n in names}
            got = step.halo(vals, rings, (i * h, j * w), (128, 512))
            want = k4.field_halo_step_plain(vals, rings, (i * h, j * w),
                                            (128, 512), fl, nsteps=ns)
            for n in names:
                if n in written:
                    assert torch.equal(got[n], want[n]), (i, j, n)
                    out[n][i][j] = got[n]
                else:
                    assert got[n] is vals[n]
    assert k4.halo_launches() == before + lines * columns
    dense = k4.PallasFieldStep((128, 512), fl, nsteps=ns)(full)
    for n in written:
        assert torch.equal(assemble(out[n], dev), dense[n]), n


@pytest.mark.cuda
@pytest.mark.parametrize("impl,depth", [("pallas", 8), ("pallas", 3),
                                        ("composed", 8), ("xla", 1)])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
def test_sharded_path_bitwise_serial_on_the_card(impl, depth, mesh_shape):
    """``ShardMapExecutor`` over one card equals the serial run of the same
    chunks bit for bit: K2 against K1, K3-halo against K3, xla against
    xla. K2 runs 20 steps, so depth 8 and 3 end on a remainder chunk, which
    runs at its own depth, where the serial path's remainder takes single
    steps; K1 and K3 choose their forms by the call's depth, so the serial
    reference runs the remainder as one call of that depth. K3 runs a
    multiple of its depth."""
    from mpi_model_tpu_torch.parallel import ShardMapExecutor, make_mesh_2d

    dev = _card()
    rng = np.random.default_rng(43)
    x = torch.from_numpy(rng.uniform(0.5, 2.0, (256, 1024))).to(
        dev, torch.float32)
    space = mt.CellularSpace.create(256, 1024, 1.0, device=dev).with_values(
        {"value": x})
    model = mt.Model(mt.Diffusion(0.1))
    lines, columns = mesh_shape
    mesh = make_mesh_2d(lines, columns, devices=[dev] * (lines * columns))
    steps = 16 if impl == "composed" else 20
    ex = ShardMapExecutor(mesh, impl, halo_depth=depth)
    out, rep = model.execute(space, ex, steps=steps)
    q, r = divmod(steps, depth)
    want, _ = model.execute(space, mt.SerialExecutor(
        impl, substeps=depth if impl != "xla" else 1), steps=q * depth)
    if r:
        want, _ = model.execute(want, mt.SerialExecutor(
            impl, substeps=r if impl != "xla" else 1), steps=r)
    assert rep.impl == impl and rep.comm_size == lines * columns
    assert torch.equal(out.values["value"], want.values["value"])
    if impl != "xla":
        assert rep.backend_report["launches"] == (q + (r > 0)) * lines \
            * columns


@pytest.mark.cuda
def test_sharded_field_path_bitwise_serial_on_the_card():
    """Config 4's flows through the ``field`` plan (K4-halo) on a 2x2 mesh
    equal serial K4 bit for bit."""
    from mpi_model_tpu_torch.parallel import ShardMapExecutor, make_mesh_2d

    dev = _card()
    rng = np.random.default_rng(47)
    vals = {n: torch.from_numpy(rng.uniform(0.5, 2.0, (256, 512))).to(
        dev, torch.float32) for n in ("a", "b")}
    space = mt.CellularSpace.create(256, 512, {"a": 1.0, "b": 1.0},
                                    device=dev).with_values(vals)
    model = mt.Model(_FLOW_SETS["config4"])
    mesh = make_mesh_2d(2, 2, devices=[dev] * 4)
    out, rep = model.execute(space, ShardMapExecutor(mesh, "pallas",
                                                     halo_depth=8), steps=20)
    want, _ = model.execute(space, mt.SerialExecutor("pallas", substeps=8),
                            steps=20)
    assert rep.backend_report["kernel"] == "K4-halo field_stencil"
    for n in ("a", "b"):
        assert torch.equal(out.values[n], want.values[n]), n


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["active", "active_fused"])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sharded_active_bitwise_serial_on_the_card(impl, mesh_shape, dtype):
    """The shard-local active sets on one card, sources on the seams: bit
    for bit the serial run with the same impl and sharded xla; K6 and K7
    launch once per flagged (shard, step), ``fa.launches()`` reading
    ``flags_fused``."""
    from mpi_model_tpu_torch.parallel import (ShardMapExecutor, make_mesh,
                                              make_mesh_2d)

    dev = _card()
    # on 2x2 no shard holds more than a quarter of its 128² tiles active
    # (K6/K7 serve every step); on the stripes one shard falls back
    v = np.zeros((1024, 2048))
    for x, y, a in ((511, 100, 1.7), (600, 1023, 2.0), (0, 2047, 1.1)):
        v[x, y] = a
    space = mt.CellularSpace.create(1024, 2048, 0.0, dtype=dtype,
                                    device=dev).with_values(
        {"value": torch.from_numpy(v).to(dev, getattr(torch, dtype))})
    model = mt.Model(mt.Diffusion(0.1))
    lines, columns = mesh_shape
    mesh = (make_mesh(lines, devices=[dev] * lines) if columns == 1
            else make_mesh_2d(lines, columns, devices=[dev] * 4))
    fa.reset_launches()
    out, rep = model.execute(space, ShardMapExecutor(mesh, impl), steps=24)
    ran = fa.launches()
    br = rep.backend_report
    # the serial plan never falls back: its fallback on the card is K1,
    # whose step is v*(1-r) + inflow, not the plain (v - r*v) + inflow
    want, _ = model.execute(space, mt.SerialExecutor(
        impl, active_opts={"max_active_frac": 1.0}), steps=24)
    assert torch.equal(out.values["value"], want.values["value"])
    xla, _ = model.execute(space, ShardMapExecutor(mesh, "xla"), steps=24)
    assert torch.equal(out.values["value"], xla.values["value"])
    assert br["fallback_steps"] == (0 if columns > 1 else 23)
    if impl == "active_fused":
        assert ran["fused_compute"] == ran["fused_scatter"] \
            == br["flags_fused"] == 24 * 4 - br["fallback_steps"]
    else:
        assert ran == {"fused_compute": 0, "fused_scatter": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["build", "launch"])
def test_sharded_active_fused_kernel_error_propagates(fault, monkeypatch):
    """A K6 build or launch error on a card shard ends the sharded
    ``"active_fused"`` run with that error: no shard falls back to the
    plain version or to another impl."""
    from mpi_model_tpu_torch.parallel import ShardMapExecutor, make_mesh_2d

    dev = _card()

    class FailingLaunch:
        """The kernel library with every launch failing as a card that
        cannot run it fails."""

        @staticmethod
        def mm_fused_compute(*args):
            return 209

        @staticmethod
        def mm_fused_scatter(*args):
            return 209

        @staticmethod
        def mm_cuda_error_string(err):
            return b"no kernel image is available for execution"

    def failing_build():
        raise RuntimeError("nvcc failed building fused_active")

    monkeypatch.setattr(fa, "_kernel_lib", failing_build if fault == "build"
                        else lambda: FailingLaunch)
    # one live tile in shard (0, 0): its dilation (4 of 16 tiles) stays
    # within the shard's capacity, so the first step launches K6
    v = np.zeros((1024, 1024))
    v[64, 64] = 1.5
    space = mt.CellularSpace.create(1024, 1024, 0.0, dtype="float32",
                                    device=dev).with_values(
        {"value": torch.from_numpy(v).to(dev, torch.float32)})
    ex = ShardMapExecutor(make_mesh_2d(2, 2, devices=[dev] * 4),
                          "active_fused")
    fa.reset_launches()
    want = ("nvcc failed" if fault == "build"
            else r"fused_compute \(K6\) kernel launch failed")
    with pytest.raises(RuntimeError, match=want):
        ex.run_model(mt.Model(mt.Diffusion(0.1)), space, 3)
    assert fa.launches() == {"fused_compute": 0, "fused_scatter": 0}


# -- bf16 interior math (compute_dtype=bfloat16) --------------------------------
#
# Each bf16-interior variant against its plain version: K1, K2, K3 vpu,
# K3-halo vpu, K4, K4-halo and K5 bit for bit (every bf16 operation rounds
# once, in the plain version's order, none contracted); K3 mxu at its f32
# tolerance (the bf16 products are exact in f32, the tensor cores sum them
# in another order: 1e-6·k·max|v| at f32 storage, one bf16 ulp at bf16).
# The blocks put the rectangle of bf16 cells across the kernels' tiles, so
# blocks that straddle its edge run both passes.

_BF = torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,ns", [(torch.float32, 1), (torch.float32, 2),
                                      (torch.float32, 8), (torch.bfloat16, 4),
                                      (torch.bfloat16, 16)])
@pytest.mark.parametrize("offs", [MOORE_OFFSETS, VON_NEUMANN_OFFSETS, CUSTOM])
@pytest.mark.parametrize("shape,block", [((512, 1024), (64, 128)),
                                         ((336, 1000), (48, 200)),
                                         ((1024, 1024), None)])
def test_bf16_interior_k1_on_the_card(dtype, ns, offs, shape, block):
    """K1 bf16-interior against ``dense_step_plain(..., compute_dtype)``;
    at one step the f32 result; (1024, 1024) at JAX's blocks: no tile off
    the edge, every cell from the grid rounded to bf16."""
    dev = _card()
    ns = min(ns, fs.ghost_depth(shape, dtype, block))
    v = np.random.default_rng(7).uniform(0.5, 2.0, shape)
    x = torch.from_numpy(v).to(dev, dtype)
    before = fs.launches()
    got = fs.pallas_dense_step(x, 0.13, offs, block=block, nsteps=ns,
                               compute_dtype=_BF)
    assert fs.launches() == before + 1
    assert torch.equal(got, fs.dense_step_plain(x, 0.13, offs, ns, _BF,
                                                block))
    if ns == 1:
        assert torch.equal(got, fs.pallas_dense_step(x, 0.13, offs,
                                                     block=block))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,ns", [(torch.float32, 4), (torch.float32, 8),
                                      (torch.bfloat16, 16)])
@pytest.mark.parametrize("offs", [MOORE_OFFSETS, CUSTOM])
@pytest.mark.parametrize("mesh_shape,shape", [((2, 2), (1024, 2048)),
                                              ((1, 4), (96, 768))])
def test_bf16_interior_k2_on_the_card(dtype, ns, offs, mesh_shape, shape):
    """K2 bf16-interior on every shard (each shard's TPU tiles at its
    origin; on 96 x 768 every tile is near) against ``halo_step_plain``."""
    from mpi_model_tpu_torch.parallel import exchange_ring

    dev = _card()
    mesh, full, g, (h, w) = _shards(dev, dtype, shape, mesh_shape, 43)
    g = g["value"]
    lines, columns = mesh_shape
    for i in range(lines):
        for j in range(columns):
            ring = exchange_ring(g, i, j, ns)
            got = fs.pallas_halo_step(g[i][j], ring, (i * h, j * w), shape,
                                      0.13, offs, nsteps=ns,
                                      compute_dtype=_BF)
            want = fs.halo_step_plain(g[i][j], ring, (i * h, j * w), shape,
                                      0.13, offs, ns, _BF)
            assert torch.equal(got, want), (i, j)


# K1/K2 bf16-interior as two launches: the near launch (the f32 walk over
# the bands around the rectangle) and the paired launch (the row-paired bf16
# walk over the rectangle, at fs.paired_rows's rows; other neighbourhoods
# the rounded f32 walk), each output filled with NaN first. Geometries: the
# rectangle across the tiles, block columns of 200, and an odd rectangle
# (rows [45, 180) and columns [333, 666) at block (45, 333)).

_K1_BF16_GEOMETRIES = {"cut": ((512, 1024), (64, 128)),
                       "odd_block": ((336, 1000), (48, 200)),
                       "odd_rect": ((225, 999), (45, 333))}


def _held_nan_by_position(got, want):
    """Bit for bit, NaN compared by position."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got[~nan].view(bits), want[~nan].view(bits))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,ns", [(torch.float32, 2), (torch.float32, 3),
                                      (torch.float32, 5), (torch.float32, 8),
                                      (torch.bfloat16, 2),
                                      (torch.bfloat16, 7),
                                      (torch.bfloat16, 12),
                                      (torch.bfloat16, 16)])
@pytest.mark.parametrize("offs", [MOORE_OFFSETS, VON_NEUMANN_OFFSETS, CUSTOM])
@pytest.mark.parametrize("geometry", sorted(_K1_BF16_GEOMETRIES))
def test_bf16_interior_k1_two_launches_on_the_card(dtype, ns, offs,
                                                   geometry):
    """Every cell written once (NaN-filled output), bit for bit
    ``dense_step_plain(..., compute_dtype=bfloat16)``, counted as one
    launch."""
    dev = _card()
    shape, block = _K1_BF16_GEOMETRIES[geometry]
    ns = min(ns, fs.ghost_depth(shape, dtype, block))
    x = torch.from_numpy(np.random.default_rng(ns).uniform(
        0.5, 2.0, shape)).to(dev, dtype)
    out = torch.full_like(x, float("nan"))
    before = fs.launches()
    fs.pallas_dense_step(x, 0.13, offs, block=block, nsteps=ns,
                         compute_dtype=_BF, out=out)
    assert fs.launches() == before + 1
    assert torch.equal(out, fs.dense_step_plain(x, 0.13, offs, ns, _BF,
                                                block))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,ns", [(torch.float32, 8), (torch.bfloat16, 4),
                                      (torch.bfloat16, 16)])
@pytest.mark.parametrize("offs", [MOORE_OFFSETS, CUSTOM])
@pytest.mark.parametrize("values", ["zeros_subnormals", "inf"])
@pytest.mark.parametrize("geometry", ["cut", "odd_rect"])
def test_bf16_interior_k1_special_values_on_the_card(dtype, ns, offs, values,
                                                     geometry):
    """Windows holding +-0 and bf16 subnormals, and +-inf: bit for bit the
    plain version, NaN by position (add.rn.bf16x2 meets them as the plain
    version's f32 operation rounded once does)."""
    dev = _card()
    shape, block = _K1_BF16_GEOMETRIES[geometry]
    ns = min(ns, fs.ghost_depth(shape, dtype, block))
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        0.5, 2.0, shape)).to(dev, dtype)
    x = _with_specials({"v": x}, 13)["v"]
    if values == "zeros_subnormals":
        x = torch.where(torch.isinf(x), torch.ones_like(x), x)
    got = fs.pallas_dense_step(x, 0.13, offs, block=block, nsteps=ns,
                               compute_dtype=_BF)
    _held_nan_by_position(got, fs.dense_step_plain(x, 0.13, offs, ns, _BF,
                                                   block))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,ns", [(torch.float32, 4), (torch.float32, 8),
                                      (torch.bfloat16, 16)])
@pytest.mark.parametrize("offs", [MOORE_OFFSETS, CUSTOM])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1), (4, 4)])
def test_bf16_interior_k2_mosaic_is_k1_on_the_card(dtype, ns, offs,
                                                   mesh_shape):
    """K2 bf16-interior on the 2x2 and 4-stripe meshes of (1024, 2048), at
    one block for the grid and its shards (so both take the same bf16
    cells; on 4x4 the inner shards lie wholly in the rectangle: no near
    launch): every shard's NaN-filled output bit for bit its plain version,
    and the shards put together bit for bit K1's whole grid."""
    from mpi_model_tpu_torch.parallel import assemble, exchange_ring

    dev = _card()
    shape, block = (1024, 2048), (64, 128)
    mesh, full, g, (h, w) = _shards(dev, dtype, shape, mesh_shape, 53)
    g = g["value"]
    lines, columns = mesh_shape
    out = [[None] * columns for _ in range(lines)]
    before = fs.halo_launches()
    for i in range(lines):
        for j in range(columns):
            ring = exchange_ring(g, i, j, ns)
            o = torch.full_like(g[i][j], float("nan"))
            fs.pallas_halo_step(g[i][j], ring, (i * h, j * w), shape, 0.13,
                                offs, block=block, nsteps=ns,
                                compute_dtype=_BF, out=o)
            assert torch.equal(o, fs.halo_step_plain(
                g[i][j], ring, (i * h, j * w), shape, 0.13, offs, ns, _BF,
                block)), (i, j)
            out[i][j] = o
    assert fs.halo_launches() == before + lines * columns
    assert torch.equal(assemble(out, dev), fs.pallas_dense_step(
        full["value"], 0.13, offs, block=block, nsteps=ns,
        compute_dtype=_BF))


#: (grid, block, mesh) of the geometry checks: K1 grids (mesh (1, 1)) and
#: K2's meshes (an empty rectangle on the stripes of (96, 768), no near band
#: on the inner shards of 4x4); only index arithmetic runs, no grid is built
_K1_PLAN_GEOMETRIES = {"cut": ((512, 1024), (64, 128), (1, 1)),
                       "odd_block": ((336, 1000), (48, 200), (1, 1)),
                       "odd_rect": ((225, 999), (45, 333), (1, 1)),
                       "main": ((16384, 16384), None, (1, 1)),
                       "main_2x2": ((16384, 16384), None, (2, 2)),
                       "main_stripes": ((16384, 16384), None, (4, 1)),
                       "near_stripes": ((96, 768), None, (4, 1)),
                       "inner_4x4": ((4096, 4096), (512, 512), (4, 4))}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offs", [MOORE_OFFSETS, CUSTOM])
@pytest.mark.parametrize("geometry", sorted(_K1_PLAN_GEOMETRIES))
def test_bf16_interior_k1_plan_is_the_library_s(dtype, offs, geometry):
    """``window_rows``, ``bf16_regions`` and ``region_tiles`` (the CPU
    tests' and ``chip_smoke.py``'s bounds' view of the two launches) are
    the source's own geometry, read through ``kernel_plan``: on every
    shard at every nsteps, the near launch's rows, and the paired region's
    and each band's cells and tiles."""
    _card()
    gshape, block, (lines, columns) = _K1_PLAN_GEOMETRIES[geometry]
    h, w = gshape[0] // lines, gshape[1] // columns
    for ns in range(2, fs.ghost_depth((h, w), dtype, block) + 1):
        for i in range(lines):
            for j in range(columns):
                org = (i * h, j * w)
                rect = fs.kernel_rect((h, w), dtype, block, ns, _BF, org,
                                      gshape)
                inner, bands = fs.bf16_regions((h, w), (
                    rect[0] - org[0], rect[1] - org[0], rect[2] - org[1],
                    rect[3] - org[1]))
                rows, regions = fs.kernel_plan((h, w), rect, ns, offs, org,
                                               gshape)
                assert rows == fs.window_rows(ns, offs)
                rows16 = fs.paired_rows(ns, offs)
                assert regions == [
                    (*inner, len(fs.region_tiles(inner, rows16, ns))),
                    *((*b, len(fs.region_tiles(b, rows, ns)))
                      for b in bands)], (ns, org)


@pytest.mark.cuda
@pytest.mark.parametrize("halo", [False, True])
def test_bf16_interior_k1_launch_error_raises(monkeypatch, halo):
    """No fallback: window rows the source has no paired instance of are
    refused before either launch; the error names the kernel, the layout
    and the rows; nothing is counted and nothing is written."""
    from mpi_model_tpu_torch.parallel import exchange_ring

    dev = _card()
    monkeypatch.setattr(fs, "paired_rows", lambda nsteps, offsets: 72)
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        0.5, 2.0, (512, 1024))).to(dev, torch.float32)
    kname = "K2" if halo else "K1"
    before = (fs.launches(), fs.halo_launches())
    if halo:
        g = [[x[i * 256:(i + 1) * 256, j * 512:(j + 1) * 512].contiguous()
              for j in range(2)] for i in range(2)]
        out = torch.full_like(g[1][0], float("nan"))
        with pytest.raises(RuntimeError,
                           match=f"{kname} .*row pairs, 72 rows"):
            fs.pallas_halo_step(g[1][0], exchange_ring(g, 1, 0, 8), (256, 0),
                                (512, 1024), 0.13, block=(64, 128), nsteps=8,
                                compute_dtype=_BF, out=out)
    else:
        out = torch.full_like(x, float("nan"))
        with pytest.raises(RuntimeError,
                           match=f"{kname} .*row pairs, 72 rows"):
            fs.pallas_dense_step(x, 0.13, block=(64, 128), nsteps=8,
                                 compute_dtype=_BF, out=out)
    torch.cuda.synchronize()
    assert (fs.launches(), fs.halo_launches()) == before
    assert bool(torch.isnan(out).all())


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["vpu", "mxu"])
@pytest.mark.parametrize("dtype,k", [(torch.float32, 1), (torch.float32, 8),
                                     (torch.bfloat16, 4),
                                     (torch.bfloat16, 16)])
@pytest.mark.parametrize("offs", [MOORE_OFFSETS, CUSTOM])
@pytest.mark.parametrize("shape,block", [((512, 1024), (64, 256)),
                                         ((320, 1280), (80, 640))])
def test_bf16_interior_k3_on_the_card(form, dtype, k, offs, shape, block):
    """K3 bf16-interior in each form against its plain version."""
    dev = _card()
    if k > cs.max_k(shape, dtype, block):
        pytest.skip("k past the window's ghost depth")
    x = torch.from_numpy(np.random.default_rng(9).uniform(
        0.5, 2.0, shape)).to(dev, dtype)
    got = cs.composed_dense_step(x, 0.13, k, offs, block=block, variant=form,
                                 compute_dtype=_BF)
    want = cs.composed_dense_step_plain(x, 0.13, k, offs, form, _BF, block)
    _held_to_plain(got, want, form, k)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["vpu", "mxu"])
@pytest.mark.parametrize("dtype,k", [(torch.float32, 8), (torch.bfloat16, 16)])
@pytest.mark.parametrize("mesh_shape,shape", [((2, 2), (1024, 2048)),
                                              ((2, 3), (150, 768))])
def test_bf16_interior_k3_halo_on_the_card(form, dtype, k, mesh_shape,
                                           shape):
    from mpi_model_tpu_torch.parallel import exchange_ring

    dev = _card()
    mesh, full, g, (h, w) = _shards(dev, dtype, shape, mesh_shape, 47)
    g = g["value"]
    lines, columns = mesh_shape
    for i in range(lines):
        for j in range(columns):
            ring = exchange_ring(g, i, j, k)
            got = cs.composed_halo_step(g[i][j], ring, (i * h, j * w), shape,
                                        0.13, k, variant=form,
                                        compute_dtype=_BF)
            want = cs.composed_halo_step_plain(
                g[i][j], ring, (i * h, j * w), shape, 0.13, k, variant=form,
                compute_dtype=_BF)
            _held_to_plain(got, want, form, k)


# K3/K3-halo vpu bf16-interior as two launches: the near launch (the f32
# walk over the bands around the rectangle, at cs.window_rows) and the
# paired launch (row pairs over the rectangle at cs.paired_rows, the bands
# kept between a step's passes; other neighbourhoods the rounded f32 walk),
# each output filled with NaN first. Geometries as K1's: the rectangle
# across the tiles, block columns of 200, an odd rectangle.

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,k", [(torch.float32, 1), (torch.float32, 2),
                                     (torch.float32, 3), (torch.float32, 8),
                                     (torch.bfloat16, 2),
                                     (torch.bfloat16, 16)])
@pytest.mark.parametrize("offs", [MOORE_OFFSETS, VON_NEUMANN_OFFSETS, CUSTOM])
@pytest.mark.parametrize("geometry", sorted(_K1_BF16_GEOMETRIES))
def test_bf16_interior_k3_vpu_two_launches_on_the_card(dtype, k, offs,
                                                       geometry):
    """Every cell written once (NaN-filled output), bit for bit
    ``composed_dense_step_plain(..., "vpu", compute_dtype=bfloat16)``,
    counted as one launch."""
    dev = _card()
    shape, block = _K1_BF16_GEOMETRIES[geometry]
    if k > cs.max_k(shape, dtype, block):
        pytest.skip("k past the window's ghost depth")
    x = torch.from_numpy(np.random.default_rng(k).uniform(
        0.5, 2.0, shape)).to(dev, dtype)
    out = torch.full_like(x, float("nan"))
    before = cs.launches("vpu")
    cs.composed_dense_step(x, 0.13, k, offs, block=block, variant="vpu",
                           compute_dtype=_BF, out=out)
    assert cs.launches("vpu") == before + 1
    assert torch.equal(out, cs.composed_dense_step_plain(
        x, 0.13, k, offs, "vpu", _BF, block))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,k", [(torch.float32, 2), (torch.float32, 8),
                                     (torch.bfloat16, 16)])
@pytest.mark.parametrize("offs", [MOORE_OFFSETS, CUSTOM])
@pytest.mark.parametrize("values", ["zeros_subnormals", "inf"])
@pytest.mark.parametrize("geometry", ["cut", "odd_rect"])
def test_bf16_interior_k3_vpu_special_values_on_the_card(dtype, k, offs,
                                                         values, geometry):
    """Windows holding +-0 and bf16 subnormals, and +-inf: bit for bit the
    plain version, NaN by position."""
    dev = _card()
    shape, block = _K1_BF16_GEOMETRIES[geometry]
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        0.5, 2.0, shape)).to(dev, dtype)
    x = _with_specials({"v": x}, 13)["v"]
    if values == "zeros_subnormals":
        x = torch.where(torch.isinf(x), torch.ones_like(x), x)
    out = torch.full_like(x, float("nan"))
    cs.composed_dense_step(x, 0.13, k, offs, block=block, variant="vpu",
                           compute_dtype=_BF, out=out)
    _held_nan_by_position(out, cs.composed_dense_step_plain(
        x, 0.13, k, offs, "vpu", _BF, block))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,k", [(torch.float32, 2), (torch.float32, 8),
                                     (torch.bfloat16, 16)])
@pytest.mark.parametrize("offs", [MOORE_OFFSETS, CUSTOM])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1), (4, 4)])
def test_bf16_interior_k3_vpu_halo_mosaic_on_the_card(dtype, k, offs,
                                                      mesh_shape):
    """K3-halo vpu bf16-interior on the 2x2, 4-stripe and 4x4 meshes of
    (1024, 2048), at one block for the grid and its shards (on 4x4 the
    inner shards lie wholly in the rectangle: no near launch): every
    shard's NaN-filled output bit for bit its plain version, and the shards
    put together bit for bit K3 on the whole grid."""
    from mpi_model_tpu_torch.parallel import assemble, exchange_ring

    dev = _card()
    shape, block = (1024, 2048), (64, 128)
    mesh, full, g, (h, w) = _shards(dev, dtype, shape, mesh_shape, 59)
    g = g["value"]
    lines, columns = mesh_shape
    out = [[None] * columns for _ in range(lines)]
    before = cs.halo_launches("vpu")
    for i in range(lines):
        for j in range(columns):
            ring = exchange_ring(g, i, j, k)
            o = torch.full_like(g[i][j], float("nan"))
            cs.composed_halo_step(g[i][j], ring, (i * h, j * w), shape, 0.13,
                                  k, offs, block, "vpu", _BF, out=o)
            assert torch.equal(o, cs.composed_halo_step_plain(
                g[i][j], ring, (i * h, j * w), shape, 0.13, k, offs, "vpu",
                _BF, block)), (i, j)
            out[i][j] = o
    assert cs.halo_launches("vpu") == before + lines * columns
    assert torch.equal(assemble(out, dev), cs.composed_dense_step(
        full["value"], 0.13, k, offs, block, "vpu", _BF))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offs", [MOORE_OFFSETS, CUSTOM])
@pytest.mark.parametrize("geometry", sorted(_K1_PLAN_GEOMETRIES))
def test_bf16_interior_k3_vpu_plan_is_the_library_s(dtype, offs, geometry):
    """``window_rows``, ``paired_rows``, ``bf16_regions`` and
    ``region_tiles`` (``cs.plan_of``: the CPU tests' and ``chip_smoke.py``'s
    view of the two launches) are the source's own geometry, read through
    ``cs.kernel_plan``: on every shard at every k."""
    _card()
    gshape, block, (lines, columns) = _K1_PLAN_GEOMETRIES[geometry]
    h, w = gshape[0] // lines, gshape[1] // columns
    for k in range(1, cs.max_k((h, w), dtype, block) + 1):
        for i in range(lines):
            for j in range(columns):
                org = (i * h, j * w)
                rect = fs.kernel_rect((h, w), dtype, block, k, _BF, org,
                                      gshape)
                assert cs.kernel_plan((h, w), rect, k, dtype, offs, org,
                                      gshape) == cs.plan_of(
                    (h, w), rect, k, offs, org), (k, org)


@pytest.mark.cuda
@pytest.mark.parametrize("halo", [False, True])
def test_bf16_interior_k3_vpu_launch_error_raises(monkeypatch, halo):
    """No fallback: with no coefficients in the bf16 slot the call is
    refused before either launch; the error names the kernels, their rows
    and k; nothing is counted and nothing is written."""
    from mpi_model_tpu_torch.parallel import exchange_ring

    dev = _card()
    form_args = cs._form_args

    def no_coefs16(*args, **kwargs):
        return form_args(*args, **kwargs)[:-1] + (None,)

    monkeypatch.setattr(cs, "_form_args", no_coefs16)
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        0.5, 2.0, (512, 1024))).to(dev, torch.float32)
    out = torch.full((256, 512) if halo else (512, 1024), float("nan"),
                     device=dev)
    before = (cs.launches(), cs.halo_launches())
    what = (r"vpu .*kernel \(f32, k=8, bf16 interior math: near launch "
            r"composed_vpu_.*near_kernel 48 rows OFF 8, paired launch "
            r"composed_vpu16_.*kernel \d+ rows OFF 8\)")
    with pytest.raises(RuntimeError, match=what):
        if halo:
            g = [[x[i * 256:(i + 1) * 256, j * 512:(j + 1) * 512].contiguous()
                  for j in range(2)] for i in range(2)]
            cs.composed_halo_step(g[1][0], exchange_ring(g, 1, 0, 8),
                                  (256, 0), (512, 1024), 0.13, 8,
                                  block=(64, 256), variant="vpu",
                                  compute_dtype=_BF, out=out)
        else:
            cs.composed_dense_step(x, 0.13, 8, block=(64, 256),
                                   variant="vpu", compute_dtype=_BF, out=out)
    torch.cuda.synchronize()
    assert (cs.launches(), cs.halo_launches()) == before
    assert bool(torch.isnan(out).all())


# K3/K3-halo mxu bf16-interior: the persistent tile walk. Cases: k 1, 3,
# 8 (and 16 at bf16 storage); Moore and a non-Moore neighbourhood; a grid
# of many tiles (19 x 17 f32 tiles, 10 x 17 bf16: no multiple of a
# persistent grid of one or two blocks an SM on 132 SMs); a rectangle whose
# row edges cut the kernel's tiles (JAX blocks of 48 and 50 rows); shards
# at an origin off the tiles (row 150: a partial first tile); windows of
# uniform values, of +-0 and bf16 subnormals, and of +-inf.

_K3_GEOMETRIES = {"many_tiles": ((1216, 2176), (64, 128)),
                  "straddling": ((336, 1024), (48, 256))}


def _k3_values(dev, dtype, shape, seed, values):
    """Uniform values; ``special``: cells of +0, -0 and bf16 subnormals
    among them; ``inf``: those and cells of +-inf."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0.5, 2.0, shape)).to(dev, dtype)
    if values != "uniform":
        specials = (0.0, -0.0, 2.0 ** -130, -(2.0 ** -128), 2.0 ** -133)
        if values == "inf":
            specials += (float("inf"), float("-inf"))
        flat = x.view(-1)
        for i, c in enumerate(rng.choice(flat.numel(), 6 * len(specials),
                                         replace=False)):
            flat[int(c)] = specials[i % len(specials)]
    return x


def _held_with_inf(got, want, k):
    """Where the plain version is not finite the kernel is not either (a
    product with an infinite cell, or 0 x inf, reaches it); elsewhere the
    kernel's finite cells are held as ``_held_to_plain`` holds them. The
    tensor cores also multiply an infinite cell by the zeros off the tap
    band, so the kernel's non-finite cells may spread past the plain
    version's, within 16 columns."""
    fin = torch.isfinite(want)
    assert not torch.isfinite(got[~fin]).any()
    both = fin & torch.isfinite(got)
    g32, w32 = got.float()[both], want.float()[both]
    tol = (1e-6 * k * float(w32.abs().max())
           if got.dtype == torch.float32 else 2.0 ** -6)
    assert float((g32 - w32).abs().max()) <= tol


def _outside_rect(shape, dtype, block, k):
    r0, r1, c0, c1 = fs.kernel_rect(shape, dtype,
                                    fs.resolve_block(shape, dtype, block), k,
                                    _BF)
    rows = torch.arange(shape[0])[:, None]
    cols = torch.arange(shape[1])[None, :]
    return ~((rows >= r0) & (rows < r1) & (cols >= c0) & (cols < c1))


@pytest.mark.cuda
@pytest.mark.parametrize("values", ["uniform", "special", "inf"])
@pytest.mark.parametrize("geometry", sorted(_K3_GEOMETRIES))
@pytest.mark.parametrize("hood", ["moore", "custom"])
@pytest.mark.parametrize("dtype,k", [(torch.float32, 1), (torch.float32, 3),
                                     (torch.float32, 8), (torch.bfloat16, 1),
                                     (torch.bfloat16, 3), (torch.bfloat16, 8),
                                     (torch.bfloat16, 16)])
def test_bf16_interior_k3_mxu_walk_on_the_card(dtype, k, hood, geometry,
                                               values):
    """The mxu bf16-interior kernel against its plain version (uniform and
    special values within the form's tolerance; +-inf by position,
    ``_held_with_inf``), one launch counted; and its cells outside the
    bf16 rectangle bit for bit the f32-compute kernel run over the grid
    rounded to bf16 (the f32 pass without the window's zero low term) on
    finite values."""
    dev = _card()
    shape, block = _K3_GEOMETRIES[geometry]
    offs = MOORE_OFFSETS if hood == "moore" else CUSTOM
    x = _k3_values(dev, dtype, shape, 5 + k, values)
    before = cs.launches("mxu")
    got = cs.composed_dense_step(x, 0.13, k, offs, block=block,
                                 variant="mxu", compute_dtype=_BF)
    assert cs.launches("mxu") == before + 1
    want = cs.composed_dense_step_plain(x, 0.13, k, offs, "mxu", _BF, block)
    if values == "inf":
        _held_with_inf(got, want, k)
        return
    _held_to_plain(got, want, "mxu", k)
    f32 = cs.composed_dense_step(x.to(_BF).to(dtype), 0.13, k, offs,
                                 block=block, variant="mxu")
    out = _outside_rect(shape, dtype, block, k).to(dev)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got[out].view(bits), f32[out].view(bits))


@pytest.mark.cuda
@pytest.mark.parametrize("values", ["uniform", "special"])
@pytest.mark.parametrize("hood", ["moore", "custom"])
@pytest.mark.parametrize("dtype,k", [(torch.float32, 3), (torch.float32, 8),
                                     (torch.bfloat16, 3),
                                     (torch.bfloat16, 16)])
@pytest.mark.parametrize("mesh_shape,shape,block", [
    ((2, 2), (1024, 2048), (64, 256)), ((2, 3), (300, 768), (50, 256))])
def test_bf16_interior_k3_mxu_halo_mosaic_on_the_card(dtype, k, hood,
                                                      mesh_shape, shape,
                                                      block, values):
    """K3-halo mxu bf16-interior on every shard (on 300 x 768 the second
    row of shards starts at row 150, off the kernel's tiles) against its
    plain version, and the shards put together bit for bit the whole-grid
    K3 at the same JAX blocks."""
    from mpi_model_tpu_torch.parallel import exchange_ring

    dev = _card()
    offs = MOORE_OFFSETS if hood == "moore" else CUSTOM
    full = _k3_values(dev, dtype, shape, 31 + k, values)
    lines, columns = mesh_shape
    h, w = shape[0] // lines, shape[1] // columns
    g = [[full[i * h:(i + 1) * h, j * w:(j + 1) * w].contiguous()
          for j in range(columns)] for i in range(lines)]
    whole = cs.composed_dense_step(full, 0.13, k, offs, block=block,
                                   variant="mxu", compute_dtype=_BF)
    mosaic = torch.empty_like(full)
    before = cs.halo_launches("mxu")
    for i in range(lines):
        for j in range(columns):
            ring = exchange_ring(g, i, j, k)
            got = cs.composed_halo_step(g[i][j], ring, (i * h, j * w), shape,
                                        0.13, k, offs, block, "mxu", _BF)
            want = cs.composed_halo_step_plain(
                g[i][j], ring, (i * h, j * w), shape, 0.13, k, offs, "mxu",
                _BF, block)
            _held_to_plain(got, want, "mxu", k)
            mosaic[i * h:(i + 1) * h, j * w:(j + 1) * w] = got
    assert cs.halo_launches("mxu") == before + lines * columns
    assert torch.equal(mosaic, whole)


@pytest.mark.cuda
@pytest.mark.parametrize("halo", [False, True])
def test_bf16_interior_k3_mxu_launch_error_raises(monkeypatch, halo):
    """No fallback: with no table in the bf16 slot the launch is refused and
    raises naming the form, dtype and k; nothing is counted and nothing is
    written in its place."""
    from mpi_model_tpu_torch.parallel import exchange_ring

    dev = _card()
    form_args = cs._form_args

    def no_table16(*args, **kwargs):
        return form_args(*args, **kwargs)[:-1] + (None,)

    monkeypatch.setattr(cs, "_form_args", no_table16)
    x = _k3_values(dev, torch.float32, (512, 1024), 3, "uniform")
    out = torch.full((256, 512) if halo else (512, 1024), float("nan"),
                     device=dev)
    before = (cs.launches(), cs.halo_launches())
    with pytest.raises(RuntimeError, match=r"mxu .*f32, k=8, bf16 interior"):
        if halo:
            g = [[x[i * 256:(i + 1) * 256, j * 512:(j + 1) * 512].contiguous()
                  for j in range(2)] for i in range(2)]
            cs.composed_halo_step(g[1][0], exchange_ring(g, 1, 0, 8),
                                  (256, 0), (512, 1024), 0.13, 8,
                                  block=(64, 256), variant="mxu",
                                  compute_dtype=_BF, out=out)
        else:
            cs.composed_dense_step(x, 0.13, 8, block=(64, 256),
                                   variant="mxu", compute_dtype=_BF, out=out)
    torch.cuda.synchronize()
    assert (cs.launches(), cs.halo_launches()) == before
    assert bool(torch.isnan(out).all())


#: a six-offset neighbourhood (hexagonal; its count is no power of two)
_SIX = ((-1, -1), (-1, 0), (0, -1), (0, 1), (1, 0), (1, 1))
_K4_HOODS = {"moore": MOORE_OFFSETS, "six": _SIX}


@pytest.fixture(scope="module")
def _k4_bf16_units():
    """Build the bf16-compute units of every flow set and neighbourhood the
    K4 bf16-interior tests run, one nvcc each, all at once."""
    from mpi_model_tpu_torch.ops import _build

    _card()
    units = {k4.plan_field(fl, ("a", "b", "c"), (64, 128), torch.float32, 1,
                           offsets=offs, compute_dtype=_BF).unit.text: name
             for name, fl in _FLOW_SETS.items()
             for offs in _K4_HOODS.values()}
    _build.build_all(units=tuple((t, n) for t, n in units.items()))


def _with_specials(vals, seed):
    """Cells of each channel set to +0, -0, bf16 subnormals and +-inf."""
    rng = np.random.default_rng(seed)
    specials = (0.0, -0.0, 2.0 ** -130, -(2.0 ** -128), 2.0 ** -133,
                float("inf"), float("-inf"))
    for t in vals.values():
        flat = t.view(-1)
        for i, x in enumerate(rng.choice(flat.numel(), 4 * len(specials),
                                         replace=False)):
            flat[int(x)] = specials[i % len(specials)]
    return vals


def _held_bf16_interior(got, want):
    """Bit for bit, NaN compared by position (exp too: the kernel's
    ``expf`` and torch's on the card agree)."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got[~nan].view(bits), want[~nan].view(bits))


@pytest.mark.cuda
@pytest.mark.parametrize("values", ["uniform", "special"])
@pytest.mark.parametrize("hood", sorted(_K4_HOODS))
@pytest.mark.parametrize("dtype,ns", [(torch.float32, 1), (torch.float32, 8),
                                      (torch.bfloat16, 1),
                                      (torch.bfloat16, 16)])
@pytest.mark.parametrize("flows", sorted(_FLOW_SETS))
@pytest.mark.parametrize("shape,block", [((512, 1024), (64, 128)),
                                         ((256, 512), None),
                                         ((225, 640), (45, 128))])
def test_bf16_interior_k4_on_the_card(dtype, ns, flows, shape, block, hood,
                                      values, _k4_bf16_units):
    """K4 bf16-interior (the paired walk) against ``field_step_plain(...,
    compute_dtype)`` bit for bit (the bf16 program, the bf16 transport, f32
    near tiles), on uniform values and on values holding +-0, bf16
    subnormals and +-inf; (225, 640) at block (45, 128) has an odd number
    of rows in the bf16 rectangle, starting at an odd row."""
    dev = _card()
    fl = _FLOW_SETS[flows]
    offs = _K4_HOODS[hood]
    ns = min(ns, fs.ghost_depth(shape, dtype, block))
    vals = _field_values(dev, dtype, shape, 17)
    if values == "special":
        vals = _with_specials(vals, 5)
    step = k4.PallasFieldStep(shape, fl, offsets=offs, block=block,
                              nsteps=ns, compute_dtype=_BF)
    got = step(vals)
    assert step.launches == 1
    want = k4.field_step_plain(vals, fl, offs, nsteps=ns, compute_dtype=_BF,
                               block=block)
    for n in {f.attr for f in fl}:
        _held_bf16_interior(got[n], want[n])


@pytest.mark.cuda
def test_bf16_interior_k4_broken_paired_unit_raises(_k4_bf16_units):
    """No fallback: a paired unit that does not build raises naming the
    flow set, and nothing is launched in its place."""
    dev = _card()
    fl = _FLOW_SETS["config4"]
    step = k4.PallasFieldStep((512, 1024), fl, block=(64, 128), nsteps=8,
                              compute_dtype=_BF)
    vals = _field_values(dev, torch.float32, (512, 1024), 3)
    key = (tuple(vals), torch.float32)
    plan = step.plan(*key)
    text = plan.unit.text.replace("mm::mul_bf2(", "mm::mul_bf2_missing(")
    assert text != plan.unit.text
    step._plans[key] = dataclasses.replace(
        plan, unit=dataclasses.replace(plan.unit, text=text))
    before = k4.launches()
    with pytest.raises(RuntimeError, match="Diffusion"):
        step(vals)
    assert k4.launches() == before and step.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("hood", sorted(_K4_HOODS))
@pytest.mark.parametrize("flows", sorted(_FLOW_SETS))
@pytest.mark.parametrize("dtype,ns", [(torch.float32, 1), (torch.float32, 8),
                                      (torch.bfloat16, 16)])
@pytest.mark.parametrize("mesh_shape,shape", [((2, 2), (1024, 2048)),
                                              ((1, 4), (128, 512))])
def test_bf16_interior_k4_halo_on_the_card(dtype, ns, mesh_shape, shape,
                                           flows, hood, _k4_bf16_units):
    from mpi_model_tpu_torch.parallel import exchange_ring

    dev = _card()
    fl = _FLOW_SETS[flows]
    offs = _K4_HOODS[hood]
    names = ("a", "b", "c")
    mesh, full, g, (h, w) = _shards(dev, dtype, shape, mesh_shape, 53,
                                    names)
    if flows in ("affine", "every_op"):
        _with_specials(full, 9)
        g = {n: [[full[n][i * h:(i + 1) * h, j * w:(j + 1) * w].contiguous()
                  for j in range(mesh_shape[1])]
                 for i in range(mesh_shape[0])] for n in names}
    step = k4.PallasFieldStep((h, w), fl, offsets=offs, nsteps=ns,
                              compute_dtype=_BF)
    lines, columns = mesh_shape
    for i in range(lines):
        for j in range(columns):
            vals = {n: g[n][i][j] for n in names}
            rings = {n: exchange_ring(g[n], i, j, ns) for n in names}
            got = step.halo(vals, rings, (i * h, j * w), shape)
            want = k4.field_halo_step_plain(vals, rings, (i * h, j * w),
                                            shape, fl, offs, nsteps=ns,
                                            compute_dtype=_BF)
            for n in {f.attr for f in fl}:
                _held_bf16_interior(got[n], want[n])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ns", [1, 4, 8])
@pytest.mark.parametrize("offs", [MOORE_OFFSETS, VON_NEUMANN_OFFSETS, CUSTOM])
@pytest.mark.parametrize("B,shape,block", [(2, (1024, 1024), (128, 256)),
                                           (3, (256, 4096), None)])
def test_bf16_interior_k5_on_the_card(dtype, ns, offs, B, shape, block):
    """K5 bf16-interior against ``pipeline_step_plain(..., compute_dtype)``;
    on 256 x 4096 (JAX's blocks: no closed tile) the f32 result."""
    dev = _card()
    x = torch.from_numpy(np.random.default_rng(11).uniform(
        0.5, 2.0, (B,) + shape)).to(dev, dtype)
    got = ps.pipeline_dense_step(x, 0.13, offs, block, ns,
                                 compute_dtype=_BF)
    assert torch.equal(got, ps.pipeline_step_plain(x, 0.13, offs, ns, block,
                                                   _BF))
    if not bool(ps.interior_mask(shape, ps.pipeline_block(shape, ns, block),
                                 ns).any()):
        assert torch.equal(got, ps.pipeline_dense_step(x, 0.13, offs, block,
                                                       ns))


# -- K5's bf16 interior math as two launches; K7's lane walk -------------------

#: (lanes, grid, block) of K5's two-launch cases: the main path's two
#: batches at JAX's blocks (4 x 8192²: closed tiles in every lane; 8 x
#: 4096²: none), a cut grid with a caller's block, an odd one (1152-wide
#: TPU tiles the windows do not divide, 48-row tiles), and one whose
#: rectangle is a single TPU tile
_K5_GEOMETRIES = {"main_8192": (4, (8192, 8192), None),
                  "main_4096": (8, (4096, 4096), None),
                  "cut": (2, (1024, 1024), (128, 256)),
                  "odd": (3, (240, 3456), (48, 1152)),
                  "one_tile": (1, (48, 384), (16, 128))}


def _traced_kernels(fn):
    """The device kernels ``fn()`` launched, by name with their counts,
    from a ``torch.profiler`` trace (the work between two spins of the
    device, the trace held open past it, as ``chip_smoke.traced_kernels``
    does: without the host's pauses the profiler on the H100 dropped these
    kernels from the trace)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)  # analysis: ignore[wall-clock-in-test] — the profiler's host window
        torch.cuda._sleep(100_000_000)
        fn()
        torch.cuda._sleep(100_000_000)
        torch.cuda.synchronize()
        time.sleep(0.05)  # analysis: ignore[wall-clock-in-test] — the profiler's host window
    names = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            names[e.name] = names.get(e.name, 0) + 1
    return names


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ns", [1, 2, 3, 8])
@pytest.mark.parametrize("geometry", sorted(_K5_GEOMETRIES))
def test_bf16_interior_k5_two_launches_on_the_card(dtype, ns, geometry):
    """K5's bf16-interior Moore call: every output cell written (NaN-filled
    output), bit for bit ``pipeline_step_plain(..., compute_dtype)``,
    counted as one launch; the input untouched."""
    dev = _card()
    B, shape, block = _K5_GEOMETRIES[geometry]
    x = torch.from_numpy(np.random.default_rng(ns).uniform(
        0.5, 2.0, (B,) + shape).astype(np.float32)).to(dev, dtype)
    keep = x.clone()
    out = torch.full_like(x, float("nan"))
    before = ps.launches()
    ps.pipeline_dense_step(x, 0.13, MOORE_OFFSETS, block, ns, out=out,
                           compute_dtype=_BF)
    assert ps.launches() == before + 1
    want = ps.pipeline_step_plain(x, 0.13, MOORE_OFFSETS, ns, block, _BF)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(out.view(bits), want.view(bits))
    assert torch.equal(x, keep)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", sorted(_K5_GEOMETRIES))
def test_bf16_interior_k5_plan_is_the_library_s(geometry):
    """The wrapper's mirrors (``ps.plan_of``: the near launch's windows of
    the near TPU tiles, the paired launch's tiles of the rectangle) are the
    source's geometry (``mm_pipeline_plan``), for both computes, every
    depth and three neighbourhoods."""
    _card()
    _, shape, block = _K5_GEOMETRIES[geometry]
    for ns in range(1, ps.MAX_STEPS + 1):
        blk = ps.pipeline_block(shape, ns, block)
        for offs in (MOORE_OFFSETS, tuple(reversed(MOORE_OFFSETS)), CUSTOM):
            for cd in (None, _BF):
                assert ps.kernel_plan(shape, blk, ns, offs, cd) == \
                    ps.plan_of(shape, blk, ns, offs, cd), (ns, offs, cd)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", ["main_8192", "main_4096", "cut"])
def test_bf16_interior_k5_launches_traced_on_the_card(geometry):
    """The kernels a call runs, from a profiler trace: with closed tiles
    the near launch and the paired launch once each, without them the near
    launch alone; no kernel with both branches (``pipeline_stencil_kernel``)
    runs. The f32-compute call runs that kernel alone."""
    dev = _card()
    B, shape, block = _K5_GEOMETRIES[geometry]
    x = torch.ones((B,) + shape, device=dev)
    names = _traced_kernels(lambda: ps.pipeline_dense_step(
        x, 0.13, MOORE_OFFSETS, block, 8, compute_dtype=_BF))
    k5 = {n: c for n, c in names.items() if "pipeline_" in n}
    near = sum(c for n, c in k5.items() if "pipeline_near_kernel" in n)
    paired = sum(c for n, c in k5.items() if "pipeline_bf16_kernel" in n)
    closed = bool(ps.interior_mask(shape, ps.pipeline_block(shape, 8, block),
                                   8).any())
    assert near == 1 and paired == (1 if closed else 0), k5
    assert sum(k5.values()) == near + paired, k5
    names = _traced_kernels(lambda: ps.pipeline_dense_step(
        x, 0.13, MOORE_OFFSETS, block, 8))
    k5 = {n: c for n, c in names.items() if "pipeline_" in n}
    assert sum(k5.values()) == 1 and all(
        "pipeline_stencil_kernel" in n for n in k5), k5


def _k7_case(dev, itemsize, count, ring, tile, grid_tiles, seed):
    """A NaN-filled ring-``ring`` padded state (or, for 2-byte and 8-byte
    elements, bf16 and f64 NaN), an update buffer of random values, and
    ``count`` live lanes over distinct random tiles."""
    dtype = {2: torch.bfloat16, 4: torch.float32, 8: torch.float64}[itemsize]
    (th, tw), (gi, gj) = tile, grid_tiles
    rng = np.random.default_rng(seed)
    plan = act.plan_for((gi * th, gj * tw), tile=tile, max_active_frac=1.0)
    K = plan.capacity
    padded = torch.full((gi * th + 2 * ring, gj * tw + 2 * ring),
                        float("nan"), dtype=dtype, device=dev)
    upd = torch.from_numpy(rng.uniform(-2.0, 2.0, (K, th, tw))).to(dev,
                                                                   dtype)
    ids = torch.from_numpy(rng.permutation(gi * gj)[:K].astype(np.int32)).to(
        dev)
    cnt1 = torch.tensor([count], dtype=torch.int32, device=dev)
    return padded, upd, ids, cnt1, plan


@pytest.mark.cuda
@pytest.mark.parametrize("itemsize", [2, 4, 8])
@pytest.mark.parametrize("ring", [1, 3, 8])
@pytest.mark.parametrize("count", ["zero", "one", "some", "all"])
@pytest.mark.parametrize("tile,grid_tiles", [((128, 128), (8, 16)),
                                             ((40, 24), (5, 7)),
                                             ((16, 13), (6, 5))])
def test_k7_lane_walk_bitwise_on_the_card(itemsize, ring, count, tile,
                                          grid_tiles):
    """K7 bit for bit ``fused_scatter_plain`` at count 0 (one lane, as
    ``clip(count, 1, K)`` gives it), 1, some and K, on a state whose
    untouched cells hold NaN (and stay NaN: compared by their bits), at
    rings whose columns start off every 16-byte boundary, on tiles whose
    rows are whole 16-byte chunks (128, 24 at 2, 4 and 8 bytes) and one
    whose rows are not (13 columns)."""
    dev = _card()
    gi, gj = grid_tiles
    K = gi * gj
    n = {"zero": 0, "one": 1, "some": K // 3, "all": K}[count]
    padded, upd, ids, cnt1, plan = _k7_case(dev, itemsize, n, ring, tile,
                                            grid_tiles, 7 * ring + n)
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[itemsize]
    before = fa.launches("fused_scatter")
    got = fa.fused_scatter(padded.clone(), upd, ids, cnt1, plan=plan,
                           ring=ring)
    assert fa.launches("fused_scatter") == before + 1
    want = fa.fused_scatter_plain(padded.clone(), upd, ids, n, plan, ring)
    assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.cuda
def test_k7_grid_is_the_library_s():
    """K7's persistent grid (``fa.scatter_blocks``) is the source's."""
    _card()
    lib = fa._kernel_lib()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for K in (1, 7, 2 * sms - 1, 2 * sms, 4096, 65536):
        assert lib.mm_fused_scatter_blocks(K) == fa.scatter_blocks(K, sms)


# -- checkpoints, supervision and migration on the card -----------------------------

def _blob(dev, side, frac, dtype=torch.float32, seed=0):
    v = np.zeros((side, side), np.float32)
    s = max(1, int(round(side * frac ** 0.5)))
    r0 = (side - s) // 2
    v[r0:r0 + s, r0:r0 + s] = np.random.default_rng(seed).uniform(
        0.5, 2.0, (s, s))
    return mt.CellularSpace({"value": torch.from_numpy(v).to(dev, dtype)},
                            side, side)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["full", "delta"])
def test_checkpoint_round_trip_of_a_card_bf16_channel(tmp_path, layout):
    """A card-resident bf16 channel (beside an f32 one) through a save and a
    restore onto the card, and onto the CPU: the same bits."""
    from mpi_model_tpu_torch.io import CheckpointManager

    dev = _card()
    rng = np.random.default_rng(3)
    sp = mt.CellularSpace({
        "value": torch.from_numpy(rng.uniform(0.5, 2.0, (256, 384))).to(
            dev, torch.bfloat16),
        "aux": torch.from_numpy(rng.uniform(-1, 1, (256, 384))).to(
            dev, torch.float32)}, 256, 384)
    mgr = CheckpointManager(str(tmp_path), layout=layout, delta_tile=(64, 64))
    mgr.save(sp, 4)
    later = sp.with_values({**sp.values,
                            "value": sp.values["value"].clone()})
    later.values["value"][100, 200] += 1.0
    mgr.save(later, 8)
    if layout == "delta":
        assert mgr.last_save["kind"] == "delta"
        assert mgr.last_save["dirty_tiles"] == 1
    for step, want in ((4, sp), (8, later)):
        got = mgr.restore(step)
        for k, t in want.values.items():
            g = got.space.values[k]
            assert g.device.type == "cuda" and g.dtype == t.dtype
            assert torch.equal(g.view(torch.uint8), t.view(torch.uint8))
        host = mgr.restore(step, device="cpu").space.values["value"]
        assert torch.equal(host, want.values["value"].cpu())


@pytest.mark.cuda
def test_supervised_k1_recovers_exc_and_nan_bit_for_bit(tmp_path):
    """K1 (substeps 4) under the supervisor with an executor exception and a
    NaN chunk armed, checkpointed: bit for bit the uninterrupted run, K1
    launches only for the chunks that ran, one health-check transfer per
    checked chunk."""
    from mpi_model_tpu_torch.io import CheckpointManager
    from mpi_model_tpu_torch.resilience import inject, supervised_run
    from mpi_model_tpu_torch.resilience import supervisor as sup
    from mpi_model_tpu_torch.resilience.inject import Fault, FaultPlan

    dev = _card()
    sp = mt.CellularSpace({"value": torch.from_numpy(
        np.random.default_rng(5).uniform(0.5, 2.0, (512, 768))).to(
        dev, torch.float32)}, 512, 768)
    model = mt.Model(mt.Diffusion(0.1), 32.0, 1.0)
    want, _ = model.execute(sp, mt.SerialExecutor("pallas", substeps=4),
                            steps=32)
    plan = FaultPlan((Fault("exc", at=1), Fault("nan", at=2, cell=(7, 9))))
    before, syncs = fs.launches(), sup.health_syncs()
    with inject.armed(plan) as st:
        res = supervised_run(model, sp, CheckpointManager(str(tmp_path)),
                             steps=32, every=8,
                             executor=mt.SerialExecutor("pallas",
                                                        substeps=4))
    assert [f["kind"] for f in st.fired] == ["exc", "nan"]
    assert [e.kind for e in res.events] == ["exception", "nonfinite"]
    assert torch.equal(res.space.values["value"], want.values["value"])
    # 4 good chunks + the poisoned one ran, 2 launches each; the exc chunk
    # raised before any launch
    assert fs.launches() - before == 5 * 2
    assert sup.health_syncs() - syncs == 5


@pytest.mark.cuda
def test_sharded_k2_halo_fault_detected_and_rolled_back():
    """K2 at depth 4 on a 2×2 mesh of the one card, a halo fault armed on
    chunk 1: detected as conservation drift, and the result is the
    unperturbed sharded run bit for bit."""
    from mpi_model_tpu_torch.parallel import ShardMapExecutor, make_mesh_2d
    from mpi_model_tpu_torch.resilience import inject, supervised_run
    from mpi_model_tpu_torch.resilience.inject import Fault, FaultPlan

    dev = _card()
    sp = _blob(dev, 512, 0.05)
    model = mt.Model(mt.Diffusion(0.1), 16.0, 1.0)

    def ex():
        return ShardMapExecutor(make_mesh_2d(2, 2, devices=[dev] * 4),
                                "pallas", halo_depth=4)

    want, _ = model.execute(sp, ex(), steps=16)
    with inject.armed(FaultPlan((Fault("halo", at=1),), seed=3)) as st:
        res = supervised_run(model, sp, steps=16, every=4, executor=ex())
    assert [f["kind"] for f in st.fired] == ["halo"]
    assert [e.kind for e in res.events] == ["conservation"]
    assert torch.equal(res.space.values["value"], want.values["value"])


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["pallas", "active_fused", "sharded"])
def test_unarmed_seams_leave_launch_counts_unchanged(impl):
    """A plan armed for other seams (and none) changes neither the result
    nor any kernel's launch count."""
    from mpi_model_tpu_torch.models.model import kernel_launches
    from mpi_model_tpu_torch.parallel import ShardMapExecutor, make_mesh_2d
    from mpi_model_tpu_torch.resilience import inject
    from mpi_model_tpu_torch.resilience.inject import Fault, FaultPlan

    dev = _card()
    sp = _blob(dev, 512, 0.05)
    model = mt.Model(mt.Diffusion(0.1), 8.0, 1.0)

    def ex():
        if impl == "sharded":
            return ShardMapExecutor(make_mesh_2d(2, 2, devices=[dev] * 4),
                                    "pallas", halo_depth=4)
        return mt.SerialExecutor(impl, substeps=4)

    def run():
        before = kernel_launches()
        out, _ = model.execute(sp, ex(), steps=8)
        return out.values["value"], {k: v - before[k]
                                     for k, v in kernel_launches().items()}

    want, clean = run()
    assert sum(clean.values()) > 0
    plan = FaultPlan((Fault("torn", at=0), Fault("lane_nan", lane=2),
                      Fault("exc", at=99), Fault("halo", at=99)))
    with inject.armed(plan) as st:
        got, armed = run()
    assert st.fired == [] and armed == clean
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_delta_chain_takes_k6_k7_dirty_tiles(tmp_path):
    """``active_fused`` k=4 (K6 + K7) under ``run_checkpointed`` with the
    delta layout: every delta record's tiles come from the executor's
    export, and every step restores bit for bit the full layout's."""
    from mpi_model_tpu_torch.io import CheckpointManager, run_checkpointed

    dev = _card()
    sp = _blob(dev, 1024, 0.01)
    model = mt.Model(mt.Diffusion(0.1), 16.0, 1.0)
    full = CheckpointManager(str(tmp_path / "full"), keep=100)
    delta = CheckpointManager(str(tmp_path / "delta"), keep=100,
                              layout="delta", keyframe_every=8)
    sources = []
    for mgr in (full, delta):
        ex = mt.SerialExecutor("active_fused", substeps=4)
        run_checkpointed(model, sp, mgr, steps=16, every=4, executor=ex)
        if mgr is delta:
            sources.append(mgr.last_save["dirty_from"])
    assert sources == ["executor"]
    assert delta.steps() == full.steps() == [0, 4, 8, 12, 16]
    for s in full.steps():
        a = delta.restore(s).space.values["value"]
        b = full.restore(s).space.values["value"]
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_migrate_k1_to_k2_and_back_on_the_card():
    from mpi_model_tpu_torch.io import migrate_scenario
    from mpi_model_tpu_torch.parallel import ShardMapExecutor, make_mesh_2d

    dev = _card()
    sp = _blob(dev, 1024, 0.01)
    model = mt.Model(mt.Diffusion(0.1), 24.0, 1.0)
    serial = mt.SerialExecutor("pallas", substeps=4)
    sharded = ShardMapExecutor(make_mesh_2d(2, 2, devices=[dev] * 4),
                               "pallas", halo_depth=4)
    want, _ = model.execute(sp, serial, steps=24)
    for src, tgt in ((serial, sharded), (sharded, serial)):
        res = migrate_scenario(model, sp, source=src, target=tgt, steps=24,
                               handoff_at=8, transfer_steps=4)
        assert torch.equal(res.space.values["value"], want.values["value"])
        assert 0 < res.delta_bytes < res.keyframe_bytes


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gray_scott", "sir", "predator_prey"])
def test_ir_nonlinear_active_and_composed_match_xla_on_the_card(name):
    """A nonlinear IR model's ``active`` (the gathered windows) and
    ``composed`` (k = 1) runs on the card are its ``xla`` run on the card
    bit for bit; SIR's active run skips tiles."""
    import warnings

    from mpi_model_tpu_torch.ir import library

    dev = _card()
    base, space = library.MODELS[name](512, dtype="float32", device=dev)
    model = mt.FlowIRModel(base.ir_terms, base.time, base.time_step,
                           active_opts={"tile": (32, 32),
                                        "max_active_frac": 0.5})
    want, _ = model.execute(space, mt.SerialExecutor("xla"), steps=16)
    for impl, kw in (("active", {}), ("composed", {"substeps": 4})):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            got, rep = model.execute(space, mt.SerialExecutor(impl, **kw),
                                     steps=16)
        for k in want.values:
            assert torch.equal(got.values[k], want.values[k]), (impl, k)
        if impl == "active" and name == "sir":
            assert rep.backend_report["fallback_steps"] < 16
            assert rep.backend_report["mean_active_fraction"] < 0.5


@pytest.mark.cuda
def test_ir_linear_pallas_is_the_flow_model_on_the_card():
    """The linear IR diffusion through ``"pallas"`` is K1 on its flows
    view: bit for bit ``Model([Diffusion])``, with the same K1 launches."""
    from mpi_model_tpu_torch.models.model import kernel_launches

    dev = _card()
    ir_m, space = mt.build_model("diffusion", 512, dtype="float32",
                                 device=dev)
    flow_m = mt.Model(mt.Diffusion(0.1), ir_m.time, ir_m.time_step)
    runs = []
    for m in (ir_m, flow_m):
        before = kernel_launches()["fused_stencil"]
        out, rep = m.execute(space, mt.SerialExecutor("pallas", substeps=8),
                             steps=32)
        runs.append((out.values["value"],
                     kernel_launches()["fused_stencil"] - before, rep.impl))
    assert torch.equal(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1] == 4
    assert runs[0][2] == runs[1][2] == "pallas"


@pytest.mark.cuda
def test_ir_ensemble_lane_is_its_serial_card_run():
    """A nonlinear IR ensemble's lanes (per-lane rates) are each their
    serial ``xla`` run on the card bit for bit."""
    dev = _card()
    model, space = mt.build_model("gray_scott", 256, dtype="float32",
                                  device=dev)
    models = [model,
              model.with_rates([r * 1.05 for r in model.term_rates()])]
    res = model.execute_many([space, space], models=models, steps=8)
    for m, (sp, _) in zip(models, res):
        want, _ = m.execute(space, mt.SerialExecutor("xla"), steps=8)
        for k in want.values:
            assert torch.equal(sp.values[k], want.values[k]), k


def _k1_run(dev, tracer):
    """64 steps of ``Model(Diffusion(0.1))`` through K1 (substeps 8) on a
    512² f32 grid made from a numpy seed, under ``tracer``; the result, the
    report and the implicit host syncs counted by torch's sync debug
    mode."""
    import warnings

    from mpi_model_tpu_torch.utils import set_tracer

    v = np.random.default_rng(9).uniform(0.5, 2.0, (512, 512))
    space = mt.CellularSpace.create(512, 512, 1.0, dtype="float32",
                                    device=dev).with_values(
        {"value": torch.from_numpy(v).to(dev, torch.float32)})
    model = mt.Model(mt.Diffusion(0.1), 64.0, 1.0)
    ex = mt.SerialExecutor("pallas", substeps=8)
    model.execute(space, ex, steps=8)  # build and warm
    prev = set_tracer(tracer)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            out, rep = model.execute(space, ex, steps=64)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        set_tracer(prev)
    syncs = sum("synchroniz" in str(x.message) for x in w)
    return out, rep, syncs


@pytest.mark.cuda
def test_traced_k1_run_is_its_untraced_run_with_equal_syncs():
    """Spans add no host wait: the traced run is the untraced run bit for
    bit, with as many implicit syncs, and the spans nest as JAX's do."""
    from mpi_model_tpu_torch.utils import Tracer

    dev = _card()
    tr = Tracer()
    got, rep, syncs = _k1_run(dev, tr)
    want, _, syncs_off = _k1_run(dev, Tracer(enabled=False))
    assert torch.equal(got.values["value"], want.values["value"])
    assert syncs == syncs_off
    assert [s.name for s in tr.spans] == ["executor.run", "model.report",
                                          "model.execute"]
    assert rep.impl == "pallas"


@pytest.mark.cuda
def test_device_trace_captures_k1_launches(tmp_path):
    import json

    from mpi_model_tpu_torch.utils import Tracer

    dev = _card()
    x = torch.from_numpy(np.random.default_rng(4).uniform(
        0.5, 2.0, (1024, 1024))).to(dev, torch.float32)
    fs.pallas_dense_step(x, 0.1, MOORE_OFFSETS, nsteps=8)  # build
    torch.cuda.synchronize()
    tr = Tracer()
    before = fs.launches()
    with tr.device_trace(str(tmp_path)):
        torch.cuda._sleep(50_000_000)
        for _ in range(4):
            x = fs.pallas_dense_step(x, 0.1, MOORE_OFFSETS, nsteps=8)
        torch.cuda._sleep(50_000_000)
        torch.cuda.synchronize()
    launched = fs.launches() - before
    with open(tmp_path / "device_trace.pt.trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    k1 = [e for e in events if e.get("cat") == "kernel"
          and "fused_stencil" in e.get("name", "")]
    assert launched == 4 and len(k1) == launched
    assert [s.name for s in tr.spans] == ["device_trace"]


def _k1_kernels_in(path) -> int:
    import json

    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return sum(1 for e in events if e.get("cat") == "kernel"
               and "fused_stencil" in e.get("name", ""))


@pytest.mark.cuda
def test_device_trace_after_earlier_profiled_work_keeps_every_kernel(
        tmp_path):
    """``device_trace`` in a process that has profiled before (the drop
    seen in a long process): a 64-step K1 run, 8 launches, leaves all 8
    K1 kernels in the written Chrome file, counted in the file."""
    from torch.profiler import ProfilerActivity, profile

    from mpi_model_tpu_torch.utils import Tracer

    dev = _card()
    space = mt.CellularSpace.create(1024, 1024, 1.0, device=dev).with_values(
        {"value": torch.from_numpy(np.random.default_rng(5).uniform(
            0.5, 2.0, (1024, 1024))).to(dev, torch.float32)})
    model = mt.Model(mt.Diffusion(0.1))
    ex = mt.SerialExecutor("pallas", substeps=8)
    model.execute(space, ex, steps=64)  # build and warm
    for _ in range(3):  # earlier profiled work in this process
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.execute(space, ex, steps=64)
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(tmp_path / "earlier.json"))
    torch.cuda.synchronize()
    tr = Tracer()
    before = fs.launches()
    with tr.device_trace(str(tmp_path)):
        model.execute(space, ex, steps=64)
        torch.cuda.synchronize()
    launched = fs.launches() - before
    assert launched == 8
    assert _k1_kernels_in(tmp_path / "device_trace.pt.trace.json") == 8


@pytest.mark.cuda
def test_the_ladder_leaves_k5_and_k6_k7_on_the_card():
    """The ladder's guard on the card: clean ``pipeline`` and
    ``active_fused`` dispatches end with ``degraded_from`` None,
    ``impl_faults`` 0 and their kernels' counters advanced; with
    ``degrade_after=1`` a ``batch_exc`` takes ``pipeline`` to ``xla``
    (each lane bit for bit a fresh ``xla`` dispatch, K5 not launched) and
    ``active_fused`` to ``active`` then ``xla``."""
    import warnings

    from mpi_model_tpu_torch.resilience import inject
    from mpi_model_tpu_torch.resilience.inject import Fault, FaultPlan

    dev = _card()
    model = mt.Model(mt.Diffusion(0.1))

    def sparse(seed):
        # one active tile of 16: a blob in the corner tile
        v = np.zeros((512, 512), np.float32)
        v[40:100, 40:100] = np.random.default_rng(seed).uniform(
            0.5, 2.0, (60, 60))
        return mt.CellularSpace.create(512, 512, 1.0, device=dev) \
            .with_values({"value": torch.from_numpy(v).to(dev)})

    def serve(sched, spaces):
        ts = [sched.submit(s, model, 8) for s in spaces]
        sched.pump(force=True)
        return [sched.poll(t) for t in ts]

    for impl, spaces, counter in (
            ("pipeline", _lanes(dev, 2, 256, 61), lambda: ps.launches()),
            ("active_fused", [sparse(62), sparse(63)],
             lambda: fa.launches("fused_compute"))):
        sch = mt.EnsembleScheduler(impl=impl, substeps=8 if impl ==
                                   "pipeline" else 1, retry="solo",
                                   degrade_after=1, max_batch=2)
        c0 = counter()
        serve(sch, spaces)
        st = sch.stats()
        assert st["degraded_from"] is None and st["impl_faults"] == 0
        assert counter() > c0
        rungs = ["xla"] if impl == "pipeline" else ["active", "xla"]
        for rung in rungs:
            c1 = counter()
            with inject.armed(FaultPlan((Fault("batch_exc", at=0),))):
                with warnings.catch_warnings(record=True) as w:
                    warnings.simplefilter("always")
                    got = serve(sch, spaces)
            assert any(f"degraded to '{rung}'" in str(x.message) for x in w)
            assert counter() == c1
            want = serve(mt.EnsembleScheduler(impl=rung, max_batch=2,
                                              substeps=sch.executor.substeps),
                         spaces)
            for (g, grep_), (wv, _) in zip(got, want):
                assert torch.equal(g.values["value"], wv.values["value"])
                assert (grep_.backend_report["impl"],
                        grep_.backend_report["degraded_from"]) == (rung, impl)


@pytest.mark.cuda
def test_chip_peaks_are_read_from_the_card():
    from mpi_model_tpu_torch.utils import chip_peaks

    dev = _card()
    p = chip_peaks(dev)
    assert p is not None and p["device_kind"] == torch.cuda.get_device_name(0)
    assert p["hbm_gbps"] > 0 and p["vpu_gops"] > 0
    if p["compute_capability"] == [9, 0] and "H100" in p["device_kind"] \
            and p["sm_count"] == 132:
        assert abs(p["hbm_gbps"] / 3350 - 1) < 0.02
        assert abs(p["vpu_gops"] / 67_000 - 1) < 0.02


@pytest.mark.cuda
def test_loopback_fleet_serves_k5_bit_for_bit_the_sync_service():
    """A 2-member fleet whose members sit behind the loopback wire, on K5
    (``pipeline``, substeps 8) at 1024²: every served lane bit for bit the
    synchronous service's on the same lanes, K5 launched by the members, no
    rung stepped, and the results back on the card."""
    from mpi_model_tpu_torch.ensemble import FleetSupervisor
    from mpi_model_tpu_torch.ensemble.member_proc import (
        spawn_loopback_member)

    dev = _card()
    model = mt.Model(mt.Diffusion(0.1))
    lanes = _lanes(dev, 4, 1024, 71)
    kw = dict(steps=8, impl="pipeline", substeps=8, max_batch=4)
    sync = mt.EnsembleService(model, **kw)
    ts = [sync.submit(s) for s in lanes]
    sync.flush()
    want = [sync.result(t)[0] for t in ts]
    c0 = ps.launches()
    fleet = FleetSupervisor(model, services=2, start=False,
                            member_transport="process",
                            member_spawner=spawn_loopback_member, **kw)
    got = [fleet.result(fleet.submit(s)) for s in lanes]
    st = fleet.stats()
    fleet.stop()
    assert ps.launches() > c0
    for (g, rep), w in zip(got, want):
        assert g.values["value"].device.type == "cuda"
        assert torch.equal(g.values["value"], w.values["value"])
        assert rep.impl == "pipeline"
        assert rep.backend_report.get("degraded_from") is None
    assert st["degraded_from"] is None and st["impl_faults"] == 0
    assert st["scenarios"] == 4 and st["pending"] == 0


@pytest.mark.cuda
def test_a_pinned_child_member_reports_the_card_and_serves_k5():
    """A real child (``spawn_process_member``) pinned by ``member_env`` to
    ``CUDA_VISIBLE_DEVICES=0``: its heartbeat names the card in
    ``_backend_devices``, it serves one K5 scenario bit for bit the
    parent's synchronous service, and its own kernel counts show the K5
    launch."""
    import os

    from mpi_model_tpu_torch.ensemble import FleetSupervisor

    dev = _card()
    model = mt.Model(mt.Diffusion(0.1))
    lane = _lanes(dev, 1, 512, 72)[0]
    kw = dict(steps=8, impl="pipeline", substeps=8)
    sync = mt.EnsembleService(model, **kw)
    want = sync.result(sync.submit(lane))[0]
    fleet = FleetSupervisor(model, services=1, start=True,
                            member_transport="process",
                            member_env={"CUDA_VISIBLE_DEVICES": "0"},
                            heartbeat_deadline_s=30.0, rpc_deadline_s=120.0,
                            **kw)
    try:
        got, rep = fleet.result(fleet.submit(lane), timeout=300)
    finally:
        fleet.stop()
    st = fleet.stats()["services"][0]
    assert st["backend"]["platform"] == "gpu"
    assert st["backend"]["devices"] == [torch.cuda.get_device_name(0)]
    assert st["backend"]["cuda_visible_devices"] == "0"
    assert st["member_pid"] != os.getpid()
    assert st["kernel_launches"]["pipeline_stencil"] >= 1
    assert torch.equal(got.values["value"], want.values["value"])
    assert rep.impl == "pipeline"


# -- scenario tiering on the card -------------------------------------------------

def _vault_on_host(tiering) -> bool:
    """No chain of the vault holds a tensor on the card."""
    return all(v.device.type == "cpu"
               for chain in tiering._chains.values()
               for v in (chain._last_values or {}).values())


@pytest.mark.cuda
def test_paged_async_service_serves_k5_bit_for_bit_the_sync_twin(tmp_path):
    """The paged async service on K5 (``pipeline``, substeps 8) at 1024²,
    a budget of two scenarios for eight: every paged scenario wakes on the
    card and is served bit for bit its never-hibernated twin, K5 launched,
    no rung stepped, and no vault chain holds a card tensor after a
    hibernation or a wake."""
    from mpi_model_tpu_torch.ensemble import (AsyncEnsembleService,
                                              scenario_nbytes)

    dev = _card()
    model = mt.Model(mt.Diffusion(0.1))
    lanes = _lanes(dev, 8, 1024, 81)
    kw = dict(steps=8, impl="pipeline", substeps=8, max_batch=2)
    sync = mt.EnsembleService(model, **kw)
    ts = [sync.submit(s) for s in lanes]
    sync.flush()
    want = [sync.result(t)[0].values["value"] for t in ts]
    c0 = ps.launches()
    svc = AsyncEnsembleService(
        model, start=False, residency_budget=2 * scenario_nbytes(lanes[0])
        + 1, hibernate_dir=str(tmp_path / "v"), **kw)
    tickets = [svc.submit(s) for s in lanes]
    assert svc.stats()["hibernated_scenarios"] == 6
    assert _vault_on_host(svc.tiering)
    got = [svc.result(t) for t in tickets]
    assert _vault_on_host(svc.tiering)
    st = svc.stats()
    svc.stop()
    assert ps.launches() > c0
    for (g, rep), w in zip(got, want):
        assert g.values["value"].device.type == "cuda"
        assert torch.equal(g.values["value"], w)
        assert rep.impl == "pipeline"
    assert st["hibernations"] == 6 and st["wakes"] == 6 and st["shed"] == 0
    assert st["degraded_from"] is None and st["impl_faults"] == 0


@pytest.mark.cuda
def test_vault_chains_hold_no_card_tensor_and_rehibernate_as_a_delta(
        tmp_path):
    """Straight on the vault: after a hibernation, a wake (on the card) and
    a re-hibernation of the unchanged scenario, no chain holds a card
    tensor, and the re-hibernation's record has zero dirty tiles. A
    checkpoint chain keeps its copy on the card (its diff runs there)."""
    from mpi_model_tpu_torch.ensemble import ScenarioTiering
    from mpi_model_tpu_torch.io.delta import DeltaChain

    dev = _card()
    space = _lanes(dev, 1, 1024, 82)[0]
    vault = ScenarioTiering(str(tmp_path / "v"), residency_budget=1)
    vault.hibernate(1, space, mt.Model(mt.Diffusion(0.1)), 8)
    assert _vault_on_host(vault)
    kf = vault.stats()["hibernated_bytes"]
    out, _ = vault.wake(1)
    assert out.values["value"].device.type == "cuda"
    assert torch.equal(out.values["value"], space.values["value"])
    assert _vault_on_host(vault)
    vault.hibernate(1, out, mt.Model(mt.Diffusion(0.1)), 8)
    assert _vault_on_host(vault)
    assert 0 < vault.stats()["hibernated_bytes"] - kf < kf / 100
    ckpt = DeltaChain(str(tmp_path / "c"), device=dev)
    ckpt.save(space, 0)
    assert ckpt._last_values["value"].device.type == "cuda"


@pytest.mark.cuda
def test_paging_a_resident_ticket_out_frees_its_card_memory(tmp_path):
    """A queued resident paged out by a new arrival frees the card: the
    memory the caching allocator counts as live falls by at least one
    scenario's bytes across the arrival's submit (the caller dropped the
    victim's space at its own submit, and keeps the arrival's)."""
    from mpi_model_tpu_torch.ensemble import (AsyncEnsembleService,
                                              scenario_nbytes)

    dev = _card()
    model = mt.Model(mt.Diffusion(0.1))
    one = 1024 * 1024 * 4
    svc = AsyncEnsembleService(
        model, steps=8, impl="pipeline", substeps=8, start=False,
        max_wait_s=1e9, max_batch=8, residency_budget=one + 1,
        hibernate_dir=str(tmp_path / "v"))
    gen = torch.Generator(device=dev).manual_seed(83)

    def lane():
        return mt.CellularSpace.create(1024, 1024, 1.0, device=dev) \
            .with_values({"value": torch.rand(
                (1024, 1024), generator=gen, device=dev) + 0.5})

    t_a = svc.submit(lane())          # resident; the caller keeps nothing
    b = lane()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    t_b = svc.submit(b)               # pages t_a out, then admits t_b
    torch.cuda.synchronize()
    freed = before - torch.cuda.memory_allocated(dev)
    assert svc.tiering.is_hibernated(t_a)
    assert not svc.tiering.is_hibernated(t_b)
    assert scenario_nbytes(b) == one
    assert freed >= one, (freed, one)
    assert _vault_on_host(svc.tiering)
    del b
    svc.stop()


@pytest.mark.cuda
def test_a_tcp_child_serves_k5_on_the_card():
    """A real child behind authenticated TCP on 127.0.0.1 (``member_env``
    pins the card): its handshake passes at the spawn, its heartbeat names
    the card, and it serves one K5 scenario bit for bit the parent's
    synchronous service, with its own K5 launch."""
    from mpi_model_tpu_torch.ensemble import FleetSupervisor

    dev = _card()
    model = mt.Model(mt.Diffusion(0.1))
    lane = _lanes(dev, 1, 512, 84)[0]
    kw = dict(steps=8, impl="pipeline", substeps=8)
    sync = mt.EnsembleService(model, **kw)
    want = sync.result(sync.submit(lane))[0]
    fleet = FleetSupervisor(model, services=1, start=True,
                            member_transport="tcp",
                            member_env={"CUDA_VISIBLE_DEVICES": "0"},
                            rpc_deadline_s=120.0, **kw)
    try:
        got, rep = fleet.result(fleet.submit(lane), timeout=300)
        handshake_s = fleet._members[0].service.handshake_s
    finally:
        fleet.stop()
    st = fleet.stats()
    assert st["member_transport"] == "tcp"
    s0 = st["services"][0]
    assert s0["backend"]["platform"] == "gpu"
    assert s0["backend"]["devices"] == [torch.cuda.get_device_name(0)]
    assert s0["kernel_launches"]["pipeline_stencil"] >= 1
    assert handshake_s is not None and handshake_s > 0
    assert got.values["value"].device.type == "cuda"
    assert torch.equal(got.values["value"], want.values["value"])
    assert rep.impl == "pipeline"


# -- the ensemble mesh and the per-shard checkpoint layout ------------------------

@pytest.mark.cuda
def test_meshed_2x2_dispatch_on_the_card_is_the_unmeshed_one():
    """A (2, 2) ensemble mesh with every position on the one card: each
    lane and its f64 totals bit for bit the unmeshed dispatch's."""
    dev = _card()
    from mpi_model_tpu_torch.ensemble import (EnsembleExecutor,
                                              make_ensemble_mesh,
                                              run_ensemble)

    gen = torch.Generator(device=dev).manual_seed(7)
    spaces = [mt.CellularSpace({"value": 0.5 + torch.rand(
        (256, 384), generator=gen, device=dev)}, 256, 384) for _ in range(4)]
    models = [mt.Model(mt.Diffusion(0.05 + 0.02 * i), 1.0, 1.0)
              for i in range(4)]
    ref = run_ensemble(models[0], spaces, models=models, steps=6,
                       executor=EnsembleExecutor(substeps=4))
    mesh = make_ensemble_mesh(2, 2)
    assert {str(d) for row in mesh.devices_grid for d in row} <= {
        f"cuda:{i}" for i in range(torch.cuda.device_count())}
    got = run_ensemble(models[0], spaces, models=models, steps=6,
                       executor=EnsembleExecutor(substeps=4, mesh=mesh))
    for (g, gr), (r, rr) in zip(got, ref):
        assert g.values["value"].device.type == "cuda"
        assert torch.equal(g.values["value"], r.values["value"])
        assert float(gr.final_total["value"]) == \
            float(rr.final_total["value"])


def _k2_executor():
    from mpi_model_tpu_torch.parallel import ShardMapExecutor, make_mesh_2d

    return ShardMapExecutor(make_mesh_2d(2, 2), "pallas", halo_depth=4)


@pytest.mark.cuda
def test_k2_run_resumes_from_an_async_per_shard_checkpoint(tmp_path):
    """A 2x2 K2 run under async per-shard saves, cut by a failure, resumes
    from the newest manifest and ends bit for bit the uninterrupted run;
    K2 launched and every piece table holds 4 pieces."""
    dev = _card()
    from mpi_model_tpu_torch.io import CheckpointManager
    from mpi_model_tpu_torch.resilience import (SimulationFailure,
                                                supervised_run)

    gen = torch.Generator(device=dev).manual_seed(8)
    space = mt.CellularSpace({"value": 1.0 + 0.1 * torch.rand(
        (512, 512), generator=gen, device=dev)}, 512, 512)
    model = mt.Model(mt.Diffusion(0.1))
    cur = space
    for _ in range(4):
        cur = model.execute(cur, _k2_executor(), steps=8,
                            check_conservation=False)[0]

    class Dies:
        comm_size = 4

        def __init__(self):
            self.inner, self.calls = _k2_executor(), 0
            self.mesh = self.inner.mesh

        def run_model(self, m, s, k):
            self.calls += 1
            if self.calls == 3:
                raise RuntimeError("card lost")
            return self.inner.run_model(m, s, k)

    d = str(tmp_path / "ck")
    before = fs.halo_launches()
    with pytest.raises(SimulationFailure):
        supervised_run(model, space, CheckpointManager(
            d, layout="sharded", async_writes=True, device=dev), steps=32,
            every=8, max_failures=0, executor=Dies())
    mgr = CheckpointManager(d, layout="sharded", async_writes=True,
                            device=dev)
    assert mgr.steps() == [0, 8, 16]
    res = supervised_run(model, space, mgr, steps=32, every=8,
                         executor=_k2_executor())
    # 16 steps before the cut, 16 after, 4 a fused call, 4 shards
    assert fs.halo_launches() - before == 4 * (16 + 16) // 4
    assert torch.equal(res.space.values["value"], cur.values["value"])
    import json
    import os

    with np.load(os.path.join(mgr.path_for(32), "shards_p00000.npz")) as z:
        assert len(json.loads(bytes(z["meta"]).decode())["pieces"]) == 4


@pytest.mark.cuda
def test_async_snapshot_is_not_reached_by_a_later_k2_step(tmp_path):
    """The staged save copies its pieces to the host when it is staged: a
    K2 step written in place into the very tensor afterwards, before the
    writer thread commits, does not reach the checkpoint."""
    dev = _card()
    from mpi_model_tpu_torch.io import CheckpointManager

    gen = torch.Generator(device=dev).manual_seed(9)
    space = mt.CellularSpace({"value": 1.0 + 0.1 * torch.rand(
        (256, 256), generator=gen, device=dev)}, 256, 256)
    want = space.values["value"].clone()
    mgr = CheckpointManager(str(tmp_path / "ck"), layout="sharded",
                            async_writes=True, device=dev)
    ex = _k2_executor()
    mgr.save(space, 0, mesh=ex.mesh)
    nxt = mt.Model(mt.Diffusion(0.1)).execute(space, ex, steps=4,
                                              check_conservation=False)[0]
    space.values["value"].copy_(nxt.values["value"])
    assert not torch.equal(space.values["value"], want)
    mgr.flush()
    got = mgr.latest().space.values["value"]
    assert torch.equal(got, want)


# -- the step audit on the card (analysis.step_audit) -------------------------

@pytest.mark.cuda
def test_step_audit_is_clean_on_the_card():
    """Every contract on the card: no finding, and every kernel route
    checked (its launches a call and its traced kernel names)."""
    dev = _card()
    from mpi_model_tpu_torch.analysis import step_audit as sa

    findings, reports = sa.audit_contracts(device=dev)
    assert findings == []
    routes = [r for r in reports if "launches_declared" in r]
    # K1, K2, K3 vpu and mxu, K3-halo, K4, K4-halo, K5, K6/K7
    assert len(routes) == 9
    for r in routes:
        assert r["launch_check"] == "checked"
        assert r["launches"] == r["launches_declared"], r


@pytest.mark.cuda
def test_step_audit_catches_an_injected_tolist_on_the_card():
    """A ``.tolist()`` in a step is no aten operation a dispatch mode sees;
    the sync debug mode counts it against the contract's declared 0."""
    dev = _card()
    from mpi_model_tpu_torch.analysis import step_audit as sa

    x = torch.arange(64, dtype=torch.float32, device=dev)

    def leaky(v):
        return v * float(len((v * 2).tolist()))

    bad = sa.BuiltStep("injected", leaky, (x,), torch.float32,
                       x.element_size() * x.numel(), ((0, 1),), 1,
                       consts_check=False)
    found, rep = sa.audit_built(bad, dev)
    assert [f.rule for f in found] == ["step-sync"]
    assert rep["host_reads_dispatch"] == 0 and rep["host_reads_warned"] >= 1
    # the same step declared with its one read is clean
    ok = dataclasses.replace(bad, host_reads=1)
    assert sa.audit_built(ok, dev)[0] == []


@pytest.mark.cuda
def test_step_audit_without_device_runs_on_the_card():
    """``device=None`` is the card (the CPU only when asked for)."""
    _card()
    from mpi_model_tpu_torch.analysis import run_step_audit

    assert run_step_audit(impls=("dense", "k1_dense")) == []


@pytest.mark.slow
@pytest.mark.cuda
def test_two_processes_share_the_card_through_k2():
    """Phase 6p (a) at 4096²: two gloo processes on the one card, a row of
    the 2×2 mesh each, K2 at depth 8 for 64 steps: 16 launches on each
    rank, and each rank's gathered grid this process's one-process 2×2
    run, bit for bit."""
    import hashlib
    import json
    from pathlib import Path

    import chip_smoke
    from mpi_model_tpu_torch.parallel import (ShardMapExecutor,
                                              make_mesh_2d, multihost)

    dev = _card()
    mp_side = 4096
    space = mt.CellularSpace({"value": chip_smoke._mp_grid(torch, dev,
                                                           mp_side)},
                             mp_side, mp_side)
    res, _ = mt.Model(mt.Diffusion(0.1)).execute(space, ShardMapExecutor(
        make_mesh_2d(2, 2, devices=[dev] * 4), "pallas", halo_depth=8),
        steps=64)
    want = hashlib.sha256(res.values["value"].cpu().numpy().tobytes())
    root = str(Path(chip_smoke.__file__).resolve().parent)
    port = multihost.probe_free_port()
    code = ("import sys; sys.path.insert(0, {root!r}); import chip_smoke; "
            "chip_smoke.multiprocess_rank({pid}, {port}, {side})")
    outs = multihost._launch_workers(
        [code.format(root=root, pid=p, port=port, side=mp_side)
         for p in (0, 1)], 600)
    for rc, out, err in outs:
        assert rc == 0, err[-4000:]
    for pid, (_, out, _) in enumerate(outs):
        row = json.loads(out.strip().splitlines()[-1])
        assert row["rank"] == pid and row["positions"] == [[pid, 0],
                                                           [pid, 1]]
        assert row["launches"] == row["traced_launches"] == 16
        assert row["sha256"] == want.hexdigest()
        assert row["total"] == float(res.total("value"))
