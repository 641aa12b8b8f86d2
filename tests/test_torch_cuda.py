"""The port's kernels on the card against their plain versions: K1, K3, K4,
K5, K6 and K7. Needs a CUDA device and skips without one. It imports neither jax
nor the JAX package, so it also runs where only torch is installed:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py

Tolerances: K1 and K3 f32 ``1e-6 * nsteps``, bf16 one ulp at values below
4 (both sum a neighborhood in ``offsets`` order with every operation
rounded, as their plain versions do; K3's tap loop is left to nvcc's FMA
contraction). K6 and K7 are held bit for bit: K6 computes in the
storage dtype with every operation rounded, in the plain version's order,
and K7 moves bits. K4 is held bit for bit (f32 and bf16 both compute in f32
and round once per call), except flows using exp: CUDA's expf and torch's
exp may differ by an ulp, so those are held to ``8·eps·nsteps·max|v|``.
K5 is held bit for bit (f32 math in the plain version's order, no FMA
contraction, rounded once per call)."""

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
@pytest.mark.parametrize("dtype,ns", [(torch.float32, 1), (torch.float32, 8),
                                      (torch.bfloat16, 16)])
@pytest.mark.parametrize("offs", [MOORE_OFFSETS, VON_NEUMANN_OFFSETS])
def test_kernel_matches_plain_on_the_card(dtype, ns, offs):
    dev = _card()
    v = np.random.default_rng(42).uniform(0.5, 2.0, (256, 512))
    x = torch.from_numpy(v).to(dev, dtype)
    before = fs.launches()
    got = fs.pallas_dense_step(x, 0.13, offs, nsteps=ns)
    assert fs.launches() == before + 1
    want = fs.dense_step_plain(x, 0.13, offs, ns)
    tol = 1e-6 * ns if dtype == torch.float32 else 2.0 ** -6
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
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
    dev = _card()
    v = np.random.default_rng(7).uniform(0.5, 2.0, shape)
    x = torch.from_numpy(v).to(dev, dtype)
    before = cs.launches()
    got = cs.composed_dense_step(x, 0.13, k, offs)
    assert cs.launches() == before + 1
    want = cs.composed_dense_step_plain(x, 0.13, k, offs)
    tol = 1e-6 * k if dtype == torch.float32 else 2.0 ** -6
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


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
    ``complete_ensemble`` then synchronizes once."""
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
