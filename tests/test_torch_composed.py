"""K3's module in the port (``ops/composed_stencil.py``) against the JAX
package's ``ops/composed_stencil.py``, on the CPU.

On a CPU tensor ``composed_dense_step`` runs ``composed_dense_step_plain``;
the CUDA kernel is held against that plain version on the card
(``chip_smoke.py`` and ``tests/test_torch_cuda.py``). The JAX side runs its
Pallas kernel in interpret mode.

- the tap tables are bitwise the JAX package's; ``max_k``, ``choose_k`` and
  the variant rule agree, and both packages refuse the same calls with the
  same messages;
- values: the port's plain version and JAX's interpret-mode kernel compute
  the same k steps with other groupings (per cell here, per block there,
  and the binomial or banded interior there), so they are held at
  ``atol = rtol = 1e-6 * k`` in f32, and both to the f64 oracle;
- the slice: ``SerialExecutor("composed")`` through ``Model.execute``
  against the JAX executor of the same name, values and report.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mpi_model_tpu as mm
from mpi_model_tpu.models.model import SerialExecutor as JSerial
from mpi_model_tpu.ops import composed_stencil as jcs
from mpi_model_tpu.oracle import dense_flow_step_np

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch import interop
from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS, VON_NEUMANN_OFFSETS
from mpi_model_tpu_torch.ops import composed_stencil as cs
from mpi_model_tpu_torch.ops import fused_stencil as fs

CUSTOM = ((-1, 0), (1, 1), (0, -1))
HOODS = {"moore": MOORE_OFFSETS, "von_neumann": VON_NEUMANN_OFFSETS,
         "custom": CUSTOM}


def _grid(h, w, seed=42):
    return np.random.default_rng(seed).uniform(0.5, 2.0, (h, w)).astype(
        np.float32)


def _oracle(v, rate, offs, n):
    ref = v.astype(np.float64)
    for _ in range(n):
        ref = dense_flow_step_np(ref, rate, offsets=offs)
    return ref


@pytest.mark.parametrize("hood", sorted(HOODS))
@pytest.mark.parametrize("rate,k", [(0.1, 1), (0.13, 4), (0.1, 8),
                                    (0.25, 16)])
def test_taps_bitwise_equal_to_jax(hood, rate, k):
    got = cs.composed_taps(rate, HOODS[hood], k)
    want = jcs.composed_taps(rate, HOODS[hood], k)
    assert got.shape == (2 * k + 1, 2 * k + 1) and got.dtype == np.float64
    assert got.tobytes() == np.asarray(want).tobytes()
    # cached by fingerprint, read-only, and mass-conserving
    assert cs.composed_taps(rate, HOODS[hood], k) is got
    assert not got.flags.writeable
    assert abs(got.sum() - 1.0) < 1e-12
    assert cs.taps_fingerprint(rate, HOODS[hood], k) == \
        jcs.taps_fingerprint(rate, HOODS[hood], k)


@pytest.mark.parametrize("shape,dtype,block", [
    ((64, 256), "float32", None), ((64, 256), "bfloat16", None),
    ((40, 640), "float32", (8, 128)), ((13, 17), "float32", None),
    ((32, 256), "bfloat16", (16, 128)), ((24, 96), "float32", (24, 32)),
])
def test_max_k_choose_k_and_variant_match_jax(shape, dtype, block):
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    assert cs.max_k(shape, tdt, block) == jcs.max_k(shape, jdt, block)
    for sub in (1, 2, 7, 8, 12, 16, 17, 24):
        assert cs.choose_k(sub, shape, tdt, block) == \
            jcs.choose_k(sub, shape, jdt, block), sub
    for k in (1, 2, 4, 8):
        for bw in (96, 128, 256):
            for var in ("auto", "vpu", "mxu"):
                assert cs._resolve_variant(var, k, bw) == \
                    jcs._resolve_variant(var, k, bw)
    assert cs.MXU_MIN_TAPS == jcs.MXU_MIN_TAPS


@pytest.mark.parametrize("shape,block,k,hood,variant", [
    ((64, 256), None, 4, "moore", "auto"),
    ((64, 256), None, 8, "moore", "mxu"),
    ((64, 256), None, 4, "von_neumann", "vpu"),
    ((40, 640), (8, 128), 4, "custom", "vpu"),
    ((48, 96), (48, 32), 2, "moore", "vpu"),     # odd block width
    ((13, 17), None, 1, "moore", "auto"),         # every cell near the edge
])
def test_values_match_jax_interpret_and_the_oracle(shape, block, k, hood,
                                                   variant):
    v = _grid(*shape)
    offs = HOODS[hood]
    got = cs.composed_dense_step(torch.from_numpy(v), 0.13, k, offs,
                                 block=block, variant=variant).numpy()
    want = np.asarray(jcs.composed_dense_step(
        jnp.asarray(v), 0.13, k, offs, block=block, interpret=True,
        variant=variant))
    tol = 1e-6 * k
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, _oracle(v, 0.13, offs, k), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("k", [2, 8])
def test_plain_version_edge_band_is_the_iterated_path(k):
    """Cells within k of the edge are exactly K1's plain iterated path;
    interior cells are the f32 tap correlation (held to the f64 oracle)."""
    v = _grid(40, 72, seed=3)
    x = torch.from_numpy(v)
    got = cs.composed_dense_step_plain(x, 0.1, k, MOORE_OFFSETS)
    it = fs.dense_step_plain(x, 0.1, MOORE_OFFSETS, k)
    band = torch.ones_like(got, dtype=torch.bool)
    band[k + 1:-k - 1, k + 1:-k - 1] = False  # distance <= k from an edge
    assert torch.equal(got[band], it[band])
    np.testing.assert_allclose(got.numpy(), _oracle(v, 0.1, MOORE_OFFSETS,
                                                    k),
                               rtol=1e-6 * k, atol=1e-6 * k)


def test_bf16_rounds_once_per_call():
    x = torch.from_numpy(_grid(32, 256, seed=9)).to(torch.bfloat16)
    got = cs.composed_dense_step(x, 0.1, 8)
    once = cs.composed_dense_step_plain(x.float(), 0.1, 8).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, once)
    want = np.asarray(jcs.composed_dense_step(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), 0.1, 8,
        interpret=True)).astype(np.float32)
    # the same f32 math rounded once, in two groupings: one bf16 ulp
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -7)


@pytest.mark.parametrize("kw", [
    dict(k=0), dict(k=9), dict(variant="nope"),
    dict(variant="mxu", block=(64, 96)), dict(offsets=((2, 0),)),
])
def test_same_calls_refused_with_same_messages(kw):
    v = _grid(64, 96)
    kw = dict(kw)
    k = kw.pop("k", 4)
    with pytest.raises(ValueError) as t_exc:
        cs.composed_dense_step(torch.from_numpy(v), 0.1, k, **kw)
    with pytest.raises(ValueError) as j_exc:
        jcs.composed_dense_step(jnp.asarray(v), 0.1, k, interpret=True,
                                **kw)
    assert str(t_exc.value) == str(j_exc.value)


def test_stepper_refuses_k_past_the_ghost_depth_like_jax():
    with pytest.raises(ValueError) as t_exc:
        cs.ComposedDiffusionStep((64, 256), 0.1, 9)
    with pytest.raises(ValueError) as j_exc:
        jcs.ComposedDiffusionStep((64, 256), 0.1, 9, interpret=True)
    assert str(t_exc.value) == str(j_exc.value)
    step = cs.ComposedDiffusionStep((64, 256), 0.1, 8)
    x = torch.from_numpy(_grid(64, 256))
    out = torch.empty_like(x)
    before = cs.launches()
    assert step(x, out=out) is out
    assert torch.equal(out, cs.composed_dense_step_plain(x, 0.1, 8))
    # a CPU call runs the plain version: nothing launched, nothing counted
    assert cs.launches() == before and step.launches == 0
    assert step.variant == "auto"   # the variant asked for
    with pytest.raises(TypeError, match="float64"):
        cs.composed_dense_step(x.double(), 0.1, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cs.composed_dense_step(x, 0.1, 2, compute_dtype=torch.bfloat16)


def _spaces(v):
    ts = interop.space_from_numpy({"value": v}, device="cpu")
    js = mm.CellularSpace.create(*v.shape, 1.0, dtype=jnp.float32)
    return ts, js.with_values({"value": jnp.asarray(v)})


@pytest.mark.parametrize("substeps,steps", [(4, 8), (8, 10), (16, 16)])
def test_executor_matches_jax_composed_executor(substeps, steps):
    v = _grid(64, 256, seed=5)
    ts, js = _spaces(v)
    tout, trep = mt.Model(mt.Diffusion(0.12)).execute(
        ts, mt.SerialExecutor("composed", substeps=substeps), steps=steps)
    jout, jrep = mm.Model(mm.Diffusion(0.12)).execute(
        js, JSerial("composed", substeps=substeps), steps=steps)
    got = tout.values["value"].numpy()
    tol = 1e-6 * steps
    np.testing.assert_allclose(got, np.asarray(jout.values["value"]),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got, _oracle(v, 0.12, MOORE_OFFSETS, steps),
                               rtol=tol, atol=tol)
    assert trep.impl == "composed"
    tb, jb = trep.backend_report, jrep.backend_report
    assert set(jb) <= set(tb)
    assert {key: tb[key] for key in jb} == jb
    # on the CPU the plain version ran: no kernel launch is counted
    assert tb["launches"] == 0 and tb["kernel"] == "K3 composed_stencil"


def test_make_step_eligibility_and_auto_k_like_jax():
    ts, js = _spaces(_grid(64, 256))
    tm, jm = mt.Model(mt.Diffusion(0.1)), mm.Model(mm.Diffusion(0.1))
    for sub in (1, 6, 8, 16):
        a = tm.make_step(ts, impl="composed", substeps=sub)
        b = jm.make_step(js, impl="composed", substeps=sub)
        assert (a.impl, a.composed_k, a.composed_passes) == \
            (b.impl, b.composed_k, b.composed_passes)
    with pytest.warns(RuntimeWarning, match="auto-k degenerated"):
        assert tm.make_step(ts, impl="composed", substeps=17).composed_k == 1
    # refused like JAX: f64, zero rates, point flows with substeps > 1
    f64 = mt.CellularSpace.create(64, 256, 1.0, dtype="float64",
                                  device="cpu")
    with pytest.raises(ValueError, match="f32/bf16 grid"):
        tm.make_step(f64, impl="composed")
    with pytest.raises(ValueError, match="nothing to compose"):
        mt.Model(mt.Diffusion(0.0)).make_step(ts, impl="composed")
    pt = mt.Model([mt.Diffusion(0.1), mt.PointFlow((3, 3), 0.2)])
    with pytest.raises(ValueError, match="point flows"):
        pt.make_step(ts, impl="composed", substeps=2)
    # substeps=1 composes with a point flow, which fires after the pass
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        step = pt.make_step(ts, impl="composed")
    out = step(dict(ts.values))["value"]
    jstep = mm.Model([mm.Diffusion(0.1), mm.PointFlow((3, 3), 0.2)]
                     ).make_step(js, impl="composed")
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jstep(dict(js.values))["value"]),
                               rtol=1e-6, atol=1e-6)
