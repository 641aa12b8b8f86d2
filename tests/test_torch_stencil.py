"""The port's plain-torch stencil ops and flows against the JAX package at
f64 on the CPU. The operation order is fixed by the reference (share =
outflow / counts, then values - outflow + Σ shifts in offset order), so the
match is bitwise (``np.array_equal``)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mpi_model_tpu as mm
from mpi_model_tpu.ops import flow as jflow
from mpi_model_tpu.ops import stencil as js

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS, VON_NEUMANN_OFFSETS
from mpi_model_tpu_torch.ops import flow as tflow
from mpi_model_tpu_torch.ops import stencil as ts

HOODS = {"moore": MOORE_OFFSETS, "von_neumann": VON_NEUMANN_OFFSETS,
         "custom": ((-1, 0), (1, 1), (0, -1))}


def _grid(h, w, seed=0):
    return np.random.default_rng(seed).uniform(0.5, 2.0, (h, w))


def _counts(shape, offs):
    return (ts.neighbor_counts(shape, offs, dtype=torch.float64),
            js.neighbor_counts_traced(shape, offs, dtype=jnp.float64))


@pytest.mark.parametrize("dx", [-1, 0, 1])
@pytest.mark.parametrize("dy", [-1, 0, 1])
def test_shift2d_bitwise(dx, dy):
    a = _grid(5, 7)
    np.testing.assert_array_equal(
        ts.shift2d(torch.from_numpy(a), dx, dy).numpy(),
        np.asarray(js.shift2d(jnp.asarray(a), dx, dy)))


@pytest.mark.parametrize("shape", [(8, 8), (13, 17), (1, 6)])
@pytest.mark.parametrize("hood", sorted(HOODS))
def test_transport_and_flow_step_bitwise(shape, hood):
    offs = HOODS[hood]
    a = _grid(*shape, seed=1)
    rate = np.random.default_rng(2).uniform(0.0, 0.3, shape)
    tc, jc = _counts(shape, offs)
    out = torch.from_numpy(0.13 * a)
    np.testing.assert_array_equal(
        ts.transport(torch.from_numpy(a), out, tc, offs).numpy(),
        np.asarray(js.transport(jnp.asarray(a), jnp.asarray(0.13 * a), jc,
                                offs)))
    np.testing.assert_array_equal(
        ts.flow_step(torch.from_numpy(a), torch.from_numpy(rate), tc,
                     offs).numpy(),
        np.asarray(js.flow_step(jnp.asarray(a), jnp.asarray(rate), jc,
                                offs)))
    np.testing.assert_array_equal(
        ts.gather_neighbors(out, offs).numpy(),
        np.asarray(js.gather_neighbors(jnp.asarray(0.13 * a), offs)))


@pytest.mark.parametrize("src", [(0, 0), (0, 5), (6, 0), (9, 11), (4, 7)])
def test_point_flow_step_corner_edge_interior_bitwise(src):
    """Corner and edge sources: the port drops out-of-bounds neighbors with
    a mask, the JAX package zeroes their share; the results agree."""
    a = _grid(10, 12, seed=3)
    tc, jc = _counts((10, 12), MOORE_OFFSETS)
    got = ts.point_flow_step(torch.from_numpy(a), torch.tensor([src[0]]),
                             torch.tensor([src[1]]),
                             torch.tensor([0.22], dtype=torch.float64), tc)
    want = js.point_flow_step(jnp.asarray(a), jnp.asarray([src[0]]),
                              jnp.asarray([src[1]]), jnp.asarray([0.22]), jc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert abs(got.sum().item() - a.sum()) < 1e-12
    # the input is not modified
    np.testing.assert_array_equal(got.numpy()[src] + 0.22, a[src])


def test_point_flow_step_several_sources_bitwise():
    a = _grid(8, 9, seed=4)
    tc, jc = _counts((8, 9), MOORE_OFFSETS)
    xs, ys, amt = [0, 3, 7], [8, 4, 0], [0.1, 0.3, 0.05]
    got = ts.point_flow_step(torch.from_numpy(a), torch.tensor(xs),
                             torch.tensor(ys),
                             torch.tensor(amt, dtype=torch.float64), tc)
    want = js.point_flow_step(jnp.asarray(a), jnp.asarray(xs),
                              jnp.asarray(ys), jnp.asarray(amt), jc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_flow_outflows_bitwise():
    a, b = _grid(6, 7, seed=5), _grid(6, 7, seed=6)
    tv = {"a": torch.from_numpy(a), "b": torch.from_numpy(b)}
    jv = {"a": jnp.asarray(a), "b": jnp.asarray(b)}
    pairs = [
        (tflow.Diffusion(0.13, attr="a"), jflow.Diffusion(0.13, attr="a")),
        (tflow.Coupled(0.07, attr="a", modulator="b"),
         jflow.Coupled(0.07, attr="a", modulator="b")),
        (tflow.PointFlow((2, 3), 0.4, attr="b"),
         jflow.PointFlow((2, 3), 0.4, attr="b")),
        (tflow.Exponencial(mt.Cell(1, 1, mt.Attribute(99, 2.2)), 0.1,
                           attr="a"),
         jflow.Exponencial(mm.Cell(1, 1, mm.Attribute(99, 2.2)), 0.1,
                           attr="a")),
    ]
    for tf, jf in pairs:
        np.testing.assert_array_equal(tf.outflow(tv).numpy(),
                                      np.asarray(jf.outflow(jv)))
        # a whole-grid sum: the two libraries reduce in different orders
        assert float(tf.execute(tv)) == pytest.approx(
            float(jf.execute(jv)), rel=1e-12)
        assert tf.fingerprint()[0] == jf.fingerprint()[0]
    tsum = tflow.build_outflow([p[0] for p in pairs], tv)
    jsum = jflow.build_outflow([p[1] for p in pairs], jv)
    for k in jsum:
        np.testing.assert_array_equal(tsum[k].numpy(), np.asarray(jsum[k]))


def test_point_flow_snapshot_and_partition_semantics():
    f = tflow.Exponencial(mt.Cell(19, 3, mt.Attribute(99, 2.2)), 0.1)
    g = jflow.Exponencial(mm.Cell(19, 3, mm.Attribute(99, 2.2)), 0.1)
    assert f.frozen_source_value == g.frozen_source_value == 2.2
    assert f.execute_scalar() == g.execute_scalar()
    v = {"value": torch.ones(4, 4, dtype=torch.float64)}
    # a source outside this partition sheds nothing here
    assert f.local_source(v)[2] is False
    assert float(f.amount(v)) == 0.0
    assert float(f.amount(v, origin=(17, 1))) == pytest.approx(0.22)
    d = tflow.Diffusion(0.3)
    assert dataclasses.asdict(d) == dataclasses.asdict(jflow.Diffusion(0.3))


def test_ring1_flow_contract():
    with pytest.raises(TypeError, match="ring1"):
        class Bad(tflow.Flow):  # noqa: F841
            footprint = "ring1"

    class Ring(tflow.Flow):
        footprint = "ring1"
        attr = "value"

        def outflow_padded(self, padded, origin=(0, 0)):
            return 0.1 * padded["value"][:-2, 1:-1]

    v = torch.arange(12, dtype=torch.float64).reshape(3, 4)
    np.testing.assert_array_equal(
        Ring().outflow({"value": v}).numpy(),
        0.1 * ts.shift2d(v, -1, 0).numpy())
