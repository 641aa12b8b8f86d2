"""The port's L0/L2 modules (abstraction, cell, cellular_space) against the
JAX package's: dtype mapping, neighbor counts, partitions and totals. All
on the CPU; inputs made with numpy from a seed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mpi_model_tpu as mm
import mpi_model_tpu.abstraction as jabs
from mpi_model_tpu.core import cell as jcell
from mpi_model_tpu.core import cellular_space as jcs
from mpi_model_tpu.ops.stencil import neighbor_counts_traced

import mpi_model_tpu_torch as mt
import mpi_model_tpu_torch.abstraction as tabs
from mpi_model_tpu_torch.core import cell as tcell
from mpi_model_tpu_torch.core import cellular_space as tcs
from mpi_model_tpu_torch.ops.stencil import neighbor_counts

NAMES = sorted(jabs._CANONICAL)


@pytest.mark.parametrize("name", NAMES)
def test_dtype_names_map_like_jax(name):
    jdt = jabs.get_abstraction_data_type(name)
    tdt = tabs.get_abstraction_data_type(name)
    assert int(tdt) == int(jdt) and tdt.name == jdt.name
    # the backend dtype carries the same name in both packages
    assert str(tabs.to_torch(tdt)).removeprefix("torch.") == \
        jnp.dtype(jabs.to_jax(jdt)).name
    assert tabs.get_abstraction_data_type(tabs.to_torch(tdt)) == tdt
    assert tabs.to_torch(tdt).itemsize == jabs.itemsize(jdt)


def test_python_scalars_and_numpy_dtypes_map_like_jax():
    for tp in (int, float, bool, np.float32, np.int16, np.dtype("uint8")):
        assert int(tabs.get_abstraction_data_type(tp)) == \
            int(jabs.get_abstraction_data_type(tp))
    assert tabs.to_torch(tabs.DataType.BFLOAT16) is torch.bfloat16


def test_unsupported_dtype_raises():
    with pytest.raises(tabs.UnsupportedDataTypeError):
        tabs.get_abstraction_data_type("complex128")
    with pytest.raises(tabs.UnsupportedDataTypeError):
        tabs.get_abstraction_data_type("not-a-dtype")


@pytest.mark.parametrize("dims", [(5, 7), (1, 4), (13, 17)])
@pytest.mark.parametrize("hood", ["moore", "von_neumann"])
def test_neighbor_count_grid_matches_jax(dims, hood):
    offs = tcell.MOORE_OFFSETS if hood == "moore" else \
        tcell.VON_NEUMANN_OFFSETS
    np.testing.assert_array_equal(
        tcell.neighbor_count_grid(*dims, offs),
        jcell.neighbor_count_grid(*dims, offs))
    # partition form: counts against the global bounds
    np.testing.assert_array_equal(
        tcell.neighbor_count_grid(3, 4, offs, x_init=2, y_init=3,
                                  global_dim_x=9, global_dim_y=7),
        jcell.neighbor_count_grid(3, 4, offs, x_init=2, y_init=3,
                                  global_dim_x=9, global_dim_y=7))


def test_device_neighbor_counts_match_traced_counts():
    got = neighbor_counts((6, 9), tcell.MOORE_OFFSETS, (4, 2), (12, 11),
                          torch.float64, "cpu")
    want = neighbor_counts_traced((6, 9), jcell.MOORE_OFFSETS, (4, 2),
                                  (12, 11), jnp.float64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cells_and_neighbors_match_jax():
    for x, y in ((0, 0), (0, 5), (19, 3), (99, 99)):
        assert tcell.moore_neighbors(x, y, 100, 100) == \
            jcell.moore_neighbors(x, y, 100, 100)
        tc = mt.Cell(x, y, mt.Attribute(99, 2.2)).set_neighbor(100, 100)
        jc = mm.Cell(x, y, mm.Attribute(99, 2.2)).set_neighbor(100, 100)
        assert tc.neighbors == jc.neighbors
        assert tc.count_neighbors == jc.count_neighbors
        assert tc.neighbor_xs() == jc.neighbor_xs()


def test_partitions_match_jax():
    for args in ((10, 7, 3), (9, 9, 4), (5, 5, 1)):
        assert [p.describe() for p in tcs.row_partitions(*args)] == \
            [p.describe() for p in jcs.row_partitions(*args)]
    for args in ((10, 7, 2, 3), (16, 16, 4, 4)):
        tp, jp = tcs.block_partitions(*args), jcs.block_partitions(*args)
        assert [(p.describe(), p.rank) for p in tp] == \
            [(p.describe(), p.rank) for p in jp]
    p = mt.Partition.parse("4|2:3|5")
    assert p == mt.Partition(4, 2, 3, 5) and p.describe() == "4|2:3|5"
    assert p.contains(6, 6) and not p.contains(7, 2)
    assert p.local(5, 3) == (1, 1)


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_totals_match_jax(dtype):
    rng = np.random.default_rng(3)
    a = rng.uniform(0.5, 2.0, (24, 40))
    js = mm.CellularSpace.create(24, 40, 1.0, dtype=dtype).with_values(
        {"value": jnp.asarray(a, dtype)})
    ts = mt.CellularSpace.create(24, 40, 1.0, dtype=dtype, device="cpu")
    ts = ts.with_values({"value": torch.as_tensor(a).to(
        tabs.to_torch(tabs.get_abstraction_data_type(dtype)))})
    got, want = ts.total("value"), js.total("value")
    # accumulation dtype kept: f64 in f64, f32/bf16 in f32
    assert str(got.dtype).removeprefix("torch.") == jnp.dtype(want.dtype).name
    tol = 1e-12 if dtype == "float64" else 1e-5
    np.testing.assert_allclose(float(got), float(want), rtol=tol)


def test_integer_totals_accumulate_int64_on_host():
    spec = {"value": 1.0, "count": (2**30, "int32")}
    ts = mt.CellularSpace.create(4, 4, spec, device="cpu")
    js = mm.CellularSpace.create(4, 4, spec)
    assert ts.total("count") == int(js.total("count")) == 16 * 2**30
    # the flow dtype is the first FLOATING channel's, whatever the order
    ts2 = mt.CellularSpace.create(2, 2, {"mask": (True, "bool"),
                                         "value": 1.0}, device="cpu")
    assert ts2.dtype == torch.float32


def test_create_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.CellularSpace.create(4, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.CellularSpace.create(4, 4, device="cuda")
    s = mt.CellularSpace.create(4, 4, device="cpu")
    assert s.device.type == "cpu" and s.values["value"].dtype == torch.float32


def test_space_shape_and_cell_access_match_jax():
    ts = mt.CellularSpace.create(5, 6, 1.0, dtype="float64", x_init=2,
                                 y_init=1, global_dim_x=9, global_dim_y=8,
                                 device="cpu")
    js = mm.CellularSpace.create(5, 6, 1.0, dtype="float64", x_init=2,
                                 y_init=1, global_dim_x=9, global_dim_y=8)
    assert ts.shape == js.shape and ts.global_shape == js.global_shape
    assert ts.is_partition and js.is_partition
    assert ts.get_cell(3, 4).neighbors == js.get_cell(3, 4).neighbors
    with pytest.raises(IndexError):
        ts.get_cell(0, 0)
    np.testing.assert_array_equal(ts.neighbor_counts().numpy(),
                                  np.asarray(js.neighbor_counts()))
