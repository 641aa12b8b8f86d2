"""The port's bridge to the native C++ engine
(``mpi_model_tpu_torch.native``), built with g++ into the port's build
directory: its ABI checks, the engine against the numpy oracle, and
``NativeExecutor`` against the JAX package's ``NativeExecutor`` on the same
numpy-seeded spaces. Both drive the same C++ source, so they agree bit
for bit, at f64 and f32, serial and on threaded ranks."""

import subprocess
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_model_tpu as mm
from mpi_model_tpu import native as jnative

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch import native, oracle
from mpi_model_tpu_torch.ops import _build

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def lib():
    try:
        return native.load_library()
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        pytest.skip(f"native build unavailable: {e}")


def test_abi_version_and_library_location(lib):
    assert lib.mmtpu_abi_version() == native.ABI_VERSION == 2
    path = native.build_native()
    assert path == str(native.library_path())
    assert path.startswith(str(_build.BUILD_DIR))
    assert "libmmtpu-" in path


def test_native_space_roundtrip():
    ns = native.NativeSpace(10, 8, 1.5)
    assert ns.total() == pytest.approx(10 * 8 * 1.5)
    ns.set(3, 4, 9.0)
    assert ns.channel()[3, 4] == 9.0
    with pytest.raises(IndexError):
        ns.set(99, 0, 1.0)
    with pytest.raises(KeyError):
        ns.channel("nope")


def test_native_f32_space_roundtrip():
    ns = native.NativeSpace(10, 8, 1.5, dtype="float32")
    assert ns.channel().dtype == np.float32
    assert ns.total() == pytest.approx(10 * 8 * 1.5)
    ns.set(3, 4, 9.0)
    assert ns.channel()[3, 4] == np.float32(9.0)
    with pytest.raises(ValueError, match="float32/float64"):
        native.NativeSpace(4, 4, dtype="bfloat16")


def test_native_reference_run_matches_oracle():
    ns = native.NativeSpace(100, 100, 1.0)
    rep = ns.run([mt.Exponencial(mt.Cell(19, 3, mt.Attribute(99, 2.2)),
                                 0.1)], steps=1)
    np.testing.assert_allclose(ns.channel(), oracle.reference_run_np(),
                               atol=1e-12)
    assert rep["final_total"] == pytest.approx(10000.0)
    assert rep["conservation_error"] < 1e-9


@pytest.mark.parametrize("lines,columns", [(1, 1), (5, 1), (2, 2), (2, 4)])
def test_native_threaded_matches_oracle(lines, columns):
    rng = np.random.default_rng(11)
    init = rng.uniform(0.5, 2.0, (40, 24))
    flows = [mt.Diffusion(0.1), mt.PointFlow(source=(19, 3), flow_rate=0.5)]
    ns = native.NativeSpace(40, 24, 0.0)
    np.copyto(ns.channel(), init)
    ns.run(flows, steps=4, lines=lines, columns=columns)
    want = init.copy()
    for _ in range(4):
        amt = 0.5 * want[19, 3]
        want = oracle.dense_flow_step_np(want, 0.1)
        want = oracle.point_flow_step_np(want, 19, 3, amt)
    np.testing.assert_allclose(ns.channel(), want, atol=1e-10)


def test_native_f32_matches_f32_oracle():
    rng = np.random.default_rng(13)
    init = rng.uniform(0.5, 2.0, (24, 20)).astype(np.float32)
    ns = native.NativeSpace(24, 20, 0.0, dtype="float32")
    np.copyto(ns.channel(), init)
    ns.run([mt.Diffusion(0.1), mt.PointFlow(source=(5, 5), flow_rate=0.5)],
           steps=4, check_conservation=False)
    want = init.copy()
    for _ in range(4):
        amt = np.float32(0.5) * want[5, 5]
        want = oracle.dense_flow_step_np(want, np.float32(0.1))
        want = oracle.point_flow_step_np(want, 5, 5, amt)
    assert want.dtype == np.float32
    np.testing.assert_allclose(ns.channel(), want, rtol=2e-6, atol=2e-6)


def _spaces(dtype: str, channels: dict, shape=(16, 32), seed=5):
    """The same numpy-seeded channels as a port space and a JAX space."""
    rng = np.random.default_rng(seed)
    vals = {k: (v * rng.uniform(0.5, 2.0, shape)).astype(dtype)
            for k, v in channels.items()}
    port = mt.CellularSpace.create(*shape, dict(channels), dtype=dtype,
                                   device=CPU).with_values(
        {k: torch.from_numpy(v.copy()) for k, v in vals.items()})
    jax = mm.CellularSpace.create(*shape, dict(channels),
                                  dtype=getattr(jnp, dtype)).with_values(
        {k: jnp.asarray(v) for k, v in vals.items()})
    return port, jax


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("lines,columns", [(1, 1), (1, 2), (2, 2)])
def test_native_executor_is_the_jax_package_s_bit_for_bit(dtype, lines,
                                                          columns):
    port_space, jax_space = _spaces(dtype, {"a": 1.0, "b": 2.0})
    flows = [mt.Coupled(flow_rate=0.05, attr="a", modulator="b"),
             mt.Diffusion(0.1, attr="b"),
             mt.PointFlow(source=(3, 7), flow_rate=0.3, attr="a")]
    jflows = [mm.Coupled(flow_rate=0.05, attr="a", modulator="b"),
              mm.Diffusion(0.1, attr="b"),
              mm.PointFlow(source=(3, 7), flow_rate=0.3, attr="a")]
    ex = native.NativeExecutor(lines=lines, columns=columns)
    got, rep = mt.Model(flows, 4.0, 1.0).execute(port_space, ex,
                                                 check_conservation=False)
    jex = jnative.NativeExecutor(lines=lines, columns=columns)
    want = jex.run_model(mm.Model(jflows, 4.0, 1.0), jax_space, 4)
    for k in ("a", "b"):
        assert got.values[k].dtype == getattr(torch, dtype)
        assert got.values[k].device == CPU
        np.testing.assert_array_equal(got.values[k].numpy(),
                                      np.asarray(want[k]))
    assert rep.backend_report == jex.last_backend_report
    assert rep.comm_size == lines * columns


def test_native_executor_reference_scenario_matches_oracle():
    """The reference scenario (100², one Exponencial from (19, 3)) through
    ``Model.execute``, and 4 steps of diffusion against the oracle."""
    space = mt.CellularSpace.create(100, 100, 1.0, dtype="float64",
                                    device=CPU)
    flow = mt.Exponencial(mt.Cell(19, 3, mt.Attribute(99, 2.2)), 0.1)
    out, rep = mt.Model(flow, 1.0, 1.0).execute(space,
                                                native.NativeExecutor())
    np.testing.assert_allclose(out.values["value"].numpy(),
                               oracle.reference_run_np(), atol=1e-12)
    assert rep.conservation_error() < 1e-9
    rng = np.random.default_rng(3)
    init = rng.uniform(0.5, 2.0, (32, 32))
    sp = mt.CellularSpace.create(32, 32, 0.0, dtype="float64",
                                 device=CPU).with_values(
        {"value": torch.from_numpy(init.copy())})
    out, _ = mt.Model(mt.Diffusion(0.07), 4.0, 1.0).execute(
        sp, native.NativeExecutor(lines=2, columns=2))
    want = init.copy()
    for _ in range(4):
        want = oracle.dense_flow_step_np(want, 0.07)
    np.testing.assert_allclose(out.values["value"].numpy(), want,
                               atol=1e-12)


def test_native_executor_surfaces_backend_report():
    space = mt.CellularSpace.create(16, 16, 1.0, dtype="float64", device=CPU)
    _, rep = mt.Model(mt.Diffusion(0.1), 3.0, 1.0).execute(
        space, native.NativeExecutor(lines=2, columns=2))
    br = rep.backend_report
    assert br is not None and br["engine"] == "native-c++"
    assert br["comm_size"] == 4
    assert br["initial_total"] == pytest.approx(256.0)
    assert abs(br["final_total"] - rep.final_total["value"]) < 1e-9
    assert br["conservation_error"] < 1e-9
    _, rep2 = mt.Model(mt.Diffusion(0.1), 1.0, 1.0).execute(space)
    assert rep2.backend_report is None


def test_native_refuses_flows_it_does_not_know():
    class Odd(mt.Diffusion):
        pass

    space = mt.CellularSpace.create(8, 8, 1.0, dtype="float64", device=CPU)
    # a subclass of a known flow runs as that flow; an unknown flow raises
    mt.Model(Odd(0.1), 1.0, 1.0).execute(space, native.NativeExecutor())
    with pytest.raises(TypeError, match="native backend supports"):
        native._flow_specs([types.SimpleNamespace(attr="value",
                                                  flow_rate=0.1)])


def test_native_selftests():
    assert native.selftest_recv_timeout(timeout_ms=200) is True
    assert native.selftest_typed_wire() is True


def test_build_native_rebuilds_on_force_and_raises_on_a_bad_source(
        monkeypatch, tmp_path):
    path = native.build_native()
    assert native.build_native() == path  # cached: the same file
    bad = tmp_path / "capi.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "NATIVE_SOURCE", bad)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build_native()
    assert not list((tmp_path / "build").glob("*.so"))
