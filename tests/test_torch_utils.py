"""The port's utilities on the CPU: ``chip_peaks`` from a stubbed card's
attributes (an H100 SXM's), ``stencil_roofline`` against the JAX
package's, the kernel build cache (``configure_compile_cache`` and the
toolchain in every library's name), and the command line's ``--trace``,
``--compile-cache``, ``--status*`` and ``info`` (the cases of
``tests/test_cli.py``)."""

import json
import os
from pathlib import Path

import pytest
import torch

from mpi_model_tpu.utils import roofline as jroofline

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch.cli import main as cli_main
from mpi_model_tpu_torch.ops import _build
from mpi_model_tpu_torch.utils import compile_cache as cc
from mpi_model_tpu_torch.utils import roofline

#: what an H100 SXM (80 GB HBM3) reports: 132 SMs, a 1980 MHz maximum SM
#: clock, a 2619 MHz memory clock on a 5120-bit bus, compute capability 9.0
H100 = {"name": "NVIDIA H100 80GB HBM3", "capability": (9, 0),
        "sm_count": 132, "sm_clock_khz": 1_980_000,
        "mem_clock_khz": 2_619_000, "bus_width_bits": 5120,
        "clock_source": "cudaDeviceGetAttribute"}


@pytest.fixture
def h100(monkeypatch):
    """``chip_peaks`` reads the stubbed card at any CUDA ordinal."""
    monkeypatch.setattr(roofline, "_device_attributes",
                        lambda index: dict(H100))
    monkeypatch.delenv("MMTPU_HBM_PEAK_GBPS", raising=False)
    monkeypatch.delenv("MMTPU_VPU_PEAK_GOPS", raising=False)


@pytest.fixture
def build_dir():
    """Restores the build directory the test re-points."""
    before = _build.BUILD_DIR
    try:
        yield
    finally:
        _build.BUILD_DIR = before
        cc._configured = None


# -- chip_peaks and the roofline -------------------------------------------------

def test_chip_peaks_of_an_h100_are_its_data_sheet_s(h100):
    p = roofline.chip_peaks(torch.device("cuda", 0))
    assert p["device_kind"] == "NVIDIA H100 80GB HBM3"
    assert abs(p["hbm_gbps"] / 3350.0 - 1) < 0.01
    assert abs(p["vpu_gops"] / 67_000.0 - 1) < 0.01
    # the tensor-core peak at the same (maximum) SM clock; the data sheet's
    # 989 TFLOP/s is the same rate at a lower clock
    assert p["mxu_bf16_tflops"] == pytest.approx(
        132 * 4096 * 1.98e9 / 1e12)
    assert p["mxu_bf16_tflops"] * 1830 / 1980 == pytest.approx(989.4,
                                                               rel=1e-3)
    assert p["tf32_tflops"] == pytest.approx(p["mxu_bf16_tflops"] / 2)
    assert (p["sm_count"], p["sm_clock_mhz"], p["mem_clock_mhz"],
            p["bus_width_bits"]) == (132, 1980.0, 2619.0, 5120)
    assert roofline.chip_peaks("cuda:1") == p
    assert roofline.chip_peaks(0) == p


def test_chip_peaks_env_overrides_and_unknown_parts(h100, monkeypatch):
    monkeypatch.setenv("MMTPU_HBM_PEAK_GBPS", "1000")
    monkeypatch.setenv("MMTPU_VPU_PEAK_GOPS", "2000")
    p = roofline.chip_peaks("cuda")
    assert p["hbm_gbps"] == 1000.0 and p["vpu_gops"] == 2000.0
    # a capability the table does not hold, or a missing attribute: None
    monkeypatch.setattr(roofline, "_device_attributes",
                        lambda index: dict(H100, capability=(7, 5)))
    assert roofline.chip_peaks("cuda") is None
    short = {k: v for k, v in H100.items() if k != "bus_width_bits"}
    monkeypatch.setattr(roofline, "_device_attributes",
                        lambda index: dict(short))
    assert roofline.chip_peaks("cuda") is None


def test_chip_peaks_is_none_on_the_cpu():
    assert roofline.chip_peaks(torch.device("cpu")) is None
    assert roofline.chip_peaks("cpu") is None
    if not torch.cuda.is_available():
        assert roofline.chip_peaks() is None
        assert mt.utils.stencil_roofline(
            64, 4, 1e-3)["pct_of_hbm_peak"] is None


def test_stencil_roofline_is_the_jax_package_s(h100, monkeypatch):
    # the same peaks on both sides: the port's read from the stubbed card,
    # JAX's from the env overrides its table falls back to
    p = roofline.chip_peaks("cuda")
    monkeypatch.setenv("MMTPU_HBM_PEAK_GBPS", repr(p["hbm_gbps"]))
    monkeypatch.setenv("MMTPU_VPU_PEAK_GOPS", repr(p["vpu_gops"]))
    for grid, itemsize, t, ns, nch in ((16384, 4, 0.641e-3 / 8, 8, 1),
                                       (8192, 2, 1e-4, 16, 2),
                                       (100, 8, 3e-6, 1, 1)):
        mine = roofline.stencil_roofline(grid, itemsize, t, substeps=ns,
                                         nchannels=nch, device="cuda")
        theirs = jroofline.stencil_roofline(grid, itemsize, t,
                                            substeps=ns, nchannels=nch,
                                            device=torch.device("cpu"))
        theirs["device_kind"] = mine["device_kind"]  # the part's name
        assert mine == theirs
    # K1's call at 16384², f32, 8 steps: the bytes of its bound
    r = roofline.stencil_roofline(16384, 4, 1e-4, substeps=8, device="cuda")
    assert r["bytes_per_step"] * 8 == 2 * 16384 * 16384 * 4


def test_device_attributes_read_the_runtime_then_nvidia_smi(monkeypatch):
    """The runtime's answers win; clocks it does not give come from
    nvidia-smi's maximum clocks."""

    class Props:
        name, major, minor, multi_processor_count = "card", 9, 0, 132

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda index: Props())
    monkeypatch.setattr(roofline, "_runtime_attrs",
                        lambda index: {"bus_width_bits": 5120})
    monkeypatch.setattr(roofline, "_smi_clocks", lambda index: {
        "sm_clock_khz": 1_980_000, "mem_clock_khz": 2_619_000})
    a = roofline._device_attributes(0)
    assert a["clock_source"] == "nvidia-smi"
    assert (a["bus_width_bits"], a["sm_clock_khz"]) == (5120, 1_980_000)
    monkeypatch.setattr(roofline, "_runtime_attrs", lambda index: {
        k: H100[k] for k in ("sm_count", "sm_clock_khz", "mem_clock_khz",
                             "bus_width_bits")})
    a = roofline._device_attributes(0)
    assert a["clock_source"] == "cudaDeviceGetAttribute"
    assert a["capability"] == (9, 0)
    monkeypatch.setattr(roofline, "_runtime_attrs", lambda index: {})
    monkeypatch.setattr(roofline, "_smi_clocks", lambda index: {})
    assert roofline.chip_peaks("cuda") is None  # no bus width: no ceiling


# -- the kernel build cache ------------------------------------------------------

def test_configure_compile_cache_repoints_the_build_directory(tmp_path,
                                                              build_dir):
    d = str(tmp_path / "kernels")
    assert cc.configure_compile_cache(d) == d
    assert _build.BUILD_DIR == Path(d) and cc.configured_dir() == d
    assert os.stat(d).st_mode & 0o777 == 0o700
    assert cc.configure_compile_cache(d) == d  # idempotent
    # "off" (and None): a private directory, reused by no other process
    assert cc.configure_compile_cache("off") is None
    private = _build.BUILD_DIR
    assert private.is_dir() and private not in (Path(d),
                                                _build.DEFAULT_BUILD_DIR)
    assert cc.configured_dir() is None
    assert cc.configure_compile_cache(None) is None
    assert _build.BUILD_DIR == private  # one private directory a process
    # "auto" is the package's own _build/
    assert cc.resolve_compile_cache("auto") == cc.default_cache_dir() == \
        str(_build.DEFAULT_BUILD_DIR)
    assert cc.resolve_compile_cache(None) is None
    assert cc.resolve_compile_cache("") is None
    assert cc.resolve_compile_cache(d) == d
    cc.configure_compile_cache(cc.resolve_compile_cache("auto"))
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR


def test_compile_cache_refuses_a_directory_others_may_write(tmp_path,
                                                            build_dir):
    shared = tmp_path / "shared"
    shared.mkdir()
    shared.chmod(0o777)
    with pytest.raises(ValueError, match="writable by group or others"):
        cc.configure_compile_cache(str(shared))
    f = tmp_path / "file"
    f.write_text("")
    with pytest.raises((ValueError, OSError)):
        cc.configure_compile_cache(str(f))
    assert _build.BUILD_DIR != shared  # nothing moved


def test_library_names_hash_the_toolchain(monkeypatch):
    """A build directory kept across an nvcc change never loads a library
    the other compiler built: the version text and the target
    architecture are in every name."""
    monkeypatch.setattr(_build, "_toolchain", "nvcc: release 12.8, V12.8.93")
    a = _build.digest_of("fused_stencil")
    unit = _build.unit_name('#include "field_stencil.cuh"\n')
    monkeypatch.setattr(_build, "_toolchain", "nvcc: release 13.0, V13.0.48")
    assert _build.digest_of("fused_stencil") != a
    assert _build.unit_name('#include "field_stencil.cuh"\n') != unit
    monkeypatch.setattr(_build, "_toolchain", "nvcc: release 12.8, V12.8.93")
    assert _build.digest_of("fused_stencil") == a
    monkeypatch.setattr(_build, "TARGET_ARCH", "sm_100a")
    assert _build.digest_of("fused_stencil") != a
    assert _build.TARGET_ARCH != "sm_90a"


def test_toolchain_without_nvcc_is_a_marker(monkeypatch):
    monkeypatch.setattr(_build, "_toolchain", None)

    def missing():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "find_nvcc", missing)
    assert _build.toolchain() == "no nvcc"
    assert _build.TARGET_ARCH == "sm_90a"
    assert f"code={_build.TARGET_ARCH}" in " ".join(_build.NVCC_FLAGS)


# -- the command line ------------------------------------------------------------

def run_cli(capsys, *argv):
    rc = cli_main(list(argv))
    out, err = capsys.readouterr()
    return rc, out, err


def test_output_and_trace_files(tmp_path, capsys):
    outdir = str(tmp_path / "out")
    trace = str(tmp_path / "trace.json")
    rc, out, err = run_cli(capsys, "run", "--dimx=16", "--dimy=16",
                           "--dtype=float64", f"--output={outdir}",
                           f"--trace={trace}", "--device=cpu", "--json")
    assert rc == 0
    assert any(f.startswith("comm_rank") for f in os.listdir(outdir))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert {"model.execute", "executor.run", "model.report"} <= {
        e["name"] for e in events}
    assert "output written" in err and "trace written" in err
    assert json.loads(out)["trace"] == trace


@pytest.mark.parametrize("extra", [
    ["--mesh=2x2"], ["--ensemble=2"],
    ["--checkpoint-every=1", "--chaos=exc:1"],
])
def test_trace_on_every_path(tmp_path, capsys, extra):
    trace = str(tmp_path / "t.json")
    rc, out, err = run_cli(capsys, "run", "--flow=diffusion", "--dimx=16",
                           "--dimy=16", "--steps=2", "--dtype=float64",
                           f"--trace={trace}", "--device=cpu", "--json",
                           *extra)
    assert rc == 0 and json.loads(out)["trace"] == trace
    names = {e["name"] for e in json.load(open(trace))["traceEvents"]}
    want = {"--mesh=2x2": "shardmap.build", "--ensemble=2": "ensemble.launch",
            "--checkpoint-every=1": "supervise.failure"}[extra[0]]
    assert want in names


def test_info(capsys):
    rc, out, _ = run_cli(capsys, "info", "--json")
    assert rc == 0
    info = json.loads(out)
    assert info["version"] == mt.__version__
    assert info["torch"] == torch.__version__
    assert "chip_peaks" in info and "device_kind" in info
    if not torch.cuda.is_available():
        assert info["chip_peaks"] is None and info["devices"] == ["cpu"]
    lib = info["native_library"]
    assert lib.startswith("unavailable: ") or Path(lib).is_file()


def test_compile_cache_flag(tmp_path, capsys, build_dir):
    d = str(tmp_path / "cache")
    rc, out, _ = run_cli(capsys, "run", "--dimx=16", "--dimy=16",
                         f"--compile-cache={d}", "--device=cpu", "--json")
    assert rc == 0 and _build.BUILD_DIR == Path(d) and Path(d).is_dir()
    rc, _, _ = run_cli(capsys, "run", "--dimx=16", "--dimy=16",
                       "--compile-cache=off", "--device=cpu", "--json")
    assert rc == 0 and _build.BUILD_DIR != Path(d)
    assert cc.configured_dir() is None
    for bad in ("--compile-cache=", "--compile-cache=  "):
        with pytest.raises(SystemExit, match="needs a directory"):
            cli_main(["run", "--dimx=16", "--dimy=16", bad,
                      "--device=cpu"])
    shared = tmp_path / "shared"
    shared.mkdir()
    shared.chmod(0o777)
    with pytest.raises(SystemExit, match="writable by group"):
        cli_main(["run", f"--compile-cache={shared}", "--device=cpu"])


def test_serve_with_status_writes_a_snapshot_that_validates(tmp_path,
                                                            capsys):
    from mpi_model_tpu import obs as jobs
    from mpi_model_tpu_torch import obs
    from mpi_model_tpu_torch.obs import get_recorder, set_recorder

    snap = str(tmp_path / "snap.json")
    trace = str(tmp_path / "serve.json")
    prev = get_recorder()
    try:
        rc, out, _ = run_cli(
            capsys, "run", "--flow=diffusion", "--dimx=16", "--dimy=16",
            "--steps=2", "--serve", "--serve-scenarios=6",
            f"--status={snap}", "--status-interval-s=0.5",
            "--status-port=0", f"--trace={trace}", "--device=cpu",
            "--json")
        assert get_recorder().dump_dir == snap + ".flight.d"
    finally:
        set_recorder(prev)
    row = json.loads(out)
    assert rc == 0 and row["ledger_complete"] and row["served"] == 6
    assert row["telemetry_snapshot"] == snap and row["trace"] == trace
    with open(snap) as fh:
        doc = json.load(fh)
    obs.validate_snapshot(doc)
    jobs.validate_snapshot(doc)
    assert doc["stats"]["scenarios"] == 6
    assert "ensemble.fetch" in {e["name"] for e in
                                json.load(open(trace))["traceEvents"]}
    with pytest.raises(SystemExit, match="must be positive"):
        cli_main(["run", "--serve", "--status-interval-s=0",
                  "--device=cpu"])
    with pytest.raises(SystemExit, match="add --serve"):
        cli_main(["run", f"--status={snap}", "--device=cpu"])
