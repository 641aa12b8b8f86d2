"""Roofline accounting: how close a measured step runs to the card's
ceilings (counterpart of ``mpi_model_tpu/utils/roofline.py``).

The JAX package types its peaks in per TPU part. Here ``chip_peaks`` reads
them from the card: its SM count, maximum SM clock, memory clock and memory
bus width, through ``cudaDeviceGetAttribute`` on the CUDA runtime torch has
loaded (``nvidia-smi --query-gpu=clocks.max.sm,clocks.max.memory`` where
the runtime does not answer), times the per-SM, per-clock rates of the
card's compute capability (``SM_RATES``, the only table):

- ``hbm_gbps``: memory clock × 2 (double data rate) × bus width / 8;
- ``vpu_gops``: the f32 peak outside the tensor cores, in Gop/s: SMs × f32
  FMA lanes × 2 × the maximum SM clock (the JAX key, which names a TPU's
  vector unit);
- ``mxu_bf16_tflops`` and ``tf32_tflops``: the dense tensor-core peaks at
  the same clock.

NVIDIA's data sheet quotes the tensor-core peaks of an H100 SXM (989
TFLOP/s bf16) at a lower clock than its f32 peak (67 TFLOP/s at the
maximum SM clock); one clock serves every figure here, and ``sm_clock_mhz``
says which. ``MMTPU_HBM_PEAK_GBPS`` and ``MMTPU_VPU_PEAK_GOPS`` override the
two figures the roofline uses.

``stencil_roofline`` is the JAX package's model unchanged: a fused
``substeps``-step call moves the grid once in and once out (2·bytes a cell
a chunk) and does ``flops_per_cell`` operations a cell a step (11 for the
Moore-8 closed-form interior).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Any, Optional

#: per-SM, per-clock rates by compute capability: f32 FMA lanes outside
#: the tensor cores, and dense tensor-core flops a clock (bf16, TF32)
SM_RATES: dict[tuple[int, int], dict[str, int]] = {
    (8, 0): {"f32_lanes": 64, "bf16_flops": 2048, "tf32_flops": 1024},
    (9, 0): {"f32_lanes": 128, "bf16_flops": 4096, "tf32_flops": 2048},
}

#: ``cudaDeviceAttr`` values (CUDA runtime API)
_ATTR_CLOCK_KHZ = 13
_ATTR_SM_COUNT = 16
_ATTR_MEM_CLOCK_KHZ = 36
_ATTR_BUS_WIDTH = 37


def _cudart():
    """The CUDA runtime torch has loaded (found among the process's mapped
    libraries), else the toolkit's, or None."""
    try:
        with open("/proc/self/maps") as fh:
            paths = sorted({line.split()[-1] for line in fh
                            if "libcudart.so" in line})
    except OSError:
        paths = []
    for p in paths + ["libcudart.so", "/usr/local/cuda/lib64/libcudart.so"]:
        try:
            return ctypes.CDLL(p)
        except OSError:
            continue
    return None


def _runtime_attrs(index: int) -> dict:
    """SM count, clocks (kHz) and bus width (bits) from
    ``cudaDeviceGetAttribute``; attributes the runtime refuses are left
    out."""
    lib = _cudart()
    if lib is None:
        return {}
    fn = lib.cudaDeviceGetAttribute
    fn.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    out = {}
    for key, attr in (("sm_clock_khz", _ATTR_CLOCK_KHZ),
                      ("sm_count", _ATTR_SM_COUNT),
                      ("mem_clock_khz", _ATTR_MEM_CLOCK_KHZ),
                      ("bus_width_bits", _ATTR_BUS_WIDTH)):
        v = ctypes.c_int(0)
        if fn(ctypes.byref(v), attr, int(index)) == 0 and v.value > 0:
            out[key] = v.value
    return out


def _smi_clocks(index: int) -> dict:
    """Maximum SM and memory clocks (kHz) from ``nvidia-smi``, or {}."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", f"--id={index}",
             "--query-gpu=clocks.max.sm,clocks.max.memory",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
        sm, mem = (float(v) for v in proc.stdout.split(","))
    except (OSError, ValueError, subprocess.SubprocessError):
        return {}
    return {"sm_clock_khz": int(sm * 1000), "mem_clock_khz": int(mem * 1000)}


def _device_attributes(index: int) -> dict:
    """What the card at ``index`` reports: ``name``, ``capability``,
    ``sm_count``, ``sm_clock_khz``, ``mem_clock_khz``, ``bus_width_bits``
    and ``clock_source``."""
    import torch

    props = torch.cuda.get_device_properties(index)
    attrs = {"name": props.name, "capability": (props.major, props.minor),
             "sm_count": props.multi_processor_count}
    got = _runtime_attrs(index)
    source = "cudaDeviceGetAttribute"
    if "sm_clock_khz" not in got or "mem_clock_khz" not in got:
        got.update(_smi_clocks(index))
        source = "nvidia-smi"
    attrs.update(got, clock_source=source)
    return attrs


def _cuda_index(device) -> Optional[int]:
    """The CUDA ordinal ``device`` names, or None for another device. None
    means the current card when one is present."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return None
        return torch.cuda.current_device()
    if isinstance(device, int):
        return device
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return 0 if dev.index is None else dev.index


def chip_peaks(device=None) -> Optional[dict[str, Any]]:
    """The card's peaks, read from it (module docstring), with the env
    overrides applied; None on the CPU and for a compute capability
    ``SM_RATES`` does not hold (no ceiling is better than a wrong one)."""
    index = _cuda_index(device)
    if index is None:
        return None
    a = _device_attributes(index)
    rates = SM_RATES.get(tuple(a["capability"]))
    need = ("sm_count", "sm_clock_khz", "mem_clock_khz", "bus_width_bits")
    if rates is None or any(k not in a for k in need):
        return None
    hz = a["sm_clock_khz"] * 1e3
    sms = a["sm_count"]
    peaks: dict[str, Any] = {
        "hbm_gbps": a["mem_clock_khz"] * 1e3 * 2 * a["bus_width_bits"]
        / 8 / 1e9,
        "vpu_gops": sms * rates["f32_lanes"] * 2 * hz / 1e9,
        "mxu_bf16_tflops": sms * rates["bf16_flops"] * hz / 1e12,
        "tf32_tflops": sms * rates["tf32_flops"] * hz / 1e12,
        "sm_count": sms,
        "sm_clock_mhz": a["sm_clock_khz"] / 1e3,
        "mem_clock_mhz": a["mem_clock_khz"] / 1e3,
        "bus_width_bits": a["bus_width_bits"],
        "compute_capability": list(a["capability"]),
        "clock_source": a.get("clock_source"),
    }
    hbm = os.environ.get("MMTPU_HBM_PEAK_GBPS")
    vpu = os.environ.get("MMTPU_VPU_PEAK_GOPS")
    if hbm:
        peaks["hbm_gbps"] = float(hbm)
    if vpu:
        peaks["vpu_gops"] = float(vpu)
    peaks["device_kind"] = a["name"]
    return peaks


def stencil_roofline(grid: int, itemsize: int, t_step_s: float,
                     substeps: int = 1, nchannels: int = 1,
                     flops_per_cell: float = 11.0,
                     device=None) -> dict[str, Any]:
    """Achieved bandwidth and throughput, and their share of the card's
    peaks when ``chip_peaks(device)`` knows them, for one measured stencil
    step of ``t_step_s`` seconds (the time a flow step: with fused calls of
    ``substeps`` steps the bytes amortize over the chunk, the arithmetic
    does not)."""
    cells = float(grid) * float(grid) * nchannels
    bytes_per_step = 2.0 * cells * itemsize / max(1, substeps)
    flops_per_step = flops_per_cell * cells
    out: dict[str, Any] = {
        "bytes_per_step": bytes_per_step,
        "flops_per_step": flops_per_step,
        "achieved_gbps": bytes_per_step / t_step_s / 1e9,
        "achieved_gflops": flops_per_step / t_step_s / 1e9,
        "pct_of_hbm_peak": None,
        "pct_of_compute_peak": None,
        "device_kind": None,
    }
    peaks = chip_peaks(device)
    if peaks is not None:
        out["device_kind"] = peaks["device_kind"]
        out["pct_of_hbm_peak"] = round(
            100.0 * out["achieved_gbps"] / peaks["hbm_gbps"], 1)
        if peaks.get("vpu_gops"):
            out["pct_of_compute_peak"] = round(
                100.0 * out["achieved_gflops"] / peaks["vpu_gops"], 1)
    return out
