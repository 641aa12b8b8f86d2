"""ctypes bridge to the native C++ engine (counterpart of
``mpi_model_tpu/native.py``).

The engine is ``native/src/capi.cpp`` over ``native/include/mmtpu``: the
reference's serial model and its threaded ranks (in-process send/recv halo
exchange, without libmpi), in f64 and f32. ``build_native`` compiles it
with ``g++ -O2 -std=c++17 -shared -fPIC -pthread`` (no cmake) into the
port's build directory (``ops/_build.BUILD_DIR``, the kernel build cache),
as ``libmmtpu-<hash>.so``, the hash over the source, the headers, the flags
and ``g++ --version``; an unchanged engine is loaded, not rebuilt.
``load_library`` checks its ABI (version 2, the typed entry points, the
dtype tags against ``abstraction.DataType``).

``NativeExecutor`` runs a ``Model`` on the engine through the executor
protocol: the space's channels are copied to the host, stepped there, and
copied back to the space's device; the engine's own report (its totals and
conservation error, computed in C++) is ``last_backend_report``. The
``--backend=tpu`` path of ``native/src/main.cpp`` (its embedded
interpreter) runs the JAX package and is not part of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .abstraction import DataType
from .core.cellular_space import CellularSpace
from .ops.flow import Coupled, Diffusion, PointFlow

_REPO_ROOT = Path(__file__).resolve().parent.parent
NATIVE_DIR = _REPO_ROOT / "native"
NATIVE_SOURCE = NATIVE_DIR / "src" / "capi.cpp"
NATIVE_INCLUDE = NATIVE_DIR / "include"
#: the C API's version this bridge speaks (``mmtpu_abi_version``)
ABI_VERSION = 2
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")


class _FlowSpec(ctypes.Structure):
    _fields_ = [
        ("type", ctypes.c_int),
        ("attr", ctypes.c_char_p),
        ("modulator", ctypes.c_char_p),
        ("rate", ctypes.c_double),
        ("x", ctypes.c_int),
        ("y", ctypes.c_int),
        ("has_frozen", ctypes.c_int),
        ("frozen", ctypes.c_double),
    ]


def _compiler_version() -> str:
    proc = subprocess.run(["g++", "--version"], capture_output=True,
                          text=True, timeout=60)
    return proc.stdout.strip()


def library_path() -> Path:
    """Where the engine's library is (or would be) built: named by the hash
    of the source, every header, the flags and the compiler's version."""
    from .ops import _build

    h = hashlib.sha256(NATIVE_SOURCE.read_bytes())
    for hdr in sorted((NATIVE_INCLUDE / "mmtpu").glob("*.hpp")):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode() + b"\0"
             + _compiler_version().encode())
    return Path(_build.BUILD_DIR) / f"libmmtpu-{h.hexdigest()[:16]}.so"


def build_native(force: bool = False) -> str:
    """Build the engine's library unless it is built; returns its path.
    A failed build raises ``RuntimeError`` with the compiler's output; a
    missing compiler raises ``OSError``."""
    out = library_path()
    if out.is_file() and not force:
        return str(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, f"-I{NATIVE_INCLUDE}", "-o", str(tmp),
           str(NATIVE_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed on {NATIVE_SOURCE.name} (exit {proc.returncode}):"
            f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return str(out)


_lib = None


def load_library():
    """The engine's library, built first if needed, its ABI checked."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_native())
    if not hasattr(lib, "mmtpu_space_create_typed"):
        raise RuntimeError(
            "the native library has no typed entry points (ABI v2): it is "
            "not built from native/src/capi.cpp")
    lib.mmtpu_last_error.restype = ctypes.c_char_p
    lib.mmtpu_abi_version.restype = ctypes.c_int
    lib.mmtpu_dtype_tag_float64.restype = ctypes.c_int
    lib.mmtpu_dtype_tag_float32.restype = ctypes.c_int
    lib.mmtpu_space_create_typed.restype = ctypes.c_void_p
    lib.mmtpu_space_create_typed.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int]
    lib.mmtpu_space_dtype.restype = ctypes.c_int
    lib.mmtpu_space_dtype.argtypes = [ctypes.c_void_p]
    lib.mmtpu_space_destroy.restype = None
    lib.mmtpu_space_destroy.argtypes = [ctypes.c_void_p]
    lib.mmtpu_space_channel.restype = ctypes.POINTER(ctypes.c_double)
    lib.mmtpu_space_channel.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.mmtpu_space_channel_f32.restype = ctypes.POINTER(ctypes.c_float)
    lib.mmtpu_space_channel_f32.argtypes = [ctypes.c_void_p,
                                            ctypes.c_char_p]
    lib.mmtpu_space_total.restype = ctypes.c_double
    lib.mmtpu_space_total.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.mmtpu_space_set.restype = ctypes.c_int
    lib.mmtpu_space_set.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_char_p]
    lib.mmtpu_run.restype = ctypes.c_int
    lib.mmtpu_run.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_FlowSpec), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]
    lib.mmtpu_selftest_recv_timeout.restype = ctypes.c_int
    lib.mmtpu_selftest_recv_timeout.argtypes = [ctypes.c_int]
    lib.mmtpu_selftest_typed_wire.restype = ctypes.c_int
    lib.mmtpu_selftest_typed_wire.argtypes = []
    version = lib.mmtpu_abi_version()
    if version != ABI_VERSION:
        raise RuntimeError(f"native ABI version {version}, this bridge "
                           f"speaks {ABI_VERSION}")
    # the engine's dtype tags are abstraction.DataType's values
    for tag, want in ((lib.mmtpu_dtype_tag_float64(), DataType.FLOAT64),
                      (lib.mmtpu_dtype_tag_float32(), DataType.FLOAT32)):
        if tag != int(want):
            raise RuntimeError(f"native dtype tag {tag} != {want!r}")
    _lib = lib
    return lib


def _selftest(rc: int) -> bool:
    if rc == -1:
        raise RuntimeError("native selftest errored: "
                           f"{load_library().mmtpu_last_error().decode()}")
    return rc == 1


def selftest_recv_timeout(timeout_ms: int = 100) -> bool:
    """A bounded receive on a rank nobody sends to raises the engine's
    RecvTimeout (True): a dead rank is detected, not waited on forever."""
    return _selftest(
        load_library().mmtpu_selftest_recv_timeout(int(timeout_ms)))


def selftest_typed_wire() -> bool:
    """An f32 payload received as f64 raises the engine's dtype-mismatch
    error, and the matching type round-trips (True: both held)."""
    return _selftest(load_library().mmtpu_selftest_typed_wire())


def _flow_specs(flows) -> tuple:
    """Flows → the C flow-spec array, and the byte strings it points to."""
    keep = []
    specs = (_FlowSpec * len(flows))()
    for i, f in enumerate(flows):
        attr_b = f.attr.encode()
        keep.append(attr_b)
        s = specs[i]
        s.attr = attr_b
        s.rate = float(f.flow_rate)
        if isinstance(f, PointFlow):
            s.type = 0
            s.x, s.y = f.source_xy
            if f.frozen_source_value is not None:
                s.has_frozen, s.frozen = 1, float(f.frozen_source_value)
        elif isinstance(f, Coupled):
            s.type = 2
            mod_b = f.modulator.encode()
            keep.append(mod_b)
            s.modulator = mod_b
        elif isinstance(f, Diffusion):
            s.type = 1
        else:
            raise TypeError(
                f"native backend supports PointFlow/Diffusion/Coupled, "
                f"got {type(f).__name__}")
    return specs, keep


class NativeSpace:
    """An engine space with zero-copy typed channel views: ``dtype``
    ``"float64"`` (the reference's ``double``) or ``"float32"``; field math
    runs in it, conservation totals accumulate in f64."""

    _DTYPES = {"float64": (DataType.FLOAT64, np.float64),
               "float32": (DataType.FLOAT32, np.float32)}

    def __init__(self, dim_x: int, dim_y: int, init: float = 1.0,
                 attrs: tuple[str, ...] = ("value",),
                 dtype: str = "float64"):
        self._lib = load_library()
        if str(dtype) not in self._DTYPES:
            raise ValueError(
                f"native engine instantiates float32/float64, not {dtype!r}")
        tag, self.np_dtype = self._DTYPES[str(dtype)]
        self.dtype = str(dtype)
        arr = (ctypes.c_char_p * len(attrs))(*[a.encode() for a in attrs])
        self._ptr = self._lib.mmtpu_space_create_typed(
            dim_x, dim_y, float(init), arr, len(attrs), int(tag))
        if not self._ptr:
            raise RuntimeError(self._lib.mmtpu_last_error().decode())
        if self._lib.mmtpu_space_dtype(self._ptr) != int(tag):
            raise RuntimeError("the native space's dtype is not the one "
                               "asked for")
        self.shape = (dim_x, dim_y)
        self.attrs = attrs

    def channel(self, attr: str = "value") -> np.ndarray:
        fn = (self._lib.mmtpu_space_channel if self.dtype == "float64"
              else self._lib.mmtpu_space_channel_f32)
        p = fn(self._ptr, attr.encode())
        if not p:
            raise KeyError(self._lib.mmtpu_last_error().decode())
        return np.ctypeslib.as_array(p, shape=self.shape)

    def set(self, x: int, y: int, v: float, attr: str = "value") -> None:
        if self._lib.mmtpu_space_set(self._ptr, x, y, v, attr.encode()) != 0:
            raise IndexError(self._lib.mmtpu_last_error().decode())

    def total(self, attr: str = "value") -> float:
        return self._lib.mmtpu_space_total(self._ptr, attr.encode())

    def run(self, flows, steps: int, lines: int = 1, columns: int = 1,
            check_conservation: bool = True, tolerance: float = 1e-3) -> dict:
        specs, keep = _flow_specs(flows)
        init_t = ctypes.c_double()
        final_t = ctypes.c_double()
        err = ctypes.c_double()
        rc = self._lib.mmtpu_run(
            self._ptr, specs, len(flows), steps, lines, columns,
            int(check_conservation), tolerance,
            ctypes.byref(init_t), ctypes.byref(final_t), ctypes.byref(err))
        if rc < 0:
            raise RuntimeError(self._lib.mmtpu_last_error().decode())
        report = {"initial_total": init_t.value,
                  "final_total": final_t.value,
                  "conservation_error": err.value,
                  "comm_size": max(1, lines * columns)}
        if rc == 1:
            from .models.model import ConservationError

            raise ConservationError(self._lib.mmtpu_last_error().decode())
        return report

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.mmtpu_space_destroy(self._ptr)
            self._ptr = None


class NativeExecutor:
    """Runs a ``Model`` on the native engine (serial, or ``lines`` ×
    ``columns`` threaded ranks) through the executor protocol. f32 spaces
    run the engine's f32 instantiation; every other dtype its f64 one. The
    channels go to the host and the results back to the space's device, in
    the space's dtype."""

    def __init__(self, lines: int = 1, columns: int = 1):
        self.lines = lines
        self.columns = columns
        #: the engine's own report of the last run (totals and
        #: conservation error computed in C++), surfaced on
        #: ``Report.backend_report``
        self.last_backend_report: Optional[dict] = None

    @property
    def comm_size(self) -> int:
        return max(1, self.lines * self.columns)

    def run_model(self, model, space: CellularSpace,
                  num_steps: int) -> dict:
        native_dtype = ("float32" if space.dtype == torch.float32
                        else "float64")
        ns = NativeSpace(space.dim_x, space.dim_y, 0.0,
                         attrs=tuple(space.values), dtype=native_dtype)
        for attr, v in space.values.items():
            host = v.detach().cpu()
            if host.dtype == torch.bfloat16:  # numpy has no bfloat16
                host = host.float()
            np.copyto(ns.channel(attr), host.numpy().astype(ns.np_dtype))
        self.last_backend_report = ns.run(
            model.flows, num_steps, self.lines, self.columns,
            check_conservation=False)
        self.last_backend_report["engine"] = "native-c++"
        # every channel comes back in the space's dtype, as in the JAX
        # package
        return {attr: torch.from_numpy(ns.channel(attr).copy()).to(
                    device=space.device, dtype=space.dtype)
                for attr in space.values}
