"""Build and load the port's hand-written CUDA kernels.

Each source under ``mpi_model_tpu_torch/csrc/`` compiles with ``nvcc`` into
a shared library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, never at import, and reads only the sources in the
checkout. Libraries go to ``mpi_model_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source and flags, so an edited
source rebuilds and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
#: per-source build record: seconds spent, whether it was cached, and what
#: ptxas said (registers, shared memory, spills)
build_info: dict[str, dict] = {}


def find_nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels are built at first use")


def _compile(src: Path, out: Path) -> str:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


def build_all() -> dict[str, ctypes.CDLL]:
    """Build (or load from the cache) every source under ``csrc/``."""
    return {p.stem: load(p.stem) for p in sorted(CSRC.glob("*.cu"))}


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``, built first if
    needed. Raises if nvcc is missing or the build fails."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    t0 = time.perf_counter()
    ptxas = ""
    cached = out.is_file()
    if not cached:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        ptxas = _compile(src, out)
    lib = ctypes.CDLL(str(out))
    build_info[name] = {"seconds": time.perf_counter() - t0,
                        "cached": cached, "ptxas": ptxas.strip(),
                        "library": str(out)}
    _libs[name] = lib
    return lib
