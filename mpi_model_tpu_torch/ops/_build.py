"""Build and load the port's hand-written CUDA kernels.

Each source under ``mpi_model_tpu_torch/csrc/`` compiles with ``nvcc`` into
a shared library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, never at import, and reads only the sources in the
checkout. Libraries go to ``mpi_model_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source, every ``csrc/*.cuh`` header
it includes (directly or through another header) and its flags, so an edited
source or shared header rebuilds and an unchanged one is reused.

``SOURCE_FLAGS`` adds flags per source: every source builds with FMA
contraction off (``fused_stencil.cu``, K1/K2; ``composed_stencil.cu``,
K3's vpu form; ``fused_active.cu``, K6/K7; ``field_stencil.cu``, K4;
``pipeline_stencil.cu``, K5: each must equal its plain version bit for
bit). ``build_all`` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: extra nvcc flags per source (by file stem)
SOURCE_FLAGS: dict[str, tuple[str, ...]] = {
    "fused_stencil": ("--fmad=false",),
    "composed_stencil": ("--fmad=false",),
    "fused_active": ("--fmad=false",),
    "field_stencil": ("--fmad=false",),
    "pipeline_stencil": ("--fmad=false",),
}

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

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


def flags_for(name: str) -> tuple[str, ...]:
    """The nvcc flags of ``csrc/<name>.cu``: the common ones, then its own."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def local_headers(src: Path) -> list[Path]:
    """Every ``csrc`` header ``src`` includes with quotes, transitively, in
    first-seen order. A quoted include that is not in ``csrc`` raises: the
    build reads nothing outside the checkout's sources."""
    seen: list[Path] = []
    todo = [src]
    while todo:
        for inc in _INCLUDE.findall(todo.pop().read_text()):
            path = CSRC / inc
            if not path.is_file():
                raise RuntimeError(f"{src.name} includes {inc!r}, which is "
                                   f"not a file under {CSRC}")
            if path not in seen:
                seen.append(path)
                todo.append(path)
    return seen


def digest_of(name: str) -> str:
    """Hash of the source, its local headers and its flags."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in local_headers(src):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(flags_for(name)).encode())
    return h.hexdigest()[:16]


def _library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{digest_of(name)}.so"


def _compile(name: str, out: Path) -> str:
    src = CSRC / f"{name}.cu"
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *flags_for(name), "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


def _build(name: str) -> None:
    """Compile ``name`` unless its library is cached; record the build."""
    out = _library_path(name)
    t0 = time.perf_counter()
    cached = out.is_file()
    ptxas = ""
    if not cached:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        ptxas = _compile(name, out)
    build_info[name] = {"seconds": time.perf_counter() - t0,
                        "cached": cached, "ptxas": ptxas.strip(),
                        "library": str(out)}


def build_all() -> dict[str, ctypes.CDLL]:
    """Build (or take from the cache) every source under ``csrc/``, one
    ``nvcc`` per source started together, then load them all."""
    names = [p.stem for p in sorted(CSRC.glob("*.cu"))]
    todo = [n for n in names if n not in _libs]
    if todo:
        with ThreadPoolExecutor(max_workers=len(todo)) as pool:
            for fut in [pool.submit(_build, n) for n in todo]:
                fut.result()
    return {n: load(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``, built first if
    needed. Raises if nvcc is missing or the build fails."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    if name not in build_info or not Path(
            build_info[name]["library"]).is_file():
        _build(name)
    lib = ctypes.CDLL(build_info[name]["library"])
    _libs[name] = lib
    return lib
