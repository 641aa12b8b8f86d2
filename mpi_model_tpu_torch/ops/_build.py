"""Build and load the port's hand-written CUDA kernels.

Each source under ``mpi_model_tpu_torch/csrc/`` compiles with ``nvcc`` into
a shared library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, never at import, and reads only the sources in the
checkout. Libraries go to ``mpi_model_tpu_torch/_build/`` (listed in
``.gitignore``; ``utils.compile_cache.configure_compile_cache`` points
``BUILD_DIR`` elsewhere), named by a hash of the source, every
``csrc/*.cuh`` header it includes (directly or through another header), its
flags, the ``nvcc --version`` text and the target architecture, so an edited
source or shared header, or another toolchain, rebuilds and an unchanged
one is reused.

``SOURCE_FLAGS`` adds flags per source: every source builds with FMA
contraction off (``fused_stencil.cu``, K1/K2; ``composed_stencil.cu``,
K3's vpu form; ``fused_active.cu``, K6/K7; ``pipeline_stencil.cu``, K5:
each must equal its plain version bit for bit). ``build_all`` starts one
``nvcc`` per source, all at once.

Generated units (K4: one per lowered flow set, ``ops/field_codegen.py``)
build the same way from their text: ``build_unit`` writes the text into the
build directory and compiles it there against the ``csrc`` headers it
includes, with ``UNIT_FLAGS`` (FMA contraction off: K4 equals its plain
version bit for bit). The library's name hashes the text, those headers and
the flags, so identical programs share one library across processes and
runs. ``build_all`` takes units too, and builds them beside the sources.
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
from typing import Optional

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
#: where libraries are built by default; ``BUILD_DIR`` is where they are
#: built now (``utils.compile_cache.configure_compile_cache`` re-points it)
DEFAULT_BUILD_DIR = PKG / "_build"
BUILD_DIR = DEFAULT_BUILD_DIR

#: the architecture every library is built for (Hopper, with its
#: architecture-specific features)
TARGET_ARCH = "sm_90a"
NVCC_FLAGS = ("-gencode",
              f"arch=compute_{TARGET_ARCH[3:]},code={TARGET_ARCH}",
              "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
#: extra nvcc flags per source (by file stem)
SOURCE_FLAGS: dict[str, tuple[str, ...]] = {
    "fused_stencil": ("--fmad=false",),
    "composed_stencil": ("--fmad=false",),
    "fused_active": ("--fmad=false",),
    "pipeline_stencil": ("--fmad=false",),
}

#: extra nvcc flags of every generated unit
UNIT_FLAGS: tuple[str, ...] = ("--fmad=false",)
#: the file stem of generated units and their libraries
UNIT_STEM = "k4_field"

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_libs: dict[str, ctypes.CDLL] = {}
#: per-source build record: seconds spent, whether it was cached, and what
#: ptxas said (registers, shared memory, spills)
build_info: dict[str, dict] = {}


class KernelError(RuntimeError):
    """A hand-written kernel failed to build, load or launch (or its
    library disagrees with its wrapper). The ensemble's degradation ladder
    never steps on one: it reaches the caller as itself."""


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
    raise KernelError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels are built at first use")


def flags_for(name: str) -> tuple[str, ...]:
    """The nvcc flags of ``csrc/<name>.cu``: the common ones, then its own."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def local_headers(src: Path) -> list[Path]:
    """Every ``csrc`` header ``src`` includes with quotes, transitively, in
    first-seen order. A quoted include that is not in ``csrc`` raises: the
    build reads nothing outside the checkout's sources."""
    return _headers_of(src.read_text(), src.name)


def _headers_of(text: str, what: str) -> list[Path]:
    seen: list[Path] = []
    todo = [text]
    while todo:
        for inc in _INCLUDE.findall(todo.pop()):
            path = CSRC / inc
            if not path.is_file():
                raise KernelError(f"{what} includes {inc!r}, which is "
                                   f"not a file under {CSRC}")
            if path not in seen:
                seen.append(path)
                todo.append(path.read_text())
    return seen


def digest_of(name: str) -> str:
    """Hash of the source, its local headers and its flags."""
    src = CSRC / f"{name}.cu"
    return _digest(src.read_bytes(), local_headers(src), flags_for(name))


_toolchain: Optional[str] = None


def toolchain() -> str:
    """What ``nvcc --version`` prints (read once a process), or a marker
    when there is no nvcc: part of every library's name, so a build
    directory shared or kept across a toolchain change never loads a
    library another compiler built."""
    global _toolchain
    if _toolchain is None:
        try:
            proc = subprocess.run([find_nvcc(), "--version"],
                                  capture_output=True, text=True,
                                  timeout=120)
            _toolchain = proc.stdout.strip() or proc.stderr.strip()
        except (RuntimeError, OSError, subprocess.SubprocessError):
            _toolchain = "no nvcc"
    return _toolchain


def _digest(text: bytes, headers: list[Path], flags: tuple[str, ...]) -> str:
    """Hash of a source's text, its headers, its flags, the toolchain and
    the target architecture."""
    h = hashlib.sha256(text)
    for hdr in headers:
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(flags).encode())
    h.update(b"\0" + toolchain().encode() + b"\0" + TARGET_ARCH.encode())
    return h.hexdigest()[:16]


def unit_flags() -> tuple[str, ...]:
    """The nvcc flags of a generated unit (its include path aside)."""
    return NVCC_FLAGS + UNIT_FLAGS


def unit_name(text: str) -> str:
    """A generated unit's name: ``UNIT_STEM`` and the hash of its text,
    the ``csrc`` headers it includes and its flags."""
    digest = _digest(text.encode(), _headers_of(text, "a generated unit"),
                     unit_flags())
    return f"{UNIT_STEM}-{digest}"


def _library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{digest_of(name)}.so"


def _compile(src: Path, flags: tuple[str, ...], out: Path,
             what: str) -> str:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *flags, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelError(
            f"nvcc failed on {what} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


def _build(name: str) -> None:
    """Compile ``name`` unless its library is cached; record the build."""
    src = CSRC / f"{name}.cu"
    _record(name, _library_path(name), lambda out: _compile(
        src, flags_for(name), out, src.name))


def _record(name: str, out: Path, compile_to) -> None:
    t0 = time.perf_counter()
    cached = out.is_file()
    ptxas = ""
    if not cached:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        ptxas = compile_to(out)
    build_info[name] = {"seconds": time.perf_counter() - t0,
                        "cached": cached, "ptxas": ptxas.strip(),
                        "library": str(out)}


def build_unit(text: str, label: str = "") -> str:
    """Compile a generated unit unless its library is cached; record the
    build under the unit's name and return the name. The text goes into
    the build directory and compiles there against ``csrc``; a failed
    build raises naming ``label`` (the flow set)."""
    name = unit_name(text)
    if name in build_info and Path(build_info[name]["library"]).is_file():
        return name

    def compile_to(out: Path) -> str:
        src = BUILD_DIR / f"{name}.cu"
        if not src.is_file():
            tmp = src.with_suffix(f".{os.getpid()}.tmp")
            tmp.write_text(text)
            os.replace(tmp, src)
        return _compile(src, unit_flags() + ("-I", str(CSRC)), out,
                        f"the field kernel of {label or name}")

    _record(name, BUILD_DIR / f"lib{name}.so", compile_to)
    return name


def build_all(units: tuple[tuple[str, str], ...] = ()
              ) -> dict[str, ctypes.CDLL]:
    """Build (or take from the cache) every source under ``csrc/`` and
    every generated unit of ``units`` (``(text, label)`` pairs), one
    ``nvcc`` each, all started together, then load them all (keyed by
    source stem or unit name)."""
    names = [p.stem for p in sorted(CSRC.glob("*.cu"))]
    todo = [n for n in names if n not in _libs]
    distinct = {unit_name(text): (text, label) for text, label in units}
    with ThreadPoolExecutor(max_workers=max(1, len(todo) + len(distinct))
                            ) as pool:
        futs = [pool.submit(_build, n) for n in todo]
        futs += [pool.submit(build_unit, text, label)
                 for text, label in distinct.values()]
        for fut in futs:
            fut.result()
    libs = {n: load(n) for n in names}
    libs.update({n: load_unit(n) for n in distinct})
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``, built first if
    needed. Raises if nvcc is missing or the build fails."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    if name not in build_info or not Path(
            build_info[name]["library"]).is_file():
        _build(name)
    lib = _open(build_info[name]["library"])
    _libs[name] = lib
    return lib


def _open(path: str) -> ctypes.CDLL:
    try:
        return ctypes.CDLL(path)
    except OSError as e:
        raise KernelError(f"{path} failed to load: {e}") from e


def load_unit(name: str) -> ctypes.CDLL:
    """The loaded library of a generated unit that ``build_unit`` built
    (by the name it returned)."""
    lib = _libs.get(name)
    if lib is None:
        lib = _open(build_info[name]["library"])
        _libs[name] = lib
    return lib
