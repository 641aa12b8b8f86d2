"""The kernel build cache (counterpart of
``mpi_model_tpu/utils/compile_cache.py``).

The JAX package's persistent compilation cache keeps compiled XLA programs
across processes. The port compiles no programs; what a process pays at
start is ``nvcc`` building the kernels' libraries (K1–K7's sources and K4's
generated units) and ``g++`` building the native engine, into the build
directory (``ops/_build.BUILD_DIR``), where each library is named by a hash
of its source, headers, flags and toolchain. That directory is this cache:
a process pointed at a directory that already holds a library loads it
instead of building it.

- ``configure_compile_cache(dir)`` points the build directory at ``dir``
  (created, private to the user, if missing) and returns it;
  ``None``/``""``/``"off"`` points it at a private ``tempfile.mkdtemp``
  directory, removed when the process exits, and returns None: the JAX
  package's "disabled", nothing is reused across processes.
- ``resolve_compile_cache("auto")`` is ``default_cache_dir()``: the
  package's ``_build/``, where the build directory is by default, so
  nothing moves unless asked.

The directory holds shared libraries that the process loads and runs, so
(as the JAX package's rule for its cache) it is the user's own: a directory
given here that another user owns, or that group or others may write, is
refused, and no default is a predictable shared path.
"""

from __future__ import annotations

import atexit
import os
import shutil
import stat
import tempfile
from pathlib import Path
from typing import Optional

#: the directory the cache was last pointed at by configure_compile_cache
_configured: Optional[str] = None
#: the private directory of "off", made at most once a process
_private: Optional[str] = None

#: spellings of "disabled" (the CLI maps "off"/"none" to None first)
_OFF = ("", "off", "none")


def _private_dir() -> str:
    global _private
    if _private is None:
        _private = tempfile.mkdtemp(prefix="mmtpu-kernels-")
        atexit.register(shutil.rmtree, _private, True)
    return _private


def _check_owned(path: str) -> None:
    """Refuse a directory another user owns or others may write: the
    libraries in it are loaded and run."""
    st = os.stat(path)
    if not stat.S_ISDIR(st.st_mode):
        raise ValueError(f"compile cache {path!r} is not a directory")
    if hasattr(os, "getuid") and st.st_uid != os.getuid():
        raise ValueError(
            f"compile cache {path!r} belongs to uid {st.st_uid}, not to "
            "this user: its libraries would be loaded and run")
    if st.st_mode & (stat.S_IWGRP | stat.S_IWOTH):
        raise ValueError(
            f"compile cache {path!r} is writable by group or others "
            f"(mode {stat.S_IMODE(st.st_mode):o}): its libraries would be "
            "loaded and run")


def configure_compile_cache(cache_dir: Optional[str]) -> Optional[str]:
    """Point the kernel build directory at ``cache_dir`` and return it;
    ``None``/empty/``"off"``: a private temporary directory, and None
    (module docstring). Idempotent. Raises ``ValueError`` for a directory
    that is not the user's own."""
    global _configured
    from ..ops import _build

    if cache_dir is None or str(cache_dir).strip().lower() in _OFF:
        _build.BUILD_DIR = Path(_private_dir())
        _configured = None
        return None
    path = os.path.abspath(os.path.expanduser(str(cache_dir)))
    if path != default_cache_dir():
        # the package's own _build/ is made at its first build, as before
        os.makedirs(path, mode=0o700, exist_ok=True)
        _check_owned(path)
    _build.BUILD_DIR = Path(path)
    _configured = path
    return path


def configured_dir() -> Optional[str]:
    """The directory ``configure_compile_cache`` last pointed the cache at
    (None: never, or disabled)."""
    return _configured


def default_cache_dir() -> str:
    """The build directory of ``"auto"``: the package's ``_build/``,
    beside its sources (per checkout, so per user)."""
    from ..ops import _build

    return str(_build.DEFAULT_BUILD_DIR)


def resolve_compile_cache(spec) -> Optional[str]:
    """Map a ``compile_cache`` knob to a directory: ``"auto"`` →
    ``default_cache_dir()``; ``None``/empty → None (disabled); any other
    string → that directory."""
    if spec == "auto":
        return default_cache_dir()
    return spec or None
