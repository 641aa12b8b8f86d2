"""The kernel wrappers' plain-version seam.

Every kernel wrapper of the port (K1/K2, K3/K3-halo, K4/K4-halo, K5,
K6, K7) runs its kernel's plain version when it is given CPU tensors.
It does so through :func:`plain_version`, which tells the registered
observers where that plain version starts and ends. The step audit
(``analysis.step_audit``) is the one observer: the operations inside a
plain version stand for the kernel, as a TPU kernel's body does for a
jaxpr audit that does not descend into a ``pallas_call``. With no
observer the seam calls the plain version and nothing else; a step
never learns whether it is being observed. On the card the kernels are
launched through ctypes, which no dispatcher sees, so the launch path
needs no seam.
"""

from __future__ import annotations

import contextlib
from typing import Callable

#: the observers: objects with ``enter(name)`` and ``exit(name)``
_observers: list = []


def plain_version(name: str, fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)``, the plain version of kernel ``name``,
    between the observers' ``enter(name)`` and ``exit(name)``."""
    for obs in _observers:
        obs.enter(name)
    try:
        return fn(*args, **kwargs)
    finally:
        for obs in reversed(_observers):
            obs.exit(name)


@contextlib.contextmanager
def observing(observer):
    """Register ``observer`` for the duration of the block."""
    _observers.append(observer)
    try:
        yield observer
    finally:
        _observers.remove(observer)
