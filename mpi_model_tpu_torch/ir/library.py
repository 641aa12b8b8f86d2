"""Built-in Flow IR models: the registry behind ``--model`` (counterpart of
``mpi_model_tpu/ir/library.py``, with the same seeded initial conditions).

Three nonlinear coupled-physics models, plus the linear diffusion model
re-expressed as IR terms (held bit for bit to ``Model([Diffusion])``).
Every builder returns ``(FlowIRModel, CellularSpace)`` with a deterministic
initial condition; keyword arguments override the canonical coefficients
(each is that term's per-scenario ``rate`` lane in the ensemble engine).
``device=None`` puts the space on the card.

The regimes suit a redistribution-style discrete step (``Transport`` sheds
``rate * value`` to the Moore ring, the reference's flow semantics) and
stay bounded over the step counts the tests and ``chip_smoke.py`` run.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core.cellular_space import CellularSpace
from .expr import Chan
from .model import FlowIRModel
from .terms import Sink, Source, Transfer, Transport


def _tensor(a: np.ndarray, like: CellularSpace) -> torch.Tensor:
    """A host f64 array as a channel of ``like`` (its dtype and device)."""
    return torch.from_numpy(a).to(dtype=like.dtype, device=like.device)


def _seeded_blob(dim_x: int, dim_y: int, value: float, frac: float = 8.0,
                 base: float = 0.0) -> np.ndarray:
    """Deterministic centered square patch — the wavefront seed."""
    a = np.full((dim_x, dim_y), base, np.float64)
    hx = max(1, int(dim_x // (2 * frac)))
    hy = max(1, int(dim_y // (2 * frac)))
    cx, cy = dim_x // 2, dim_y // 2
    a[cx - hx:cx + hx + 1, cy - hy:cy + hy + 1] = value
    return a


def diffusion(dim_x: int = 64, dim_y: Optional[int] = None, *,
              rate: float = 0.1, dtype="float32", device=None,
              time: float = 10.0, time_step: float = 1.0):
    """The existing linear model re-expressed as ONE IR term: the
    uniform-rate Moore-8 Transport every step engine hard-coded before
    this subsystem. Bitwise-at-f64 equal to ``Model([Diffusion(rate)])``
    on every impl and executor (``tests/test_torch_ir.py`` holds it)."""
    dim_y = dim_x if dim_y is None else dim_y
    model = FlowIRModel([Transport("value", rate=rate)], time, time_step)
    space = CellularSpace.create(dim_x, dim_y, 0.0, dtype=dtype,
                                 device=device)
    space = space.with_values(
        {"value": _tensor(_seeded_blob(dim_x, dim_y, 1.0), space)})
    return model, space


def gray_scott(dim_x: int = 64, dim_y: Optional[int] = None, *,
               Du: float = 0.16, Dv: float = 0.08, F: float = 0.035,
               k: float = 0.065, dtype="float32", device=None,
               time: float = 64.0, time_step: float = 1.0):
    """Gray-Scott reaction-diffusion: two coupled channels, a cubic
    autocatalytic transfer, a declared feed source and a declared kill
    sink — the canonical pattern-forming workload.

    Terms: ``du = Du·∇u − u·v² + F·(1−u)``, ``dv = Dv·∇v + u·v² −
    (F+k)·v`` with the Laplacian realized as the Moore Transport. The
    feed integrates a non-negative budget, the kill a non-positive one;
    the reconciliation gate checks both and that mass drift equals
    their sum."""
    dim_y = dim_x if dim_y is None else dim_y
    u, v = Chan("u"), Chan("v")
    model = FlowIRModel([
        Transport("u", rate=Du),
        Transport("v", rate=Dv),
        # v is the sparse channel: its factor leads the product so the
        # active engine's derived predicate keys on v's support
        Transfer("u", "v", v ** 2 * u, rate=1.0, name="reaction"),
        Source("u", 1.0 - u, rate=F, name="feed"),
        Sink("v", v, rate=F + k, name="kill"),
    ], time, time_step)
    ub = 1.0 - _seeded_blob(dim_x, dim_y, 0.5)
    vb = _seeded_blob(dim_x, dim_y, 0.25)
    space = model.create_space(dim_x, dim_y, {"u": 0.0, "v": 0.0},
                               dtype=dtype, device=device)
    space = space.with_values({**space.values,
                               "u": _tensor(ub, space),
                               "v": _tensor(vb, space)})
    return model, space


def sir(dim_x: int = 64, dim_y: Optional[int] = None, *,
        beta: float = 0.3, gamma: float = 0.05, Di: float = 0.1,
        dtype="float32", device=None, time: float = 32.0,
        time_step: float = 1.0):
    """Spatial SIR contagion: susceptible/infected/recovered channels,
    infection and recovery as conserving cross-channel Transfers,
    spatial spread as Transport of the infected channel. FULLY
    conserving (population is constant): the gate checks the summed
    S+I+R mass, not per-channel totals (which legitimately migrate).

    The infection amount leads with ``I`` so the active engine's
    term-derived predicate keys on the infected support — tiles far
    from the outbreak are skipped exactly."""
    dim_y = dim_x if dim_y is None else dim_y
    S, I = Chan("S"), Chan("I")
    model = FlowIRModel([
        Transfer("S", "I", I * S, rate=beta, name="infection"),
        Transfer("I", "R", I, rate=gamma, name="recovery"),
        Transport("I", rate=Di, name="mixing"),
    ], time, time_step)
    ib = _seeded_blob(dim_x, dim_y, 0.01, frac=16.0)
    sb = 1.0 - ib
    space = model.create_space(
        dim_x, dim_y, {"S": 0.0, "I": 0.0, "R": 0.0}, dtype=dtype,
        device=device)
    space = space.with_values({**space.values,
                               "S": _tensor(sb, space),
                               "I": _tensor(ib, space)})
    return model, space


def predator_prey(dim_x: int = 64, dim_y: Optional[int] = None, *,
                  alpha: float = 0.08, beta: float = 0.4,
                  delta: float = 0.2, gamma: float = 0.06,
                  Dx: float = 0.1, Dy: float = 0.05,
                  dtype="float32", device=None, time: float = 32.0,
                  time_step: float = 1.0):
    """Spatial Lotka-Volterra: prey growth (declared source), predation
    (declared sink on prey), predator reproduction (declared source fed
    by the same encounter product) and predator mortality (declared
    sink), both species diffusing via Transport. Four budget channels
    reconcile against the observed mass drift; a predation/reproduction
    imbalance is visible as budget signs, not silent drift."""
    dim_y = dim_x if dim_y is None else dim_y
    x, y = Chan("x"), Chan("y")
    model = FlowIRModel([
        Transport("x", rate=Dx, name="prey_mixing"),
        Transport("y", rate=Dy, name="pred_mixing"),
        Source("x", x, rate=alpha, name="growth"),
        Sink("x", x * y, rate=beta, name="predation"),
        Source("y", y * x, rate=delta, name="reproduction"),
        Sink("y", y, rate=gamma, name="mortality"),
    ], time, time_step)
    xb = _seeded_blob(dim_x, dim_y, 1.0, frac=6.0)
    # predators seeded OFF-center so the chase is visible
    yb = np.zeros((dim_x, dim_y), np.float64)
    qx, qy = dim_x // 4, dim_y // 4
    hx, hy = max(1, dim_x // 16), max(1, dim_y // 16)
    yb[qx - hx:qx + hx + 1, qy - hy:qy + hy + 1] = 0.5
    space = model.create_space(dim_x, dim_y, {"x": 0.0, "y": 0.0},
                               dtype=dtype, device=device)
    space = space.with_values({**space.values,
                               "x": _tensor(xb, space),
                               "y": _tensor(yb, space)})
    return model, space


#: the --model registry: name -> builder(dim_x, dim_y, dtype=..., **kw)
MODELS: dict[str, Callable] = {
    "diffusion": diffusion,
    "gray_scott": gray_scott,
    "sir": sir,
    "predator_prey": predator_prey,
}


def build_model(name: str, dim_x: int = 64, dim_y: Optional[int] = None,
                **kw):
    """Build a registered IR model + its seeded space; unknown names
    raise listing the registry (the CLI's flag-surface discipline)."""
    builder = MODELS.get(name)
    if builder is None:
        raise ValueError(
            f"unknown IR model {name!r} (registry: "
            f"{', '.join(sorted(MODELS))})")
    return builder(dim_x, dim_y, **kw)
