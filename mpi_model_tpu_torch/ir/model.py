"""FlowIRModel: a Model whose physics is a declarative term list
(counterpart of ``mpi_model_tpu/ir/model.py``).

Where ``Model`` holds the reference's ``Flow`` objects, ``FlowIRModel``
holds IR **terms** (``ir.terms``) and builds every step through the one
registered lowering (``ir.lower``). The executor, ensemble and serving
stack needs no per-model step code:

- **linear models** (every term a uniform ``Transport``) expose an exact
  flows view (one ``Diffusion`` per term), so every kernel path runs them
  unchanged: K1 (``"pallas"``), K3 (``"composed"``), K6/K7
  (``"active_fused"``), K5 (the ensemble's ``"pipeline"``), K2 (sharded
  ``"pallas"``); the dense path they are held to is itself the IR
  Transport lowering (``Model.make_step``'s all-Diffusion dense branch
  runs ``ir.lower.dense_apply``);
- **nonlinear models** (reactions, coupled channels, sources and sinks)
  lower to the dense step (plain torch ops on the card, as the JAX package
  computes them with XLA ops outside any Pallas kernel), the composed path
  at k = 1 (a warning says the taps do not compose) and the active engine,
  whose activity predicate comes from the terms; ``pallas``,
  ``active_fused`` and ``pipeline`` raise (their kernels are
  linear-stencil machines).

Conservation becomes **per-term budget reconciliation**: declared sources
and sinks integrate their signed contribution into hidden ``_b_<term>``
channels during the run, and the check holds (a) each budget's sign to its
contract and (b) the observed total-mass drift to the summed budgets;
violations raise ``ConservationError`` naming the term.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..core.cellular_space import CellularSpace
from ..models.model import ConservationError, Model, \
    default_conservation_rtol
from ..ops.flow import Diffusion
from . import lower
from .terms import Term, Transport, validate_terms

Number = Union[float, np.ndarray]


class FlowIRModel(Model):
    """Orchestrates IR terms over a CellularSpace (see the module
    docstring). ``terms`` is the model; each term's ``rate`` is its
    per-scenario parameter (``with_rates`` rebinds them; the ensemble
    engine ships differing rates as ``[B, T]`` lanes)."""

    def __init__(self, terms: Sequence[Term], time: float = 1.0,
                 time_step: float = 1.0, *,
                 offsets: Optional[Sequence[tuple[int, int]]] = None,
                 active_opts: Optional[dict] = None):
        self.ir_terms: tuple[Term, ...] = validate_terms(terms)
        #: the active engine's plan knobs for nonlinear terms (``tile``,
        #: ``capacity``, ``max_active_frac``: ``ops.active.plan_for``);
        #: linear models take theirs from SerialExecutor(active_opts=...)
        self.active_opts = dict(active_opts) if active_opts else None
        # the exact flows view of a linear model: one Diffusion per uniform
        # Transport term, which routes it onto every kernel path
        rates = lower.uniform_rates(self.ir_terms)
        flows = ([Diffusion(t.rate, attr=t.channel) for t in self.ir_terms]
                 if rates is not None else [])
        super().__init__(flows, time, time_step, offsets=offsets)

    # -- structure ----------------------------------------------------------

    @property
    def ir_linear(self) -> bool:
        """True when every term is a uniform Transport (the flows-view
        family)."""
        return bool(self.flows)

    def term_rates(self) -> tuple[float, ...]:
        return tuple(t.rate for t in self.ir_terms)

    def with_rates(self, rates: Sequence[float]) -> "FlowIRModel":
        """Same structure, new per-term rates (the per-scenario knob)."""
        rates = list(rates)
        if len(rates) != len(self.ir_terms):
            raise ValueError(
                f"{len(rates)} rates for {len(self.ir_terms)} terms")
        return FlowIRModel(
            [t.with_rate(r) for t, r in zip(self.ir_terms, rates)],
            self.time, self.time_step, offsets=self.offsets,
            active_opts=self.active_opts)

    def term_structure(self) -> tuple:
        """Hashable batch-compatibility identity: the terms' structures
        (rates excluded) and the offsets."""
        return (tuple(t.structure() for t in self.ir_terms),
                tuple(self.offsets))

    def _term_fingerprints(self) -> tuple:
        return tuple(t.structure() + (t.rate,) for t in self.ir_terms)

    def pallas_rates(self) -> Optional[dict[str, float]]:
        if self.ir_linear:
            return super().pallas_rates()
        return None  # nonlinear terms need the general lowering

    # -- spaces -------------------------------------------------------------

    def required_channels(self) -> frozenset[str]:
        return lower.involved_channels(self.ir_terms)

    def create_space(self, dim_x: int, dim_y: int,
                     attributes: Optional[Mapping] = None,
                     dtype="float32", **kw) -> CellularSpace:
        """``CellularSpace.create`` plus the model's hidden budget channels
        (zero accumulators for declared sources and sinks). ``device=None``
        (in ``kw``) means the card."""
        attrs = dict(attributes) if attributes is not None else {
            ch: 0.0 for ch in sorted(self.required_channels())
            if not ch.startswith("_b_")}
        for b in lower.budget_channels(self.ir_terms):
            attrs.setdefault(b, 0.0)
        return CellularSpace.create(dim_x, dim_y, attrs, dtype=dtype, **kw)

    def with_budget_channels(self, space: CellularSpace) -> CellularSpace:
        """A copy of ``space`` with any missing budget channels added
        (zeros in the space dtype)."""
        vals = dict(space.values)
        for b in lower.budget_channels(self.ir_terms):
            if b not in vals:
                vals[b] = torch.zeros(space.shape, dtype=space.dtype,
                                      device=space.device)
        return space.with_values(vals)

    def _validate_space(self, space) -> None:
        missing = sorted(self.required_channels() - set(space.values))
        if missing:
            raise ValueError(
                f"space is missing channels {missing} required by the "
                "model's terms (budget accumulators included) — build "
                "spaces with FlowIRModel.create_space, or add them via "
                "with_budget_channels")
        for ch in lower.written_channels(self.ir_terms):
            if not space.values[ch].dtype.is_floating_point:
                raise TypeError(
                    f"IR terms write channel {ch!r}, which requires a "
                    f"floating dtype (got {space.values[ch].dtype}); "
                    "int/bool channels are supported as read-only "
                    "masks/storage")

    def _meta(self, space: CellularSpace) -> lower.StepMeta:
        return lower.StepMeta(
            shape=space.shape, origin=(space.x_init, space.y_init),
            global_shape=space.global_shape, dtype=space.dtype,
            offsets=tuple(self.offsets))

    # -- step construction --------------------------------------------------

    def make_step(self, space: CellularSpace, impl: str = "xla",
                  substeps: int = 1, compute_dtype=None,
                  composed_variant: str = "auto") -> Callable:
        if self.ir_linear:
            # the flows view runs every engine; its dense path is the IR
            # Transport lowering (Model.make_step delegates to it)
            return super().make_step(space, impl=impl, substeps=substeps,
                                     compute_dtype=compute_dtype,
                                     composed_variant=composed_variant)
        if impl in ("pallas", "active_fused", "pipeline"):
            raise ValueError(
                f"impl={impl!r} is a linear-stencil kernel; this model "
                "has nonlinear/coupled terms "
                f"({[t.name for t in self.ir_terms]}). Eligible impls: "
                "'xla'/'auto' (dense lowering), 'composed' (k forced "
                "to 1), 'active' (term-derived activity predicate).")
        if impl not in ("xla", "auto", "composed", "active"):
            raise ValueError(f"unknown step impl {impl!r}")
        substeps = int(substeps)
        if substeps < 1:
            raise ValueError(f"substeps must be >= 1, got {substeps}")
        self._validate_space(space)
        key = ("ir", space.shape, space.global_shape,
               (space.x_init, space.y_init), str(space.dtype),
               str(space.device), self.offsets, impl, substeps,
               self._term_fingerprints(),
               tuple(sorted((self.active_opts or {}).items())))
        cached = self._step_cache.get(key)
        if cached is not None:
            return cached

        meta = self._meta(space)
        rates = self.term_rates()
        single = lower.build_dense_step(self.ir_terms, meta, rates)
        if impl == "composed" and substeps > 1:
            # nonlinear terms do not compose into a k-step tap table (the
            # table is the k-fold power of a linear operator), so every
            # "composed" call iterates k=1 passes
            warnings.warn(
                f"impl='composed' with nonlinear IR terms forces k=1 "
                f"for substeps={substeps}: each call runs iterated "
                "single passes, equaling the dense path. Only linear "
                "all-Transport models compose into the tap table.",
                RuntimeWarning)
        if impl == "active":
            from ..ops.active import plan_for
            opts = dict(self.active_opts or {})
            plan = plan_for(space.shape, tile=opts.get("tile"),
                            capacity=opts.get("capacity"),
                            max_active_frac=opts.get("max_active_frac",
                                                     0.25))
            single = lower.build_active_step(self.ir_terms, meta, rates,
                                             plan, single)

        if substeps == 1:
            step = single
        else:
            def step(values, out=None, _single=single):
                for _ in range(substeps):
                    values = _single(values)
                return values

            step.stats = getattr(single, "stats", None)
            step.plan = getattr(single, "plan", None)
            run1 = getattr(single, "run", None)
            if run1 is not None:
                step.run = lambda values, n: run1(values, n * substeps)
        step.impl = "active" if impl == "active" else (
            "composed" if impl == "composed" else "xla")
        step.substeps = substeps
        step.steppers = {}
        step.field_stepper = None
        step.composed_k = 1 if impl == "composed" else None
        step.composed_passes = substeps if impl == "composed" else None
        step.variant = step.form = None
        self._step_cache[key] = step
        return step

    # -- conservation: per-term budget reconciliation -----------------------

    def conservation_view(self, totals: Mapping[str, Number]
                          ) -> dict[str, Number]:
        """Map raw per-channel totals to the quantities the IR contract
        checks (scalars, or the ensemble's ``[B]`` lanes):

        - ``"mass"``: the summed non-budget totals minus the integrated
          budgets, constant for a correct model;
        - ``"term:<name>"`` per declared source or sink: the
          contract-violating part of its integrated budget (a source gone
          negative, a sink gone positive), zero when honest.

        All-Transport models return the totals unchanged (the per-channel
        contract)."""
        buds = lower.budget_channels(self.ir_terms)
        if not buds and all(isinstance(t, Transport)
                            for t in self.ir_terms):
            return dict(totals)
        mass = None
        for k, v in totals.items():
            if k in buds:
                continue
            mass = v if mass is None else mass + v
        for b in buds:
            mass = mass - totals[b]
        out: dict[str, Number] = {"mass": mass}
        for b, t in buds.items():
            v = totals[b]
            out[f"term:{t.name}"] = (np.minimum(v, 0.0)
                                     if t.conservation == "source"
                                     else np.maximum(v, 0.0))
        return out

    def budget_totals(self, space: CellularSpace) -> dict[str, float]:
        """term name -> integrated budget (host floats): the run's
        reconciled source/sink ledger."""
        return {t.name: float(space.total(b))
                for b, t in lower.budget_channels(self.ir_terms).items()}

    def _raise_if_violated(self, space: CellularSpace,
                           initial: dict, final: dict,
                           tolerance: float, rtol: Optional[float]
                           ) -> None:
        vi = self.conservation_view(initial)
        vf = self.conservation_view(final)
        if rtol is None:
            rtol = default_conservation_rtol(space.shape, space.dtype)
        scale = max(abs(float(t)) for t in initial.values())
        thresh = tolerance + rtol * scale * max(len(initial), 1)
        worst_key, worst = None, -1.0
        for k in vi:
            err = abs(float(vf[k]) - float(vi[k]))
            if not math.isfinite(err):
                worst_key, worst = k, err
                break
            if err > worst:
                worst_key, worst = k, err
        if worst_key is None or (math.isfinite(worst)
                                 and worst <= thresh):
            return
        raise ConservationError(
            self.violation_message(worst_key, worst, thresh))

    def violation_message(self, key: str, err: float,
                          thresh: float) -> str:
        """The one place IR conservation violations are worded: the
        ensemble path uses it too, so serial and batched runs name terms
        alike."""
        if key.startswith("term:"):
            name = key[len("term:"):]
            term = next(t for t in self.ir_terms if t.name == name)
            return (
                f"conservation contract violated by term {name!r}: the "
                f"declared {term.conservation}'s integrated budget ran "
                f"{'negative' if term.conservation == 'source' else 'positive'}"
                f" by {err:.3e} (> {thresh:.3e}) — a "
                f"{term.conservation} must only "
                f"{'add' if term.conservation == 'source' else 'remove'}"
                " mass")
        conserving = [t.name for t in self.ir_terms
                      if t.budget_channel is None]
        return (
            f"per-term budgets do not reconcile: |Δmass − Σ budgets| = "
            f"{err:.3e} > {thresh:.3e} — a conserving term "
            f"({conserving}) leaked mass, or a source/sink moved mass "
            "it did not declare")

    def conservation_error(self, initial: dict, final: dict) -> float:
        """The largest |Δ| over the IR view (raw per-channel drift is
        expected physics for a model with declared sources and sinks)."""
        return super().conservation_error(self.conservation_view(initial),
                                          self.conservation_view(final))

    def conservation_threshold(self, space: CellularSpace,
                               tolerance: float = 1e-3,
                               rtol: Optional[float] = None,
                               initial_totals: Optional[dict] = None
                               ) -> float:
        thresh = super().conservation_threshold(
            space, tolerance, rtol, initial_totals=initial_totals)
        # the reconciliation sums C channel totals and T budgets: each
        # reduction gets its own rounding share
        n = len(space.values) if initial_totals is None \
            else len(initial_totals)
        return thresh * max(n, 1)
