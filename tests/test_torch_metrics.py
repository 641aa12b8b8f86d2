"""The port's timing helpers (``utils/metrics.py``) on the CPU: the port of
the JAX package's ``tests/test_benchmarks.py::test_timing_trial_helpers``,
and the helpers' structure against the JAX package's. Every assertion is
about shapes, call order and the dicts returned, never about a time."""

import pytest
import torch

import jax.numpy as jnp

from mpi_model_tpu import utils as jutils

from mpi_model_tpu_torch import utils
from mpi_model_tpu_torch.utils import (interleaved_ab, marginal_runner_time,
                                       marginal_runner_trials,
                                       marginal_step_time,
                                       marginal_step_trials, median_spread,
                                       positive_spread)

NAMES = ("marginal_step_time", "marginal_step_trials", "median_spread",
         "positive_spread", "marginal_runner_time", "marginal_runner_trials",
         "interleaved_ab")


def _step(vals):
    return {"value": vals["value"] * 0.5}


def _v0():
    return {"value": torch.ones((4, 4), dtype=torch.float32)}


def test_timing_trial_helpers():
    """The JAX package's test, on the port's helpers: shapes, medians,
    and the interleaved A/B structure."""
    ms = median_spread([3.0, 1.0, 2.0])
    assert ms == {"value": 2.0, "spread_lo": 1.0, "spread_hi": 3.0}

    calls = []
    ts = marginal_runner_trials(lambda n: calls.append(n), s1=1, s2=2,
                                trials=3)
    assert len(ts) == 3 and calls == [1, 2] * 3  # back-to-back per trial

    samples = marginal_step_trials(_step, _v0(), s1=1, s2=3, trials=2)
    assert len(samples) == 2

    med = interleaved_ab({"a": _step, "b": _step}, _v0(), s1=1, s2=2,
                         reps=2)
    assert set(med) == {"a", "b"}

    ab = interleaved_ab({"a": _step, "b": _step}, _v0(), s1=1, s2=2, reps=3,
                        spread=True)
    assert set(ab) == {"a", "b"}
    for arm in ab.values():
        assert set(arm) == {"value", "spread_lo", "spread_hi"}
        assert arm["spread_lo"] <= arm["value"] <= arm["spread_hi"]


def test_the_helpers_are_exported_under_jax_s_names():
    for name in NAMES:
        assert name in utils.__all__ and name in jutils.__all__
        assert callable(getattr(utils, name))


@pytest.mark.parametrize("samples", [[3.0, 1.0, 2.0], [0.5], [2.0, -1.0,
                                                               4.0, 0.0]])
def test_spread_dicts_are_jax_s(samples):
    assert median_spread(samples) == jutils.median_spread(samples)
    assert positive_spread(samples, 8.0) == jutils.positive_spread(samples,
                                                                   8.0)
    assert positive_spread([-1.0, 0.0], 8.0) == {"lo": None, "hi": None}
    assert positive_spread([2.0, 4.0], 8.0) == {"lo": 2.0, "hi": 4.0}


def test_runner_time_warms_each_length_then_times_reps():
    calls = []
    t = marginal_runner_time(lambda n: calls.append(n), s1=2, s2=5, reps=3)
    assert isinstance(t, float)
    # per length: one warm-up call, then ``reps`` timed ones
    assert calls == [2] * 4 + [5] * 4
    jcalls = []
    jutils.marginal_runner_time(lambda n: jcalls.append(n), s1=2, s2=5,
                                reps=3)
    assert jcalls == calls


def test_step_helpers_call_the_step_s_steps_on_fresh_clones():
    """A length-``s`` run is ``s`` calls of the step; with ``donate`` each
    run starts from a clone, so a step that consumes its input in place
    leaves the caller's values untouched."""
    seen = []

    def consuming(vals):
        seen.append(vals["value"].data_ptr())
        vals["value"].mul_(0.5)
        return vals

    v0 = _v0()
    before = v0["value"].clone()
    t = marginal_step_time(consuming, v0, s1=1, s2=3, reps=2)
    assert isinstance(t, float)
    # two lengths × (one warm-up + two reps) runs of 1 or 3 calls
    assert len(seen) == 3 * 1 + 3 * 3
    assert torch.equal(v0["value"], before)
    assert v0["value"].data_ptr() not in seen
    seen.clear()
    marginal_step_trials(consuming, v0, s1=2, s2=4, trials=3)
    # warm-up of each length, then 3 trials of both
    assert len(seen) == (2 + 4) + 3 * (2 + 4)
    assert torch.equal(v0["value"], before)


def test_without_donate_the_runs_read_the_values_themselves():
    seen = []

    def step(vals):
        seen.append(vals["value"].data_ptr())
        return {"value": vals["value"] * 0.5}

    v0 = _v0()
    marginal_step_time(step, v0, s1=1, s2=2, reps=1, donate=False)
    assert v0["value"].data_ptr() in seen


def test_the_jax_helpers_take_the_same_arguments():
    """The port's signatures are the JAX package's (names, defaults)."""
    import inspect

    for name in NAMES:
        mine = inspect.signature(getattr(utils, name))
        theirs = inspect.signature(getattr(jutils, name))
        assert [(p.name, p.default, p.kind) for p in
                mine.parameters.values()] == [
            (p.name, p.default, p.kind) for p in theirs.parameters.values()
        ], name
    # JAX's own step helper on the same structure, for reference
    v0 = {"value": jnp.ones((4, 4), jnp.float32)}
    assert len(jutils.marginal_step_trials(
        lambda v: {"value": v["value"] * 0.5}, v0, s1=1, s2=2,
        trials=2)) == 2
