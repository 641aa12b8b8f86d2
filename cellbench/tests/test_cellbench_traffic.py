"""Seeded inputs and schedules: the same seed gives the same work, another
seed the same sizes and arrivals in another order."""

import itertools

import pytest
import torch

from cellbench import inputs, registry
from cellbench.lanes import pick_order

SEEDS = [0, 7, 2**31 + 9, 2**40 + 3]


@pytest.mark.parametrize("seed", SEEDS)
def test_picks_are_the_seeds_own(seed):
    a = list(itertools.islice(pick_order(seed, 64), 200))
    assert a == list(itertools.islice(pick_order(seed, 64), 200))
    assert sorted(a[:64]) == list(range(64))
    assert sorted(a[64:128]) == list(range(64))
    assert a != list(itertools.islice(pick_order(seed + 1, 64), 200))


@pytest.mark.parametrize("seed", SEEDS)
def test_inputs_repeat_for_a_seed(seed):
    conf = registry.config("field4_f32")
    g1 = inputs.grid(conf, 32, seed, "cpu")
    g2 = inputs.grid(conf, 32, seed, "cpu")
    assert list(g1) == ["a", "b"]
    for k in g1:
        assert torch.equal(g1[k], g2[k]) and g1[k].dtype == torch.float32
        assert 0.5 <= float(g1[k].min()) and float(g1[k].max()) <= 2.0
    assert not torch.equal(g1["a"], g1["b"])
    other = inputs.grid(conf, 32, seed + 1, "cpu")
    assert not torch.equal(g1["a"], other["a"])


def test_pool_states_are_distinct_and_repeat():
    conf = registry.config("moore8_f32")
    p1 = inputs.pool(conf, 16, 8, 5, "cpu")
    p2 = inputs.pool(conf, 16, 8, 5, "cpu")
    totals = {float(p["value"].sum()) for p in p1}
    assert len(totals) == 8
    assert all(torch.equal(a["value"], b["value"]) for a, b in zip(p1, p2))


def test_a_round_is_one_full_dispatch(tmp_path):
    from cellbench import harness

    ctx = harness.execute("moore8.sweep4k", 2**31 + 5, 0.3, False,
                          device="cpu",
                          overrides={"side": 128, "pool": 8, "check_sample": 4},
                          build_dir=str(tmp_path / "build"))
    s0, s1 = ctx.record["stats"]
    rounds = s1["dispatches"] - s0["dispatches"]
    assert rounds >= 1
    assert s1["scenarios"] - s0["scenarios"] == 8 * rounds
    assert ctx.attempted == 8 * rounds and ctx.failed == 0
    assert ctx.checks.ok, ctx.checks.table()
