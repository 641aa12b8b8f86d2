"""The plain reference against the port, through ``Model.execute`` and
``execute_many`` with ``impl="xla"``, at 64² on the CPU, in float64 (the
two sum in other orders, so they agree to rounding, not bit for bit)."""

import pytest
import torch

import mpi_model_tpu_torch as mt
from cellbench import inputs, program, registry
from cellbench.reference import Reference, stated_rate

CONFS = ["moore8_f32", "field4_f32"]


def f64(conf):
    return {**registry.config(conf), "storage_dtype": "float64"}


@pytest.mark.parametrize("conf", CONFS)
@pytest.mark.parametrize("steps", [1, 13])
def test_reference_matches_model_execute(conf, steps):
    c = f64(conf)
    values = inputs.grid(c, 64, 3, "cpu")
    model = program.build_model(mt, c)
    out, rep = model.execute(program.space(mt, values),
                             mt.SerialExecutor("xla"), steps=steps)
    ref = Reference(c)
    want = ref.run(values, steps)
    for ch, w in want.items():
        assert torch.allclose(out.values[ch], w, rtol=0, atol=1e-13)
    assert rep.final_total == pytest.approx(ref.totals(want), rel=1e-13)
    assert rep.last_execute == pytest.approx(ref.outflow_sums(want),
                                             rel=1e-13)


@pytest.mark.parametrize("conf", CONFS)
def test_reference_matches_execute_many(conf):
    c = f64(conf)
    pool = inputs.pool(c, 64, 3, 4, "cpu")
    model = program.build_model(mt, c)
    got = model.execute_many([program.space(mt, v) for v in pool],
                             executor=mt.EnsembleExecutor("xla"), steps=8)
    ref = Reference(c)
    for (space, rep), v in zip(got, pool):
        want = ref.run(v, 8)
        for ch, w in want.items():
            assert torch.allclose(space.values[ch], w, rtol=0, atol=1e-13)
        assert rep.initial_total == pytest.approx(ref.totals(v), rel=1e-13)


def test_reference_conserves_and_counts_neighbours():
    c = registry.config("moore8_f32")
    ref = Reference(c)
    cnt = ref.counts((5, 6), "cpu")
    assert cnt[0, 0] == 3 and cnt[0, 3] == 5 and cnt[2, 3] == 8
    v = inputs.grid(c, 33, 1, "cpu")
    out = ref.run(v, 20)
    assert ref.totals(out)["value"] == pytest.approx(
        ref.totals(ref.cast(v))["value"], rel=1e-14)


def test_rates_are_the_storage_dtypes():
    c = registry.config("moore8_f32")
    assert stated_rate(0.1, c) == float(torch.tensor(0.1))
    assert stated_rate(0.1, f64("moore8_f32")) == 0.1
