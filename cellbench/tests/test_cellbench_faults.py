"""The check has to fail what it exists to catch. Each test drives a whole
run of a cell on the CPU at a small size (``harness.execute`` skips the
look for a card), with the timed path broken underneath, and sees
``correct`` come out false; and the controls (the program's bf16 knob, the
reference in bf16 in the program's place) fail too. The cells run on one
card, so no exchange between cards can be left out."""

import pytest
import torch

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch.ops import pipeline_stencil
from cellbench import harness

GRIDS = {"moore8.grid16k": {"side": 64, "warmup_calls": 1},
         "field4.grid8k": {"side": 64, "warmup_calls": 1}}
LANES = {"moore8.sweep4k": {"side": 128, "pool": 8, "check_sample": 6}}
SEED = 2**31 + 77


def run(cell, over, tmp_path, control="none", seconds=0.4):
    return harness.execute(cell, SEED, seconds, False, device="cpu",
                           control=control, overrides=over,
                           build_dir=str(tmp_path / "build"))


@pytest.mark.parametrize("cell", [*GRIDS, *LANES])
def test_a_sound_run_is_correct(cell, tmp_path):
    ctx = run(cell, {**GRIDS, **LANES}[cell], tmp_path)
    assert ctx.checks.ok, ctx.checks.table()
    assert ctx.attempted > 0 and ctx.failed == 0


def _unchanged(self, model, space, num_steps):
    return dict(space.values)


def _altered(orig):
    def run_model(self, model, space, num_steps):
        out = {k: v.clone() for k, v in orig(self, model, space,
                                             num_steps).items()}
        ch = next(iter(out))
        # mass moved between two cells: the program's conservation check
        # cannot see it
        out[ch][3, 5] += 0.5
        out[ch][5, 3] -= 0.5
        return out
    return run_model


@pytest.mark.parametrize("cell", list(GRIDS))
@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_grid_faults_fail(cell, fault, tmp_path, monkeypatch):
    orig = mt.SerialExecutor.run_model
    monkeypatch.setattr(mt.SerialExecutor, "run_model",
                        _unchanged if fault == "unchanged" else _altered(orig))
    ctx = run(cell, GRIDS[cell], tmp_path)
    assert not ctx.checks.ok
    assert ctx.checks.values["state_err"] > ctx.checks.limits["state_err"]


def _lane_fault(kind):
    orig = pipeline_stencil.pipeline_dense_step

    def step(cur, *a, **k):
        if kind == "unchanged":
            return cur.clone()
        out = orig(cur, *a, **k)
        if kind == "half_batch":
            half = cur.shape[0] // 2
            out[half:] = cur[half:]
        else:
            out[..., 7, 9] += 0.5
            out[..., 9, 7] -= 0.5
        return out
    return step


@pytest.mark.parametrize("cell", list(LANES))
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_lane_faults_fail(cell, fault, tmp_path, monkeypatch):
    monkeypatch.setattr(pipeline_stencil, "pipeline_dense_step",
                        _lane_fault(fault))
    ctx = run(cell, LANES[cell], tmp_path)
    assert not ctx.checks.ok
    assert ctx.checks.values["state_err"] > ctx.checks.limits["state_err"]


def test_a_lane_handed_to_another_ticket_fails(tmp_path, monkeypatch):
    from mpi_model_tpu_torch.ensemble import scheduler

    orig = scheduler.EnsembleScheduler._complete_batch

    def swapped(self, flight):
        results, err, hit, wall = orig(self, flight)
        if results is not None and len(results) > 1:
            results = results[1:] + results[:1]
        return results, err, hit, wall
    monkeypatch.setattr(scheduler.EnsembleScheduler, "_complete_batch",
                        swapped)
    ctx = run("moore8.sweep4k", LANES["moore8.sweep4k"], tmp_path)
    assert not ctx.checks.ok
    assert ctx.checks.values["ticket_total_err"] > \
        ctx.checks.limits["ticket_total_err"]


@pytest.mark.parametrize("cell", [*GRIDS, *LANES])
def test_reference_in_bf16_fails(cell, tmp_path):
    ctx = run(cell, {**GRIDS, **LANES}[cell], tmp_path,
              control="reference_bf16")
    assert not ctx.checks.ok
    assert ctx.checks.values["state_err"] > \
        3 * ctx.checks.limits["state_err"]


def test_program_bf16_knob_fails(tmp_path):
    # 1024² holds closed interior tiles, where K1's knob computes in bf16
    over = {**GRIDS["moore8.grid16k"], "side": 1024, "steps": 8}
    ctx = run("moore8.grid16k", over, tmp_path, control="program_bf16",
              seconds=0.05)
    assert not ctx.checks.ok
    assert ctx.checks.values["state_err"] > \
        3 * ctx.checks.limits["state_err"]


def test_program_bf16_knob_breaks_config4s_conservation(tmp_path):
    # K4's knob moves more mass than Model.execute's check allows at
    # 2048²: the control stops at the program's own check, in set-up
    over = {**GRIDS["field4.grid8k"], "side": 2048, "steps": 8}
    with pytest.raises(mt.ConservationError):
        run("field4.grid8k", over, tmp_path, control="program_bf16",
            seconds=0.05)


def test_a_call_that_raises_is_an_answer_missing(tmp_path, monkeypatch):
    orig = mt.SerialExecutor.run_model
    calls = []

    def fails_in_the_window(self, model, space, num_steps):
        calls.append(1)
        if len(calls) > 2:
            raise RuntimeError("kernel launch failed")
        return orig(self, model, space, num_steps)
    monkeypatch.setattr(mt.SerialExecutor, "run_model", fails_in_the_window)
    ctx = run("moore8.grid16k", GRIDS["moore8.grid16k"], tmp_path)
    assert not ctx.checks.ok and ctx.failed == 1
    assert ctx.checks.values["answers_missing"] == 1


def test_changed_inputs_are_caught(tmp_path, monkeypatch):
    orig = mt.EnsembleService.submit

    def writes_input(self, space, **kw):
        ticket = orig(self, space, **kw)
        space.values["value"][0, 0] += 1.0
        return ticket
    monkeypatch.setattr(mt.EnsembleService, "submit", writes_input)
    ctx = run("moore8.sweep4k", LANES["moore8.sweep4k"], tmp_path)
    assert not ctx.checks.ok
    assert ctx.checks.values["pool_changed"] > 0


@pytest.mark.cuda
def test_controls_fail_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    over = {**GRIDS["moore8.grid16k"], "side": 2048}
    sound = harness.execute("moore8.grid16k", SEED, 0.5, False,
                            device="cuda", overrides=over,
                            build_dir=str(tmp_path / "build"))
    assert sound.checks.ok, sound.checks.table()
    low = harness.execute("moore8.grid16k", SEED, 0.5, False,
                          device="cuda", control="program_bf16",
                          overrides=over, build_dir=str(tmp_path / "build"))
    assert not low.checks.ok
