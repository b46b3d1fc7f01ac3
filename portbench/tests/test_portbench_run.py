"""Whole runs of each cell, the pending learned cell included, on the CPU at
a small size: the result line, the traced run, and ``correct`` coming out
false with the timed path broken underneath (the check for a chip
skipped), and for the control."""
import dataclasses
import json

import pytest
import torch

from portbench import control, run, spec

CELLS = ("point2d.b10240", "learned2d.b1024")
CPU = torch.device("cpu")


def small(name, batch=16):
    cell = spec.cell(name, bench=spec.with_pending())
    cell.traffic.update(batch=batch, worlds=4, pairs_per_world=4)
    cell.settings.update(warmup_calls=1, trace_calls=1, check_problems=64,
                         check_block=32)
    cell.config["optim_params"]["max_iters"] = 20  # not the batch: axes differ
    return cell


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct_and_well_formed(name):
    cell = small(name)
    result, compared = run.execute(cell, 2**31 + 7, 0.0, False, CPU)
    assert result["correct"], compared
    assert list(result)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert result["attempted"] >= cell.traffic["batch"]
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    for k, v in result["compared"].items():
        assert v["value"] <= v["limit"]
    json.dumps(result)


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_is_correct(name):
    result, _ = run.execute(small(name), 3, 0.0, True, CPU)
    assert result["correct"]
    assert "breakdown" in result and "busy_s" in result["device"]
    # The CPU runs no device operation: the trace readers find nothing.
    assert set(result["metrics"]) <= {
        m["name"] for m in spec.cell(name, bench=spec.with_pending()).per_layer}


def _state_unchanged(monkeypatch):
    from dgpmp2_tpu_torch.ops import tridiag

    monkeypatch.setattr(tridiag, "btd_solve_auto",
                        lambda diag, off, rhs: torch.zeros_like(rhs))


def _wrap_plan(monkeypatch, change):
    """Break the entry's outputs: ``change(outputs)`` where ``outputs`` is
    what the planner's ``plan`` returns."""
    from dgpmp2_tpu_torch.learn.learned_planner import LearnedDiffGPMP2Planner
    from dgpmp2_tpu_torch.planner import DiffGPMP2Planner

    for cls in (DiffGPMP2Planner, LearnedDiffGPMP2Planner):
        orig = cls.plan

        def plan(self, *a, _orig=orig, **k):
            return change(_orig(self, *a, **k))

        monkeypatch.setattr(cls, "plan", plan)


def _half_left_out(monkeypatch):
    """The second half of the batch gets the first half's answers."""
    def change(out):
        b = out[0].shape[0]

        def half(x):
            if not isinstance(x, torch.Tensor):
                return x
            axis = 0 if x.shape[0] == b else 1  # error traces: (iters, B)
            x = x.clone()
            x.narrow(axis, b // 2, b // 2).copy_(x.narrow(axis, 0, b // 2))
            return x
        return type(out)(*map(half, out)) if hasattr(out, "_fields") \
            else tuple(map(half, out))
    _wrap_plan(monkeypatch, change)


def _answer_altered(monkeypatch):
    """One state of one returned trajectory moved 0.3 m."""
    def change(out):
        th = out[0].clone()
        th[0, th.shape[1] // 2, 0] += 0.3
        if hasattr(out, "_replace"):
            return out._replace(th=th)
        return (th, *out[1:])
    _wrap_plan(monkeypatch, change)


def _loop_cut(monkeypatch):
    """The loop stops after its first iteration; the error traces are
    padded with their last row to the configured length."""
    from dgpmp2_tpu_torch.learn.learned_planner import LearnedDiffGPMP2Planner
    from dgpmp2_tpu_torch.planner import DiffGPMP2Planner

    def pad(x, n):
        return torch.cat([x, x[-1:].expand(n - x.shape[0], *x.shape[1:])])

    plan_2d = DiffGPMP2Planner.plan

    def plan(self, *a, **k):
        cfg = self.cfg
        self.cfg = dataclasses.replace(cfg, max_iters=1)
        try:
            out = plan_2d(self, *a, **k)
        finally:
            self.cfg = cfg
        return out._replace(err_per_iter=pad(out.err_per_iter, cfg.max_iters),
                            err_ext_per_iter=pad(out.err_ext_per_iter,
                                                 cfg.max_iters))

    plan_learned = LearnedDiffGPMP2Planner.plan

    def learned(self, *a, max_iters=None, **k):
        th, errs, errs_ext, *rest = plan_learned(self, *a, max_iters=1, **k)
        return (th, pad(errs, max_iters), pad(errs_ext, max_iters), *rest)

    monkeypatch.setattr(DiffGPMP2Planner, "plan", plan)
    monkeypatch.setattr(LearnedDiffGPMP2Planner, "plan", learned)


FAULTS = {"loop_cut": _loop_cut,
          "state_unchanged": _state_unchanged,
          "half_left_out": _half_left_out,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result, compared = run.execute(small(name), 2**31 + 7, 0.0, False, CPU)
    assert not result["correct"], compared


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The reference in bfloat16 in the program's place, at a size a test
    run can hold (the chip's readings are in PERF.md)."""
    cell = small(name, batch=16)
    got = control.read(cell, 2**31 + 11, torch.bfloat16, CPU)
    assert not got["correct"], got
