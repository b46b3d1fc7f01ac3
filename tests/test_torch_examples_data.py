"""dgpmp2_tpu_torch.examples' data and learning examples and the workflow
scripts ``dgpmp2_tpu_torch/scripts/*.sh``, on the CPU in float64.

Each example runs once through its ``main`` (datasets written by the
port's generator into a temporary directory) and must return finite
numbers, lower each problem's error and draw its figure.  The
multi-dataset example's task loss and its gradient with respect to
``Q_c⁻¹`` through the unrolled plan are held against the JAX package's
``gn.plan`` under ``jax.value_and_grad``, reading the same datasets with
the JAX package's reader, to 1e-8 relative.  The learned-vs-static example
is run with its head decoded in float64 (``chip_smoke.decode_in_float64``;
the shipped planner, as JAX's, casts the head's output to float32 first,
which alone puts the plans ~1e-6 apart): at the static initialisation the
learned plan must then equal the static ``gn.plan`` to 1e-10.  The four
scripts run in a chain through ``bash`` at a tiny size (6 + 2 worlds at
32², T=8, one epoch) and ``report_stats_example`` reads what
``test_planner`` wrote.  ``chip_smoke.py`` phase 17's launch formulas are
held on the CPU for one example of each kind of path, the kernel wrappers
counting their plain versions.
"""
import contextlib
import io
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from dgpmp2_tpu import robots as jr
from dgpmp2_tpu.core import gn as jgn
from dgpmp2_tpu.core import graph as jg
from dgpmp2_tpu.data import dataset as jds

from tests._torch_examples import (check_plans, count_plain_launches, module,
                                   np_, run)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data_dir():
    with tempfile.TemporaryDirectory(prefix="dgpmp2_examples_data_") as d:
        yield d


@pytest.fixture(scope="module")
def multi(data_dir):
    return run("diff_gpmp2_multi_dataset_example", "--data_dir", data_dir)


@pytest.fixture(scope="module")
def learned():
    """learned_vs_static, its head decoded in float64."""
    m = module("learned_vs_static_example")
    orig = m.learned_planner

    def planner(dev, dtype):
        p = orig(dev, dtype)
        chip_smoke.decode_in_float64(p)
        return p

    m.learned_planner = planner
    try:
        return run("learned_vs_static_example")
    finally:
        m.learned_planner = orig


def test_dataset_loading_plans_on_the_cpu():
    out = run("dataset_loading_example")
    assert out["problems"] == 6
    check_plans("dataset_loading_example", out)


def test_multi_dataset_plans_on_the_cpu(multi):
    assert multi["problems"] == 8
    check_plans("diff_gpmp2_multi_dataset_example", multi)


def test_multi_dataset_loss_and_gradient_match_jax(multi, data_dir):
    m = module("diff_gpmp2_multi_dataset_example")
    dset = jds.PlanningDatasetMulti(
        [f"{data_dir}/{f}" for f in m.FAMILIES], mode="train")
    batch = next(jds.as_batches(dset, np.arange(len(dset)),
                                batch_size=len(dset)))
    b = {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()}
    spec = jg.GraphSpec(total_time_step=m.T)
    robot = jr.PointRobot2D()
    cfg = jgn.OptimConfig(engine="standard", reg=0.1,
                          max_iters=m.CFG.max_iters, tol_delta=0.0)
    th0 = jnp.asarray(np_(m.straight_line_traj(
        torch.tensor(batch["start"][:, :2], dtype=torch.float64),
        torch.tensor(batch["goal"][:, :2], dtype=torch.float64), 10.0,
        m.T)))

    def loss(qc_inv):
        params = jg.default_params(spec, robot, b["start"], b["goal"],
                                   **{**m.COV, "qc_inv": qc_inv},
                                   dtype=jnp.float64)
        r = jgn.plan(spec, robot, params, th0, b["sdf"], cfg)
        return jnp.mean((r.th[..., :2] - b["th_opt"][..., :2]) ** 2)

    value, grad = jax.jit(jax.value_and_grad(loss))(
        jnp.eye(2, dtype=jnp.float64))
    np.testing.assert_allclose(multi["loss"], float(value), rtol=1e-8)
    want = np.asarray(grad)
    np.testing.assert_allclose(np_(multi["grad"]), want, rtol=1e-8,
                               atol=1e-8 * np.abs(want).max())


def test_learned_equals_static_at_the_static_init(learned):
    assert learned["static_init_gap"] <= 1e-10


def test_learned_vs_static_trains_and_plans_on_the_cpu(learned):
    m = module("learned_vs_static_example")
    assert len(learned["losses"]) == m.STEPS
    assert np.isfinite(learned["losses"]).all()
    check_plans("learned_vs_static_example", learned)


def test_report_stats_reads_results_and_the_sweep(tmp_path):
    for epoch, rate in ((10, 0.5), (5, 0.25)):
        (tmp_path / f"results_epoch{epoch}.yaml").write_text(yaml.safe_dump(
            {"solve_rate": rate, "avg_gp_error": 0.1, "avg_in_coll": 0.5}))
    sweep = tmp_path / "sensitivity_results.yaml"
    sweep.write_text(yaml.safe_dump({"best_sigma": 0.05,
                                     "best": {"solve_rate": 0.4}}))
    m = module("report_stats_example")
    with contextlib.redirect_stdout(io.StringIO()):
        out = m.main(["--results_glob", str(tmp_path / "results_*.yaml"),
                      "--sensitivity_file", str(sweep)])
        none = m.main(["--results_glob", str(tmp_path / "nothing*.yaml")])
    assert [(e, r["solve_rate"]) for e, r in out["rows"]] == [(10, 0.5),
                                                              (5, 0.25)]
    assert out["baseline"] == {"solve_rate": 0.4}
    assert none["rows"] == []


def test_the_scripts_run_in_a_chain_on_the_cpu(tmp_path):
    """generate -> train the initializer -> train the planner -> validate,
    each through bash in its own process, the port's configs found beside
    the scripts from another working directory; then the report."""
    seconds, report = chip_smoke.script_chain(
        tmp_path / "chain", "cpu", train=6, test=2, imsize=32, t=8,
        gen_iters=10, epochs=1, batch=4)
    assert list(seconds) == ["generate_dataset.sh", "train_init_network.sh",
                             "train_planner.sh", "valid_planner.sh"]
    chain = tmp_path / "chain"
    assert (chain / "init" / "init_losses.yaml").exists()
    assert list((chain / "exp" / "checkpoints").iterdir())
    (epoch, row), = report["rows"]
    assert epoch == 0 and 0.0 <= row["solve_rate"] <= 1.0
    assert np.isfinite(row["avg_gp_error"])


@pytest.mark.parametrize("name", [
    "gpmp2_2d_step_example", "diff_gpmp2_2d_batch_step_example",
    "diff_gpmp2_gp_inter_example", "arm_taskspace_example",
    "multistart_example", "plan3d_example", "serving_example",
    "dataset_loading_example", "diff_gpmp2_multi_dataset_example"])
def test_phase17_launch_formula_holds_on_the_cpu(name, monkeypatch):
    """GPMP2Planner and DiffGPMP2Planner steps, gn.plan with extra lookups,
    multistart scorings, 3-D lookups, the service's dispatches, generated
    data and a gradient through a plan (adjoint solves, K-LOOKUP-BWD)."""
    count_plain_launches(monkeypatch)
    with contextlib.redirect_stdout(io.StringIO()):
        chip_smoke.run_example(name, torch.device("cpu"), "CPU")
