"""Learned covariances against the static baseline, end to end: port of
``examples/learned_vs_static_example.py``, a miniature of the learned
campaign.  Generate a handful of cluttered worlds with the batched expert,
train an eps-bounded learned planner from its static initialisation for a
few Adam steps, then plan one held-out problem with both.

At the static initialisation the learned planner is the static one: the
example plans the held-out problem with the untrained weights too and
reports how far that plan lies from the static plan.

The dataset goes to a temporary directory unless ``--data_dir`` names one.

    python -m dgpmp2_tpu_torch.examples.learned_vs_static_example
        [--device cpu] [--dtype float64] [--data_dir DIR] [--plot]
"""
from __future__ import annotations

import os

import numpy as np
import torch

from dgpmp2_tpu_torch.core import gn, graph
from dgpmp2_tpu_torch.data import dataset as ds
from dgpmp2_tpu_torch.data import generate
from dgpmp2_tpu_torch.examples import _common
from dgpmp2_tpu_torch.examples.dataset_loading_example import (data_dir,
                                                               parser)
from dgpmp2_tpu_torch.learn.learned_planner import (LearnedDiffGPMP2Planner,
                                                    LearnedPlannerConfig)
from dgpmp2_tpu_torch.learn.losses import LossWeights
from dgpmp2_tpu_torch.learn.train import (TrainConfig, init_train_state,
                                          make_optimizer, make_train_step)
from dgpmp2_tpu_torch.robots import PointRobot2D
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj

T, WORLDS, IMSIZE, STEPS, ITERS = 24, 8, 64, 8, 20
COV = dict(qc_inv=np.eye(2), cost_sigma=0.05, epsilon_dist=0.4, k_s=0.01,
           k_g=0.01)
SPEC = graph.GraphSpec(total_time_step=T)
ROBOT = PointRobot2D()
CFG = gn.OptimConfig(reg=0.1, max_iters=ITERS)


def learned_planner(dev, dtype) -> LearnedDiffGPMP2Planner:
    return LearnedDiffGPMP2Planner(
        SPEC, ROBOT, CFG, LearnedPlannerConfig(
            dynamics_mode="diag_identity", learn_eps=True,
            eps_max=2 * COV["epsilon_dist"], dropout_prob=0.1,
            static_init=(1.0, COV["cost_sigma"], COV["epsilon_dist"]),
            dtype=dtype), device=dev)


def main(argv=None) -> dict:
    args = _common.parse(parser(__doc__), argv)
    dev, dtype = args.device, args.dtype
    with data_dir(args.data_dir) as root:
        generate.generate_split(
            os.path.join(root, "train"), WORLDS, 2, "multi_obs", IMSIZE,
            np.random.default_rng(0), SPEC, ROBOT,
            gn.OptimConfig(reg=0.1, max_iters=30, method="lm"), COV,
            device=dev)
        dataset = ds.PlanningDataset(root, mode="train",
                                     label_subdir="opt_trajs_gpmp2")
        idxs = np.arange(len(dataset))
        batch = next(ds.as_batches(dataset, idxs[:-1], len(idxs) - 1))
        item = dataset[len(dataset) - 1]  # the held-out problem
    batch = {k: torch.as_tensor(v, dtype=dtype, device=dev)
             for k, v in batch.items()}
    batch["cov_scalars"] = COV

    planner = learned_planner(dev, dtype)
    weights = LossWeights(pos_loss_weight=0.0, ext_loss_weight=1.0,
                          ext_obs_lambda=5.0)
    train_step = make_train_step(planner, weights,
                                 TrainConfig(T=5, tk=5, use_inter_loss=True))
    state = init_train_state(
        planner, make_optimizer("adam", {"alpha": 3e-4}),
        torch.Generator().manual_seed(0),
        planner.stack_inputs(batch["im"], batch["sdf"]), batch["th_opt"])

    held = {k: torch.as_tensor(item[k], dtype=dtype, device=dev)[None]
            for k in ("start", "goal", "sdf", "im")}
    th0 = straight_line_traj(held["start"][:, :2], held["goal"][:, :2],
                             SPEC.total_time_sec, T)
    params = graph.default_params(SPEC, ROBOT, held["start"], held["goal"],
                                  **COV, dtype=dtype)
    with torch.no_grad():
        static = gn.plan(SPEC, ROBOT, params, th0, held["sdf"], CFG,
                         track_best=True)
        th_init_weights = planner.plan(state.variables, params, th0,
                                       held["sdf"], held["im"],
                                       max_iters=ITERS, track_best=True)[0]
    gap = float((th_init_weights - static.best_th).abs().max())
    print(f"static init: learned plan - static plan, max |dth| = {gap:.3e}")

    losses = []
    for epoch in range(STEPS):
        state, m = train_step(state, batch, 0)
        losses.append(float(m["loss"]))
        print(f"epoch {epoch}: loss={losses[-1]:.4f}")

    with torch.no_grad():
        th_learned, errs, _, _ = planner.plan(
            state.variables, params, th0, held["sdf"], held["im"],
            max_iters=ITERS, track_best=True)
    err = {k: graph.graph_error(SPEC, ROBOT, params, th, held["sdf"])
           for k, th in (("init", th0), ("static", static.best_th),
                         ("learned", th_learned))}
    print(f"held-out problem, error under the static covariances: seed "
          f"{float(err['init'][0]):.3f}, static {float(err['static'][0]):.5f},"
          f" learned {float(err['learned'][0]):.5f}")
    if args.plot:
        plot(item["im"], th0, static.best_th, th_learned)
    return {"losses": losses, "static_init_gap": gap,
            "static": {"err_init": err["init"], "err_final": err["static"],
                       "th": static.best_th},
            "learned": {"err_init": err["init"], "err_final": err["learned"],
                        "th": th_learned}}


def plot(im, th0, th_static, th_learned):
    plt, fig, ax = _common.figure(figsize=(6, 6))
    ax.imshow(im, cmap="gray", extent=(-5, 5, -5, 5), origin="upper")
    for th, style, label in ((th0, "r--", "initial"),
                             (th_static, "c-", "static"),
                             (th_learned, "b-", "learned (eps)")):
        t = _common.np_(th[0])
        ax.plot(t[:, 0], t[:, 1], style, label=label)
    ax.legend()
    _common.save(plt, fig, "learned_vs_static_example.png")


if __name__ == "__main__":
    main()
