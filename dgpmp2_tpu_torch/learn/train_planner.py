"""Learned-planner training CLI.

Port of ``dgpmp2_tpu/learn/train_planner.py``, with its flags and YAML
schema: loads the four YAML families, splits train/validation (the split
written to ``train_val_split.yaml``), runs epochs of the TBPTT train step,
validates every ``eval_epoch``, checkpoints every ``save_epoch`` and at the
end, and writes the per-epoch series to ``train_losses.yaml`` (and a loss
curve PNG where matplotlib imports; nothing else needs it).  Runs on the
card unless ``--device cpu``.  ``--resume`` continues from the newest
checkpoint exactly where the run left off: weights, optimizer state, step
count and the batch shuffle's generator state.

    python -m dgpmp2_tpu_torch.learn.train_planner \\
        --dataset_folders data/forest --out_folder runs/exp1 \\
        --plan_param_file dgpmp2_tpu_torch/configs/gpmp2_2d_params.yaml \\
        --robot_param_file dgpmp2_tpu_torch/configs/robot_2d.yaml \\
        --env_param_file dgpmp2_tpu_torch/configs/env_2d_params.yaml \\
        --learn_param_file dgpmp2_tpu_torch/configs/learn_params.yaml
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import yaml

from dgpmp2_tpu_torch.core import graph
from dgpmp2_tpu_torch.data import dataset as ds
from dgpmp2_tpu_torch.learn import checkpoints
from dgpmp2_tpu_torch.learn.eval import evaluate_batch, summarize
from dgpmp2_tpu_torch.learn.learned_planner import (LearnedDiffGPMP2Planner,
                                                    LearnedPlannerConfig)
from dgpmp2_tpu_torch.learn.losses import LossWeights
from dgpmp2_tpu_torch.learn.train import (TrainConfig, init_train_state,
                                          make_optimizer, make_train_step)
from dgpmp2_tpu_torch.utils import config as config_lib
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj


def build_planner(planner_params, env_data, optim_params, learn_params, robot,
                  gp_params=None, obs_params=None, device=None,
                  dtype: torch.dtype = torch.float32):
    """The learned planner of the YAMLs; ``dgpmp2.static_init`` takes the
    static covariances from the GP and obstacle YAML sections."""
    spec = config_lib.spec_from_params(planner_params, env_data, robot)
    cfg = config_lib.optim_from_params(optim_params)
    dg, model = learn_params["dgpmp2"], learn_params["model"]
    static_init = None
    if dg.get("static_init", False) and gp_params and obs_params:
        static_init = (float(np.asarray(gp_params["Q_c_inv"]).ravel()[0]),
                       float(obs_params["cost_sigma"]),
                       float(obs_params["epsilon_dist"]))
    lcfg = LearnedPlannerConfig(
        dynamics_mode=dg["dynamics_mode"],
        learn_eps=bool(dg.get("learn_eps", False)),
        eps_max=(float(dg["eps_max"]) if dg.get("eps_max") is not None
                 else None),
        sdf_predict=bool(dg.get("sdf_predict", True)),
        fixed_conv=bool(dg.get("fixed_conv", False)),
        dtheta_predict=bool(dg.get("dtheta_predict", False)),
        costmap_predict=bool(dg.get("costmap_predict", False)),
        costmap_eps=(float(obs_params["epsilon_dist"]) if obs_params
                     else 0.4),
        model_type=model.get("type", "feed_forward"),
        hidden_dim=int(model.get("hidden_dim", 64)),
        num_hidden=int(model.get("num_hidden", 1)),
        dropout_prob=float(model.get("dropout_prob", 0.5)),
        static_init=static_init,
        dtype=dtype,
    )
    return LearnedDiffGPMP2Planner(spec, robot, cfg, lcfg, device=device)


def cov_scalars_of(gp_params, obs_params) -> dict:
    """The fixed covariances' keywords of ``graph.default_params``."""
    return dict(
        qc_inv=np.asarray(gp_params["Q_c_inv"], np.float32),
        cost_sigma=float(obs_params["cost_sigma"]),
        epsilon_dist=float(obs_params["epsilon_dist"]),
        k_s=float(gp_params["K_s"]), k_g=float(gp_params["K_g"]),
    )


def load_run(args):
    """(planner, learn_params, gp_params, obs_params, robot) of the CLI's
    YAML files."""
    (env_data, planner_params, gp_params, obs_params, optim_params,
     robot_data, learn_params) = config_lib.load_params_learn(
        args.plan_param_file, args.robot_param_file, args.env_param_file,
        args.learn_param_file)
    robot = config_lib.make_robot(robot_data)
    planner = build_planner(planner_params, env_data, optim_params,
                            learn_params, robot, gp_params, obs_params,
                            device=args.device)
    return planner, learn_params, gp_params, obs_params, robot


def train_config_of(learn_params):
    """(TrainConfig, LossWeights) of the learn YAML."""
    opt, dg = learn_params["optim"], learn_params["dgpmp2"]
    tcfg = TrainConfig(
        T=int(dg.get("T", 10)), tk=int(dg.get("tk", 5)),
        tk2=int(dg["tk2"]) if dg.get("tk2") else None,
        use_inter_loss=bool(dg.get("use_inter_loss", True)),
        clip_grad=bool(opt.get("clip_grad", True)),
        clip_val=float(opt.get("clip_val", 2.0)),
        optimize_tk=bool(dg.get("optimize_tk", False)),
    )
    weights = LossWeights(
        vel_loss_lambda=float(opt.get("vel_loss_lambda", 0.1)),
        ext_obs_lambda=float(opt.get("ext_obs_lambda", 1.0)),
        ext_loss_weight=float(opt.get("ext_loss_weight", 0.0)),
        pos_loss_weight=float(opt.get("pos_loss_weight", 1.0)),
        max_pen_weight=float(opt.get("max_pen_weight", 0.0)),
        max_pen_beta=float(opt.get("max_pen_beta", 30.0)),
    )
    return tcfg, weights


def _parser(description):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--dataset_folders", nargs="+", required=True)
    p.add_argument("--plan_param_file", required=True)
    p.add_argument("--robot_param_file", required=True)
    p.add_argument("--env_param_file", required=True)
    p.add_argument("--learn_param_file", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the card)")
    return p


def main(argv=None):
    p = _parser(__doc__)
    p.add_argument("--out_folder", type=str, required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in out_folder")
    args = p.parse_args(argv)

    planner, learn_params, gp_params, obs_params, robot = load_run(args)
    spec = planner.spec
    opt = learn_params["optim"]
    data = learn_params["data"]

    os.makedirs(args.out_folder, exist_ok=True)
    ckpt_dir = os.path.join(args.out_folder, "checkpoints")

    dataset = ds.PlanningDatasetMulti(
        args.dataset_folders, mode="train",
        num_envs=int(data.get("num_train_envs", -1)),
        num_env_probs=int(data.get("num_train_env_probs", -1)),
        label_subdir="opt_trajs_" + data.get("expert", "gpmp2"),
    )
    rng_np = np.random.default_rng(args.seed)
    train_idx, valid_idx = ds.train_valid_split(
        len(dataset), float(data.get("valid_size", 0.2)), rng_np,
        shuffle=bool(data.get("shuffle", True)))
    split = {"train": train_idx.tolist(), "valid": valid_idx.tolist()}
    with open(os.path.join(args.out_folder, "train_val_split.yaml"),
              "w") as fp:
        yaml.safe_dump(split, fp)

    cov_scalars = cov_scalars_of(gp_params, obs_params)
    tx = make_optimizer(opt.get("optimizer", "adam"), opt)
    tcfg, weights = train_config_of(learn_params)
    train_step = make_train_step(planner, weights, tcfg)
    batch_size = int(opt.get("batch_size", 16))
    if len(train_idx) < batch_size:
        raise ValueError(
            f"train split has {len(train_idx)} problems but batch_size="
            f"{batch_size}: with drop_remainder batching no batch would ever "
            "be formed; lower optim.batch_size or use a larger dataset")

    sample = _to_batch(next(ds.as_batches(dataset, train_idx, batch_size)),
                       cov_scalars, planner.device)
    im_stack = planner.stack_inputs(sample["im"], sample["sdf"])
    state = init_train_state(planner, tx,
                             torch.Generator().manual_seed(args.seed),
                             im_stack, sample["th_opt"])
    start_epoch = 0
    if args.resume and checkpoints.latest_step(ckpt_dir) is not None:
        start_epoch, payload = checkpoints.restore(ckpt_dir, {"state": state})
        state = payload["state"]
        if payload["rng"] is not None:
            rng_np.bit_generator.state = payload["rng"]
        print(f"resumed from epoch {start_epoch}")

    history = []
    epochs = int(opt.get("epochs", 20))
    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        ep_metrics = []
        for batch in ds.as_batches(dataset, train_idx, batch_size,
                                   rng=rng_np):
            state, metrics = train_step(
                state, _to_batch(batch, cov_scalars, planner.device),
                args.seed)
            ep_metrics.append({k: float(v) for k, v in metrics.items()})
        mean = {k: float(np.mean([m[k] for m in ep_metrics]))
                for k in ep_metrics[0]}
        mean["epoch"] = epoch
        mean["time"] = time.time() - t0
        history.append(mean)
        print(f"epoch {epoch}: " + " ".join(
            f"{k}={v:.5f}" for k, v in mean.items() if k != "epoch"))

        if (opt.get("do_validation", True)
                and (epoch + 1) % int(opt.get("eval_epoch", 5)) == 0
                and len(valid_idx)):
            val = validate(planner, state, dataset, valid_idx, batch_size,
                           cov_scalars, spec, robot)
            print(f"  validation: {val}")
            history[-1]["validation"] = val
        if (epoch + 1) % int(opt.get("save_epoch", 5)) == 0:
            checkpoints.save(ckpt_dir, epoch + 1, state,
                             rng=rng_np.bit_generator.state, split=split)

        with open(os.path.join(args.out_folder, "train_losses.yaml"),
                  "w") as fp:
            yaml.safe_dump(history, fp)
        _plot_curves(history, args.out_folder)

    checkpoints.save(ckpt_dir, epochs, state, rng=rng_np.bit_generator.state,
                     split=split)
    print("done")
    return state, history


def _to_batch(batch, cov_scalars, device):
    out = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    out["cov_scalars"] = cov_scalars
    return out


@torch.no_grad()
def validate(planner, state, dataset, valid_idx, batch_size, cov_scalars,
             spec, robot):
    """Learned rollout and the metric suite on the validation split (full
    batches only)."""
    all_m = []
    dtype = planner.learn_cfg.dtype
    for batch in ds.as_batches(dataset, valid_idx, batch_size,
                               drop_remainder=True):
        b = _to_batch(batch, cov_scalars, planner.device)
        params_fix = graph.default_params(spec, robot, b["start"], b["goal"],
                                          **cov_scalars, dtype=dtype)
        th0 = straight_line_traj(
            b["start"][:, :spec.dof], b["goal"][:, :spec.dof],
            spec.total_time_sec, spec.total_time_step).to(dtype)
        sdf = b["sdf"].to(dtype)
        th, _, _, _ = planner.plan(state.variables, params_fix, th0, sdf,
                                   b["im"], max_iters=planner.cfg.max_iters)
        all_m.append(evaluate_batch(spec, robot, params_fix, th,
                                    b["th_opt"].to(dtype), sdf))
    if not all_m:
        return {}
    merged = {k: np.concatenate([m[k] for m in all_m]) for k in all_m[0]}
    return summarize(merged)


def _plot_curves(history, out_folder):
    """The loss curve as a PNG, where matplotlib imports."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, ax = plt.subplots()
    ax.plot([h["epoch"] for h in history], [h["loss"] for h in history])
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    fig.savefig(os.path.join(out_folder, "train_curve.png"),
                bbox_inches="tight", dpi=100)
    plt.close(fig)


if __name__ == "__main__":
    main()
