"""Evaluation CLI: roll out a trained (or the static) planner over a dataset.

Port of ``dgpmp2_tpu/learn/test_planner.py``: loads the run's train/valid
split, restores its newest checkpoint, plans every batch with
``track_best`` (the best non-colliding iterate by GP-MSE) and writes the
metric suite to a results YAML.  Without ``--model_folder`` it evaluates the
fixed-covariance planner.  Runs on the card unless ``--device cpu``.

    python -m dgpmp2_tpu_torch.learn.test_planner --dataset_folders d \\
        --model_folder runs/exp1 --out_file runs/exp1/results.yaml \\
        --plan_param_file ... --robot_param_file ... --env_param_file ... \\
        --learn_param_file ...
"""
from __future__ import annotations

import os

import numpy as np
import torch
import yaml

from dgpmp2_tpu_torch.core import gn, graph
from dgpmp2_tpu_torch.data import dataset as ds
from dgpmp2_tpu_torch.learn import checkpoints
from dgpmp2_tpu_torch.learn.eval import dump_results, evaluate_batch, summarize
from dgpmp2_tpu_torch.learn.train import init_train_state, make_optimizer
from dgpmp2_tpu_torch.learn.train_planner import (_parser, _to_batch,
                                                  cov_scalars_of, load_run)
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj


@torch.no_grad()
def main(argv=None):
    p = _parser(__doc__)
    p.add_argument("--model_folder", type=str, default=None)
    p.add_argument("--out_file", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--split", choices=("train", "valid", "all"),
                   default="valid")
    p.add_argument("--mode", choices=("train", "test"), default="train")
    args = p.parse_args(argv)

    planner, learn_params, gp_params, obs_params, robot = load_run(args)
    spec, dev, dtype = planner.spec, planner.device, planner.learn_cfg.dtype
    dataset = ds.PlanningDatasetMulti(
        args.dataset_folders, mode=args.mode,
        label_subdir="opt_trajs_" + learn_params["data"].get("expert",
                                                             "gpmp2"))
    idxs = np.arange(len(dataset))
    split_file = (os.path.join(args.model_folder, "train_val_split.yaml")
                  if args.model_folder else None)
    if args.split != "all" and split_file and os.path.exists(split_file):
        with open(split_file) as fp:
            split = yaml.safe_load(fp)
        idxs = np.asarray(split["valid" if args.split == "valid"
                                else "train"])
    cov_scalars = cov_scalars_of(gp_params, obs_params)

    variables = None
    if args.model_folder:
        sample = _to_batch(next(ds.as_batches(dataset, idxs,
                                              args.batch_size)),
                           cov_scalars, dev)
        # The template's optimizer is the run's own, so that its state
        # loads.
        opt = learn_params["optim"]
        tmpl = init_train_state(
            planner, make_optimizer(opt.get("optimizer", "adam"), opt),
            torch.Generator().manual_seed(0),
            planner.stack_inputs(sample["im"], sample["sdf"]),
            sample["th_opt"])
        _, payload = checkpoints.restore(
            os.path.join(args.model_folder, "checkpoints"), {"state": tmpl})
        variables = payload["state"].variables

    all_m = []
    for batch in ds.as_batches(dataset, idxs, args.batch_size):
        b = _to_batch(batch, cov_scalars, dev)
        params_fix = graph.default_params(spec, robot, b["start"], b["goal"],
                                          **cov_scalars, dtype=dtype)
        th0 = straight_line_traj(
            b["start"][:, :spec.dof], b["goal"][:, :spec.dof],
            spec.total_time_sec, spec.total_time_step).to(dtype)
        sdf = b["sdf"].to(dtype)
        if variables is not None:
            th, _, _, _ = planner.plan(variables, params_fix, th0, sdf,
                                       b["im"], track_best=True)
        else:
            th = gn.plan(spec, robot, params_fix, th0, sdf, planner.cfg,
                         track_best=True).best_th
        all_m.append(evaluate_batch(spec, robot, params_fix, th,
                                    b["th_opt"].to(dtype), sdf))

    merged = {k: np.concatenate([m[k] for m in all_m]) for k in all_m[0]}
    summary = summarize(merged)
    dump_results(args.out_file, summary)
    print(yaml.safe_dump(summary, default_flow_style=False))
    return summary


if __name__ == "__main__":
    main()
