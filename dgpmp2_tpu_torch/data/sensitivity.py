"""Static-covariance sensitivity study.

Port of ``dgpmp2_tpu/data/sensitivity.py`` (the reference's
``datasets/test_dataset_sensitivity.py``): sweep fixed ``cost_sigma``
values over a dataset, plan each batch with ``core.gn.plan``, record the
evaluation suite per sigma (``learn.eval.evaluate_batch`` / ``summarize``)
and write ``sensitivity_results.yaml``, the best static baseline that
learned covariances are compared with (``test_dataset_sensitivity.py:70-252,
270``).

    python -m dgpmp2_tpu_torch.data.sensitivity --dataset_folders d \
        --out_file sensitivity_results.yaml [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
import yaml

from dgpmp2_tpu_torch.core import gn, graph
from dgpmp2_tpu_torch.data import dataset as ds
from dgpmp2_tpu_torch.learn.eval import evaluate_batch, summarize
from dgpmp2_tpu_torch.robots import PointRobot2D
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj

DEFAULT_SIGMAS = (0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0)


@torch.no_grad()
def run_sweep(dataset, idxs, spec, robot, cfg, sigmas=DEFAULT_SIGMAS,
              batch_size=16, epsilon_dist=0.4, k_sg=0.01, device="cuda"):
    """``{"per_sigma": {sigma: summary}, "best_sigma", "best"}``: each
    sigma's metrics over the full batches of ``idxs`` (the short last batch
    dropped), the best by solve rate (the first of equals)."""
    dev = torch.device(device)
    results = {}
    for sigma in sigmas:
        all_m = []
        for batch in ds.as_batches(dataset, idxs, batch_size):
            b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            params = graph.default_params(
                spec, robot, b["start"], b["goal"],
                qc_inv=np.eye(spec.dof), cost_sigma=sigma,
                epsilon_dist=epsilon_dist, k_s=k_sg, k_g=k_sg,
                dtype=torch.float32,
            )
            th0 = straight_line_traj(
                b["start"][:, :spec.dof], b["goal"][:, :spec.dof],
                spec.total_time_sec, spec.total_time_step,
            ).to(torch.float32)
            th = gn.plan(spec, robot, params, th0, b["sdf"], cfg).th
            all_m.append(evaluate_batch(spec, robot, params, th,
                                        b.get("th_opt"), b["sdf"]))
        merged = {k: np.concatenate([m[k] for m in all_m]) for k in all_m[0]}
        results[float(sigma)] = summarize(merged)
    best = max(results, key=lambda s: results[s]["solve_rate"])
    return {"per_sigma": results, "best_sigma": best,
            "best": results[best]}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset_folders", nargs="+", required=True)
    p.add_argument("--out_file", default="sensitivity_results.yaml")
    p.add_argument("--sigmas", nargs="+", type=float,
                   default=list(DEFAULT_SIGMAS))
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--total_time_step", type=int, default=100)
    p.add_argument("--max_iters", type=int, default=60)
    p.add_argument("--mode", default="train")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    dataset = ds.PlanningDatasetMulti(args.dataset_folders, mode=args.mode)
    spec = graph.GraphSpec(total_time_step=args.total_time_step)
    cfg = gn.OptimConfig(reg=0.1, max_iters=args.max_iters)
    out = run_sweep(dataset, np.arange(len(dataset)), spec, PointRobot2D(),
                    cfg, tuple(args.sigmas), args.batch_size,
                    device=args.device)
    with open(args.out_file, "w") as fp:
        yaml.safe_dump(out, fp)
    print(f"best sigma = {out['best_sigma']}: {out['best']}")
    return out


def plot_results(results_file: str, out_png: str = "sensitivity.png"):
    """Solve rate against sigma (``datasets/plot_results.py:8-18``); needs
    matplotlib, imported only here."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(results_file) as fp:
        data = yaml.safe_load(fp)
    per = data["per_sigma"]
    sigmas = sorted(float(s) for s in per)
    unsolved = [1.0 - per[s]["solve_rate"] for s in sigmas]
    fig, ax = plt.subplots()
    ax.plot(sigmas, unsolved, "-", marker="o")
    ax.set_xscale("log")
    ax.set_xlabel("cost_sigma")
    ax.set_ylabel("fraction unsolved")
    fig.savefig(out_png, bbox_inches="tight", dpi=110)
    return out_png


if __name__ == "__main__":
    main()
