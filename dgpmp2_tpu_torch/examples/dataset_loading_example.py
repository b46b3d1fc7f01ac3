"""Dataset loading: port of ``examples/dataset_loading_example.py``.
Generate a tiny expert-labelled dataset, load it through the dataset
reader, batch it and replan the batch against the stored labels.

The dataset goes to a temporary directory unless ``--data_dir`` names one.

    python -m dgpmp2_tpu_torch.examples.dataset_loading_example
        [--device cpu] [--dtype float64] [--data_dir DIR] [--plot]
"""
from __future__ import annotations

import contextlib
import os
import tempfile

import numpy as np
import torch

from dgpmp2_tpu_torch.core import gn, graph
from dgpmp2_tpu_torch.data import dataset as ds
from dgpmp2_tpu_torch.data import generate
from dgpmp2_tpu_torch.examples import _common
from dgpmp2_tpu_torch.robots import PointRobot2D
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj

T = 24
SPEC = graph.GraphSpec(total_time_step=T)
ROBOT = PointRobot2D()
CFG = gn.OptimConfig(reg=0.1, max_iters=30)
COV = dict(qc_inv=np.eye(2), cost_sigma=0.1, epsilon_dist=0.4, k_s=0.01,
           k_g=0.01)


def data_dir(path):
    """``path``, or a temporary directory removed at the end."""
    if path:
        return contextlib.nullcontext(path)
    return tempfile.TemporaryDirectory(prefix="dgpmp2_dataset_example_")


def parser(doc):
    p = _common.parser(doc)
    p.add_argument("--data_dir", default=None,
                   help="where to write the dataset (default: a temporary "
                        "directory)")
    return p


@torch.no_grad()
def main(argv=None) -> dict:
    args = _common.parse(parser(__doc__), argv)
    dev, dtype = args.device, args.dtype
    with data_dir(args.data_dir) as root:
        generate.generate_split(
            os.path.join(root, "train"), num_envs=3, probs_per_env=2,
            family="multi_obs", im_size=64, rng=np.random.default_rng(0),
            spec=SPEC, robot=ROBOT, cfg=CFG, cov_scalars=COV, device=dev)
        dset = ds.PlanningDataset(root, mode="train")
        print(f"loaded dataset: {len(dset)} problems")
        batch = next(ds.as_batches(dset, np.arange(len(dset)), batch_size=4))
    print("batch shapes:", {k: v.shape for k, v in batch.items()})
    b = {k: torch.as_tensor(v, dtype=dtype, device=dev)
         for k, v in batch.items()}
    params = graph.default_params(SPEC, ROBOT, b["start"], b["goal"], **COV,
                                  dtype=dtype)
    th0 = straight_line_traj(b["start"][:, :2], b["goal"][:, :2], 10.0, T)
    r = gn.plan(SPEC, ROBOT, params, th0, b["sdf"], CFG)
    mse = float(torch.mean((r.th[..., :2] - b["th_opt"][..., :2]) ** 2))
    print(f"replanned batch: err {np.round(_common.np_(r.err_init), 2)} -> "
          f"{np.round(_common.np_(r.err_final), 4)}; MSE vs stored expert: "
          f"{mse:.2e}")
    if args.plot:
        _common.plot_plan(batch["im"][0], th0[0], r.th[0],
                          "dataset_loading_example.png")
    return {"problems": len(dset), "err_init": r.err_init,
            "err_final": r.err_final, "iters": r.iters, "mse": mse,
            "th": r.th}


if __name__ == "__main__":
    main()
