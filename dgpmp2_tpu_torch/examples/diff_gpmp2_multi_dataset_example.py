"""Several datasets in one batch and a gradient through the unrolled plan
to the GP covariance: port of
``examples/diff_gpmp2_multi_dataset_example.py``.  Two dataset roots (a
multi-obstacle and a forest family) are read as one with
``PlanningDatasetMulti``, batched, replanned, and a task loss against the
stored experts is differentiated with respect to ``Q_c⁻¹``.

The datasets go to a temporary directory unless ``--data_dir`` names one.

    python -m dgpmp2_tpu_torch.examples.diff_gpmp2_multi_dataset_example
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
from dgpmp2_tpu_torch.examples.dataset_loading_example import (COV, ROBOT,
                                                               SPEC, T,
                                                               data_dir,
                                                               parser)
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj

CFG = gn.OptimConfig(reg=0.1, max_iters=20, tol_delta=0.0)
FAMILIES = ("multi_obs", "forest")


def task_loss(qc_inv, batch, dtype):
    """The plan's mean squared position error against the stored experts,
    and the plan."""
    params = graph.default_params(SPEC, ROBOT, batch["start"], batch["goal"],
                                  **{**COV, "qc_inv": qc_inv}, dtype=dtype)
    th0 = straight_line_traj(batch["start"][:, :2], batch["goal"][:, :2],
                             10.0, T)
    r = gn.plan(SPEC, ROBOT, params, th0, batch["sdf"], CFG)
    return torch.mean((r.th[..., :2] - batch["th_opt"][..., :2]) ** 2), r, th0


def main(argv=None) -> dict:
    args = _common.parse(parser(__doc__), argv)
    dev, dtype = args.device, args.dtype
    with data_dir(args.data_dir) as root:
        roots = []
        for i, family in enumerate(FAMILIES):
            roots.append(os.path.join(root, family))
            generate.generate_split(
                os.path.join(roots[-1], "train"), num_envs=2, probs_per_env=2,
                family=family, im_size=64, rng=np.random.default_rng(i),
                spec=SPEC, robot=ROBOT, cfg=CFG, cov_scalars=COV, device=dev)
        dset = ds.PlanningDatasetMulti(roots, mode="train")
        print(f"multi-dataset: {len(dset)} problems from {len(roots)} roots")
        batch = next(ds.as_batches(dset, np.arange(len(dset)),
                                   batch_size=len(dset)))
    b = {k: torch.as_tensor(v, dtype=dtype, device=dev)
         for k, v in batch.items()}
    qc_inv = torch.eye(2, dtype=dtype, device=dev, requires_grad=True)
    loss, r, th0 = task_loss(qc_inv, b, dtype)
    (grad,) = torch.autograd.grad(loss, qc_inv)
    loss = float(loss.detach())
    print(f"task loss vs experts: {loss:.4f}")
    print("d(loss)/d(Qc_inv) through the unrolled plan:\n",
          _common.np_(grad))
    if args.plot:
        _common.plot_plan(batch["im"][0], th0[0], r.th[0],
                          "diff_gpmp2_multi_dataset_example.png")
    return {"problems": len(dset), "loss": loss, "grad": grad,
            "err_init": r.err_init, "err_final": r.err_final,
            "iters": r.iters, "th": r.th.detach()}


if __name__ == "__main__":
    main()
