"""Supervised training of the trajectory-initializer network.

Port of ``dgpmp2_tpu/learn/train_initializer.py``: ``InitNet`` predicts the
delta from a straight-line seed to the expert trajectory (MSE over the
state dimension, summed); validation reports the solve rate of ``seed +
delta``, every state clear of the robot radius in the SDF.  Adam; dropout
masks from a generator seeded by (seed, step).  Runs on the card unless
``--device cpu``.

    python -m dgpmp2_tpu_torch.learn.train_initializer --dataset_folders d \\
        --out_folder runs/init --epochs 20
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import yaml

from dgpmp2_tpu_torch.data import dataset as ds
from dgpmp2_tpu_torch.learn.train import dropout_seed
from dgpmp2_tpu_torch.models.init_net import InitNet
from dgpmp2_tpu_torch.ops import sdf as sdf_ops
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj


def make_train_fns(net: InitNet, optimizer: torch.optim.Optimizer,
                   total_time_sec, total_time_step, dof):
    """``(train_step(batch, generator) -> loss, predict(batch) -> th,
    seed_traj(start, goal) -> th0)`` on tensors of the net's device."""
    dtype = next(net.parameters()).dtype

    def seed_traj(start, goal):
        return straight_line_traj(start[:, :dof], goal[:, :dof],
                                  total_time_sec, total_time_step).to(dtype)

    def inputs(batch):
        return torch.stack([batch["im"], batch["sdf"]], dim=-1)

    def train_step(batch, generator):
        optimizer.zero_grad(set_to_none=True)
        th0 = seed_traj(batch["start"], batch["goal"])
        delta = net(inputs(batch), th0, train=True, rng=generator)
        target = batch["th_opt"].to(dtype) - th0
        loss = torch.mean(torch.sum((delta - target) ** 2, dim=-1))
        loss.backward()
        optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def predict(batch):
        th0 = seed_traj(batch["start"], batch["goal"])
        return th0 + net(inputs(batch), th0, train=False)

    return train_step, predict, seed_traj


@torch.no_grad()
def solve_rate(th, sdf, res, x_lims, y_lims, robot_radius) -> float:
    """The share of trajectories whose every state clears the robot
    radius."""
    d, _ = sdf_ops.lookup(sdf, th[..., :2].contiguous(), res, x_lims, y_lims)
    return float(torch.mean(torch.all(d > robot_radius, dim=-1).double()))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset_folders", nargs="+", required=True)
    p.add_argument("--out_folder", required=True)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--valid_size", type=float, default=0.2)
    p.add_argument("--total_time_sec", type=float, default=10.0)
    p.add_argument("--total_time_step", type=int, default=100)
    p.add_argument("--robot_radius", type=float, default=0.4)
    p.add_argument("--x_lims", nargs=2, type=float, default=(-5.0, 5.0))
    p.add_argument("--y_lims", nargs=2, type=float, default=(-5.0, 5.0))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the card)")
    args = p.parse_args(argv)
    dev = torch.device(args.device)

    dataset = ds.PlanningDatasetMulti(args.dataset_folders, mode="train")
    rng_np = np.random.default_rng(args.seed)
    tr, va = ds.train_valid_split(len(dataset), args.valid_size, rng_np)

    sample = dataset[0]
    im_size = sample["im"].shape[-1]
    state_dim = sample["th_opt"].shape[-1]
    res = (args.x_lims[1] - args.x_lims[0]) / im_size

    net = InitNet(2, sample["im"].shape, args.total_time_step + 1, state_dim)
    with torch.no_grad():
        net.reset_parameters(torch.Generator().manual_seed(args.seed))
    net = net.to(dev)
    optimizer = torch.optim.Adam(net.parameters(), args.lr)
    train_step, predict, _ = make_train_fns(
        net, optimizer, args.total_time_sec, args.total_time_step,
        state_dim // 2)

    def on_device(batch):
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    os.makedirs(args.out_folder, exist_ok=True)
    history, step = [], 0
    for epoch in range(args.epochs):
        losses = []
        for batch in ds.as_batches(dataset, tr, args.batch_size, rng=rng_np):
            gen = torch.Generator(dev)
            gen.manual_seed(dropout_seed(args.seed, step, 0))
            losses.append(float(train_step(on_device(batch), gen)))
            step += 1
        row = {"epoch": epoch, "loss": float(np.mean(losses))}
        if len(va) >= args.batch_size:
            vb = on_device(next(ds.as_batches(dataset, va, args.batch_size)))
            row["valid_solve_rate"] = solve_rate(
                predict(vb), vb["sdf"], res, tuple(args.x_lims),
                tuple(args.y_lims), args.robot_radius)
        history.append(row)
        print(row)
        with open(os.path.join(args.out_folder, "init_losses.yaml"),
                  "w") as fp:
            yaml.safe_dump(history, fp)
    return net, history


if __name__ == "__main__":
    main()
