"""Evaluation: planner rollouts, the quality metrics and the results YAML.

Port of ``dgpmp2_tpu/learn/eval.py``: roll out the planner (learned or
fixed covariances) over problem batches and report the reference's metric
suite: errors against the expert, graph errors, smoothness (average
velocity, acceleration, jerk), collision statistics (in-collision rate,
average and largest penetration, collision intensity) and constraint
violations, each per problem, then averaged.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import yaml

from dgpmp2_tpu_torch.core import gn, graph
from dgpmp2_tpu_torch.utils.trajectory import (collision_metrics,
                                               smoothness_metrics,
                                               straight_line_traj)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


@torch.no_grad()
def evaluate_batch(spec: graph.GraphSpec, robot, params: graph.GraphParams,
                   th_final: torch.Tensor, th_opt: Optional[torch.Tensor],
                   sdf: torch.Tensor) -> Dict[str, np.ndarray]:
    """The reference's metric suite for final trajectories (B, T+1, D), each
    metric (B,) numpy."""
    r_obs = graph.obstacle_residuals(spec, robot, params, th_final, sdf)
    coll = collision_metrics(r_obs, spec.total_time_sec, spec.total_time_step,
                             eps=params.eps)
    avg_vel, avg_acc, avg_jerk = smoothness_metrics(
        th_final, spec.total_time_sec, spec.total_time_step)
    err_sg, err_gp, err_obs = graph.unweighted_errors(spec, robot, params,
                                                      th_final, sdf)
    out = {k: _np(coll[k]) for k in (
        "in_coll", "in_contact", "contact_intensity", "avg_penetration",
        "max_penetration", "coll_intensity")}
    out.update(avg_vel=_np(avg_vel), avg_acc=_np(avg_acc),
               avg_jerk=_np(avg_jerk), gp_error=_np(err_gp),
               sg_error=_np(err_sg), obs_error=_np(err_obs))
    if spec.use_vel_limits and params.v_lim is not None:
        # The share of states with any axis faster than its limit (strict >).
        v = th_final[..., spec.dof:]
        viol = torch.any(torch.abs(v) > params.v_lim, dim=-1)
        out["constraint_violation"] = _np(
            torch.mean(viol.to(torch.float32), dim=-1))
    if spec.use_joint_limits and params.q_min is not None:
        # The share of states with any joint outside [q_min, q_max].
        q = th_final[..., :spec.dof]
        violj = torch.any((q < params.q_min) | (q > params.q_max), dim=-1)
        out["joint_limit_violation"] = _np(
            torch.mean(violj.to(torch.float32), dim=-1))
    if spec.use_self_collision:
        # Body-pair penetration of true contact (d < r_i + r_j), interior
        # states only.
        pairs = torch.as_tensor(spec.self_pairs, dtype=torch.long,
                                device=th_final.device)
        centers, _ = robot.fk(th_final)
        radii = robot.radii_array(th_final.dtype, th_final.device)
        dist = torch.sqrt(torch.sum(
            (centers[..., pairs[:, 0], :] - centers[..., pairs[:, 1], :])
            ** 2, dim=-1) + 1e-12)
        pen = torch.clamp(radii[pairs[:, 0]] + radii[pairs[:, 1]] - dist,
                          min=0.0)
        pen_int = pen[:, 1:-1, :]
        out["in_self_contact"] = _np(torch.any(pen_int > 0, dim=2).any(1))
        out["max_self_penetration"] = _np(torch.amax(pen_int, dim=(1, 2)))
    if th_opt is not None:
        dof = spec.dof
        out["pos_mse"] = _np(torch.mean(torch.sum(
            (th_final[..., :dof] - th_opt[..., :dof]) ** 2, -1), -1))
        out["vel_mse"] = _np(torch.mean(torch.sum(
            (th_final[..., dof:] - th_opt[..., dof:]) ** 2, -1), -1))
    return out


def summarize(per_problem: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The results YAML's scalars: ``avg_<metric>`` of each, and
    ``solve_rate`` (no margin violation on the interior),
    ``contact_free_rate`` (no true contact) and ``self_contact_free_rate``
    where their metrics are present."""
    s = {}
    for k, v in per_problem.items():
        s[f"avg_{k}"] = float(np.mean(np.asarray(v, np.float64)))
    s["solve_rate"] = float(np.mean(~per_problem["in_coll"].astype(bool)))
    if "in_contact" in per_problem:
        s["contact_free_rate"] = float(
            np.mean(~per_problem["in_contact"].astype(bool)))
    if "in_self_contact" in per_problem:
        s["self_contact_free_rate"] = float(
            np.mean(~per_problem["in_self_contact"].astype(bool)))
    return s


def dump_results(path: str, summary: Dict[str, float]) -> None:
    with open(path, "w") as fp:
        yaml.safe_dump(summary, fp, default_flow_style=False)


def run_validation(spec: graph.GraphSpec, robot, cfg: gn.OptimConfig,
                   make_params_fn, batches,
                   learned_step_fn=None) -> Dict[str, float]:
    """Plan every batch and summarize the merged metrics.

    ``batches`` yields dicts of tensors with ``start`` / ``goal`` (B, D),
    ``sdf``, optional ``th_opt`` and ``th_init``; ``make_params_fn(start,
    goal)`` gives the covariances to plan with and to judge by;
    ``learned_step_fn(params, th0, sdf) -> th`` replaces the fixed-covariance
    plan (``core.gn.plan``) when given.
    """
    all_metrics = []
    for batch in batches:
        start, goal, sdf = batch["start"], batch["goal"], batch["sdf"]
        params = make_params_fn(start, goal)
        th0 = batch.get("th_init")
        if th0 is None:
            th0 = straight_line_traj(start[:, :spec.dof], goal[:, :spec.dof],
                                     spec.total_time_sec,
                                     spec.total_time_step).to(sdf.dtype)
        if learned_step_fn is not None:
            th = learned_step_fn(params, th0, sdf)
        else:
            with torch.no_grad():
                th = gn.plan(spec, robot, params, th0, sdf, cfg).th
        all_metrics.append(evaluate_batch(spec, robot, params, th,
                                          batch.get("th_opt"), sdf))
    merged = {k: np.concatenate([m[k] for m in all_metrics])
              for k in all_metrics[0]}
    return summarize(merged)
