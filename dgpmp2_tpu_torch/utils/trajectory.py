"""Trajectory initialisation and evaluation metrics (port of
``dgpmp2_tpu/utils/trajectory.py``), batched over leading dims."""
from __future__ import annotations

import torch


def straight_line_traj(start_conf: torch.Tensor, goal_conf: torch.Tensor,
                       total_time_sec: float,
                       total_time_step: int) -> torch.Tensor:
    """Linear interpolation with constant average velocity.

    start_conf, goal_conf: (..., dof) -> (..., T+1, 2·dof) trajectories whose
    positions interpolate start -> goal and whose velocities are the average
    velocity.  Made on the inputs' device and dtype.
    """
    t = total_time_step
    alpha = torch.linspace(0.0, 1.0, t + 1, dtype=start_conf.dtype,
                           device=start_conf.device)
    pos = (start_conf[..., None, :] * (1.0 - alpha)[:, None]
           + goal_conf[..., None, :] * alpha[:, None])
    avg_vel = (goal_conf - start_conf) / float(total_time_sec)
    vel = avg_vel[..., None, :].expand(pos.shape)
    return torch.cat([pos, vel], dim=-1)


def smoothness_metrics(traj: torch.Tensor, total_time_sec: float,
                       total_time_step: int):
    """Average velocity, acceleration and jerk magnitudes of (..., T+1, D)
    trajectories (velocities in the last D/2 dims), by the reference's
    finite differences of the velocity columns divided by step counts.
    Returns three (...,) means."""
    d = traj.shape[-1]
    dtraj = traj[..., 1:, :] - traj[..., :-1, :]
    ddtraj = dtraj[..., 1:, :] - dtraj[..., :-1, :]
    vel = traj[..., :, d // 2:]
    acc = dtraj[..., :, d // 2:] / float(total_time_step)
    jerk = ddtraj[..., :, d // 2:] / float(total_time_step) ** 2
    return tuple(torch.mean(torch.linalg.vector_norm(x, dim=-1), dim=-1)
                 for x in (vel, acc, jerk))


def collision_metrics(obs_error: torch.Tensor, total_time_sec: float,
                      total_time_step: int, eps=None) -> dict:
    """Collision statistics from (..., T+1, L) hinge residuals
    (``graph.obstacle_residuals``), endpoints excluded: a state is in
    collision when its hinge residual is nonzero (a margin violation,
    ``d < ε + r``).  With ``eps`` (broadcastable to ``obs_error``) true
    contact (residual > ε, i.e. ``d < r``) is split out as well.

    Returns (...,) tensors ``in_coll``, ``avg_penetration``,
    ``max_penetration``, ``coll_intensity`` (+ ``in_contact``,
    ``contact_intensity`` with ``eps``).
    """
    interior = obs_error[..., 1:-1, :]
    num_pen = torch.sum(interior > 0, dim=(-2, -1))
    dt = float(total_time_sec) / float(total_time_step)
    out = {
        "in_coll": num_pen > 0,
        "avg_penetration": torch.mean(interior, dim=(-2, -1)),
        "max_penetration": torch.amax(interior, dim=(-2, -1)),
        "coll_intensity": num_pen * dt / float(total_time_sec),
    }
    if eps is not None:
        eps_i = torch.as_tensor(eps, dtype=obs_error.dtype,
                                device=obs_error.device)
        eps_i = eps_i.expand(obs_error.shape)[..., 1:-1, :]
        num_contact = torch.sum(interior > eps_i, dim=(-2, -1))
        out["in_contact"] = num_contact > 0
        out["contact_intensity"] = num_contact * dt / float(total_time_sec)
    return out


def path_to_traj_avg_vel(path: torch.Tensor, traj_time: float) -> torch.Tensor:
    """Lift a waypoint path (..., S, dof) to states with the constant
    average velocity."""
    avg_vel = (path[..., -1, :] - path[..., 0, :]) / float(traj_time)
    return torch.cat([path, avg_vel[..., None, :].expand(path.shape)], dim=-1)
