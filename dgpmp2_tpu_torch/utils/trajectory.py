"""Trajectory initialisation (port of ``dgpmp2_tpu/utils/trajectory.py``)."""
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
