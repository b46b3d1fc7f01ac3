"""Training losses for the learned planner.

Port of ``dgpmp2_tpu/learn/losses.py``.  Per GN step the loss compares the
step's update with the expert's remaining delta, plus externally weighted
graph terms:

    expert_loss = mean‖dθ_pos - (θ*_pos - θ_pos)‖² +
                  λ_vel · mean‖dθ_vel - (θ*_vel - θ_vel)‖²
    ext_loss    = mean(err_gp) + mean(err_sg) + λ_obs · mean(err_obs)
    total       = w_pos · expert_loss + w_ext · ext_loss [+ w_pen · maxpen]
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class LossWeights(NamedTuple):
    vel_loss_lambda: float = 0.1
    ext_obs_lambda: float = 1.0
    ext_loss_weight: float = 0.0
    # Weight on the expert-imitation MSE (1.0: the reference's loss).
    pos_loss_weight: float = 1.0
    # The smooth-max penetration surrogate (smooth_max_penetration): it
    # targets the single worst interior hinge, the state that decides a
    # problem's solve_rate.
    max_pen_weight: float = 0.0
    max_pen_beta: float = 30.0


class LossTerms(NamedTuple):
    total: torch.Tensor
    pos: torch.Tensor
    vel: torch.Tensor
    gp: torch.Tensor
    sg: torch.Tensor
    obs: torch.Tensor
    ext: torch.Tensor
    maxpen: torch.Tensor


def smooth_max_penetration(r_obs: torch.Tensor, beta: float) -> torch.Tensor:
    """Differentiable surrogate of each problem's largest interior
    penetration: the softmax(β·pen)-weighted mean of the hinge residuals
    ``r_obs`` (B, T+1, L) over the interior states (endpoints excluded, as
    ``collision_metrics``); the max as β → ∞, exactly 0 when no hinge is
    active.  Returns (B,)."""
    pen = r_obs[..., 1:-1, :]
    flat = pen.reshape(*pen.shape[:-2], -1)
    w = torch.softmax(beta * flat, dim=-1)
    return torch.sum(w * flat, dim=-1)


def one_step_loss(dtheta: torch.Tensor, target_delta: torch.Tensor,
                  err_sg: torch.Tensor, err_gp: torch.Tensor,
                  err_obs: torch.Tensor, weights: LossWeights, dof: int,
                  r_obs: Optional[torch.Tensor] = None) -> LossTerms:
    """The loss of one GN step.

    dtheta (B, T+1, D) the update; target_delta (B, T+1, D) the expert's
    remaining delta ``th_opt - th``; err_sg / err_gp / err_obs (B,) the
    unweighted graph errors at the new iterate; r_obs (B, T+1, L) its hinge
    residuals, needed when ``weights.max_pen_weight > 0``.
    """
    diff = dtheta - target_delta
    pos = torch.mean(torch.sum(diff[..., :dof] ** 2, dim=-1))
    vel = torch.mean(torch.sum(diff[..., dof:] ** 2, dim=-1))
    expert = pos + weights.vel_loss_lambda * vel
    gp = torch.mean(err_gp)
    sg = torch.mean(err_sg)
    obs = torch.mean(err_obs)
    ext = gp + sg + weights.ext_obs_lambda * obs
    total = weights.pos_loss_weight * expert + weights.ext_loss_weight * ext
    maxpen = torch.zeros((), dtype=total.dtype, device=total.device)
    if weights.max_pen_weight:
        if r_obs is None:
            raise ValueError("max_pen_weight > 0 requires r_obs")
        maxpen = torch.mean(smooth_max_penetration(r_obs,
                                                   weights.max_pen_beta))
        total = total + weights.max_pen_weight * maxpen
    return LossTerms(total=total, pos=pos, vel=vel, gp=gp, sg=sg, obs=obs,
                     ext=ext, maxpen=maxpen)


def mse_traj(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Sum over the state dimension, mean over the rest."""
    return torch.mean(torch.sum((pred - target) ** 2, dim=-1))


def huber_traj(pred: torch.Tensor, target: torch.Tensor,
               delta: float = 1.0) -> torch.Tensor:
    """Smooth-L1 over trajectories."""
    diff = torch.abs(pred - target)
    quad = torch.clamp(diff, max=delta)
    return torch.mean(0.5 * quad ** 2 + delta * (diff - quad))


def make_loss(name: str, **kwargs):
    """A trajectory loss by name: ``mse``, ``mse_traj`` or ``huber``
    (``delta`` keyword)."""
    if name == "mse":
        return lambda p, t: torch.mean((p - t) ** 2)
    if name == "mse_traj":
        return mse_traj
    if name == "huber":
        return lambda p, t: huber_traj(p, t, kwargs.get("delta", 1.0))
    raise ValueError(f"unknown loss {name!r}")
