"""Factor evaluations of the GPMP2 factor graph.

Port of ``dgpmp2_tpu/core/factors.py``: the CV-GP prior, start/goal priors,
the hinge obstacle factor, GP interpolation between support states, and the
nonholonomic, velocity-limit, self-collision, joint-limit and workspace-goal
factors.  Every factor returns ``(r, H)`` with ``H = -∂r/∂x``, so a
Gauss-Newton step solves ``(Σ HᵀΛH + δI) dθ = Σ HᵀΛ r``, ``θ ← θ + dθ``.
The nonholonomic Jacobian keeps the JAX package's consistent sign (the
original dGPMP2 factor flips the sign of its θ/velocity entries).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from dgpmp2_tpu_torch.ops import sdf as sdf_ops


def gp_phi(dof: int, dt: float, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """State transition ``Φ(dt) = [[I, dt·I], [0, I]]``."""
    eye = torch.eye(dof, dtype=dtype, device=device)
    zero = torch.zeros((dof, dof), dtype=dtype, device=device)
    return torch.cat([torch.cat([eye, dt * eye], dim=1),
                      torch.cat([zero, eye], dim=1)], dim=0)


def gp_q_inv(qc_inv: torch.Tensor, dt: float) -> torch.Tensor:
    """Expand ``Q_c⁻¹`` (..., dof, dof) to the GP inverse covariance
    ``[[12 dt⁻³, -6 dt⁻²], [-6 dt⁻², 4 dt⁻¹]] ⊗ Q_c⁻¹`` (..., 2·dof, 2·dof)."""
    m1 = 12.0 * dt**-3.0 * qc_inv
    m2 = -6.0 * dt**-2.0 * qc_inv
    m3 = 4.0 * dt**-1.0 * qc_inv
    return torch.cat([torch.cat([m1, m2], dim=-1),
                      torch.cat([m2, m3], dim=-1)], dim=-2)


def gp_residual(th: torch.Tensor, phi: torch.Tensor | None = None,
                dt: float | None = None) -> torch.Tensor:
    """GP residual ``r_i = x_{i+1} - Φ x_i`` for i = 0..T-1.

    th (..., T+1, D) with layout [pos(dof), vel(dof)] -> (..., T, D).  Pass
    ``dt`` (Φ applied in closed form) or ``phi``, whose (0, dof) entry is dt.
    The Jacobians are constant (``Φ`` w.r.t. x_i, ``-I`` w.r.t. x_{i+1}).
    """
    dof = th.shape[-1] // 2
    if dt is None:
        dt = phi[0, dof]
    prev = th[..., :-1, :]
    phi_x = torch.cat([prev[..., :dof] + dt * prev[..., dof:],
                       prev[..., dof:]], dim=-1)
    return th[..., 1:, :] - phi_x


def prior_residual(mean: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Unary anchor ``r = mean - x`` with ``H = I``."""
    return mean - x


def hinge_obstacle_residual(centers, jac_fk, radii, eps, sdf, res, x_lims,
                            y_lims, z_lims=None):
    """Hinge obstacle residual + Jacobian per trajectory state.

    centers (..., T, L, W), jac_fk (..., T, L, W, D), radii (L,),
    eps (..., T, L), sdf (..., H, Wim); W = 3 and a voxel sdf
    (..., D, H, Wim) when ``z_lims`` is set.  Returns r (..., T, L) and
    H (..., T, L, D).  One SDF lookup for all spheres of all states.
    """
    t, l = centers.shape[-3], centers.shape[-2]
    pts = centers.reshape(*centers.shape[:-3], t * l, centers.shape[-1])
    d, grad = sdf_ops.lookup_nd(sdf, pts, res, x_lims, y_lims, z_lims)
    d = d.reshape(*centers.shape[:-3], t, l)
    grad = grad.reshape(centers.shape)
    return hinge_from_lookup(d, grad, jac_fk, radii, eps)


def hinge_from_lookup(d, grad, jac_fk, radii, eps):
    """Hinge residual/Jacobian from SDF values and gradients.

    d (..., L), grad (..., L, W), jac_fk (..., L, W, D), eps (..., L).
    Returns r (..., L) and H = -∂r/∂x (..., L, D).
    """
    eps_tot = eps + radii
    active = d <= eps_tot
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    r = torch.where(active, eps_tot - d, zero)
    h_c = torch.where(active[..., None], grad, zero)
    return r, torch.sum(h_c[..., None] * jac_fk, dim=-2)


@functools.lru_cache(maxsize=None)
def gp_interp_coeffs(dof: int, dt: float, num_inter: int, dtype: torch.dtype,
                     device: torch.device | str):
    """Interpolation matrices Λ(τ_k), Ψ(τ_k) for τ_k = dt·k/(nip+1).

    CV-prior closed forms with ``Q_s = S(s) ⊗ Q_c`` (S the 2×2 kernel
    [[s³/3, s²/2], [s²/2, s]]) and ``Φ(s) = [[1, s], [0, 1]] ⊗ I``:
    ``Ψ(τ) = Q_τ Φ(Δ-τ)ᵀ Q_Δ⁻¹`` (Q_c cancels), ``Λ(τ) = Φ(τ) - Ψ(τ) Φ(Δ)``.
    Computed in float64 numpy, then cast, once per dtype and device.
    Returns (lam, psi) each (num_inter, D, D) with D = 2·dof.
    """
    def s_mat(s):
        return np.array([[s**3 / 3.0, s**2 / 2.0], [s**2 / 2.0, s]])

    def phi2(s):
        return np.array([[1.0, s], [0.0, 1.0]])

    lam2, psi2 = [], []
    q_d_inv = np.linalg.inv(s_mat(dt))
    for k in range(1, num_inter + 1):
        tau = dt * k / (num_inter + 1)
        psi = s_mat(tau) @ phi2(dt - tau).T @ q_d_inv
        lam2.append(phi2(tau) - psi @ phi2(dt))
        psi2.append(psi)
    eye = np.eye(dof)
    lam_full = np.stack([np.kron(m, eye) for m in lam2])
    psi_full = np.stack([np.kron(m, eye) for m in psi2])
    return (torch.tensor(lam_full, dtype=dtype, device=device),
            torch.tensor(psi_full, dtype=dtype, device=device))


def gp_interpolate(th: torch.Tensor, lam: torch.Tensor, psi: torch.Tensor):
    """Interpolated states x(τ_k) = Λ_k x_i + Ψ_k x_{i+1} of every GP
    segment: th (..., T+1, D), lam/psi (nip, D, D) -> (..., T, nip, D)."""
    x_i = th[..., :-1, None, None, :]  # (..., T, 1, 1, D)
    x_j = th[..., 1:, None, None, :]
    return torch.sum(lam * x_i, dim=-1) + torch.sum(psi * x_j, dim=-1)


def nonholonomic_residual(th: torch.Tensor):
    """Unicycle constraint on ``[x, y, θ, vx, vy, ω]``: ``r = vy·cosθ -
    vx·sinθ`` (..., T) and ``H = -∂r/∂x`` (..., T, 6)."""
    theta, vx, vy = th[..., 2], th[..., 3], th[..., 4]
    s, c = torch.sin(theta), torch.cos(theta)
    r = vy * c - vx * s
    zeros = torch.zeros_like(r)
    return r, torch.stack([zeros, zeros, vy * s + vx * c, s, -c, zeros],
                          dim=-1)


def velocity_limit_residual(th: torch.Tensor, v_lim: torch.Tensor, dof: int):
    """Per-axis velocity hinge ``r_k = max(0, |v_k| - v_lim_k)`` with
    ``H_k = -sign(v_k)·e_{v_k}`` inside the hinge (active at ``|v| >=
    v_lim``).  th (..., T, D), v_lim (..., T, dof) -> r (..., T, dof),
    H (..., T, dof, D)."""
    d = th.shape[-1]
    v = th[..., dof:]
    over = torch.abs(v) >= v_lim
    zero = torch.zeros((), dtype=th.dtype, device=th.device)
    r = torch.where(over, torch.abs(v) - v_lim, zero)
    sign = torch.where(over, -torch.sign(v), zero)
    h_v = sign[..., :, None] * torch.eye(dof, dtype=th.dtype, device=th.device)
    return r, torch.cat([h_v.new_zeros((*h_v.shape[:-1], d - dof)), h_v],
                        dim=-1)


def self_collision_residual(centers, jac_fk, radii, pairs_i, pairs_j,
                            eps_self):
    """Sphere-sphere self-collision hinge per configured pair (i, j):
    ``r_p = max(0, (ε_p + radius_i + radius_j) − ‖c_i − c_j‖)`` with
    ``H = û·(J_i − J_j)`` inside the hinge (active at ``dist <= thresh``;
    ``dist = sqrt(Σ diff² + 1e-12)``).

    centers (..., L, W), jac_fk (..., L, W, D), radii (L,), pairs_i/pairs_j
    (P,) int64 tensors, eps_self (..., P) -> r (..., P), H (..., P, D).
    """
    diff = centers[..., pairs_i, :] - centers[..., pairs_j, :]  # (..., P, W)
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
    thresh = eps_self + radii[pairs_i] + radii[pairs_j]
    active = dist <= thresh
    zero = torch.zeros((), dtype=dist.dtype, device=dist.device)
    r = torch.where(active, thresh - dist, zero)
    u = torch.where(active[..., None], diff / dist[..., None], zero)
    jdiff = jac_fk[..., pairs_i, :, :] - jac_fk[..., pairs_j, :, :]
    return r, torch.sum(u[..., None] * jdiff, dim=-2)


def joint_limit_residual(th: torch.Tensor, q_min: torch.Tensor,
                         q_max: torch.Tensor, dof: int):
    """Per-joint position hinge ``r_k = max(0, q_k − q_max_k) + max(0,
    q_min_k − q_k)`` (active at ``>=`` and ``<=``) with ``H_k = ∓e_{q_k}``.
    th (..., T, D), q_min/q_max (..., T, dof) -> r (..., T, dof),
    H (..., T, dof, D)."""
    d = th.shape[-1]
    q = th[..., :dof]
    over = q >= q_max
    under = q <= q_min
    zero = torch.zeros((), dtype=th.dtype, device=th.device)
    r = torch.where(over, q - q_max, zero) + torch.where(under, q_min - q, zero)
    sign = (torch.where(over, -1.0, zero) + torch.where(under, 1.0, zero))
    h_q = sign[..., :, None] * torch.eye(dof, dtype=th.dtype, device=th.device)
    return r, torch.cat([h_q, h_q.new_zeros((*h_q.shape[:-1], d - dof))],
                        dim=-1)


def workspace_goal_residual(centers_end, jac_end, p_goal):
    """End-effector workspace goal on the last body sphere (the tip) of the
    terminal state: ``r = p_goal − tip(q_T)``, ``H = J_tip``.
    centers_end (..., L, W), jac_end (..., L, W, D), p_goal (..., W) ->
    r (..., W), H (..., W, D)."""
    return p_goal - centers_end[..., -1, :], jac_end[..., -1, :, :]
