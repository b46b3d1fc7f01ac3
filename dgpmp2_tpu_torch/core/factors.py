"""Factor evaluations of the GPMP2 factor graph (main-path subset).

Port of ``dgpmp2_tpu/core/factors.py``: the CV-GP prior, start/goal priors
and the hinge obstacle factor.  Every factor returns ``(r, H)`` with
``H = -∂r/∂x``, so a Gauss-Newton step solves
``(Σ HᵀΛH + δI) dθ = Σ HᵀΛ r``, ``θ ← θ + dθ``.
"""
from __future__ import annotations

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
