"""Factor-graph specification and block-tridiagonal normal-equation assembly.

Port of ``dgpmp2_tpu/core/graph.py`` for the main path (CV-GP prior,
start/goal priors, hinge obstacle factors) in 2-D and 3-D workspaces.  ``AᵀKA`` is assembled directly
as its ``D×D`` blocks,

    diag_i = Σ H_fᵀ Λ_f H_f over factors touching state i
    off_i  = -Φᵀ Q⁻¹_i        (the only coupling: the GP factor)
    rhs_i  = Σ H_fᵀ Λ_f r_f

and ``A``/``K`` are never formed.  The optional factors of the JAX package
raise ``NotImplementedError`` when enabled in a :class:`GraphSpec`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from dgpmp2_tpu_torch.core import factors
from dgpmp2_tpu_torch.robots import RobotModel


def _mv(mat, vec):
    """(..., i, j) x (..., j) -> (..., i)."""
    return torch.sum(mat * vec[..., None, :], dim=-1)


def _phiT_left(q, dof, dt):
    """Φᵀ·Q for Φᵀ = [[I, 0], [dt·I, I]] (block adds, no matmul)."""
    top = q[..., :dof, :]
    return torch.cat([top, dt * top + q[..., dof:, :]], dim=-2)


def _phi_right(m, dof, dt):
    """M·Φ with Φ = [[I, dt·I], [0, I]]."""
    left = m[..., :, :dof]
    return torch.cat([left, dt * left + m[..., :, dof:]], dim=-1)


def _pad_time(x, before, after, vec=False):
    """Zero-pad the time axis (-2 for vectors, -3 for blocks)."""
    pad = [0, 0] if vec else [0, 0, 0, 0]
    return F.pad(x, pad + [before, after])


_OPTIONAL = ("non_holonomic", "use_vel_limits", "use_gp_inter",
             "use_self_collision", "use_joint_limits", "use_workspace_goal")


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """Static problem dimensions and options (as the JAX package's)."""

    dof: int = 2
    state_dim: int = 4
    total_time_sec: float = 10.0
    total_time_step: int = 100  # T; the trajectory has T+1 states
    nlinks: int = 1
    x_lims: Tuple[float, float] = (-5.0, 5.0)
    y_lims: Tuple[float, float] = (-5.0, 5.0)
    z_lims: Optional[Tuple[float, float]] = None
    non_holonomic: bool = False
    use_vel_limits: bool = False
    use_gp_inter: bool = False
    use_self_collision: bool = False
    use_joint_limits: bool = False
    use_workspace_goal: bool = False

    def __post_init__(self):
        enabled = [f for f in _OPTIONAL if getattr(self, f)]
        if enabled:
            raise NotImplementedError(
                f"GraphSpec options {enabled} are not ported to "
                "dgpmp2_tpu_torch yet (ROADMAP.md, queue 1 item 9)"
            )

    @property
    def num_traj_states(self) -> int:
        return self.total_time_step + 1

    @property
    def num_gp_factors(self) -> int:
        return self.total_time_step

    @property
    def dt(self) -> float:
        return float(self.total_time_sec) / float(self.total_time_step)

    @property
    def M(self) -> int:
        """Total residual dimension, the error normaliser."""
        return (self.state_dim * (self.num_gp_factors + 2)
                + self.num_traj_states * self.nlinks)

    @property
    def N(self) -> int:
        return self.state_dim * self.num_traj_states

    def res(self, sdf_width: int) -> float:
        """Metres per pixel, from the x extent and the SDF width."""
        return (self.x_lims[1] - self.x_lims[0]) / float(sdf_width)

    def validate_grid(self, sdf_shape) -> None:
        """Raise unless the SDF's y (and, with ``z_lims``, z) cells match the
        x-derived resolution."""
        r = self.res(sdf_shape[-1])
        checks = [("y_lims", self.y_lims, sdf_shape[-2])]
        if self.z_lims is not None:
            checks.append(("z_lims", self.z_lims, sdf_shape[-3]))
        for name, lims, cells in checks:
            ext = lims[1] - lims[0]
            got = ext / float(cells)
            if abs(got - r) > 1e-6 * max(abs(r), 1.0):
                raise ValueError(
                    f"SDF grid inconsistent with workspace extents: {name} "
                    f"extent {ext} over {cells} cells gives {got:.6g} m/cell "
                    f"but x-derived res is {r:.6g} m/cell (sdf shape "
                    f"{tuple(sdf_shape)}, x_lims {self.x_lims}, y_lims "
                    f"{self.y_lims}, z_lims {self.z_lims}); voxels must be "
                    "square/cubical"
                )


@dataclasses.dataclass
class GraphParams:
    """Per-problem factor parameters (B = batch, T = total_time_step).

    start, goal (B, D); q_inv (B, T, D, D); ks_inv, kg_inv (B, D, D);
    obs_inv (B, T+1, L, L); eps (B, T+1, L).  The optional fields of the JAX
    package stay ``None`` until their factors are ported.
    """

    start: torch.Tensor
    goal: torch.Tensor
    q_inv: torch.Tensor
    ks_inv: torch.Tensor
    kg_inv: torch.Tensor
    obs_inv: torch.Tensor
    eps: torch.Tensor
    dyn_inv: Optional[torch.Tensor] = None
    vel_inv: Optional[torch.Tensor] = None
    v_lim: Optional[torch.Tensor] = None
    self_inv: Optional[torch.Tensor] = None
    self_eps: Optional[torch.Tensor] = None
    jl_inv: Optional[torch.Tensor] = None
    q_min: Optional[torch.Tensor] = None
    q_max: Optional[torch.Tensor] = None
    wg_inv: Optional[torch.Tensor] = None
    p_goal: Optional[torch.Tensor] = None


@dataclasses.dataclass
class FactorResiduals:
    """Factor residuals and Jacobians at one linearisation point.

    r_gp (B, T, D), r_s/r_g (B, D), r_obs (B, T+1, L), h_obs (B, T+1, L, D).
    """

    r_gp: torch.Tensor
    r_s: torch.Tensor
    r_g: torch.Tensor
    r_obs: torch.Tensor
    h_obs: torch.Tensor
    r_dyn: Optional[torch.Tensor] = None
    h_dyn: Optional[torch.Tensor] = None
    r_vel: Optional[torch.Tensor] = None
    h_vel: Optional[torch.Tensor] = None
    r_obsi: Optional[torch.Tensor] = None
    h_obsi: Optional[torch.Tensor] = None
    r_self: Optional[torch.Tensor] = None
    h_self: Optional[torch.Tensor] = None
    r_jl: Optional[torch.Tensor] = None
    h_jl: Optional[torch.Tensor] = None
    r_wg: Optional[torch.Tensor] = None
    h_wg: Optional[torch.Tensor] = None


def select(mask: torch.Tensor, a, b):
    """Per-problem select between two dataclasses of (B, ...) tensors
    (``None`` fields stay ``None``)."""
    out = {}
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        out[f.name] = None if x is None else torch.where(
            mask.reshape(mask.shape + (1,) * (x.ndim - 1)), x, y)
    return type(a)(**out)


def eval_residuals(spec: GraphSpec, robot: RobotModel, params: GraphParams,
                   th: torch.Tensor, sdf: torch.Tensor) -> FactorResiduals:
    """Evaluate every factor once at ``th`` (one SDF lookup in all)."""
    spec.validate_grid(sdf.shape)
    r_gp = factors.gp_residual(th, dt=spec.dt)
    r_s = factors.prior_residual(params.start, th[..., 0, :])
    r_g = factors.prior_residual(params.goal, th[..., -1, :])
    centers, jac_fk = robot.fk(th)
    r_obs, h_obs = factors.hinge_obstacle_residual(
        centers, jac_fk, robot.radii_array(th.dtype, th.device), params.eps,
        sdf, spec.res(sdf.shape[-1]), spec.x_lims, spec.y_lims, spec.z_lims,
    )
    return FactorResiduals(r_gp=r_gp, r_s=r_s, r_g=r_g, r_obs=r_obs,
                           h_obs=h_obs)


@dataclasses.dataclass
class StaticBlocks:
    """Iteration-invariant pieces of the normal equations: diag_static
    (B, T+1, D, D) GP/prior Gauss terms, off (B, T, D, D) = -ΦᵀQ⁻¹, and
    phiT_q (B, T, D, D) = ΦᵀQ⁻¹ for the GP rhs."""

    diag_static: torch.Tensor
    off: torch.Tensor
    phiT_q: torch.Tensor


def assemble_static(spec: GraphSpec, params: GraphParams,
                    dtype: torch.dtype) -> StaticBlocks:
    """GP + prior Gauss blocks (constant across iterations):
    diag_i += ΦᵀQ⁻¹Φ, diag_{i+1} += Q⁻¹, off_i = -ΦᵀQ⁻¹, endpoints += K⁻¹."""
    dof = spec.dof
    q_inv = params.q_inv
    phiT_q = _phiT_left(q_inv, dof, spec.dt).to(dtype)
    diag = (_pad_time(_phi_right(phiT_q, dof, spec.dt), 0, 1)
            + _pad_time(q_inv, 1, 0))
    ends = torch.stack([params.ks_inv, params.kg_inv], dim=-3)  # (B, 2, D, D)
    diag = diag + _pad_time(ends[..., :1, :, :], 0, spec.total_time_step)
    diag = diag + _pad_time(ends[..., 1:, :, :], spec.total_time_step, 0)
    return StaticBlocks(diag_static=diag.to(dtype), off=-phiT_q, phiT_q=phiT_q)


def assemble_from_residuals(spec: GraphSpec, params: GraphParams,
                            res: FactorResiduals,
                            dtype: torch.dtype | None = None,
                            static: StaticBlocks | None = None):
    """Block-tridiagonal GN normal equations from residuals.

    Returns diag (B, T+1, D, D), off (B, T, D, D), rhs (B, T+1, D).  Pass a
    precomputed ``static`` (:func:`assemble_static`) inside iteration loops.
    """
    dtype = res.r_gp.dtype if dtype is None else dtype
    if static is None:
        static = assemble_static(spec, params, dtype)
    t = spec.total_time_step
    r_gp = res.r_gp
    # rhs_i += ΦᵀQ⁻¹ r ; rhs_{i+1} -= Q⁻¹ r ; endpoints += K⁻¹ r
    rhs = (_pad_time(_mv(static.phiT_q, r_gp), 0, 1, vec=True)
           - _pad_time(_mv(params.q_inv, r_gp), 1, 0, vec=True))
    rhs = rhs + _pad_time(_mv(params.ks_inv, res.r_s)[..., None, :], 0, t,
                          vec=True)
    rhs = rhs + _pad_time(_mv(params.kg_inv, res.r_g)[..., None, :], t, 0,
                          vec=True)
    # Obstacle factors (unary): diag += Σ_k h_k ⊗ (Λh)_k, rhs += Σ_k (Λh)_k r_k
    h = res.h_obs
    lam_h = torch.sum(params.obs_inv[..., :, :, None] * h[..., None, :, :],
                      dim=-2)
    diag = static.diag_static + torch.sum(
        h[..., :, :, None] * lam_h[..., :, None, :], dim=-3)
    rhs = rhs + torch.sum(lam_h * res.r_obs[..., None], dim=-2)
    return diag, static.off, rhs


def assemble(spec: GraphSpec, robot: RobotModel, params: GraphParams,
             th: torch.Tensor, sdf: torch.Tensor):
    """Normal equations at linearisation point ``th``."""
    res = eval_residuals(spec, robot, params, th, sdf)
    return assemble_from_residuals(spec, params, res, dtype=th.dtype)


def error_from_residuals(spec: GraphSpec, params: GraphParams,
                         res: FactorResiduals,
                         q_inv: torch.Tensor | None = None,
                         obs_inv: torch.Tensor | None = None) -> torch.Tensor:
    """``(Σ_f ½ r_fᵀ Λ_f r_f) / M`` per problem (B,); ``q_inv``/``obs_inv``
    override the GP/obstacle weights (fixed external covariances)."""
    q_inv = params.q_inv if q_inv is None else q_inv
    obs_inv = params.obs_inv if obs_inv is None else obs_inv
    err = 0.5 * torch.sum(_mv(params.ks_inv, res.r_s) * res.r_s, dim=-1)
    err = err + 0.5 * torch.sum(_mv(params.kg_inv, res.r_g) * res.r_g, dim=-1)
    err = err + 0.5 * torch.sum(_mv(q_inv, res.r_gp) * res.r_gp, dim=(-2, -1))
    err = err + 0.5 * torch.sum(_mv(obs_inv, res.r_obs) * res.r_obs,
                                dim=(-2, -1))
    return err / spec.M


def graph_error(spec: GraphSpec, robot: RobotModel, params: GraphParams,
                th: torch.Tensor, sdf: torch.Tensor,
                q_inv: torch.Tensor | None = None,
                obs_inv: torch.Tensor | None = None) -> torch.Tensor:
    """Total weighted factor-graph error at ``th``, normalised by M."""
    res = eval_residuals(spec, robot, params, th, sdf)
    return error_from_residuals(spec, params, res, q_inv, obs_inv)


def obstacle_residuals(spec: GraphSpec, robot: RobotModel,
                       params: GraphParams, th: torch.Tensor,
                       sdf: torch.Tensor) -> torch.Tensor:
    """Raw per-state hinge residuals (B, T+1, L) for collision metrics."""
    centers, jac_fk = robot.fk(th)
    r_obs, _ = factors.hinge_obstacle_residual(
        centers, jac_fk, robot.radii_array(th.dtype, th.device), params.eps,
        sdf, spec.res(sdf.shape[-1]), spec.x_lims, spec.y_lims, spec.z_lims,
    )
    return r_obs


def default_params(spec: GraphSpec, robot: RobotModel, start: torch.Tensor,
                   goal: torch.Tensor, qc_inv, cost_sigma, epsilon_dist, k_s,
                   k_g, dtype: torch.dtype = torch.float32) -> GraphParams:
    """Fixed-covariance GraphParams from the YAML scalars, on ``start``'s
    device: ``K_s⁻¹ = I/K_s²``, ``K_g⁻¹ = I/K_g²``, obstacle ``Λ = I/σ²``
    and GP ``Q⁻¹`` expanded from ``Q_c⁻¹``.  start, goal (B, D)."""
    dev = start.device
    b = start.shape[0]
    d, tn, t, l = (spec.state_dim, spec.num_traj_states, spec.total_time_step,
                   spec.nlinks)
    qc = torch.as_tensor(qc_inv, dtype=dtype, device=dev)
    q_inv = factors.gp_q_inv(qc.expand(b, t, spec.dof, spec.dof), spec.dt)
    eye_d = torch.eye(d, dtype=dtype, device=dev)
    obs = torch.eye(l, dtype=dtype, device=dev) / float(cost_sigma) ** 2
    return GraphParams(
        start=start.to(dtype),
        goal=goal.to(dtype),
        q_inv=q_inv,
        ks_inv=(eye_d / float(k_s) ** 2).expand(b, d, d),
        kg_inv=(eye_d / float(k_g) ** 2).expand(b, d, d),
        obs_inv=obs.expand(b, tn, l, l),
        eps=torch.full((b, tn, l), float(epsilon_dist), dtype=dtype,
                       device=dev),
    )
