"""Factor-graph specification and block-tridiagonal normal-equation assembly.

Port of ``dgpmp2_tpu/core/graph.py`` in 2-D and 3-D workspaces, with every
factor of the JAX package: the CV-GP prior, start/goal priors, hinge
obstacle factors, and the optional nonholonomic, velocity-limit,
GP-interpolated obstacle, self-collision, joint-limit and workspace-goal
factors.  ``AᵀKA`` is assembled directly as its ``D×D`` blocks,

    diag_i = Σ H_fᵀ Λ_f H_f over factors touching state i
    off_i  = -Φᵀ Q⁻¹_i (+ the GP-interpolated obstacle couplings)
    rhs_i  = Σ H_fᵀ Λ_f r_f

and ``A``/``K`` are never formed.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dgpmp2_tpu_torch.core import factors
from dgpmp2_tpu_torch.ops import sdf as sdf_ops
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


@functools.lru_cache(maxsize=None)
def pair_index(self_pairs: Tuple[Tuple[int, int], ...],
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pairs_i, pairs_j) int64 index tensors of ``self_pairs``, made once
    per device."""
    pairs = torch.tensor(self_pairs, dtype=torch.int64,
                         device=device).reshape(-1, 2)
    return pairs[:, 0], pairs[:, 1]


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """Static problem dimensions and options (as the JAX package's).

    ``use_gp_inter`` adds ``num_inter`` obstacle checks per GP segment at the
    CV-GP posterior mean; ``self_pairs`` are the (sphere_i, sphere_j) pairs
    of the self-collision factor (``robots.self_collision_pairs``).
    """

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
    num_inter: int = 3
    use_self_collision: bool = False
    self_pairs: Tuple[Tuple[int, int], ...] = ()
    use_joint_limits: bool = False
    use_workspace_goal: bool = False

    @property
    def num_self_pairs(self) -> int:
        return len(self.self_pairs)

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
        m = self.state_dim * (self.num_gp_factors + 2)
        m += self.num_traj_states * self.nlinks
        if self.non_holonomic:
            m += self.num_traj_states
        if self.use_vel_limits:
            m += self.dof * self.num_traj_states
        if self.use_joint_limits:
            m += self.dof * self.num_traj_states
        if self.use_workspace_goal:
            m += 2  # wksp_dim rows at the terminal state
        if self.use_self_collision:
            m += self.num_self_pairs * self.num_traj_states
        if self.use_gp_inter:
            m += self.num_gp_factors * self.num_inter * self.nlinks
        return m

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
    """Per-problem factor parameters (B = batch, T = total_time_step,
    L = nlinks, P = self-collision pairs, W = workspace dim).

    start, goal (B, D); q_inv (B, T, D, D); ks_inv, kg_inv (B, D, D);
    obs_inv (B, T+1, L, L); eps (B, T+1, L); and, ``None`` unless their
    factor is enabled: dyn_inv (B, T+1); vel_inv (B, T+1, dof, dof) with
    v_lim (B, T+1, dof); self_inv, self_eps (B, T+1, P); jl_inv
    (B, T+1, dof, dof) with q_min, q_max (B, T+1, dof); wg_inv (B, W, W) with
    p_goal (B, W).
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

    r_gp (B, T, D), r_s/r_g (B, D), r_obs (B, T+1, L), h_obs (B, T+1, L, D);
    optional: r_dyn (B, T+1), h_dyn (B, T+1, D); r_vel, r_jl (B, T+1, dof)
    with h (B, T+1, dof, D); r_obsi (B, T, nip, L) with h_obsi
    (B, T, nip, L, D) w.r.t. the interpolated state; r_self (B, T+1, P) with
    h_self (B, T+1, P, D); r_wg (B, W) with h_wg (B, W, D).
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


@dataclasses.dataclass
class Geometry:
    """The part of a factor-graph evaluation that no GraphParams field
    changes: the robot's spheres at ``th`` and their SDF lookup.

    centers (B, T+1, L, W), jac_fk (B, T+1, L, W, D), d (B, T+1, L), grad
    (B, T+1, L, W); under ``use_gp_inter`` the same at the interpolated
    states: centers_i, jac_fk_i, d_i (B, T, nip, L), grad_i.  One SDF lookup
    covers all of them.
    """

    centers: torch.Tensor
    jac_fk: torch.Tensor
    d: torch.Tensor
    grad: torch.Tensor
    centers_i: Optional[torch.Tensor] = None
    jac_fk_i: Optional[torch.Tensor] = None
    d_i: Optional[torch.Tensor] = None
    grad_i: Optional[torch.Tensor] = None


def eval_geometry(spec: GraphSpec, robot: RobotModel, th: torch.Tensor,
                  sdf: torch.Tensor) -> Geometry:
    """FK and the one SDF lookup at ``th`` (under ``use_gp_inter`` it covers
    the support and the interpolated states)."""
    spec.validate_grid(sdf.shape)
    centers, jac_fk = robot.fk(th)
    b_shape = th.shape[:-2]
    wd = centers.shape[-1]
    tn, l = spec.num_traj_states, spec.nlinks
    pts = centers.reshape(*b_shape, tn * l, wd)
    out = {}
    if spec.use_gp_inter:
        lam, psi = factors.gp_interp_coeffs(spec.dof, spec.dt, spec.num_inter,
                                            th.dtype, th.device)
        th_tau = factors.gp_interpolate(th, lam, psi)  # (B, T, nip, D)
        out["centers_i"], out["jac_fk_i"] = robot.fk(th_tau)
        pts = torch.cat([pts, out["centers_i"].reshape(*b_shape, -1, wd)],
                        dim=-2)
    d_all, grad_all = sdf_ops.lookup_nd(
        sdf, pts, spec.res(sdf.shape[-1]), spec.x_lims, spec.y_lims,
        spec.z_lims)
    if spec.use_gp_inter:
        t, nip = spec.num_gp_factors, spec.num_inter
        out["d_i"] = d_all[..., tn * l:].reshape(*b_shape, t, nip, l)
        out["grad_i"] = grad_all[..., tn * l:, :].reshape(*b_shape, t, nip,
                                                          l, wd)
        d_all, grad_all = d_all[..., :tn * l], grad_all[..., :tn * l, :]
    return Geometry(centers=centers, jac_fk=jac_fk,
                    d=d_all.reshape(*b_shape, tn, l),
                    grad=grad_all.reshape(centers.shape), **out)


def residuals_from_geometry(spec: GraphSpec, robot: RobotModel,
                            params: GraphParams, th: torch.Tensor,
                            geom: Geometry) -> FactorResiduals:
    """Every factor at ``th`` from its :class:`Geometry` (no lookup): one
    geometry serves every GraphParams at the same ``th``."""
    dtype, dev = th.dtype, th.device
    r_gp = factors.gp_residual(th, dt=spec.dt)
    r_s = factors.prior_residual(params.start, th[..., 0, :])
    r_g = factors.prior_residual(params.goal, th[..., -1, :])
    centers, jac_fk = geom.centers, geom.jac_fk
    radii = robot.radii_array(dtype, dev)
    r_obs, h_obs = factors.hinge_from_lookup(geom.d, geom.grad, jac_fk, radii,
                                             params.eps)
    out = {}
    if spec.use_gp_inter:
        eps_i = params.eps[..., :-1, None, :]  # left-support margin
        out["r_obsi"], out["h_obsi"] = factors.hinge_from_lookup(
            geom.d_i, geom.grad_i, geom.jac_fk_i, radii, eps_i)
    if spec.non_holonomic:
        out["r_dyn"], out["h_dyn"] = factors.nonholonomic_residual(th)
    if spec.use_vel_limits:
        out["r_vel"], out["h_vel"] = factors.velocity_limit_residual(
            th, params.v_lim, spec.dof)
    if spec.use_joint_limits:
        out["r_jl"], out["h_jl"] = factors.joint_limit_residual(
            th, params.q_min, params.q_max, spec.dof)
    if spec.use_self_collision:
        pairs_i, pairs_j = pair_index(spec.self_pairs, dev)
        out["r_self"], out["h_self"] = factors.self_collision_residual(
            centers, jac_fk, radii, pairs_i, pairs_j, params.self_eps)
    if spec.use_workspace_goal:
        out["r_wg"], out["h_wg"] = factors.workspace_goal_residual(
            centers[..., -1, :, :], jac_fk[..., -1, :, :, :], params.p_goal)
    return FactorResiduals(r_gp=r_gp, r_s=r_s, r_g=r_g, r_obs=r_obs,
                           h_obs=h_obs, **out)


def eval_residuals(spec: GraphSpec, robot: RobotModel, params: GraphParams,
                   th: torch.Tensor, sdf: torch.Tensor) -> FactorResiduals:
    """Evaluate every factor once at ``th`` (one SDF lookup in all: under
    ``use_gp_inter`` it covers the support and the interpolated states)."""
    return residuals_from_geometry(spec, robot, params, th,
                                   eval_geometry(spec, robot, th, sdf))


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


# Above this many elements, a broadcast product summed over one axis is
# formed as a batched matrix product instead: the crossover measured on an
# H100 at every assembly of tools/time_contract.py.  Up to 1.4e7 elements
# the broadcast form is the faster (a batched GEMM costs 0.09-0.28 ms a call
# at small blocks), from 2.1e7 the matrix product; far above, the broadcast
# intermediate outgrows memory (a 17-link arm's 411 self-collision pairs:
# 80 GB in float32 at B=1024).
BROADCAST_MAX = 1 << 24


def _contract(x, y, dim, matmul, a, b):
    """``Σ_dim x * y`` (x, y broadcast views of ``a``, ``b``), or
    ``matmul(a, b)`` in their promoted dtype when the broadcast product
    would hold more than :data:`BROADCAST_MAX` elements."""
    n = torch.broadcast_shapes(x.shape, y.shape).numel()
    if n <= BROADCAST_MAX:
        return torch.sum(x * y, dim=dim)
    dt = torch.promote_types(a.dtype, b.dtype)
    return matmul(a.to(dt), b.to(dt))


def _lam_full(w, h):
    """Λh for a full (K, K) inverse covariance ``w`` and rows ``h``."""
    return _contract(w[..., :, :, None], h[..., None, :, :], -2,
                     lambda a, b: a @ b, w, h)


def workspace_goal_terms(params: GraphParams, res: FactorResiduals):
    """The workspace goal's Gauss terms at the last state: HᵀΛH (B, D, D)
    and HᵀΛr (B, D)."""
    lam_hw = _lam_full(params.wg_inv, res.h_wg)  # (B, W, D)
    return (torch.sum(res.h_wg[..., :, :, None] * lam_hw[..., :, None, :],
                      dim=-3),
            torch.sum(lam_hw * res.r_wg[..., None], dim=-2))


def gp_interp_terms(spec: GraphSpec, params: GraphParams,
                    res: FactorResiduals, dtype: torch.dtype):
    """The GP-interpolated obstacle factors' terms, each summed per segment
    (B, T, ...): diag of the left and the right support state, their
    coupling (added to ``off``), and the left and right rhs.  These binary
    factors on (x_t, x_{t+1}) chain H through the interpolation matrices:
    a_L = Λᵀhᵀ and a_P = Ψᵀhᵀ."""
    lam_m, psi_m = factors.gp_interp_coeffs(
        spec.dof, spec.dt, spec.num_inter, dtype, res.r_gp.device)
    h_i = res.h_obsi  # (B, T, nip, L, D) w.r.t. the interpolated state
    lam_t = lam_m.transpose(-1, -2)[:, None, :, :]  # (nip, 1, D, D)
    psi_t = psi_m.transpose(-1, -2)[:, None, :, :]
    a_l = torch.sum(lam_t * h_i[..., None, :], dim=-1)  # (B,T,nip,L,D)
    a_p = torch.sum(psi_t * h_i[..., None, :], dim=-1)
    w = params.obs_inv[..., :-1, None, :, :]  # left-support Λ_obs
    lam_al = _lam_full(w, a_l)
    lam_ap = _lam_full(w, a_p)
    lam_r = torch.sum(w * res.r_obsi[..., None, :], dim=-1)  # (B,T,nip,L)
    return (torch.sum(a_l[..., :, None] * lam_al[..., None, :], dim=(-4, -3)),
            torch.sum(a_p[..., :, None] * lam_ap[..., None, :], dim=(-4, -3)),
            torch.sum(a_l[..., :, None] * lam_ap[..., None, :], dim=(-4, -3)),
            torch.sum(a_l * lam_r[..., None], dim=(-3, -2)),
            torch.sum(a_p * lam_r[..., None], dim=(-3, -2)))


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
    diag = static.diag_static

    def unary_gauss(diag, rhs, h, r, lam_h):
        """Per-state Gauss terms of a unary factor with K residual rows:
        diag += Σ_k h_k ⊗ (Λh)_k, rhs += Σ_k (Λh)_k r_k."""
        diag = diag + _contract(h[..., :, :, None], lam_h[..., :, None, :],
                                -3, lambda a, b: a.transpose(-1, -2) @ b,
                                h, lam_h)
        return diag, rhs + torch.sum(lam_h * r[..., None], dim=-2)

    diag, rhs = unary_gauss(diag, rhs, res.h_obs, res.r_obs,
                            _lam_full(params.obs_inv, res.h_obs))
    if spec.non_holonomic:
        h_dyn = res.h_dyn[..., None, :]  # (B, T+1, 1, D)
        diag, rhs = unary_gauss(diag, rhs, h_dyn, res.r_dyn[..., None],
                                params.dyn_inv[..., None, None] * h_dyn)
    if spec.use_vel_limits:
        diag, rhs = unary_gauss(diag, rhs, res.h_vel, res.r_vel,
                                _lam_full(params.vel_inv, res.h_vel))
    if spec.use_joint_limits:
        diag, rhs = unary_gauss(diag, rhs, res.h_jl, res.r_jl,
                                _lam_full(params.jl_inv, res.h_jl))
    if spec.use_self_collision:
        diag, rhs = unary_gauss(diag, rhs, res.h_self, res.r_self,
                                params.self_inv[..., None] * res.h_self)
    if spec.use_workspace_goal:  # unary at the last state
        d_wg, r_wg = workspace_goal_terms(params, res)
        diag = diag + _pad_time(d_wg[..., None, :, :], t, 0)
        rhs = rhs + _pad_time(r_wg[..., None, :], t, 0, vec=True)
    off = static.off
    if spec.use_gp_inter:
        # ``off`` becomes a new tensor; the static blocks stay as they are.
        d_l, d_p, d_off, r_l, r_p = gp_interp_terms(spec, params, res, dtype)
        diag = diag + _pad_time(d_l, 0, 1)
        diag = diag + _pad_time(d_p, 1, 0)
        off = off + d_off
        rhs = rhs + _pad_time(r_l, 0, 1, vec=True)
        rhs = rhs + _pad_time(r_p, 1, 0, vec=True)
    return diag, off, rhs


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
    if spec.non_holonomic:
        err = err + 0.5 * torch.sum(params.dyn_inv * res.r_dyn**2, dim=-1)
    if spec.use_vel_limits:
        err = err + 0.5 * torch.sum(_mv(params.vel_inv, res.r_vel) * res.r_vel,
                                    dim=(-2, -1))
    if spec.use_joint_limits:
        err = err + 0.5 * torch.sum(_mv(params.jl_inv, res.r_jl) * res.r_jl,
                                    dim=(-2, -1))
    if spec.use_self_collision:
        err = err + 0.5 * torch.sum(params.self_inv * res.r_self**2,
                                    dim=(-2, -1))
    if spec.use_workspace_goal:
        err = err + 0.5 * torch.sum(_mv(params.wg_inv, res.r_wg) * res.r_wg,
                                    dim=-1)
    if spec.use_gp_inter:
        w = obs_inv[..., :-1, None, :, :]
        err = err + 0.5 * torch.sum(
            torch.sum(w * res.r_obsi[..., None, :], dim=-1) * res.r_obsi,
            dim=(-3, -2, -1))
    return err / spec.M


def graph_error(spec: GraphSpec, robot: RobotModel, params: GraphParams,
                th: torch.Tensor, sdf: torch.Tensor,
                q_inv: torch.Tensor | None = None,
                obs_inv: torch.Tensor | None = None) -> torch.Tensor:
    """Total weighted factor-graph error at ``th``, normalised by M."""
    res = eval_residuals(spec, robot, params, th, sdf)
    return error_from_residuals(spec, params, res, q_inv, obs_inv)


def unweighted_errors_from_residuals(res: FactorResiduals):
    """Unweighted per-term errors for task losses, each (B,):
    ``err_sg = ½‖r_start‖² + ½‖r_goal‖²``, ``err_gp = mean_t ½‖r_gp,t‖²``,
    ``err_obs = mean_t ½‖r_obs,t‖²``."""
    err_sg = (0.5 * torch.sum(res.r_s**2, -1)
              + 0.5 * torch.sum(res.r_g**2, -1))
    err_gp = torch.mean(0.5 * torch.sum(res.r_gp**2, -1), dim=-1)
    err_obs = torch.mean(0.5 * torch.sum(res.r_obs**2, -1), dim=-1)
    return err_sg, err_gp, err_obs


def unweighted_errors(spec: GraphSpec, robot: RobotModel,
                      params: GraphParams, th: torch.Tensor,
                      sdf: torch.Tensor):
    return unweighted_errors_from_residuals(
        eval_residuals(spec, robot, params, th, sdf))


def linear_error(spec: GraphSpec, robot: RobotModel, params: GraphParams,
                 th: torch.Tensor, sdf: torch.Tensor) -> torch.Tensor:
    """Stacked residual vector ``b`` (B, M): start prior, GP, goal prior and
    obstacle rows, then the enabled nonholonomic, velocity, joint-limit,
    self-collision, workspace-goal and interpolated-obstacle rows."""
    res = eval_residuals(spec, robot, params, th, sdf)
    batch = res.r_gp.shape[:-2]
    parts = [res.r_s, res.r_gp.reshape(*batch, -1), res.r_g,
             res.r_obs.reshape(*batch, -1)]
    if spec.non_holonomic:
        parts.append(res.r_dyn)
    if spec.use_vel_limits:
        parts.append(res.r_vel.reshape(*batch, -1))
    if spec.use_joint_limits:
        parts.append(res.r_jl.reshape(*batch, -1))
    if spec.use_self_collision:
        parts.append(res.r_self.reshape(*batch, -1))
    if spec.use_workspace_goal:
        parts.append(res.r_wg)
    if spec.use_gp_inter:
        parts.append(res.r_obsi.reshape(*batch, -1))
    return torch.cat(parts, dim=-1)


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
                   k_g, k_d=None, k_v=None, v_x=None, v_y=None, k_self=None,
                   eps_self=None, k_jl=None, q_min=None, q_max=None,
                   k_wg=None, workspace_goal=None,
                   dtype: torch.dtype = torch.float32) -> GraphParams:
    """Fixed-covariance GraphParams from the YAML scalars, on ``start``'s
    device: ``K_s⁻¹ = I/K_s²``, ``K_g⁻¹ = I/K_g²``, obstacle ``Λ = I/σ²``
    and GP ``Q⁻¹`` expanded from ``Q_c⁻¹``; start, goal (B, D).

    The enabled optional factors take ``k_d`` (nonholonomic), ``k_v`` with
    per-axis limits ``v_x``/``v_y`` (or a length-dof sequence as ``v_x``),
    ``k_self``/``eps_self``, ``k_jl`` with ``q_min``/``q_max``, and ``k_wg``
    with the (B, W) or (W,) ``workspace_goal``.
    """
    dev = start.device
    b = start.shape[0]
    d, tn, t, l = (spec.state_dim, spec.num_traj_states, spec.total_time_step,
                   spec.nlinks)
    dof = spec.dof

    def tensor(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    def iso(n, k):  # I/k² in dtype
        return torch.eye(n, dtype=dtype, device=dev) / tensor(k) ** 2

    qc = tensor(qc_inv).expand(b, t, dof, dof)
    # Q⁻¹ formed once per distinct Q_c⁻¹: a Q_c⁻¹ that every problem (or
    # step) shares gives a Q⁻¹ read with stride 0 there (the stream engine
    # then reads its per-plan blocks from one copy).
    q_inv = factors.gp_q_inv(qc[tuple(
        slice(0, 1) if s == 0 else slice(None) for s in qc.stride()[:2])],
        spec.dt).expand(b, t, d, d)
    eye_d = torch.eye(d, dtype=dtype, device=dev)
    obs = torch.eye(l, dtype=dtype, device=dev) / float(cost_sigma) ** 2
    opt = {}
    if spec.non_holonomic:
        opt["dyn_inv"] = (1.0 / tensor(k_d) ** 2).expand(b, tn)
    if spec.use_vel_limits:
        opt["vel_inv"] = iso(dof, k_v).expand(b, tn, dof, dof)
        # The YAMLs name the per-axis limits v_x/v_y (dof=2); a higher-dof
        # robot passes a length-dof sequence as v_x (v_y ignored).
        lims = (np.asarray(v_x, np.float64).reshape(-1)
                if np.ndim(v_x) else np.asarray([v_x, v_y], np.float64))
        if lims.size != dof:
            raise ValueError(
                f"velocity limits have {lims.size} entries for dof="
                f"{dof}; pass a length-dof sequence as v_x"
            )
        opt["v_lim"] = tensor(lims).expand(b, tn, dof)
    if spec.use_self_collision:
        p = spec.num_self_pairs
        opt["self_inv"] = (1.0 / tensor(k_self) ** 2).expand(b, tn, p)
        opt["self_eps"] = tensor(eps_self).expand(b, tn, p)
    if spec.use_workspace_goal:
        w = robot.wksp_dim
        opt["wg_inv"] = iso(w, k_wg).expand(b, w, w)
        opt["p_goal"] = tensor(workspace_goal).expand(b, w)
    if spec.use_joint_limits:
        opt["jl_inv"] = iso(dof, k_jl).expand(b, tn, dof, dof)
        opt["q_min"] = tensor(q_min).reshape(-1).expand(b, tn, dof)
        opt["q_max"] = tensor(q_max).reshape(-1).expand(b, tn, dof)
    return GraphParams(
        start=start.to(dtype),
        goal=goal.to(dtype),
        q_inv=q_inv,
        ks_inv=(eye_d / float(k_s) ** 2).expand(b, d, d),
        kg_inv=(eye_d / float(k_g) ** 2).expand(b, d, d),
        obs_inv=obs.expand(b, tn, l, l),
        eps=torch.full((b, tn, l), float(epsilon_dist), dtype=dtype,
                       device=dev),
        **opt,
    )
