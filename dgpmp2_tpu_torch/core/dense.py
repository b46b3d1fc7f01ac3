"""Dense reference assembly: the verification oracle, not the hot path.

Port of ``dgpmp2_tpu/core/dense.py``.  Builds the ``A (M×N)``, ``b (M)``,
``K (M×M)`` matrices of one problem's Gauss-Newton system with the row
layout of the JAX package's oracle (and of ``graph.linear_error``):

    rows [0, D)                       start prior
    rows [D, D·(T+1))                 GP factors (factor i at rows (i+1)·D)
    rows [D·(T+1), D·(T+2))           goal prior
    rows [D·(T+2), D·(T+2)+(T+1)·L)   obstacle factors
    then nonholonomic (1 row/state), then velocity limits (dof rows/state),
    then joint limits (dof rows/state), then self-collision pairs
    (P rows/state), then the terminal workspace goal (wksp_dim rows),
    then interpolated obstacles

so that ``ops.tridiag.btd_to_dense(graph.assemble(...)) == AᵀKA`` and
``rhs == AᵀKb`` can be checked for every factor family, and a kernel that
fuses the assembly has a ground truth inside the port.  Every residual and
Jacobian comes from ``core.factors`` and ``core.graph``; the matrices are
filled by slicing preallocated tensors, each family's per-state blocks
through one strided view of the block diagonal they sit on.

2-D workspaces only, as the JAX oracle: an (H, W) SDF, no ``z_lims``.  A
batch is a Python loop over problems.  O(M·N) memory (K alone is gigabytes
per problem for the 17-link arm at T=100): keep it off the GN path.  The
SDF lookups go through ``ops.sdf.lookup_nd`` on a batch of one, so a CUDA
problem launches K-LOOKUP (one launch, two with GP interpolation).
"""
from __future__ import annotations

import torch

from dgpmp2_tpu_torch.core import factors, graph as graph_lib
from dgpmp2_tpu_torch.utils.tree import tree_map


def _blocks(mat: torch.Tensor, r0: int, c0: int, n: int, p: int, q: int,
            r_step: int, c_step: int) -> torch.Tensor:
    """An (n, p, q) view of ``mat``'s blocks ``mat[r0 + i·r_step : +p,
    c0 + i·c_step : +q]``, i = 0..n-1 (``mat`` contiguous, 2-D)."""
    s0, s1 = mat.stride()
    return mat.as_strided((n, p, q), (r_step * s0 + c_step * s1, s0, s1),
                          mat.storage_offset() + r0 * s0 + c0 * s1)


def assemble_dense(spec: graph_lib.GraphSpec, robot,
                   params: graph_lib.GraphParams, th: torch.Tensor,
                   sdf: torch.Tensor):
    """Dense ``(A, b, K)`` of a single problem.

    Args:
      th: (T+1, D) one trajectory; sdf: (H, W).  ``params`` carries one
        problem's fields, unbatched (row ``i`` of a batched GraphParams is
        ``utils.tree.tree_map(lambda x: x[i], p)``); loop over problems for
        a batch.
    """
    if spec.z_lims is not None or sdf.ndim != 2:
        raise ValueError("the dense oracle is 2-D only: an (H, W) SDF and "
                         "no z_lims")
    d, tn, l = spec.state_dim, spec.num_traj_states, spec.nlinks
    t, dof = spec.num_gp_factors, spec.dof
    m, n = spec.M, spec.N
    dtype, dev = th.dtype, th.device

    A = torch.zeros((m, n), dtype=dtype, device=dev)
    b = torch.zeros((m,), dtype=dtype, device=dev)
    K = torch.zeros((m, m), dtype=dtype, device=dev)

    def unary(off, rows, r, h, k):
        """Per-state factors of ``rows`` rows each: H (T+1, rows, D) on
        state i's columns, r (T+1, rows), K blocks (T+1, rows, rows)."""
        _blocks(A, off, 0, tn, rows, d, rows, d).copy_(h)
        b[off:off + tn * rows].copy_(r.reshape(-1))
        _blocks(K, off, off, tn, rows, rows, rows, rows).copy_(k)
        return off + tn * rows

    eye = torch.eye(d, dtype=dtype, device=dev)
    # Start prior.
    A[:d, :d] = eye
    b[:d] = factors.prior_residual(params.start, th[0])
    K[:d, :d] = params.ks_inv
    # GP factors: factor i is Φ on state i and -I on state i+1.
    phi = factors.gp_phi(dof, spec.dt, dtype, dev)
    _blocks(A, d, 0, t, d, d, d, d).copy_(phi.expand(t, d, d))
    _blocks(A, d, d, t, d, d, d, d).copy_(-eye.expand(t, d, d))
    b[d:d * (t + 1)] = factors.gp_residual(th, phi).reshape(-1)
    _blocks(K, d, d, t, d, d, d, d).copy_(params.q_inv)
    # Goal prior.
    off = d * (t + 1)
    A[off:off + d, n - d:] = eye
    b[off:off + d] = factors.prior_residual(params.goal, th[-1])
    K[off:off + d, off:off + d] = params.kg_inv
    off += d

    # Obstacle factors: one lookup, on a batch of one.
    centers, jac_fk = robot.fk(th)
    radii = robot.radii_array(dtype, dev)
    r_obs, h_obs = factors.hinge_obstacle_residual(
        centers[None], jac_fk[None], radii, params.eps[None], sdf[None],
        spec.res(sdf.shape[-1]), spec.x_lims, spec.y_lims)
    off = unary(off, l, r_obs[0], h_obs[0], params.obs_inv)

    if spec.non_holonomic:
        r_dyn, h_dyn = factors.nonholonomic_residual(th)
        off = unary(off, 1, r_dyn, h_dyn[:, None, :],
                    params.dyn_inv[:, None, None])
    if spec.use_vel_limits:
        r_vel, h_vel = factors.velocity_limit_residual(th, params.v_lim, dof)
        off = unary(off, dof, r_vel, h_vel, params.vel_inv)
    if spec.use_joint_limits:
        r_jl, h_jl = factors.joint_limit_residual(th, params.q_min,
                                                  params.q_max, dof)
        off = unary(off, dof, r_jl, h_jl, params.jl_inv)
    if spec.use_self_collision:
        pairs_i, pairs_j = graph_lib.pair_index(spec.self_pairs, dev)
        r_self, h_self = factors.self_collision_residual(
            centers, jac_fk, radii, pairs_i, pairs_j, params.self_eps)
        off = unary(off, spec.num_self_pairs, r_self, h_self,
                    torch.diag_embed(params.self_inv))
    if spec.use_workspace_goal:
        r_wg, h_wg = factors.workspace_goal_residual(centers[-1], jac_fk[-1],
                                                     params.p_goal)
        w = robot.wksp_dim
        A[off:off + w, n - d:] = h_wg
        b[off:off + w] = r_wg
        K[off:off + w, off:off + w] = params.wg_inv
        off += w

    if spec.use_gp_inter:
        # Binary interpolated obstacle rows of segment s, check k:
        # h·Λ_k on state s, h·Ψ_k on state s+1, the left support's K.
        res = graph_lib.eval_residuals(
            spec, robot, tree_map(lambda x: x[None], params), th[None],
            sdf[None])
        lam_m, psi_m = factors.gp_interp_coeffs(dof, spec.dt, spec.num_inter,
                                                dtype, dev)
        nip = spec.num_inter
        h_i = res.h_obsi[0]  # (T, nip, L, D)
        rows = nip * l
        _blocks(A, off, 0, t, rows, d, rows, d).copy_(
            (h_i @ lam_m).reshape(t, rows, d))
        _blocks(A, off, d, t, rows, d, rows, d).copy_(
            (h_i @ psi_m).reshape(t, rows, d))
        b[off:off + t * rows] = res.r_obsi[0].reshape(-1)
        _blocks(K, off, off, t * nip, l, l, l, l).copy_(
            params.obs_inv[:-1, None].expand(t, nip, l, l).reshape(-1, l, l))
        off += t * rows
    if off != m:
        raise AssertionError(f"dense oracle filled {off} rows of M={m}")
    return A, b, K


def solve_dense(A: torch.Tensor, b: torch.Tensor, K: torch.Tensor,
                delta) -> torch.Tensor:
    """The damped Gauss-Newton step ``(AᵀKA + δI)⁻¹ AᵀKb`` of the dense
    system, by one dense solve (reference semantics)."""
    atk = A.T @ K
    lam = atk @ A + delta * torch.eye(A.shape[-1], dtype=A.dtype,
                                      device=A.device)
    return torch.linalg.solve(lam, atk @ b)
