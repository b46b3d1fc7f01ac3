"""Plain GPMP2 for a 2-D point robot: the yardstick of the planning cells.

Written from the factor graph of mhmukadam/dgpmp2 (``gp/gp_factor.py``,
``obstacle/obstacle_factor.py``, ``planner/plan_layer.py``) in plain torch,
in any floating dtype, bfloat16 included: no kernel, no library solver.

The trajectory ``th`` (B, T+1, 4) holds ``[x, y, vx, vy]`` per state.  The
factors, with r their residual and J = dr/dx:

* GP prior between states i and i+1: ``r = x_{i+1} - Φ x_i`` with
  ``Φ = [[I, dt I], [0, I]]``, weight ``Q⁻¹ = [[12/dt³, -6/dt²], [-6/dt²,
  4/dt]] ⊗ Q_c⁻¹``;
* start and goal priors: ``r = start - x_0`` (``goal - x_T``), weight
  ``I / K²``;
* obstacle hinge at each state: ``r = max(0, ε + radius - sdf(x, y))``,
  weight ``1 / σ²``, ``J = -∇sdf`` where the hinge is active.

A Gauss-Newton step solves ``(JᵀΛJ + δI) dθ = -JᵀΛr``.  The normal matrix
is block tridiagonal by the chain's structure; it is formed block by block
and solved by a block Cholesky written out element by element.  The error
is ``Σ ½ rᵀΛr / M`` with ``M = 4 (T + 2) + (T + 1)`` residual rows.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Problem:
    """One batch of 2-D point-robot problems in one dtype.

    sdf (B, H, W) metres; start, goal (B, 4); q_inv (B, T, 4, 4) or (4, 4);
    ks_inv, kg_inv scalars (isotropic); obs_w (B, T+1) or a scalar; eps
    (B, T+1) or a scalar (the margin, the robot's radius added apart)."""

    sdf: torch.Tensor
    start: torch.Tensor
    goal: torch.Tensor
    q_inv: torch.Tensor
    ks_inv: float
    kg_inv: float
    obs_w: torch.Tensor
    eps: torch.Tensor
    radius: float
    dt: float
    x_lims: tuple
    y_lims: tuple

    @property
    def res(self) -> float:
        return (self.x_lims[1] - self.x_lims[0]) / self.sdf.shape[-1]


def gp_q_inv(qc_inv: torch.Tensor, dt: float) -> torch.Tensor:
    """(..., 2, 2) ``Q_c⁻¹`` -> (..., 4, 4) GP inverse covariance."""
    top = torch.cat([12.0 / dt**3 * qc_inv, -6.0 / dt**2 * qc_inv], dim=-1)
    bot = torch.cat([-6.0 / dt**2 * qc_inv, 4.0 / dt * qc_inv], dim=-1)
    return torch.cat([top, bot], dim=-2)


def phi(dt: float, dtype, device) -> torch.Tensor:
    eye = torch.eye(2, dtype=dtype, device=device)
    zero = torch.zeros((2, 2), dtype=dtype, device=device)
    return torch.cat([torch.cat([eye, dt * eye], dim=1),
                      torch.cat([zero, eye], dim=1)], dim=0)


def lookup(sdf: torch.Tensor, pts: torch.Tensor, res: float, x_lims,
           y_lims):
    """Bilinear SDF value and spatial gradient at (B, P, 2) world points of
    (B, H, W) grids whose row 0 is the top of the world.  Outside the world
    the distance is the world's width and the gradient zero."""
    dtype = sdf.dtype
    h, w = sdf.shape[-2:]
    x, y = pts[..., 0].to(dtype), pts[..., 1].to(dtype)
    r = torch.tensor(res, dtype=dtype, device=sdf.device)
    px = -x_lims[0] / res + x / r
    py = -y_lims[0] / res - y / r

    def axis(p, n):
        f0 = torch.floor(p)
        i0 = f0.long()
        return (i0.clamp(0, n - 1), (i0 + 1).clamp(0, n - 1), p - f0)

    c0, c1, fx = axis(px, w)
    r0, r1, fy = axis(py, h)
    flat = sdf.reshape(sdf.shape[0], h * w)

    def tap(row, col):
        return torch.gather(flat, 1, row * w + col)

    d00, d01, d10, d11 = tap(r0, c0), tap(r0, c1), tap(r1, c0), tap(r1, c1)
    gx, gy = 1.0 - fx, 1.0 - fy
    d = gy * (gx * d00 + fx * d01) + fy * (gx * d10 + fx * d11)
    ddx = (gy * (d01 - d00) + fy * (d11 - d10)) / r
    ddy = -(gx * (d10 - d00) + fx * (d11 - d01)) / r
    inside = ((x >= x_lims[0]) & (x <= x_lims[1])
              & (y >= y_lims[0]) & (y <= y_lims[1]))
    zero = torch.zeros((), dtype=dtype, device=sdf.device)
    d = torch.where(inside, d, torch.full_like(d, x_lims[1] - x_lims[0]))
    grad = torch.stack([torch.where(inside, ddx, zero),
                        torch.where(inside, ddy, zero)], dim=-1)
    return d, grad


@dataclasses.dataclass
class Residuals:
    """r_gp (B, T, 4), r_s, r_g (B, 4), r_obs (B, T+1), j_obs (B, T+1, 4)."""

    r_gp: torch.Tensor
    r_s: torch.Tensor
    r_g: torch.Tensor
    r_obs: torch.Tensor
    j_obs: torch.Tensor


def residuals(p: Problem, th: torch.Tensor) -> Residuals:
    ph = phi(p.dt, th.dtype, th.device)
    r_gp = th[:, 1:] - torch.einsum("ij,btj->bti", ph, th[:, :-1])
    d, grad = lookup(p.sdf, th[..., :2], p.res, p.x_lims, p.y_lims)
    margin = p.eps + p.radius
    active = d <= margin
    zero = torch.zeros((), dtype=th.dtype, device=th.device)
    r_obs = torch.where(active, margin - d, zero)
    j_pos = torch.where(active[..., None], -grad, zero)
    j_obs = torch.cat([j_pos, torch.zeros_like(j_pos)], dim=-1)
    return Residuals(r_gp=r_gp, r_s=p.start - th[:, 0], r_g=p.goal - th[:, -1],
                     r_obs=r_obs, j_obs=j_obs)


def error(p: Problem, res: Residuals) -> torch.Tensor:
    """``Σ ½ rᵀΛr / M`` per problem (B,)."""
    t = res.r_gp.shape[1]
    m = 4 * (t + 2) + (t + 1)
    q = p.q_inv.expand(res.r_gp.shape[0], t, 4, 4)
    e_gp = torch.einsum("bti,btij,btj->b", res.r_gp, q, res.r_gp)
    e = (p.ks_inv * (res.r_s * res.r_s).sum(-1)
         + p.kg_inv * (res.r_g * res.r_g).sum(-1) + e_gp
         + (p.obs_w * res.r_obs * res.r_obs).sum(-1))
    return 0.5 * e / m


def normal_equations(p: Problem, res: Residuals):
    """Blocks of ``JᵀΛJ``: diag (B, T+1, 4, 4), upper (B, T, 4, 4) =
    Λ_{t, t+1}; and the gradient ``g = JᵀΛr`` (B, T+1, 4)."""
    b, t = res.r_gp.shape[:2]
    dtype, dev = res.r_gp.dtype, res.r_gp.device
    ph = phi(p.dt, dtype, dev)
    q = p.q_inv.expand(b, t, 4, 4)
    eye = torch.eye(4, dtype=dtype, device=dev)
    # GP factor i: J_i = -Φ, J_{i+1} = I.
    phtq = torch.einsum("ji,btjk->btik", ph, q)  # Φᵀ Q⁻¹
    diag = torch.zeros((b, t + 1, 4, 4), dtype=dtype, device=dev)
    diag[:, :-1] += torch.einsum("btij,jk->btik", phtq, ph)
    diag[:, 1:] += q
    upper = -phtq
    qr = torch.einsum("btij,btj->bti", q, res.r_gp)
    g = torch.zeros((b, t + 1, 4), dtype=dtype, device=dev)
    g[:, :-1] -= torch.einsum("ji,btj->bti", ph, qr)
    g[:, 1:] += qr
    # Start and goal priors: J = -I.
    diag[:, 0] += p.ks_inv * eye
    diag[:, -1] += p.kg_inv * eye
    g[:, 0] -= p.ks_inv * res.r_s
    g[:, -1] -= p.kg_inv * res.r_g
    # Obstacle hinge: one row per state.
    w = p.obs_w * torch.ones_like(res.r_obs)
    diag += w[..., None, None] * res.j_obs[..., :, None] * res.j_obs[..., None, :]
    g += (w * res.r_obs)[..., None] * res.j_obs
    return diag, upper, g


def _cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (..., D, D) blocks, column by column.  A
    pivot is kept at least the dtype's epsilon times the block's largest
    entry, so that a low precision's rounding gives a poor factor, not NaN
    (positive definite blocks in float32 and float64 never come near it)."""
    d = a.shape[-1]
    fi = torch.finfo(a.dtype)
    floor = fi.eps * a.abs().amax((-2, -1))[..., None] + fi.tiny
    cols = []
    for j in range(d):
        col = a[..., :, j]
        for k in range(j):
            col = col - cols[k] * cols[k][..., j:j + 1]
        piv = torch.sqrt(torch.maximum(col[..., j:j + 1], floor))
        mask = torch.arange(d, device=a.device) >= j
        cols.append(torch.where(mask, col / piv, torch.zeros_like(col)))
    return torch.stack(cols, dim=-1)


def _forward(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L⁻¹ b for lower (..., D, D) and (..., D, K)."""
    rows = []
    for i in range(l.shape[-1]):
        acc = b[..., i, :]
        for k in range(i):
            acc = acc - l[..., i, k:k + 1] * rows[k]
        rows.append(acc / l[..., i, i:i + 1])
    return torch.stack(rows, dim=-2)


def _backward(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L⁻ᵀ b for lower (..., D, D) and (..., D, K)."""
    d = l.shape[-1]
    rows = [None] * d
    for i in reversed(range(d)):
        acc = b[..., i, :]
        for k in range(i + 1, d):
            acc = acc - l[..., k, i:i + 1] * rows[k]
        rows[i] = acc / l[..., i, i:i + 1]
    return torch.stack(rows, dim=-2)


def block_solve(diag: torch.Tensor, upper: torch.Tensor,
                rhs: torch.Tensor) -> torch.Tensor:
    """Solve the symmetric positive definite block-tridiagonal system with
    diagonal blocks ``diag`` (B, N, D, D), blocks ``upper`` (B, N-1, D, D)
    above them and right-hand side (B, N, D), by block Cholesky."""
    n = diag.shape[1]
    ls, ws, zs = [], [], []
    a = diag[:, 0]
    z_in = rhs[:, 0, :, None]
    for t in range(n):
        l = _cholesky(a)
        z = _forward(l, z_in)
        ls.append(l)
        zs.append(z)
        if t + 1 < n:
            w = _forward(l, upper[:, t])
            ws.append(w)
            a = diag[:, t + 1] - w.transpose(-1, -2) @ w
            z_in = rhs[:, t + 1, :, None] - w.transpose(-1, -2) @ z
    x = [None] * n
    x[-1] = _backward(ls[-1], zs[-1])
    for t in reversed(range(n - 1)):
        x[t] = _backward(ls[t], zs[t] - ws[t] @ x[t + 1])
    return torch.stack(x, dim=1)[..., 0]


def select(mask: torch.Tensor, a: Residuals, b: Residuals) -> Residuals:
    """Per problem, ``a`` where ``mask`` else ``b``."""
    out = {}
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        out[f.name] = torch.where(mask.reshape(-1, *[1] * (x.ndim - 1)), x, y)
    return Residuals(**out)


def gn_step(p: Problem, res: Residuals, reg: float) -> torch.Tensor:
    """One damped Gauss-Newton update (B, T+1, 4)."""
    diag, upper, g = normal_equations(p, res)
    eye = torch.eye(4, dtype=diag.dtype, device=diag.device)
    return block_solve(diag + reg * eye, upper, -g)


def plan(p: Problem, th0: torch.Tensor, reg: float, iters: int,
         tol_delta: float):
    """GN with a per-problem freeze once a step's norm falls under
    ``tol_delta``: ``(th, err_init, err_per_iter (iters, B), iters_used)``."""
    res = residuals(p, th0)
    err = error(p, res)
    err0, th = err, th0
    conv = torch.zeros(th0.shape[0], dtype=torch.bool, device=th0.device)
    used = torch.zeros(th0.shape[0], dtype=torch.int32, device=th0.device)
    errs = []
    for _ in range(iters):
        dth = gn_step(p, res, reg)
        th_new = th + dth
        res_new = residuals(p, th_new)
        err_new = error(p, res_new)
        take = ~conv
        th = torch.where(take[:, None, None], th_new, th)
        res = select(take, res_new, res)
        err = torch.where(take, err_new, err)
        used = used + take.to(torch.int32)
        norm = torch.linalg.vector_norm(dth.reshape(dth.shape[0], -1), dim=-1)
        conv = conv | (norm < tol_delta)
        errs.append(err)
    return th, err0, torch.stack(errs), used
