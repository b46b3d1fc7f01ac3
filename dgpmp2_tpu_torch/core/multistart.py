"""Batched multi-start planning: initialisation search by batching.

Port of ``dgpmp2_tpu/core/multistart.py``.  GPMP2 is a local optimiser; on
dense clutter the straight-line seed leaves Gauss-Newton in a colliding
basin.  All K perturbed seeds of all B problems are planned as one (K·B)
batch through :func:`dgpmp2_tpu_torch.core.gn.plan`, then the best
candidate of each problem is selected.

Seeds are endpoint-vanishing sine-harmonic position bumps with the matching
analytic velocity perturbation (restart 0 is always the unperturbed base),
so every seed keeps the boundary states exactly.  Selection prefers
contact-free candidates, graded by total contact depth when none are,
tie-broken by velocity smoothness.

The random draws come from an explicit ``torch.Generator`` where the JAX
package takes a PRNG key; the two sources differ, so equal seeds do not
give equal draws across the packages.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from dgpmp2_tpu_torch.core import factors, gn
from dgpmp2_tpu_torch.core import graph as graph_lib
from dgpmp2_tpu_torch.ops import sdf as sdf_ops


def inits_from_normals(th0: torch.Tensor, z: torch.Tensor, amp: float,
                       total_time_sec: float) -> torch.Tensor:
    """The deterministic part of :func:`perturbed_inits`: (B, T+1, 2·dof)
    base and standard-normal draws z (K, B, H, dof), or (K, 1, H, dof)
    shared by every problem, -> (K, B, T+1, 2·dof) seeds.  Harmonic h of
    dof d gets the amplitude ``amp·z/h``; restart 0 is the base."""
    b, t1, sd = th0.shape
    dof = sd // 2
    harmonics = z.shape[-2]
    dtype, dev = th0.dtype, th0.device
    h = torch.arange(1, harmonics + 1, dtype=dtype, device=dev)
    s = torch.linspace(0.0, 1.0, t1, dtype=dtype, device=dev)
    basis = torch.sin(h[:, None] * math.pi * s[None, :])  # (H, T+1)
    dbasis = (h[:, None] * math.pi) * torch.cos(
        h[:, None] * math.pi * s[None, :]) / total_time_sec
    a = amp * z.to(dtype) / h[None, None, :, None]
    a = torch.cat([torch.zeros_like(a[:1]), a[1:]], dim=0)
    dpos = torch.einsum("kbhd,ht->kbtd", a, basis)
    dvel = torch.einsum("kbhd,ht->kbtd", a, dbasis)
    # The sine basis vanishes at the endpoints but its derivative does not:
    # pin the endpoint velocity rows so every seed keeps the full boundary
    # state.
    dvel = torch.cat([torch.zeros_like(dvel[:, :, :1]), dvel[:, :, 1:-1],
                      torch.zeros_like(dvel[:, :, :1])], dim=2)
    return torch.cat([th0[None, ..., :dof] + dpos,
                      th0[None, ..., dof:] + dvel], dim=-1)


def perturbed_inits(th0: torch.Tensor, generator: torch.Generator,
                    restarts: int, amp: float, total_time_sec: float,
                    harmonics: int = 3) -> torch.Tensor:
    """(B, T+1, 2·dof) base trajectory -> (K, B, T+1, 2·dof) seeds.

    The position perturbation per restart, problem and dof is
    ``Σ_h a_h sin(h π s)`` with ``a_h ~ N(0, (amp/h)²)`` over normalised
    time ``s ∈ [0, 1]``; velocities get its analytic derivative.  The draws
    come from ``generator`` (on ``th0``'s device).
    """
    b, _, sd = th0.shape
    z = torch.randn((restarts, b, harmonics, sd // 2), generator=generator,
                    dtype=th0.dtype, device=th0.device)
    return inits_from_normals(th0, z, amp, total_time_sec)


class MultistartResult(NamedTuple):
    th: torch.Tensor        # (B, T+1, D) selected trajectories
    score: torch.Tensor     # (B,) selected score (lower is better)
    # (B,) index of the winning candidate: the restart index in the full
    # pool (0 = unperturbed base); under staged pruning the index into the
    # 2·keep selection pool (phase-1 then phase-2 best of the survivors).
    k_best: torch.Tensor
    contact_free: torch.Tensor  # (B,) bool: selected traj clears the radius
    # (B,) GN iterations the winning candidate ran (staged: phase 1 +
    # phase 2).  None only when made by bare select_best.
    iters: Optional[torch.Tensor] = None


def tile_params(params: graph_lib.GraphParams, b: int, k: int):
    """Repeat every per-problem field K times, K-major (matching the
    ``(K, B) -> (K·B)`` reshape of the seeds)."""
    out = {}
    for f in dataclasses.fields(params):
        x = getattr(params, f.name)
        if x is not None and x.ndim > 0 and x.shape[0] == b:
            x = x.repeat(k, *(1,) * (x.ndim - 1))
        out[f.name] = x
    return type(params)(**out)


def _tile(x: torch.Tensor, k: int) -> torch.Tensor:
    """K contiguous copies of a batch along its first axis (K-major)."""
    return x.repeat(k, *(1,) * (x.ndim - 1))


def plan_multistart(spec: graph_lib.GraphSpec, robot,
                    params: graph_lib.GraphParams, th_init: torch.Tensor,
                    sdf: torch.Tensor, cfg: gn.OptimConfig,
                    generator: torch.Generator, restarts: int = 8,
                    amp: float = 1.5, harmonics: int = 3,
                    contact_weight: float = 1e6, prune_iters: int = 0,
                    keep: int = 0, select_margin: float = 0.0,
                    extra_seeds: Optional[torch.Tensor] = None,
                    normals: Optional[torch.Tensor] = None
                    ) -> MultistartResult:
    """Plan ``restarts`` perturbed seeds per problem as one batch and select
    the best per problem; the planner runs with ``track_best`` so each
    candidate is represented by its best iterate (under a workspace goal by
    its final one, whose tip error the score reads).

    ``extra_seeds`` (E, B, T+1, 2·dof) appends E informed candidates per
    problem (candidate indices ``restarts .. restarts+E-1``).  ``normals``
    (K, B, H, dof), or (K, 1, H, dof) shared by every problem, are the
    standard-normal draws of the perturbations, taken in place of
    ``generator``'s (which may then be None); restart 0 stays the
    unperturbed base either way.  Score per
    candidate: ``contact_weight · Σ interior contact depth`` + velocity
    smoothness (:func:`score_candidates`).

    Staged pruning (``prune_iters > 0`` and ``0 < keep <= restarts``): all
    seeds run ``prune_iters`` iterations, the ``keep`` best per problem
    (ties to the lower index) finish the remaining ``max_iters -
    prune_iters``, and selection considers each survivor's phase-1 and
    phase-2 representative.  The SDF batch is tiled once per phase,
    contiguous.  The JAX package's ``unroll`` (a ``lax.scan`` option) is not
    taken.
    """
    b = th_init.shape[0]
    if normals is None:
        th0s = perturbed_inits(th_init, generator, restarts, amp,
                               spec.total_time_sec, harmonics)
    else:
        th0s = inits_from_normals(th_init, normals, amp, spec.total_time_sec)
    if extra_seeds is not None:
        th0s = torch.cat([th0s, extra_seeds.to(th0s)], dim=0)
    restarts = th0s.shape[0]  # pool size: restarts (+ E informed)
    th0s = th0s.reshape(restarts * b, *th0s.shape[2:])

    staged = prune_iters > 0 or keep > 0
    if staged and not (0 < prune_iters < cfg.max_iters
                       and 0 < keep <= restarts):
        raise ValueError(
            f"staged pruning needs 0 < prune_iters < max_iters and "
            f"0 < keep <= restarts; got prune_iters={prune_iters}, "
            f"max_iters={cfg.max_iters}, keep={keep}, restarts={restarts}"
        )
    sdf_t = _tile(sdf, restarts)
    params_t = tile_params(params, b, restarts)
    wg = spec.use_workspace_goal
    track = not wg

    def rep(res):
        return res.th if wg else res.best_th

    def pick_iters(iters_pool, k, k_best):
        return iters_pool.reshape(k, b).gather(0, k_best[None, :])[0]

    if not staged:
        res = gn.plan(spec, robot, params_t, th0s, sdf_t, cfg,
                      track_best=track)
        sel = select_best(spec, robot, rep(res), sdf_t, restarts, b,
                          contact_weight=contact_weight,
                          params_t=params_t if wg else None,
                          select_margin=select_margin)
        return sel._replace(iters=pick_iters(res.iters, restarts, sel.k_best))

    # Phase 1: all K seeds, prune_iters iterations.
    res1 = gn.plan(spec, robot, params_t, th0s, sdf_t,
                   dataclasses.replace(cfg, max_iters=prune_iters),
                   track_best=track)
    score1, _ = score_candidates(spec, robot, rep(res1), sdf_t,
                                 contact_weight, select_margin=select_margin,
                                 params=params_t if wg else None)
    del sdf_t
    # Per-problem `keep` lowest scores, ties to the lower index (as
    # lax.top_k): a stable ascending sort.  idx (B, keep).
    idx = torch.argsort(score1.reshape(restarts, b).T, dim=-1,
                        stable=True)[:, :keep]
    cols = torch.arange(b, device=idx.device)

    def gather(x_kb_flat):
        # (K·b, ...) K-major -> the survivors, keep-major (keep·b, ...).
        x_kb = x_kb_flat.reshape(restarts, b, *x_kb_flat.shape[1:])
        return x_kb[idx.T, cols].reshape(keep * b, *x_kb_flat.shape[1:])

    # Phase 2: survivors resume from their phase-1 final iterate.
    sdf_k = _tile(sdf, keep)
    params_k = tile_params(params, b, keep)
    res2 = gn.plan(spec, robot, params_k, gather(res1.th), sdf_k,
                   dataclasses.replace(cfg, max_iters=cfg.max_iters
                                       - prune_iters),
                   track_best=track)
    # Select over each survivor's phase-1 and phase-2 representatives.
    pool = torch.cat([gather(rep(res1)), rep(res2)], dim=0)
    sel = select_best(spec, robot, pool, torch.cat([sdf_k, sdf_k], dim=0),
                      2 * keep, b, contact_weight=contact_weight,
                      params_t=tile_params(params, b, 2 * keep) if wg
                      else None, select_margin=select_margin)
    iters1 = gather(res1.iters)
    # Phase-1 representatives stop at phase 1; phase-2 candidates resumed
    # from the phase-1 final, so their cost is the sum.
    iters_pool = torch.cat([iters1, iters1 + res2.iters], dim=0)
    return sel._replace(iters=pick_iters(iters_pool, 2 * keep, sel.k_best))


def score_candidates(spec, robot, th, sdf, contact_weight: float = 1e6,
                     params=None, select_margin: float = 0.0):
    """(N, T+1, D) candidates against (N, H, W) SDFs -> (score (N,),
    contact (N,)): contact depth dominates, smoothness breaks ties.

    Contact counts interior penetration of the bare radius, plus the
    GP-interpolated states under ``use_gp_inter`` and body-pair penetration
    under ``use_self_collision``.  ``select_margin`` (m) adds clearance
    shortfalls inside ``radius + select_margin`` at ``1e-3·contact_weight``
    (``contact`` stays at the bare radius).  Under ``use_workspace_goal``
    the tiled ``params`` are required and the squared terminal tip error
    joins at weight 1e2.  One SDF lookup in all; a NaN score becomes +inf.
    """
    res = spec.res(sdf.shape[-1])
    centers, _ = robot.fk(th)  # (N, T+1, L, W)
    n, t1, l, wd = centers.shape
    n_sup = t1 * l
    pts = centers.reshape(n, n_sup, wd)
    if spec.use_gp_inter:
        lam, psi = factors.gp_interp_coeffs(spec.dof, spec.dt, spec.num_inter,
                                            th.dtype, th.device)
        centers_i, _ = robot.fk(factors.gp_interpolate(th, lam, psi))
        pts = torch.cat([pts, centers_i.reshape(n, -1, wd)], dim=-2)
    d, _ = sdf_ops.lookup_nd(sdf, pts, res, spec.x_lims, spec.y_lims,
                             spec.z_lims)
    radii = robot.radii_array(th.dtype, th.device)
    d_sup = d[..., :n_sup].reshape(n, t1, l)
    contact = torch.sum(torch.clamp(radii - d_sup, min=0.0)[:, 1:-1, :],
                        dim=(-2, -1))
    if spec.use_gp_inter:
        d_i = d[..., n_sup:].reshape(n, spec.num_gp_factors, spec.num_inter, l)
        contact = contact + torch.sum(torch.clamp(radii - d_i, min=0.0),
                                      dim=(-3, -2, -1))
    if spec.use_self_collision:
        pairs_i, pairs_j = graph_lib.pair_index(spec.self_pairs, th.device)
        dist = torch.sqrt(torch.sum(
            (centers[..., pairs_i, :] - centers[..., pairs_j, :]) ** 2,
            dim=-1) + 1e-12)
        pen_self = torch.clamp(radii[pairs_i] + radii[pairs_j] - dist, min=0.0)
        contact = contact + torch.sum(pen_self[:, 1:-1, :], dim=(-2, -1))
    vel = th[..., spec.dof:]
    smooth = torch.mean(torch.sum(torch.diff(vel, dim=-2) ** 2, -1), -1)
    score = contact * contact_weight + smooth
    if select_margin > 0.0:
        margin_pen = torch.sum(
            torch.clamp(radii + select_margin - d_sup, min=0.0)[:, 1:-1, :],
            dim=(-2, -1))
        if spec.use_gp_inter:
            margin_pen = margin_pen + torch.sum(
                torch.clamp(radii + select_margin - d_i, min=0.0),
                dim=(-3, -2, -1))
        score = score + (1e-3 * contact_weight) * margin_pen
    if spec.use_workspace_goal:
        if params is None:
            raise ValueError(
                "use_workspace_goal selection needs params (the tiled "
                "GraphParams with p_goal): without the tip-target error the "
                "scoring is goal-attainment blind")
        tip = centers[:, -1, -1, :]  # terminal-state tip
        score = score + 1e2 * torch.sum((params.p_goal - tip) ** 2, dim=-1)
    return torch.where(torch.isnan(score), torch.full_like(score, math.inf),
                       score), contact


def select_best(spec, robot, th, sdf_t, restarts: int, b: int,
                contact_weight: float = 1e6, params_t=None,
                select_margin: float = 0.0) -> MultistartResult:
    """Select the winning candidate per problem from (K·B) planned
    trajectories (K-major); the first minimum wins ties.  ``params_t``: the
    K-tiled GraphParams, required under ``spec.use_workspace_goal``."""
    score, contact = score_candidates(spec, robot, th, sdf_t, contact_weight,
                                      params=params_t,
                                      select_margin=select_margin)
    score_kb = score.reshape(restarts, b)
    k_best = torch.argmin(score_kb, dim=0)
    cols = torch.arange(b, device=k_best.device)
    th_sel = th.reshape(restarts, b, *th.shape[1:])[k_best, cols]
    return MultistartResult(
        th=th_sel, score=score_kb[k_best, cols], k_best=k_best,
        contact_free=contact.reshape(restarts, b)[k_best, cols] <= 0.0,
    )
