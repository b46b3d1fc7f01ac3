"""The numbers that decide ``correct``: each a widest relative gap (at most
1) between a claim of the program's output and the float64 reference's
value.

Every plan is chaotic past its first steps (the hinge switches on and off;
float32 against float64 trajectories part within tens of iterations), so
no number follows a whole plan.  Each checks an answer by what it says:

* ``init_err_gap``: the error of the first iterate, recomputed (the SDF
  gather, the lookups, the residuals, the error; in the learned plan also
  the encoder, the head and the decode);
* ``step1_err_gap``: the error after the first step, the reference's own
  step from the same start (the assembly, the damping, the solve, the
  update, and in the learned plan the second prediction), as a share of
  the larger of the two and the first iterate's error: a first step cuts
  the error by up to a thousandfold, and a float32 step, right to its
  conditioning (~1e-2 of the step), can leave a small error a quarter
  away from float64's;
* ``final_err_gap``: the returned trajectory, recomputed against what the
  program says of it: its error (the GN plan), or, where the learned plan
  kept an earlier collision-free iterate, that iterate's errors under the
  fixed and the predicted covariances (``track_best``'s choice);
* ``final_err_excess``: every iteration after the first, as a whole: the
  mean error of the returned trajectories, recomputed, against the mean
  error of the reference's own float64 plans of the same problems with
  the configuration's iterations (in the learned plan the error under the
  fixed covariances of the trajectory ``track_best`` returns), as
  ``(program - reference) / max(program, reference)``.  One plan is chaos,
  the mean of thousands is not: float32 and float64 plans read within a
  few hundredths of each other, a plan cut short reads a tenth or more
  above (the error falls by about a third over the iterations).
"""
from __future__ import annotations

import dataclasses

import torch

from portbench.reference import gpmp2, learned

ATOL = 1e-9  # errors below this count as zero in a gap's denominator


def rel_gap(a: torch.Tensor, b: torch.Tensor, scale=None) -> torch.Tensor:
    """|a - b| / max(|a|, |b|, scale, ATOL) per entry: the relative gap where
    it is small, never above 1, and 1 where either side is not finite (a
    plan that diverged reads 1, not infinity)."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    den = torch.maximum(a.abs(), b.abs())
    if scale is not None:
        den = torch.maximum(den, scale.to(torch.float64).abs())
    gap = (a - b).abs() / den.clamp_min(ATOL)
    ok = torch.isfinite(a) & torch.isfinite(b)
    return torch.where(ok, gap, torch.ones_like(gap))


def widest(gap: torch.Tensor) -> float:
    return float(gap.max()) if gap.numel() else 0.0


def excess(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """``(mean(prog) - mean(ref)) / max(mean(prog), mean(ref))``: below 0
    where the program's errors are lower, at most 1, and 1 where either
    side is not finite."""
    a, b = float(prog.to(torch.float64).mean()), float(
        ref.to(torch.float64).mean())
    if not (torch.isfinite(torch.tensor([a, b])).all()):
        return 1.0
    return (a - b) / max(a, b, ATOL)


def finish(blocks: list) -> dict:
    """The numbers compared from each block's ``(gaps, (prog, ref))``: the
    widest of each gap, the excess over all the blocks' errors."""
    out = {k: max(g[k] for g, _ in blocks) for k in blocks[0][0]}
    out["final_err_excess"] = excess(torch.cat([e[0] for _, e in blocks]),
                                     torch.cat([e[1] for _, e in blocks]))
    return out


def point2d(p: gpmp2.Problem, th0: torch.Tensor, out: dict, reg: float,
            iters: int, tol_delta: float) -> tuple:
    """``out``: the program's err_init, err1 (after step 1), th and
    err_final of each problem, any dtype.  Returns the block's gaps and the
    final errors, the program's recomputed and the reference plan's."""
    th0 = th0.to(p.sdf.dtype)
    _, e0, errs, _ = gpmp2.plan(p, th0, reg, iters, tol_delta)
    e = gpmp2.error(p, gpmp2.residuals(p, out["th"].to(p.sdf.dtype)))
    return {
        "init_err_gap": widest(rel_gap(out["err_init"], e0)),
        "step1_err_gap": widest(rel_gap(out["err1"], errs[0], e0)),
        "final_err_gap": widest(rel_gap(out["err_final"], e)),
    }, (e, errs[-1])


def _learned_err(w, fixed, feats, th, steps, eps_max):
    p = learned.learned_problem(fixed, learned.decode(
        learned.head(w, feats, th), steps, fixed.dt, eps_max))
    return p, gpmp2.residuals(p, th)


def learned2d(w: dict, fixed: gpmp2.Problem, im: torch.Tensor,
              th0: torch.Tensor, out: dict, reg: float, iters: int,
              eps_max: float) -> tuple:
    """``out``: the program's errs and errs_ext (iters, B), th (returned)
    and th_final of each problem.  Returns the block's gaps and the errors
    under the fixed covariances of the returned trajectories, the
    program's recomputed and the reference plan's."""
    dtype = fixed.sdf.dtype
    steps = th0.shape[1] - 1
    th0 = th0.to(dtype)
    feats = learned.encoder(w, learned.image_stack(im, fixed.sdf))
    th_ref, errs_ref, _, _ = learned.plan(w, fixed, im, th0, reg, iters,
                                          eps_max, feats)
    e0 = errs_ref[0]
    gaps = {
        "init_err_gap": widest(rel_gap(out["errs"][0], e0)),
        "step1_err_gap": widest(rel_gap(out["errs"][1], errs_ref[1], e0)),
    }
    # An earlier iterate kept by track_best is the one whose external error
    # the program reported: match it, then hold the learned error there.
    th = out["th"].to(dtype)
    kept = (out["th"] != out["th_final"]).flatten(1).any(-1)
    final = torch.zeros(0, dtype=torch.float64, device=th.device)
    if bool(kept.any()):
        idx = kept.nonzero()[:, 0]
        sub = dataclasses.replace(
            fixed, sdf=fixed.sdf[idx], start=fixed.start[idx],
            goal=fixed.goal[idx])
        ext = gpmp2.error(sub, gpmp2.residuals(sub, th[idx]))
        ext_gaps = rel_gap(out["errs_ext"][:, idx], ext[None])
        k = ext_gaps.argmin(0)
        p_k, res_k = _learned_err(w, sub, feats[idx], th[idx], steps, eps_max)
        errs_k = out["errs"][k, idx]
        final = torch.maximum(ext_gaps.min(0).values,
                              rel_gap(errs_k, gpmp2.error(p_k, res_k)))
    gaps["final_err_gap"] = widest(final)
    return gaps, (gpmp2.error(fixed, gpmp2.residuals(fixed, th)),
                  gpmp2.error(fixed, gpmp2.residuals(fixed, th_ref)))
