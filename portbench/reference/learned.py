"""Plain dGPMP2 learned planner (Bhardwaj et al., ICRA 2020) for the 2-D
point robot, in plain torch and any floating dtype.

Per plan a CNN encodes the (occupancy, SDF) image once; per GN iteration a
feed-forward head maps (features, trajectory positions) to one number per
GP factor, per state's obstacle factor and per state's safety margin, which
decode to the covariances of that iteration's step:

* encoder: five 3x3 convolutions (16, 16, 16, 32, 32 features, padding 1),
  each followed by a LayerNorm over the channels (eps 1e-6) and ReLU, a
  2x2 max-pool after the first four; the last map flattened in (row,
  column, channel) order;
* head: Dense(1000), LayerNorm, ReLU, Dense(640), LayerNorm, ReLU,
  Dense(T + 2 (T + 1)) on the features and the states' (x, y);
* decode (``diag_identity``, bounded learned margin): ``Q_c⁻¹ = s² I`` per
  GP factor, obstacle weight ``s²`` per state, margin ``eps_max σ(s)``.

Weights are a flat dict of tensors named as the program's module tree
names them (``conv.convs.0.weight``, ``head.dense.1.bias``, ...), laid out
as ``torch.nn.Conv2d`` and ``torch.nn.Linear`` lay theirs out.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from portbench.reference import gpmp2

FEATURES = (16, 16, 16, 32, 32)
HIDDEN = (1000, 640)
LN_EPS = 1e-6


def weight_shapes(in_channels: int, im_size: int, states: int,
                  out_dim: int) -> dict:
    """Name -> shape of every weight, in a fixed order."""
    shapes = {}
    chans = (in_channels, *FEATURES)
    for i, f in enumerate(FEATURES):
        shapes[f"conv.convs.{i}.weight"] = (f, chans[i], 3, 3)
        shapes[f"conv.convs.{i}.bias"] = (f,)
    for i, f in enumerate(FEATURES):
        shapes[f"conv.norms.{i}.weight"] = (f,)
        shapes[f"conv.norms.{i}.bias"] = (f,)
    side = im_size // 16
    dims = (FEATURES[-1] * side * side + 2 * states, *HIDDEN)
    for i, h in enumerate(HIDDEN):
        shapes[f"head.dense.{i}.weight"] = (h, dims[i])
        shapes[f"head.dense.{i}.bias"] = (h,)
    for i, h in enumerate(HIDDEN):
        shapes[f"head.norms.{i}.weight"] = (h,)
        shapes[f"head.norms.{i}.bias"] = (h,)
    shapes["head.out.weight"] = (out_dim, HIDDEN[-1])
    shapes["head.out.bias"] = (out_dim,)
    return shapes


def layer_norm(x: torch.Tensor, weight, bias) -> torch.Tensor:
    """Normalise over the last axis: ``(x - mean) / sqrt(var + eps)``."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * weight + bias


def encoder(w: dict, im: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 32 (H/16) (W/16)) features."""
    x = im.permute(0, 3, 1, 2)
    for i in range(len(FEATURES)):
        x = F.conv2d(x, w[f"conv.convs.{i}.weight"], w[f"conv.convs.{i}.bias"],
                     padding=1)
        x = layer_norm(x.permute(0, 2, 3, 1), w[f"conv.norms.{i}.weight"],
                       w[f"conv.norms.{i}.bias"])
        x = torch.relu(x).permute(0, 3, 1, 2)
        if i < len(FEATURES) - 1:
            x = F.max_pool2d(x, 2)
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def head(w: dict, feats: torch.Tensor, th: torch.Tensor) -> torch.Tensor:
    """(B, F) features and (B, T+1, 4) states -> (B, out_dim)."""
    x = torch.cat([feats, th[..., :2].reshape(th.shape[0], -1)], dim=-1)
    for i in range(len(HIDDEN)):
        x = x @ w[f"head.dense.{i}.weight"].T + w[f"head.dense.{i}.bias"]
        x = torch.relu(layer_norm(x, w[f"head.norms.{i}.weight"],
                                  w[f"head.norms.{i}.bias"]))
    return x @ w["head.out.weight"].T + w["head.out.bias"]


def static_bias(steps: int, qc_inv: float, cost_sigma: float, eps: float,
                eps_max: float) -> list:
    """The head's output at a zero final kernel that decodes to the static
    covariances: sqrt(Q_c⁻¹) per GP factor, 1/σ per state, logit(eps /
    eps_max) per state."""
    p = eps / eps_max
    logit = float(torch.log(torch.tensor(p / (1.0 - p), dtype=torch.float64)))
    return ([qc_inv ** 0.5] * steps + [1.0 / cost_sigma] * (steps + 1)
            + [logit] * (steps + 1))


@dataclasses.dataclass
class Decoded:
    q_inv: torch.Tensor  # (B, T, 4, 4)
    obs_w: torch.Tensor  # (B, T+1)
    eps: torch.Tensor  # (B, T+1)


def decode(out: torch.Tensor, steps: int, dt: float,
           eps_max: float) -> Decoded:
    s = out[:, :steps]
    eye = torch.eye(2, dtype=out.dtype, device=out.device)
    q_inv = gpmp2.gp_q_inv((s * s)[..., None, None] * eye, dt)
    so = out[:, steps:2 * steps + 1]
    return Decoded(q_inv=q_inv, obs_w=so * so,
                   eps=eps_max * torch.sigmoid(out[:, 2 * steps + 1:]))


def learned_problem(fixed: gpmp2.Problem, dec: Decoded) -> gpmp2.Problem:
    return dataclasses.replace(fixed, q_inv=dec.q_inv, obs_w=dec.obs_w,
                               eps=dec.eps)


def image_stack(im: torch.Tensor, sdf: torch.Tensor) -> torch.Tensor:
    """(B, H, W) occupancy and SDF -> the (B, H, W, 2) network input."""
    return torch.stack([im.to(sdf.dtype), sdf], dim=-1)


def best_score(fixed: gpmp2.Problem, res: gpmp2.Residuals) -> torch.Tensor:
    """GP mean squared residual where no interior state touches the
    inflated obstacles under the fixed factors, else +inf."""
    colliding = (res.r_obs[:, 1:-1] > 0).any(-1)
    mse = (res.r_gp * res.r_gp).sum(-1).mean(-1)
    return torch.where(colliding, torch.full_like(mse, float("inf")), mse)


def plan(w: dict, fixed: gpmp2.Problem, im: torch.Tensor, th0: torch.Tensor,
         reg: float, iters: int, eps_max: float, feats=None):
    """The learned plan with the best collision-free iterate kept:
    ``(th, errs (iters, B), errs_ext (iters, B), th_final)``; ``errs[k]``
    is the error of iterate k under iteration k's covariances,
    ``errs_ext[k]`` under the fixed ones.  ``feats``: the encoder's output,
    where the caller has it."""
    steps = th0.shape[1] - 1
    if feats is None:
        feats = encoder(w, image_stack(im, fixed.sdf))
    th = th0
    best_th, best_s = th0, best_score(fixed, gpmp2.residuals(fixed, th0))
    errs, errs_ext = [], []
    for _ in range(iters):
        dec = decode(head(w, feats, th), steps, fixed.dt, eps_max)
        p = learned_problem(fixed, dec)
        res = gpmp2.residuals(p, th)
        errs.append(gpmp2.error(p, res))
        res_fix = gpmp2.residuals(fixed, th)
        errs_ext.append(gpmp2.error(fixed, res_fix))
        th = th + gpmp2.gn_step(p, res, reg)
        s = best_score(fixed, gpmp2.residuals(fixed, th))
        better = s < best_s
        best_th = torch.where(better[:, None, None], th, best_th)
        best_s = torch.minimum(s, best_s)
    out = torch.where(torch.isfinite(best_s)[:, None, None], best_th, th)
    return out, torch.stack(errs), torch.stack(errs_ext), th
