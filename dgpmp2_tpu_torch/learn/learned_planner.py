"""Learned differentiable planner: CNN + head predicting factor covariances.

Port of ``dgpmp2_tpu/learn/learned_planner.py``.  Per plan a CNN encodes the
``(im, sdf)`` stack once; per GN iteration a feed-forward or recurrent head
maps (features ⊕ trajectory positions) to a flat vector that
:mod:`dgpmp2_tpu_torch.learn.covariances` decodes into PSD factor
covariances, which drive one damped block GN step (assembly, then K-BTD on
the card).  Gradients flow through the solve into the network (the
implicit-adjoint backward of the block-tridiagonal solve).

The weights live in ``variables``, an ``nn.ModuleDict`` with the encoder
under ``"conv"`` and the head under ``"head"``, made by
:meth:`LearnedDiffGPMP2Planner.init_variables` from an explicit
``torch.Generator`` (or loaded from the JAX package's flax variables with
``dgpmp2_tpu_torch.convert.learned_state_from_flax``).  The head's output is
cast to float32 before the decode, as in the JAX package, even in a float64
plan: the covariances are float32 numbers, promoted where they meet the
plan's float64 tensors.

Where the JAX package evaluates the factor graph several times at one
trajectory (the GN step's residuals, ``err`` under the predicted params,
``err_ext`` under the fixed ones; LM's proposal and the best-iterate score
at the next one), the port looks the SDF up once per trajectory
(:func:`dgpmp2_tpu_torch.core.graph.eval_geometry`) and evaluates each
params' residuals from it: a learned ε moves the hinge, not the SDF value.
A plan makes one lookup per iteration, plus one at the seed with LM or
``track_best``.

In training (``train=True``) the feed-forward head's dropout draws its masks
from the ``rng`` handed to :meth:`LearnedDiffGPMP2Planner.predict` /
:meth:`~LearnedDiffGPMP2Planner.step`: a ``torch.Generator`` or masks drawn
beforehand (``FeedForwardHead.dropout_masks``), as the JAX package's
``step(..., train=True, rng=...)``.  Without ``train`` there is no dropout.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from dgpmp2_tpu_torch.core import factors, gn
from dgpmp2_tpu_torch.core import graph as graph_lib
from dgpmp2_tpu_torch.learn import covariances as cov_lib
from dgpmp2_tpu_torch.models.conv_encoder import (ConvEncoder, ConvEncoder3D,
                                                  normalize_im)
from dgpmp2_tpu_torch.models.cov_head import (Dropout, FeedForwardHead,
                                              RecurrentHead,
                                              traj_positions_flat)
from dgpmp2_tpu_torch.ops import sdf as sdf_ops
from dgpmp2_tpu_torch.ops import tridiag
from dgpmp2_tpu_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class LearnedPlannerConfig:
    """Static learned-planner options (the learn YAML's ``dgpmp2`` and
    ``model`` sections)."""

    dynamics_mode: str = "diag_identity"
    learn_eps: bool = False
    # Bound on the learned safety margin: eps = eps_max * sigmoid(s) in
    # place of the unbounded s**2.
    eps_max: Optional[float] = None
    sdf_predict: bool = True  # feed (im, sdf) vs im only
    # Feed the hinge costmap max(0, (eps + r) - sdf) as the map channel.
    costmap_predict: bool = False
    costmap_eps: float = 0.4
    # Per-image [-1, 1] min-max normalisation of the conv input.
    normalize_im: bool = False
    # Training only: the conv features are computed once per problem and
    # detached, so that the encoder is not trained (a plan computes them
    # once per plan in any case).
    fixed_conv: bool = False
    dtheta_predict: bool = False  # feed the previous GN update to the head
    # Head output bias reproducing these static covariances at init:
    # (qc_inv_scalar, cost_sigma[, eps]); see static_out_bias.
    static_init: Optional[tuple] = None
    model_type: str = "feed_forward"  # feed_forward | rnn_gru | rnn_lstm
    hidden_dim: int = 64
    num_hidden: int = 1
    dropout_prob: float = 0.5
    dtype: torch.dtype = torch.float32


class LearnedDiffGPMP2Planner:
    """ConvEncoder + covariance head + the block GN engine, on ``device``:
    the card unless ``device="cpu"`` is given (without a card the first
    tensor made raises)."""

    def __init__(self, spec: graph_lib.GraphSpec, robot,
                 optim_cfg: gn.OptimConfig, learn_cfg: LearnedPlannerConfig,
                 device: torch.device | str | None = None):
        gn.resolve_engine(optim_cfg.engine)
        self.spec = spec
        self.robot = robot
        self.cfg = optim_cfg
        self.learn_cfg = learn_cfg
        self.device = torch.device("cuda" if device is None else device)
        self.out_dim = cov_lib.out_dim(spec, learn_cfg.dynamics_mode,
                                       learn_cfg.learn_eps)
        self._is3d = spec.z_lims is not None
        self.out_bias = (None if learn_cfg.static_init is None
                         else self.static_out_bias(*learn_cfg.static_init))
        if learn_cfg.model_type not in ("feed_forward", "rnn_gru",
                                        "rnn_lstm"):
            raise ValueError(f"unknown model_type {learn_cfg.model_type!r}")

    @property
    def recurrent(self) -> bool:
        return self.learn_cfg.model_type != "feed_forward"

    def static_out_bias(self, qc_inv_scalar, cost_sigma, eps=0.4):
        """Head-output bias reproducing the static covariances at init.

        The decode squares the outputs, so sqrt(Q_c⁻¹ scalar) for the GP
        terms and 1/σ for the obstacle terms make the zero-kernel forward
        pass the fixed-covariance planner.  ``qc_full``/``q_full`` decode
        through rank-1 outer products, for which a constant bias gives the
        singular ``qc_inv·𝟙``, so static_init is refused there.  Under
        ``eps_max`` the eps bias is logit(eps / eps_max), which must lie
        strictly inside (0, 1).
        """
        spec, cfg = self.spec, self.learn_cfg
        t, tn, l = spec.num_gp_factors, spec.num_traj_states, spec.nlinks
        mode = cfg.dynamics_mode
        if mode in ("qc_full", "q_full"):
            raise ValueError(
                f"static_init is not representable under dynamics_mode "
                f"{mode!r}: the rank-1 outer-product decode cannot emit the "
                "static diagonal covariance (a constant bias decodes to the "
                "singular qc_inv*ones matrix). Use diag/diag_identity for "
                "static_init, or initialize without it."
            )
        gp_val = math.sqrt(float(qc_inv_scalar))
        obs_val = 1.0 / float(cost_sigma)
        gp_terms = {"fix_dynamics": 0, "diag_identity": t,
                    "diag": t * spec.dof}[mode]
        bias = [gp_val] * gp_terms + [obs_val] * (tn * l)
        if cfg.learn_eps:
            if cfg.eps_max is not None:
                p = float(eps) / float(cfg.eps_max)
                if not 0.0 < p < 1.0:
                    raise ValueError(
                        f"static_init eps {eps} must lie strictly inside "
                        f"(0, eps_max={cfg.eps_max}) for the sigmoid decode "
                        "to reproduce it at init"
                    )
                eps_bias = math.log(p / (1.0 - p))
            else:
                eps_bias = math.sqrt(float(eps))
            bias += [eps_bias] * (tn * l)
        return tuple(bias)

    # -- variables ---------------------------------------------------------

    def _head_pos(self, th, dth_prev=None):
        pd = 3 if self._is3d else 2
        dtype = self.learn_cfg.dtype
        pos = traj_positions_flat(th, pd).to(dtype)
        if self.learn_cfg.dtheta_predict:
            if dth_prev is None:
                dth_prev = torch.zeros_like(th)
            pos = torch.cat([pos, traj_positions_flat(dth_prev, pd).to(dtype)],
                            dim=-1)
        return pos

    def _build_variables(self, in_channels: int, spatial,
                        num_states: int) -> nn.ModuleDict:
        """The encoder and head for an input stack of ``in_channels``
        channels and spatial shape ``spatial`` and trajectories of
        ``num_states`` states, parameters not yet set, on the CPU in
        float32."""
        cfg = self.learn_cfg
        conv = (ConvEncoder3D if self._is3d else ConvEncoder)(in_channels)
        pos_len = (3 if self._is3d else 2) * num_states
        if cfg.dtheta_predict:
            pos_len *= 2
        in_dim = conv.out_dim(spatial) + pos_len
        if self.recurrent:
            head = RecurrentHead(
                in_dim, self.out_dim, hidden_dim=cfg.hidden_dim,
                num_hidden=cfg.num_hidden,
                cell_type="lstm" if cfg.model_type == "rnn_lstm" else "gru",
                out_bias=self.out_bias)
        else:
            head = FeedForwardHead(in_dim, self.out_dim,
                                   dropout_prob=cfg.dropout_prob,
                                   out_bias=self.out_bias)
        return nn.ModuleDict({"conv": conv, "head": head})

    def init_variables(self, generator: torch.Generator, im_stack, th
                       ) -> nn.ModuleDict:
        """The network for ``im_stack`` (B, *spatial, C) and ``th``
        (B, T+1, D), its parameters drawn from ``generator`` (a CPU
        generator: the same draws on every device), then moved to the
        planner's device in ``learn_cfg.dtype``."""
        variables = self._build_variables(im_stack.shape[-1],
                                         tuple(im_stack.shape[1:-1]),
                                         th.shape[-2])
        with torch.no_grad():
            variables["conv"].reset_parameters(generator)
            variables["head"].reset_parameters(generator)
        return variables.to(device=self.device, dtype=self.learn_cfg.dtype)

    def load_variables(self, state: dict, im_stack, th) -> nn.ModuleDict:
        """The network for ``im_stack`` and ``th`` with the parameters of
        ``state`` (as ``convert.learned_state_from_flax`` gives them), on
        the planner's device in ``learn_cfg.dtype``."""
        variables = self._build_variables(im_stack.shape[-1],
                                         tuple(im_stack.shape[1:-1]),
                                         th.shape[-2])
        variables = variables.to(dtype=self.learn_cfg.dtype)
        variables.load_state_dict(state)
        return variables.to(device=self.device)

    def init_hidden(self, variables: nn.ModuleDict, batch_size: int):
        """Zero recurrent carry (None for the feed-forward head)."""
        if not self.recurrent:
            return None
        return variables["head"].initialize_carry(batch_size)

    # -- forward pieces ------------------------------------------------------

    def stack_inputs(self, im: torch.Tensor, sdf: torch.Tensor) -> torch.Tensor:
        """The (B, *spatial, C) conv input per ``sdf_predict`` /
        ``costmap_predict`` / ``normalize_im``."""
        cfg = self.learn_cfg
        if cfg.costmap_predict:
            safety = cfg.costmap_eps + float(max(self.robot.sphere_radii))
            sdf = sdf_ops.costmap_2d(sdf, safety)
        if cfg.sdf_predict or cfg.costmap_predict:
            # costmap_predict selects which map the model sees; it feeds it
            # even when sdf_predict is off.
            out = torch.stack([im.to(sdf.dtype), sdf], dim=-1).to(cfg.dtype)
        else:
            out = im[..., None].to(cfg.dtype)
        if cfg.normalize_im:
            out = normalize_im(out)
        return out

    def conv_features(self, variables: nn.ModuleDict,
                      im_stack: torch.Tensor) -> torch.Tensor:
        return variables["conv"](im_stack)

    def predict(self, variables: nn.ModuleDict, th, feats, hidden=None,
                train: bool = False, dth_prev=None, rng: Dropout = None):
        """Head forward + covariance decode: (covs, new_hidden).  With
        ``dtheta_predict`` the previous GN update's positions join the
        head's input.  With ``train`` the feed-forward head's dropout masks
        come from ``rng`` (a generator or the masks themselves); the
        recurrent head has no dropout."""
        pos = self._head_pos(th, dth_prev)
        head = variables["head"]
        if self.recurrent:
            out, new_hidden = head(feats, pos, hidden)
        else:
            out, new_hidden = head(feats, pos, train=train, rng=rng), None
        lc = self.learn_cfg
        covs = cov_lib.decode(out.to(torch.float32), self.spec,
                              lc.dynamics_mode, lc.learn_eps, lc.eps_max)
        return covs, new_hidden

    def graph_params(self, params_fix: graph_lib.GraphParams,
                     covs: cov_lib.DecodedCovariances
                     ) -> graph_lib.GraphParams:
        """The decoded covariances on the fixed-parameter template."""
        p = params_fix
        if covs.q_inv is not None:
            p = dataclasses.replace(p, q_inv=covs.q_inv)
        elif covs.qc_inv is not None:
            p = dataclasses.replace(p, q_inv=factors.gp_q_inv(covs.qc_inv,
                                                              self.spec.dt))
        p = dataclasses.replace(p, obs_inv=covs.obs_inv)
        if covs.eps is not None:
            p = dataclasses.replace(p, eps=covs.eps)
        return p

    # -- planner steps -------------------------------------------------------

    def _step(self, variables, params_fix, th, geom, feats, hidden, train,
              dth_prev, delta, trust_region, rng=None):
        """One learned GN iteration at ``th`` from its geometry."""
        spec, robot = self.spec, self.robot
        covs, new_hidden = self.predict(variables, th, feats, hidden,
                                        train=train, dth_prev=dth_prev,
                                        rng=rng)
        params = self.graph_params(params_fix, covs)
        res = graph_lib.residuals_from_geometry(spec, robot, params, th, geom)
        diag, off, rhs = graph_lib.assemble_from_residuals(spec, params, res,
                                                           dtype=th.dtype)
        diag, off, rhs = gn.damped_system(diag, off, rhs, delta,
                                          trust_region=trust_region)
        dth = tridiag.btd_solve_auto(diag, off, rhs)
        err = graph_lib.error_from_residuals(spec, params, res).detach()
        # External error under the fully fixed params, eps included: a
        # learned eps shrinks the hinge residuals themselves, so the
        # learned weights could otherwise deflate err_ext.
        res_fix = (res if params.eps is params_fix.eps else
                   graph_lib.residuals_from_geometry(spec, robot, params_fix,
                                                     th, geom))
        err_ext = graph_lib.error_from_residuals(spec, params_fix, res_fix)
        return dth, err, err_ext, params, new_hidden

    def step(self, variables, params_fix: graph_lib.GraphParams, th, sdf,
             feats, hidden=None, train: bool = False, dth_prev=None,
             delta=None, rng: Dropout = None,
             geom: Optional[graph_lib.Geometry] = None):
        """One learned GN iteration: (dtheta, err, err_ext, params_used,
        new_hidden).  ``delta`` (B,) is a per-problem LM lambda applied as
        trust-region damping; None keeps the scalar ``cfg.reg``.  ``rng``:
        the dropout source with ``train``.  ``geom``, the geometry of ``th``
        (``graph.eval_geometry``) where the caller has it, saves the
        lookup."""
        th = th.to(self.device)
        if geom is None:
            geom = graph_lib.eval_geometry(self.spec, self.robot, th,
                                           sdf.to(self.device).contiguous())
        lm = delta is not None
        return self._step(variables, params_fix, th, geom, feats, hidden,
                          train, dth_prev, delta if lm else self.cfg.reg, lm,
                          rng)

    def _best_score(self, params_fix, th, geom):
        """GP-MSE of the iterate if its interior is free of collision under
        the fixed params (GP-interpolated checks and self-collision
        included), else +inf; detached."""
        res = graph_lib.residuals_from_geometry(self.spec, self.robot,
                                                params_fix, th, geom)
        return gn._best_score(res).detach()

    def plan(self, variables, params_fix: graph_lib.GraphParams, th_init,
             sdf, im, max_iters: Optional[int] = None, hidden=None,
             track_best: bool = False, return_final: bool = False):
        """The unrolled learned plan: covariances predicted every GN
        iteration.  Returns ``(th, errs (iters, B), errs_ext (iters, B),
        hidden)``, and the final iterate as a fifth value with
        ``return_final``.

        ``track_best`` returns the best non-colliding iterate by GP-MSE,
        judged under the fixed ``params_fix``, where there is one.  Under
        ``cfg.method == "lm"`` each problem keeps a lambda (×10 on a
        rejected step, ÷10 on an accepted one), both errors of the test
        taken under this iteration's predicted covariances.
        """
        spec, robot = self.spec, self.robot
        iters = max_iters or self.cfg.max_iters
        lm = self.cfg.method == "lm"
        th_init = th_init.to(self.device)
        sdf = sdf.to(self.device).contiguous()
        im = im.to(self.device)
        feats = self.conv_features(variables, self.stack_inputs(im, sdf))
        b = th_init.shape[0]
        if self.recurrent and hidden is None:
            hidden = self.init_hidden(variables, b)
        dtype = th_init.dtype
        reg = torch.tensor(self.cfg.reg, dtype=dtype, device=self.device)
        lam = torch.full((b,), self.cfg.lm_lambda_init, dtype=dtype,
                         device=self.device)
        th, dth_prev = th_init, torch.zeros_like(th_init)
        geom = None
        if lm or track_best:
            geom = graph_lib.eval_geometry(spec, robot, th, sdf)
        if track_best:
            best_th, best_s = th, self._best_score(params_fix, th, geom)
        errs, errs_ext = [], []
        for _ in range(iters):
            if geom is None:
                geom = graph_lib.eval_geometry(spec, robot, th, sdf)
            dth, err, err_ext, params, hidden = self._step(
                variables, params_fix, th, geom, feats, hidden, False,
                dth_prev, lam if lm else reg, lm)
            th_new, geom_new = th + dth, None
            if lm or track_best:
                geom_new = graph_lib.eval_geometry(spec, robot, th_new, sdf)
            if lm:
                # Accept or reject on this iteration's covariances.
                err_prop = graph_lib.error_from_residuals(
                    spec, params, graph_lib.residuals_from_geometry(
                        spec, robot, params, th_new, geom_new)).detach()
                accept = err_prop < err
                th_new = torch.where(accept[:, None, None], th_new, th)
                dth = torch.where(accept[:, None, None], dth,
                                  torch.zeros_like(dth))
                lam = torch.where(accept, lam / 10.0, lam * 10.0)
                geom_new = graph_lib.select(accept, geom_new, geom)
            if track_best:
                s = self._best_score(params_fix, th_new, geom_new)
                better = s < best_s
                best_th = torch.where(better[:, None, None], th_new, best_th)
                best_s = torch.minimum(s, best_s)
            th, dth_prev, geom = th_new, dth, geom_new
            errs.append(err)
            errs_ext.append(err_ext)
        th_final = th
        if track_best:
            th = torch.where(torch.isfinite(best_s)[:, None, None], best_th,
                             th)

        def trace(xs):
            return (torch.stack(xs) if xs else
                    torch.zeros((0, b), dtype=dtype, device=self.device))

        out = (th, trace(errs), trace(errs_ext), hidden)
        return out + (th_final,) if return_final else out

    def plan_multistart(self, variables, params_fix: graph_lib.GraphParams,
                        th_init, sdf, im, generator: torch.Generator,
                        restarts: int = 8, amp: float = 1.5,
                        harmonics: int = 3, max_iters: Optional[int] = None,
                        contact_weight: float = 1e6, prune_iters: int = 0,
                        keep: int = 0):
        """Learned covariances with batched multistart seeding: the
        ``restarts`` endpoint-preserving perturbations of every seed (drawn
        from ``generator``) planned as one (K·B) batch through :meth:`plan`
        with ``track_best``, then the best candidate selected per problem.

        ``prune_iters``/``keep`` enable staged pruning: all K seeds run
        ``prune_iters`` iterations, candidates are ranked by their phase-1
        tracked-best iterate, and the ``keep`` best per problem (ties to the
        lower index) resume from their phase-1 final iterate with their
        recurrent carry; selection pools each survivor's phase-1 and
        phase-2 best.  Returns a ``MultistartResult`` (``iters`` None).
        Under ``dtheta_predict`` the previous-update input restarts from 0
        at the phase boundary, as in the JAX package.
        """
        from dgpmp2_tpu_torch.core.multistart import (perturbed_inits,
                                                      score_candidates,
                                                      select_best,
                                                      tile_params)

        if self.spec.use_workspace_goal:
            raise NotImplementedError(
                "plan_multistart does not support use_workspace_goal "
                "specs; use core.multistart.plan_multistart")
        iters = max_iters or self.cfg.max_iters
        staged = prune_iters > 0 or keep > 0
        if staged and not (0 < prune_iters < iters and 0 < keep <= restarts):
            raise ValueError(
                f"staged pruning needs 0 < prune_iters < max_iters and "
                f"0 < keep <= restarts; got prune_iters={prune_iters}, "
                f"max_iters={iters}, keep={keep}, restarts={restarts}"
            )
        th_init = th_init.to(self.device)
        sdf = sdf.to(self.device).contiguous()
        im = im.to(self.device)
        b = th_init.shape[0]

        def tile(x, k):  # K copies along the batch axis, K-major
            return x.repeat(k, *(1,) * (x.ndim - 1))

        th0s = perturbed_inits(th_init, generator, restarts, amp,
                               self.spec.total_time_sec, harmonics)
        th0s = th0s.reshape(restarts * b, *th0s.shape[2:])
        sdf_t = tile(sdf, restarts)
        params_t = tile_params(params_fix, b, restarts)
        if not staged:
            th, _, _, _ = self.plan(variables, params_t, th0s, sdf_t,
                                    tile(im, restarts), max_iters=iters,
                                    track_best=True)
            return select_best(self.spec, self.robot, th, sdf_t, restarts, b,
                               contact_weight=contact_weight)

        best1, _, _, hidden1, th1 = self.plan(
            variables, params_t, th0s, sdf_t, tile(im, restarts),
            max_iters=prune_iters, track_best=True, return_final=True)
        score1, _ = score_candidates(self.spec, self.robot, best1, sdf_t,
                                     contact_weight)
        del sdf_t
        # The `keep` lowest scores per problem, ties to the lower index.
        idx = torch.argsort(score1.reshape(restarts, b).T, dim=-1,
                            stable=True)[:, :keep]
        cols = torch.arange(b, device=idx.device)

        def gather(x):  # (K·B, ...) K-major -> survivors (keep·B, ...)
            xk = x.reshape(restarts, b, *x.shape[1:])
            return xk[idx.T, cols].reshape(keep * b, *x.shape[1:])

        sdf_k = tile(sdf, keep)
        th2, _, _, _ = self.plan(
            variables, tile_params(params_fix, b, keep), gather(th1), sdf_k,
            tile(im, keep), max_iters=iters - prune_iters, track_best=True,
            hidden=tree_map(gather, hidden1))
        pool = torch.cat([gather(best1), th2], dim=0)
        return select_best(self.spec, self.robot, pool,
                           torch.cat([sdf_k, sdf_k], dim=0), 2 * keep, b,
                           contact_weight=contact_weight)
