"""Learned-planner training: truncated backprop through unrolled GN steps.

Port of ``dgpmp2_tpu/learn/train.py``.  The JAX package's chunked
``lax.scan`` becomes a Python loop over windows of ``tk`` GN steps: within a
window the gradient flows through every step (through the block solve by its
implicit adjoint, and through each SDF lookup by its backward, K-LOOKUP-BWD
on the card); the trajectory carry is detached at window boundaries.  With
``remat`` each window body runs under ``torch.utils.checkpoint`` (its
activations recomputed in the backward pass).

Window semantics, as in the JAX package:

* ``tk2 is None``: non-overlapping windows of ``tk`` (``tk = T`` is full
  BPTT); ``method="lm"`` planners train here only, with LM's accept/reject
  and a per-problem λ carried across windows.
* ``tk2 >= tk``: sliding windows.  A rollout with no gradient records the
  trajectory; each loss point (every ``tk`` steps) recomputes its trailing
  ``tk2`` steps under gradient.
* ``optimize_tk``: an optimizer step after every window, each applying the
  gradient summed since the batch began.

The trajectory's geometry (``graph.eval_geometry``: FK and the one SDF
lookup) at each new iterate serves both the step's loss and the next GN
step, so a training step makes one lookup under gradient per GN iteration.

Dropout masks come from ``(seed, train step, GN step)``
(:func:`dropout_seed`), drawn before the window that uses them, so that a
checkpointed window's recompute and the sliding path's recompute see the
masks of the first pass.  The port updates the weights and the optimizer
state in place; ``TrainState.step`` counts the steps.

On a device mesh (``make_train_step(mesh=)``) the step is data-parallel
over a ``parallel.sharding.ShardedState``, the feed-forward head
tensor-parallel inside each data row, and equals the unsharded step to
rounding (:func:`_sharded_step`).

Where the JAX package fixes float32 for the fixed covariances and the seed
trajectory, the port takes the planner's ``learn_cfg.dtype`` (float32 in the
shipped configurations), so that a float64 planner trains in float64.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from dgpmp2_tpu_torch.core import graph
from dgpmp2_tpu_torch.learn.learned_planner import LearnedDiffGPMP2Planner
from dgpmp2_tpu_torch.learn.losses import LossTerms, LossWeights, one_step_loss
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj
from dgpmp2_tpu_torch.utils.tree import tree_map


@dataclasses.dataclass
class TrainState:
    step: int
    variables: nn.ModuleDict  # {"conv": encoder, "head": head}
    optimizer: torch.optim.Optimizer


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The learn YAML's ``optim`` / ``dgpmp2`` training options."""

    T: int = 10  # unroll length per batch
    tk: int = 5  # TBPTT window (gradient truncation and loss cadence)
    tk2: Optional[int] = None  # sliding look-back (>= tk); None: chunked
    use_inter_loss: bool = True
    clip_grad: bool = True
    clip_val: float = 2.0
    remat: bool = True  # torch.utils.checkpoint on each window body
    # An optimizer step after every tk window, applying the gradient summed
    # over all windows so far (the reference zeroes gradients only at the
    # batch's start).
    optimize_tk: bool = False


class OptaxRMSprop(torch.optim.Optimizer):
    """optax's ``rmsprop`` after ``add_decayed_weights``: ν ← 0.9ν + 0.1g²
    (also μ ← 0.9μ + 0.1g when centered), u = −lr·g/√(ν [− μ²] + ε) with ε
    inside the root, then a momentum trace t ← u + m·t.  torch's
    ``RMSprop`` decays at 0.99 by default and adds ε outside the root."""

    def __init__(self, params, lr: float, decay: float = 0.9,
                 eps: float = 1e-8, momentum: float = 0.0,
                 centered: bool = False, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      momentum=momentum, centered=centered,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, decay, eps = group["lr"], group["decay"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                st = self.state[p]
                if not st:
                    st["nu"] = torch.zeros_like(p)
                    st["mu"] = torch.zeros_like(p)
                    st["trace"] = torch.zeros_like(p)
                st["nu"] = (1 - decay) * (g * g) + decay * st["nu"]
                den = st["nu"]
                if group["centered"]:
                    st["mu"] = (1 - decay) * g + decay * st["mu"]
                    den = den - st["mu"] * st["mu"]
                u = -lr * (torch.rsqrt(den + eps) * g)
                st["trace"] = u + group["momentum"] * st["trace"]
                p.add_(st["trace"])


def make_optimizer(name: str, opt: dict) -> Callable:
    """The optimizer of the learn YAML's ``optim`` section as a factory
    ``tx(params) -> torch.optim.Optimizer``, each updating as its optax
    counterpart in the JAX package: ``adam`` (``adamw``, decoupled decay,
    when ``reg_strength`` is set), ``sgd`` (decay added to the gradient
    before momentum; ``nesterov``) and ``rmsprop`` (:class:`OptaxRMSprop`);
    step size ``alpha``."""
    lr = float(opt.get("alpha", 1e-4))
    wd = float(opt.get("reg_strength", 0.0))
    momentum = float(opt.get("momentum", 0.0))
    if name == "adam":
        if wd:
            return lambda params: torch.optim.AdamW(params, lr,
                                                    weight_decay=wd)
        return lambda params: torch.optim.Adam(params, lr)
    if name == "sgd":
        # optax's trace with decay 0 is the plain gradient, Nesterov or not.
        nesterov = bool(opt.get("nesterov", False)) and momentum > 0
        return lambda params: torch.optim.SGD(params, lr, momentum=momentum,
                                              nesterov=nesterov,
                                              weight_decay=wd)
    if name == "rmsprop":
        centered = bool(opt.get("centered", False))
        return lambda params: OptaxRMSprop(params, lr, momentum=momentum,
                                           centered=centered,
                                           weight_decay=wd)
    raise ValueError(f"unknown optimizer {name!r}")


def zero_missing_grads(variables: nn.ModuleDict) -> None:
    """A zero gradient for every parameter that got none (the conv under
    ``fixed_conv``), so that every leaf stays in the norm and steps the
    optimizer, as the JAX package's gradient tree holds every leaf."""
    for p in variables.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def clip_by_global_norm(variables: nn.ModuleDict,
                        clip_val: float) -> torch.Tensor:
    """Scale every gradient by ``min(1, clip_val / (‖g‖ + 1e-9))``, ‖g‖ the
    norm over all of them (as the JAX package; torch's
    ``clip_grad_norm_`` adds 1e-6); returns ‖g‖."""
    grads = [p.grad for p in variables.parameters()]
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    scale = torch.clamp(clip_val / (gnorm + 1e-9), max=1.0)
    for g in grads:
        g.mul_(scale)
    return gnorm


def dropout_seed(seed: int, step: int, t: int) -> int:
    """The seed of the dropout masks of GN step ``t`` of training step
    ``step`` (numpy's ``SeedSequence`` of the three)."""
    return int(np.random.SeedSequence([seed, step, t])
               .generate_state(1, np.uint64)[0])


def dropout_masks(planner: LearnedDiffGPMP2Planner,
                  variables: nn.ModuleDict, batch: int, seed: int, step: int,
                  n_steps: int) -> list:
    """The keep-masks of each GN step of one training step (None for a head
    without dropout), each drawn on the planner's device from a generator
    seeded by :func:`dropout_seed`."""
    head = variables["head"]
    if planner.recurrent or head.dropout_prob == 0.0:
        return [None] * n_steps
    out = []
    for t in range(n_steps):
        gen = torch.Generator(planner.device)
        gen.manual_seed(dropout_seed(seed, step, t))
        out.append(head.dropout_masks(batch, gen))
    return out


def _detach_geometry(geom: graph.Geometry) -> graph.Geometry:
    return graph.Geometry(**{
        f.name: None if getattr(geom, f.name) is None
        else getattr(geom, f.name).detach()
        for f in dataclasses.fields(geom)})


def _step_loss(spec, robot, params_fix, geom_new, dth, th, th_new, th_opt,
               weights) -> LossTerms:
    """``one_step_loss`` at ``th_new`` from its geometry (the hinge rows too,
    for the max-penetration surrogate)."""
    res = graph.residuals_from_geometry(spec, robot, params_fix, th_new,
                                        geom_new)
    err_sg, err_gp, err_obs = graph.unweighted_errors_from_residuals(res)
    return one_step_loss(dth, th_opt - th, err_sg, err_gp, err_obs, weights,
                         spec.dof, r_obs=res.r_obs)


class _Unroll:
    """The unrolled GN steps of a training step on one planner (and so one
    device): the batch's inputs there, the windows of ``tk`` steps, their
    losses and the final metrics.  A sharded step has one a data shard."""

    def __init__(self, planner: LearnedDiffGPMP2Planner, weights: LossWeights,
                 train_cfg: TrainConfig):
        self.planner, self.weights, self.cfg = planner, weights, train_cfg
        self.spec, self.robot = planner.spec, planner.robot
        self.lm = planner.cfg.method == "lm"
        self.tk, self.dtype = train_cfg.tk, planner.learn_cfg.dtype
        self.denom = train_cfg.tk if train_cfg.use_inter_loss else 1

    def prepare(self, batch):
        spec, dev = self.spec, self.planner.device
        start, goal = batch["start"].to(dev), batch["goal"].to(dev)
        params_fix = graph.default_params(spec, self.robot, start, goal,
                                          **batch["cov_scalars"],
                                          dtype=self.dtype)
        th0 = straight_line_traj(start[:, :spec.dof], goal[:, :spec.dof],
                                 spec.total_time_sec,
                                 spec.total_time_step).to(self.dtype)
        sdf = batch["sdf"].to(device=dev, dtype=self.dtype).contiguous()
        return (params_fix, th0, sdf, batch["th_opt"].to(dev, self.dtype),
                batch["im"].to(dev))

    def features(self, variables, im, sdf):
        planner = self.planner
        stack = planner.stack_inputs(im, sdf)
        if planner.learn_cfg.fixed_conv:
            with torch.no_grad():
                return planner.conv_features(variables, stack)
        return planner.conv_features(variables, stack)

    def geometry(self, th, sdf):
        return graph.eval_geometry(self.spec, self.robot, th, sdf)

    def window(self, variables, params_fix, sdf, th_opt, feats, masks, t0,
               th, geom, hid, dth_prev, lam):
        """tk GN steps from the detached carry, steps t0.. of the unroll:
        (window loss, th, geometry, hidden, dth, lam)."""
        spec, robot, lm = self.spec, self.robot, self.lm
        loss_acc = 0.0
        for i in range(self.tk):
            dth, err, _, params_used, hid = self.planner.step(
                variables, params_fix, th, sdf, feats, hid, train=True,
                dth_prev=dth_prev, delta=lam if lm else None,
                rng=masks[t0 + i], geom=geom)
            th_new = th + dth
            geom_new = self.geometry(th_new, sdf)
            if lm:
                # The moving-surface accept test of the LM plan: both
                # errors under this iteration's predicted covariances.
                with torch.no_grad():
                    err_prop = graph.error_from_residuals(
                        spec, params_used, graph.residuals_from_geometry(
                            spec, robot, params_used, th_new, geom_new))
                accept = err_prop < err
                th_new = torch.where(accept[:, None, None], th_new, th)
                dth = torch.where(accept[:, None, None], dth,
                                  torch.zeros_like(dth))
                lam = torch.where(accept, lam / 10.0, lam * 10.0)
                geom_new = graph.select(accept, geom_new, geom)
            if self.cfg.use_inter_loss or i == self.tk - 1:
                loss_acc = loss_acc + _step_loss(
                    spec, robot, params_fix, geom_new, dth, th, th_new,
                    th_opt, self.weights).total
            th, dth_prev, geom = th_new, dth, geom_new
        return loss_acc / self.denom, th, geom, hid, dth_prev, lam

    def start(self, variables, th0, sdf):
        """The carry before the first window: (th, geometry, hidden,
        dth)."""
        return (th0, self.geometry(th0, sdf),
                self.planner.init_hidden(variables, th0.shape[0]),
                torch.zeros_like(th0))

    def chunked_losses(self, variables, params_fix, th0, sdf, th_opt, feats,
                       masks):
        tk = self.tk
        th, geom, hid, dth_prev = self.start(variables, th0, sdf)
        lam = torch.full((th0.shape[0],), self.planner.cfg.lm_lambda_init,
                         dtype=th0.dtype, device=th0.device)
        losses = []
        for k in range(self.cfg.T // tk):
            args = (variables, params_fix, sdf, th_opt, feats, masks, k * tk,
                    th.detach(), _detach_geometry(geom),
                    tree_map(torch.detach, hid), dth_prev.detach(), lam)
            loss, th, geom, hid, dth_prev, lam = (
                checkpoint(self.window, *args, use_reentrant=False)
                if self.cfg.remat else self.window(*args))
            losses.append(loss)
        return losses, th.detach(), _detach_geometry(geom)

    def sliding_losses(self, variables, params_fix, th0, sdf, th_opt, feats,
                       masks):
        planner, cfg, tk = self.planner, self.cfg, self.tk
        tk2 = cfg.tk2
        # The rollout with no gradient: each step's start state.
        ths, hids, dths, geoms = [], [], [], []
        th, hid = th0, planner.init_hidden(variables, th0.shape[0])
        dth_prev = torch.zeros_like(th0)
        with torch.no_grad():
            geom = self.geometry(th0, sdf)
            for t in range(cfg.T):
                ths.append(th)
                hids.append(hid)
                dths.append(dth_prev)
                geoms.append(geom)
                dth_prev, _, _, _, hid = planner.step(
                    variables, params_fix, th, sdf, feats, hid, train=True,
                    dth_prev=dth_prev, rng=masks[t], geom=geom)
                th = th + dth_prev
                geom = self.geometry(th, sdf)

        def window_k(k):
            t_end = (k + 1) * tk  # exclusive: the loss step is t_end - 1
            s = t_end - tk2  # negative for the first windows
            first = max(s, 0)
            th, hid, dth_prev, geom = (ths[first], hids[first], dths[first],
                                       geoms[first])
            loss_acc = 0.0
            for j in range(max(-s, 0), tk2):
                dth, _, _, _, hid = planner.step(
                    variables, params_fix, th, sdf, feats, hid, train=True,
                    dth_prev=dth_prev, rng=masks[s + j], geom=geom)
                th_new = th + dth
                geom_new = self.geometry(th_new, sdf)
                # The loss steps (the window's trailing tk) all have s+j>=0.
                if (cfg.use_inter_loss and j >= tk2 - tk) or (j == tk2 - 1):
                    loss_acc = loss_acc + _step_loss(
                        self.spec, self.robot, params_fix, geom_new, dth, th,
                        th_new, th_opt, self.weights).total
                th, dth_prev, geom = th_new, dth, geom_new
            return loss_acc / self.denom

        losses = [checkpoint(window_k, k, use_reentrant=False)
                  if cfg.remat else window_k(k)
                  for k in range(cfg.T // tk)]
        return losses, th, geom

    def losses(self, variables, params_fix, th0, sdf, th_opt, feats, masks):
        """The windows' losses, the final iterate and its geometry."""
        fn = (self.sliding_losses if self.cfg.tk2 is not None
              else self.chunked_losses)
        return fn(variables, params_fix, th0, sdf, th_opt, feats, masks)

    def final_metrics(self, params_fix, th, geom, th_opt):
        spec, robot = self.spec, self.robot
        with torch.no_grad():
            final_err = torch.mean(graph.error_from_residuals(
                spec, params_fix, graph.residuals_from_geometry(
                    spec, robot, params_fix, th, geom)))
            pos_mse = torch.mean((th[..., :2] - th_opt[..., :2]) ** 2)
        return final_err, pos_mse


def make_train_step(planner: LearnedDiffGPMP2Planner, weights: LossWeights,
                    train_cfg: TrainConfig, mesh=None):
    """The training step ``train_step(state, batch, seed) -> (state,
    metrics)``.

    ``batch``: ``im`` (B, *spatial), ``sdf`` (B, *spatial), ``start`` /
    ``goal`` (B, D), ``th_opt`` (B, T+1, D) tensors and ``cov_scalars``
    (the keywords of ``graph.default_params``).  ``seed`` with the state's
    step seeds the dropout masks.  Metrics (0-d tensors): ``loss``,
    ``final_err``, ``final_pos_mse`` and, when clipping, ``grad_norm``.

    With ``mesh`` (``parallel.sharding.make_mesh`` or
    ``make_multihost_mesh``) the step is data-parallel over a
    ``parallel.sharding.ShardedState`` (``shard_state``) and equals the
    unsharded step to rounding (:func:`_sharded_step`).
    """
    n_chunks = train_cfg.T // train_cfg.tk
    if n_chunks * train_cfg.tk != train_cfg.T:
        raise ValueError("tk must divide T")
    sliding = train_cfg.tk2 is not None
    if sliding and train_cfg.tk2 < train_cfg.tk:
        raise ValueError("tk2 must be >= tk")
    if planner.cfg.method == "lm" and (sliding or train_cfg.optimize_tk):
        raise NotImplementedError(
            "method='lm' training supports the chunked tk path only "
            "(unset tk2 / optimize_tk)")
    if train_cfg.optimize_tk and sliding:
        raise ValueError("optimize_tk does not compose with sliding tk2")
    if mesh is not None:
        return _sharded_step(planner, weights, train_cfg, mesh)
    u = _Unroll(planner, weights, train_cfg)
    tk = train_cfg.tk

    def train_step(state: TrainState, batch, seed: int):
        variables, optimizer = state.variables, state.optimizer
        params_fix, th0, sdf, th_opt, im = u.prepare(batch)
        masks = dropout_masks(planner, variables, th0.shape[0], seed,
                              state.step, train_cfg.T)
        optimizer.zero_grad(set_to_none=True)
        feats = u.features(variables, im, sdf)
        losses, th, geom = u.losses(variables, params_fix, th0, sdf, th_opt,
                                    feats, masks)
        total = torch.stack(losses).mean()
        total.backward()
        zero_missing_grads(variables)
        metrics = {"loss": total.detach()}
        if train_cfg.clip_grad:
            metrics["grad_norm"] = clip_by_global_norm(variables,
                                                       train_cfg.clip_val)
        optimizer.step()
        metrics["final_err"], metrics["final_pos_mse"] = u.final_metrics(
            params_fix, th, geom, th_opt)
        return dataclasses.replace(state, step=state.step + 1), metrics

    def train_step_tk(state: TrainState, batch, seed: int):
        """An optimizer step after every window, each applying the gradient
        summed since the batch began, later windows seeing the updated
        weights."""
        variables, optimizer = state.variables, state.optimizer
        params_fix, th0, sdf, th_opt, im = u.prepare(batch)
        masks = dropout_masks(planner, variables, th0.shape[0], seed,
                              state.step, train_cfg.T)
        params = list(variables.parameters())
        gsum = [torch.zeros_like(p) for p in params]
        th, geom, hid, dth_prev = u.start(variables, th0, sdf)
        losses = []
        for k in range(n_chunks):
            optimizer.zero_grad(set_to_none=True)
            feats = u.features(variables, im, sdf)
            loss, th, geom, hid, dth_prev, _ = u.window(
                variables, params_fix, sdf, th_opt, feats, masks, k * tk,
                th.detach(), _detach_geometry(geom),
                tree_map(torch.detach, hid), dth_prev.detach(), None)
            loss.backward()
            zero_missing_grads(variables)
            for acc, p in zip(gsum, params):
                acc.add_(p.grad)
                p.grad = acc.clone()
            if train_cfg.clip_grad:
                clip_by_global_norm(variables, train_cfg.clip_val)
            optimizer.step()
            losses.append(loss.detach())
        metrics = {"loss": torch.stack(losses).mean()}
        metrics["final_err"], metrics["final_pos_mse"] = u.final_metrics(
            params_fix, th.detach(), _detach_geometry(geom), th_opt)
        return dataclasses.replace(state, step=state.step + 1), metrics

    return train_step_tk if train_cfg.optimize_tk else train_step


def _sharded_step(planner: LearnedDiffGPMP2Planner, weights: LossWeights,
                  train_cfg: TrainConfig, mesh):
    """:func:`make_train_step`'s step over a ``ShardedState`` on ``mesh``.

    The batch's rows split over every data shard of the mesh (``dcn`` ×
    ``data``; ``sharding.row_bounds``, sizes differing by at most one).
    Each of this process's shards runs the unsharded step's forward and
    backward on its data row's devices: the encoder, decode and GN steps on
    the row's first device, the feed-forward head tensor-parallel over its
    model group (``learned_planner.row_variables``), one after another.
    What keeps the step the unsharded one:

    * the dropout masks are drawn for the whole batch, as the unsharded
      step draws them, and each shard takes its rows (the head its column
      slice);
    * each shard's loss, a mean over its rows, is weighted by its rows / B
      before the backward pass, so that the gradients' sum over the shards
      is the whole batch's; the metrics are reduced the same way;
    * ``sharding.reduce_grads`` sums the gradients over the devices that
      hold each part of a parameter, and over processes, before clipping,
      whose norm counts each slice and replica once
      (``sharding.clip_grads``);
    * every device steps its own optimizer on equal gradients, so that the
      replicas stay equal bit for bit.
    """
    from dgpmp2_tpu_torch.learn.learned_planner import row_variables
    from dgpmp2_tpu_torch.parallel import sharding

    units = [_Unroll(planner.replica(d), weights, train_cfg)
             for d in mesh.data_devices()]
    first = mesh.data_devices()[0]
    tk = train_cfg.tk

    def shards(state, batch, seed):
        """Per shard of this process: (unroll, variables, inputs, masks,
        rows / B)."""
        b = batch["th_opt"].shape[0]
        views = [row_variables(state.variables, i)
                 for i in range(len(units))]
        masks = dropout_masks(planner, views[0], b, seed, state.step,
                              train_cfg.T)
        out = []
        for (lo, hi), u, view in zip(sharding.row_bounds(b, mesh), units,
                                     views):
            rows = {k: v[lo:hi] if isinstance(v, torch.Tensor) else v
                    for k, v in batch.items()}
            dev = u.planner.device
            m = [None if mk is None else
                 tuple(x[lo:hi].to(dev) for x in mk) for mk in masks]
            out.append((u, view, u.prepare(rows), m, (hi - lo) / b))
        return out

    def reduced(values):
        """Each shard's weighted values summed here and over processes."""
        total = sum(torch.stack(v).to(first) for v in values)
        return sharding.process_all_reduce(total, mesh).unbind()

    def zero_grad(state):
        for opt in state.optimizers:
            opt.zero_grad(set_to_none=True)

    def finish(state):
        if train_cfg.clip_grad:
            gnorm = sharding.clip_grads(state.variables, train_cfg.clip_val)
        else:
            gnorm = None
        for opt in state.optimizers:
            opt.step()
        return gnorm

    def train_step(state, batch, seed: int):
        parts = shards(state, batch, seed)
        zero_grad(state)
        values = []
        for u, view, (params_fix, th0, sdf, th_opt, im), masks, w in parts:
            feats = u.features(view, im, sdf)
            losses, th, geom = u.losses(view, params_fix, th0, sdf, th_opt,
                                        feats, masks)
            total = torch.stack(losses).mean()
            (total * w).backward()
            values.append([w * x for x in (total.detach(), *u.final_metrics(
                params_fix, th, geom, th_opt))])
        sharding.reduce_grads(state.variables)
        loss, final_err, pos_mse = reduced(values)
        metrics = {"loss": loss}
        gnorm = finish(state)
        if gnorm is not None:
            metrics["grad_norm"] = gnorm
        metrics["final_err"], metrics["final_pos_mse"] = final_err, pos_mse
        return dataclasses.replace(state, step=state.step + 1), metrics

    def train_step_tk(state, batch, seed: int):
        parts = shards(state, batch, seed)
        params = [list(s.parameters()) for s in state.variables.shards]
        gsum = [[torch.zeros_like(p) for p in ps] for ps in params]
        carry = [u.start(view, inputs[1], inputs[2])
                 for u, view, inputs, _, _ in parts]
        losses = []
        for k in range(train_cfg.T // tk):
            zero_grad(state)
            values = []
            for i, (u, view, inputs, masks, w) in enumerate(parts):
                params_fix, _, sdf, th_opt, im = inputs
                th, geom, hid, dth_prev = carry[i]
                loss, th, geom, hid, dth_prev, _ = u.window(
                    view, params_fix, sdf, th_opt, u.features(view, im, sdf),
                    masks, k * tk, th.detach(), _detach_geometry(geom),
                    tree_map(torch.detach, hid), dth_prev.detach(), None)
                (loss * w).backward()
                carry[i] = (th, geom, hid, dth_prev)
                values.append([w * loss.detach()])
            sharding.reduce_grads(state.variables)
            for accs, ps in zip(gsum, params):
                for acc, p in zip(accs, ps):
                    acc.add_(p.grad)
                    p.grad = acc.clone()
            finish(state)
            losses.append(reduced(values)[0])
        final_err, pos_mse = reduced([
            [w * x for x in u.final_metrics(
                inputs[0], th.detach(), _detach_geometry(geom), inputs[3])]
            for (u, _, inputs, _, w), (th, geom, _, _) in zip(parts, carry)])
        metrics = {"loss": torch.stack(losses).mean(),
                   "final_err": final_err, "final_pos_mse": pos_mse}
        return dataclasses.replace(state, step=state.step + 1), metrics

    return train_step_tk if train_cfg.optimize_tk else train_step


def init_train_state(planner: LearnedDiffGPMP2Planner, tx: Callable,
                     generator: torch.Generator, sample_im_stack,
                     sample_th) -> TrainState:
    """Step 0: the planner's initial weights (drawn from ``generator``) and
    a fresh optimizer ``tx(parameters)`` (:func:`make_optimizer`)."""
    variables = planner.init_variables(generator, sample_im_stack, sample_th)
    return TrainState(step=0, variables=variables,
                      optimizer=tx(variables.parameters()))
