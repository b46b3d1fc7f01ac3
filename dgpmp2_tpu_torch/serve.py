"""Async micro-batching planning service: the deployment front end.

Port of ``dgpmp2_tpu/serve.py``.  Requests are (start, goal, world) problems;
an asyncio dispatcher coalesces concurrent ones into batches of a fixed
width, which one planner call plans on the planner's device (the card unless
the planner was built on the CPU).

* **One batch width.**  Every dispatch, full or padded, plans
  ``batch_size`` rows, so the shapes the kernels and their launch plans see
  never change after :meth:`PlanningService.warmup`.  Pad rows copy row 0:
  planning is row-independent, so they cost work but cannot perturb the
  real rows.
* **Micro-batching.**  The dispatcher waits at most ``window_ms`` after the
  first queued request before it dispatches a partial batch.
* **The event loop never waits on the device.**  A dispatch runs in a
  thread-pool executor, so ``submit`` keeps queueing while a batch is in
  flight; dispatches are serialised (the loop awaits each, and
  ``plan_batch_sync`` holds a lock regardless).
* **A world bank on the device.**  ``register_world`` uploads an SDF once;
  requests that name it carry no SDF, and a dispatch gathers its rows with
  one ``index_select``.
* **One hand-off.**  A dispatch uploads its inputs once and reads every
  output back in one device-to-host copy.

* **A mesh.**  With ``mesh=`` (``parallel.sharding.make_mesh``) the batch
  is split into one shard per data row of the mesh: each shard is planned
  on its device, every shard's plan launched before any output is
  gathered, the world bank replicated on each device, and every output
  gathered in one host copy.

Each dispatch runs eagerly: there is no ``jax.jit``.  Capturing the four
dispatch paths (cold or warm seed, inline SDF or bank row) as CUDA graphs is
ROADMAP.md Queue 1 item 6.

Unlike the JAX package, a served plan does not depend on the request's row:
the multistart adapter draws one set of perturbations per dispatch, shared
by every row, and one RRT* seed for every row; and the RRT* pool is built
from the same SDF the device plans against.  A cold task-space request is
seeded with the arm held at its start (``TaskSpacePlanningAdapter.
cold_seed``), not with a line toward its target's coordinates read as
joint angles.
"""
from __future__ import annotations

import asyncio
import contextlib
import copy
import dataclasses
import threading
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from dgpmp2_tpu_torch.core import gn, graph, multistart
from dgpmp2_tpu_torch.core import seeds as seeds_lib
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _straight_np(start, goal, spec, dtype):
    """Numpy twin of ``utils.trajectory.straight_line_traj`` for one (D,)
    start/goal pair, in ``dtype``: the seed of a row without ``th_init`` in
    a warm batch, built on the host."""
    s, g = start[: spec.dof], goal[: spec.dof]
    alpha = np.linspace(0.0, 1.0, spec.total_time_step + 1)[:, None]
    pos = s[None] * (1.0 - alpha) + g[None] * alpha
    vel = np.broadcast_to((g - s) / float(spec.total_time_sec), pos.shape)
    return np.concatenate([pos, vel], axis=-1).astype(dtype)


@dataclasses.dataclass
class PlanRequest:
    """One planning problem: (D,) start/goal states and an environment.

    The environment is an inline ``sdf`` array ((H, W), or (D, H, W) in 3-D)
    or the ``world`` name of an SDF registered with
    :meth:`PlanningService.register_world`, which stays on the device, so
    that the request carries no SDF.  ``th_init`` (T+1, D) seeds the
    optimiser (warm-start replanning); ``None`` seeds the straight line.
    """

    start: np.ndarray
    goal: np.ndarray
    sdf: Optional[np.ndarray] = None
    th_init: Optional[np.ndarray] = None
    world: Optional[str] = None


@dataclasses.dataclass
class PlanResponse:
    th: np.ndarray            # (T+1, D) optimised trajectory
    err_init: float
    err_final: float
    iters: int
    batch_fill: float         # share of the dispatched batch that was real
    latency_s: float          # submit -> result, queue wait included


class _AdapterResult(NamedTuple):
    """The serving fields of ``gn.PlanResult``."""
    th: torch.Tensor
    err_init: torch.Tensor
    err_final: torch.Tensor
    iters: torch.Tensor


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def _canonical(device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _device_context(device):
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _replica(planner, device: torch.device):
    """``planner`` on ``device``: itself when it is there already, else a
    shallow copy whose tensors, modules and wrapped planner (an adapter's
    ``lplanner``) are moved there."""
    if _canonical(planner.device) == device:
        return planner
    rep = copy.copy(planner)
    for name, value in vars(planner).items():
        if isinstance(value, torch.Tensor):
            setattr(rep, name, value.to(device))
        elif isinstance(value, torch.nn.Module):
            setattr(rep, name, copy.deepcopy(value).to(device))
        elif hasattr(value, "device") and hasattr(value, "spec"):
            setattr(rep, name, _replica(value, device))
    rep.device = device
    return rep


class LearnedPlanningAdapter:
    """Serve a ``LearnedDiffGPMP2Planner`` through :class:`PlanningService`,
    on the planner's device.

    The service's planner interface: ``plan(th0, start, goal, sdf)`` over a
    leading batch axis, plus ``spec``, ``dtype`` and ``device``.  Fixed
    GraphParams come from each batch's (start, goal) and the covariance
    scalars, and the encoder's occupancy image from the SDF's sign
    (occupied where ``sdf <= 0``), so requests stay (start, goal, sdf) as
    for the static service.
    """

    def __init__(self, lplanner, variables, cov_scalars: dict,
                 track_best: bool = True,
                 dtype: torch.dtype = torch.float32):
        self.lplanner = lplanner
        self.variables = variables
        self.cov = dict(cov_scalars)
        self.track_best = track_best
        self.spec = lplanner.spec
        self.dtype = dtype
        self.device = lplanner.device

    def plan(self, th0, start, goal, sdf):
        params = graph.default_params(
            self.spec, self.lplanner.robot, start, goal, **self.cov,
            dtype=self.dtype)
        im = (sdf > 0).to(self.dtype)
        th, errs, _, _ = self.lplanner.plan(
            self.variables, params, th0, sdf, im, track_best=self.track_best)
        n_iters = torch.full(th.shape[:1], errs.shape[0], dtype=torch.int32,
                             device=th.device)
        return _AdapterResult(th=th, err_init=errs[0], err_final=errs[-1],
                              iters=n_iters)


class MultistartPlanningAdapter:
    """Serve K-seed multistart planning (``core.multistart``) through
    :class:`PlanningService`: each request is planned from ``restarts``
    perturbed seeds and the best candidate returned.

    The perturbations are one (K, 1, 3, dof) standard-normal draw from a
    generator seeded with ``seed``, made once and shared by every row of
    every dispatch, so the same request gets the same plan at any row and on
    every dispatch.
    err_init/err_final are the weighted factor-graph error of the seed and
    of the selected candidate under the fixed covariances.

    ``rrt_seeds > 0`` appends that many RRT* seed trajectories per problem to
    the pool (``core.seeds.rrt_seed_batch``, the native planner on the
    host): seed k of every row is searched with the RRT* seed
    ``seed + 7919·k``, whatever the row.  ``rrt_clearance`` defaults to the
    robot's largest sphere radius; ``rrt_plan_time`` is the per-problem
    budget in seconds (host wall clock, sequential over the batch).  The
    search stops at ``rrt_max_iters`` or ``rrt_plan_time``, whichever comes
    first; it replays exactly only when the iteration cap binds first.
    """

    def __init__(self, spec, robot, cov_scalars: dict,
                 optim_cfg: Optional[gn.OptimConfig] = None,
                 restarts: int = 16, amp: float = 1.5, prune_iters: int = 0,
                 keep: int = 0, seed: int = 0, select_margin: float = 0.0,
                 rrt_seeds: int = 0, rrt_plan_time: float = 1.0,
                 rrt_max_iters: int = 20000,
                 rrt_clearance: Optional[float] = None,
                 dtype: torch.dtype = torch.float32, device=None):
        if rrt_seeds > 0 and spec.z_lims is not None:
            raise ValueError("rrt_seeds: the native RRT* expert is 2-D; "
                             "3-D workspaces are not supported")
        self.spec = spec
        self.robot = robot
        self.cov = dict(cov_scalars)
        self.cfg = optim_cfg or gn.OptimConfig(reg=0.1, max_iters=50)
        self.restarts = restarts
        self.amp = amp
        self.prune_iters = prune_iters
        self.keep = keep
        # Selection margin (m): candidate selection aligned with
        # margin-based quality metrics (core.multistart.score_candidates).
        self.select_margin = select_margin
        self.rrt_seeds = rrt_seeds
        self.rrt_plan_time = rrt_plan_time
        self.rrt_max_iters = rrt_max_iters
        if rrt_clearance is None:
            rrt_clearance = float(np.max(np.asarray(robot.sphere_radii,
                                                    np.float32)))
        self.rrt_clearance = rrt_clearance
        self.seed = seed
        self.dtype = dtype
        self.device = _device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.normals = torch.randn((restarts, 1, 3, spec.dof), generator=gen,
                                   dtype=dtype, device=self.device)

    def _error(self, params, th, sdf):
        res = graph.eval_residuals(self.spec, self.robot, params, th, sdf)
        return graph.error_from_residuals(self.spec, params, res)

    def host_extra_seeds(self, start, goal, sdf) -> np.ndarray:
        """The RRT* seed pool of one dispatch on the host: numpy (B, D)
        starts and goals and (B, H, W) SDFs -> (B, rrt_seeds, T+1, 2·dof).
        Seed k of every row comes from RRT* seed ``seed + 7919·k``, so a
        row's pool does not depend on its place in the batch."""
        pool = [
            seeds_lib.rrt_seed_batch(
                sdf, start, goal, self.spec.x_lims, self.spec.y_lims,
                self.spec.total_time_sec, self.spec.num_traj_states,
                clearance=self.rrt_clearance, plan_time=self.rrt_plan_time,
                max_iters=self.rrt_max_iters, seed=self.seed + 7919 * k)[0]
            for k in range(self.rrt_seeds)
        ]
        return np.stack(pool, axis=1)

    def plan(self, th0, start, goal, sdf, extra_seeds=None):
        """``extra_seeds``: the optional (B, E, T+1, 2·dof) informed-seed
        pool (:meth:`host_extra_seeds`'s).  Without it and with
        ``rrt_seeds > 0`` the pool is searched here from the tensors'
        host copies."""
        params = graph.default_params(self.spec, self.robot, start, goal,
                                      **self.cov, dtype=self.dtype)
        if extra_seeds is None and self.rrt_seeds > 0:
            extra_seeds = self.host_extra_seeds(
                *(x.detach().cpu().numpy() for x in (start, goal, sdf)))
        extra = None
        if extra_seeds is not None:
            # (B, E, T+1, D) -> plan_multistart's (E, B, T+1, D)
            extra = torch.as_tensor(extra_seeds, dtype=self.dtype,
                                    device=th0.device).transpose(0, 1)
        res = multistart.plan_multistart(
            self.spec, self.robot, params, th0, sdf, self.cfg, None,
            restarts=self.restarts, amp=self.amp,
            prune_iters=self.prune_iters, keep=self.keep,
            select_margin=self.select_margin, extra_seeds=extra,
            normals=self.normals)
        return _AdapterResult(
            th=res.th, err_init=self._error(params, th0, sdf),
            err_final=self._error(params, res.th, sdf),
            iters=res.iters)  # the winning candidate's GN iterations


class TaskSpacePlanningAdapter:
    """Serve workspace end-effector goals (``GraphSpec.use_workspace_goal``)
    through :class:`PlanningService` with the unchanged request schema: the
    request's ``goal`` carries the workspace target in its first
    ``wksp_dim`` components (the rest is ignored), the joint-space goal
    prior is nearly off (``k_goal_off``), and the planner solves the implied
    IK inside the same GN iteration.

    ``cov_scalars`` must hold ``k_wg`` (the workspace-goal weight);
    ``k_jl``/``q_min``/``q_max`` and ``k_self``/``eps_self`` engage the
    joint-limit and self-collision factors where the spec enables them.

    A request without ``th_init`` is seeded by :meth:`cold_seed`, the arm
    held at its start: the straight line toward ``goal[:dof]`` would head
    for the target's coordinates read as joint angles.
    """

    def __init__(self, spec, robot, cov_scalars: dict,
                 optim_cfg: Optional[gn.OptimConfig] = None,
                 k_goal_off: float = 100.0,
                 dtype: torch.dtype = torch.float32, device=None):
        if not spec.use_workspace_goal:
            raise ValueError("spec must enable use_workspace_goal")
        self.spec = spec
        self.robot = robot
        self.cov = dict(cov_scalars)
        self.cfg = optim_cfg or gn.OptimConfig(reg=0.1, max_iters=50)
        self.k_goal_off = k_goal_off
        self.dtype = dtype
        self.device = _device(device)

    def cold_seed(self, start, goal):
        """The seed of a request without ``th_init``: the straight line
        from ``start[:dof]`` to ``start[:dof]`` (``goal`` carries the
        workspace target, no joint angles)."""
        s = start[..., :self.spec.dof]
        return straight_line_traj(s, s, self.spec.total_time_sec,
                                  self.spec.total_time_step)

    def plan(self, th0, start, goal, sdf):
        cov = dict(self.cov)
        k_wg = cov.pop("k_wg")
        cov.pop("k_g", None)  # the joint goal prior gives way to k_goal_off
        params = graph.default_params(
            self.spec, self.robot, start, start, **cov, k_g=self.k_goal_off,
            k_wg=k_wg, workspace_goal=goal[..., :self.robot.wksp_dim],
            dtype=self.dtype)
        # No track_best: its best iterate (contact-free, lowest GP error)
        # presumes goal-anchored iterates; under a task-space goal the
        # unmoved seed would win.  The converged iterate is returned.
        res = gn.plan(self.spec, self.robot, params, th0, sdf, self.cfg)
        return _AdapterResult(th=res.th, err_init=res.err_init,
                              err_final=res.err_final, iters=res.iters)


class PlanningService:
    """Micro-batching front end over a batched planner.

    Args:
      planner: a ``DiffGPMP2Planner`` or an adapter of this module (any
        object with ``plan(th_init, start, goal, sdf)`` over a leading batch
        axis, returning ``th``, ``err_init``, ``err_final`` and ``iters``,
        and ``spec``, ``dtype`` and ``device`` attributes; an optional
        ``cold_seed(start, goal)`` seeds the rows without ``th_init``).
      batch_size: the dispatched batch width; also the coalescing target.
      window_ms: the longest the dispatcher waits after the first request
        of a batch before it dispatches a partial one.
      mesh: a ``parallel.sharding.Mesh``: each dispatch plans one shard of
        ``batch_size / (data rows)`` rows on each data row's first device
        (a replica of the planner there).  ``batch_size`` must divide by
        the mesh's size.
    """

    def __init__(self, planner, batch_size: int = 64,
                 window_ms: float = 2.0, mesh=None):
        self.planner = planner
        self.batch_size = int(batch_size)
        self.window_s = float(window_ms) / 1e3
        if mesh is None:
            devices = [_canonical(planner.device)]
        else:
            if self.batch_size % mesh.size:
                raise ValueError(
                    f"batch_size {self.batch_size} not divisible by mesh "
                    f"size {mesh.size}")
            devices = [_canonical(d) for d in mesh.data_devices()]
        # One (device, planner) per shard; the shards of one device share
        # its planner replica and its bank.
        replicas = {}
        for d in devices:
            replicas.setdefault(d, _replica(planner, d))
        self._shards = [(d, replicas[d]) for d in devices]
        self.device = devices[0]
        self._np_dtype = _NP_DTYPES[planner.dtype]
        # A planner whose seed pool needs host work (the RRT* expert of
        # MultistartPlanningAdapter) exposes host_extra_seeds; the service
        # runs it before each dispatch and hands the pool to plan().
        self._host_seeds = (
            getattr(planner, "host_extra_seeds", None)
            if getattr(planner, "rrt_seeds", 0) else None)
        self._queue: Optional[asyncio.Queue] = None
        self._task: Optional[asyncio.Task] = None
        self._lock = threading.Lock()  # dispatches are serialised
        self._world_index: dict = {}   # name -> row of the device bank
        self._world_np: dict = {}      # name -> host copy, for host seeds
        self._banks: dict = {}         # device -> (n, H, W) or (n, D, H, W)
        self.stats = {
            "requests": 0,
            "batches": 0,
            "padded_rows": 0,
            "device_time_s": 0.0,
            "host_seed_time_s": 0.0,
        }

    # -- the world bank ------------------------------------------------------

    def register_world(self, name: str, sdf) -> None:
        """Upload one environment SDF to every device of the service once;
        requests then name it as ``PlanRequest(world=name)`` and carry no
        SDF.  Re-registering a name replaces its row in place."""
        host = np.array(sdf, self._np_dtype)  # a copy: the caller's
        # array may change later, and on the CPU a tensor would share it
        with self._lock:
            if self._host_seeds is not None:
                # The RRT* expert reads this copy, not the device row.
                self._world_np[name] = host
            for dev in {d for d, _ in self._shards}:
                row = torch.tensor(host, device=dev)
                bank = self._banks.get(dev)
                if name in self._world_index:
                    bank[self._world_index[name]].copy_(row)
                elif bank is None:
                    self._banks[dev] = row[None].contiguous()
                else:
                    self._banks[dev] = torch.cat([bank, row[None]])
            if name not in self._world_index:
                self._world_index[name] = len(self._world_index)

    def _upload(self, x, device) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, self._np_dtype), device=device)

    def _resolve_sdfs(self, requests, device, bank_mode) -> torch.Tensor:
        """The (rows, H, W) or (rows, D, H, W) SDFs of ``requests`` (one
        shard's rows, pad rows included) on ``device``: a bank gather in
        bank mode (every request of the dispatch names a registered world),
        else one upload of the inline arrays (a named world's row read back
        from the bank where a request has no inline SDF)."""
        if bank_mode:
            try:
                idx = [self._world_index[r.world] for r in requests]
            except KeyError as exc:
                raise KeyError(f"unregistered world {exc}") from exc
            return self._banks[device].index_select(
                0, torch.tensor(idx, device=device))
        rows = []
        for r in requests:
            if r.sdf is not None:
                rows.append(np.asarray(r.sdf))
            elif r.world in self._world_index:
                rows.append(self._banks[device][self._world_index[r.world]]
                            .cpu().numpy())
            else:
                raise ValueError(
                    "request carries neither sdf nor a registered world")
        return self._upload(np.stack(rows), device)

    def _host_sdf(self, request, bank_mode: bool) -> np.ndarray:
        """The SDF the host seed expert plans a request in: the one the
        device plans it in (:meth:`_resolve_sdfs`), the registered world in
        bank mode, else the inline SDF."""
        if not bank_mode and request.sdf is not None:
            return np.asarray(request.sdf)
        if request.world in self._world_np:
            return self._world_np[request.world]
        raise ValueError("request carries neither sdf nor a registered world")

    def _cold_seed(self, planner, start, goal):
        """Seeds of rows without ``th_init``: the planner's ``cold_seed``
        where it has one, else the straight line to the goal state."""
        cold = getattr(planner, "cold_seed", None)
        if cold is not None:
            return cold(start, goal)
        spec = planner.spec
        return straight_line_traj(start[..., :spec.dof], goal[..., :spec.dof],
                                  spec.total_time_sec, spec.total_time_step)

    def _dispatch(self, start, goal, th0, sdfs, extra):
        """One dispatch: every shard's plan launched on its device (the
        seeds of a cold batch made there), then every output gathered in
        one host copy.  ``sdfs(k, device)`` gives shard ``k``'s SDFs on its
        device.  Returns numpy (th, err_init, err_final, iters)."""
        dt = self.planner.dtype
        rows = self.batch_size // len(self._shards)
        outs = []
        for k, (dev, planner) in enumerate(self._shards):
            sl = slice(k * rows, (k + 1) * rows)
            with _device_context(dev):
                st, gl = self._upload(start[sl], dev), self._upload(goal[sl],
                                                                    dev)
                th = (self._cold_seed(planner, st, gl) if th0 is None
                      else self._upload(th0[sl], dev))
                if extra is None:
                    res = planner.plan(th, st, gl, sdfs(k, dev))
                else:
                    res = planner.plan(th, st, gl, sdfs(k, dev),
                                       extra_seeds=self._upload(extra[sl],
                                                                dev))
                # Iterations are exact in the planner's dtype.
                outs.append(torch.cat([
                    res.th.reshape(rows, -1), res.err_init[:, None],
                    res.err_final[:, None], res.iters[:, None].to(dt)],
                    dim=1))
        # One device-to-host copy for every output of every shard.
        out = torch.cat([o.to(self.device) for o in outs]).cpu().numpy()
        th = out[:, :-3].reshape(self.batch_size, *res.th.shape[1:])
        return th, out[:, -3], out[:, -2], out[:, -1].astype(np.int64)

    # -- synchronous path ----------------------------------------------------

    def warmup(self, sdf_shape: Optional[tuple] = None) -> None:
        """Plan one batch ahead of traffic, so that the first dispatch does
        not pay for the kernels' build (``nvcc`` at first launch) and their
        launch plans at this batch width.  On the card it plans twice, so
        that ``core.gn.plan`` captures its CUDA graph here (a key's second
        plan) and a dispatch of the same shapes replays it.  Plans against
        the world bank when worlds are registered and no ``sdf_shape`` is
        given, else against ones of ``sdf_shape``.  Counts nothing in
        ``stats``."""
        spec = self.planner.spec
        b, d = self.batch_size, spec.state_dim
        rows = b // len(self._shards)
        start = np.zeros((b, d))
        goal = np.ones((b, d))
        extra = None
        if self._host_seeds is not None:
            # A pool of the right shape; the warm-up plan is discarded.
            extra = np.zeros((b, int(self.planner.rrt_seeds),
                              spec.num_traj_states, d))
        if sdf_shape is None and self._banks.get(self.device) is None:
            raise ValueError("no registered worlds: pass sdf_shape")

        def sdfs(k, dev):
            if sdf_shape is None:
                return self._banks[dev].index_select(
                    0, torch.zeros(rows, dtype=torch.int64, device=dev))
            return self._upload(np.ones((rows,) + tuple(sdf_shape)), dev)

        passes = 2 if any(d.type == "cuda" for d, _ in self._shards) else 1
        with self._lock, torch.no_grad():
            for _ in range(passes):
                self._dispatch(start, goal, None, sdfs, extra)

    def plan_batch_sync(self, requests: Sequence[PlanRequest]):
        """Plan up to ``batch_size`` requests in one dispatch and return
        their ``PlanResponse``s (``latency_s`` is the dispatch's time)."""
        n = len(requests)
        if n == 0:
            return []
        if n > self.batch_size:
            raise ValueError(f"{n} requests > batch width {self.batch_size}")
        pad = self.batch_size - n
        padded = list(requests) + [requests[0]] * pad

        def stack(rows):
            return np.stack(rows + [rows[0]] * pad)

        start = stack([np.asarray(r.start) for r in requests])
        goal = stack([np.asarray(r.goal) for r in requests])
        bank_mode = self._banks.get(self.device) is not None and all(
            r.world in self._world_index for r in requests)
        th0 = None
        if any(r.th_init is not None for r in requests):
            # Rows without a seed get the cold seed, built on the host.
            th0 = stack([
                np.asarray(r.th_init) if r.th_init is not None
                else self._cold_seed_np(r) for r in requests])

        # The host seed expert (RRT*) before the dispatch, on the real rows
        # only (pad rows copy row 0's pool), in the SDFs the device plans;
        # one pool for the whole batch, split with it.
        extra = None
        if self._host_seeds is not None:
            t_h = time.perf_counter()
            extra = self._host_seeds(
                start[:n], goal[:n],
                np.stack([self._host_sdf(r, bank_mode) for r in requests]))
            extra = np.concatenate([extra] + [extra[:1]] * pad)
            self.stats["host_seed_time_s"] += time.perf_counter() - t_h

        rows = self.batch_size // len(self._shards)
        gather = all(r.world is not None for r in requests)

        def sdfs(k, dev):
            return self._resolve_sdfs(padded[k * rows:(k + 1) * rows], dev,
                                      gather)

        t0 = time.perf_counter()
        # The dispatch may run in an executor thread, whose grad mode is its
        # own (each shard also enters its CUDA device there).
        with self._lock, torch.no_grad():
            th, err0, errf, n_iters = self._dispatch(start, goal, th0, sdfs,
                                                     extra)
        dt_dev = time.perf_counter() - t0

        self.stats["requests"] += n
        self.stats["batches"] += 1
        self.stats["padded_rows"] += pad
        self.stats["device_time_s"] += dt_dev

        fill = n / self.batch_size
        return [
            PlanResponse(th=th[i], err_init=float(err0[i]),
                         err_final=float(errf[i]), iters=int(n_iters[i]),
                         batch_fill=fill, latency_s=dt_dev)
            for i in range(n)
        ]

    def _cold_seed_np(self, request) -> np.ndarray:
        """The cold seed of one request of a warm batch, on the host: the
        planner's ``cold_seed`` on the CPU, else the straight line to the
        goal state (``_straight_np``), in the planner's dtype."""
        start, goal = np.asarray(request.start), np.asarray(request.goal)
        cold = getattr(self.planner, "cold_seed", None)
        if cold is None:
            return _straight_np(start, goal, self.planner.spec,
                                self._np_dtype)
        return cold(torch.as_tensor(start)[None], torch.as_tensor(goal)[None]
                    )[0].numpy().astype(self._np_dtype)

    # -- async micro-batching path ------------------------------------------

    async def start(self) -> None:
        """Start the dispatcher on the running event loop."""
        if self._task is not None:
            raise RuntimeError("service already started")
        self._queue = asyncio.Queue()
        self._task = asyncio.ensure_future(self._dispatch_loop())

    async def stop(self) -> None:
        """Cancel the dispatcher at once; requests still queued (not yet
        dispatched) never resolve, so call it after the in-flight
        ``submit()``s have returned."""
        if self._task is None:
            return
        self._task.cancel()
        try:
            await self._task
        except asyncio.CancelledError:
            pass
        self._task = None
        self._queue = None

    async def submit(self, request: PlanRequest) -> PlanResponse:
        """Queue one request; resolves when its batch returns."""
        if self._queue is None:
            raise RuntimeError("service not started")
        fut = asyncio.get_running_loop().create_future()
        await self._queue.put((request, fut, time.perf_counter()))
        return await fut

    async def _dispatch_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            first = await self._queue.get()
            batch = [first]
            deadline = loop.time() + self.window_s
            while len(batch) < self.batch_size:
                timeout = deadline - loop.time()
                if timeout <= 0:
                    break
                try:
                    batch.append(
                        await asyncio.wait_for(self._queue.get(), timeout))
                except asyncio.TimeoutError:
                    break
            requests = [b[0] for b in batch]
            try:
                responses = await loop.run_in_executor(
                    None, self.plan_batch_sync, requests)
            except Exception as exc:  # every waiter of the batch gets it
                for _, fut, _ in batch:
                    if not fut.done():
                        fut.set_exception(exc)
                continue
            now = time.perf_counter()
            for (_, fut, t_submit), resp in zip(batch, responses):
                resp.latency_s = now - t_submit
                if not fut.done():
                    fut.set_result(resp)
