"""Gauss-Newton / Levenberg-Marquardt engine over the block factor graph.

Port of ``dgpmp2_tpu/core/gn.py``.  :func:`gn_step` is one damped GN update;
:func:`plan` runs a fixed iteration budget as a Python loop of masked
``torch.where`` updates (the JAX package's ``lax.scan``), with per-problem
convergence freezing, so no iteration waits for the host.  The whole plan is
differentiable through the unrolled iterations.  ``err`` (the convergence
metric) is detached; ``err_ext`` (fixed external covariances) carries
gradients.

Three linear-system engines (``OptimConfig.engine``): the standard one,
assembly in ``core/graph.py`` and the solve in ``ops/tridiag.btd_solve_auto``
(the K-BTD kernel for CUDA tensors); the stream engine (``core/stream.py``),
assembly and solve in one kernel, K-STREAM; and df32 (``core/df32.py``),
float32 residuals with a float64 assembly and solve.

On the card :func:`plan` replays a CUDA graph of its whole loop where the
inputs allow it: every tensor input on one CUDA device, nothing for
autograd to record (grad mode off, or no input requiring grad), no capture
already under way, and the same key (:func:`_graph_key`: the spec, the
robot, the shapes, strides and dtypes, the engine, the ``OptimConfig``,
``track_best``, which fields of the params are ``None``, the device and
the generation of the process-wide settings, ``utils.settings``) seen once
before.  The first plan of a key runs eagerly and warms up the kernels;
the second copies its inputs into static buffers, captures the loop on
them and replays it; each later one copies its inputs in, replays, and
returns clones of the outputs, so a result survives the next call.  The
graphs of one device share one memory pool, which holds the largest
graph's intermediates and every graph's outputs, and so run one at a time:
a call, on any stream, waits for the last call's clones on its device
before its inputs are copied in.  The :data:`GRAPH_CACHE` graphs used
last are kept; an evicted key is forgotten, and its next plan runs
eagerly as a first sighting.  Every other plan runs the eager loop.  Either way the loop
never reads a device value on the host, so a replay computes what the
eager loop computes, bit for bit.  :data:`graph_counts` counts the plans
by path (``eager``, ``captures``, ``replays``) and the graphs evicted.
The kernel wrappers' launch counters count the eager loop's launches
alone; the kernels the replays ran are summed in :data:`graph_launches`,
by counter of ``utils.profiling.counters``.  ``LearnedDiffGPMP2Planner.
plan`` runs its loop by the same rules through the same machinery
(:func:`graph_key`, :func:`run_loop`): one cache, one pool and one event a
device, and one set of counters for both loops.

:func:`plan` opens the profiler spans of ``utils.profiling``: ``dgpmp2.plan``
(its ``graph`` argument names the path) and, in the eager loop, its stages;
they cost one flag check when no profiler runs.  A replay opens
``dgpmp2.plan`` alone.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import NamedTuple, Optional

import torch

from dgpmp2_tpu_torch.core import graph as graph_lib
from dgpmp2_tpu_torch.ops import tridiag
from dgpmp2_tpu_torch.utils import profiling, settings
from dgpmp2_tpu_torch.utils.profiling import annotate
from dgpmp2_tpu_torch.utils.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Optimizer options (``optim_params`` YAML)."""

    method: str = "gauss_newton"  # or "lm"
    reg: float = 0.1
    max_iters: int = 100
    tol_err: float = 1e-3
    tol_delta: float = 1e-4
    conv_check_dtheta: bool = True
    conv_check_err: bool = False
    lm_lambda_init: float = 1e-4
    # Linear-system engine inside :func:`plan`:
    #   "auto"     - the standard engine, on every device (see resolve_engine).
    #   "standard" - assembly (core/graph.py) + damping + K-BTD solve.
    #   "stream"   - assembly, damping and solve in one K-STREAM launch per
    #                iteration (core/stream.py); its plain version on the CPU.
    #   "df32"     - float32 residuals, float64 assembly and solve
    #                (core/df32.py): steps of float64 quality in a float32
    #                plan; refuses float64 plans, GP interpolation and the
    #                workspace goal.
    engine: str = "auto"


ENGINES = ("auto", "standard", "stream", "df32")


def resolve_engine(engine: str, dtype: torch.dtype | None = None) -> str:
    """Map ``engine`` to a concrete engine; unknown names raise.

    ``auto`` is the standard engine on every device and dtype.  The JAX
    package picks the stream engine on its TPU; which engine the card should
    pick is left to a measurement of both at a benchmark cell.  ``dtype`` is
    taken for the JAX signature and does not change the answer.
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    return "standard" if engine == "auto" else engine


class PlanResult(NamedTuple):
    th: torch.Tensor  # (B, T+1, D) final trajectories
    err_init: torch.Tensor  # (B,)
    err_final: torch.Tensor  # (B,)
    err_per_iter: torch.Tensor  # (iters, B) weighted error trace
    err_ext_per_iter: torch.Tensor  # (iters, B) external error trace
    iters: torch.Tensor  # (B,) iterations actually used per problem
    # Best non-colliding trajectory by GP-MSE seen along the optimisation;
    # equals `th` where none was non-colliding (track_best only).
    best_th: Optional[torch.Tensor] = None
    best_valid: Optional[torch.Tensor] = None  # (B,) bool


def damped_system(diag, off, rhs, delta, trust_region: bool = False):
    """GN damping ``+δI`` or LM trust-region ``+δ·diag(Λ)``; ``delta`` is a
    scalar or a (B,) per-problem value."""
    d = diag.shape[-1]
    delta = torch.as_tensor(delta, dtype=diag.dtype, device=diag.device)
    while delta.ndim < diag.ndim - 2:
        delta = delta[..., None]
    scale = delta[..., None, None]
    eye = torch.eye(d, dtype=diag.dtype, device=diag.device)
    damp = scale * (eye * diag) if trust_region else scale * eye
    return diag + damp, off, rhs


def gn_step(spec: graph_lib.GraphSpec, robot, params: graph_lib.GraphParams,
            th: torch.Tensor, sdf: torch.Tensor, delta,
            trust_region: bool = False) -> torch.Tensor:
    """One Gauss-Newton update ``dθ = (AᵀKA + δI)⁻¹ AᵀKb`` in block form."""
    diag, off, rhs = graph_lib.assemble(spec, robot, params, th, sdf)
    diag, off, rhs = damped_system(diag, off, rhs, delta, trust_region)
    return tridiag.btd_solve_auto(diag, off, rhs)


def _converged(dth, err_delta, cfg: OptimConfig):
    """Per-problem convergence test."""
    b = dth.shape[0]
    conv = torch.zeros((b,), dtype=torch.bool, device=dth.device)
    if cfg.conv_check_dtheta:
        conv = conv | (torch.linalg.vector_norm(dth.reshape(b, -1), dim=-1)
                       < cfg.tol_delta)
    if cfg.conv_check_err:
        conv = conv | (err_delta.abs() < cfg.tol_err)
    return conv


def _best_score(res: graph_lib.FactorResiduals) -> torch.Tensor:
    """GP-MSE if the interior is collision-free, else +inf.  Collision
    covers the GP-interpolated checks and self-collision where enabled."""
    colliding = torch.any((res.r_obs[..., 1:-1, :] > 0).flatten(-2), dim=-1)
    if res.r_obsi is not None:
        colliding = colliding | torch.any((res.r_obsi > 0).flatten(-3), dim=-1)
    if res.r_self is not None:
        colliding = colliding | torch.any(
            (res.r_self[..., 1:-1, :] > 0).flatten(-2), dim=-1)
    gp_mse = torch.mean(torch.sum(res.r_gp**2, dim=-1), dim=-1)
    return torch.where(colliding, torch.full_like(gp_mse, float("inf")),
                       gp_mse)


def plan(spec: graph_lib.GraphSpec, robot, params: graph_lib.GraphParams,
         th_init: torch.Tensor, sdf: torch.Tensor, cfg: OptimConfig,
         params_fix: Optional[graph_lib.GraphParams] = None,
         track_best: bool = False) -> PlanResult:
    """Batched plan: ``cfg.max_iters`` GN/LM steps with convergence freeze.

    LM keeps one lambda per problem (accepted steps divide it by 10, rejected
    steps multiply it by 10).  ``params_fix`` supplies the fixed external
    covariances of the ``err_ext`` trace; it defaults to ``params``.  The JAX
    package's ``unroll`` (a ``lax.scan`` option) has no counterpart in a
    Python loop and is not taken.  On the card a plan whose key was seen
    before replays a CUDA graph of the loop (see the module docstring).
    """
    engine = _engine(cfg, th_init)
    if params_fix is None:
        params_fix = params
    key = _graph_key(spec, robot, params, params_fix, th_init, sdf, cfg,
                     track_best, engine)
    return _run_plan(key, spec, robot, params, params_fix, th_init, sdf, cfg,
                     track_best, engine)


def _engine(cfg: OptimConfig, th_init: torch.Tensor) -> str:
    """The resolved engine; refuses an unknown method and a float64 df32."""
    if cfg.method not in ("gauss_newton", "lm"):
        raise ValueError(
            f"unknown method {cfg.method!r}; expected 'gauss_newton' or 'lm'"
        )
    engine = resolve_engine(cfg.engine, th_init.dtype)
    if engine == "df32" and th_init.dtype != torch.float32:
        raise ValueError("engine='df32' is a float32 accuracy mode; use the "
                         "standard engine for float64 runs")
    return engine


def _span(th_init, engine, cfg, graph):
    b, t1, d = th_init.shape
    return annotate("dgpmp2.plan", {"B": b, "T+1": t1, "D": d,
                                    "dtype": th_init.dtype, "engine": engine,
                                    "method": cfg.method,
                                    "max_iters": cfg.max_iters,
                                    "graph": graph})


def _eager_plan(spec, robot, params, th_init, sdf, cfg, params_fix=None,
                track_best=False) -> PlanResult:
    """:func:`plan` as the eager loop, whatever its inputs: the stage spans
    open, and no graph is captured or replayed."""
    engine = _engine(cfg, th_init)
    return _run_plan(None, spec, robot, params,
                     params if params_fix is None else params_fix, th_init,
                     sdf, cfg, track_best, engine)


def _run_plan(key, spec, robot, params, params_fix, th_init, sdf, cfg,
              track_best, engine) -> PlanResult:
    """:func:`plan`'s loop by :func:`run_loop`'s rules under ``key``."""
    args = (params, params_fix, th_init, sdf)

    def make_run():
        reg = torch.tensor(cfg.reg, dtype=th_init.dtype,
                           device=th_init.device)

        def run(params, params_fix, th_init, sdf):
            return _plan(spec, robot, params, th_init, sdf, cfg, params_fix,
                         track_best, engine, reg)

        return run, (reg,)

    return run_loop(key, lambda: args, make_run,
                    lambda path: _span(th_init, engine, cfg, path))


# -- the captured plan ------------------------------------------------------

# Captured plans kept, the ones used last: the most keys one caller cycles
# through, a PlanningService over a mesh of four cards with staged
# multistart (two phases a shard); a plain planner makes one key a batch
# shape, multistart two.
GRAPH_CACHE = 8
_SEEN = 64  # keys of eager plans remembered, the ones used last
_GRAPH_DEVICE = "cuda"  # the device type whose plans are captured
_graphs: "collections.OrderedDict[tuple, _CapturedPlan]" = \
    collections.OrderedDict()
_seen: "collections.OrderedDict[tuple, None]" = collections.OrderedDict()
_lock = threading.Lock()
# By device: the memory pool its captured plans share, and an event
# recorded after the last replay's clones.
_pools: dict = {}
_done: dict = {}
# Plans by path (each plan adds one to eager, captures or replays) and the
# graphs evicted.
graph_counts = dict.fromkeys(("eager", "captures", "replays", "evictions"),
                             0)
# Kernels the replays ran, by counter of utils.profiling.counters.
graph_launches: "collections.Counter[str]" = collections.Counter()


def _settings() -> tuple:
    """The process-wide settings that change what a plan launches."""
    return (settings.generation, graph_lib.BROADCAST_MAX,
            torch.backends.cuda.matmul.allow_tf32,
            torch.is_inference_mode_enabled())


def _compact(x: torch.Tensor) -> torch.Tensor:
    """``x`` with each broadcast dimension (stride 0) cut to one element."""
    for dim, (size, stride) in enumerate(zip(x.shape, x.stride())):
        if stride == 0 and size > 1:
            x = x.narrow(dim, 0, 1)
    return x


def _overlaps(x: torch.Tensor) -> bool:
    """Whether two elements of ``x`` share memory."""
    need = 1
    for stride, size in sorted((st, n) for n, st in zip(x.shape, x.stride())
                               if n > 1):
        if stride < need:
            return True
        need += stride * (size - 1)
    return False


def _inputs(args) -> tuple:
    """The distinct tensors of ``args`` and, for each tensor leaf, the index
    of its distinct tensor."""
    index: dict = {}
    tensors = []
    pattern = []
    for x in leaves(args):
        if id(x) not in index:
            index[id(x)] = len(tensors)
            tensors.append(x)
        pattern.append(index[id(x)])
    return tensors, tuple(pattern)


def graph_key(batch: torch.Tensor, args, static) -> Optional[tuple]:
    """What a captured loop depends on: ``static`` (hashable: its options),
    and the device, the shapes, strides and dtypes of the distinct tensors
    of ``args`` (its inputs, a pytree) and how its leaves alias them, and
    the process-wide settings; or ``None`` where the loop runs eagerly: an
    input off the card or on another device, an input autograd would
    record, a capture under way, an empty ``batch``, or an input whose
    memory overlaps itself."""
    tensors, pattern = _inputs(args)
    dev = batch.device
    if dev.type != _GRAPH_DEVICE or batch.numel() == 0:
        return None
    if any(x.device != dev for x in tensors):
        return None
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        return None
    if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
        return None
    if any(_overlaps(_compact(x)) for x in tensors):
        return None
    shapes = tuple((tuple(x.shape), x.stride(), x.dtype) for x in tensors)
    try:
        key = (static, dev, shapes, pattern, _settings())
        hash(key)
    except TypeError:  # a robot or spec that cannot be a key
        return None
    return key


def nones(*params: graph_lib.GraphParams) -> tuple:
    """The fields of each GraphParams that are ``None``."""
    return tuple(tuple(f.name for f in dataclasses.fields(p)
                       if getattr(p, f.name) is None) for p in params)


def _graph_key(spec, robot, params, params_fix, th_init, sdf, cfg,
               track_best, engine):
    """What :func:`plan`'s captured loop depends on (:func:`graph_key`)."""
    return graph_key(th_init, (params, params_fix, th_init, sdf),
                     (spec, robot, cfg, track_best, engine,
                      nones(params, params_fix)))


class _CapturedPlan:
    """One plan's loop captured in a ``torch.cuda.CUDAGraph`` on static
    copies of its inputs (each broadcast input kept broadcast, every stride
    as given), and the kernels one replay launches, by counter
    (``utils.profiling.capture``)."""

    def __init__(self, args, tensors, run, consts=()):
        self.device = tensors[0].device
        self.consts = consts  # tensors the graph reads, made before capture
        self.bases = []
        static = {}
        for x in tensors:
            c = _compact(x)
            base = torch.empty_strided(c.shape, c.stride(), dtype=c.dtype,
                                       device=c.device)
            base.copy_(c)
            self.bases.append(base)
            static[id(x)] = base.expand(x.shape)
        self.args = tree_map(lambda x: static[id(x)], args)
        self.out, self.launches = profiling.capture(
            lambda: run(*self.args), self._capturing())

    @contextlib.contextmanager
    def _capturing(self):
        self.graph = torch.cuda.CUDAGraph()
        pool = _pools.setdefault(self.device, torch.cuda.graph_pool_handle())
        with torch.cuda.device(self.device), torch.cuda.graph(
                self.graph, pool=pool, capture_error_mode="thread_local"):
            yield

    @contextlib.contextmanager
    def _ordered(self):
        """The block on the device's current stream, after the last call's
        clones on the device: a replay writes the memory that another
        graph's outputs, or its own, occupy until they are cloned."""
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream()
            done = _done.setdefault(self.device, torch.cuda.Event())
            stream.wait_event(done)
            yield
            done.record(stream)

    def _replay(self):
        self.graph.replay()

    def reset(self):
        """Free the graph and its memory pool."""
        self.graph.reset()

    def __call__(self, tensors):
        """Replay on ``tensors`` (the inputs' distinct tensors, in the
        captured order): clones of the outputs."""
        with self._ordered():
            for base, x in zip(self.bases, tensors):
                base.copy_(_compact(x))
            self._replay()
            out = tree_map(torch.clone, self.out)
        graph_launches.update(self.launches)
        return out


def run_loop(key, inputs, make_run, span):
    """A plan's loop by the captured-loop rules (the module docstring),
    which :func:`plan` and ``LearnedDiffGPMP2Planner.plan`` share.

    ``inputs()`` gives the loop's inputs, a pytree of tensors; what it runs
    (the learned planner's encoder) runs eagerly on every path.
    ``make_run()`` gives ``(run, consts)``: ``run(*inputs)`` is the loop,
    and ``consts`` the tensors it reads that are made before a capture.
    ``span(path)`` opens the plan's span, its ``graph`` argument ``path``.
    ``key`` (:func:`graph_key`; ``None``: eager) decides the path: a key's
    first plan runs eagerly, its second captures, later ones replay."""
    if key is None or (key not in _graphs and key not in _seen):
        with _lock:
            graph_counts["eager"] += 1
        with span("eager"):
            run, _ = make_run()
            out = run(*inputs())
        if key is not None:
            with _lock:
                _seen[key] = None
                _seen.move_to_end(key)
                while len(_seen) > _SEEN:
                    _seen.popitem(last=False)
        return out
    with _lock:
        entry = _graphs.get(key)
        with span("replay" if entry else "capture"):
            args = inputs()
            tensors, _ = _inputs(args)
            if entry is None:
                run, consts = make_run()
                entry = _CapturedPlan(args, tensors, run, consts)
                _seen.pop(key, None)
                _graphs[key] = entry
                while len(_graphs) > GRAPH_CACHE:
                    _, old = _graphs.popitem(last=False)
                    old.reset()
                    graph_counts["evictions"] += 1
                graph_counts["captures"] += 1
            else:
                graph_counts["replays"] += 1
            _graphs.move_to_end(key)
            return entry(tensors)


def _reset_graphs() -> None:
    """Drop every graph and key kept, and zero :data:`graph_counts` and
    :data:`graph_launches`."""
    with _lock:
        for entry in _graphs.values():
            entry.reset()
        _graphs.clear()
        _seen.clear()
        _pools.clear()
        _done.clear()
        for k in graph_counts:
            graph_counts[k] = 0
        graph_launches.clear()


def _plan(spec, robot, params, th_init, sdf, cfg, params_fix, track_best,
          engine, reg) -> PlanResult:
    """The body of :func:`plan`, its stages in their spans; ``reg`` is
    ``cfg.reg`` as a 0-d tensor of the plan's dtype on its device, made by
    the caller (a capture refuses the copy from the host)."""
    # The lookup kernels read a contiguous SDF batch; made so once here, a
    # strided one (as sdf_from_occupancy returns) is not copied per lookup.
    sdf = sdf.contiguous()
    b = th_init.shape[0]
    dtype, dev = th_init.dtype, th_init.device
    lm = cfg.method == "lm"

    def residuals(th):
        return graph_lib.eval_residuals(spec, robot, params, th, sdf)

    def weighted_err(res):
        return graph_lib.error_from_residuals(spec, params, res).detach()

    def ext_err(res):
        return graph_lib.error_from_residuals(
            spec, params, res, q_inv=params_fix.q_inv,
            obs_inv=params_fix.obs_inv,
        )

    # One factor-graph evaluation per iteration feeds assembly and both
    # error traces; the GP/prior Gauss blocks are built once.
    with annotate("dgpmp2.residuals"):
        res = residuals(th_init)
    with annotate("dgpmp2.errors"):
        err0 = weighted_err(res)
        if track_best:
            best_s = _best_score(res).detach()
    static = graph_lib.assemble_static(spec, params, dtype)
    if engine in ("stream", "df32"):
        from dgpmp2_tpu_torch.core import df32 as df32_lib
        from dgpmp2_tpu_torch.core import stream as stream_lib

        # The per-plan blocks once, GN's scalar damping folded in (LM's is
        # per problem and per iteration); df32 holds them in float64 (its
        # CPU step, the plain float64 solve, does not read them).
        ss = stream_lib.build_stream_static(
            spec, params, static if engine == "stream" else None, b,
            dtype if engine == "stream" else torch.float64,
            reg=0.0 if lm else cfg.reg)
    th, err_old = th_init, err0
    conv = torch.zeros((b,), dtype=torch.bool, device=dev)
    lam = torch.full((b,), cfg.lm_lambda_init, dtype=dtype, device=dev)
    iters = torch.zeros((b,), dtype=torch.int32, device=dev)
    if track_best:
        best_th = th_init
    errs, errs_ext = [], []
    for _ in range(cfg.max_iters):
        delta = lam if lm else reg
        if engine == "stream":
            with annotate("dgpmp2.solve"):
                dth = stream_lib.stream_step(spec, params, ss, res, delta,
                                             trust_region=lm)
        elif engine == "df32":
            with annotate("dgpmp2.solve"):
                # GN's damping as the float64 value of cfg.reg, as in ss.
                dth = df32_lib.df32_step_from_residuals(
                    spec, params, res, lam if lm else cfg.reg,
                    trust_region=lm, ss=ss)
        else:
            with annotate("dgpmp2.assemble"):
                diag, off, rhs = graph_lib.assemble_from_residuals(
                    spec, params, res, dtype=dtype, static=static)
                diag, off, rhs = damped_system(diag, off, rhs, delta,
                                               trust_region=lm)
            with annotate("dgpmp2.solve"):
                dth = tridiag.btd_solve_auto(diag, off, rhs)
        with annotate("dgpmp2.residuals"):
            th_prop = th + dth
            res_prop = residuals(th_prop)
        with annotate("dgpmp2.errors"):
            err_prop = weighted_err(res_prop)
        with annotate("dgpmp2.update"):
            accept = (err_prop < err_old) if lm else torch.ones_like(conv)
            take = accept & ~conv
            th = torch.where(take[:, None, None], th_prop, th)
            res = graph_lib.select(take, res_prop, res)
            err_next = torch.where(take, err_prop, err_old)
            if lm:
                lam = torch.where(conv, lam,
                                  torch.where(accept, lam / 10.0, lam * 10.0))
            trigger = _converged(dth, err_next - err_old, cfg)
            if lm:
                # A rejected proposal is not convergence: LM raises lambda
                # and retries instead.
                trigger = trigger & accept
            iters = iters + (~conv).to(torch.int32)
            conv = conv | trigger
            err_old = err_next
            errs.append(err_next)
        with annotate("dgpmp2.errors"):
            errs_ext.append(ext_err(res))
            if track_best:
                s = _best_score(res).detach()
        if track_best:
            with annotate("dgpmp2.update"):
                better = s < best_s
                best_th = torch.where(better[:, None, None], th, best_th)
                best_s = torch.minimum(s, best_s)
    best_valid = None
    if track_best:
        best_valid = torch.isfinite(best_s)
        best_th = torch.where(best_valid[:, None, None], best_th, th)
    else:
        best_th = None

    def trace(xs):
        return (torch.stack(xs) if xs
                else torch.zeros((0, b), dtype=dtype, device=dev))

    return PlanResult(th=th, err_init=err0, err_final=err_old,
                      err_per_iter=trace(errs),
                      err_ext_per_iter=trace(errs_ext), iters=iters,
                      best_th=best_th, best_valid=best_valid)
