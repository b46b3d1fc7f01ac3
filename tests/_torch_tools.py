"""Shared helpers of the tests that hold dgpmp2_tpu_torch.tools (the port's
campaign and sweep tools) against the JAX package (``test_torch_tools_*``).

The JAX tools hard-code float32, so the float64 side of a comparison is
built here from the JAX package's own functions, following the tool's code
line by line; the port's functions run on the CPU in float64.  A JAX tool
module is imported only for its constants and pure-numpy helpers
(:func:`jax_tool`), by path, with its compilation-cache side effect pointed
at a temporary directory and undone, and ``sys.path`` left as it was.
Multistart perturbations: the port's draws are replaced by JAX's normals of
the keys the JAX tool would use (:func:`jax_normals`).
"""
from __future__ import annotations

import atexit
import contextlib
import importlib.util
import os
import shutil
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

from dgpmp2_tpu.core import gn as jgn
from dgpmp2_tpu.core import graph as jgraph
from dgpmp2_tpu.learn import learned_planner as jlp
from dgpmp2_tpu.learn.eval import evaluate_batch as j_evaluate
from dgpmp2_tpu.learn.eval import summarize as j_summarize
from dgpmp2_tpu.utils.trajectory import straight_line_traj as j_straight
from dgpmp2_tpu_torch import convert
from dgpmp2_tpu_torch.core import gn as tgn
from dgpmp2_tpu_torch.core import graph as tgraph
from dgpmp2_tpu_torch.core import multistart as tms
from dgpmp2_tpu_torch.data import generate as tgen
from dgpmp2_tpu_torch.robots import PointRobot2D

ROOT = Path(__file__).resolve().parents[1]
F64 = torch.float64
ARGS = ["--device", "cpu", "--dtype", "float64"]
TOL = 1e-8
RATES = ("solve_rate", "contact_free_rate", "avg_in_coll", "avg_in_contact")
_TMP = tempfile.mkdtemp(prefix="dgpmp2_torch_tools_")
atexit.register(shutil.rmtree, _TMP, ignore_errors=True)
_JAX_TOOLS = {}


def jax_tool(name: str):
    """The JAX package's ``tools/<name>.py``, loaded by path (once): its
    sibling imports resolved against ``tools/`` while it loads, the
    compilation cache it sets pointed at a temporary directory, then the
    cache setting, the environment and ``sys.path`` restored."""
    if name not in _JAX_TOOLS:
        prev_dir = jax.config.jax_compilation_cache_dir
        prev_env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
        prev_path = list(sys.path)
        os.environ["JAX_COMPILATION_CACHE_DIR"] = _TMP
        sys.path.insert(0, str(ROOT / "tools"))
        try:
            spec = importlib.util.spec_from_file_location(
                f"_jax_tools_{name}", ROOT / "tools" / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        finally:
            sys.path[:] = prev_path
            if prev_env is None:
                os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
            else:
                os.environ["JAX_COMPILATION_CACHE_DIR"] = prev_env
            jax.config.update("jax_compilation_cache_dir", prev_dir)
        _JAX_TOOLS[name] = mod
    return _JAX_TOOLS[name]


@contextlib.contextmanager
def jax_normals(keys):
    """The port's multistart perturbations (``core.multistart.
    perturbed_inits``, read by ``plan_multistart`` and the learned
    planner's) drawn as JAX draws them from each key of ``keys`` in turn
    (an iterator of ``jax.random`` keys, one per call)."""
    orig = tms.perturbed_inits
    keys = iter(keys)

    def perturbed(th0, generator, restarts, amp, total_time_sec,
                  harmonics=3):
        b, _, sd = th0.shape
        z = jax.random.normal(next(keys), (restarts, b, harmonics, sd // 2),
                              jnp.float64)
        return tms.inits_from_normals(th0, torch.tensor(np.asarray(z)), amp,
                                      total_time_sec)

    tms.perturbed_inits = perturbed
    try:
        yield
    finally:
        tms.perturbed_inits = orig


def fold_keys(seed, n):
    """``fold_in(PRNGKey(seed), i)`` for i < n: the JAX sweeps' batch
    keys."""
    return [jax.random.fold_in(jax.random.PRNGKey(seed), i) for i in range(n)]


def np_(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np_(got), np_(want), rtol=tol, atol=tol,
                               err_msg=what)


def same_summary(got: dict, want: dict, what=""):
    """Two summaries: the same keys, rates equal exactly, every continuous
    metric within :data:`TOL`."""
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        if isinstance(w, dict):
            same_summary(got[k], w, f"{what}/{k}")
        elif isinstance(w, str) or k in RATES or k == "sigma":
            assert got[k] == w, (what, k, got[k], w)
        else:
            close(got[k], w, what=f"{what}/{k}")


def j_batches(batches):
    """Port batches (float64 tensors) as jnp arrays."""
    return [{k: jnp.asarray(np_(v)) for k, v in b.items()
             if isinstance(v, torch.Tensor)} for b in batches]


def j_line(spec, b):
    return j_straight(b["start"][:, :spec.dof], b["goal"][:, :spec.dof],
                      spec.total_time_sec, spec.total_time_step)


def j_params(spec, robot, b, cov):
    return jgraph.default_params(spec, robot, b["start"], b["goal"], **cov,
                                 dtype=jnp.float64)


def j_merged(all_m):
    return j_summarize({k: np.concatenate([np.asarray(m[k]) for m in all_m])
                        for k in all_m[0]})


def j_static_rows(spec, robot, batches, sigmas, cov, method="gauss_newton",
                  th0_fn=None, iters=50):
    """The JAX side of a static sweep: per sigma, each batch planned from
    the straight seed (or ``th0_fn(b)``) with ``track_best`` (``iters``
    iterations), judged under the canonical ``cov``."""
    cfg = jgn.OptimConfig(reg=0.1, max_iters=iters, method=method)
    plan = jax.jit(lambda p, th0, s: jgn.plan(spec, robot, p, th0, s, cfg,
                                              track_best=True).best_th)
    rows = {}
    for sigma in sigmas:
        all_m = []
        for b in batches:
            th0 = j_line(spec, b) if th0_fn is None else th0_fn(b)
            th = plan(j_params(spec, robot, b, dict(cov, cost_sigma=sigma)),
                      th0, b["sdf"])
            all_m.append(j_evaluate(spec, robot,
                                    j_params(spec, robot, b, cov), th,
                                    b["th_opt"], b["sdf"]))
        rows[float(sigma)] = j_merged(all_m)
    return rows


def port_split(out, rng, family, n, probs=2, t=8, iters=10, im=32):
    """A split written by the port's generator on the CPU (LM labels)."""
    tgen.generate_split(
        str(out), n, probs, family, im, rng,
        tgraph.GraphSpec(total_time_step=t),
        PointRobot2D(),
        tgn.OptimConfig(reg=0.1, max_iters=iters, method="lm"),
        dict(qc_inv=np.eye(2), cost_sigma=0.05, epsilon_dist=0.4, k_s=0.01,
             k_g=0.01), device="cpu")


def campaign_data(root: Path, families=("multi_obs", "forest"), train=4,
                  test=2, probs=2, t=8, im=32):
    """``root/data_<family>/{train,test}`` as ``learned_campaign.gen_data``
    lays them out, at a small size (``im``², T=``t``), from the tool's
    numpy seeds; returns the roots."""
    roots = []
    for fi, fam in enumerate(families):
        r = root / f"data_{fam}"
        rng = np.random.default_rng(1000 * (fi + 1))
        port_split(r / "train", rng, fam, train, probs, t, im=im)
        port_split(r / "test", rng, fam, test, probs, t, im=im)
        roots.append(str(r))
    return roots


def learned_weights(planner_j, stack_j, th_j, seed=11):
    """Random weights about the static initialisation, as a flax tree of
    numpy arrays (``convert.seeded_flax_tree``)."""
    shapes = jax.tree.map(lambda a: list(np.shape(a)),
                          planner_j.init_variables(jax.random.PRNGKey(0),
                                                   stack_j, th_j))
    bias = planner_j.static_out_bias(*planner_j.learn_cfg.static_init)
    return convert.seeded_flax_tree(shapes, seed,
                                    convert.learned_out_path(shapes), bias)


def j_learned_planner(spec, robot, lkw, method="gauss_newton", iters=50):
    """The JAX twin of a tool's learned planner, float64."""
    return jlp.LearnedDiffGPMP2Planner(
        spec, robot, jgn.OptimConfig(reg=0.1, max_iters=iters,
                                     method=method),
        jlp.LearnedPlannerConfig(**lkw, dtype=jnp.float64))


def yaml_of(path):
    return yaml.safe_load(Path(path).read_text())
