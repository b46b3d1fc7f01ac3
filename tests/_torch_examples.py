"""Shared helpers of the tests that run dgpmp2_tpu_torch.examples and hold
them against the JAX package (``test_torch_examples.py``,
``test_torch_examples_robots.py``, ``test_torch_examples_data.py``).

Each example runs once per test process through its ``main`` on the CPU
in float64 (:func:`run`); the JAX side is built from the JAX package's own
functions and configurations, fed the port's numpy inputs.
"""
import atexit
import contextlib
import importlib
import io
import shutil
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dgpmp2_tpu import robots as jr
from dgpmp2_tpu.core import gn as jgn
from dgpmp2_tpu.core import graph as jg
from dgpmp2_tpu.planner import DiffGPMP2Planner as JDiffPlanner
from dgpmp2_tpu.utils.config import load_params as j_load_params
from dgpmp2_tpu.utils.trajectory import straight_line_traj as j_line
from dgpmp2_tpu_torch.core import multistart as tms
from dgpmp2_tpu_torch.examples import _common

ROOT = Path(__file__).resolve().parents[1]
CFG = ROOT / "dgpmp2_tpu" / "configs"
ARGS = ["--device", "cpu", "--dtype", "float64"]
TOL = 1e-8
_RUNS = {}
_TMP = tempfile.mkdtemp(prefix="dgpmp2_torch_examples_")
atexit.register(shutil.rmtree, _TMP, ignore_errors=True)


def module(name):
    return importlib.import_module(f"dgpmp2_tpu_torch.examples.{name}")


@contextlib.contextmanager
def jax_normals():
    """The port's multistart perturbations from JAX's ``PRNGKey(0)``, as
    ``dgpmp2_tpu.core.multistart.perturbed_inits`` draws them."""
    orig = tms.perturbed_inits

    def perturbed(th0, generator, restarts, amp, total_time_sec,
                  harmonics=3):
        b, _, sd = th0.shape
        z = jax.random.normal(jax.random.PRNGKey(0),
                              (restarts, b, harmonics, sd // 2), jnp.float64)
        return tms.inits_from_normals(th0, torch.tensor(np.asarray(z)), amp,
                                      total_time_sec)

    tms.perturbed_inits = perturbed
    try:
        yield
    finally:
        tms.perturbed_inits = orig


def run(name, *extra):
    """The example's result at its default sizes with ``--plot`` (its
    figures under a temporary directory, :func:`out_dir`), computed once
    per ``extra`` flags."""
    key = (name,) + extra
    if key not in _RUNS:
        ctx = (jax_normals() if name in ("multistart_example",
                                         "plan3d_example")
               else contextlib.nullcontext())
        orig = _common.OUT_DIR
        _common.OUT_DIR = out_dir(name)
        try:
            with ctx, contextlib.redirect_stdout(io.StringIO()):
                _RUNS[key] = module(name).main(ARGS + ["--plot", *extra])
        finally:
            _common.OUT_DIR = orig
    return _RUNS[key]


def out_dir(name) -> Path:
    """Where :func:`run` has the example write its figures."""
    return Path(_TMP) / name


def np_(x):
    return _common.np_(x)


def close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np_(got), np_(want), rtol=tol, atol=tol,
                               err_msg=what)


def leaves(out):
    if isinstance(out, dict):
        return [x for v in out.values() for x in leaves(v)]
    if isinstance(out, (list, tuple)):
        return [x for v in out for x in leaves(v)]
    return [out]


def check_plans(name, out=None):
    """Finite numbers out, every problem's error lowered (a warm plan held
    below its baseline's seed error, ``_common.unimproved``) and a figure
    written."""
    out = run(name) if out is None else out
    for x in leaves(out):
        if isinstance(x, (torch.Tensor, np.ndarray, float)):
            assert np.isfinite(np_(x)).all(), name
    assert _common.error_pairs(out), name
    assert _common.unimproved(out, getattr(module(name), "BASELINE",
                                           None)) == []
    assert list(out_dir(name).glob("*.png")), name


def j_configs(plan_yaml="gpmp2_2d_params.yaml"):
    return j_load_params(CFG / plan_yaml, CFG / "robot_2d.yaml",
                         CFG / "env_2d_params.yaml")


def env_of(env):
    return {"x_lims": env["x_lims"], "y_lims": env["y_lims"]}


def box_sdf():
    return np_(_common.box_world("cpu", torch.float64)[1])


def j_diff_planner(pp=None, gp=None, obs=None, plan_yaml=None, robot=None):
    env, pp0, gp0, obs0, opt, robot_data = j_configs(
        plan_yaml or "gpmp2_2d_params.yaml")
    return JDiffPlanner(gp or gp0, obs or obs0, pp or pp0, opt, env_of(env),
                        robot or jr.make_robot(robot_data),
                        dtype=jnp.float64), pp or pp0


def j_line_of(start, goal, pp, dof=2):
    return j_line(jnp.asarray(start)[:, :dof], jnp.asarray(goal)[:, :dof],
                  pp["total_time_sec"], pp["total_time_step"])


def j_arm(arm):
    """The JAX twin of a port arm."""
    if type(arm).__name__ == "PlanarArm2Link":
        return jr.PlanarArm2Link(link_lengths=arm.link_lengths,
                                 spheres_per_link=arm.spheres_per_link,
                                 sphere_radii=arm.sphere_radii)
    return jr.PlanarArmNLink(link_lengths=arm.link_lengths,
                             spheres_per_link=arm.spheres_per_link,
                             sphere_radii=arm.sphere_radii)


def j_spec(spec):
    return jg.GraphSpec(**{f: getattr(spec, f)
                           for f in spec.__dataclass_fields__})


def j_params(params):
    return jg.GraphParams(**{
        f: None if getattr(params, f) is None
        else jnp.asarray(np_(getattr(params, f)))
        for f in params.__dataclass_fields__})


def j_plan(spec, robot, params, th0, sdf, cfg, **kw):
    """``dgpmp2_tpu.core.gn.plan`` of a port problem, jitted."""
    jcfg = jgn.OptimConfig(engine="standard", method=cfg.method,
                           reg=cfg.reg, max_iters=cfg.max_iters,
                           tol_err=cfg.tol_err, tol_delta=cfg.tol_delta)
    jspec, jrobot = j_spec(spec), j_arm(robot)
    return jax.jit(lambda p, t, s: jgn.plan(jspec, jrobot, p, t, s, jcfg,
                                            **kw))(
        j_params(params), jnp.asarray(np_(th0)), jnp.asarray(np_(sdf)))


def count_plain_launches(monkeypatch):
    """Route CPU tensors through the kernel wrappers of ``ops/cuda``, each
    launch running the kernel's plain version and counting as the kernel
    would, so that ``chip_smoke.run_example`` can hold an example's launch
    formula on the CPU; ``monkeypatch`` restores the counters after."""
    from dgpmp2_tpu_torch.ops import sdf as sdf_ops
    from dgpmp2_tpu_torch.ops import tridiag
    from dgpmp2_tpu_torch.ops.cuda import _tiles, btd_solve, sdf_lookup
    from dgpmp2_tpu_torch.ops.cuda import sdf_lookup3d, sdf_lookup_bwd

    plain = {2: sdf_ops.bilinear_lookup, 3: sdf_ops.trilinear_lookup}

    def solve(diag, off, rhs):
        btd_solve.launches += 1
        # The regime the kernel would take where its rows fit shared memory.
        regime = btd_solve.team(rhs.shape[-1], 1 << 30)[0]
        btd_solve.regime_launches[regime] += 1
        with torch.no_grad():
            return tridiag.btd_solve_factored(tridiag.btd_factor(diag, off),
                                              off, rhs)

    def lookup(name, sdf, points, res, lims, oob_mode):
        with torch.no_grad():
            return plain[len(lims)](sdf, points, res, *lims, oob_mode)

    def backward(sdf, points, d_bar, g_bar, res, lims,
                 oob_mode="intended", sdf_grad=True):
        sdf_lookup_bwd.launches += 1
        with torch.enable_grad():
            s = sdf.detach().requires_grad_(sdf_grad)
            p = points.detach().requires_grad_(True)
            d, g = plain[len(lims)](s, p, res, *lims, oob_mode)
            grads = torch.autograd.grad((d, g), (p, s) if sdf_grad else (p,),
                                        (d_bar, g_bar), allow_unused=True)
        p_bar = torch.zeros_like(points) if grads[0] is None else grads[0]
        if not sdf_grad:
            return p_bar, None
        return p_bar, torch.zeros_like(sdf) if grads[1] is None else grads[1]

    from dgpmp2_tpu_torch.ops.cuda import sdf_lookup_limbs

    # The counters come back to their values at teardown, for the tests
    # that follow in the same process.
    for m in (btd_solve, sdf_lookup, sdf_lookup3d, sdf_lookup_bwd,
              sdf_lookup_limbs):
        monkeypatch.setattr(m, "launches", m.launches)
    monkeypatch.setattr(sdf_lookup_limbs, "splits", sdf_lookup_limbs.splits)
    monkeypatch.setattr(btd_solve, "regime_launches",
                        dict(btd_solve.regime_launches))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(btd_solve, "launch", solve)
    monkeypatch.setattr(btd_solve, "_ready", lambda a: a.contiguous())
    monkeypatch.setattr(tridiag, "btd_solve", btd_solve.btd_solve_cuda)
    monkeypatch.setattr(_tiles, "launch", lookup)
    monkeypatch.setattr(sdf_lookup_bwd, "launch", backward)
    monkeypatch.setattr(
        sdf_ops, "bilinear_lookup",
        lambda sdf, pts, res, xl, yl, oob_mode=None:
        sdf_lookup.bilinear_lookup_cuda(sdf, pts, res, xl, yl,
                                        oob_mode or "intended"))
    monkeypatch.setattr(
        sdf_ops, "trilinear_lookup",
        lambda sdf, pts, res, xl, yl, zl, oob_mode=None:
        sdf_lookup3d.trilinear_lookup_cuda(sdf, pts, res, xl, yl, zl,
                                           oob_mode or "intended"))
