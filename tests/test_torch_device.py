"""Where the port's planners put their tensors: on the card unless the
caller asks for the CPU, with no fallback; and ``device="cpu"`` still plans
as the JAX package does (float64, B=3, T=16, 32x32 worlds, 1e-8)."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgpmp2_tpu.ops import sdf as jsdf
from dgpmp2_tpu.planner import DiffGPMP2Planner as JPlanner
from dgpmp2_tpu.planner import GPMP2Planner as JGPMP2Planner
from dgpmp2_tpu.robots import make_robot as j_make_robot
from dgpmp2_tpu_torch import convert
from dgpmp2_tpu_torch.planner import DiffGPMP2Planner, GPMP2Planner
from dgpmp2_tpu_torch.robots import make_robot
from dgpmp2_tpu_torch.utils import config as tconfig
from dgpmp2_tpu_torch.utils import mat_utils

from _torch_parity import F64, np_, world

torch.set_num_threads(1)
CONFIGS = Path(__file__).resolve().parents[1] / "dgpmp2_tpu" / "configs"
B, T = 3, 16


def yamls():
    """(planner_params at T=16, gp, obs, optim, robot data, limits) of the
    2-D YAMLs."""
    env, pp, gp, obs, opt, rd = tconfig.load_params(
        CONFIGS / "gpmp2_2d_params.yaml", CONFIGS / "robot_2d.yaml",
        CONFIGS / "env_2d_params.yaml")
    lims = {"x_lims": env["x_lims"], "y_lims": env["y_lims"]}
    return dict(pp, total_time_step=T), gp, obs, opt, rd, lims


def problem(seed=0):
    """(th0, start, goal, sdf) numpy inputs: straight-line seeds."""
    imgs, start, goal = world(seed, B, 32)
    sdf = np.asarray(jsdf.sdf_from_occupancy(jnp.asarray(imgs), res=10 / 32))
    alpha = np.linspace(0.0, 1.0, T + 1)[None, :, None]
    pos = start[:, None, :2] * (1 - alpha) + goal[:, None, :2] * alpha
    vel = np.broadcast_to(((goal - start)[:, :2] / 10.0)[:, None], pos.shape)
    return np.concatenate([pos, vel], -1), start, goal, sdf


def make_planner(cls, **kw):
    pp, gp, obs, opt, rd, lims = yamls()
    if cls is DiffGPMP2Planner:
        return cls(gp, obs, pp, opt, lims, make_robot(rd), dtype=F64, **kw)
    return cls(gp, obs, pp, lims, make_robot(rd), **kw)


@pytest.mark.parametrize("cls", [DiffGPMP2Planner, GPMP2Planner])
def test_planners_default_to_the_card(cls):
    """Built without ``device``, a planner holds ``cuda``; where no card is
    visible, making its params raises instead of falling back to the CPU."""
    planner = make_planner(cls)
    assert planner.device == torch.device("cuda")
    _, start, goal, _ = problem()
    diff = planner if cls is DiffGPMP2Planner else planner._diff
    if torch.cuda.is_available():
        assert diff.make_params(start, goal).q_inv.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            diff.make_params(start, goal)


def test_isotropic_matrix_defaults_to_the_card():
    if torch.cuda.is_available():
        assert mat_utils.isotropic_matrix(2.0, 3).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            mat_utils.isotropic_matrix(2.0, 3)
    got = mat_utils.isotropic_matrix(2.0, 3, F64, "cpu")
    assert got.device == torch.device("cpu")
    np.testing.assert_array_equal(np_(got), 2.0 * np.eye(3))


def test_cpu_diff_planner_plans_like_jax():
    """``DiffGPMP2Planner(..., device="cpu").plan`` against the JAX planner
    from the same YAMLs."""
    pp, gp, obs, opt, rd, lims = yamls()
    planner = make_planner(DiffGPMP2Planner, device="cpu")
    j_planner = JPlanner(gp, obs, pp, opt, lims, j_make_robot(rd),
                         dtype=jnp.float64)
    args = problem(1)
    out = planner.plan(*args)
    assert out.th.device == torch.device("cpu")
    got = convert.plan_result_to_numpy(out)
    want = j_planner.plan(*args)
    for name in ("th", "err_init", "err_final", "err_per_iter"):
        np.testing.assert_allclose(got[name], np_(getattr(want, name)),
                                   rtol=1e-8, atol=1e-8, err_msg=name)
    assert (got["err_final"] < got["err_init"]).all()


def test_cpu_classic_planner_plans_like_jax():
    """``GPMP2Planner(..., device="cpu").plan_batch`` (LM, float64) against
    the JAX planner."""
    pp, gp, obs, _, rd, lims = yamls()
    planner = make_planner(GPMP2Planner, device="cpu")
    th0, start, goal, sdf = problem(2)
    optim = {"method": "lm", "max_iters": 8, "tol_delta": 1e-3}
    got = planner.plan_batch(start, goal, th0, sdf, optim)
    want = JGPMP2Planner(gp, obs, pp, lims, j_make_robot(rd)).plan_batch(
        start, goal, th0, sdf, optim)
    assert got[0].device == torch.device("cpu")
    np.testing.assert_allclose(np_(got[0]), np_(want[0]), rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_array_equal(got[4], want[4])
