"""dgpmp2_tpu_torch robots against dgpmp2_tpu: FK and its Jacobian, the
self-collision pair rule and make_robot for every robot YAML of the repo.

Float64 on the CPU; inputs made with numpy from a seed.  Tolerance 1e-12:
the same closed forms, rounding differences only.
"""
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dgpmp2_tpu import robots as jr
from dgpmp2_tpu_torch import robots as tr

from _torch_parity import F64, np_

torch.set_num_threads(1)
TOL = 1e-12
CONFIGS = Path(__file__).resolve().parents[1] / "dgpmp2_tpu" / "configs"

ROBOTS = {
    "xyh": ("PointRobotXYH", dict(sphere_radii=(0.3,))),
    "arm2": ("PlanarArm2Link", dict()),
    "arm2_yaml": ("PlanarArm2Link", dict(link_lengths=(2.5, 2.0),
                                         spheres_per_link=3,
                                         sphere_radii=(0.25,) * 6)),
    "arm2_offset": ("PlanarArm2Link", dict(link_lengths=(1.5, 1.0),
                                           base_xy=(0.5, -1.0),
                                           spheres_per_link=2,
                                           sphere_radii=(0.2,))),
    "arm3": ("PlanarArmNLink", dict(link_lengths=(1.8, 1.4, 1.2),
                                    spheres_per_link=2,
                                    sphere_radii=(0.25,))),
    "arm4": ("PlanarArmNLink", dict(link_lengths=(1.0, 0.9, 0.8, 0.7),
                                    base_xy=(-0.3, 0.2), spheres_per_link=1,
                                    sphere_radii=(0.2, 0.2, 0.15, 0.1))),
    "arm2_nlink": ("PlanarArmNLink", dict(link_lengths=(2.5, 2.0),
                                          spheres_per_link=3)),
}


def both(name):
    cls, kw = ROBOTS[name]
    return getattr(jr, cls)(**kw), getattr(tr, cls)(**kw)


@pytest.mark.parametrize("name", sorted(ROBOTS))
def test_fk_and_jacobian_match_jax(name):
    j_robot, t_robot = both(name)
    assert dataclasses.asdict(j_robot) == dataclasses.asdict(t_robot)
    th = np.random.default_rng(len(name)).uniform(
        -3.0, 3.0, (3, 5, t_robot.state_dim))
    c_t, jac_t = t_robot.fk(torch.tensor(th))
    c_j, jac_j = j_robot.fk(jnp.asarray(th))
    assert c_t.shape == c_j.shape and jac_t.shape == jac_j.shape
    np.testing.assert_allclose(np_(c_t), np_(c_j), atol=TOL)
    np.testing.assert_allclose(np_(jac_t), np_(jac_j), atol=TOL)
    np.testing.assert_allclose(
        np_(t_robot.radii_array(F64, "cpu")),
        np_(j_robot.radii_array(jnp.float64)), atol=0)


@pytest.mark.parametrize("name", ["arm2_offset", "arm4"])
def test_fk_jacobian_is_the_derivative_of_fk(name):
    """The analytic Jacobian against autograd of the port's own FK."""
    _, robot = both(name)
    th = torch.tensor(np.random.default_rng(3).uniform(
        -2.0, 2.0, robot.state_dim))
    auto = torch.autograd.functional.jacobian(lambda x: robot.fk(x)[0], th)
    np.testing.assert_allclose(np_(robot.fk(th)[1]), np_(auto), atol=TOL)


def test_fk_constants_are_made_once_per_device_and_dtype():
    _, robot = both("arm3")
    th = torch.zeros((2, 6), dtype=F64)
    robot.fk(th)
    before = tr._const.cache_info().misses
    robot.fk(th + 1.0)
    assert tr._const.cache_info().misses == before
    assert robot.radii_array(F64, "cpu") is robot.radii_array(F64, "cpu")


@pytest.mark.parametrize("name,eps,slack", [
    ("arm2", 0.05, 0.02), ("arm2_yaml", 0.05, 0.02), ("arm3", 0.05, 0.02),
    ("arm3", 0.5, 0.1), ("arm4", 0.0, 0.0), ("arm2_offset", 0.05, 0.02),
])
def test_self_collision_pairs_match_jax(name, eps, slack):
    j_robot, t_robot = both(name)
    got = tr.self_collision_pairs(t_robot, eps_self=eps, slack=slack)
    assert got == jr.self_collision_pairs(j_robot, eps_self=eps, slack=slack)
    assert all(isinstance(i, int) for pair in got for i in pair)


def test_self_collision_pairs_refuse_point_robots():
    for robot in (tr.PointRobot2D(), tr.PointRobotXYH()):
        with pytest.raises(ValueError, match="chain geometry"):
            tr.self_collision_pairs(robot)


def _robot_yamls():
    return sorted(p.name for p in CONFIGS.glob("robot_*.yaml"))


@pytest.mark.parametrize("fname", _robot_yamls())
def test_make_robot_matches_jax_for_every_robot_yaml(fname):
    data = yaml.safe_load((CONFIGS / fname).read_text())
    got, want = tr.make_robot(data), jr.make_robot(data)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if hasattr(got, "link_lengths"):
        assert tr.self_collision_pairs(got) == jr.self_collision_pairs(want)


@pytest.mark.parametrize("data", [
    {"type": "planar_arm_2link", "sphere_radius": [0.3]},
    {"type": "planar_arm", "link_lengths": [1.0, 1.0, 1.0, 1.0],
     "spheres_per_link": 3, "base_xy": [1.0, 0.0]},
    {"type": "point_robot_xyh", "sphere_radius": [0.5]},
    {"type": "point_robot_3d"},
    {"dof": 3},
    {"type": "unknown_kind", "dof": 2},
])
def test_make_robot_builds_all_five_types_like_jax(data):
    got, want = tr.make_robot(data), jr.make_robot(data)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
