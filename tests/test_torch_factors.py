"""dgpmp2_tpu_torch factors, robot and trajectory seeds against dgpmp2_tpu.

Float64 on the CPU; every input is made with numpy from a seed.  Tolerance
1e-12: the same closed forms in the same order, rounding differences only.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgpmp2_tpu.core import factors as jf
from dgpmp2_tpu.robots import PointRobot2D as JPointRobot2D
from dgpmp2_tpu.robots import make_robot as j_make_robot
from dgpmp2_tpu.utils.trajectory import straight_line_traj as j_straight

from dgpmp2_tpu_torch.core import factors as tf
from dgpmp2_tpu_torch.robots import PointRobot2D, make_robot
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj

from _torch_parity import F64, np_

torch.set_num_threads(1)
TOL = 1e-12


def test_gp_phi_and_q_inv():
    rng = np.random.default_rng(0)
    qc = rng.standard_normal((3, 5, 2, 2))
    np.testing.assert_allclose(np_(tf.gp_q_inv(torch.tensor(qc), 0.1)),
                               np_(jf.gp_q_inv(jnp.asarray(qc), 0.1)),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(np_(tf.gp_phi(2, 0.1, F64, "cpu")),
                               np_(jf.gp_phi(2, 0.1, jnp.float64)), atol=TOL)


def test_gp_and_prior_residuals():
    rng = np.random.default_rng(1)
    th = rng.standard_normal((3, 11, 4))
    mean = rng.standard_normal((3, 4))
    np.testing.assert_allclose(np_(tf.gp_residual(torch.tensor(th), dt=0.1)),
                               np_(jf.gp_residual(jnp.asarray(th), dt=0.1)),
                               atol=TOL)
    phi = tf.gp_phi(2, 0.1, F64, "cpu")
    np.testing.assert_allclose(np_(tf.gp_residual(torch.tensor(th), phi=phi)),
                               np_(jf.gp_residual(jnp.asarray(th), dt=0.1)),
                               atol=TOL)
    np.testing.assert_allclose(
        np_(tf.prior_residual(torch.tensor(mean), torch.tensor(th[:, 0]))),
        np_(jf.prior_residual(jnp.asarray(mean), jnp.asarray(th[:, 0]))),
        atol=TOL)


def test_point_robot_fk():
    th = np.random.default_rng(2).standard_normal((3, 7, 4))
    c_t, j_t = PointRobot2D().fk(torch.tensor(th))
    c_j, j_j = JPointRobot2D().fk(jnp.asarray(th))
    np.testing.assert_allclose(np_(c_t), np_(c_j), atol=TOL)
    np.testing.assert_allclose(np_(j_t), np_(j_j), atol=TOL)
    assert j_t.dtype == F64


def test_hinge_from_lookup():
    rng = np.random.default_rng(3)
    d = rng.uniform(-0.5, 1.5, (4, 9, 1))
    grad = rng.standard_normal((4, 9, 1, 2))
    jac = np.broadcast_to(np.eye(2, 4), (4, 9, 1, 2, 4))
    eps = np.full((4, 9, 1), 0.4)
    radii = np.array([0.4])
    r_t, h_t = tf.hinge_from_lookup(*(torch.tensor(np.ascontiguousarray(a))
                                      for a in (d, grad, jac, radii, eps)))
    r_j, h_j = jf.hinge_from_lookup(*(jnp.asarray(a)
                                      for a in (d, grad, jac, radii, eps)))
    np.testing.assert_allclose(np_(r_t), np_(r_j), atol=TOL)
    np.testing.assert_allclose(np_(h_t), np_(h_j), atol=TOL)
    assert (np_(r_t) > 0).any() and (np_(r_t) == 0).any()


def test_straight_line_traj():
    rng = np.random.default_rng(4)
    s, g = rng.standard_normal((5, 2)), rng.standard_normal((5, 2))
    np.testing.assert_allclose(
        np_(straight_line_traj(torch.tensor(s), torch.tensor(g), 10.0, 20)),
        np_(j_straight(jnp.asarray(s), jnp.asarray(g), 10.0, 20)), atol=TOL)


@pytest.mark.parametrize("data", [
    {"type": "point_robot_xyh", "dof": 3},
    {"type": "planar_arm"},
    {"type": "point_robot", "dof": 3},
])
def test_make_robot_refuses_what_is_not_ported(data):
    """Every robot type is ported now: these schemas, once refused, build
    the JAX package's robot (same class name and fields)."""
    assert make_robot({"type": "point_robot", "dof": 2}) == PointRobot2D()
    got, want = make_robot(data), j_make_robot(data)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
