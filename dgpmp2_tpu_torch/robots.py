"""Robot models: forward kinematics to workspace collision spheres.

Port of ``dgpmp2_tpu/robots.py``: the base interface, the 2-D, heading and
3-D point robots, the 2-link and N-link planar arms, the self-collision pair
rule and ``make_robot``.  FK output shapes for ``th`` of shape (..., D):
centers (..., L, W) and jac (..., L, W, D) = ∂center/∂state.

The constant tensors an FK needs (radii, link lengths, the chain mask) are
made once per robot, dtype and device and then reused, so an FK inside a
plan loop copies nothing from the host.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch


@functools.lru_cache(maxsize=None)
def _const(values: tuple, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """A constant tensor of nested-tuple ``values``, made once per dtype and
    device."""
    return torch.tensor(values, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Base robot: static geometry + FK interface."""

    dofs: int
    nlinks: int
    wksp_dim: int
    state_dim: int
    sphere_radii: Tuple[float, ...]

    def fk(self, th: torch.Tensor):
        raise NotImplementedError

    def radii_array(self, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
        return _const(tuple(self.sphere_radii), dtype, torch.device(device))


@dataclasses.dataclass(frozen=True)
class PointRobot2D(RobotModel):
    """Holonomic 2-D point robot, state ``[x, y, vx, vy]``: one sphere at
    (x, y) with a constant selector Jacobian."""

    dofs: int = 2
    nlinks: int = 1
    wksp_dim: int = 2
    state_dim: int = 4
    sphere_radii: Tuple[float, ...] = (0.4,)

    def fk(self, th: torch.Tensor):
        centers = th[..., None, :2]  # (..., 1, 2)
        jac = torch.eye(2, 4, dtype=th.dtype, device=th.device)
        return centers, jac.expand(*th.shape[:-1], 1, 2, 4)


@dataclasses.dataclass(frozen=True)
class PointRobotXYH(RobotModel):
    """Planar robot with heading, state ``[x, y, θ, vx, vy, ω]``: one sphere
    at (x, y); the heading does not move it (constant 2×6 selector)."""

    dofs: int = 3
    nlinks: int = 1
    wksp_dim: int = 2
    state_dim: int = 6
    sphere_radii: Tuple[float, ...] = (0.4,)

    def fk(self, th: torch.Tensor):
        centers = th[..., None, :2]
        jac = torch.eye(2, 6, dtype=th.dtype, device=th.device)
        return centers, jac.expand(*th.shape[:-1], 1, 2, 6)


@dataclasses.dataclass(frozen=True)
class PointRobot3D(RobotModel):
    """Holonomic 3-D point robot, state ``[x, y, z, vx, vy, vz]``: one sphere
    at (x, y, z) with a constant selector Jacobian.  Pair with
    ``GraphSpec(dof=3, state_dim=6, z_lims=...)`` and a voxel SDF."""

    dofs: int = 3
    nlinks: int = 1
    wksp_dim: int = 3
    state_dim: int = 6
    sphere_radii: Tuple[float, ...] = (0.4,)

    def fk(self, th: torch.Tensor):
        centers = th[..., None, :3]  # (..., 1, 3)
        jac = torch.eye(3, 6, dtype=th.dtype, device=th.device)
        return centers, jac.expand(*th.shape[:-1], 1, 3, 6)


@dataclasses.dataclass(frozen=True)
class PlanarArm2Link(RobotModel):
    """Two-link planar arm, state ``[q1, q2, dq1, dq2]`` (joint space).

    ``spheres_per_link`` equally spaced spheres on each link (at fractions
    (i+1)/n of its length), so ``nlinks = 2·n``; the analytic FK Jacobian
    feeds the obstacle factor's chain rule.
    """

    dofs: int = 2
    wksp_dim: int = 2
    state_dim: int = 4
    link_lengths: Tuple[float, float] = (2.5, 2.0)
    base_xy: Tuple[float, float] = (0.0, 0.0)
    spheres_per_link: int = 3
    nlinks: int = 6
    sphere_radii: Tuple[float, ...] = (0.3,) * 6

    def __post_init__(self):
        if self.nlinks != 2 * self.spheres_per_link:
            object.__setattr__(self, "nlinks", 2 * self.spheres_per_link)
        if len(self.sphere_radii) != self.nlinks:
            object.__setattr__(
                self, "sphere_radii", (self.sphere_radii[0],) * self.nlinks
            )

    def fk(self, th: torch.Tensor):
        l1, l2 = self.link_lengths
        bx, by = self.base_xy
        n = self.spheres_per_link
        q1 = th[..., 0]
        q12 = th[..., 0] + th[..., 1]
        c1, s1 = torch.cos(q1), torch.sin(q1)
        c12, s12 = torch.cos(q12), torch.sin(q12)
        zeros = torch.zeros_like(c1)
        fracs = [(i + 1) / n for i in range(n)]
        centers, jacs = [], []
        for f in fracs:  # link 1: ∂p/∂q1 = f·l1·(-s1, c1), ∂p/∂q2 = 0
            centers.append(torch.stack([bx + f * l1 * c1, by + f * l1 * s1], -1))
            jacs.append(torch.stack([
                torch.stack([-f * l1 * s1, zeros, zeros, zeros], -1),
                torch.stack([f * l1 * c1, zeros, zeros, zeros], -1),
            ], -2))
        ex = bx + l1 * c1
        ey = by + l1 * s1
        for f in fracs:  # link 2
            centers.append(torch.stack([ex + f * l2 * c12, ey + f * l2 * s12],
                                       -1))
            dq1x = -l1 * s1 - f * l2 * s12
            dq1y = l1 * c1 + f * l2 * c12
            jacs.append(torch.stack([
                torch.stack([dq1x, -f * l2 * s12, zeros, zeros], -1),
                torch.stack([dq1y, f * l2 * c12, zeros, zeros], -1),
            ], -2))
        return torch.stack(centers, -2), torch.stack(jacs, -3)


@dataclasses.dataclass(frozen=True)
class PlanarArmNLink(RobotModel):
    """N-link planar revolute arm, state ``[q_1..q_n, dq_1..dq_n]``.

    Absolute link angles are a cumsum of the joint angles, sphere centers
    cumulative link-vector sums, and the FK Jacobian the revolute-chain
    identity ``∂p/∂q_i = perp(p − joint_i)`` masked to the joints proximal
    to the sphere's link.  ``spheres_per_link`` spheres per link at
    fractions (i+1)/spheres_per_link, so ``nlinks = n·spheres_per_link``.
    """

    link_lengths: Tuple[float, ...] = (1.8, 1.4, 1.0)
    base_xy: Tuple[float, float] = (0.0, 0.0)
    spheres_per_link: int = 2
    wksp_dim: int = 2
    # Derived in __post_init__ from link_lengths/spheres_per_link:
    dofs: int = 0
    state_dim: int = 0
    nlinks: int = 0
    sphere_radii: Tuple[float, ...] = (0.3,)

    def __post_init__(self):
        n = len(self.link_lengths)
        ns = n * self.spheres_per_link
        object.__setattr__(self, "dofs", n)
        object.__setattr__(self, "state_dim", 2 * n)
        object.__setattr__(self, "nlinks", ns)
        if len(self.sphere_radii) != ns:
            object.__setattr__(
                self, "sphere_radii", (self.sphere_radii[0],) * ns
            )

    def fk(self, th: torch.Tensor):
        n = len(self.link_lengths)
        sp = self.spheres_per_link
        dt, dev = th.dtype, th.device
        lengths = _const(tuple(float(v) for v in self.link_lengths), dt, dev)
        base = _const(tuple(float(v) for v in self.base_xy), dt, dev)
        fracs = _const(tuple((i + 1) / sp for i in range(sp)), dt, dev)
        # mask[l, i] = 1 where joint i is proximal to sphere l's link.
        mask = _const(tuple(tuple(float(l // sp >= i) for i in range(n))
                            for l in range(n * sp)), dt, dev)
        theta = torch.cumsum(th[..., :n], dim=-1)  # absolute link angles
        u = torch.stack([torch.cos(theta), torch.sin(theta)], -1)  # (..., n, 2)
        seg = lengths[:, None] * u  # full link vectors
        joints = base + torch.cumsum(seg, dim=-2) - seg  # (..., n, 2)
        centers = (joints[..., :, None, :]
                   + fracs[:, None] * seg[..., :, None, :]
                   ).reshape(*th.shape[:-1], n * sp, 2)
        diff = centers[..., :, None, :] - joints[..., None, :, :]  # (..., L, n, 2)
        perp = torch.stack([-diff[..., 1], diff[..., 0]], -1)
        jac_q = (perp * mask[..., None]).transpose(-1, -2)  # (..., L, 2, n)
        return centers, torch.cat([jac_q, torch.zeros_like(jac_q)], dim=-1)


def self_collision_pairs(robot: RobotModel, eps_self: float = 0.05,
                         slack: float = 0.02) -> Tuple[Tuple[int, int], ...]:
    """Sphere index pairs for the self-collision factor.

    Pairs on one rigid link, and pairs whose separation along the chain at
    rest is within contact range (``r_i + r_j + eps_self + slack``, so they
    would be in hinge contact in every configuration), are left out; every
    other pair can fold into collision and is included.  Needs a robot with
    ``link_lengths`` and ``spheres_per_link`` (the planar arms).
    """
    lengths = getattr(robot, "link_lengths", None)
    sp = getattr(robot, "spheres_per_link", None)
    if lengths is None or sp is None:
        raise ValueError(
            f"{type(robot).__name__} has no chain geometry for "
            "self-collision pair construction")
    arcs, links = [], []
    acc = 0.0
    for k, lk in enumerate(lengths):
        for i in range(sp):
            arcs.append(acc + (i + 1) / sp * lk)
            links.append(k)
        acc += lk
    pairs = []
    for i in range(len(arcs)):
        for j in range(i + 1, len(arcs)):
            if links[i] == links[j]:
                continue  # same rigid link: distance is constant
            reach = (robot.sphere_radii[i] + robot.sphere_radii[j]
                     + eps_self + slack)
            if arcs[j] - arcs[i] > reach:
                pairs.append((i, j))
    return tuple(pairs)


def make_robot(robot_data: dict) -> RobotModel:
    """Robot from the robot-YAML schema ``{type, dof, sphere_radius, ...}``
    (plus ``link_lengths``, ``base_xy`` and ``spheres_per_link`` for arms);
    ``dof == 3`` without a known type is the heading robot, anything else
    the 2-D point robot."""
    radii = tuple(float(r) for r in robot_data.get("sphere_radius", [0.4]))
    rtype = robot_data.get("type", "point_robot")
    dof = int(robot_data.get("dof", 2))
    if rtype == "planar_arm_2link":
        return PlanarArm2Link(
            link_lengths=tuple(robot_data.get("link_lengths", (2.5, 2.0))),
            base_xy=tuple(robot_data.get("base_xy", (0.0, 0.0))),
            spheres_per_link=int(robot_data.get("spheres_per_link", 3)),
            sphere_radii=radii,
        )
    if rtype == "planar_arm":
        return PlanarArmNLink(
            link_lengths=tuple(robot_data.get("link_lengths", (1.8, 1.4, 1.0))),
            base_xy=tuple(robot_data.get("base_xy", (0.0, 0.0))),
            spheres_per_link=int(robot_data.get("spheres_per_link", 2)),
            sphere_radii=radii,
        )
    if rtype == "point_robot_3d":
        return PointRobot3D(sphere_radii=radii)
    if rtype == "point_robot_xyh" or dof == 3:
        return PointRobotXYH(sphere_radii=radii)
    return PointRobot2D(sphere_radii=radii)
