"""Robot models: forward kinematics to workspace collision spheres.

Port of ``dgpmp2_tpu/robots.py`` for the ported paths: the base interface
and the 2-D and 3-D point robots.  FK output shapes for ``th`` of shape (..., D):
centers (..., L, W) and jac (..., L, W, D) = ∂center/∂state.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


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
        return torch.tensor(self.sphere_radii, dtype=dtype, device=device)


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


def make_robot(robot_data: dict) -> RobotModel:
    """Robot from the reference's robot-YAML schema (``{type, dof,
    sphere_radius, ...}``); the 2-D and 3-D point robots are ported so far."""
    radii = tuple(float(r) for r in robot_data.get("sphere_radius", [0.4]))
    rtype = robot_data.get("type", "point_robot")
    dof = int(robot_data.get("dof", 2))
    if rtype == "point_robot" and dof == 2:
        return PointRobot2D(sphere_radii=radii)
    if rtype == "point_robot_3d":
        return PointRobot3D(sphere_radii=radii)
    raise NotImplementedError(
        f"robot type {rtype!r} with dof={dof} is not ported to "
        "dgpmp2_tpu_torch yet (ROADMAP.md, queue 1 item 9)"
    )
