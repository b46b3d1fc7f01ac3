"""dgpmp2_tpu_torch — the PyTorch + CUDA port of dgpmp2_tpu.

Batched Gauss-Newton / Levenberg-Marquardt trajectory optimisation on a
GP-prior factor graph, differentiable through the unrolled optimizer, with
the block-tridiagonal solve and the bilinear SDF lookup as hand-written CUDA
kernels for NVIDIA Hopper (``csrc/``) beside plain PyTorch versions.  The
port covers the planners (``DiffGPMP2Planner``, ``GPMP2Planner``), every
robot and factor of the JAX package in 2-D and 3-D workspaces, and batched
multistart; see ROADMAP.md for what is still to come.

Imports PyTorch only.  The kernels are built at their first launch, never
at import.
"""
from dgpmp2_tpu_torch.core.gn import OptimConfig, PlanResult, gn_step, plan
from dgpmp2_tpu_torch.core.graph import GraphParams, GraphSpec
from dgpmp2_tpu_torch.planner import DiffGPMP2Planner, GPMP2Planner
from dgpmp2_tpu_torch.robots import (PlanarArm2Link, PlanarArmNLink,
                                     PointRobot2D, PointRobot3D,
                                     PointRobotXYH, RobotModel, make_robot,
                                     self_collision_pairs)

__all__ = [
    "DiffGPMP2Planner", "GPMP2Planner", "GraphParams", "GraphSpec",
    "OptimConfig", "PlanResult", "PlanarArm2Link", "PlanarArmNLink",
    "PointRobot2D", "PointRobot3D", "PointRobotXYH", "RobotModel", "gn_step",
    "make_robot", "plan", "self_collision_pairs",
]
