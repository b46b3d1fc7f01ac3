"""dgpmp2_tpu_torch — the PyTorch + CUDA port of dgpmp2_tpu.

Batched Gauss-Newton / Levenberg-Marquardt trajectory optimisation on a
GP-prior factor graph, differentiable through the unrolled optimizer, with
the block-tridiagonal solve and the bilinear SDF lookup as hand-written CUDA
kernels for NVIDIA Hopper (``csrc/``) beside plain PyTorch versions.  So far
the port covers the 2-D point-robot plan path; see ROADMAP.md.

Imports PyTorch only.  The kernels are built at their first launch, never
at import.
"""
from dgpmp2_tpu_torch.core.gn import OptimConfig, PlanResult, gn_step, plan
from dgpmp2_tpu_torch.core.graph import GraphParams, GraphSpec
from dgpmp2_tpu_torch.planner import DiffGPMP2Planner
from dgpmp2_tpu_torch.robots import PointRobot2D, RobotModel, make_robot

__all__ = [
    "DiffGPMP2Planner", "GraphParams", "GraphSpec", "OptimConfig",
    "PlanResult", "PointRobot2D", "RobotModel", "gn_step", "make_robot",
    "plan",
]
