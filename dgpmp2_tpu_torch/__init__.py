"""dgpmp2_tpu_torch — the PyTorch + CUDA port of dgpmp2_tpu.

Batched Gauss-Newton / Levenberg-Marquardt trajectory optimisation on a
GP-prior factor graph, differentiable through the unrolled optimizer, with
the block-tridiagonal solve and the bilinear SDF lookup as hand-written CUDA
kernels for NVIDIA Hopper (``csrc/``) beside plain PyTorch versions.  The
port covers the planners (``DiffGPMP2Planner``, ``GPMP2Planner``), every
robot and factor of the JAX package in 2-D and 3-D workspaces, batched
multistart, the learned planner and its training, data generation and
serving (``serve``, sharded over a device mesh by ``parallel.sharding``),
the environments (``envs``), the dense oracle (``core.dense``) and the
capture timer (``utils.profiling``).

Imports PyTorch only.  The kernels are built at their first launch, never
at import.
"""
from dgpmp2_tpu_torch.core.gn import OptimConfig, PlanResult, gn_step, plan
from dgpmp2_tpu_torch.core.graph import GraphParams, GraphSpec
from dgpmp2_tpu_torch.core.multistart import (MultistartResult,
                                              perturbed_inits,
                                              plan_multistart,
                                              score_candidates, select_best)
from dgpmp2_tpu_torch.envs import Env2D, Env3D
from dgpmp2_tpu_torch.planner import DiffGPMP2Planner, GPMP2Planner
from dgpmp2_tpu_torch.robots import (PlanarArm2Link, PlanarArmNLink,
                                     PointRobot2D, PointRobot3D,
                                     PointRobotXYH, RobotModel, make_robot,
                                     self_collision_pairs)
from dgpmp2_tpu_torch.serve import (LearnedPlanningAdapter,
                                    MultistartPlanningAdapter,
                                    PlanningService, PlanRequest,
                                    PlanResponse, TaskSpacePlanningAdapter)

__version__ = "0.2.0"

__all__ = [
    "DiffGPMP2Planner", "Env2D", "Env3D", "GPMP2Planner", "GraphParams",
    "GraphSpec", "LearnedPlanningAdapter", "MultistartPlanningAdapter",
    "MultistartResult", "OptimConfig", "PlanRequest", "PlanResponse",
    "PlanResult", "PlanarArm2Link", "PlanarArmNLink", "PlanningService",
    "PointRobot2D", "PointRobot3D", "PointRobotXYH", "RobotModel",
    "TaskSpacePlanningAdapter", "__version__", "gn_step", "make_robot",
    "perturbed_inits", "plan", "plan_multistart", "score_candidates",
    "select_best", "self_collision_pairs",
]
