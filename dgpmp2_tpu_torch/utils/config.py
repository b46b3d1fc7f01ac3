"""YAML configuration loading (port of ``dgpmp2_tpu/utils/config.py``).

Reads the same files as the JAX package (``dgpmp2_tpu/configs/*.yaml``, by
path) and returns plain Python/numpy values.
"""
from __future__ import annotations

import numpy as np
import yaml

from dgpmp2_tpu_torch.core.gn import OptimConfig
from dgpmp2_tpu_torch.core.graph import GraphSpec
from dgpmp2_tpu_torch.robots import make_robot


def _load_yaml(path):
    with open(path, "r") as fp:
        return yaml.safe_load(fp)


def load_params(param_file, robot_file, env_file):
    """(env_data, planner_params, gp_params, obs_params, optim_params,
    robot_data), in the order of the JAX package's ``load_params``."""
    planner_data = _load_yaml(param_file)
    env_data = _load_yaml(env_file)
    robot_data = _load_yaml(robot_file)
    gpmp2 = planner_data["gpmp2"]
    gp_params = dict(gpmp2["gp_params"])
    gp_params["Q_c_inv"] = np.asarray(gp_params["Q_c_inv"], np.float64)
    return (env_data, gpmp2["planner_params"], gp_params,
            dict(gpmp2["obs_params"]), dict(gpmp2["optim_params"]),
            robot_data)


def spec_from_params(planner_params, env_data, robot) -> GraphSpec:
    """GraphSpec from the planner and env YAML; options that are not ported
    raise ``NotImplementedError`` (see :class:`GraphSpec`)."""
    return GraphSpec(
        dof=int(planner_params["dof"]),
        state_dim=int(planner_params["state_dim"]),
        total_time_sec=float(planner_params["total_time_sec"]),
        total_time_step=int(planner_params["total_time_step"]),
        nlinks=robot.nlinks,
        x_lims=tuple(float(v) for v in env_data["x_lims"]),
        y_lims=tuple(float(v) for v in env_data["y_lims"]),
        z_lims=(tuple(float(v) for v in env_data["z_lims"])
                if env_data.get("z_lims") is not None else None),
        non_holonomic=bool(planner_params.get("non_holonomic", False)),
        use_vel_limits=bool(planner_params.get("use_vel_limits", False)),
        use_gp_inter=bool(planner_params.get("use_gp_inter", False)),
        use_self_collision=bool(planner_params.get("use_self_collision",
                                                   False)),
        use_joint_limits=bool(planner_params.get("use_joint_limits", False)),
        use_workspace_goal=bool(planner_params.get("use_workspace_goal",
                                                   False)),
    )


def optim_from_params(optim_params) -> OptimConfig:
    max_iters = optim_params.get("max_iters", 100)
    if isinstance(max_iters, str):
        max_iters = 100 if max_iters == "inf" else int(float(max_iters))
    return OptimConfig(
        method=optim_params.get("method", "gauss_newton"),
        reg=float(optim_params.get("reg", 0.0)),
        max_iters=int(max_iters),
        tol_err=float(optim_params.get("tol_err", 1e-3)),
        tol_delta=float(optim_params.get("tol_delta", 1e-4)),
        engine=str(optim_params.get("engine", "auto")),
    )


__all__ = ["load_params", "spec_from_params", "optim_from_params",
           "make_robot"]
