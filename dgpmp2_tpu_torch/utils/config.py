"""YAML configuration loading (port of ``dgpmp2_tpu/utils/config.py``).

Reads the YAML files of the JAX package's schema, by path, and returns
plain Python/numpy values.  The package ships its own copy of the JAX
package's configurations in :data:`CONFIG_DIR`
(``dgpmp2_tpu_torch/configs/*.yaml``).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import yaml

from dgpmp2_tpu_torch.core.gn import OptimConfig
from dgpmp2_tpu_torch.core.graph import GraphSpec
from dgpmp2_tpu_torch.robots import make_robot, self_collision_pairs

CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs"


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


def load_params_learn(param_file, robot_file, env_file, learn_params_file):
    """:func:`load_params` plus the learn-params dict."""
    out = load_params(param_file, robot_file, env_file)
    return (*out, _load_yaml(learn_params_file))


def spec_from_params(planner_params, env_data, robot) -> GraphSpec:
    """GraphSpec from the planner and env YAML.

    Keys beyond the 2-D schema: ``use_self_collision`` (pairs from the
    robot's chain geometry at ``self_collision_eps``), ``use_joint_limits``,
    ``use_workspace_goal``, and ``z_lims`` in the env YAML (3-D).  Under
    ``use_gp_inter``, ``total_check_step`` counts all collision checks, so
    ``num_inter = total_check_step // total_time_step - 1`` (at least 1;
    ``total_check_step`` defaults to 4·T).
    """
    t = int(planner_params["total_time_step"])
    gp_inter = bool(planner_params.get("use_gp_inter", False))
    self_pairs = ()
    if planner_params.get("use_self_collision", False):
        self_pairs = self_collision_pairs(
            robot,
            eps_self=float(planner_params.get("self_collision_eps", 0.05)))
    return GraphSpec(
        dof=int(planner_params["dof"]),
        state_dim=int(planner_params["state_dim"]),
        total_time_sec=float(planner_params["total_time_sec"]),
        total_time_step=t,
        nlinks=robot.nlinks,
        x_lims=tuple(float(v) for v in env_data["x_lims"]),
        y_lims=tuple(float(v) for v in env_data["y_lims"]),
        z_lims=(tuple(float(v) for v in env_data["z_lims"])
                if env_data.get("z_lims") is not None else None),
        non_holonomic=bool(planner_params.get("non_holonomic", False)),
        use_vel_limits=bool(planner_params.get("use_vel_limits", False)),
        use_gp_inter=gp_inter,
        num_inter=max(1, int(planner_params.get("total_check_step", 4 * t))
                      // t - 1) if gp_inter else 3,
        use_self_collision=bool(planner_params.get("use_self_collision",
                                                   False)),
        self_pairs=self_pairs,
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


def plan_time_budget(optim_params) -> float:
    """The ``plan_time`` budget in seconds (``'inf'`` by default)."""
    return float(optim_params.get("plan_time", "inf"))


__all__ = ["load_params", "load_params_learn", "spec_from_params",
           "optim_from_params", "plan_time_budget", "make_robot"]
