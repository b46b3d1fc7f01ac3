#!/usr/bin/env python
"""Write the float64 goldens of the PyTorch port from the JAX package.

The goldens tie the PyTorch port to the JAX reference on machines that have
no JAX (the GPU host): ``chip_smoke.py`` and ``tests/test_torch_port.py``
rebuild each problem from the stored inputs and compare their plan with it.

* ``tests/goldens/torch_port_plan_small.npz``: the bench.py problem
  construction at B=8 (128x128 occupancy images as uint8, start and goal).
* ``tests/goldens/torch_port_plan3d_small.npz``: the 3-D path at B=4,
  PointRobot3D in 16^3 voxel worlds with one carved 4^3 box each (uint8
  occupancy), starts near (-4,-4,-4) and goals near (4,4,4).
* ``tests/goldens/torch_port_plan_ext_small.npz``: the constrained robots
  and factors at B=4 each, in 64x64 worlds with one obstacle each: the
  2-link arm from ``gpmp2_arm_params.yaml`` + ``robot_arm.yaml``
  (self-collision, joint limits), the 3-link arm with a workspace goal,
  self-collision and joint limits, the heading robot from
  ``gpmp2_xyh_params.yaml`` (nonholonomic), and the 2-D point robot with GP
  interpolation (3 checks per segment) and velocity limits.  The
  task-space arm runs LM: its first GN steps swing the arm by tens of
  radians, so GN amplifies rounding by ~40x per iteration.  Each case
  ``<c>`` stores ``<c>_config`` (JSON: robot, planner, gp, obs and env
  dicts in the YAML schema, method, reg, iters), its occupancy images, start, goal,
  seeds ``th0`` and, for the task-space arm, ``workspace_goal``; each is
  planned through ``DiffGPMP2Planner.make_params`` and ``gn.plan``.

* ``tests/goldens/torch_port_learned_small.npz``: the learned planner
  (``LearnedDiffGPMP2Planner``) at B=4 in 64x64 worlds (the bench
  construction at that size), T=20, 5 iterations: case ``ff``, the
  campaign's bounded-eps feed-forward configuration under GN with
  ``track_best``, and case ``gru``, its GRU twin under LM.  The weights are
  remade on both sides with ``dgpmp2_tpu_torch.convert.seeded_flax_tree``
  from the stored seed and flax tree shapes (``<c>_shapes``, JSON) about the
  head's static init; no array of weights is stored.  Each case stores
  ``<c>_config`` (JSON: LearnedPlannerConfig fields, method, reg, iters,
  track_best, T, the fixed covariance scalars), its images, start, goal,
  and the plan's ``th``, ``errs`` and ``errs_ext``.

* ``tests/goldens/torch_port_data_small.npz`` (``--data``): a small forest
  split of ``dgpmp2_tpu.data.generate.generate_split`` (``DATA_CONFIG``:
  64x64, T=20, 2 worlds x 2 problems, LM with 5 iterations and
  ``track_best``, float32 as the generator plans, numpy seed 0): each
  world's occupancy map as the dataset reads it (uint8, 1 free), its SDF,
  the problems' start, goal, ``th_init`` and ``th_opt``, the config (JSON)
  and the generator's state afterwards (JSON).  The card has no JAX, so
  this is ``chip_smoke.py``'s check of the random stream there.

The plan goldens store their config scalars and, after ITERS fixed-damping GN iterations
of ``dgpmp2_tpu.core.gn.plan`` (standard engine, gather lookups), ``th``,
``err_init``, ``err_per_iter`` and ``err_ext_per_iter``, float64 on CPU.

    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py [--learned|--data]

(``--learned`` or ``--data`` writes that golden only.)
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dgpmp2_tpu.core import gn, graph  # noqa: E402
from dgpmp2_tpu.ops import sdf as sdf_ops  # noqa: E402
from dgpmp2_tpu.planner import DiffGPMP2Planner  # noqa: E402
from dgpmp2_tpu.robots import (PointRobot2D, PointRobot3D,  # noqa: E402
                               make_robot)
from dgpmp2_tpu.utils.config import load_params  # noqa: E402
from dgpmp2_tpu.utils.trajectory import straight_line_traj  # noqa: E402

GOLDENS = Path(__file__).resolve().parents[1] / "tests" / "goldens"
OUT = GOLDENS / "torch_port_plan_small.npz"
OUT3D = GOLDENS / "torch_port_plan3d_small.npz"
OUT_EXT = GOLDENS / "torch_port_plan_ext_small.npz"
OUT_LEARNED = GOLDENS / "torch_port_learned_small.npz"
OUT_DATA = GOLDENS / "torch_port_data_small.npz"
# The data golden's generate_split: the campaign's COV and expert method
# (tools/learned_campaign.py:54-55, :136-140) at a small size.
DATA_CONFIG = dict(family="forest", im_size=64, T=20, num_envs=2,
                   probs_per_env=2, method="lm", max_iters=5, reg=0.1,
                   seed=0, cost_sigma=0.05, epsilon_dist=0.4, k_s=0.01,
                   k_g=0.01)
CONFIGS = Path(__file__).resolve().parents[1] / "dgpmp2_tpu" / "configs"
B_EXT, IM_EXT = 4, 64
B, T, IMSIZE, ITERS = 8, 100, 128, 5
B3D, VOX, BOX = 4, 16, 4
CONFIG = dict(total_time_sec=10.0, reg=0.1, cost_sigma=0.05, epsilon_dist=0.4,
              k_s=0.01, k_g=0.01, x_lo=-5.0, x_hi=5.0)


def bench_inputs(b: int, seed: int = 0):
    """bench.py:44-68's construction: one 20x20 obstacle per image."""
    rng = np.random.default_rng(seed)
    imgs = np.ones((b, IMSIZE, IMSIZE), np.uint8)
    for i in range(b):
        r, c = rng.integers(20, 90, 2)
        imgs[i, r:r + 20, c:c + 20] = 0
    start = np.zeros((b, 4))
    start[:, :2] = rng.uniform(-4.5, -3.5, (b, 2))
    goal = np.zeros((b, 4))
    goal[:, :2] = rng.uniform(3.5, 4.5, (b, 2))
    return imgs, start, goal


def box_worlds_3d(b: int, seed: int = 0):
    """(b, VOX, VOX, VOX) uint8 occupancy (1 free) with one BOX^3 box each,
    its low corner in [5, 8) on every axis, so that the straight line from
    the start to the goal runs through it; starts near (-4,-4,-4) and goals
    near (4,4,4) as (b, 6) states."""
    rng = np.random.default_rng(seed)
    vox = np.ones((b, VOX, VOX, VOX), np.uint8)
    for i, (z, r, c) in enumerate(rng.integers(5, 8, (b, 3))):
        vox[i, z:z + BOX, r:r + BOX, c:c + BOX] = 0
    start = np.zeros((b, 6))
    start[:, :3] = rng.uniform(-4.5, -3.5, (b, 3))
    goal = np.zeros((b, 6))
    goal[:, :3] = rng.uniform(3.5, 4.5, (b, 3))
    return vox, start, goal


def golden(out_path, spec, robot, occupancy, start, goal, sdf, qc_inv):
    """Plan ITERS GN iterations in float64 and save inputs and outputs."""
    params = graph.default_params(
        spec, robot, jnp.asarray(start), jnp.asarray(goal), qc_inv=qc_inv,
        cost_sigma=CONFIG["cost_sigma"], epsilon_dist=CONFIG["epsilon_dist"],
        k_s=CONFIG["k_s"], k_g=CONFIG["k_g"], dtype=jnp.float64,
    )
    dof = spec.dof
    th0 = straight_line_traj(jnp.asarray(start[:, :dof]),
                             jnp.asarray(goal[:, :dof]),
                             spec.total_time_sec, T)
    cfg = gn.OptimConfig(reg=CONFIG["reg"], max_iters=ITERS, tol_delta=0.0,
                         engine="standard")
    out = gn.plan(spec, robot, params, th0, sdf, cfg)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        out_path, images=occupancy, start=start, goal=goal, T=T,
        imsize=occupancy.shape[-1], iters=ITERS,
        **{k: np.float64(v) for k, v in CONFIG.items()},
        th=np.asarray(out.th), err_init=np.asarray(out.err_init),
        err_per_iter=np.asarray(out.err_per_iter),
        err_ext_per_iter=np.asarray(out.err_ext_per_iter),
    )
    print(f"wrote {out_path} ({os.path.getsize(out_path)} bytes)")


def ext_cases(rng):
    """The constrained cases as (name, config, extra inputs): configs in the
    YAML schema, from the repo's YAMLs where they exist."""
    env = {"x_lims": [-5.0, 5.0], "y_lims": [-5.0, 5.0]}
    _, pp_arm, gp_arm, obs_arm, _, robot_arm = load_params(
        CONFIGS / "gpmp2_arm_params.yaml", CONFIGS / "robot_arm.yaml",
        CONFIGS / "env_2d_params.yaml")
    _, pp_xyh, gp_xyh, obs_xyh, _, _ = load_params(
        CONFIGS / "gpmp2_xyh_params.yaml", CONFIGS / "robot_2d.yaml",
        CONFIGS / "env_2d_params.yaml")
    _, pp_2d, gp_2d, obs_2d, _, robot_2d = load_params(
        CONFIGS / "gpmp2_2d_params.yaml", CONFIGS / "robot_2d.yaml",
        CONFIGS / "env_2d_params.yaml")
    b = B_EXT

    def states(dof, lo, hi):
        x = np.zeros((b, 2 * dof))
        x[:, :dof] = rng.uniform(lo, hi, (b, dof))
        return x

    arm_start = states(2, -0.5, 0.5)
    arm_start[:, 0] += -2.0
    arm_goal = states(2, -0.5, 0.5)
    arm_goal[:, 0] += 1.6
    task_start = states(3, -0.4, 0.4)
    xyh_start, xyh_goal = states(3, -4.5, -3.5), states(3, 3.5, 4.5)
    xyh_start[:, 2] = xyh_goal[:, 2] = 0.785
    return [
        ("arm2", dict(robot=robot_arm, planner=pp_arm, gp=gp_arm,
                      obs=obs_arm, env=env), arm_start, arm_goal, None),
        ("arm3_task", dict(
            robot={"type": "planar_arm", "link_lengths": [1.8, 1.4, 1.2],
                   "spheres_per_link": 2, "sphere_radius": [0.25]},
            planner=dict(pp_arm, dof=3, state_dim=6, total_time_step=30,
                         use_workspace_goal=True),
            gp=dict(gp_arm, Q_c_inv=np.eye(3), K_g=100.0, q_min=[-2.4] * 3,
                    q_max=[2.4] * 3),
            obs=dict(obs_arm, epsilon_dist=0.25), env=env, method="lm"),
         task_start, task_start, rng.uniform(2.1, 3.1, (b, 2))),
        ("xyh", dict(robot={"type": "point_robot", "dof": 3,
                            "sphere_radius": [0.4]},
                     planner=pp_xyh, gp=gp_xyh, obs=obs_xyh, env=env),
         xyh_start, xyh_goal, None),
        ("gp_inter_vel", dict(
            robot=robot_2d,
            planner=dict(pp_2d, total_time_step=50, use_gp_inter=True,
                         total_check_step=200, use_vel_limits=True),
            gp=dict(gp_2d, v_x=0.7, v_y=0.7), obs=obs_2d, env=env),
         states(2, -4.5, -3.5), states(2, 3.5, 4.5), None),
    ]


def golden_ext(out_path):
    """Plan each constrained case ITERS GN iterations in float64 through the
    YAML-schema planner and save inputs, config and outputs."""
    rng = np.random.default_rng(0)
    arrays = {}
    for name, cfg, start, goal, wg in ext_cases(rng):
        imgs = np.ones((B_EXT, IM_EXT, IM_EXT), np.uint8)
        for i in range(B_EXT):
            r, c = rng.integers(10, 44, 2)
            imgs[i, r:r + 10, c:c + 10] = 0
        cfg = json.loads(json.dumps(
            dict(cfg, reg=CONFIG["reg"], iters=ITERS,
                 method=cfg.get("method", "gauss_newton")),
            default=lambda a: np.asarray(a).tolist()))
        robot = make_robot(cfg["robot"])
        planner = DiffGPMP2Planner(
            cfg["gp"], cfg["obs"], cfg["planner"],
            {"method": cfg["method"], "reg": cfg["reg"], "max_iters": ITERS},
            cfg["env"], robot,
            dtype=jnp.float64)
        spec = planner.spec
        sdf = sdf_ops.sdf_from_occupancy(jnp.asarray(imgs, jnp.float64),
                                         res=10.0 / IM_EXT)
        params = planner.make_params(start, goal, workspace_goal=wg)
        th0 = straight_line_traj(jnp.asarray(start[:, :spec.dof]),
                                 jnp.asarray(goal[:, :spec.dof]),
                                 spec.total_time_sec, spec.total_time_step)
        opt = gn.OptimConfig(method=cfg["method"], reg=cfg["reg"],
                             max_iters=ITERS, tol_delta=0.0,
                             engine="standard")
        out = gn.plan(spec, robot, params, th0, sdf, opt)
        arrays.update({
            f"{name}_config": np.asarray(json.dumps(cfg)),
            f"{name}_images": imgs, f"{name}_start": start,
            f"{name}_goal": goal, f"{name}_th0": np.asarray(th0),
            f"{name}_th": np.asarray(out.th),
            f"{name}_err_init": np.asarray(out.err_init),
            f"{name}_err_per_iter": np.asarray(out.err_per_iter),
            f"{name}_err_ext_per_iter": np.asarray(out.err_ext_per_iter),
        })
        if wg is not None:
            arrays[f"{name}_workspace_goal"] = wg
    np.savez_compressed(out_path, cases=np.asarray(
        [n for n, *_ in ext_cases(np.random.default_rng(0))]), **arrays)
    print(f"wrote {out_path} ({os.path.getsize(out_path)} bytes)")


LEARNED_B, LEARNED_IM, LEARNED_T = 4, 64, 20
# The campaign's eps_bounded configuration (tools/learned_campaign.py) and
# its GRU twin, hidden width cut to 16.
LEARNED_CASES = {
    "ff": dict(learn=dict(dynamics_mode="diag_identity", learn_eps=True,
                          eps_max=0.8, static_init=[1.0, 0.01, 0.4],
                          dropout_prob=0.1),
               method="gauss_newton", track_best=True),
    "gru": dict(learn=dict(dynamics_mode="diag_identity", learn_eps=True,
                           eps_max=0.8, static_init=[1.0, 0.01, 0.4],
                           model_type="rnn_gru", hidden_dim=16),
                method="lm", track_best=False),
}


def golden_learned(out_path):
    """The learned planner's golden: each case planned in float64 with
    weights from ``seeded_flax_tree`` (seed 7) about the static init."""
    from dgpmp2_tpu.learn.learned_planner import (LearnedDiffGPMP2Planner,
                                                  LearnedPlannerConfig)
    from dgpmp2_tpu_torch import convert

    cov = dict(cost_sigma=0.05, epsilon_dist=0.4, k_s=0.01, k_g=0.01)
    arrays = {}
    for case, c in LEARNED_CASES.items():
        rng = np.random.default_rng({"ff": 1, "gru": 2}[case])
        imgs = np.ones((LEARNED_B, LEARNED_IM, LEARNED_IM), np.uint8)
        for i in range(LEARNED_B):
            r, cc = rng.integers(10, 45, 2)
            imgs[i, r:r + 10, cc:cc + 10] = 0
        start = np.zeros((LEARNED_B, 4))
        start[:, :2] = rng.uniform(-4.5, -3.5, (LEARNED_B, 2))
        goal = np.zeros((LEARNED_B, 4))
        goal[:, :2] = rng.uniform(3.5, 4.5, (LEARNED_B, 2))
        spec = graph.GraphSpec(total_time_step=LEARNED_T)
        robot = PointRobot2D()
        lcfg = dict(c["learn"], static_init=tuple(c["learn"]["static_init"]))
        planner = LearnedDiffGPMP2Planner(
            spec, robot, gn.OptimConfig(reg=0.1, max_iters=ITERS,
                                        method=c["method"]),
            LearnedPlannerConfig(**lcfg, dtype=jnp.float64))
        sdf = sdf_ops.sdf_from_occupancy(jnp.asarray(imgs, jnp.float64),
                                         res=10.0 / LEARNED_IM)
        params = graph.default_params(spec, robot, jnp.asarray(start),
                                      jnp.asarray(goal), qc_inv=np.eye(2),
                                      dtype=jnp.float64, **cov)
        th0 = straight_line_traj(jnp.asarray(start[:, :2]),
                                 jnp.asarray(goal[:, :2]),
                                 spec.total_time_sec, LEARNED_T)
        im = jnp.asarray(imgs, jnp.float64)
        shapes = jax.tree.map(
            lambda a: list(np.shape(a)), planner.init_variables(
                jax.random.PRNGKey(0), planner.stack_inputs(im, sdf), th0))
        tree = convert.seeded_flax_tree(
            shapes, 7, convert.learned_out_path(shapes),
            planner.static_out_bias(*lcfg["static_init"]))
        hidden = None
        if planner.recurrent:  # flax's carry is float32; the scan is float64
            hidden = jax.tree.map(lambda x: x.astype(jnp.float64),
                                  planner.init_hidden(jax.random.PRNGKey(0),
                                                      LEARNED_B, 1))
        th, errs, errs_ext, _ = planner.plan(
            jax.tree.map(jnp.asarray, tree), params, th0, sdf, im,
            hidden=hidden, track_best=c["track_best"])
        config = dict(learn=c["learn"], method=c["method"], reg=0.1,
                      iters=ITERS, track_best=c["track_best"], T=LEARNED_T,
                      **cov)
        arrays.update({
            f"{case}_config": json.dumps(config),
            f"{case}_shapes": json.dumps(shapes), f"{case}_seed": 7,
            f"{case}_images": imgs, f"{case}_start": start,
            f"{case}_goal": goal, f"{case}_th": np.asarray(th),
            f"{case}_errs": np.asarray(errs),
            f"{case}_errs_ext": np.asarray(errs_ext)})
    np.savez_compressed(out_path, cases=np.asarray(list(LEARNED_CASES)),
                        **arrays)
    print(f"wrote {out_path} ({os.path.getsize(out_path)} bytes)")


def golden_data(out_path):
    """generate_split at DATA_CONFIG into a temporary directory, read back
    (the maps through the JAX package's dataset reader)."""
    import tempfile

    from dgpmp2_tpu.data import dataset as ds
    from dgpmp2_tpu.data import generate

    c = DATA_CONFIG
    rng = np.random.default_rng(c["seed"])
    cov = dict(qc_inv=np.eye(2), cost_sigma=c["cost_sigma"],
               epsilon_dist=c["epsilon_dist"], k_s=c["k_s"], k_g=c["k_g"])
    n, probs = c["num_envs"], c["probs_per_env"]
    with tempfile.TemporaryDirectory() as root:
        split = os.path.join(root, "train")
        generate.generate_split(
            split, n, probs, c["family"], c["im_size"], rng,
            graph.GraphSpec(total_time_step=c["T"]), PointRobot2D(),
            gn.OptimConfig(reg=c["reg"], max_iters=c["max_iters"],
                           method=c["method"]), cov)
        data = ds.PlanningDataset(root, mode="train")
        envs = [data._load_env(e) for e in range(n)]
        labels = [np.load(os.path.join(split, "opt_trajs_gpmp2",
                                       f"env_{e}_prob_{j}.npz"))
                  for e in range(n) for j in range(probs)]
        arrays = {k: np.stack([z[k] for z in labels])
                  for k in ("start", "goal", "th_init", "th_opt")}
    np.savez_compressed(
        out_path, config=json.dumps(c),
        rng_state=json.dumps(rng.bit_generator.state),
        maps=np.stack([im for im, _ in envs]).astype(np.uint8),
        sdf=np.stack([sdf for _, sdf in envs]).astype(np.float32), **arrays)
    print(f"wrote {out_path} ({os.path.getsize(out_path)} bytes)")


def main():
    if sys.argv[1:] == ["--learned"]:
        golden_learned(OUT_LEARNED)
        return
    if sys.argv[1:] == ["--data"]:
        golden_data(OUT_DATA)
        return
    imgs, start, goal = bench_inputs(B)
    spec = graph.GraphSpec(total_time_step=T,
                           total_time_sec=CONFIG["total_time_sec"])
    sdf = sdf_ops.sdf_from_occupancy(jnp.asarray(imgs, jnp.float64),
                                     res=10.0 / IMSIZE)
    golden(OUT, spec, PointRobot2D(), imgs, start, goal, sdf, np.eye(2))

    vox, start, goal = box_worlds_3d(B3D)
    lims = (CONFIG["x_lo"], CONFIG["x_hi"])
    spec = graph.GraphSpec(dof=3, state_dim=6, total_time_step=T,
                           total_time_sec=CONFIG["total_time_sec"],
                           x_lims=lims, y_lims=lims, z_lims=lims)
    sdf_ops.set_lookup3d_method("gather")
    sdf = sdf_ops.sdf_from_occupancy_3d(jnp.asarray(vox, jnp.float64),
                                        res=10.0 / VOX)
    golden(OUT3D, spec, PointRobot3D(), vox, start, goal, sdf, np.eye(3))
    golden_ext(OUT_EXT)
    golden_learned(OUT_LEARNED)
    golden_data(OUT_DATA)


if __name__ == "__main__":
    main()
