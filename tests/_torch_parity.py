"""Shared helpers of the tests that hold dgpmp2_tpu_torch against dgpmp2_tpu.

Inputs are made with numpy from a seed and handed to both packages; results
come back as numpy.  JAX stays on the CPU in float64 (tests/conftest.py).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from dgpmp2_tpu.core import graph as jgraph
from dgpmp2_tpu.robots import PointRobot2D as JPointRobot2D
from dgpmp2_tpu.robots import PointRobot3D as JPointRobot3D
from dgpmp2_tpu.ops import sdf as jsdf
from dgpmp2_tpu.utils.trajectory import straight_line_traj as j_straight

from dgpmp2_tpu_torch import convert
from dgpmp2_tpu_torch.core import graph as tgraph
from dgpmp2_tpu_torch.ops import sdf as tsdf
from dgpmp2_tpu_torch.robots import PointRobot2D as TPointRobot2D
from dgpmp2_tpu_torch.robots import PointRobot3D as TPointRobot3D
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj as t_straight

F64 = torch.float64


def np_(x):
    """A JAX array or a torch tensor as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def params_arrays(p) -> dict:
    """JAX GraphParams -> the dict convert.graph_params_from_numpy takes."""
    return {f.name: None if getattr(p, f.name) is None
            else np.asarray(getattr(p, f.name))
            for f in dataclasses.fields(p)}


def world(seed, b, n):
    """Occupancy images with one or two square obstacles each, b x n x n."""
    rng = np.random.default_rng(seed)
    imgs = np.ones((b, n, n))
    for i in range(b):
        for _ in range(1 + i % 2):
            r, c = rng.integers(n // 5, 3 * n // 5, 2)
            imgs[i, r:r + n // 5, c:c + n // 5] = 0.0
    start = np.zeros((b, 4))
    start[:, :2] = rng.uniform(-4.5, -3.5, (b, 2))
    goal = np.zeros((b, 4))
    goal[:, :2] = rng.uniform(3.5, 4.5, (b, 2))
    return imgs, start, goal


def both_problems(seed=0, b=4, t=16, n=32, cost_sigma=0.05, eps=0.4):
    """The same float64 problem in both packages:
    ((spec, robot, params, th0, sdf) JAX, (...) torch)."""
    imgs, start, goal = world(seed, b, n)
    res = 10.0 / n
    kw = dict(qc_inv=np.eye(2), cost_sigma=cost_sigma, epsilon_dist=eps,
              k_s=0.01, k_g=0.01)
    spec_j = jgraph.GraphSpec(total_time_step=t)
    sdf_j = jsdf.sdf_from_occupancy(jnp.asarray(imgs), res=res)
    params_j = jgraph.default_params(spec_j, JPointRobot2D(),
                                     jnp.asarray(start), jnp.asarray(goal),
                                     dtype=jnp.float64, **kw)
    th_j = j_straight(jnp.asarray(start[:, :2]), jnp.asarray(goal[:, :2]),
                      spec_j.total_time_sec, t)
    spec_t = tgraph.GraphSpec(total_time_step=t)
    sdf_t = tsdf.sdf_from_occupancy(torch.tensor(imgs), res=res, dtype=F64)
    params_t = convert.graph_params_from_numpy(params_arrays(params_j), "cpu",
                                               F64)
    th_t = t_straight(torch.tensor(start[:, :2]), torch.tensor(goal[:, :2]),
                      spec_t.total_time_sec, t)
    return ((spec_j, JPointRobot2D(), params_j, th_j, sdf_j),
            (spec_t, TPointRobot2D(), params_t, th_t, sdf_t))


def world3d(seed, b, n=16):
    """Voxel occupancy (b, n, n, n) with one central box each (edge n/4,
    low corner in [5n/16, n/2)), which the straight start -> goal line runs
    through; starts near (-4,-4,-4), goals near (4,4,4)."""
    rng = np.random.default_rng(seed)
    vox = np.ones((b, n, n, n))
    e = n // 4
    for i, (z, r, c) in enumerate(rng.integers(5 * n // 16, n // 2, (b, 3))):
        vox[i, z:z + e, r:r + e, c:c + e] = 0.0
    start = np.zeros((b, 6))
    start[:, :3] = rng.uniform(-4.5, -3.5, (b, 3))
    goal = np.zeros((b, 6))
    goal[:, :3] = rng.uniform(3.5, 4.5, (b, 3))
    return vox, start, goal


def both_problems_3d(seed=0, b=3, t=16, n=16, cost_sigma=0.05, eps=0.4):
    """The same float64 3-D problem (PointRobot3D, n^3 voxels) in both
    packages, as :func:`both_problems`."""
    vox, start, goal = world3d(seed, b, n)
    res = 10.0 / n
    lims = (-5.0, 5.0)
    kw = dict(qc_inv=np.eye(3), cost_sigma=cost_sigma, epsilon_dist=eps,
              k_s=0.01, k_g=0.01)
    spec_j = jgraph.GraphSpec(dof=3, state_dim=6, total_time_step=t,
                              z_lims=lims)
    sdf_j = jsdf.sdf_from_occupancy_3d(jnp.asarray(vox), res=res)
    params_j = jgraph.default_params(spec_j, JPointRobot3D(),
                                     jnp.asarray(start), jnp.asarray(goal),
                                     dtype=jnp.float64, **kw)
    th_j = j_straight(jnp.asarray(start[:, :3]), jnp.asarray(goal[:, :3]),
                      spec_j.total_time_sec, t)
    spec_t = tgraph.GraphSpec(dof=3, state_dim=6, total_time_step=t,
                              z_lims=lims)
    sdf_t = tsdf.sdf_from_occupancy_3d(torch.tensor(vox), res=res, dtype=F64)
    params_t = convert.graph_params_from_numpy(params_arrays(params_j), "cpu",
                                               F64)
    th_t = t_straight(torch.tensor(start[:, :3]), torch.tensor(goal[:, :3]),
                      spec_t.total_time_sec, t)
    return ((spec_j, JPointRobot3D(), params_j, th_j, sdf_j),
            (spec_t, TPointRobot3D(), params_t, th_t, sdf_t))


def flax_shapes(tree) -> dict:
    """A flax variable tree's leaf shapes (nested dicts of lists)."""
    import jax

    return jax.tree.map(lambda a: list(np.shape(a)), tree)


def jnp_tree(tree) -> dict:
    """Nested numpy -> nested jnp arrays (float64)."""
    import jax

    return jax.tree.map(jnp.asarray, tree)


def learned_pair(lkw: dict, seed=0, b=3, t=10, n=32, method="gauss_newton",
                 max_iters=5, weights_seed=11, out_bias=True, three_d=False):
    """The same float64 learned planner, problem and random weights in both
    packages.  ``lkw``: LearnedPlannerConfig fields (dtype excluded).  The
    weights come from ``convert.seeded_flax_tree`` about the static init
    (1.0, 0.05, 0.4) unless ``out_bias`` is False or the mode has no static
    init (``qc_full``, ``q_full``).  The JAX planner's recurrent carry is
    made float64: flax makes it float32 (its param_dtype), which a float64
    scan refuses.

    Returns (jax: (planner, variables, params, th0, sdf, im),
    torch: (planner, variables, params, th0, sdf, im), numpy weights)."""
    import jax

    from dgpmp2_tpu.core import gn as jgn
    from dgpmp2_tpu.learn import learned_planner as jlp
    from dgpmp2_tpu_torch.core import gn as tgn
    from dgpmp2_tpu_torch.learn import learned_planner as tlp

    if three_d:
        pj, pt = both_problems_3d(seed, b, t, n)
        im = world3d(seed, b, n)[0]
    else:
        pj, pt = both_problems(seed, b, t, n)
        im = world(seed, b, n)[0]
    spec_j, robot_j, params_j, th_j, sdf_j = pj
    spec_t, robot_t, params_t, th_t, sdf_t = pt
    optim = dict(reg=0.1, max_iters=max_iters, method=method)
    planner_j = jlp.LearnedDiffGPMP2Planner(
        spec_j, robot_j, jgn.OptimConfig(**optim),
        jlp.LearnedPlannerConfig(**lkw, dtype=jnp.float64))
    planner_t = tlp.LearnedDiffGPMP2Planner(
        spec_t, robot_t, tgn.OptimConfig(**optim),
        tlp.LearnedPlannerConfig(**lkw, dtype=F64), device="cpu")
    im_j = jnp.asarray(im)
    stack_j = planner_j.stack_inputs(im_j, sdf_j)
    shapes = flax_shapes(planner_j.init_variables(jax.random.PRNGKey(0),
                                                  stack_j, th_j))
    bias = None
    if out_bias and lkw.get("dynamics_mode") not in ("qc_full", "q_full"):
        bias = (planner_j.static_out_bias(1.0, 0.05, 0.4)
                if planner_j.learn_cfg.static_init is None
                else planner_j.static_out_bias(
                    *planner_j.learn_cfg.static_init))
    tree = convert.seeded_flax_tree(shapes, weights_seed,
                                    convert.learned_out_path(shapes), bias)
    if planner_j.recurrent:
        init_hidden = planner_j.init_hidden
        planner_j.init_hidden = lambda *a: jax.tree.map(
            lambda x: x.astype(jnp.float64), init_hidden(*a))
    im_t = torch.tensor(im)
    vars_t = planner_t.load_variables(
        convert.learned_state_from_flax(tree),
        planner_t.stack_inputs(im_t, sdf_t), th_t)
    return ((planner_j, jnp_tree(tree), params_j, th_j, sdf_j, im_j),
            (planner_t, vars_t, params_t, th_t, sdf_t, im_t), tree)
