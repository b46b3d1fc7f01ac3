"""dgpmp2_tpu_torch.tools.multistart_sweep and init_experiment against the
JAX tools' protocols, on the CPU in float64.

On a small dataset (32², T=8, written by the port): ``eval_family``
(static multistart, staged) and ``eval_family_learned_ms`` (learned
covariances on multistart seeds, both heads decoded in float64) against
the JAX package's ``plan_multistart`` with JAX's normals of the tool's
keys (``fold_in(PRNGKey(seed), batch)``) in the port, rates equal and every
other metric to 1e-8; RRT* pools: the found counts of the port's
``rrt_seed_pool`` equal the JAX package's ``rrt_seed_batch`` on the same
problems (the port takes one seed a problem where JAX salts it by row, a
listed reference fault, so the paths themselves are not compared) and the
planning that follows from given pools matches.  ``init_experiment``: the
first step of ``train_initnet`` (dropout 0) against the JAX package's on
the same weights (loss and gradients to 1e-8, Adam's update to 1e-5 of its
largest entry, see test_torch_tools_learned.py), ``eval_static``,
``eval_expert_ceiling`` and ``eval_multistart``; ``initnet_vars.npz`` read
and written in the JAX tool's layout.  Each tool's ``main`` runs end to
end, its YAMLs keyed as the JAX tool's committed ones.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from dgpmp2_tpu.core import gn as jgn
from dgpmp2_tpu.core import graph as jgraph
from dgpmp2_tpu.core import multistart as jms
from dgpmp2_tpu.core import seeds as jseeds
from dgpmp2_tpu.data import dataset as jds
from dgpmp2_tpu.learn import learned_planner as jlp_mod
from dgpmp2_tpu.learn import train_initializer as jti
from dgpmp2_tpu.learn.eval import evaluate_batch as j_evaluate
from dgpmp2_tpu.models.init_net import InitNet as JInitNet
from dgpmp2_tpu.robots import PointRobot2D as JPointRobot2D
from dgpmp2_tpu_torch import convert
from dgpmp2_tpu_torch.core import graph as tgraph
from dgpmp2_tpu_torch.learn import checkpoints as tckpt
from dgpmp2_tpu_torch.robots import PointRobot2D
from dgpmp2_tpu_torch.tools import init_experiment as ie
from dgpmp2_tpu_torch.tools import learned_campaign as lc
from dgpmp2_tpu_torch.tools import multistart_sweep as msw

from _torch_parity import _Float64Jnp
from _torch_tools import (ARGS, F64, campaign_data, fold_keys, j_batches,
                          j_learned_planner, j_line, j_merged, j_params,
                          j_static_rows, jax_normals, learned_weights, np_,
                          same_summary, yaml_of)

torch.set_num_threads(1)
T, K, AMP = 8, 4, 2.0
SPEC_J, ROBOT_J = jgraph.GraphSpec(total_time_step=T), JPointRobot2D()
SPEC_T, ROBOT_T = tgraph.GraphSpec(total_time_step=T), PointRobot2D()
BOUNDED = lc.CONFIGS["eps_bounded"][1]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("ms")
    return root, campaign_data(root)


def fam_batches(roots, fam=0, bs=2):
    return msw.load_batches(roots[fam], bs, "cpu", F64)


def j_ms_rows(batches, sigmas, seed, prune_iters=0, keep=0, pools=None):
    """The JAX tool's ``eval_family`` in float64."""
    cfg = jgn.OptimConfig(reg=0.1, max_iters=50)
    plan = jax.jit(lambda p, th0, s, rng, extra: jms.plan_multistart(
        SPEC_J, ROBOT_J, p, th0, s, cfg, rng, restarts=K, amp=AMP,
        prune_iters=prune_iters, keep=keep, extra_seeds=extra).th)
    rows = {}
    for sigma in sigmas:
        all_m = []
        for bi, b in enumerate(batches):
            th = plan(j_params(SPEC_J, ROBOT_J, b, dict(lc.COV,
                                                        cost_sigma=sigma)),
                      j_line(SPEC_J, b), b["sdf"],
                      jax.random.fold_in(jax.random.PRNGKey(seed), bi),
                      None if pools is None else jnp.asarray(np_(pools[bi])))
            all_m.append(j_evaluate(SPEC_J, ROBOT_J,
                                    j_params(SPEC_J, ROBOT_J, b, lc.COV), th,
                                    b["th_opt"], b["sdf"]))
        rows[float(sigma)] = dict(j_merged(all_m), sigma=float(sigma))
    return rows


@pytest.mark.parametrize("prune_iters,keep", [(0, 0), (10, 2)])
def test_eval_family_matches_jax(data, prune_iters, keep):
    _, roots = data
    tb = fam_batches(roots)
    sigmas, seed = (0.05, 0.5), 3
    with jax_normals(fold_keys(seed, len(tb)) * len(sigmas)):
        got = msw.eval_family(roots[0], SPEC_T, ROBOT_T, K, AMP, 2, seed,
                              prune_iters, keep, sigmas, dev="cpu",
                              dtype=F64)
    want = j_ms_rows(j_batches(tb), sigmas, seed, prune_iters, keep)
    for s in sigmas:
        same_summary(got[s], want[s], f"sigma {s}")


def test_rrt_seed_pools_and_their_plans_match_jax(data):
    _, roots = data
    tb = fam_batches(roots, fam=0)
    pools, found = msw.rrt_seed_pool(tb, SPEC_T, 2, 0.3, 0.2, seed=5)
    j_found = 0
    for bi, b in enumerate(tb):
        for k in range(2):
            _, f = jseeds.rrt_seed_batch(
                np_(b["sdf"]), np_(b["start"]), np_(b["goal"]),
                SPEC_J.x_lims, SPEC_J.y_lims, SPEC_J.total_time_sec,
                SPEC_J.num_traj_states, clearance=0.2, plan_time=0.3,
                seed=5 + 7919 * k + 104729 * bi)
            j_found += int(f.sum())
    assert found == j_found
    assert [tuple(p.shape) for p in pools] == [(2, 2, T + 1, 4)] * len(tb)
    with jax_normals(fold_keys(5, len(tb))):
        got = msw.eval_family(roots[0], SPEC_T, ROBOT_T, K, AMP, 2, 5,
                              sigmas=(0.05,), rrt_seeds=2, dev="cpu",
                              dtype=F64, pools=pools)
    want = j_ms_rows(j_batches(tb), (0.05,), 5, pools=pools)
    same_summary(got[0.05], want[0.05])


def campaign_weights(batch_j):
    kw = dict(dynamics_mode="diag_identity", dropout_prob=0.1,
              static_init=(1.0, lc.COV["cost_sigma"], lc.COV["epsilon_dist"]))
    pj = j_learned_planner(SPEC_J, ROBOT_J, dict(kw, **BOUNDED))
    return pj, learned_weights(pj, pj.stack_inputs(batch_j["im"],
                                                   batch_j["sdf"]),
                               batch_j["th_opt"])


@pytest.mark.parametrize("prune_iters,keep", [(0, 0), (10, 2)])
def test_eval_family_learned_ms_matches_jax(data, monkeypatch, prune_iters,
                                            keep):
    _, roots = data
    tb = fam_batches(roots, fam=1)
    jb = j_batches(tb)
    pj, tree = campaign_weights(jb[0])
    pt = lc.make_planner(T, BOUNDED, device="cpu", dtype=F64)
    vt = pt.load_variables(convert.learned_state_from_flax(tree),
                           pt.stack_inputs(tb[0]["im"], tb[0]["sdf"]),
                           tb[0]["th_opt"])
    monkeypatch.setattr(jlp_mod, "jnp", _Float64Jnp())
    chip_smoke.decode_in_float64(pt)
    with jax_normals(fold_keys(0, len(tb))):
        got = msw.eval_family_learned_ms(roots[1], pt, vt, K, AMP, 2, 0,
                                         prune_iters, keep)
    vj = jax.tree.map(jnp.asarray, tree)
    plan = jax.jit(lambda p, th0, s, im, rng: pj.plan_multistart(
        vj, p, th0, s, im, rng, restarts=K, amp=AMP, max_iters=50,
        prune_iters=prune_iters, keep=keep).th)
    all_m = []
    for bi, b in enumerate(jb):
        p = j_params(SPEC_J, ROBOT_J, b, lc.COV)
        th = plan(p, j_line(SPEC_J, b), b["sdf"], b["im"],
                  jax.random.fold_in(jax.random.PRNGKey(0), bi))
        all_m.append(j_evaluate(SPEC_J, ROBOT_J, p, th, b["th_opt"],
                                b["sdf"]))
    same_summary(got, j_merged(all_m))


def test_multistart_main_runs_end_to_end(data, tmp_path):
    root, roots = data
    tb = fam_batches(roots, bs=4)
    pj, tree = campaign_weights(j_batches(tb)[0])
    pt = lc.make_planner(T, BOUNDED, device="cpu", dtype=F64)
    vt = pt.load_variables(convert.learned_state_from_flax(tree),
                           pt.stack_inputs(tb[0]["im"], tb[0]["sdf"]),
                           tb[0]["th_opt"])
    tckpt.save_flat_variables(str(tmp_path / "m.npz"), vt)
    common = ["--data_root", str(root), "--out", str(tmp_path / "ms"),
              "--families", "multi_obs", "forest", "--t", str(T),
              "--restarts", "32", "--amp", "2.0", "--batch", "4",
              "--prune_iters", "10", "--keep", "8", *ARGS]
    msw.main(common + ["--sigmas", "0.05", "0.5"])
    got = msw.main(common + ["--no_static", "--cov_model",
                             f"eps_bounded:{tmp_path / 'm.npz'}"])
    chip_smoke.check_tool_files("multistart_sweep learned", tmp_path / "ms")
    assert sorted(got["forest"]["by_sigma"]) == [0.05, 0.5]
    rrt = msw.main(["--data_root", str(root), "--out", str(tmp_path / "r"),
                    "--families", "forest", "--t", str(T), "--restarts", "4",
                    "--batch", "4", "--rrt_seeds", "2", "--rrt_plan_time",
                    "0.2", "--sigmas", "0.05", *ARGS])
    assert sorted(rrt["forest"]) == ["best_contact_free_rrt2",
                                     "best_solve_rrt2", "by_sigma_rrt2"]
    chip_smoke.check_tool_files("multistart_sweep rrt", tmp_path / "r")
    table = (tmp_path / "ms" / "table.md").read_text().splitlines()
    assert [x.split(" | ")[0] for x in table[4:]] == ["| forest",
                                                      "| multi_obs"]


# -- init_experiment -----------------------------------------------------------

def init_args(**kw):
    return types.SimpleNamespace(**dict(
        dict(t=T, epochs=1, batch=2, alpha=3e-4, dropout=0.0, eval_every=1,
             seed=0, device=torch.device("cpu"), dtype=F64), **kw))


def j_initnet(b):
    """The JAX tool's InitNet (dropout 0), computing in float64, and its
    initial params made float64 (flax draws them in float32)."""
    net = JInitNet(num_states=SPEC_J.num_traj_states,
                   state_dim=SPEC_J.state_dim, dropout_prob=0.0,
                   dtype=jnp.float64)
    x0 = jnp.stack([b["im"], b["sdf"]], axis=-1)
    params = net.init(jax.random.PRNGKey(7), x0, j_line(SPEC_J, b),
                      train=False)
    return net, jax.tree.map(lambda x: x.astype(jnp.float64), params)


def test_train_initnet_first_step_matches_jax(data, tmp_path, monkeypatch):
    _, roots = data
    dataset = jds.PlanningDataset(roots[1], mode="train",
                                  label_subdir=lc.LABELS)
    all_idxs = np.random.default_rng(123).permutation(len(dataset))
    idxs = all_idxs[2:]  # n_val = max(batch 2, 8 // 10) = 2
    b = next(jds.as_batches(dataset, idxs, 2, rng=np.random.default_rng(1),
                            drop_remainder=True))
    b = {k: jnp.asarray(np.asarray(v, np.float64)) for k, v in b.items()}
    net_j, params = j_initnet(b)
    tx = optax.adam(3e-4)
    monkeypatch.setattr(jti, "jnp", _Float64Jnp())  # its float32 seed
    step_j, _, _ = jti.make_train_fns(net_j, tx, SPEC_J.total_time_sec,
                                      SPEC_J.total_time_step, SPEC_J.dof)
    params_j, opt_j, loss_j = step_j(params, tx.init(params), b,
                                     jax.random.PRNGKey(0))

    made, fns, first = ie.make_initnet, ie.make_train_fns, []

    def initnet(spec, im_size, args):
        net = made(spec, im_size, args)
        net.load_state_dict(convert.module_state_from_flax(
            jax.tree.map(np.asarray, params["params"])))
        return net

    def train_fns(net, optimizer, *a):
        step, predict, seed = fns(net, optimizer, *a)

        def recorded(batch, generator):
            before = convert.module_state_to_flax(net)
            loss = step(batch, generator)
            if not first:
                first.append((loss, before, convert.module_state_to_flax(
                    net), convert.module_grads_to_flax(net)))
            return loss
        return recorded, predict, seed

    monkeypatch.setattr(ie, "make_initnet", initnet)
    monkeypatch.setattr(ie, "make_train_fns", train_fns)
    ie.train_initnet(roots[1], str(tmp_path), init_args(), SPEC_T, ROBOT_T)
    loss_t, before, after, grads = first[0]
    assert abs(float(loss_t) / float(loss_j) - 1) <= 1e-8
    mu = opt_j[0].mu["params"]
    for (path, g), gj, a, aj, o in zip(
            jax.tree_util.tree_leaves_with_path(grads),
            jax.tree.leaves(mu), jax.tree.leaves(after),
            jax.tree.leaves(params_j["params"]), jax.tree.leaves(before)):
        gj = np.asarray(gj) / 0.1
        assert np.abs(g - gj).max() <= 1e-8 * np.abs(gj).max(), path
        dj = np.asarray(aj) - o
        assert np.abs((a - o) - dj).max() <= 1e-5 * np.abs(dj).max(), path
    assert (tmp_path / "initnet_vars.npz").exists()


def test_initnet_checkpoints_in_the_jax_layout(data, tmp_path):
    _, roots = data
    tb = fam_batches(roots, fam=1)
    b = j_batches(tb)[0]
    net_j, params = j_initnet(b)
    # JAX writes (the JAX tool's layout), the port reads.
    flat, treedef = jax.tree_util.tree_flatten(params)
    np.savez(tmp_path / "initnet_vars.npz",
             **{f"v{i}": np.asarray(x) for i, x in enumerate(flat)})
    net_t = ie.make_initnet(SPEC_T, 32, init_args())
    tckpt.load_flat_module(str(tmp_path / "initnet_vars.npz"), net_t)
    _, predict_t, _ = ie.make_train_fns(net_t, None, SPEC_T.total_time_sec,
                                        SPEC_T.total_time_step, SPEC_T.dof)
    want = np.asarray(jnp.asarray(j_line(SPEC_J, b))
                      + net_j.apply(params, jnp.stack([b["im"], b["sdf"]],
                                                      -1), j_line(SPEC_J, b),
                                    train=False))
    np.testing.assert_allclose(np_(predict_t(tb[0])), want, rtol=1e-8,
                               atol=1e-8)
    # The port writes, JAX reads the same leaves.
    tckpt.save_flat_module(str(tmp_path / "port.npz"), net_t)
    loaded = np.load(tmp_path / "port.npz")
    back = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(loaded[f"v{i}"]) for i in range(len(flat))])
    for x, y in zip(jax.tree.leaves(back), flat):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_init_experiment_evals_match_jax(data):
    _, roots = data
    tb = fam_batches(roots, fam=1)
    jb = j_batches(tb)
    sigma = 0.05
    got = ie.eval_static(SPEC_T, ROBOT_T, tb,
                         lambda b: lc.straight(SPEC_T, b["start"], b["goal"]),
                         sigma)
    same_summary(got, j_static_rows(SPEC_J, ROBOT_J, jb, (sigma,),
                                    lc.COV)[sigma])
    got = ie.eval_expert_ceiling(SPEC_T, ROBOT_T, tb)
    same_summary(got, j_merged([j_evaluate(
        SPEC_J, ROBOT_J, j_params(SPEC_J, ROBOT_J, b, lc.COV), b["th_opt"],
        b["th_opt"], b["sdf"]) for b in jb]))
    with jax_normals(fold_keys(0, len(tb))):
        got = ie.eval_multistart(
            SPEC_T, ROBOT_T, tb,
            lambda b: lc.straight(SPEC_T, b["start"], b["goal"]), sigma, K,
            1.5, 32)
    cfg = jgn.OptimConfig(reg=0.1, max_iters=50)
    plan = jax.jit(lambda p, th0, s, rng: jms.plan_multistart(
        SPEC_J, ROBOT_J, p, th0, s, cfg, rng, restarts=K, amp=1.5).th)
    all_m = []
    for bi, b in enumerate(jb):
        th = plan(j_params(SPEC_J, ROBOT_J, b, dict(lc.COV, cost_sigma=sigma)),
                  j_line(SPEC_J, b), b["sdf"],
                  jax.random.fold_in(jax.random.PRNGKey(0), bi))
        all_m.append(j_evaluate(SPEC_J, ROBOT_J,
                                j_params(SPEC_J, ROBOT_J, b, lc.COV), th,
                                b["th_opt"], b["sdf"]))
    same_summary(got, j_merged(all_m))


def test_init_experiment_main_runs_end_to_end(data, tmp_path):
    root, roots = data
    tb = fam_batches(roots, fam=1, bs=4)
    pj, tree = campaign_weights(j_batches(tb)[0])
    pt = lc.make_planner(T, BOUNDED, device="cpu", dtype=F64)
    vt = pt.load_variables(convert.learned_state_from_flax(tree),
                           pt.stack_inputs(tb[0]["im"], tb[0]["sdf"]),
                           tb[0]["th_opt"])
    tckpt.save_flat_variables(str(tmp_path / "m.npz"), vt)
    out = tmp_path / "init"
    argv = ["--data", roots[1], "--out", str(out), "--t", str(T),
            "--epochs", "1", "--batch", "2", "--eval_every", "1",
            "--eval_batch", "4", "--restarts", "16",
            "--cov_model", f"eps_bounded:{tmp_path / 'm.npz'}", *ARGS]
    got = ie.main(argv)
    chip_smoke.check_tool_files("init_experiment", out)
    # A second run reads initnet_vars.npz back: the same raw predictions.
    again = ie.main(argv)
    assert again["raw_initnet"] == got["raw_initnet"]
    assert yaml_of(out / "results.yaml") == again
