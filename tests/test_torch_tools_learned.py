"""dgpmp2_tpu_torch.tools.learned_campaign against the JAX tool's protocol,
on the CPU.

``gen_data`` against the JAX package's ``generate_split`` from the tool's
seeds: the same worlds, starts and goals, SDFs and seeds to 1e-6.  The
labels are 60-iteration float32 LM plans in both packages, which part by
~2e-4 (a long float32 trajectory is not compared); each package's labels
clear the robot.
On a small dataset (32², T=8, written by the port) in float64: the static
sweep's per-sigma rows against the JAX package's ``gn.plan`` and metric
suite, rates equal and every other metric to 1e-8; the first training step
of ``train_config`` against the JAX package's step on the same weights
and batch (dropout 0, both heads decoded in float64): the loss and metrics
to 1e-8 relative, each gradient to 1e-8 of its leaf's largest entry, and
each weight's Adam update to 1e-5 of its largest entry (Adam's first step
is lr·g/(|g| + 1e-8), which multiplies a gradient's rounding by up to
lr/1e-8 = 3e4 where |g| is near 1e-8: 1e-6 relative seen);
``eval_learned`` on weights carried across by ``convert``; the flat
checkpoint written by either package planning equal in the other; and the
tool's ``main`` end to end, its YAMLs keyed as the JAX tool's committed
ones.
"""
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dgpmp2_tpu.core import graph as jgraph
from dgpmp2_tpu.data import dataset as jds
from dgpmp2_tpu.data import generate as jgen
from dgpmp2_tpu.core import gn as jgn
from dgpmp2_tpu.learn import checkpoints as jckpt
from dgpmp2_tpu.learn import learned_planner as jlp_mod
from dgpmp2_tpu.learn import train as jtrain
from dgpmp2_tpu.learn.eval import evaluate_batch as j_evaluate
from dgpmp2_tpu.learn.losses import LossWeights as JWeights
from dgpmp2_tpu.robots import PointRobot2D as JPointRobot2D
from dgpmp2_tpu_torch import convert
from dgpmp2_tpu_torch.data import dataset as tds
from dgpmp2_tpu_torch.learn import checkpoints as tckpt
from dgpmp2_tpu_torch.ops import sdf as tsdf
from dgpmp2_tpu_torch.core import graph as tgraph
from dgpmp2_tpu_torch.learn import train as ttrain
from dgpmp2_tpu_torch.robots import PointRobot2D
from dgpmp2_tpu_torch.tools import learned_campaign as lc

from _torch_parity import _Float64Jnp, check_train_step
from _torch_tools import (ARGS, F64, campaign_data, j_batches,
                          j_learned_planner, j_line, j_merged, j_params,
                          j_static_rows, jax_tool,
                          learned_weights, np_, same_summary, yaml_of)
from test_torch_datagen import INIT_TOL

torch.set_num_threads(1)
T = 8
BOUNDED = dict(lc.CONFIGS["eps_bounded"][1], dropout_prob=0.0)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("campaign")
    return root, campaign_data(root)


def batches(roots, bs=4):
    return lc.load_test_batches(roots, bs, "cpu", F64)


def j_campaign_planner(lkw=BOUNDED):
    kw = dict(dynamics_mode="diag_identity", dropout_prob=0.1,
              static_init=(1.0, lc.COV["cost_sigma"],
                           lc.COV["epsilon_dist"]))
    kw.update(lkw)
    return j_learned_planner(jgraph.GraphSpec(total_time_step=T),
                             JPointRobot2D(), kw)


def test_the_constants_equal_the_jax_tools():
    jt = jax_tool("learned_campaign")
    assert lc.SIGMAS == jt.SIGMAS
    assert lc.COV.keys() == jt.COV.keys()
    for k, v in jt.COV.items():
        np.testing.assert_array_equal(lc.COV[k], v)
    assert lc.CONFIGS == jt.CONFIGS


def test_gen_data_matches_jax(tmp_path):
    fams = ["multi_obs", "forest"]
    roots = lc.gen_data(str(tmp_path / "port"), fams, 1, 1, 2, T,
                        device="cpu")
    spec = jgraph.GraphSpec(total_time_step=T)
    cfg = jgn.OptimConfig(reg=0.1, max_iters=60, method="lm")
    for fi, (fam, root) in enumerate(zip(fams, roots)):
        rng = np.random.default_rng(1000 * (fi + 1))
        for mode in ("train", "test"):
            jdir = tmp_path / "jax" / fam / mode
            jgen.generate_split(str(jdir), 1, 2, fam, 128, rng, spec,
                                JPointRobot2D(), cfg, lc.COV)
            want = jds.PlanningDataset(str(tmp_path / "jax" / fam), mode)
            got = tds.PlanningDataset(root, mode)
            assert len(got) == len(want) == 2
            for i in range(2):
                a, b = got[i], want[i]
                for k in ("im", "start", "goal"):
                    np.testing.assert_array_equal(a[k], np.asarray(b[k]))
                np.testing.assert_allclose(a["sdf"], np.asarray(b["sdf"]),
                                           rtol=0, atol=INIT_TOL)
                for th in (a["th_opt"], np.asarray(b["th_opt"])):
                    d, _ = tsdf.bilinear_lookup(
                        torch.tensor(a["sdf"])[None],
                        torch.tensor(th[None, :, :2]), 10 / 128,
                        (-5.0, 5.0), (-5.0, 5.0))
                    assert float(d.min()) > PointRobot2D().sphere_radii[0]


def test_static_sweep_matches_jax(data, tmp_path):
    _, roots = data
    tb = batches(roots)
    spec, robot = tgraph.GraphSpec(total_time_step=T), PointRobot2D()
    got = lc.static_sweep(spec, robot, tb, str(tmp_path / "s.yaml"))
    want = j_static_rows(jgraph.GraphSpec(total_time_step=T),
                         JPointRobot2D(), j_batches(tb), lc.SIGMAS, lc.COV)
    assert sorted(got) == sorted(want)
    for s in want:
        same_summary(got[s], want[s], f"sigma {s}")
    # Read back, not recomputed, where the file exists.
    assert lc.static_sweep(spec, robot, [], str(tmp_path / "s.yaml")) == got


def test_train_config_first_step_matches_jax(data, tmp_path, monkeypatch):
    """train_config's first step, from the JAX package's step on the same
    weights (``init_train_state`` loads them) and the tool's first batch."""
    _, roots = data
    args = types.SimpleNamespace(t=T, unroll=10, tk=5, batch=4, epochs=1,
                                 eval_every=1, alpha=3e-4, device="cpu",
                                 dtype=F64)
    w_over, _ = lc.CONFIGS["eps_bounded"]
    pj = j_campaign_planner()
    dataset = jds.PlanningDatasetMulti(roots, mode="train",
                                       label_subdir=lc.LABELS)
    all_idxs = np.random.default_rng(123).permutation(len(dataset))
    n_val = max(4, len(all_idxs) // 10)
    n_val -= n_val % 4
    idxs = all_idxs[n_val:]
    b = next(jds.as_batches(dataset, idxs, 4, rng=np.random.default_rng(1)))
    b = {k: jnp.asarray(np.asarray(v, np.float64)) for k, v in b.items()}
    tree = learned_weights(pj, pj.stack_inputs(b["im"], b["sdf"]),
                           b["th_opt"])

    monkeypatch.setattr(jtrain, "jnp", _Float64Jnp())
    monkeypatch.setattr(jlp_mod, "jnp", _Float64Jnp())
    tx = jtrain.make_optimizer("adam", {"alpha": 3e-4})
    vj = jax.tree.map(jnp.asarray, tree)
    state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), variables=vj,
                              opt_state=tx.init(vj))
    step = jtrain.make_train_step(pj, tx, JWeights(**w_over),
                                  jtrain.TrainConfig(T=10, tk=5,
                                                     use_inter_loss=True))
    state_j, m_j = step(state, dict(b, cov_scalars=lc.COV),
                        jax.random.fold_in(jax.random.PRNGKey(0), 0))

    made = lc.make_planner

    def planner(*a, **kw):
        p = made(*a, **kw)
        chip_smoke.decode_in_float64(p)
        return p

    grads = []

    def init_state(planner, tx, generator, stack, th):
        v = planner.load_variables(convert.learned_state_from_flax(tree),
                                   stack, th)
        opt = tx(v.parameters())
        step_opt = opt.step

        def recorded(*a, **kw):  # the (clipped) gradient of the first step
            if not grads:
                grads.append(convert.learned_grads_to_flax(v))
            return step_opt(*a, **kw)

        opt.step = recorded
        return ttrain.TrainState(0, v, opt)

    first = []
    make_step = lc.make_train_step

    def recording(*a, **kw):
        fn = make_step(*a, **kw)

        def step_t(state, batch, seed):
            out = fn(state, batch, seed)
            if not first:
                first.append((out[1], convert.learned_state_to_flax(
                    out[0].variables)))
            return out
        return step_t

    monkeypatch.setattr(lc, "make_planner", planner)
    monkeypatch.setattr(lc, "init_train_state", init_state)
    monkeypatch.setattr(lc, "make_train_step", recording)
    lc.train_config("eps_bounded", w_over, BOUNDED, roots, args,
                    str(tmp_path))
    m_t, after_t = first[0]
    moved = check_train_step(m_j, m_t, tree,
                             jax.tree.map(np.asarray, state_j.variables),
                             after_t, tol_loss=1e-8, tol_update=1e-5)
    assert moved > 0
    # Adam's first moment after one step is 0.1 g.
    mu = next(x.mu for x in state_j.opt_state if hasattr(x, "mu"))
    for (path, g), gj in zip(jax.tree_util.tree_leaves_with_path(grads[0]),
                             jax.tree.leaves(mu)):
        gj = np.asarray(gj) / 0.1
        assert np.abs(g - gj).max() <= 1e-8 * np.abs(gj).max(), path
    gate = yaml_of(tmp_path / "eps_bounded_gate.yaml")
    assert set(gate) == set(yaml_of(lc_ref("eps_bounded_gate.yaml")))


def lc_ref(name):
    return chip_smoke.ROOT / "runs" / "headline" / name


def test_eval_learned_matches_jax(data, monkeypatch):
    _, roots = data
    tb = batches(roots)
    jb = j_batches(tb)
    pj = j_campaign_planner()
    tree = learned_weights(pj, pj.stack_inputs(jb[0]["im"], jb[0]["sdf"]),
                           jb[0]["th_opt"])
    pt = lc.make_planner(T, BOUNDED, device="cpu", dtype=F64)
    vt = pt.load_variables(convert.learned_state_from_flax(tree),
                           pt.stack_inputs(tb[0]["im"], tb[0]["sdf"]),
                           tb[0]["th_opt"])
    monkeypatch.setattr(jlp_mod, "jnp", _Float64Jnp())
    chip_smoke.decode_in_float64(pt)
    got = lc.eval_learned(pt, types.SimpleNamespace(variables=vt), pt.spec,
                          pt.robot, tb)
    vj = jax.tree.map(jnp.asarray, tree)
    plan = jax.jit(lambda v, p, th0, s, im: pj.plan(
        v, p, th0, s, im, max_iters=50, track_best=True)[0])
    all_m = []
    for b in jb:
        p = j_params(pj.spec, pj.robot, b, lc.COV)
        th = plan(vj, p, j_line(pj.spec, b), b["sdf"], b["im"])
        all_m.append(j_evaluate(pj.spec, pj.robot, p, th, b["th_opt"],
                                b["sdf"]))
    same_summary(got, j_merged(all_m))


def test_flat_checkpoints_plan_equal_in_both_packages(data, tmp_path,
                                                      monkeypatch):
    """Either package reads the other's flat checkpoint into the same
    weights (bit-equal plans); the two packages plan them equal (both heads
    decoded in float64)."""
    _, roots = data
    monkeypatch.setattr(jlp_mod, "jnp", _Float64Jnp())
    tb = batches(roots)
    jb = j_batches(tb)[0]
    pj = j_campaign_planner()
    stack = pj.stack_inputs(jb["im"], jb["sdf"])
    tree = learned_weights(pj, stack, jb["th_opt"], seed=5)
    pt = lc.make_planner(T, BOUNDED, device="cpu", dtype=F64)
    t_stack = pt.stack_inputs(tb[0]["im"], tb[0]["sdf"])
    vt = pt.load_variables(convert.learned_state_from_flax(tree), t_stack,
                           tb[0]["th_opt"])
    chip_smoke.decode_in_float64(pt)
    template = pj.init_variables(jax.random.PRNGKey(3), stack, jb["th_opt"])
    p = j_params(pj.spec, pj.robot, jb, lc.COV)

    plan = jax.jit(lambda v: pj.plan(v, p, j_line(pj.spec, jb), jb["sdf"],
                                     jb["im"], max_iters=3)[0])

    def j_plan(v):
        return np.asarray(plan(v))

    t_params = lc.fixed_params(pt.spec, pt.robot, tb[0], lc.COV)

    def t_plan(v):
        with torch.no_grad():
            return np_(pt.plan(v, t_params, lc.straight(
                pt.spec, tb[0]["start"], tb[0]["goal"]), tb[0]["sdf"],
                tb[0]["im"], max_iters=3)[0])

    # The port writes, JAX reads (and plans as the port's weights).
    tckpt.save_flat_variables(str(tmp_path / "port.npz"), vt)
    loaded_j = jckpt.load_flat_variables(str(tmp_path / "port.npz"), template)
    np.testing.assert_array_equal(j_plan(loaded_j),
                                  j_plan(jax.tree.map(jnp.asarray, tree)))
    np.testing.assert_allclose(t_plan(vt), j_plan(loaded_j), rtol=1e-8,
                               atol=1e-8)
    # JAX writes, the port reads: the same plan as the weights it wrote.
    jckpt.save_flat_variables(str(tmp_path / "jax.npz"),
                              jax.tree.map(jnp.asarray, tree))
    fresh = pt.init_variables(torch.Generator().manual_seed(9), t_stack,
                              tb[0]["th_opt"])
    loaded_t = tckpt.load_flat_variables(str(tmp_path / "jax.npz"), fresh)
    np.testing.assert_array_equal(t_plan(loaded_t), t_plan(vt))


def test_main_runs_end_to_end_with_the_jax_tools_keys(data, tmp_path):
    root, roots = data
    out = tmp_path / "out"
    for r in roots:  # the data exists: gen_data skips it
        shutil.copytree(r, out / r.rsplit("/", 1)[-1])
    got = lc.main(["--out", str(out), "--families", "multi_obs", "forest",
                   "--num_train", "4", "--num_test", "2", "--probs", "2",
                   "--t", str(T), "--epochs", "1", "--batch", "4",
                   "--eval_every", "1", "--configs", "eps_bounded", *ARGS])
    assert got["test_batches"] == 2
    assert set(got["results"]) == {"static_best", "eps_bounded"}
    # The files, their numbers and the JAX tool's keys (runs/headline).
    chip_smoke.check_tool_files("learned_campaign", out)
    lines = (out / "table.md").read_text().splitlines()
    assert lines[0] == "| config | " + " | ".join(lc.TABLE_KEYS) + " |"
    assert [x.split(" | ")[0] for x in lines[2:]] == [
        "| static_best", "| eps_bounded"]
