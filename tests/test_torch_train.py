"""Training in the port (dgpmp2_tpu_torch.learn.{losses, train, checkpoints,
eval, train_planner, test_planner, train_initializer}) against the JAX
package where both compute the same thing, and the port's own dropout,
checkpoints and CLIs.  Float64 on the CPU; each tolerance is stated where
it is used (the training step's parity is test_torch_train_paths.py's and
test_torch_train_heads.py's)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

import chip_smoke
from _torch_parity import learned_pair, np_, world
from dgpmp2_tpu.core import gn as jgn
from dgpmp2_tpu.core import graph as jgraph
from dgpmp2_tpu.learn import checkpoints as jckpt
from dgpmp2_tpu.learn import eval as jeval
from dgpmp2_tpu.learn import losses as jlosses
from dgpmp2_tpu.learn import train as jtrain
from dgpmp2_tpu.robots import PointRobot2D as JRobot
from dgpmp2_tpu_torch import convert
from dgpmp2_tpu_torch.core import gn as tgn
from dgpmp2_tpu_torch.core import graph as tgraph
from dgpmp2_tpu_torch.learn import checkpoints as tckpt
from dgpmp2_tpu_torch.learn import eval as teval
from dgpmp2_tpu_torch.learn import losses as tlosses
from dgpmp2_tpu_torch.learn import test_planner, train_initializer
from dgpmp2_tpu_torch.learn import train as ttrain
from dgpmp2_tpu_torch.learn import train_planner
from dgpmp2_tpu_torch.models import cov_head
from dgpmp2_tpu_torch.robots import PointRobot2D as TRobot

torch.set_num_threads(1)
CPU = torch.device("cpu")


def rel(a, b):
    a, b = np_(a), np_(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# -- losses -----------------------------------------------------------------

def test_one_step_loss_matches_jax():
    """Every term, the max-penetration surrogate on: 1e-12 relative."""
    rng = np.random.default_rng(0)
    b, t, d = 3, 9, 4
    args = [rng.standard_normal((b, t + 1, d)) for _ in range(2)]
    errs = [rng.uniform(0, 2, b) for _ in range(3)]
    r_obs = np.maximum(rng.standard_normal((b, t + 1, 2)), 0.0)
    kw = dict(vel_loss_lambda=0.3, ext_obs_lambda=2.0, ext_loss_weight=0.7,
              pos_loss_weight=0.4, max_pen_weight=1.5, max_pen_beta=12.0)
    got = tlosses.one_step_loss(*map(torch.tensor, args + errs),
                                tlosses.LossWeights(**kw), 2,
                                r_obs=torch.tensor(r_obs))
    want = jlosses.one_step_loss(*map(jnp.asarray, args + errs),
                                 jlosses.LossWeights(**kw), 2,
                                 r_obs=jnp.asarray(r_obs))
    assert got._fields == want._fields
    for name in got._fields:
        assert rel(getattr(got, name), getattr(want, name)) <= 1e-12, name
    assert rel(tlosses.smooth_max_penetration(torch.tensor(r_obs), 12.0),
               jlosses.smooth_max_penetration(jnp.asarray(r_obs), 12.0)
               ) <= 1e-12
    with pytest.raises(ValueError, match="requires r_obs"):
        tlosses.one_step_loss(*map(torch.tensor, args + errs),
                              tlosses.LossWeights(max_pen_weight=1.0), 2)


@pytest.mark.parametrize("name", ["mse", "mse_traj", "huber"])
def test_make_loss_matches_jax(name):
    rng = np.random.default_rng(1)
    p, t = rng.standard_normal((2, 3, 5, 4)) * 2
    assert rel(tlosses.make_loss(name, delta=0.7)(torch.tensor(p),
                                                  torch.tensor(t)),
               jlosses.make_loss(name, delta=0.7)(jnp.asarray(p),
                                                  jnp.asarray(t))) <= 1e-12
    with pytest.raises(ValueError):
        tlosses.make_loss("norm_mse")


# -- optimizers and clipping -------------------------------------------------

OPTIMIZERS = {
    "adam": ("adam", {"alpha": 1e-2}),
    "adamw": ("adam", {"alpha": 1e-2, "reg_strength": 0.05}),
    "sgd_nesterov": ("sgd", {"alpha": 0.1, "momentum": 0.9,
                             "nesterov": True, "reg_strength": 0.01}),
    "rmsprop_momentum": ("rmsprop", {"alpha": 1e-2, "momentum": 0.8,
                                     "reg_strength": 0.01}),
    "rmsprop_centered": ("rmsprop", {"alpha": 1e-2, "centered": True}),
}


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_optimizers_match_optax_over_three_steps(opt):
    """The same gradients, three steps: the parameters within 1e-12
    relative (float64; only the order of a few products differs)."""
    name, cfg = OPTIMIZERS[opt]
    rng = np.random.default_rng(2)
    shapes = [(3, 4), (5,)]
    params = [rng.standard_normal(s) for s in shapes]
    grads = [[rng.standard_normal(s) for s in shapes] for _ in range(3)]
    tx = jtrain.make_optimizer(name, cfg)
    p_j = [jnp.asarray(p) for p in params]
    state = tx.init(p_j)
    p_t = [torch.tensor(p, requires_grad=True) for p in params]
    optim = ttrain.make_optimizer(name, cfg)(p_t)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, p_j)
        p_j = optax.apply_updates(p_j, updates)
        for p, x in zip(p_t, g):
            p.grad = torch.tensor(x)
        optim.step()
        for a, b in zip(p_t, p_j):
            assert rel(a.detach(), b) <= 1e-12, opt
    with pytest.raises(ValueError, match="unknown optimizer"):
        ttrain.make_optimizer("lbfgs", {})


def test_clip_by_global_norm_matches_jax():
    """scale = min(1, clip / (‖g‖ + 1e-9)) over every leaf, as the JAX
    train step (not torch's clip_grad_norm_, which adds 1e-6)."""
    rng = np.random.default_rng(3)
    mods = torch.nn.ModuleDict({"a": torch.nn.Linear(4, 3),
                                "b": torch.nn.Linear(3, 2)}).double()
    grads = [rng.standard_normal(tuple(p.shape)) for p in mods.parameters()]
    for p, g in zip(mods.parameters(), grads):
        p.grad = torch.tensor(g)
    gnorm = ttrain.clip_by_global_norm(mods, 0.5)
    want = optax.global_norm([jnp.asarray(g) for g in grads])
    scale = jnp.minimum(1.0, 0.5 / (want + 1e-9))
    assert rel(gnorm, want) <= 1e-14
    for p, g in zip(mods.parameters(), grads):
        assert rel(p.grad, g * scale) <= 1e-14


# -- flat variables -----------------------------------------------------------

@pytest.mark.parametrize("lkw", [dict(dynamics_mode="diag_identity"),
                                 dict(model_type="rnn_gru", hidden_dim=8)],
                         ids=["feed_forward", "gru"])
def test_flat_variables_cross_between_the_packages(lkw, tmp_path):
    """A JAX-written .npz loads into the port and a port-written one into
    JAX, leaf for leaf (exact)."""
    jp, tp, tree = learned_pair(lkw)
    vars_j, vars_t = jp[1], tp[1]
    jckpt.save_flat_variables(tmp_path / "j.npz", vars_j)
    fresh = tp[0].init_variables(torch.Generator().manual_seed(5),
                                 tp[0].stack_inputs(tp[5], tp[4]), tp[3])
    loaded = tckpt.load_flat_variables(tmp_path / "j.npz", fresh)
    for k, v in convert.learned_state_from_flax(tree).items():
        assert torch.equal(loaded.state_dict()[k], v), k
    tckpt.save_flat_variables(tmp_path / "t.npz", vars_t)
    back = jckpt.load_flat_variables(tmp_path / "t.npz", vars_j)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert np.array_equal(np.asarray(a), b)
    with pytest.raises(ValueError, match="mismatched architecture"):
        np.savez(tmp_path / "short.npz", v0=np.zeros(3))
        tckpt.load_flat_variables(tmp_path / "short.npz", fresh)


# -- evaluation ---------------------------------------------------------------

def test_eval_metrics_cover_velocity_and_joint_limits():
    """tests/test_learn.py:752's case in both packages: every metric to
    1e-12 relative (the smoothness norms round apart), the summaries'
    violation rates equal."""
    kw = dict(qc_inv=np.eye(2), cost_sigma=0.1, epsilon_dist=0.3, k_s=0.01,
              k_g=0.01, k_v=0.1, v_x=1.0, v_y=1.0, k_jl=0.1,
              q_min=[-2.0, -2.0], q_max=[2.0, 2.0])
    flags = dict(total_time_step=9, use_vel_limits=True,
                 use_joint_limits=True)
    spec_j, spec_t = jgraph.GraphSpec(**flags), tgraph.GraphSpec(**flags)
    z = np.zeros((2, 4))
    params_j = jgraph.default_params(spec_j, JRobot(), jnp.asarray(z),
                                     jnp.asarray(z), dtype=jnp.float64, **kw)
    params_t = tgraph.default_params(spec_t, TRobot(), torch.tensor(z),
                                     torch.tensor(z), dtype=torch.float64,
                                     **kw)
    th = np.zeros((2, 10, 4))
    th[1, 3:7, 2] = 1.5
    th[1, 8:, 0] = 2.5
    sdf = np.full((2, 16, 16), 5.0)
    m_t = teval.evaluate_batch(spec_t, TRobot(), params_t, torch.tensor(th),
                               None, torch.tensor(sdf))
    m_j = jeval.evaluate_batch(spec_j, JRobot(), params_j, jnp.asarray(th),
                               None, jnp.asarray(sdf))
    np.testing.assert_allclose(m_t["constraint_violation"], [0.0, 0.4])
    np.testing.assert_allclose(m_t["joint_limit_violation"], [0.0, 0.2])
    assert m_t.keys() == m_j.keys()
    for k in m_j:
        assert rel(m_t[k].astype(np.float64), m_j[k].astype(np.float64)
                   ) <= 1e-12, k
    s_t, s_j = teval.summarize(m_t), jeval.summarize(m_j)
    assert s_t.keys() == s_j.keys()
    for k in ("avg_constraint_violation", "avg_joint_limit_violation",
              "solve_rate", "contact_free_rate"):
        assert s_t[k] == s_j[k], k


def test_evaluate_batch_and_summarize_match_jax_on_plans():
    """Plans through obstacles (5 GN iterations from the straight line, so
    some collide) against an expert: every metric 1e-12 relative, the
    summary's rates equal."""
    jp, tp, _ = learned_pair(dict(dynamics_mode="diag_identity"), b=4)
    spec_j, params_j, sdf_j = jp[0].spec, jp[2], jp[4]
    spec_t, params_t, sdf_t = tp[0].spec, tp[2], tp[4]
    th = tgn.plan(spec_t, TRobot(), params_t, tp[3], sdf_t,
                  tgn.OptimConfig(reg=0.1, max_iters=5)).th
    th_opt = np_(th) + 0.05
    m_j = jeval.evaluate_batch(spec_j, JRobot(), params_j,
                               jnp.asarray(np_(th)), jnp.asarray(th_opt),
                               sdf_j)
    m_t = teval.evaluate_batch(spec_t, TRobot(), params_t, th,
                               torch.tensor(th_opt), sdf_t)
    assert m_t.keys() == m_j.keys()
    for k in m_j:
        assert rel(m_t[k].astype(np.float64), m_j[k].astype(np.float64)
                   ) <= 1e-12, k
    s_t, s_j = teval.summarize(m_t), jeval.summarize(m_j)
    assert s_t.keys() == s_j.keys()
    for k in s_j:
        assert abs(s_t[k] - s_j[k]) <= 1e-12 * max(1.0, abs(s_j[k])), k
    assert 0.0 < s_t["solve_rate"] <= 1.0


def test_run_validation_matches_jax():
    """The fixed-covariance plan of run_validation (5 GN iterations) and its
    summary: 1e-9 relative."""
    jp, tp, _ = learned_pair(dict(dynamics_mode="diag_identity"), b=4)
    _, start, goal = world(0, 4, 32)
    cov = dict(qc_inv=np.eye(2), cost_sigma=0.05, epsilon_dist=0.4,
               k_s=0.01, k_g=0.01)
    th_opt = np_(tp[3]) + 0.05
    s_j = jeval.run_validation(
        jp[0].spec, JRobot(), jgn.OptimConfig(reg=0.1, max_iters=5),
        lambda s, g: jgraph.default_params(jp[0].spec, JRobot(), s, g,
                                           dtype=jnp.float64, **cov),
        [{"start": jnp.asarray(start), "goal": jnp.asarray(goal),
          "sdf": jp[4], "th_opt": jnp.asarray(th_opt)}])
    s_t = teval.run_validation(
        tp[0].spec, TRobot(), tgn.OptimConfig(reg=0.1, max_iters=5),
        lambda s, g: tgraph.default_params(tp[0].spec, TRobot(), s, g,
                                           dtype=torch.float64, **cov),
        [{"start": torch.tensor(start), "goal": torch.tensor(goal),
          "sdf": tp[4], "th_opt": torch.tensor(th_opt)}])
    assert s_t.keys() == s_j.keys()
    for k in s_j:
        assert abs(s_t[k] - s_j[k]) <= 1e-9 * max(1.0, abs(s_j[k])), k


# -- dropout --------------------------------------------------------------------

def _head(p, in_dim=40, out_dim=7):
    head = cov_head.FeedForwardHead(in_dim, out_dim, hidden=(30, 20),
                                    dropout_prob=p).double()
    head.reset_parameters(torch.Generator().manual_seed(0))
    return head


def test_dropout_keeps_units_at_one_minus_p_and_scales_by_its_inverse():
    """Masks from an explicit generator: each unit kept with probability
    1 - p (within 4 standard deviations over 2·10^5 draws), the kept ones
    scaled by 1/(1 - p) as flax's Dropout; the same generator seed gives
    the same masks."""
    p = 0.3
    head = _head(p)
    masks = head.dropout_masks(5000, torch.Generator().manual_seed(1))
    assert [tuple(m.shape) for m in masks] == [(5000, 40), (5000, 30),
                                                (5000, 20)]
    keep = masks[0].double().mean().item()
    assert abs(keep - (1 - p)) <= 4 * np.sqrt(p * (1 - p) / 2e5)
    again = head.dropout_masks(5000, torch.Generator().manual_seed(1))
    assert all(torch.equal(a, b) for a, b in zip(masks, again))
    x = torch.randn(5000, 40, dtype=torch.float64)
    y = cov_head.apply_dropout(x, masks[0], p)
    assert torch.equal(y, torch.where(masks[0], x / (1 - p),
                                      torch.zeros((), dtype=x.dtype)))
    # The head's forward takes the masks or draws them from a generator.
    feats, pos = x[:8, :30], x[:8, 30:]
    by_gen = head(feats, pos, train=True,
                  rng=torch.Generator().manual_seed(2))
    by_mask = head(feats, pos, train=True, rng=head.dropout_masks(
        8, torch.Generator().manual_seed(2)))
    assert torch.equal(by_gen, by_mask)
    with pytest.raises(ValueError, match="torch.Generator"):
        head(feats, pos, train=True)


def test_forward_without_train_is_the_plain_chain():
    """train=False (and p = 0 in training) is Dense/LayerNorm/ReLU twice
    and the output Dense, bit for bit: no dropout arithmetic at all."""
    head = _head(0.4)
    x = torch.randn(6, 40, dtype=torch.float64)
    h = x
    for dense, norm in zip(head.dense, head.norms):
        h = torch.relu(norm(dense(h)))
    want = head.out(h)
    assert torch.equal(head(x[:, :25], x[:, 25:]), want)
    head.dropout_prob = 0.0
    assert torch.equal(head(x[:, :25], x[:, 25:], train=True), want)


def _dropout_setup(**cfg):
    """A float64 learned planner with dropout 0.3 and a training batch."""
    jp, tp, _ = learned_pair(dict(dynamics_mode="diag_identity",
                                  learn_eps=True, dropout_prob=0.3), b=3)
    planner, variables, _, th0, sdf, im = tp
    _, start, goal = world(0, 3, 32)
    batch = {"im": im, "sdf": sdf, "start": torch.tensor(start),
             "goal": torch.tensor(goal),
             "th_opt": th0 + 0.1 * torch.randn(
                 th0.shape, generator=torch.Generator().manual_seed(4),
                 dtype=th0.dtype),
             "cov_scalars": dict(qc_inv=np.eye(2), cost_sigma=0.05,
                                 epsilon_dist=0.4, k_s=0.01, k_g=0.01)}
    state = ttrain.TrainState(0, variables, ttrain.make_optimizer(
        "sgd", {"alpha": 0.01})(variables.parameters()))
    step = ttrain.make_train_step(planner, tlosses.LossWeights(
        ext_loss_weight=0.5), ttrain.TrainConfig(**cfg))
    return planner, state, step, batch


@pytest.mark.parametrize("sliding", [False, True], ids=["chunked", "sliding"])
def test_remat_gives_the_gradient_of_the_plain_step_with_dropout(sliding):
    """The checkpointed windows recompute their forward with the masks of
    the first pass: the updates equal those without remat (1e-12
    relative; only the backward's accumulation order may differ)."""
    extra = dict(tk2=3) if sliding else {}
    updates = []
    for remat in (True, False):
        _, state, step, batch = _dropout_setup(T=4, tk=2, remat=remat,
                                               **extra)
        before = convert.learned_state_to_flax(state.variables)
        state, metrics = step(state, batch, 7)
        after = convert.learned_state_to_flax(state.variables)
        updates.append(jax.tree.map(lambda a, b: a - b, after, before))
    for a, b in zip(jax.tree.leaves(updates[0]), jax.tree.leaves(updates[1])):
        assert rel(a, b) <= 1e-12
    assert any(np.abs(a).max() > 0 for a in jax.tree.leaves(updates[0]))


def test_sliding_rollout_and_recompute_see_the_same_masks(monkeypatch):
    """T=3, tk=1, tk2=2, remat: the rollout steps 0, 1, 2, the windows
    step 0 | 0, 1 | 1, 2 and recompute the same steps in the backward pass,
    each with the rollout's mask of that step; another training step draws
    other masks, the same seed and step the same ones."""
    planner, state, step, batch = _dropout_setup(T=3, tk=1, tk2=2)
    seen = []
    inner = planner.step

    def record(*args, **kw):
        seen.append(kw["rng"])
        return inner(*args, **kw)

    monkeypatch.setattr(planner, "step", record)
    state, _ = step(state, batch, 11)
    roll = seen[:3]

    def index(masks):
        hits = [t for t, m in enumerate(roll)
                if all(torch.equal(a, b) for a, b in zip(masks, m))]
        assert len(hits) == 1
        return hits[0]

    assert len(seen) == 3 + 5 + 5
    assert [index(m) for m in seen[3:8]] == [0, 0, 1, 1, 2]
    assert sorted(index(m) for m in seen[8:]) == [0, 0, 1, 1, 2]
    first = ttrain.dropout_masks(planner, state.variables, 3, 11, 0, 3)
    assert all(torch.equal(a, b) for a, b in zip(first[2], roll[2]))
    second = ttrain.dropout_masks(planner, state.variables, 3, 11, 1, 3)
    assert not torch.equal(second[0][0], roll[0][0])


# -- checkpoints ----------------------------------------------------------------

def test_checkpoints_keep_the_newest_and_restore_exactly(tmp_path):
    planner, state, step, batch = _dropout_setup(T=2, tk=1)
    for s in range(1, 5):
        state, _ = step(state, batch, 0)
        tckpt.save(tmp_path, s, state, rng={"k": s}, split={"valid": [s]},
                   max_to_keep=2)
    assert tckpt.latest_step(tmp_path) == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == ["3.pt", "4.pt"]
    assert tckpt.latest_step(tmp_path / "none") is None
    _, fresh, _, _ = _dropout_setup(T=2, tk=1)
    got, payload = tckpt.restore(tmp_path, {"state": fresh}, step=3)
    assert got == 3 and payload["state"].step == 3
    assert payload["rng"] == {"k": 3} and payload["split"] == {"valid": [3]}
    _, payload = tckpt.restore(tmp_path, {"state": fresh})
    for (k, a), b in zip(state.variables.state_dict().items(),
                         payload["state"].variables.state_dict().values()):
        assert torch.equal(a, b), k
    with pytest.raises(FileNotFoundError):
        tckpt.restore(tmp_path / "none", {"state": fresh})


# -- the CLIs -------------------------------------------------------------------

def _run_files(tmp_path, epochs, tag="learn"):
    """chip_smoke.py phase 12's run at a small size on the CPU: 6 worlds of
    32^2 x 2 problems labelled at T=8, batch 2, unroll 2 in windows of 1,
    3 GN iterations in validation; validation and a checkpoint every
    epoch."""
    data = tmp_path / "data"
    if not data.exists():
        chip_smoke.training_dataset(data, CPU, n_envs=6, probs=2, imsize=32,
                                    t=8, iters=5)
    learn = chip_smoke.eps_bounded_learn(epochs, batch=2, unroll=2, tk=1,
                                         every=1)
    return data, lambda out: chip_smoke.training_argv(
        tmp_path, data, out, learn, t=8, iters=3, device="cpu", tag=tag)


def test_train_planner_main_resumes_exactly(tmp_path):
    """Two epochs straight, and one epoch then --resume for the second: the
    same weights and optimizer state, bit for bit (the batches' shuffle
    state and the dropout masks' step are in the checkpoint); then
    test_planner.main on the run."""
    data, argv2 = _run_files(tmp_path, 2)
    state_a, hist_a = train_planner.main(argv2(tmp_path / "a"))
    _, argv1 = _run_files(tmp_path, 1, tag="learn1")
    state_b, hist_b = train_planner.main(argv1(tmp_path / "b"))
    assert len(hist_b) == 1 and "validation" in hist_b[0]
    assert tckpt.latest_step(tmp_path / "b" / "checkpoints") == 1
    state_b, hist_c = train_planner.main(argv2(tmp_path / "b") + ["--resume"])
    assert [h["epoch"] for h in hist_c] == [1]
    assert hist_c[0]["loss"] == hist_a[1]["loss"]
    assert state_a.step == state_b.step == 8
    for (k, a), b in zip(state_a.variables.state_dict().items(),
                         state_b.variables.state_dict().values()):
        assert torch.equal(a, b), k
    opt_a = state_a.optimizer.state_dict()["state"]
    opt_b = state_b.optimizer.state_dict()["state"]
    assert all(torch.equal(opt_a[i][k], opt_b[i][k])
               for i in opt_a for k in opt_a[i])
    out = tmp_path / "a"
    assert yaml.safe_load((out / "train_val_split.yaml").read_text())["valid"]
    assert len(yaml.safe_load((out / "train_losses.yaml").read_text())) == 2
    summary = test_planner.main(
        argv2(None) + ["--model_folder", str(out), "--out_file",
                       str(tmp_path / "results.yaml"), "--batch_size", "2"])
    assert summary == yaml.safe_load((tmp_path / "results.yaml").read_text())
    assert 0.0 <= summary["solve_rate"] <= 1.0
    static = test_planner.main(argv2(None) + [
        "--out_file", str(tmp_path / "static.yaml"), "--batch_size", "4"])
    assert static.keys() == summary.keys()


def test_train_initializer_main_runs(tmp_path):
    data, _ = _run_files(tmp_path, 1)
    net, history = train_initializer.main([
        "--dataset_folders", str(data), "--out_folder", str(tmp_path / "i"),
        "--epochs", "2", "--batch_size", "2", "--total_time_step", "8",
        "--valid_size", "0.25", "--device", "cpu"])
    assert [h["epoch"] for h in history] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert 0.0 <= history[-1]["valid_solve_rate"] <= 1.0
    assert (tmp_path / "i" / "init_losses.yaml").is_file()
