"""The port's mesh execution against the unsharded port and the JAX
package, float64 on meshes of repeated CPU devices: the feed-forward head's
tensor-parallel forward (``models.cov_head.TensorParallelHead``, Megatron's
column/row split with the LayerNorm statistics summed over ``model``), the
learned plan on sharded weights, the data-parallel training step
(``learn.train.make_train_step(mesh=)``) and ``sharding.shard_state`` /
``unshard_state``.  The two-process runs are in
``tests/test_torch_multiprocess.py``.

Tolerances: the head, the plan and the joined state to 1e-12 (the shards
sum in another order than one device, nothing else differs); a training
step's loss, metrics and each leaf's update to 1e-10 relative (the head's
output decoded in float64 on both sides, as ``test_torch_train_paths.py``
does, since a float32 decode rounds a 1e-16 difference upstream to 1e-8).
"""
import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dgpmp2_tpu.learn import learned_planner as jlp_mod
from dgpmp2_tpu.learn import train as jtrain
from dgpmp2_tpu.learn.losses import LossWeights as JWeights
from dgpmp2_tpu.models.cov_head import FeedForwardHead as JHead
from dgpmp2_tpu_torch import convert
from dgpmp2_tpu_torch.learn import train as ttrain
from dgpmp2_tpu_torch.learn.losses import LossWeights as TWeights
from dgpmp2_tpu_torch.models.cov_head import (FeedForwardHead,
                                              TensorParallelHead)
from dgpmp2_tpu_torch.parallel import sharding as tsh

from _torch_parity import (BOUNDED, COV, WEIGHTS, _Float64Jnp,
                           check_train_step, learned_pair, np_, world)

torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64
MESHES = {"(2,1)": (2, 1), "(2,2)": (2, 2), "(4,2)": (4, 2)}


def mesh_of(shape):
    data, mp = shape
    return tsh.make_mesh([CPU] * (data * mp), model_parallel=mp)


@contextlib.contextmanager
def float64_jax():
    """The JAX package's ``jnp.float32`` read as float64 in its
    ``learn.train`` and ``learn.learned_planner`` (the seed trajectory,
    the fixed covariances and the decode), as ``_torch_parity.train_pair``
    patches them."""
    saved = jtrain.jnp, jlp_mod.jnp
    jtrain.jnp = jlp_mod.jnp = _Float64Jnp()
    try:
        yield
    finally:
        jtrain.jnp, jlp_mod.jnp = saved


# -- the tensor-parallel head -------------------------------------------------

IN, OUT, B = 230, 37, 6


def heads(seed=0):
    """The flax head's variables (numpy, random about its init) and the
    port's replicated head holding them, in float64, with the inputs and an
    output cotangent."""
    rng = np.random.default_rng(seed)
    jhead = JHead(OUT, dropout_prob=0.3, dtype=jnp.float64)
    x = (rng.standard_normal((B, IN - 40)), rng.standard_normal((B, 40)))
    shapes = jax.tree.map(lambda a: list(np.shape(a)), jhead.init(
        jax.random.PRNGKey(0), *map(jnp.asarray, x))["params"])
    tree = convert.seeded_flax_tree({"params": shapes}, seed)["params"]
    head = FeedForwardHead(IN, OUT, dropout_prob=0.3).to(F64)
    head.load_state_dict(convert.module_state_from_flax(tree))
    cot = rng.standard_normal((B, OUT))
    return jhead, tree, head, x, cot


def tp_of(head, mp):
    """The head sharded over a (1, mp) mesh and its TensorParallelHead."""
    sp = tsh.shard_params(torch.nn.ModuleDict({"head": head}),
                          mesh_of((1, mp)))
    return sp, TensorParallelHead([s["head"] for s in sp.group(0)])


def tp_grads(sp):
    """Every parameter's gradient, reduced and joined, as a flax tree."""
    tsh.reduce_grads(sp)
    return convert.module_grads_to_flax(tsh.join_params(sp)["head"])


def rel(a, b):
    a, b = np_(a), np_(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("mp", [1, 2, 4])
def test_tp_head_matches_the_flax_head(mp):
    """Forward, every parameter's gradient and the input's, at 1000 hidden
    units split over ``mp`` model devices, against flax on the same
    weights."""
    jhead, tree, head, (f, pos), cot = heads()

    def loss(params, f, pos):
        return jnp.sum(jhead.apply({"params": params}, f, pos) * cot)

    want = jhead.apply({"params": tree}, jnp.asarray(f), jnp.asarray(pos))
    g_params, g_f = jax.grad(loss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(f), jnp.asarray(pos))
    sp, tp = tp_of(head, mp)
    ft = torch.tensor(f, requires_grad=True)
    out = tp(ft, torch.tensor(pos))
    assert rel(out, want) <= 1e-12
    (out * torch.tensor(cot)).sum().backward()
    assert rel(ft.grad, g_f) <= 1e-12
    got = tp_grads(sp)
    paths = jax.tree_util.tree_leaves_with_path(g_params)
    assert len(paths) == 10
    for (path, g), t in zip(paths, jax.tree.leaves(got)):
        assert rel(t, g) <= 1e-12, path


@pytest.mark.parametrize("mp", [2, 4])
def test_tp_head_with_dropout_matches_the_replicated_head(mp):
    """Training with the whole batch's masks: the input and 640 masks
    replicated, the 1000 mask's column slice on each model device; forward
    and gradients equal the replicated head's."""
    _, _, head, (f, pos), cot = heads(1)
    masks = head.dropout_masks(B, torch.Generator().manual_seed(5))
    f, pos, cot = map(torch.tensor, (f, pos, cot))
    out = head(f, pos, train=True, rng=masks)
    (out * cot).sum().backward()
    want = convert.module_grads_to_flax(head)
    sp, tp = tp_of(copy.deepcopy(head), mp)
    got_out = tp(f, pos, train=True, rng=masks)
    assert rel(got_out, out) <= 1e-12
    (got_out * cot).sum().backward()
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(tp_grads(sp))):
        assert rel(g, w) <= 1e-12


def test_tp_head_sums_layernorm_statistics_over_model(monkeypatch):
    """The wide LayerNorm's statistics cross the model axis as one (B, 2)
    sum of x and x² per device (an all-reduce: a sum onto the first device
    and a copy back), and the hidden layer is never gathered: the only
    other reduction is the (B, 640) partial product's."""
    _, _, head, (f, pos), _ = heads()
    sp, tp = tp_of(head, 4)
    seen = []
    for name in ("all_reduce", "sum_to"):
        fn = getattr(tsh, name)
        monkeypatch.setattr(tsh, name, lambda xs, fn=fn, name=name: (
            seen.append((name, [tuple(x.shape) for x in xs])) or fn(xs)))
    tp(torch.tensor(f), torch.tensor(pos))
    assert seen == [("all_reduce", [(B, 2)] * 4), ("sum_to", [(B, 2)] * 4),
                    ("sum_to", [(B, 640)] * 4)]


@pytest.mark.parametrize("mp", [3, 6, 7])
def test_a_model_axis_that_does_not_divide_the_width_raises(mp):
    _, _, head, _, _ = heads()
    with pytest.raises(ValueError, match="not divisible by model_parallel"):
        tp_of(head, mp)


def test_shard_params_holds_slices_and_replicas():
    """(2, 2): each device holds its slice of the split tensors and a
    replica of the rest; joined back, the module is the original."""
    _, _, head, _, _ = heads()
    mods = torch.nn.ModuleDict({"head": head})
    sp = tsh.shard_params(mods, mesh_of((2, 2)))
    w0, w1 = head.dense[0].weight, head.dense[1].weight
    for k in range(4):
        j = k % 2
        named = sp.named(k)
        assert torch.equal(named["head.dense.0.weight"],
                           w0[500 * j:500 * (j + 1)])
        assert torch.equal(named["head.dense.0.bias"],
                           head.dense[0].bias[500 * j:500 * (j + 1)])
        assert torch.equal(named["head.dense.1.weight"],
                           w1[:, 500 * j:500 * (j + 1)])
        assert torch.equal(named["head.norms.0.weight"], head.norms[0].weight)
        assert named["head.out.weight"] is not head.out.weight
    joined = tsh.join_params(sp)
    for (n, a), (_, b) in zip(joined.state_dict().items(),
                              mods.state_dict().items()):
        assert torch.equal(a, b), n


# -- the learned planner on a mesh -------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_plan_matches_the_unsharded_plan_and_jax(mesh):
    """``plan`` on sharded weights (4 rows, track_best, the final iterate
    too) against the unsharded plan and JAX's, the head's output decoded in
    float64 on every side (a float32 decode rounds the TP head's other
    summation order to 1e-8)."""
    (pj, vj, paj, thj, sdfj, imj), (pt, vt, pat, tht, sdft, imt), _ = (
        learned_pair(BOUNDED, b=4, t=6, n=16))
    chip_smoke.decode_in_float64(pt)
    want = pt.plan(vt, pat, tht, sdft, imt, track_best=True,
                   return_final=True)
    sp = tsh.shard_params(vt, mesh_of(MESHES[mesh]))
    got = pt.plan(sp, pat, tht, sdft, imt, track_best=True,
                  return_final=True)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.shape == w.shape and rel(g, w) <= 1e-12
    with float64_jax():
        th_j, errs_j, *_ = pj.plan(vj, paj, thj, sdfj, imj, track_best=True)
    assert rel(got[0], th_j) <= 1e-12 and rel(got[1], errs_j) <= 1e-12


# -- the data-parallel training step ------------------------------------------

SGD = ("sgd", {"alpha": 0.01, "momentum": 0.9, "nesterov": True})
ADAM = ("adam", {"alpha": 1e-3})
# path -> (LearnedPlannerConfig fields, TrainConfig fields, method,
# optimizer, compared with JAX).  "clipped" binds the clip (‖g‖ ≫ 0.05);
# "dropout" draws masks, which jax.random cannot give torch: it is held to
# the port's unsharded step alone, as is "adam".
DROPOUT = dict(BOUNDED, dropout_prob=0.3)
PATHS = {
    "clipped": (BOUNDED, dict(T=2, tk=1, clip_val=0.05), "gauss_newton",
                SGD, True),
    "optimize_tk": (BOUNDED, dict(T=2, tk=1, optimize_tk=True,
                                  clip_val=0.05), "gauss_newton", SGD, True),
    "lm": (BOUNDED, dict(T=2, tk=1), "lm", SGD, True),
    "dropout": (DROPOUT, dict(T=2, tk=1, clip_val=0.05), "gauss_newton",
                SGD, False),
    "dropout optimize_tk": (DROPOUT, dict(T=2, tk=1, optimize_tk=True),
                            "gauss_newton", SGD, False),
    "adam": (DROPOUT, dict(T=2, tk=1), "gauss_newton", ADAM, False),
    # No TP rule matches the recurrent head: it stays replicated.
    "gru": (dict(model_type="rnn_gru", hidden_dim=8, learn_eps=True,
                 static_init=(1.0, 0.05, 0.4)), dict(T=2, tk=1),
            "gauss_newton", SGD, True),
}
BATCH = 5  # over 2 shards 3 + 2 rows, over 4 shards 2 + 1 + 1 + 1
_DONE = {}


def reference_steps(path):
    """One step of ``path`` in JAX (where compared) and in the port
    unsharded, from the same float64 weights and a fresh optimizer: (the
    port's planner, batch and weights before as a flax tree, then the
    metrics and weights after of JAX (or None) and of the port).  Cached
    per path: every mesh is held to the same references."""
    if path in _DONE:
        return _DONE[path]
    lkw, cfg, method, opt, with_jax = PATHS[path]
    jp, tp, tree = learned_pair(lkw, b=BATCH, t=6, n=16, method=method)
    pj, vj, _, thj, sdfj, imj = jp
    pt, vt, _, tht, sdft, imt = tp
    chip_smoke.decode_in_float64(pt)
    _, start, goal = world(0, BATCH, 16)
    th_opt = np_(tht) + 0.1 * np.random.default_rng(1).standard_normal(
        tuple(tht.shape))
    jax_out = None
    if with_jax:
        with float64_jax():
            tx = jtrain.make_optimizer(*opt)
            state = jtrain.TrainState(step=jnp.zeros((), jnp.int32),
                                      variables=vj, opt_state=tx.init(vj))
            step_j = jtrain.make_train_step(pj, tx, JWeights(**WEIGHTS),
                                            jtrain.TrainConfig(**cfg))
            state_j, m_j = step_j(state, {
                "im": imj, "sdf": sdfj, "start": jnp.asarray(start),
                "goal": jnp.asarray(goal), "th_opt": jnp.asarray(th_opt),
                "cov_scalars": COV}, jax.random.PRNGKey(0))
        jax_out = (m_j, jax.tree.map(np.asarray, state_j.variables))
    batch = {"im": imt, "sdf": sdft, "start": torch.tensor(start),
             "goal": torch.tensor(goal), "th_opt": torch.tensor(th_opt),
             "cov_scalars": COV}
    before = convert.learned_state_to_flax(vt)
    start_vars = copy.deepcopy(vt)
    state_t = ttrain.TrainState(0, vt, ttrain.make_optimizer(*opt)(
        vt.parameters()))
    step_t = ttrain.make_train_step(pt, TWeights(**WEIGHTS),
                                    ttrain.TrainConfig(**cfg))
    _, m_t = step_t(state_t, batch, 7)
    _DONE[path] = (pt, batch, start_vars, before, jax_out,
                   (m_t, convert.learned_state_to_flax(vt)))
    return _DONE[path]


def sharded_step(path, mesh):
    """The same step on ``mesh``: (metrics, the state after)."""
    lkw, cfg, method, opt, _ = PATHS[path]
    pt, batch, start_vars, _, _, _ = reference_steps(path)
    variables = copy.deepcopy(start_vars)
    state = tsh.shard_state(ttrain.TrainState(0, variables,
                                              ttrain.make_optimizer(*opt)(
                                                  variables.parameters())),
                            mesh)
    step = ttrain.make_train_step(pt, TWeights(**WEIGHTS),
                                  ttrain.TrainConfig(**cfg), mesh=mesh)
    state, metrics = step(state, batch, 7)
    assert state.step == 1
    return metrics, state


def assert_replicas_equal(state):
    """Every device holding a part of a parameter holds the same bits of
    it, and of its optimizer state."""
    sp, opt = state.variables, state.opt_state
    for name in sp.specs:
        for group in tsh.holders(sp, name):
            ref = sp.named(group[0])[name]
            for k in group[1:]:
                assert torch.equal(sp.named(k)[name], ref), (name, k)
            for key in (k for k in opt.specs if k.startswith(name + ".")):
                for k in group[1:]:
                    assert torch.equal(opt.named(k)[key],
                                       opt.named(group[0])[key]), key


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("path", list(PATHS))
def test_sharded_train_step_matches_the_unsharded_steps(path, mesh):
    """Loss, metrics and every updated weight joined back from its shards
    against the port's unsharded step and JAX's, at 1e-10; the replicas
    bit-equal after the step."""
    _, _, _, before, jax_out, (m_t, after_t) = reference_steps(path)
    metrics, state = sharded_step(path, mesh_of(MESHES[mesh]))
    after = convert.learned_sharded_to_flax(state.variables)
    total = len(jax.tree.leaves(before))
    if PATHS[path][3] is ADAM:
        # Adam's step g/√v is ~lr wherever g ≠ 0, however small g is: a
        # rounding of a tiny gradient moves its update by up to ~1e-10 of
        # lr, so the updated weights, not the updates, are held to 1e-10.
        assert set(metrics) == set(m_t)
        for k in m_t:
            assert abs(float(metrics[k]) / float(m_t[k]) - 1) <= 1e-10, k
        for a, b in zip(jax.tree.leaves(after), jax.tree.leaves(after_t)):
            assert rel(a, b) <= 1e-10
    else:
        assert check_train_step(m_t, metrics, before, after_t, after,
                                tol_loss=1e-10, tol_update=1e-10) == total
    if jax_out is not None:
        m_j, after_j = jax_out
        check_train_step(m_j, metrics, before, after_j, after,
                         tol_loss=1e-10, tol_update=1e-10)
    if "clip_val" in PATHS[path][1] and "grad_norm" in metrics:
        assert float(metrics["grad_norm"]) > 20 * 0.05  # the clip binds
    assert_replicas_equal(state)


def test_per_shard_dropout_masks_would_change_the_step():
    """The dropout case above would catch masks drawn per shard: a step
    whose shards draw their own masks (from the same seeds, at their own
    row counts) moves the weights away from the unsharded step's."""
    pt, batch, start_vars, before, _, (_, after_t) = reference_steps(
        "dropout")
    draw = ttrain.dropout_masks
    mesh = mesh_of(MESHES["(2,2)"])

    def per_shard(planner, variables, b, seed, step, n):
        masks = [draw(planner, variables, hi - lo, seed, step, n)
                 for lo, hi in tsh.row_bounds(b, mesh)]
        return [tuple(torch.cat(ks) for ks in zip(*m)) for m in zip(*masks)]

    ttrain.dropout_masks = per_shard
    try:
        _, state = sharded_step("dropout", mesh)
    finally:
        ttrain.dropout_masks = draw
    after = convert.learned_sharded_to_flax(state.variables)
    worst = max(rel(a - b, c - b) for a, b, c in zip(
        jax.tree.leaves(after), jax.tree.leaves(before),
        jax.tree.leaves(after_t)))
    assert worst > 1e-3


def test_a_per_device_clip_norm_would_change_the_step():
    """The clipped case above would catch a norm taken on one device's
    shards only: on (2, 2) the first device holds half of each split
    tensor, and its norm scales the step by another factor."""
    metrics, state = sharded_step("clipped", mesh_of(MESHES["(2,2)"]))
    sp = state.variables
    own = torch.sqrt(sum(torch.sum(p.grad ** 2)
                         for p in sp.shards[0].parameters()))
    assert abs(float(own) / float(metrics["grad_norm"]) - 1) > 1e-3


def test_sharded_weights_cross_to_flax_and_back():
    """``convert.learned_sharded_from_flax`` shards the flax tree over a
    (2, 2) mesh, and ``learned_sharded_to_flax`` gives it back exactly."""
    _, (planner, _, _, th, sdf, im), tree = learned_pair(BOUNDED, b=2, t=6,
                                                         n=16)
    sp = convert.learned_sharded_from_flax(
        tree, planner, planner.stack_inputs(im, sdf), th, mesh_of((2, 2)))
    assert sp.named(1)["head.dense.0.weight"].shape[0] == 500
    back = convert.learned_sharded_to_flax(sp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_shard_state_joined_back_equals_the_original(mesh):
    """Adam's state after a step, sharded and joined back: every weight and
    moment bit-equal, the step count kept."""
    _, (planner, variables, _, th, sdf, im), _ = learned_pair(BOUNDED, b=2,
                                                              t=6, n=16)
    opt = torch.optim.Adam(variables.parameters(), 1e-3)
    for p in variables.parameters():
        p.grad = torch.full_like(p, 0.5) + 0.01 * p.detach()
    opt.step()
    state = tsh.unshard_state(tsh.shard_state(
        ttrain.TrainState(3, variables, opt), mesh_of(MESHES[mesh])))
    assert state.step == 3
    for (n, a), (_, b) in zip(state.variables.state_dict().items(),
                              variables.state_dict().items()):
        assert torch.equal(a, b), n
    got, want = state.optimizer.state_dict(), opt.state_dict()
    assert got["param_groups"] == want["param_groups"]
    for i, st in want["state"].items():
        for key, v in st.items():
            assert torch.equal(got["state"][i][key], v), (i, key)
