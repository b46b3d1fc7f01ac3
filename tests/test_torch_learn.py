"""The learned planner's port (dgpmp2_tpu_torch.models, .learn) against the
JAX package, in float64 on the CPU, with the same weights in both packages:
random weights made with numpy from a seed (``convert.seeded_flax_tree``),
carried across by ``convert``.

Tolerances.  Modules alone: 1e-10 relative (float64 on both sides, only
summation order differs).  Anything downstream of ``predict``: the head's
output is cast to float32 before the decode in both packages, so the
covariances agree exactly where the decode squares (the same float32
products), and to a float32 ulp (6e-8) where it takes a sigmoid
(``eps_max``); plans are held to 1e-9 relative without ``eps_max`` and
1e-5 with it (1e-15 seen in both).  Gradients with respect to the weights
pass backward through the float32 decode: 1e-6 (5e-8 seen).
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import EPS_BOUNDED  # the campaign's bounded-eps configuration
from dgpmp2_tpu.learn import covariances as jcov
from dgpmp2_tpu.models import conv_encoder as jconv
from dgpmp2_tpu.models import cov_head as jhead
from dgpmp2_tpu.models import init_net as jinit
from dgpmp2_tpu_torch import convert
from dgpmp2_tpu_torch.core import graph as tgraph
from dgpmp2_tpu_torch.core import multistart as tms
from dgpmp2_tpu_torch.learn import covariances as tcov
from dgpmp2_tpu_torch.learn import learned_planner as tlp
from dgpmp2_tpu_torch.models import conv_encoder as tconv
from dgpmp2_tpu_torch.models import cov_head as thead
from dgpmp2_tpu_torch.models import init_net as tinit
from dgpmp2_tpu_torch.ops import sdf as tsdf

from tests._torch_parity import (F64, flax_shapes, jnp_tree, learned_pair,
                                 np_)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
SPEC = tgraph.GraphSpec(total_time_step=10)


def rel(a, b):
    a, b = np_(a), np_(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def module_pair(jmod, tmod, *args, seed=3):
    """Random flax params for ``jmod`` at ``args`` (numpy), loaded into
    ``tmod`` (float64): (jax variables, torch module)."""
    shapes = flax_shapes(jmod.init(jax.random.PRNGKey(0),
                                   *map(jnp.asarray, args)))
    tree = convert.seeded_flax_tree(shapes, seed)
    tmod = tmod.to(F64)
    tmod.load_state_dict(convert.module_state_from_flax(tree["params"]))
    return jnp_tree(tree), tmod


@pytest.mark.parametrize("ndim", [2, 3])
def test_conv_encoder_matches_jax(ndim):
    """Flatten order (H', W', C), LayerNorm over channels with eps 1e-6."""
    rng = np.random.default_rng(ndim)
    shape = (3, 32, 32, 2) if ndim == 2 else (2, 16, 16, 16, 2)
    x = rng.standard_normal(shape)
    jmod = (jconv.ConvEncoder if ndim == 2 else jconv.ConvEncoder3D)(
        dtype=jnp.float64)
    tmod = (tconv.ConvEncoder if ndim == 2 else tconv.ConvEncoder3D)(2)
    v, tmod = module_pair(jmod, tmod, x)
    want = jmod.apply(v, jnp.asarray(x))
    got = tmod(torch.tensor(x))
    assert got.shape == want.shape == (shape[0], tmod.out_dim(shape[1:-1]))
    assert rel(got, want) <= 1e-10


def test_normalize_im_matches_jax():
    x = np.random.default_rng(0).uniform(-3, 5, (3, 8, 9, 2))
    assert rel(tconv.normalize_im(torch.tensor(x)),
               jconv.normalize_im(jnp.asarray(x))) <= 1e-12


@pytest.mark.parametrize("out_bias", [None, (0.5, -1.0, 2.0, 0.25, 3.0)])
def test_feed_forward_head_matches_jax(out_bias):
    """With ``out_bias`` the init forward pass is exactly the bias (the
    static-covariance planner); with random weights both heads agree."""
    rng = np.random.default_rng(4)
    feats, pos = rng.standard_normal((4, 40)), rng.standard_normal((4, 22))
    jmod = jhead.FeedForwardHead(out_dim=5, dtype=jnp.float64,
                                 out_bias=out_bias)
    tmod = thead.FeedForwardHead(62, 5, out_bias=out_bias)
    if out_bias is not None:
        tmod.reset_parameters(torch.Generator().manual_seed(0))
        at_init = tmod(torch.rand(4, 40), torch.rand(4, 22))
        assert torch.equal(at_init, torch.tensor(out_bias).expand(4, 5)
                           .to(at_init.dtype))
    v, tmod = module_pair(jmod, tmod, feats, pos)
    assert rel(tmod(torch.tensor(feats), torch.tensor(pos)),
               jmod.apply(v, jnp.asarray(feats), jnp.asarray(pos))) <= 1e-10


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("num_hidden", [1, 2])
def test_recurrent_head_matches_jax(cell, num_hidden):
    """Flax's cell parameter sets, the (c, h) LSTM carry, and the carry
    threaded across two calls."""
    rng = np.random.default_rng(5)
    feats, pos = rng.standard_normal((3, 30)), rng.standard_normal((3, 22))
    jmod = jhead.RecurrentHead(out_dim=7, hidden_dim=16,
                               num_hidden=num_hidden, cell_type=cell,
                               dtype=jnp.float64)
    tmod = thead.RecurrentHead(52, 7, hidden_dim=16, num_hidden=num_hidden,
                               cell_type=cell)
    carry_j = jmod.initialize_carry(jax.random.PRNGKey(0), 3, 52)
    v, tmod = module_pair(jmod, tmod, feats, pos, carry_j)
    carry_t = tmod.initialize_carry(3)
    for step in range(2):
        x_j = (jnp.asarray(feats + step), jnp.asarray(pos * (step + 1)))
        x_t = (torch.tensor(feats + step), torch.tensor(pos * (step + 1)))
        out_j, carry_j = jmod.apply(v, *x_j, carry_j)
        out_t, carry_t = tmod(*x_t, carry_t)
        assert rel(out_t, out_j) <= 1e-10
        for a, b in zip(jax.tree.leaves(carry_t), jax.tree.leaves(carry_j)):
            assert rel(a, b) <= 1e-10


def test_init_net_matches_jax():
    rng = np.random.default_rng(6)
    x, th = rng.standard_normal((2, 32, 32, 2)), rng.standard_normal((2, 11, 4))
    jmod = jinit.InitNet(num_states=11, state_dim=4, hidden=64,
                         dtype=jnp.float64)
    tmod = tinit.InitNet(2, (32, 32), 11, 4, hidden=64)
    v, tmod = module_pair(jmod, tmod, x, th)
    got = tmod(torch.tensor(x), torch.tensor(th))
    assert rel(got, jmod.apply(v, jnp.asarray(x), jnp.asarray(th))) <= 1e-10
    assert float(got[:, [0, -1]].detach().abs().max()) == 0.0


def test_flax_trees_round_trip_through_the_port():
    """learned_grads_to_flax inverts learned_state_from_flax: a tree loaded
    as parameters comes back, as gradients, leaf for leaf."""
    jp, tp, tree = learned_pair(dict(model_type="rnn_lstm", hidden_dim=8,
                                     num_hidden=2))
    variables = tp[1]
    for p in variables.parameters():
        p.grad = p.detach().clone()
    back = convert.learned_grads_to_flax(variables)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("mode", tcov.MODES)
@pytest.mark.parametrize("learn_eps,eps_max", [(False, None), (True, None),
                                               (True, 0.8)])
def test_decode_matches_jax(mode, learn_eps, eps_max):
    """out_dim and the decode in float32: equal where the decode squares,
    a float32 ulp where it takes a sigmoid."""
    n = tcov.out_dim(SPEC, mode, learn_eps)
    assert n == jcov.out_dim(SPEC, mode, learn_eps)
    out = np.random.default_rng(7).standard_normal((3, n)).astype(np.float32)
    got = tcov.decode(torch.tensor(out), SPEC, mode, learn_eps, eps_max)
    want = jcov.decode(jnp.asarray(out), SPEC, mode, learn_eps, eps_max)
    for name in tcov.DecodedCovariances._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.dtype == torch.float32
            tol = 2e-7 if name == "eps" and eps_max else 0.0
            assert rel(g, w) <= tol, name


def test_decode_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="unknown dynamics_mode"):
        tcov.decode(torch.zeros(1, 21), SPEC, "full")


@pytest.mark.parametrize("lkw", [
    dict(dynamics_mode="diag_identity"),
    dict(dynamics_mode="diag", learn_eps=True),
    dict(dynamics_mode="fix_dynamics", learn_eps=True, eps_max=0.8),
])
def test_static_out_bias_matches_jax(lkw):
    jp, tp, _ = learned_pair(lkw)
    for args in ((1.0, 0.05), (2.0, 0.02, 0.3)):
        assert np.allclose(tp[0].static_out_bias(*args),
                           jp[0].static_out_bias(*args), rtol=1e-15,
                           atol=0.0)


@pytest.mark.parametrize("mode", ["qc_full", "q_full"])
def test_static_out_bias_refuses_rank_one_modes(mode):
    cfg = tlp.LearnedPlannerConfig(dynamics_mode=mode,
                                   static_init=(1.0, 0.05))
    from dgpmp2_tpu_torch.core import gn as tgn
    from dgpmp2_tpu_torch.robots import PointRobot2D

    with pytest.raises(ValueError, match="not representable"):
        tlp.LearnedDiffGPMP2Planner(SPEC, PointRobot2D(), tgn.OptimConfig(),
                                    cfg, device="cpu")


def test_static_out_bias_refuses_eps_outside_eps_max():
    from dgpmp2_tpu_torch.core import gn as tgn
    from dgpmp2_tpu_torch.robots import PointRobot2D

    cfg = tlp.LearnedPlannerConfig(learn_eps=True, eps_max=0.8,
                                   static_init=(1.0, 0.05, 0.8))
    with pytest.raises(ValueError, match="strictly inside"):
        tlp.LearnedDiffGPMP2Planner(SPEC, PointRobot2D(), tgn.OptimConfig(),
                                    cfg, device="cpu")


@pytest.mark.parametrize("lkw", [
    dict(), dict(sdf_predict=False), dict(costmap_predict=True),
    dict(costmap_predict=True, sdf_predict=False, costmap_eps=0.3),
    dict(normalize_im=True)])
def test_stack_inputs_matches_jax(lkw):
    jp, tp, _ = learned_pair(lkw)
    got = tp[0].stack_inputs(tp[5], tp[4])
    want = jp[0].stack_inputs(jp[5], jp[4])
    assert got.shape == want.shape and rel(got, want) <= 1e-12


def test_costmap_and_safe_sdf_match_jax():
    from dgpmp2_tpu.ops import sdf as jsdf

    sdf = np.random.default_rng(8).uniform(-1, 2, (2, 9, 9))
    assert rel(tsdf.costmap_2d(torch.tensor(sdf), 0.6),
               jsdf.costmap_2d(jnp.asarray(sdf), 0.6)) == 0.0
    assert rel(tsdf.safe_sdf(torch.tensor(sdf), 0.6),
               jsdf.safe_sdf(jnp.asarray(sdf), 0.6)) == 0.0


@pytest.mark.parametrize("lkw", [EPS_BOUNDED,
                                 dict(model_type="rnn_gru", hidden_dim=16,
                                      dynamics_mode="qc_full")])
def test_predict_matches_jax(lkw):
    jp, tp, _ = learned_pair(lkw)
    pj, vj, _, thj, sdfj, imj = jp
    pt, vt, _, tht, sdft, imt = tp
    fj = pj.conv_features(vj, pj.stack_inputs(imj, sdfj))
    ft = pt.conv_features(vt, pt.stack_inputs(imt, sdft))
    assert rel(ft, fj) <= 1e-10
    hid_j = pj.init_hidden(jax.random.PRNGKey(0), 3,
                           fj.shape[-1] + thj.shape[1] * 2)
    covs_j, hid_j, _ = pj.predict(vj, thj, fj, hid_j)
    covs_t, hid_t = pt.predict(vt, tht, ft, pt.init_hidden(vt, 3))
    tol = 1e-5 if lkw.get("eps_max") else 1e-9
    for name in tcov.DecodedCovariances._fields:
        g, w = getattr(covs_t, name), getattr(covs_j, name)
        assert (g is None) == (w is None)
        if g is not None:
            assert rel(g, w) <= tol, name
    if pt.recurrent:
        assert rel(hid_t[0], hid_j[0]) <= 1e-10


@pytest.mark.parametrize("lm", [False, True])
def test_step_matches_jax(lm):
    jp, tp, _ = learned_pair(EPS_BOUNDED)
    pj, vj, parj, thj, sdfj, imj = jp
    pt, vt, part, tht, sdft, imt = tp
    fj = pj.conv_features(vj, pj.stack_inputs(imj, sdfj))
    ft = pt.conv_features(vt, pt.stack_inputs(imt, sdft))
    dj = jnp.full((3,), 1e-2) if lm else None
    dt = torch.full((3,), 1e-2, dtype=F64) if lm else None
    got = pt.step(vt, part, tht, sdft, ft, delta=dt)
    want = pj.step(vj, parj, thj, sdfj, fj, delta=dj)
    for i in range(3):
        assert rel(got[i], want[i]) <= 1e-5, i


# (name, LearnedPlannerConfig fields, method, plan kwargs)
PLAN_CASES = [
    ("ff_gn", dict(dynamics_mode="diag_identity"), "gauss_newton", {}),
    ("ff_eps_bounded_lm_best", EPS_BOUNDED, "lm",
     dict(track_best=True, return_final=True)),
    ("gru_gn_best", dict(model_type="rnn_gru", hidden_dim=16),
     "gauss_newton", dict(track_best=True)),
    ("lstm2_lm", dict(model_type="rnn_lstm", hidden_dim=8, num_hidden=2,
                      dynamics_mode="diag", learn_eps=True), "lm", {}),
    ("dtheta_costmap", dict(dtheta_predict=True, costmap_predict=True),
     "gauss_newton", dict(track_best=True)),
]


@pytest.mark.parametrize("name,lkw,method,kw", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_plan_matches_jax(name, lkw, method, kw):
    """5 iterations; GN and LM; track_best and return_final; recurrent
    carries; dtheta_predict."""
    jp, tp, _ = learned_pair(lkw, method=method)
    pj, vj, parj, thj, sdfj, imj = jp
    pt, vt, part, tht, sdft, imt = tp
    want = pj.plan(vj, parj, thj, sdfj, imj, **kw)
    got = pt.plan(vt, part, tht, sdft, imt, **kw)
    assert len(got) == len(want)
    tol = 1e-5 if lkw.get("eps_max") else 1e-9
    for i in (0, 1, 2) + ((4,) if kw.get("return_final") else ()):
        assert got[i].shape == want[i].shape
        assert rel(got[i], want[i]) <= tol, (name, i)
    if pt.recurrent:
        for a, b in zip(jax.tree.leaves(got[3]), jax.tree.leaves(want[3])):
            assert rel(a, b) <= tol


@pytest.mark.parametrize("lkw", [dict(learn_eps=True),
                                 dict(model_type="rnn_lstm", hidden_dim=8)],
                         ids=["feed_forward", "lstm"])
def test_plan3d_matches_jax(lkw):
    """The 3-D learned plan (ConvEncoder3D over 16^3 voxel stacks, xyz
    positions into the head) under LM, 5 iterations with track_best."""
    jp, tp, _ = learned_pair(lkw, method="lm", three_d=True, n=16)
    pj, vj, parj, thj, sdfj, imj = jp
    pt, vt, part, tht, sdft, imt = tp
    want = pj.plan(vj, parj, thj, sdfj, imj, track_best=True)
    got = pt.plan(vt, part, tht, sdft, imt, track_best=True)
    for i in range(3):
        assert got[i].shape == want[i].shape
        assert rel(got[i], want[i]) <= 1e-9, i


@pytest.mark.parametrize("lkw", [EPS_BOUNDED,
                                 dict(model_type="rnn_gru", hidden_dim=16,
                                      learn_eps=True)],
                         ids=["feed_forward", "gru"])
def test_plan_gradients_match_jax(lkw):
    """d(Σ err_ext + Σ th²)/d(every weight) through 3 unrolled iterations
    (the K-BTD adjoint and the lookups' replay on the card), tree against
    tree."""
    jp, tp, _ = learned_pair(lkw, max_iters=3)
    pj, vj, parj, thj, sdfj, imj = jp
    pt, vt, part, tht, sdft, imt = tp

    def loss_j(v):
        th, _, errs_ext, _ = pj.plan(v, parj, thj, sdfj, imj)
        return jnp.sum(errs_ext) + jnp.sum(th ** 2)

    gj = jax.grad(loss_j)(vj)
    th, _, errs_ext, _ = pt.plan(vt, part, tht, sdft, imt)
    (errs_ext.sum() + (th ** 2).sum()).backward()
    gt = convert.learned_grads_to_flax(vt)
    assert jax.tree.structure(gt) == jax.tree.structure(gj)
    # The decode's backward runs in float32 in both packages (5e-8 seen).
    tol = 1e-6
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(gt),
                            jax.tree.leaves(gj)):
        assert rel(a, b) <= tol, path


@pytest.mark.parametrize("staged", [False, True])
def test_plan_multistart_matches_jax(staged, monkeypatch):
    """Full and staged multistart of the learned planner, the JAX package's
    normal draws fed to the port's perturbation (the two generators differ),
    K=4 restarts; a GRU head, so the staged carry gather is covered."""
    jp, tp, _ = learned_pair(dict(model_type="rnn_gru", hidden_dim=8),
                             max_iters=4)
    pj, vj, parj, thj, sdfj, imj = jp
    pt, vt, part, tht, sdft, imt = tp
    key, k = jax.random.PRNGKey(5), 4
    z = np_(jax.random.normal(key, (k, 3, 3, 2), jnp.float64))
    monkeypatch.setattr(
        tms, "perturbed_inits",
        lambda th0, gen, restarts, amp, total, harmonics=3:
        tms.inits_from_normals(th0, torch.tensor(z), amp, total))
    kw = dict(restarts=k, amp=1.5, prune_iters=2, keep=2) if staged else \
        dict(restarts=k, amp=1.5)
    want = pj.plan_multistart(vj, parj, thj, sdfj, imj, key, **kw)
    got = pt.plan_multistart(vt, part, tht, sdft, imt,
                             torch.Generator().manual_seed(0), **kw)
    assert isinstance(got, tms.MultistartResult)
    assert np.array_equal(np_(got.k_best), np_(want.k_best))
    assert np.array_equal(np_(got.contact_free), np_(want.contact_free))
    assert rel(got.th, want.th) <= 1e-9
    assert rel(got.score, want.score) <= 1e-9


def test_plan_multistart_refuses_bad_staging():
    jp, tp, _ = learned_pair(dict(), max_iters=4)
    pt, vt, part, tht, sdft, imt = tp
    with pytest.raises(ValueError, match="staged pruning"):
        pt.plan_multistart(vt, part, tht, sdft, imt,
                           torch.Generator().manual_seed(0), restarts=2,
                           prune_iters=4, keep=1)


def test_planner_without_device_refuses_a_host_without_a_card():
    """Entry points run on the card unless device="cpu" is given: with no
    card, the first tensor made raises (no CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from dgpmp2_tpu_torch.core import gn as tgn
    from dgpmp2_tpu_torch.robots import PointRobot2D

    planner = tlp.LearnedDiffGPMP2Planner(SPEC, PointRobot2D(),
                                          tgn.OptimConfig(),
                                          tlp.LearnedPlannerConfig())
    assert planner.device.type == "cuda"
    with pytest.raises((RuntimeError, AssertionError)):
        planner.init_variables(torch.Generator().manual_seed(0),
                               torch.zeros(1, 32, 32, 2),
                               torch.zeros(1, 11, 4))


def test_init_variables_are_reproducible_and_static_at_init():
    """init_variables draws from an explicit generator; at static init the
    head emits the static covariances, whatever the features."""
    jp, tp, _ = learned_pair(EPS_BOUNDED)
    pt, _, part, tht, sdft, imt = tp
    stack = pt.stack_inputs(imt, sdft)
    a = pt.init_variables(torch.Generator().manual_seed(1), stack, tht)
    b = pt.init_variables(torch.Generator().manual_seed(1), stack, tht)
    for (n, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), n
    covs, _ = pt.predict(a, tht, pt.conv_features(a, stack))
    assert torch.all(covs.obs_inv == torch.tensor(1e4, dtype=torch.float32))
    assert torch.all(covs.eps == torch.tensor(0.4, dtype=torch.float32))


def test_learned_modules_import_without_jax():
    code = ("import sys, dgpmp2_tpu_torch.learn.learned_planner, "
            "dgpmp2_tpu_torch.models.init_net, dgpmp2_tpu_torch.convert\n"
            "assert not any(m.split('.')[0] in ('jax', 'flax', 'dgpmp2_tpu') "
            "for m in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_learned_golden_replays():
    """The JAX package's learned golden (feed-forward under GN with
    track_best, GRU under LM; float64), replayed on the CPU as chip_smoke.py
    replays it on the card: 1e-8 relative."""
    errs = chip_smoke.learned_golden_errors(torch.device("cpu"))
    assert set(errs) == {"ff", "gru"}
    for case, e in errs.items():
        assert all(v <= 1e-8 for v in e.values()), (case, e)
    assert chip_smoke.GOLDEN_LEARNED.stat().st_size < 1_000_000
