"""dgpmp2_tpu_torch.tools.arm_campaign and arm_multistart_eval against the
JAX tools, on the CPU.

The world sampler, the configuration sampler and the numpy FK are held
bit-equal to the JAX tool's own functions, the numpy generator's state
included.  In float64: ``gen_problems`` (n=4, chunks of 8 worlds; the
expert is multistart LM with JAX's normals of the tool's keys) against
the JAX tool's procedure built from the JAX package (worlds, starts and
goals equal, SDFs to 1e-6, labels to 1e-6: 60 LM iterations put them
3.1e-8 apart); the static sweep's per-sigma rows (rates equal, the rest to
1e-8); ``eval_learned`` on weights carried across by ``convert``;
``eval_static_ms`` and ``eval_learned_ms``; both heads decoded in float64.

Plain GN on the arm is chaotic where the obstacle factor is stiff: at
sigma = 0.01 the packages' float64 plans agree to 4.5e-10 after 5
iterations and part by 2.9e-3 after 50 (the gap grows ~6e6-fold over
45 iterations), while at sigma >= 0.05 they agree to 1e-12 throughout.  So
the sweep is compared at the tool's 50 iterations from sigma = 0.05 up and
at 5 iterations (``arm_campaign.ITERS``) at every sigma, and the learned
and multistart evaluations at 5.  Both tools' ``main`` run end to end,
their YAMLs keyed as the JAX tool's committed ones.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dgpmp2_tpu.core import gn as jgn
from dgpmp2_tpu.core import graph as jgraph
from dgpmp2_tpu.core import multistart as jms
from dgpmp2_tpu.learn import learned_planner as jlp_mod
from dgpmp2_tpu.learn.eval import evaluate_batch as j_evaluate
from dgpmp2_tpu.ops import sdf as jsdf
from dgpmp2_tpu.robots import PlanarArm2Link as JArm
from dgpmp2_tpu_torch import convert
from dgpmp2_tpu_torch.tools import arm_campaign as ac
from dgpmp2_tpu_torch.tools import arm_multistart_eval as ame

from _torch_parity import _Float64Jnp
from _torch_tools import (ARGS, F64, close, j_batches, j_learned_planner,
                          j_line, j_merged, j_params, j_static_rows,
                          jax_normals, jax_tool, learned_weights, np_,
                          same_summary)

torch.set_num_threads(1)
CHAOS_ITERS = 5
ARM_J = JArm(link_lengths=(2.5, 2.0), spheres_per_link=3,
             sphere_radii=(0.25,) * 6)
SPEC_J = jgraph.GraphSpec(total_time_step=ac.T_STEP, nlinks=ARM_J.nlinks)
SPEC_T = ac.arm_spec()
LEARNED = dict(learn_eps=True, eps_max=2 * ac.COV["epsilon_dist"],
               static_init=(1.0, 0.05, ac.COV["epsilon_dist"]))


def jt():
    return jax_tool("arm_campaign")


def j_gen_problems(n, seed, chunk, restarts=8, amp=1.2):
    """The JAX tool's ``gen_problems`` in float64 (its SDFs float32, as the
    tool's): (problems, the multistart keys it used)."""
    tool = jt()
    rng = np.random.default_rng(seed)
    margin = ARM_J.sphere_radii[0] + tool.COV["epsilon_dist"] + 0.06
    cfg = jgn.OptimConfig(reg=0.1, max_iters=60, method="lm")
    ms_rng, keys = jax.random.PRNGKey(seed), []
    plan = jax.jit(lambda p, th0, s, r: jms.plan_multistart(
        SPEC_J, ARM_J, p, th0, s, cfg, r, restarts=restarts, amp=amp))
    out = {k: [] for k in ac.KEYS}
    kept = 0
    while kept < n:
        ims, starts, goals = [], [], []
        while len(ims) < chunk:
            img = tool.gen_world(rng)
            sdf_np = np.asarray(jsdf.sdf_from_occupancy(
                jnp.asarray(img)[None], res=tool.RES)[0])
            qs = tool.sample_config(rng, sdf_np, margin)
            if qs is None:
                continue
            qg = tool.sample_config(rng, sdf_np, margin, avoid=qs)
            if qg is None:
                continue
            ims.append(img)
            starts.append(np.concatenate([qs, [0.0, 0.0]]))
            goals.append(np.concatenate([qg, [0.0, 0.0]]))
        sdfb = jsdf.sdf_from_occupancy(jnp.asarray(np.stack(ims)),
                                       res=tool.RES)
        b = {"start": jnp.asarray(np.stack(starts).astype(np.float32),
                                  jnp.float64),
             "goal": jnp.asarray(np.stack(goals).astype(np.float32),
                                 jnp.float64)}
        keys.append(ms_rng)
        res = plan(j_params(SPEC_J, ARM_J, b, tool.COV), j_line(SPEC_J, b),
                   sdfb.astype(jnp.float64), ms_rng)
        ms_rng = jax.random.fold_in(ms_rng, kept)
        ok = np.asarray(res.contact_free) & np.isfinite(
            np.asarray(res.th).reshape(len(ims), -1)).all(-1)
        out["im"].append(np.stack(ims)[ok])
        out["sdf"].append(np.asarray(sdfb)[ok])
        out["start"].append(np.stack(starts)[ok].astype(np.float32))
        out["goal"].append(np.stack(goals)[ok].astype(np.float32))
        out["th_opt"].append(np.asarray(res.th)[ok])
        kept += int(ok.sum())
    return {k: np.concatenate(v)[:n] for k, v in out.items()}, keys


@pytest.fixture(scope="module")
def problems():
    want, keys = j_gen_problems(4, 777, 8)
    with jax_normals(keys):
        got = ac.gen_problems(4, 777, SPEC_T, chunk=8, device="cpu",
                              dtype=F64)
    return got, want


def test_the_constants_equal_the_jax_tools():
    tool = jt()
    assert (ac.LIMS, ac.IM, ac.RES, ac.T_STEP, ac.SIGMAS) == (
        tool.LIMS, tool.IM, tool.RES, tool.T_STEP, tool.SIGMAS)
    for f in ("link_lengths", "spheres_per_link", "sphere_radii", "nlinks"):
        assert getattr(ac.ARM, f) == getattr(tool.ARM, f), f
    assert ac.COV.keys() == tool.COV.keys()
    for k, v in tool.COV.items():
        np.testing.assert_array_equal(ac.COV[k], v)
    assert ame.SIGMAS_MS == jax_tool("arm_multistart_eval").SIGMAS_MS


def test_fk_and_pixels_equal_the_jax_tools():
    q = np.random.default_rng(0).uniform(-3, 3, (7, 5, 2))
    np.testing.assert_array_equal(ac.fk_np(q), jt().fk_np(q))
    pts = np.random.default_rng(1).uniform(-5, 5, (9, 2))
    for a, b in zip(ac.world_to_pix(pts), jt().world_to_pix(pts)):
        np.testing.assert_array_equal(a, b)


def test_world_and_config_draws_equal_the_jax_tools():
    ra, rb = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(6):
        img = ac.gen_world(ra)
        np.testing.assert_array_equal(img, jt().gen_world(rb))
        sdf = np_(ac.world_sdf(img, "cpu"))
        np.testing.assert_allclose(sdf, np.asarray(jsdf.sdf_from_occupancy(
            jnp.asarray(img)[None], res=ac.RES)[0]), rtol=0, atol=1e-6)
        qs = ac.sample_config(ra, sdf, 0.51)
        assert np.array_equal(qs, jt().sample_config(rb, sdf, 0.51))
        if qs is not None:
            qg = ac.sample_config(ra, sdf, 0.51, avoid=qs)
            assert np.array_equal(qg, jt().sample_config(rb, sdf, 0.51,
                                                         avoid=qs))
        assert ra.bit_generator.state == rb.bit_generator.state


def test_gen_problems_matches_jax(problems):
    got, want = problems
    assert sorted(got) == sorted(want) == sorted(ac.KEYS)
    for k in ("im", "start", "goal"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["sdf"], want["sdf"], rtol=0, atol=1e-6)
    close(got["th_opt"], want["th_opt"], tol=1e-6, what="th_opt")


@pytest.mark.parametrize("iters", [ac.ITERS, CHAOS_ITERS])
def test_static_sweep_matches_jax(problems, tmp_path, monkeypatch, iters):
    got_p, _ = problems
    monkeypatch.setattr(ac, "ITERS", iters)
    got = ac.static_sweep(SPEC_T, got_p, 4, str(tmp_path / "s.yaml"), "cpu",
                          F64)
    sigmas = [s for s in ac.SIGMAS if iters == CHAOS_ITERS or s >= 0.05]
    want = j_static_rows(SPEC_J, ARM_J, j_batches(ac.batches_on(
        got_p, 4, "cpu", F64)), sigmas, ac.COV, iters=iters)
    for s in sigmas:
        same_summary(got[s], want[s], f"sigma {s}")


def arm_pair(test):
    """The arm's learned planner in both packages on random weights about
    its static initialisation; both heads decode in float64 (JAX's through
    the patch the caller applies)."""
    tb = ac.batches_on(test, 4, "cpu", F64)
    jb = j_batches(tb)
    pj = j_learned_planner(SPEC_J, ARM_J, dict(
        dynamics_mode="diag_identity", dropout_prob=0.1, **LEARNED),
        iters=ac.ITERS)
    tree = learned_weights(pj, pj.stack_inputs(jb[0]["im"], jb[0]["sdf"]),
                           jb[0]["th_opt"])
    pt = ac.make_planner(LEARNED, "cpu", F64)
    vt = pt.load_variables(convert.learned_state_from_flax(tree),
                           pt.stack_inputs(tb[0]["im"], tb[0]["sdf"]),
                           tb[0]["th_opt"])
    chip_smoke.decode_in_float64(pt)
    return pj, jax.tree.map(jnp.asarray, tree), jb, pt, vt


def test_eval_learned_matches_jax(problems, monkeypatch):
    got_p, _ = problems
    monkeypatch.setattr(jlp_mod, "jnp", _Float64Jnp())
    monkeypatch.setattr(ac, "ITERS", CHAOS_ITERS)
    pj, vj, jb, pt, vt = arm_pair(got_p)
    got = ac.eval_learned(pt, type("S", (), {"variables": vt}), pt.spec,
                          got_p, 4)
    plan = jax.jit(lambda p, th0, s, im: pj.plan(
        vj, p, th0, s, im, max_iters=CHAOS_ITERS, track_best=True)[0])
    all_m = []
    for b in jb:
        p = j_params(SPEC_J, ARM_J, b, ac.COV)
        all_m.append(j_evaluate(SPEC_J, ARM_J, p, plan(
            p, j_line(SPEC_J, b), b["sdf"], b["im"]), b["th_opt"], b["sdf"]))
    same_summary(got, j_merged(all_m))


def test_multistart_evals_match_jax(problems, monkeypatch):
    got_p, _ = problems
    k, amp, sigma = 4, 1.2, 0.05
    monkeypatch.setattr(ac, "ITERS", CHAOS_ITERS)
    with jax_normals([jax.random.PRNGKey(0)]):
        got = ame.eval_static_ms(SPEC_T, got_p, 4, sigma, k, amp, 2, 2,
                                 "cpu", F64)
    cfg = jgn.OptimConfig(reg=0.1, max_iters=CHAOS_ITERS)
    b = j_batches(ac.batches_on(got_p, 4, "cpu", F64))[0]
    th = jms.plan_multistart(
        SPEC_J, ARM_J, j_params(SPEC_J, ARM_J, b, dict(ac.COV,
                                                       cost_sigma=sigma)),
        j_line(SPEC_J, b), b["sdf"], cfg, jax.random.PRNGKey(0), restarts=k,
        amp=amp, prune_iters=2, keep=2).th
    same_summary(got, j_merged([j_evaluate(
        SPEC_J, ARM_J, j_params(SPEC_J, ARM_J, b, ac.COV), th, b["th_opt"],
        b["sdf"])]))

    monkeypatch.setattr(jlp_mod, "jnp", _Float64Jnp())
    pj, vj, jb, pt, vt = arm_pair(got_p)
    with jax_normals([jax.random.PRNGKey(0)]):
        got = ame.eval_learned_ms(SPEC_T, got_p, 4, pt, vt, k, amp, 0, 0)
    p = j_params(SPEC_J, ARM_J, jb[0], ac.COV)
    th = jax.jit(lambda p, th0, s, im: pj.plan_multistart(
        vj, p, th0, s, im, jax.random.PRNGKey(0), restarts=k, amp=amp,
        prune_iters=0, keep=0).th)(p, j_line(SPEC_J, jb[0]), jb[0]["sdf"],
                                   jb[0]["im"])
    same_summary(got, j_merged([j_evaluate(SPEC_J, ARM_J, p, th,
                                           jb[0]["th_opt"], jb[0]["sdf"])]))


def test_both_mains_run_end_to_end(tmp_path):
    out = tmp_path / "arm"
    out.mkdir()
    for mode, n, seed in (("train", 8, 0), ("test", 4, 777)):
        np.savez_compressed(out / f"data_{mode}.npz", **ac.gen_problems(
            n, seed, SPEC_T, chunk=8, device="cpu", dtype=F64))
    got = ac.main(["--out", str(out), "--num_train", "8", "--num_test", "4",
                   "--epochs", "1", "--batch", "4", "--eval_every", "1",
                   "--configs", "eps_bounded_lr1", *ARGS])
    assert set(got) == {"static_best", "eps_bounded_lr1"}
    chip_smoke.check_tool_files("arm_campaign", out)
    ms = ame.main(["--out", str(out), "--batch", "4", "--restarts", "4",
                   "--cov_model", "eps_bounded_lr1", *ARGS])
    assert sorted(ms) == ["eps_bounded_lr1_ms4", "static_ms4_s0.02",
                          "static_ms4_s0.05", "static_ms4_s0.1"]
    chip_smoke.check_tool_files("arm_multistart_eval", out)
    for row in ms.values():
        assert sorted(row) == sorted(got["eps_bounded_lr1"])
