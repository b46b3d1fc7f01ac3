"""The plain reference against hand-built problems, and against the port on
the CPU in float64 for the first steps of a plan (the port is imported by
these tests only; the reference never imports it)."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from portbench.reference import compare, gpmp2, learned

F64 = torch.float64


def ramp_problem(b=2, t=4, slope=(0.3, -0.2), offset=0.45):
    """An SDF that is the plane ``offset + slope · (x, y)`` on a 64 x 64 grid
    of a 10 m world: bilinear lookups are exact on it."""
    n = 64
    res = 10.0 / n
    cols = -5.0 + torch.arange(n, dtype=F64) * res
    rows = 5.0 - torch.arange(n, dtype=F64) * res  # row 0 at the top
    sdf = offset + slope[0] * cols[None, :] + slope[1] * rows[:, None]
    start = torch.tensor([[-2.0, -1.0, 0.0, 0.0]] * b, dtype=F64)
    goal = torch.tensor([[2.0, 1.5, 0.0, 0.0]] * b, dtype=F64)
    return gpmp2.Problem(
        sdf=sdf.expand(b, n, n).clone(), start=start, goal=goal,
        q_inv=gpmp2.gp_q_inv(torch.eye(2, dtype=F64), 10.0 / t),
        ks_inv=1e4, kg_inv=1e4, obs_w=400.0, eps=0.4, radius=0.4,
        dt=10.0 / t, x_lims=(-5.0, 5.0), y_lims=(-5.0, 5.0))


def test_lookup_is_exact_on_a_plane():
    p = ramp_problem()
    pts = torch.tensor([[[0.13, -0.71], [1.9, 2.3], [-3.3, 0.05]]] * 2,
                       dtype=F64)
    d, grad = gpmp2.lookup(p.sdf, pts, p.res, p.x_lims, p.y_lims)
    want = 0.45 + 0.3 * pts[..., 0] - 0.2 * pts[..., 1]
    assert torch.allclose(d, want, atol=1e-12)
    assert torch.allclose(grad, torch.tensor([0.3, -0.2], dtype=F64)
                          .expand_as(grad), atol=1e-12)


def test_lookup_outside_the_world_reads_its_width():
    p = ramp_problem()
    pts = torch.tensor([[[6.0, 0.0], [0.0, -7.0]]] * 2, dtype=F64)
    d, grad = gpmp2.lookup(p.sdf, pts, p.res, p.x_lims, p.y_lims)
    assert torch.all(d == 10.0) and torch.all(grad == 0.0)


def residual_vector(p, th):
    res = gpmp2.residuals(p, th)
    return torch.cat([res.r_s, res.r_gp.flatten(1), res.r_g, res.r_obs], 1)


def weight_matrix(p, t):
    blocks = [p.ks_inv * torch.eye(4, dtype=F64)]
    blocks += [p.q_inv] * t
    blocks += [p.kg_inv * torch.eye(4, dtype=F64)]
    blocks += [p.obs_w * torch.eye(t + 1, dtype=F64)]
    return torch.block_diag(*blocks)


def straight(p, t):
    alpha = torch.linspace(0, 1, t + 1, dtype=F64)[None, :, None]
    pos = p.start[:, None, :2] * (1 - alpha) + p.goal[:, None, :2] * alpha
    vel = ((p.goal - p.start)[:, :2] / (p.dt * t))[:, None].expand_as(pos)
    return torch.cat([pos, vel], -1)


def test_error_is_half_the_weighted_square_over_the_rows():
    t = 4
    p = ramp_problem(t=t)
    th = straight(p, t) + 0.01 * torch.randn(2, t + 1, 4, dtype=F64,
                                             generator=torch.Generator().manual_seed(0))
    r = residual_vector(p, th)
    w = weight_matrix(p, t)
    want = 0.5 * torch.einsum("bi,ij,bj->b", r, w, r) / (4 * (t + 2) + t + 1)
    assert torch.allclose(gpmp2.error(p, gpmp2.residuals(p, th)), want,
                          rtol=1e-13)


def test_normal_equations_equal_the_dense_jacobian_form():
    """JᵀΛJ and JᵀΛr from a numerical Jacobian of the stacked residuals."""
    t = 4
    p = ramp_problem(t=t)
    th = straight(p, t)
    th[:, 1:-1, :2] += torch.tensor([[0.05, -0.03]], dtype=F64)
    r = residual_vector(p, th)
    n = (t + 1) * 4
    jac = torch.zeros(2, r.shape[1], n, dtype=F64)
    h = 1e-6
    for k in range(n):
        e = torch.zeros(n, dtype=F64)
        e[k] = h
        jac[:, :, k] = (residual_vector(p, th + e.view(t + 1, 4))
                        - residual_vector(p, th - e.view(t + 1, 4))) / (2 * h)
    w = weight_matrix(p, t)
    lam = jac.transpose(1, 2) @ w @ jac
    g = (jac.transpose(1, 2) @ w @ r[..., None])[..., 0]
    diag, upper, grad = gpmp2.normal_equations(p, gpmp2.residuals(p, th))
    dense = torch.zeros_like(lam)
    for i in range(t + 1):
        dense[:, 4 * i:4 * i + 4, 4 * i:4 * i + 4] = diag[:, i]
    for i in range(t):
        dense[:, 4 * i:4 * i + 4, 4 * i + 4:4 * i + 8] = upper[:, i]
        dense[:, 4 * i + 4:4 * i + 8, 4 * i:4 * i + 4] = upper[:, i].mT
    assert torch.allclose(dense, lam, rtol=1e-6, atol=1e-4)
    assert torch.allclose(grad.flatten(1), g, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("d, n", [(1, 1), (2, 5), (4, 101), (6, 9)])
def test_block_solve_equals_a_dense_solve(d, n):
    gen = torch.Generator().manual_seed(d * 100 + n)
    m = torch.randn(3, n * d, n * d, dtype=F64, generator=gen)
    band = torch.zeros(n * d, n * d, dtype=torch.bool)
    for i in range(n):
        for j in range(max(0, i - 1), min(n, i + 2)):
            band[i * d:(i + 1) * d, j * d:(j + 1) * d] = True
    a = m @ m.mT * band + n * d * torch.eye(n * d, dtype=F64)
    a = torch.where(band, a, torch.zeros_like(a))
    a = 0.5 * (a + a.mT)
    rhs = torch.randn(3, n, d, dtype=F64, generator=gen)
    diag = torch.stack([a[:, i * d:(i + 1) * d, i * d:(i + 1) * d]
                        for i in range(n)], 1)
    upper = torch.stack([a[:, i * d:(i + 1) * d, (i + 1) * d:(i + 2) * d]
                         for i in range(n - 1)], 1) if n > 1 else \
        torch.zeros(3, 0, d, d, dtype=F64)
    x = gpmp2.block_solve(diag, upper, rhs)
    want = torch.linalg.solve(a, rhs.flatten(1))
    assert torch.allclose(x.flatten(1), want, rtol=1e-10, atol=1e-10)


def test_bfloat16_step_stays_finite():
    """The control's precision gives a poor step, never NaN."""
    t = 8
    p = ramp_problem(t=t)
    pb = dataclasses.replace(p, sdf=p.sdf.bfloat16(), start=p.start.bfloat16(),
                             goal=p.goal.bfloat16(), q_inv=p.q_inv.bfloat16())
    th = straight(p, t).bfloat16()
    dth = gpmp2.gn_step(pb, gpmp2.residuals(pb, th), 0.1)
    assert torch.isfinite(dth).all()


def test_rel_gap_is_bounded_and_reads_one_off_the_finite():
    a = torch.tensor([1.0, 2.0, float("nan"), float("inf"), 0.0, 1e-12])
    b = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.0, 0.0])
    gap = compare.rel_gap(a, b)
    assert gap.tolist() == pytest.approx([0.0, 0.5, 1.0, 1.0, 0.0, 1e-3])


def test_excess_compares_means_and_reads_one_off_the_finite():
    two = torch.tensor([2.0, 2.0])
    assert compare.excess(torch.tensor([1.0, 3.0]), two) == 0.0
    assert compare.excess(torch.tensor([3.0, 3.0]), two) == pytest.approx(1 / 3)
    assert compare.excess(two, torch.tensor([3.0, 3.0])) == pytest.approx(-1 / 3)
    assert compare.excess(torch.tensor([1.0, float("nan")]), two) == 1.0
    got = compare.finish([({"g": 0.1}, (torch.tensor([3.0]), torch.tensor([1.0]))),
                          ({"g": 0.3}, (torch.tensor([1.0]), torch.tensor([1.0])))])
    assert got == pytest.approx({"g": 0.3, "final_err_excess": 0.5})


def test_static_bias_decodes_to_the_static_covariances():
    steps = 6
    bias = torch.tensor(learned.static_bias(steps, 1.0, 0.01, 0.4, 0.8),
                        dtype=F64)[None]
    dec = learned.decode(bias, steps, 0.5, 0.8)
    assert torch.allclose(dec.q_inv[0, 0], gpmp2.gp_q_inv(
        torch.eye(2, dtype=F64), 0.5))
    assert torch.allclose(dec.obs_w, torch.full((1, steps + 1), 1e4,
                                                dtype=F64))
    assert torch.allclose(dec.eps, torch.full((1, steps + 1), 0.4,
                                              dtype=F64))


def test_encoder_and_head_match_torch_modules():
    """The plain layers against ``torch.nn`` modules holding the same
    weights (channels-last flatten, LayerNorm over channels)."""
    gen = torch.Generator().manual_seed(3)
    steps, size = 4, 32
    shapes = learned.weight_shapes(2, size, steps + 1, 7)
    w = {k: torch.randn(s, dtype=F64, generator=gen) * 0.3
         for k, s in shapes.items()}
    im = torch.rand(2, size, size, 2, dtype=F64, generator=gen)
    x = im.permute(0, 3, 1, 2)
    for i, f in enumerate(learned.FEATURES):
        conv = torch.nn.Conv2d(x.shape[1], f, 3, padding=1).double()
        conv.weight.data, conv.bias.data = (w[f"conv.convs.{i}.weight"],
                                            w[f"conv.convs.{i}.bias"])
        ln = torch.nn.LayerNorm(f, eps=1e-6).double()
        ln.weight.data, ln.bias.data = (w[f"conv.norms.{i}.weight"],
                                        w[f"conv.norms.{i}.bias"])
        x = torch.relu(ln(conv(x).permute(0, 2, 3, 1))).permute(0, 3, 1, 2)
        if i < 4:
            x = torch.nn.functional.max_pool2d(x, 2)
    want = x.permute(0, 2, 3, 1).reshape(2, -1)
    feats = learned.encoder(w, im)
    assert torch.allclose(feats, want, atol=1e-12)
    th = torch.randn(2, steps + 1, 4, dtype=F64, generator=gen)
    out = learned.head(w, feats, th)
    assert out.shape == (2, 7) and torch.isfinite(out).all()


# --- against the port on the CPU (float64) -------------------------------

def _port_problem(t=20, b=3, seed=5):
    from portbench import worlds

    gen = torch.Generator().manual_seed(seed)
    maps, starts, goals = worlds.forest_bank(gen, b, 1, 64, (-5.0, 5.0),
                                             (-5.0, 5.0), 0.4, "cpu")
    sdf = worlds.sdf_from_map(maps, 10.0 / 64).double()
    start = torch.zeros(b, 4, dtype=F64)
    goal = torch.zeros(b, 4, dtype=F64)
    start[:, :2] = starts[:, 0]
    goal[:, :2] = goals[:, 0]
    th0 = worlds.straight_line(start[:, :2], goal[:, :2], 10.0, t)
    return sdf, start, goal, th0


def test_reference_plan_follows_the_port_for_its_first_steps():
    from dgpmp2_tpu_torch.core import gn, graph
    from dgpmp2_tpu_torch.robots import PointRobot2D

    t, iters = 20, 4
    sdf, start, goal, th0 = _port_problem(t)
    spec = graph.GraphSpec(total_time_step=t)
    params = graph.default_params(spec, PointRobot2D(), start, goal,
                                  qc_inv=np.eye(2), cost_sigma=0.05,
                                  epsilon_dist=0.4, k_s=0.01, k_g=0.01,
                                  dtype=F64)
    port = gn.plan(spec, PointRobot2D(), params, th0, sdf,
                   gn.OptimConfig(reg=0.1, max_iters=iters))
    p = gpmp2.Problem(sdf=sdf, start=start, goal=goal,
                      q_inv=gpmp2.gp_q_inv(torch.eye(2, dtype=F64), 10.0 / t),
                      ks_inv=1e4, kg_inv=1e4, obs_w=400.0, eps=0.4,
                      radius=0.4, dt=10.0 / t, x_lims=(-5.0, 5.0),
                      y_lims=(-5.0, 5.0))
    th, err0, errs, _ = gpmp2.plan(p, th0, 0.1, iters, 1e-4)
    assert torch.allclose(err0, port.err_init, rtol=1e-12)
    assert torch.allclose(errs, port.err_per_iter, rtol=1e-8)
    assert torch.allclose(th, port.th, rtol=1e-8, atol=1e-10)
    gaps, final = compare.point2d(p, th0, {
        "err_init": port.err_init, "err1": port.err_per_iter[0],
        "th": port.th, "err_final": port.err_final}, 0.1, iters, 1e-4)
    assert max(gaps.values()) < 1e-8
    assert abs(compare.finish([(gaps, final)])["final_err_excess"]) < 1e-8


def test_reference_learned_plan_follows_the_port():
    from dgpmp2_tpu_torch.core import gn, graph
    from dgpmp2_tpu_torch.learn.learned_planner import (
        LearnedDiffGPMP2Planner, LearnedPlannerConfig)
    from dgpmp2_tpu_torch.robots import PointRobot2D

    t, iters, size = 20, 3, 64
    sdf, start, goal, th0 = _port_problem(t)
    robot = PointRobot2D()
    spec = graph.GraphSpec(total_time_step=t)
    planner = LearnedDiffGPMP2Planner(
        spec, robot, gn.OptimConfig(reg=0.1, max_iters=iters),
        LearnedPlannerConfig(learn_eps=True, eps_max=0.8,
                             static_init=(1.0, 0.01, 0.4), dtype=F64),
        device="cpu")
    gen = torch.Generator().manual_seed(9)
    shapes = learned.weight_shapes(2, size, t + 1, t + 2 * (t + 1))
    w = {}
    for k, s in shapes.items():
        z = torch.randn(s, dtype=F64, generator=gen)
        w[k] = z / math.sqrt(float(np.prod(s[1:]))) if len(s) > 1 else 0.1 * z
    w["head.out.weight"] = 0.05 * w["head.out.weight"]
    w["head.out.bias"] = w["head.out.bias"] + torch.tensor(
        learned.static_bias(t, 1.0, 0.01, 0.4, 0.8), dtype=F64)
    im = (sdf > 0).double()
    stack = planner.stack_inputs(im, sdf)
    variables = planner.load_variables(w, stack, th0)
    params = graph.default_params(spec, robot, start, goal, qc_inv=np.eye(2),
                                  cost_sigma=0.05, epsilon_dist=0.4, k_s=0.01,
                                  k_g=0.01, dtype=F64)
    with torch.no_grad():
        th, errs, errs_ext, _, th_final = planner.plan(
            variables, params, th0, sdf, im, track_best=True,
            return_final=True)
    fixed = gpmp2.Problem(sdf=sdf, start=start, goal=goal,
                          q_inv=gpmp2.gp_q_inv(torch.eye(2, dtype=F64),
                                               10.0 / t),
                          ks_inv=1e4, kg_inv=1e4, obs_w=400.0, eps=0.4,
                          radius=0.4, dt=10.0 / t, x_lims=(-5.0, 5.0),
                          y_lims=(-5.0, 5.0))
    r_th, r_errs, r_ext, r_final = learned.plan(w, fixed, im, th0, 0.1,
                                                iters, 0.8)
    # The port decodes the head's output in float32, as the JAX package.
    assert torch.allclose(errs, r_errs, rtol=1e-5)
    assert torch.allclose(errs_ext, r_ext, rtol=1e-5)
    assert torch.allclose(th_final, r_final, rtol=1e-4, atol=1e-6)
    gaps, ext = compare.learned2d(w, fixed, im, th0, {
        "th": th, "th_final": th_final, "errs": errs, "errs_ext": errs_ext},
        0.1, iters, 0.8)
    assert max(gaps.values()) < 1e-4
    assert abs(compare.finish([(gaps, ext)])["final_err_excess"]) < 1e-4
