"""The CUDA kernels against their plain PyTorch versions, on a GPU only.

Marked ``cuda``; each test skips (from its fixture) where PyTorch sees no
CUDA device.  On the card:  python -m pytest tests/test_torch_cuda.py -m cuda
"""
import numpy as np
import pytest
import torch

from dgpmp2_tpu_torch.core import gn
from dgpmp2_tpu_torch.ops import sdf as tsdf
from dgpmp2_tpu_torch.ops import tridiag
from dgpmp2_tpu_torch.ops.cuda import btd_solve as k_btd
from dgpmp2_tpu_torch.ops.cuda import sdf_lookup as k_lookup
from dgpmp2_tpu_torch.ops.cuda import sdf_lookup3d as k_lookup3d
from dgpmp2_tpu_torch.ops.cuda import sdf_lookup_limbs as k_limbs

pytestmark = pytest.mark.cuda
LIMS = (-5.0, 5.0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _spd(rng, b, t, d, dtype, dev):
    """chip_smoke.spd_system's SPD system (off blocks scaled down above
    D = 16)."""
    g = rng.standard_normal((b, t, d, d))
    diag = g @ np.swapaxes(g, -1, -2) * 0.1 + 4.0 * np.eye(d)
    off = 0.3 * min(1.0, (16 / d) ** 0.5) * rng.standard_normal(
        (b, t - 1, d, d))
    rhs = rng.standard_normal((b, t, d))
    return [torch.tensor(a, dtype=dtype, device=dev) for a in (diag, off, rhs)]


@pytest.mark.parametrize("d", [2, 4, 6, 8])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
def test_btd_kernel_matches_plain(dev, d, dtype, tol):
    diag, off, rhs = _spd(np.random.default_rng(d), 33, 21, d, dtype, dev)
    x_k = k_btd.launch(diag, off, rhs)
    x_p = tridiag.btd_solve(diag, off, rhs)
    assert float((x_k - x_p).abs().max() / x_p.abs().max()) <= tol


@pytest.mark.parametrize("b,t", [(1, 1), (1, 2), (3, 2), (7, 1), (13, 5),
                                 (1000, 3)])
@pytest.mark.parametrize("d", [2, 4, 6, 8])
def test_btd_kernel_ragged_shapes_match_plain(dev, b, t, d):
    """Batches that leave the last warp's lane groups partly empty, and the
    shortest chains (T = 1 is one block solve, T = 2 one Schur step)."""
    diag, off, rhs = _spd(np.random.default_rng(b + t), b, t, d,
                          torch.float64, dev)
    x_k = k_btd.launch(diag, off, rhs)
    x_p = tridiag.btd_solve(diag, off, rhs)
    assert float((x_k - x_p).abs().max() / x_p.abs().max()) <= 1e-10


@pytest.mark.parametrize("d", [4, 8])
def test_btd_kernel_gradient_matches_plain(dev, d):
    ins = _spd(np.random.default_rng(0), 5, 9, d, torch.float64, dev)
    a = [x.clone().requires_grad_(True) for x in ins]
    b = [x.clone().requires_grad_(True) for x in ins]
    xbar = torch.randn(ins[2].shape, dtype=torch.float64, device=dev)
    n = k_btd.launches
    tridiag.btd_solve_auto(*a).backward(xbar)
    assert k_btd.launches - n == 2
    tridiag.btd_solve(*b).backward(xbar)
    for u, v in zip(a, b):
        assert float((u.grad - v.grad).abs().max()) <= 1e-10


@pytest.mark.parametrize("d", [4, 8])
def test_btd_kernel_reads_the_lower_triangle_of_diag(dev, d):
    """As the plain version's Cholesky (and the TPU kernels): noise above the
    diagonal of the diag blocks does not change the solution."""
    diag, off, rhs = _spd(np.random.default_rng(11), 6, 7, d, torch.float64,
                          dev)
    noisy = diag + torch.triu(torch.randn_like(diag), diagonal=1)
    x_k = k_btd.launch(noisy, off, rhs)
    x_p = tridiag.btd_solve(diag, off, rhs)
    assert float((x_k - x_p).abs().max() / x_p.abs().max()) <= 1e-10


def test_btd_kernel_takes_a_view_off_the_16_byte_grid(dev):
    """An input that starts off the 16-byte grid is copied, not refused,
    by the differentiable entry point; ``launch`` itself refuses it."""
    diag, off, rhs = _spd(np.random.default_rng(9), 4, 6, 4, torch.float32,
                          dev)
    rhs_odd = torch.cat([rhs.new_zeros(1), rhs.reshape(-1)])[1:].view_as(rhs)
    assert rhs_odd.data_ptr() % 16
    x_k = tridiag.btd_solve_auto(diag, off, rhs_odd)
    x_p = tridiag.btd_solve(diag, off, rhs)
    assert float((x_k - x_p).abs().max() / x_p.abs().max()) <= 1e-4
    with pytest.raises(ValueError, match="aligned"):
        k_btd.launch(diag, off, rhs_odd)


@pytest.mark.parametrize("mode", tsdf.OOB_MODES)
def test_lookup_kernel_matches_plain(dev, mode):
    rng = np.random.default_rng(1)
    sdf = torch.tensor(rng.standard_normal((3, 32, 32)), device=dev)
    pts = np.concatenate([rng.uniform(-4.9, 4.9, (3, 40, 2)),
                          rng.uniform(-7, 7, (3, 10, 2))], axis=1)
    pts[:, 0] = (-5.0, 5.0)
    p = torch.tensor(pts, device=dev)
    d_k, g_k = k_lookup.launch(sdf, p, 10 / 32, LIMS, LIMS, mode)
    d_p, g_p = tsdf.bilinear_lookup(sdf, p, 10 / 32, LIMS, LIMS, mode)
    assert float((d_k - d_p).abs().max()) <= 1e-12
    assert float((g_k - g_p).abs().max()) <= 1e-10


def test_lookup_kernel_gradient_replays_plain(dev):
    rng = np.random.default_rng(2)
    sdf = torch.tensor(rng.standard_normal((2, 32, 32)), device=dev)
    pts = torch.tensor(rng.uniform(-4.9, 4.9, (2, 20, 2)), device=dev)
    grads = []
    for fn in (tsdf.lookup, tsdf.bilinear_lookup):
        s = sdf.clone().requires_grad_(True)
        p = pts.clone().requires_grad_(True)
        d, g = fn(s, p, 10 / 32, LIMS, LIMS)
        (d.sum() + (g * g).sum()).backward()
        grads.append((s.grad, p.grad))
    for u, v in zip(*grads):
        assert float((u - v).abs().max()) <= 1e-10


def test_cuda_dispatch_raises_on_what_the_kernels_do_not_take(dev):
    x = torch.zeros((2, 5, 4, 4), device=dev)
    with pytest.raises(ValueError, match="one dtype"):
        tridiag.btd_solve_auto(x, x[:, 1:].double(), x[..., 0])
    with pytest.raises(ValueError, match=r"\(B, H, W\)"):
        tsdf.lookup(torch.zeros((8, 8), device=dev),
                    torch.zeros((3, 2), device=dev), 10 / 8, LIMS, LIMS)


def test_gn_step_on_the_card_uses_both_kernels(dev):
    import chip_smoke

    imgs, start, goal = chip_smoke.bench_inputs(16)
    bench = chip_smoke.port_problem(imgs, start, goal, dev, torch.float64)
    cpu = chip_smoke.port_problem(imgs, start, goal, "cpu", torch.float64)
    n_b, n_l = k_btd.launches, k_lookup.launches
    got = gn.gn_step(*bench, 0.1)
    assert (k_btd.launches - n_b, k_lookup.launches - n_l) == (1, 1)
    want = gn.gn_step(*cpu, 0.1)
    assert float((got.cpu() - want).abs().max()) <= 1e-9 * float(
        want.abs().max())


@pytest.mark.parametrize("dtype,tol_d,tol_g", [(torch.float32, 1e-5, 1e-3),
                                               (torch.float64, 1e-12, 1e-10)])
def test_lookup_kernel_far_point_matches_plain(dev, dtype, tol_d, tol_g):
    """A pixel coordinate beyond int range (x = 1e10) must clamp to the last
    column as the plain version's int64 floor does, not wrap."""
    sdf = torch.tensor(np.random.default_rng(3).standard_normal((2, 32, 32)),
                       dtype=dtype, device=dev)
    pts = torch.tensor([[[1e10, 0.3], [-0.7, -1e10], [1e10, 1e10]]] * 2,
                       dtype=dtype, device=dev)
    for mode in tsdf.OOB_MODES:
        d_k, g_k = k_lookup.launch(sdf, pts, 10 / 32, LIMS, LIMS, mode)
        d_p, g_p = tsdf.bilinear_lookup(sdf, pts, 10 / 32, LIMS, LIMS, mode)
        assert float((d_k - d_p).abs().max()) <= tol_d
        assert float((g_k - g_p).abs().max()) <= tol_g


@pytest.mark.parametrize("mode", tsdf.OOB_MODES)
@pytest.mark.parametrize("dtype,tol_d,tol_g", [(torch.float32, 1e-5, 1e-3),
                                               (torch.float64, 1e-12, 1e-10)])
def test_lookup3d_kernel_matches_plain(dev, mode, dtype, tol_d, tol_g):
    rng = np.random.default_rng(4)
    sdf = torch.tensor(rng.standard_normal((3, 16, 12, 20)), dtype=dtype,
                       device=dev)
    pts = np.concatenate([rng.uniform(-4.9, 4.9, (3, 40, 3)),
                          rng.uniform(-7, 7, (3, 10, 3))], axis=1)
    pts[:, 0] = (-5.0, 5.0, 5.0)
    pts[:, 1] = (1e10, -1e10, 0.2)
    p = torch.tensor(pts, dtype=dtype, device=dev)
    # A 16 x 12 x 20 grid at res 0.5 spans z 8 m, y 6 m, x 10 m.
    args = (sdf, p, 0.5, LIMS, (-3.0, 3.0), (-4.0, 4.0), mode)
    d_k, g_k = k_lookup3d.launch(*args)
    d_p, g_p = tsdf.trilinear_lookup(*args)
    assert float((d_k - d_p).abs().max()) <= tol_d
    assert float((g_k - g_p).abs().max()) <= tol_g


def test_lookup3d_kernel_gradient_replays_plain(dev):
    rng = np.random.default_rng(5)
    sdf = torch.tensor(rng.standard_normal((2, 12, 12, 12)), device=dev)
    pts = torch.tensor(rng.uniform(-4.9, 4.9, (2, 20, 3)), device=dev)
    grads = []
    for fn in (tsdf.lookup_nd, tsdf.trilinear_lookup):
        s = sdf.clone().requires_grad_(True)
        p = pts.clone().requires_grad_(True)
        n = k_lookup3d.launches
        d, g = fn(s, p, 10 / 12, LIMS, LIMS, LIMS)
        assert k_lookup3d.launches - n == (fn is tsdf.lookup_nd)
        (d.sum() + (g * g).sum()).backward()
        grads.append((s.grad, p.grad))
    for u, v in zip(*grads):
        assert float((u - v).abs().max()) <= 1e-10


@pytest.mark.parametrize("n_limbs", [1, 2, 3])
def test_limb_kernel_matches_plain(dev, n_limbs):
    """Bit-equal (tolerance 0) to the packed layout's plain reader and to
    bilinear_lookup_limbs on the (B, L, H, W) limbs, far points and the
    grid's last cell included."""
    rng = np.random.default_rng(6)
    sdf = torch.tensor(rng.standard_normal((3, 32, 32)), dtype=torch.float32,
                       device=dev)
    pts = np.concatenate([rng.uniform(-4.9, 4.9, (3, 40, 2)),
                          rng.uniform(-7, 7, (3, 10, 2))], axis=1)
    pts[:, 0] = (1e10, -1e10)
    pts[:, 1] = (4.9, -4.9)
    pts = torch.tensor(pts, dtype=torch.float32, device=dev)
    packed = k_limbs.split(sdf, n_limbs)
    n = k_limbs.launches
    d_k, g_k = k_limbs.launch(packed, pts, 10 / 32, LIMS, LIMS)
    assert k_limbs.launches - n == 1
    for d_p, g_p in (tsdf.bilinear_lookup_packed(packed, pts, 10 / 32, LIMS,
                                                 LIMS),
                     tsdf.bilinear_lookup_limbs(tsdf.limb_split(sdf, n_limbs),
                                                pts, 10 / 32, LIMS, LIMS)):
        assert torch.equal(d_k, d_p) and torch.equal(g_k, g_p)


def test_limb_engine_splits_once_per_plan_on_the_card(dev):
    """A 5-iteration plan under pallas_v3_2: one split of the SDF, six
    K-LOOKUP-LIMB launches and no K-LOOKUP launch."""
    import chip_smoke

    imgs, start, goal = chip_smoke.bench_inputs(8)
    bench = chip_smoke.port_problem(imgs, start, goal, dev, torch.float32)
    counts = (k_limbs.splits, k_limbs.launches, k_lookup.launches)
    tsdf.set_lookup_method("pallas_v3_2")
    try:
        gn.plan(*bench, gn.OptimConfig(reg=0.1, max_iters=5, tol_delta=0.0))
    finally:
        tsdf.set_lookup_method("auto")
    after = (k_limbs.splits, k_limbs.launches, k_lookup.launches)
    assert tuple(a - b for a, b in zip(after, counts)) == (1, 6, 0)


def test_limb_engine_on_the_card_launches_and_replays_exact(dev):
    rng = np.random.default_rng(7)
    sdf = torch.tensor(rng.standard_normal((2, 32, 32)), device=dev)
    pts = torch.tensor(rng.uniform(-4.9, 4.9, (2, 20, 2)), device=dev)
    grads = []
    for engine in ("pallas_v3_2", "gather"):
        s = sdf.clone().requires_grad_(True)
        p = pts.clone().requires_grad_(True)
        n = k_limbs.launches
        tsdf.set_lookup_method(engine)
        try:
            d, g = tsdf.lookup(s, p, 10 / 32, LIMS, LIMS)
        finally:
            tsdf.set_lookup_method("auto")
        assert k_limbs.launches - n == (engine != "gather")
        (d.double().sum() + g.double().sum()).backward()
        grads.append((s.grad, p.grad))
    for u, v in zip(*grads):
        assert float((u - v).abs().max()) <= 1e-10


def test_3d_dispatch_raises_on_what_the_kernel_does_not_take(dev):
    with pytest.raises(ValueError, match=r"\(B, D, H, W\)"):
        tsdf.lookup_nd(torch.zeros((8, 8, 8), device=dev),
                       torch.zeros((1, 3, 3), device=dev), 10 / 8, LIMS,
                       LIMS, LIMS)
    with pytest.raises(ValueError, match="one dtype"):
        tsdf.lookup_nd(torch.zeros((1, 8, 8, 8), device=dev),
                       torch.zeros((1, 3, 3), dtype=torch.float64,
                                   device=dev), 10 / 8, LIMS, LIMS, LIMS)


def test_gn_step_3d_on_the_card_uses_lookup3d(dev):
    import chip_smoke

    g = np.load(chip_smoke.GOLDEN3D)
    args = (g["images"], g["start"], g["goal"])
    bench = chip_smoke.port_problem(*args, dev, torch.float64)
    cpu = chip_smoke.port_problem(*args, "cpu", torch.float64)
    n_b, n_l = k_btd.launches, k_lookup3d.launches
    got = gn.gn_step(*bench, 0.1)
    assert (k_btd.launches - n_b, k_lookup3d.launches - n_l) == (1, 1)
    want = gn.gn_step(*cpu, 0.1)
    assert float((got.cpu() - want).abs().max()) <= 1e-9 * float(
        want.abs().max())


def _golden_ext():
    import chip_smoke

    return chip_smoke, dict(np.load(chip_smoke.GOLDEN_EXT))


@pytest.mark.parametrize("case", ["arm2", "arm3_task", "xyh",
                                  "gp_inter_vel"])
def test_constrained_gn_step_on_the_card_matches_cpu(dev, case):
    """float64: one GN step of each constrained golden case on the card (one
    K-BTD and one K-LOOKUP launch, the GP-interpolated states included in
    that one lookup) against the CPU plain path: 1e-9 relative."""
    from dgpmp2_tpu_torch.core import graph

    cs, g = _golden_ext()
    out = []
    for where in (dev, torch.device("cpu")):
        planner, params, th0, sdf = cs.golden_ext_problem(where, case, g)
        n_b, n_l = k_btd.launches, k_lookup.launches
        out.append(gn.gn_step(planner.spec, planner.robot, params, th0, sdf,
                              0.1).cpu())
        counts = (k_btd.launches - n_b, k_lookup.launches - n_l)
        assert counts == ((1, 1) if where == dev else (0, 0))
    assert float((out[0] - out[1]).abs().max()) <= 1e-9 * float(
        out[1].abs().max())
    # float32: the residuals on the card against the CPU's (the lookups are
    # bit-equal; FK's sin/cos may differ by an ulp).
    res = []
    for where in (dev, torch.device("cpu")):
        planner, params, th0, sdf = cs.golden_ext_problem(where, case, g,
                                                          torch.float32)
        res.append(graph.eval_residuals(planner.spec, planner.robot, params,
                                        th0, sdf))
    for f in ("r_gp", "r_obs", "h_obs", "r_dyn", "r_vel", "r_obsi", "r_self",
              "r_jl", "r_wg"):
        a, b = getattr(res[0], f), getattr(res[1], f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert float((a.cpu() - b).abs().max()) <= 1e-4 * max(
                1.0, float(b.abs().max())), f


@pytest.mark.parametrize("staged", [False, True])
def test_multistart_on_the_card_matches_cpu(dev, staged):
    """float64, restart 0 plus three numpy-made extra seeds (no random draw
    reaches the result): the same selection on the card and on the CPU,
    with exact launch counts."""
    import chip_smoke
    from dgpmp2_tpu_torch.core import multistart

    imgs, start, goal = chip_smoke.bench_inputs(4)
    rng = np.random.default_rng(8)
    extra = rng.normal(0.0, 0.3, (3, 4, 101, 4))
    extra[:, :, [0, -1]] = 0.0
    cfg = gn.OptimConfig(reg=0.1, max_iters=5)
    kw = dict(prune_iters=2, keep=2) if staged else {}
    outs = []
    for where in (dev, torch.device("cpu")):
        bench = chip_smoke.port_problem(imgs, start, goal, where,
                                        torch.float64)
        seeds = torch.tensor(extra, device=where) + bench[3]
        n_b, n_l = k_btd.launches, k_lookup.launches
        outs.append(multistart.plan_multistart(
            *bench, cfg, torch.Generator(where).manual_seed(0), restarts=1,
            extra_seeds=seeds, **kw))
        if where == dev:
            assert (k_btd.launches - n_b, k_lookup.launches - n_l) == (
                (5, 9) if staged else (5, 7))
    got, want = outs
    assert torch.equal(got.k_best.cpu(), want.k_best)
    assert torch.equal(got.contact_free.cpu(), want.contact_free)
    assert torch.equal(got.iters.cpu(), want.iters)
    assert float((got.th.cpu() - want.th).abs().max()) <= 1e-9 * float(
        want.th.abs().max())


def test_plan_batch_lm_on_the_card_matches_cpu(dev):
    """GPMP2Planner.plan_batch (LM, float64) on the card: one K-BTD and two
    K-LOOKUP launches per host iteration plus the initial lookup, and the
    CPU's trajectories to 1e-9 relative."""
    import chip_smoke
    from dgpmp2_tpu_torch.planner import GPMP2Planner
    from dgpmp2_tpu_torch.robots import make_robot

    lims, pp, gp, obs, _, rd = chip_smoke.load_yamls("gpmp2_2d_params.yaml")
    imgs, start, goal = chip_smoke.bench_inputs(4)
    optim = {"method": "lm", "max_iters": 6, "tol_delta": 1e-3}
    outs = []
    for where in (dev, torch.device("cpu")):
        planner = GPMP2Planner(gp, obs, pp, lims, make_robot(rd), device=where)
        sdf = chip_smoke.occupancy_sdf(imgs, where, torch.float64)
        th0 = chip_smoke.seeds(planner.spec, start, goal, where, torch.float64)
        n_b, n_l = k_btd.launches, k_lookup.launches
        outs.append(planner.plan_batch(start, goal, th0, sdf, optim))
        if where == dev:
            n = len(outs[-1][3])
            assert (k_btd.launches - n_b, k_lookup.launches - n_l) == (
                n, 2 * n + 1)
    (th_k, *_rest_k), (th_c, *_rest_c) = outs
    assert float((th_k.cpu() - th_c).abs().max()) <= 1e-9 * float(
        th_c.abs().max())
    np.testing.assert_array_equal(_rest_k[3], _rest_c[3])


def test_perturbed_inits_with_a_card_generator(dev):
    """Draws from a CUDA generator: restart 0 is the base and every seed
    keeps both boundary states."""
    from dgpmp2_tpu_torch.core import multistart

    th0 = torch.randn((3, 21, 6), dtype=torch.float64, device=dev)
    seeds = multistart.perturbed_inits(
        th0, torch.Generator(dev).manual_seed(1), 5, 1.5, 10.0)
    assert seeds.shape == (5, 3, 21, 6) and seeds.device == th0.device
    assert torch.equal(seeds[0], th0)
    # sin(hπ) at the last state is 1e-16, not 0: the ends hold to rounding.
    ends = seeds[:, :, [0, -1]] - th0[None, :, [0, -1]]
    assert float(ends.abs().max()) <= 1e-12
    assert float((seeds[1:] - th0).abs().max()) > 0.0


def test_a_four_link_arm_on_the_card_matches_cpu(dev):
    """A 4-link arm (D=8): one float64 GN step on the card (one K-BTD
    launch) against the CPU plain path, 1e-9 relative."""
    from dgpmp2_tpu_torch.core import graph
    from dgpmp2_tpu_torch.robots import PlanarArmNLink

    arm = PlanarArmNLink(link_lengths=(1.2, 1.0, 0.8, 0.6))
    spec = graph.GraphSpec(dof=4, state_dim=8, total_time_step=10,
                           nlinks=arm.nlinks)
    out = []
    for where in (dev, torch.device("cpu")):
        start = torch.zeros((2, 8), dtype=torch.float64, device=where)
        params = graph.default_params(spec, arm, start, start + 0.5,
                                      qc_inv=np.eye(4), cost_sigma=0.1,
                                      epsilon_dist=0.2, k_s=0.01, k_g=0.01,
                                      dtype=torch.float64)
        th = torch.linspace(0.0, 0.5, 11, dtype=torch.float64,
                            device=where)[None, :, None].expand(2, 11, 8)
        sdf = torch.tensor(np.random.default_rng(10).uniform(
            -0.5, 2.0, (2, 16, 16)), dtype=torch.float64, device=where)
        n = k_btd.launches
        out.append(gn.gn_step(spec, arm, params, th.contiguous(), sdf,
                              0.1).cpu())
        assert k_btd.launches - n == (where == dev)
    assert float((out[0] - out[1]).abs().max()) <= 1e-9 * float(
        out[1].abs().max())


@pytest.mark.parametrize("d", [10, 16])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
def test_btd_kernel_at_d_10_and_16_matches_plain(dev, d, dtype, tol):
    """Arms of 5 and 8 links: 16 lanes per problem; in float64 at D=16 a
    2-stage ring."""
    for b, t in ((33, 21), (3, 1), (5, 2), (1000, 41)):
        diag, off, rhs = _spd(np.random.default_rng(d + t), b, t, d, dtype,
                              dev)
        x_k = k_btd.launch(diag, off, rhs)
        x_p = tridiag.btd_solve(diag, off, rhs)
        assert float((x_k - x_p).abs().max() / x_p.abs().max()) <= tol


@pytest.mark.parametrize("d", [1, 3, 17, 18, 24, 32])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
def test_btd_kernel_at_odd_and_wide_d_matches_plain(dev, d, dtype, tol):
    """Odd D (their own instances) and D = 17-32 (the wide kernel, one
    problem per warp), at ragged batches and the shortest chains."""
    for b, t in ((33, 21), (3, 1), (5, 2), (1000, 41)):
        diag, off, rhs = _spd(np.random.default_rng(d + t), b, t, d, dtype,
                              dev)
        x_k = k_btd.launch(diag, off, rhs)
        x_p = tridiag.btd_solve(diag, off, rhs)
        assert float((x_k - x_p).abs().max() / x_p.abs().max()) <= tol


@pytest.mark.parametrize("d", [17, 32])
def test_btd_kernel_wide_reads_the_lower_triangle_and_differentiates(dev, d):
    """The wide kernel reads the lower triangle of each diag block, and its
    gradient is two launches of the implicit adjoint."""
    diag, off, rhs = _spd(np.random.default_rng(12), 6, 7, d, torch.float64,
                          dev)
    noisy = diag + torch.triu(torch.randn_like(diag), diagonal=1)
    x_p = tridiag.btd_solve(diag, off, rhs)
    assert float((k_btd.launch(noisy, off, rhs) - x_p).abs().max()
                 / x_p.abs().max()) <= 1e-10
    a = [x.clone().requires_grad_(True) for x in (diag, off, rhs)]
    c = [x.clone().requires_grad_(True) for x in (diag, off, rhs)]
    xbar = torch.randn(rhs.shape, dtype=torch.float64, device=dev)
    n = k_btd.launches
    tridiag.btd_solve_auto(*a).backward(xbar)
    assert k_btd.launches - n == 2
    tridiag.btd_solve(*c).backward(xbar)
    for u, v in zip(a, c):
        assert float((u.grad - v.grad).abs().max()) <= 1e-10


@pytest.mark.parametrize("d", [33, 48, 64])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-12)])
def test_btd_kernel_past_d_32_matches_plain(dev, d, dtype, tol):
    """D > 32 (arms of 17+ links): a block per problem, its rows (float64 in
    both dtypes) in dynamic shared memory, at ragged batches and the
    shortest chains."""
    for b, t in ((33, 21), (3, 1), (5, 2), (200, 41)):
        diag, off, rhs = _spd(np.random.default_rng(d + t), b, t, d, dtype,
                              dev)
        x_k = k_btd.launch(diag, off, rhs)
        x_p = tridiag.btd_solve(diag, off, rhs)
        assert float((x_k - x_p).abs().max() / x_p.abs().max()) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-12)])
def test_btd_kernel_beyond_shared_memory_matches_plain(dev, dtype, tol):
    """The largest D whose rows fit the card's shared memory and the next,
    whose rows go to the wrapper's global scratch buffer."""
    d = 33
    while k_btd.scratch_bytes(d + 1, dev) == 0:
        d += 1
    for dd in (d, d + 1):
        diag, off, rhs = _spd(np.random.default_rng(dd), 4, 5, dd, dtype, dev)
        x_k = k_btd.launch(diag, off, rhs)
        x_p = tridiag.btd_solve(diag, off, rhs)
        assert float((x_k - x_p).abs().max() / x_p.abs().max()) <= tol


@pytest.mark.parametrize("d", [33, 64])
def test_btd_kernel_block_reads_the_lower_triangle_and_differentiates(dev, d):
    """Past D = 32 the kernel reads the lower triangle of each diag block,
    and its gradient is two launches of the implicit adjoint."""
    diag, off, rhs = _spd(np.random.default_rng(13), 5, 6, d, torch.float64,
                          dev)
    noisy = diag + torch.triu(torch.randn_like(diag), diagonal=1)
    x_p = tridiag.btd_solve(diag, off, rhs)
    assert float((k_btd.launch(noisy, off, rhs) - x_p).abs().max()
                 / x_p.abs().max()) <= 1e-10
    a = [x.clone().requires_grad_(True) for x in (diag, off, rhs)]
    c = [x.clone().requires_grad_(True) for x in (diag, off, rhs)]
    xbar = torch.randn(rhs.shape, dtype=torch.float64, device=dev)
    n = k_btd.launches
    tridiag.btd_solve_auto(*a).backward(xbar)
    assert k_btd.launches - n == 2
    tridiag.btd_solve(*c).backward(xbar)
    for u, v in zip(a, c):
        assert float((u.grad - v.grad).abs().max()) <= 1e-10


# Shapes that exercise the lookup kernels' tiles of 128 points: B·P below
# one tile, exactly one, a ragged tail, P = 1, B = 1, P = 401, and the
# paths' shapes of more than one wave of blocks (the 2-link arm, GP
# interpolation, the multistart pool).
TILE_SHAPES = [(1, 50), (2, 64), (3, 101), (1024, 1), (1, 1), (7, 401),
               (1024, 246), (1024, 401), (4096, 101)]


def _tile_case(ndim, b, p, dtype, dev, seed):
    """(sdf, points, res, lims) with points inside, outside and far outside
    the grid (a 16 x 12 x 20 voxel grid at res 0.5 spans z 8 m, y 6 m,
    x 10 m)."""
    rng = np.random.default_rng(seed)
    grid, res, lims = (((32, 32), 10 / 32, (LIMS, LIMS)) if ndim == 2 else
                       ((16, 12, 20), 0.5, (LIMS, (-3.0, 3.0), (-4.0, 4.0))))
    pts = rng.uniform(-4.9, 4.9, (b, p, ndim))
    pts[:, ::7] = rng.uniform(-7.0, 7.0, (b, len(range(0, p, 7)), ndim))
    pts[0, -1] = 1e10
    return (torch.tensor(rng.standard_normal((b, *grid)), dtype=dtype,
                         device=dev),
            torch.tensor(pts, dtype=dtype, device=dev), res, lims)


@pytest.mark.parametrize("b,p", TILE_SHAPES)
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lookup_kernels_are_bit_equal_to_plain_at_tile_edges(dev, b, p, ndim,
                                                             dtype):
    k, plain = ((k_lookup, tsdf.bilinear_lookup) if ndim == 2
                else (k_lookup3d, tsdf.trilinear_lookup))
    sdf, pts, res, lims = _tile_case(ndim, b, p, dtype, dev, b * p + ndim)
    for mode in tsdf.OOB_MODES:
        n = k.launches
        d_k, g_k = k.launch(sdf, pts, res, *lims, mode)
        assert k.launches - n == 1
        d_p, g_p = plain(sdf, pts, res, *lims, mode)
        assert torch.equal(d_k, d_p) and torch.equal(g_k, g_p)


@pytest.mark.parametrize("ndim", [2, 3])
def test_lookup_kernels_take_a_view_off_the_16_byte_grid(dev, ndim):
    """Points that start off the 16-byte grid: the differentiable entry and
    ``launch`` both take them, bit-equal to plain."""
    k, entry, plain = ((k_lookup, k_lookup.bilinear_lookup_cuda,
                        tsdf.bilinear_lookup) if ndim == 2 else
                       (k_lookup3d, k_lookup3d.trilinear_lookup_cuda,
                        tsdf.trilinear_lookup))
    sdf, pts, res, lims = _tile_case(ndim, 3, 101, torch.float32, dev, 12)
    flat = torch.cat([pts.new_zeros(1), pts.reshape(-1)])
    odd = flat[1:].view_as(pts)
    assert odd.data_ptr() % 16
    d_k, g_k = entry(sdf, odd, res, *lims, "intended")
    d_p, g_p = plain(sdf, pts, res, *lims, "intended")
    assert torch.equal(d_k, d_p) and torch.equal(g_k, g_p)
    d_k, g_k = k.launch(sdf, odd, res, *lims, "intended")
    assert torch.equal(d_k, d_p) and torch.equal(g_k, g_p)


@pytest.mark.parametrize("ndim", [2, 3])
def test_lookup_kernel_outputs_are_views_of_one_buffer(dev, ndim):
    k = k_lookup if ndim == 2 else k_lookup3d
    sdf, pts, res, lims = _tile_case(ndim, 5, 77, torch.float32, dev, 13)
    d, g = k.launch(sdf, pts, res, *lims, "intended")
    assert d.shape == (5, 77) and d.stride() == (77, 1)
    assert g.shape == (5, 77, ndim) and g.stride() == (77 * ndim, ndim, 1)
    assert d.untyped_storage().data_ptr() == g.untyped_storage().data_ptr()
    assert g.data_ptr() % 16 == 0


@pytest.mark.parametrize("which", ["2d", "3d"])
def test_lookup_launches_equal_the_plan_iterations(dev, which):
    """One lookup launch per GN iteration plus the initial one."""
    import chip_smoke

    if which == "2d":
        imgs, start, goal = chip_smoke.bench_inputs(8)
        k = k_lookup
    else:
        g = np.load(chip_smoke.GOLDEN3D)
        imgs, start, goal = g["images"], g["start"], g["goal"]
        k = k_lookup3d
    bench = chip_smoke.port_problem(imgs, start, goal, dev, torch.float32)
    n_b, n_l = k_btd.launches, k.launches
    gn.plan(*bench, gn.OptimConfig(reg=0.1, max_iters=7, tol_delta=0.0))
    assert (k_btd.launches - n_b, k.launches - n_l) == (7, 8)


def test_a_five_link_arm_on_the_card_matches_cpu(dev):
    """A 5-link arm (D=10): one float64 GN step on the card (one K-BTD
    launch) against the CPU plain path, 1e-9 relative."""
    from dgpmp2_tpu_torch.core import graph
    from dgpmp2_tpu_torch.robots import PlanarArmNLink

    arm = PlanarArmNLink(link_lengths=(1.0, 0.9, 0.8, 0.6, 0.5))
    spec = graph.GraphSpec(dof=5, state_dim=10, total_time_step=10,
                           nlinks=arm.nlinks)
    out = []
    for where in (dev, torch.device("cpu")):
        start = torch.zeros((2, 10), dtype=torch.float64, device=where)
        params = graph.default_params(spec, arm, start, start + 0.5,
                                      qc_inv=np.eye(5), cost_sigma=0.1,
                                      epsilon_dist=0.2, k_s=0.01, k_g=0.01,
                                      dtype=torch.float64)
        th = torch.linspace(0.0, 0.5, 11, dtype=torch.float64,
                            device=where)[None, :, None].expand(2, 11, 10)
        sdf = torch.tensor(np.random.default_rng(10).uniform(
            -0.5, 2.0, (2, 16, 16)), dtype=torch.float64, device=where)
        n = k_btd.launches
        out.append(gn.gn_step(spec, arm, params, th.contiguous(), sdf,
                              0.1).cpu())
        assert k_btd.launches - n == (where == dev)
    assert float((out[0] - out[1]).abs().max()) <= 1e-9 * float(
        out[1].abs().max())


@pytest.mark.parametrize("lkw,method", [
    (dict(dynamics_mode="diag_identity", learn_eps=True, eps_max=0.8,
          static_init=(1.0, 0.01, 0.4)), "gauss_newton"),
    (dict(model_type="rnn_gru", hidden_dim=16, learn_eps=True,
          static_init=(1.0, 0.05, 0.4)), "lm")], ids=["feed_forward", "gru"])
def test_learned_plan_on_the_card_matches_cpu(dev, lkw, method):
    """The learned planner in float64 (random weights about the static
    init), 5 iterations with track_best, through K-BTD and K-LOOKUP on the
    card against the plain versions on the CPU: 1e-9 relative, and 1e-6
    under eps_max, whose float32 sigmoid may round an ulp apart on the card
    and the CPU (6e-8 seen)."""
    import chip_smoke

    inputs = chip_smoke.bench_inputs(4, seed=2)
    outs, counts = [], {}
    for where in (dev, torch.device("cpu")):
        planner, variables, params, th0, sdf, im = chip_smoke.learned_setup(
            where, *inputs, lkw=lkw, method=method, iters=5,
            dtype=torch.float64, weights_seed=4)
        n_btd, n_look = k_btd.launches, k_lookup.launches
        with torch.no_grad():
            outs.append(planner.plan(variables, params, th0, sdf, im,
                                     track_best=True))
        counts[where.type] = (k_btd.launches - n_btd,
                              k_lookup.launches - n_look)
    assert counts == {"cuda": (5, 6), "cpu": (0, 0)}
    tol = 1e-6 if lkw.get("eps_max") else 1e-9
    for a, b in zip(outs[0][:3], outs[1][:3]):
        assert float((a.cpu() - b).abs().max() / b.abs().max()) <= tol


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("b,p", [(1, 1), (1, 50), (3, 101), (7, 401),
                                 (1024, 1)])
def test_lookup_bwd_kernel_matches_the_replay(dev, ndim, dtype, tol, b, p):
    """K-LOOKUP-BWD against autograd through the plain lookup, at the
    lookup tiles' edge shapes, both OOB modes, far points too: the point
    and SDF cotangents within float32 / float64 rounding relative to the
    replay's largest (chip_smoke.check_bwd_call)."""
    import chip_smoke

    rng = np.random.default_rng(b * p + ndim)
    grid, res, lims = (((32, 32), 10 / 32, (LIMS, LIMS)) if ndim == 2 else
                       ((16, 12, 20), 0.5, (LIMS, (-3.0, 3.0),
                                            (-4.0, 4.0))))
    case = chip_smoke.bwd_cases(dev, rng, dtype, b, p, ndim, grid, res, lims)
    for mode in tsdf.OOB_MODES:
        assert chip_smoke.check_bwd_call("K-LOOKUP-BWD", *case, res, lims,
                                         mode) <= tol


@pytest.mark.parametrize("ndim", [2, 3])
def test_lookup_backward_launches_the_bwd_kernel_once(dev, ndim):
    """The differentiable lookup on the card: one K-LOOKUP launch forward,
    one K-LOOKUP-BWD launch backward, the gradients the plain lookup's."""
    from dgpmp2_tpu_torch.ops.cuda import sdf_lookup_bwd as k_bwd

    rng = np.random.default_rng(ndim)
    grid = (24, 24) if ndim == 2 else (12, 12, 12)
    sdf = torch.tensor(rng.standard_normal((2, *grid)), device=dev)
    pts = torch.tensor(rng.uniform(-4.9, 4.9, (2, 30, ndim)), device=dev)
    lims = (LIMS,) * ndim
    grads = []
    for fn in (tsdf.lookup_nd, tsdf.trilinear_lookup if ndim == 3 else
               tsdf.bilinear_lookup):
        s = sdf.clone().requires_grad_(True)
        p = pts.clone().requires_grad_(True)
        n_fwd = (k_lookup if ndim == 2 else k_lookup3d).launches
        n_bwd = k_bwd.launches
        d, g = fn(s, p, 10 / grid[0], *lims)
        (d.sum() + (g * g).sum()).backward()
        if fn is tsdf.lookup_nd:
            assert ((k_lookup if ndim == 2 else k_lookup3d).launches - n_fwd,
                    k_bwd.launches - n_bwd) == (1, 1)
        grads.append((s.grad, p.grad))
    for u, v in zip(*grads):
        assert float((u - v).abs().max()) <= 1e-10


def test_service_serves_a_small_batch_on_the_card(dev):
    """PlanningService on the card: 3 concurrent requests through the world
    bank in a batch of 4, float64, against the same service on the CPU;
    one K-BTD launch per iteration and one lookup more, per dispatch."""
    import asyncio

    from pathlib import Path

    from dgpmp2_tpu_torch.planner import DiffGPMP2Planner
    from dgpmp2_tpu_torch.robots import make_robot
    from dgpmp2_tpu_torch.serve import PlanningService, PlanRequest
    from dgpmp2_tpu_torch.utils.config import load_params

    cfg = Path(__file__).resolve().parents[1] / "dgpmp2_tpu" / "configs"
    env, pp, gp, obs, opt, rd = load_params(
        cfg / "gpmp2_2d_params.yaml", cfg / "robot_2d.yaml",
        cfg / "env_2d_params.yaml")

    img = np.ones((32, 32))
    img[12:20, 12:20] = 0.0
    world = tsdf.sdf_from_occupancy(torch.tensor(img), res=10 / 32,
                                    dtype=torch.float64).numpy()
    rng = np.random.default_rng(0)
    reqs = [PlanRequest(start=np.r_[rng.uniform(-4.3, -3.7, 2), 0.0, 0.0],
                        goal=np.r_[rng.uniform(3.7, 4.3, 2), 0.0, 0.0],
                        world="lab") for _ in range(3)]
    out = {}
    for device in (dev, torch.device("cpu")):
        planner = DiffGPMP2Planner(
            gp, obs, dict(pp, total_time_step=15), dict(opt, max_iters=12),
            {"x_lims": env["x_lims"], "y_lims": env["y_lims"]},
            make_robot(rd), dtype=torch.float64, device=device)
        svc = PlanningService(planner, batch_size=4, window_ms=50.0)
        svc.register_world("lab", world)

        async def run():
            await svc.start()
            try:
                return await asyncio.gather(*(svc.submit(r) for r in reqs))
            finally:
                await svc.stop()

        n0 = (k_btd.launches, k_lookup.launches)
        out[device.type] = asyncio.run(run())
        if device.type == "cuda":
            assert (k_btd.launches - n0[0], k_lookup.launches - n0[1]) == (
                12, 13)
        assert svc.stats["batches"] == 1
    for g, c in zip(out["cuda"], out["cpu"]):
        assert g.batch_fill == 0.75 and g.err_final < g.err_init
        np.testing.assert_allclose(g.th, c.th, rtol=0, atol=1e-9)


def test_captured_gn_steps_equal_the_eager_steps(dev):
    """utils.profiling.CapturedSteps: 5 GN steps of a small bench problem
    captured in one CUDA graph; a replay's th equals the eager steps bit
    for bit, and the capture counted one launch of each kernel a step."""
    import chip_smoke
    from dgpmp2_tpu_torch.utils import profiling

    spec, robot, params, th0, sdf = chip_smoke.port_problem(
        *chip_smoke.bench_inputs(16), dev, torch.float32, t=20)
    delta = torch.tensor(0.1, dtype=torch.float32, device=dev)

    def step(th, p, s):
        return th + gn.gn_step(spec, robot, p, th, s, delta)

    with torch.no_grad():
        th = th0
        for _ in range(5):
            th = step(th, params, sdf)
        steps = profiling.CapturedSteps(step, th0, params, sdf, iters=5)
        n0 = k_btd.launches
        got = steps.replay().clone()
        torch.cuda.synchronize()
        assert k_btd.launches == n0
        assert torch.equal(got, th)
        assert (steps.launches["btd_solve"], steps.launches["sdf_lookup"]) \
            == (5, 5)
        # A second replay continues from the first one's result.
        again = steps.replay().clone()
        for _ in range(5):
            th = step(th, params, sdf)
        assert torch.equal(again, th)
        assert profiling.time_compiled(step, th0, params, sdf, iters=5,
                                       repeats=2) > 0.0


def test_envs_on_the_card_launch_their_kernel_once_per_query(dev):
    from dgpmp2_tpu_torch import envs

    img = np.ones((64, 64))
    img[20:30, 40:50] = 0.0
    env2 = envs.Env2D({"x_lims": LIMS, "y_lims": LIMS}, device=dev)
    env2.initialize_from_image(img)
    vox = np.ones((16, 16, 16))
    vox[6:10, 6:10, 6:10] = 0.0
    env3 = envs.Env3D({"x_lims": LIMS, "y_lims": LIMS, "z_lims": LIMS},
                      device=dev)
    env3.initialize_from_voxels(vox)
    rng = np.random.default_rng(0)
    pts2 = torch.tensor(rng.uniform(-5.5, 5.5, (7, 33, 2)),
                        dtype=torch.float32, device=dev)
    pts3 = torch.tensor(rng.uniform(-5.5, 5.5, (129, 3)),
                        dtype=torch.float32, device=dev)
    n2, n3 = k_lookup.launches, k_lookup3d.launches
    d2, g2 = env2.get_signed_obstacle_distance(pts2)
    d3, g3 = env3.get_signed_obstacle_distance(pts3)
    assert env2.is_feasible((-4.0, -4.0), 0.3)
    assert (k_lookup.launches - n2, k_lookup3d.launches - n3) == (2, 1)
    p2 = tsdf.bilinear_lookup(env2.sedt[None], pts2.reshape(1, -1, 2),
                              env2.res, LIMS, LIMS)
    p3 = tsdf.trilinear_lookup(env3.sedt[None], pts3[None], env3.res, LIMS,
                               LIMS, LIMS)
    assert torch.equal(d2.reshape(-1), p2[0].reshape(-1))
    assert torch.equal(g2.reshape(-1), p2[1].reshape(-1))
    assert torch.equal(d3, p3[0][0]) and torch.equal(g3, p3[1][0])
