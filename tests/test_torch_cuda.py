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
    g = rng.standard_normal((b, t, d, d))
    diag = g @ np.swapaxes(g, -1, -2) * 0.1 + 4.0 * np.eye(d)
    off = 0.3 * rng.standard_normal((b, t - 1, d, d))
    rhs = rng.standard_normal((b, t, d))
    return [torch.tensor(a, dtype=dtype, device=dev) for a in (diag, off, rhs)]


@pytest.mark.parametrize("d", [4, 6])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
def test_btd_kernel_matches_plain(dev, d, dtype, tol):
    diag, off, rhs = _spd(np.random.default_rng(d), 33, 21, d, dtype, dev)
    x_k = k_btd.launch(diag, off, rhs)
    x_p = tridiag.btd_solve(diag, off, rhs)
    assert float((x_k - x_p).abs().max() / x_p.abs().max()) <= tol


def test_btd_kernel_gradient_matches_plain(dev):
    ins = _spd(np.random.default_rng(0), 5, 9, 4, torch.float64, dev)
    a = [x.clone().requires_grad_(True) for x in ins]
    b = [x.clone().requires_grad_(True) for x in ins]
    xbar = torch.randn(ins[2].shape, dtype=torch.float64, device=dev)
    tridiag.btd_solve_auto(*a).backward(xbar)
    tridiag.btd_solve(*b).backward(xbar)
    for u, v in zip(a, b):
        assert float((u.grad - v.grad).abs().max()) <= 1e-10


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
    x = torch.zeros((2, 5, 3, 3), device=dev)
    with pytest.raises(ValueError, match="D="):
        tridiag.btd_solve_auto(x, x[:, 1:], x[..., 0])
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
    rng = np.random.default_rng(6)
    sdf = torch.tensor(rng.standard_normal((3, 32, 32)), dtype=torch.float32,
                       device=dev)
    pts = torch.tensor(np.concatenate([rng.uniform(-4.9, 4.9, (3, 40, 2)),
                                       rng.uniform(-7, 7, (3, 10, 2))],
                                      axis=1), dtype=torch.float32, device=dev)
    limbs = tsdf.limb_split(sdf, n_limbs)
    d_k, g_k = k_limbs.launch(limbs, pts, 10 / 32, LIMS, LIMS)
    d_p, g_p = tsdf.bilinear_lookup_limbs(limbs, pts, 10 / 32, LIMS, LIMS)
    assert float((d_k - d_p).abs().max()) <= 1e-5
    assert float((g_k - g_p).abs().max()) <= 1e-3


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
