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
