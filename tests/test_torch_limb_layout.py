"""K-LOOKUP-LIMB's packed limb layout and its split cache, on the CPU.

The kernel reads the SDF's bf16 limbs packed cell by cell
(``ops.sdf.limb_pack``), split once per SDF tensor and version
(``ops.sdf.LIMB_CACHE``).  Here: the packed layout's plain reader against
``bilinear_lookup_limbs`` (bit for bit) and against JAX's TPU kernel T5 in
interpret mode; the cache's semantics; what the launch plan takes.  The
kernel itself runs on the card only (``tests/test_torch_cuda.py``).
"""
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dgpmp2_tpu.ops.pallas import sdf_lookup as jpallas
from dgpmp2_tpu_torch.core import gn
from dgpmp2_tpu_torch.ops import sdf as tsdf
from dgpmp2_tpu_torch.ops.cuda import _tiles
from dgpmp2_tpu_torch.ops.cuda import sdf_lookup_limbs as k_limbs

from _torch_parity import F64, np_

torch.set_num_threads(1)
LIMS = (-5.0, 5.0)
N = 32
RES = 10 / N


def _inputs(seed, b=3, p=50):
    """float32 SDF (b, N, N) with a -0.0 cell, and points inside, far
    outside the grid, on floor(px) = -1 and W-1 and floor(py) = H-1 (cell
    middles: the TPU kernel forms x·(1/res), the port divides)."""
    rng = np.random.default_rng(seed)
    sdf = (3.0 * rng.standard_normal((b, N, N))).astype(np.float32)
    sdf[0, 0, 0] = -0.0
    pts = rng.uniform(-4.9, 4.9, (b, p, 2))
    pts[:, ::7] = rng.uniform(-7.0, 7.0, (b, len(range(0, p, 7)), 2))
    pts[:, 1] = (1e10, 0.3)
    pts[:, 2] = (-1e10, -1e10)
    pts[:, 3] = (LIMS[0] - 0.5 * RES, 0.1)  # floor(px) = -1
    pts[:, 4] = (LIMS[1] - 0.5 * RES, LIMS[0] + 0.5 * RES)  # last cell
    return sdf, pts.astype(np.float32)


@pytest.mark.parametrize("n_limbs", [1, 2, 3])
def test_packed_reader_is_bit_equal_to_the_limb_planes(n_limbs):
    sdf, pts = (torch.tensor(a) for a in _inputs(1))
    limbs = tsdf.limb_split(sdf, n_limbs)
    packed = tsdf.limb_pack(limbs)
    got = tsdf.bilinear_lookup_packed(packed, pts, RES, LIMS, LIMS)
    want = tsdf.bilinear_lookup_limbs(limbs, pts, RES, LIMS, LIMS)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(np_(a).view(np.uint32),
                                      np_(b).view(np.uint32))


@pytest.mark.parametrize("n_limbs", [1, 2, 3])
def test_packed_reader_matches_pallas_v3_interpret(n_limbs):
    """T5 in interpret mode: the same limbs, so only float32 blend rounding
    differs: d within 1e-4, gradient within 1e-3."""
    sdf, pts = _inputs(2)
    d_j, g_j = jpallas.bilinear_lookup_pallas_v3(
        jnp.asarray(sdf), jnp.asarray(pts), RES, LIMS, LIMS, 2, n_limbs, True)
    packed = k_limbs.split(torch.tensor(sdf), n_limbs)
    d_t, g_t = tsdf.bilinear_lookup_packed(packed, torch.tensor(pts), RES,
                                           LIMS, LIMS)
    np.testing.assert_allclose(np_(d_t), np_(d_j), atol=1e-4)
    np.testing.assert_allclose(np_(g_t), np_(g_j), atol=1e-3)


def test_limb_pack_puts_a_cells_limbs_side_by_side():
    """(B, H, W, S) with S = 1, 2, 4; at L = 3 slot 3 stays zero."""
    sdf = torch.tensor(_inputs(3)[0])
    for n_limbs, slots in ((1, 1), (2, 2), (3, 4)):
        limbs = tsdf.limb_split(sdf, n_limbs)
        packed = tsdf.limb_pack(limbs)
        assert packed.shape == (3, N, N, slots) and packed.is_contiguous()
        assert packed.dtype == torch.bfloat16
        assert torch.equal(packed[..., :n_limbs], limbs.permute(0, 2, 3, 1))
        assert not packed[..., n_limbs:].any()
        assert tsdf.packed_grid(packed.shape) == (3, N, N, n_limbs)


def test_packed_grid_and_the_launch_plan_refuse_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="packed limb layout"):
        tsdf.packed_grid((2, 8, 8, 3))
    with pytest.raises(ValueError, match="packed limb layout"):
        tsdf.packed_grid((2, 1, 8, 8))
    cpu, bf16, f32 = torch.device("cpu"), torch.bfloat16, torch.float32
    lims = (LIMS, LIMS)
    shape, pts = torch.Size((2, 8, 8, 2)), torch.Size((2, 5, 2))
    with pytest.raises(ValueError, match="bfloat16 limbs and float32"):
        _tiles.plan("sdf_lookup_limbs", shape, pts, f32, f32, cpu, cpu, 1.0,
                    lims, "intended")
    with pytest.raises(ValueError, match="bfloat16 limbs and float32"):
        _tiles.plan("sdf_lookup_limbs", shape, pts, bf16, torch.float64, cpu,
                    cpu, 1.0, lims, "intended")
    with pytest.raises(ValueError, match="intended OOB mode only"):
        _tiles.plan("sdf_lookup_limbs", shape, pts, bf16, f32, cpu, cpu, 1.0,
                    lims, "reference")
    with pytest.raises(ValueError, match="CUDA tensors"):
        _tiles.plan("sdf_lookup_limbs", shape, pts, bf16, f32, cpu, cpu, 1.0,
                    lims, "intended")
    # K-LOOKUP still takes float32 or float64 only.
    with pytest.raises(ValueError, match="CUDA tensors|float32 or float64"):
        _tiles.plan("sdf_lookup", torch.Size((2, 8, 8)), pts, bf16, f32,
                    torch.device("cuda", 0), torch.device("cuda", 0), 1.0,
                    lims, "intended")


ENGINE = {n: m for m, n in tsdf.LIMB_ENGINES.items()}


def _lookup(sdf, pts, engine):
    tsdf.set_lookup_method(engine)
    try:
        return tsdf.lookup(sdf, pts, RES, LIMS, LIMS)
    finally:
        tsdf.set_lookup_method("auto")


def _bench(t=10):
    imgs, start, goal = chip_smoke.bench_inputs(2)
    return chip_smoke.port_problem(imgs, start, goal, "cpu", torch.float32,
                                   t=t)


def _case(case):
    """Splits counted by one case of the cache's semantics, and what it
    expects: (counted, expected)."""
    sdf, pts = (torch.tensor(a) for a in _inputs(4))
    n0 = k_limbs.splits
    if case.startswith("plan "):
        engine = case[5:]
        bench = _bench()
        tsdf.set_lookup_method(engine)
        try:
            gn.plan(*bench, gn.OptimConfig(reg=0.1, max_iters=50,
                                           tol_delta=0.0))
        finally:
            tsdf.set_lookup_method("auto")
        # One split per plan, whatever the engine's L; no kernel on the CPU.
        return k_limbs.splits - n0, 1
    if case == "in-place edit":
        _lookup(sdf, pts, "pallas_v3_1")
        sdf.mul_(0.5)
        got = _lookup(sdf, pts, "pallas_v3_1")
        want = tsdf.bilinear_lookup_limbs(tsdf.limb_split(sdf, 1), pts, RES,
                                          LIMS, LIMS)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        return k_limbs.splits - n0, 2
    if case == "new tensor":
        _lookup(sdf, pts, "pallas_v3_1")
        _lookup(sdf.clone(), pts, "pallas_v3_1")
        _lookup(sdf, pts, "pallas_v3_1")
        return k_limbs.splits - n0, 2
    if case == "other n_limbs":
        for engine in ("pallas_v3_1", "pallas_v3_2", "pallas_v3_1",
                       "pallas_v3_2"):
            _lookup(sdf, pts, engine)
        return k_limbs.splits - n0, 2
    if case == "other dtype":
        sdf64 = sdf.double()
        for s in (sdf, sdf64, sdf, sdf64):
            _lookup(s, pts, "pallas_v3")
        return k_limbs.splits - n0, 2
    if case == "freed":
        other = sdf.clone()
        _lookup(sdf, pts, "pallas_v3_2")
        _lookup(other, pts, "pallas_v3_2")
        assert len(tsdf.LIMB_CACHE) == 2
        del other
        assert len(tsdf.LIMB_CACHE) == 1
        # A temporary's entry dies with it at once.
        _lookup(sdf.clone(), pts, "pallas_v3_2")
        assert len(tsdf.LIMB_CACHE) == 1
        del sdf
        gc.collect()
        return len(tsdf.LIMB_CACHE), 0
    assert case == "backward"
    # float64 SDF and points: the backward replays the exact lookup on the
    # unsplit SDF; a cached split changes nothing of it.
    s64, p64 = sdf.double().requires_grad_(True), pts.double()
    p64.requires_grad_(True)
    rng = np.random.default_rng(5)
    w_d = torch.tensor(rng.standard_normal(pts.shape[:2]), dtype=torch.float32)
    w_g = torch.tensor(rng.standard_normal(pts.shape), dtype=torch.float32)
    grads = []
    for engine in ("pallas_v3_2", "pallas_v3_2", "gather"):
        d, g = _lookup(s64, p64, engine)
        s_bar, p_bar = torch.autograd.grad(
            (d * w_d.to(d.dtype)).sum() + (g * w_g.to(g.dtype)).sum(),
            (s64, p64))
        grads.append((s_bar, p_bar))
    for a, b in zip(grads[0], grads[1]):
        assert torch.equal(a, b)
    for a, b in zip(grads[0], grads[2]):
        np.testing.assert_allclose(np_(a), np_(b), atol=1e-10)
    assert s64.dtype == F64
    return k_limbs.splits - n0, 1


@pytest.mark.parametrize("case", [
    "plan pallas_v3", "plan pallas_v3_2", "plan pallas_v3_1", "in-place edit",
    "new tensor", "other n_limbs", "other dtype", "freed", "backward"])
def test_limb_split_cache(case):
    """LIMB_CACHE splits an SDF once per tensor, version, dtype and L: once
    for a 50-iteration plan under each limb engine; again after an in-place
    edit, for a new tensor, another n_limbs or another dtype; an entry dies
    with its SDF; the backward is the exact replay, cached split or not."""
    tsdf.LIMB_CACHE.clear()
    try:
        got, want = _case(case)
    finally:
        tsdf.LIMB_CACHE.clear()
    assert got == want


def test_split_runs_without_gradient_and_counts():
    sdf = torch.tensor(_inputs(6)[0], requires_grad=True)
    n = k_limbs.splits
    packed = k_limbs.split(sdf, 2)
    assert k_limbs.splits - n == 1
    assert not packed.requires_grad and packed.grad_fn is None
    assert torch.equal(packed, tsdf.limb_pack(tsdf.limb_split(sdf.detach(),
                                                              2)))
