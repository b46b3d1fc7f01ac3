"""The launch geometry of the lookup kernels K-LOOKUP and K-LOOKUP3D
(``dgpmp2_tpu_torch/ops/cuda/_tiles.py``), on the CPU: tiles of 128 points
and the ragged tail, the divide-free problem index, the one output buffer
and its views with grad on the 16-byte grid, K-BTD's alignment rule, and
the plan handed to the kernel.  The kernels themselves run on the card
only (``tests/test_torch_cuda.py``).
"""
import ctypes

import numpy as np
import pytest
import torch

from dgpmp2_tpu_torch.ops import sdf as tsdf
from dgpmp2_tpu_torch.ops.cuda import _tiles
from dgpmp2_tpu_torch.ops.cuda import btd_solve as k_btd
from dgpmp2_tpu_torch.ops.cuda import sdf_lookup as k_lookup
from dgpmp2_tpu_torch.ops.cuda import sdf_lookup3d as k_lookup3d


@pytest.mark.parametrize("b,p", [(1, 1), (1, 50), (2, 64), (3, 101),
                                 (1024, 1), (1024, 101), (1024, 246),
                                 (1024, 401), (4096, 101), (256, 101)])
def test_geometry_tiles_tail_and_grid(b, p):
    """One block per tile: every point has exactly one thread, and only the
    last tile may be ragged."""
    g = _tiles.geometry(b, p)
    assert g.n == b * p
    assert 0 <= g.tail < _tiles.TILE
    assert (g.tiles - (g.tail > 0)) * _tiles.TILE + g.tail == g.n
    assert (g.tiles - 1) * _tiles.TILE < g.n <= g.tiles * _tiles.TILE


def test_geometry_at_the_main_paths_shapes():
    """B=1024, P=101 is 808 whole tiles; P=401 3208; B=3, P=101 two whole
    tiles and a tail of 47 points."""
    assert _tiles.geometry(1024, 101) == (103424, 808, 0)
    assert _tiles.geometry(1024, 401) == (410624, 3208, 0)
    assert _tiles.geometry(4096, 101) == (413696, 3232, 0)
    assert _tiles.geometry(3, 101) == (303, 3, 47)


@pytest.mark.parametrize("d", [1, 2, 3, 7, 101, 128, 246, 401, 1000, 4096,
                               65537, 2 ** 20 + 3, 2 ** 31 - 1])
def test_divisor_magic_is_exact_below_2_31(d):
    mul, shift = _tiles.divisor_magic(d)
    assert 0 < mul < 2 ** 32
    rng = np.random.default_rng(d)
    span = min(3 * d + 3, 4000)
    js = np.concatenate([
        np.arange(0, span),
        rng.integers(0, 2 ** 31, 2000),
        np.arange(2 ** 31 - span, 2 ** 31),
        (np.arange(1, 50, dtype=np.int64) * d)[:, None] + np.array([-1, 0, 1]),
    ], axis=None)
    js = js[(js >= 0) & (js < 2 ** 31)]
    for j in js.tolist():
        assert (j * mul) >> shift == j // d


def test_divisor_magic_refuses_what_it_cannot_divide():
    for d in (0, -3, 2 ** 31):
        with pytest.raises(ValueError):
            _tiles.divisor_magic(d)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [0, 1, 3, 127, 128, 129, 303, 103424])
def test_out_layout_keeps_grad_on_the_16_byte_grid(ndim, dtype, n):
    itemsize = torch.finfo(dtype).bits // 8
    numel, g_offset = _tiles.out_layout(n, ndim, itemsize)
    assert g_offset >= n and (g_offset * itemsize) % 16 == 0
    assert g_offset - n < 16 // itemsize
    assert numel == g_offset + n * ndim


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,p", [(1, 1), (3, 101), (7, 401)])
def test_output_views_have_the_contract_shapes_and_strides(ndim, dtype, b,
                                                           p):
    """d (B, P) and grad (B, P, ndim): contiguous, disjoint views of one
    buffer, grad 16-byte aligned; a caller's reshape is a view too."""
    numel, g_offset = _tiles.out_layout(b * p, ndim, dtype.itemsize)
    out = torch.empty(numel, dtype=dtype)
    d, g = _tiles.output_views(out, b, p, ndim, g_offset)
    assert d.shape == (b, p) and d.stride() == (p, 1)
    assert g.shape == (b, p, ndim) and g.stride() == (p * ndim, ndim, 1)
    assert d.is_contiguous() and g.is_contiguous()
    assert d.data_ptr() == out.data_ptr()
    assert g.data_ptr() % _tiles.ALIGN == 0
    assert d.data_ptr() + d.numel() * dtype.itemsize <= g.data_ptr()
    assert g.data_ptr() + g.numel() * dtype.itemsize <= (
        out.data_ptr() + numel * dtype.itemsize)
    d.fill_(1.0)
    g.fill_(2.0)
    assert float(out[:b * p].sum()) == b * p
    assert float(out[g_offset:].sum()) == 2.0 * b * p * ndim
    assert d.reshape(b, p, 1)._base is out
    assert g.reshape(b * p, ndim)._base is out


def test_lookup_plan_mirrors_the_c_struct():
    """csrc/lookup_tiles.cuh LookupPlan: a long long, 11 doubles, 9 ints
    (132 bytes, padded to 136), in this order."""
    assert ctypes.sizeof(_tiles.LookupPlan) == 136
    offsets = {name: getattr(_tiles.LookupPlan, name).offset
               for name, _ in _tiles.LookupPlan._fields_}
    assert offsets["g_offset"] == 0 and offsets["res"] == 8
    assert offsets["max_d"] == 88 and offsets["nz"] == 96
    assert offsets["device"] == 128


@pytest.mark.parametrize("shape,npts,lims", [
    ((1024, 128, 128), 101, ((-5.0, 5.0), (-5.0, 5.0))),
    ((1024, 96, 96), 246, ((-5.0, 5.0), (-5.0, 5.0))),
    ((7, 32, 48), 401, ((-2.0, 8.0), (-3.0, 3.0))),
    ((1024, 64, 64, 64), 101, ((-5.0, 5.0),) * 3),
    ((3, 16, 12, 20), 50, ((-5.0, 5.0), (-3.0, 3.0), (-4.0, 4.0))),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", tsdf.OOB_MODES)
def test_plan_struct_across_b_p_w_and_dtype(shape, npts, lims, dtype, mode):
    itemsize = torch.finfo(dtype).bits // 8
    res = 10.0 / shape[-1]
    s = _tiles.plan_struct(shape, npts, itemsize, res, lims, mode, 0)
    geo = _tiles.geometry(shape[0], npts)
    assert (s.n, s.tiles) == (shape[0] * npts, geo.tiles)
    assert (s.nz, s.h, s.w) == ((1,) + tuple(shape[1:]))[-3:]
    assert (s.div_mul, s.div_shift) == _tiles.divisor_magic(npts)
    assert s.g_offset == _tiles.out_layout(geo.n, len(lims), itemsize)[1]
    assert s.reference_mode == (mode == "reference")
    assert s.res == res and s.max_d == lims[0][1] - lims[0][0]
    for i, (lo, hi) in enumerate(lims):
        # The plain version's pixel origin: -lo / res in double.
        assert (s.orig[i], s.lo[i], s.hi[i]) == (-lo / res, lo, hi)


def test_ready_copies_a_view_off_the_16_byte_grid():
    """K-BTD's ``cp.async`` copies need 16-byte aligned inputs; its
    differentiable entry copies a view that is not."""
    flat = torch.arange(1 + 3 * 101 * 2, dtype=torch.float32)
    odd = flat[1:].view(3, 101, 2)
    assert odd.data_ptr() % 16
    got = k_btd._ready(odd)
    assert got.data_ptr() % 16 == 0 and got.is_contiguous()
    assert torch.equal(got, odd)
    assert k_btd._ready(got) is got
    strided = torch.zeros((3, 101, 4))[..., :2]
    assert k_btd._ready(strided).is_contiguous()


@pytest.mark.parametrize("which", ["2d", "3d"])
def test_launch_refuses_cpu_tensors(which):
    """The kernels take CUDA tensors only; on the CPU the wrappers' callers
    take the plain versions (ops.sdf.lookup / lookup_nd)."""
    if which == "2d":
        sdf, pts = torch.zeros((2, 8, 8)), torch.zeros((2, 5, 2))
        call = lambda: k_lookup.launch(sdf, pts, 1.0, (-4, 4), (-4, 4))  # noqa: E731
    else:
        sdf, pts = torch.zeros((2, 8, 8, 8)), torch.zeros((2, 5, 3))
        call = lambda: k_lookup3d.launch(sdf, pts, 1.0, (-4, 4), (-4, 4),  # noqa: E731
                                         (-4, 4))
    n = (k_lookup.launches, k_lookup3d.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()
    assert (k_lookup.launches, k_lookup3d.launches) == n


def test_plan_refuses_what_the_kernels_do_not_take():
    cpu, f32 = torch.device("cpu"), torch.float32
    args = (f32, f32, cpu, cpu, 1.0, ((-4.0, 4.0), (-4.0, 4.0)), "intended")
    with pytest.raises(ValueError, match=r"\(B, H, W\)"):
        _tiles.plan("sdf_lookup", torch.Size((8, 8)), torch.Size((1, 3, 2)),
                    *args)
    with pytest.raises(ValueError, match="batch mismatch"):
        _tiles.plan("sdf_lookup", torch.Size((2, 8, 8)),
                    torch.Size((3, 3, 2)), *args)
    with pytest.raises(ValueError, match=r"\(B, D, H, W\)"):
        _tiles.plan("sdf_lookup3d", torch.Size((2, 8, 8)),
                    torch.Size((2, 3, 3)), f32, f32, cpu, cpu, 1.0,
                    ((-4.0, 4.0),) * 3, "intended")
