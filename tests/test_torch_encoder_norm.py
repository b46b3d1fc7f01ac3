"""K-NORM (``ops/cuda/encoder_norm.py``, ``csrc/encoder_norm.cu``): the
learned encoder's per-pixel LayerNorm, ReLU and 2×2 (2×2×2) max-pool.

On the CPU: the plain version against the module chain the encoder ran
before (``nn.LayerNorm`` → ReLU → max-pool), the encoder's entry, its
parameter names and flatten order, and the wrapper's refusals.  Marked
``cuda`` (each skips from its fixture without a card): the kernel against
the plain version, its backward by ``gradcheck`` and at ties against the
plain chain's autograd, the encoders on the card against the CPU, the
launch counter, and a CUDA tensor outside the instances raising.  On the
card:  python -m pytest tests/test_torch_encoder_norm.py --noconftest -m cuda
"""
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from dgpmp2_tpu_torch.models import conv_encoder as tconv
from dgpmp2_tpu_torch.ops.cuda import encoder_norm as k_norm
from dgpmp2_tpu_torch.utils import profiling

EPS = tconv.LN_EPS
# (B, *spatial) of each window kind: even, odd sizes, B = 1, and a batch
# whose lanes leave the last block partly empty.
SHAPES = {2: [(2, 8, 12), (3, 9, 13), (1, 7, 6), (5, 10, 10)],
          3: [(2, 4, 6, 8), (1, 5, 7, 3), (3, 5, 5, 5)]}
GRID = [(nd, s) for nd, shapes in SHAPES.items() for s in shapes]


def _inputs(shape, c, dtype, device="cpu", seed=0, bias_shift=0.0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape, c, generator=g, dtype=torch.float64)
    w = 1.0 + 0.3 * torch.randn(c, generator=g, dtype=torch.float64)
    b = bias_shift + 0.3 * torch.randn(c, generator=g, dtype=torch.float64)
    return [t.to(device=device, dtype=dtype) for t in (x, w, b)]


def _module_chain(x, weight, bias, pool):
    """The encoder's block as it ran before K-NORM: ``nn.LayerNorm``,
    ``torch.relu``, ``max_pool2d``/``max_pool3d`` on a channels-first
    view."""
    norm = nn.LayerNorm(x.shape[-1], eps=EPS).to(x)
    with torch.no_grad():
        norm.weight.copy_(weight)
        norm.bias.copy_(bias)
    x = torch.relu(norm(x))
    if pool:
        mp = F.max_pool2d if x.dim() == 4 else F.max_pool3d
        x = mp(x.movedim(-1, 1), 2).movedim(1, -1)
    return x


def _old_forward(enc, x):
    """``ConvEncoder.forward`` before K-NORM."""
    x = x.to(enc.convs[0].weight.dtype)
    for conv, norm, down in zip(enc.convs, enc.norms, enc.pool_after):
        x = conv(x.movedim(-1, 1)).movedim(1, -1)
        x = _module_chain(x, norm.weight, norm.bias, down)
    return x.reshape(x.shape[0], -1)


def _encoder(ndim, dtype, device="cpu", seed=0):
    enc = (tconv.ConvEncoder if ndim == 2 else tconv.ConvEncoder3D)(2)
    gen = torch.Generator().manual_seed(seed)
    enc.reset_parameters(gen)
    with torch.no_grad():  # scales and offsets away from 1 and 0
        for norm in enc.norms:
            norm.weight.add_(0.2 * torch.randn(norm.weight.shape,
                                               generator=gen))
            norm.bias.add_(0.2 * torch.randn(norm.bias.shape, generator=gen))
    return enc.to(device=device, dtype=dtype)


def _images(ndim, b, device="cpu", dtype=torch.float64, seed=1):
    size = (32, 32) if ndim == 2 else (16, 16, 16)
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, *size, 2, generator=g,
                       dtype=torch.float64).to(device=device, dtype=dtype)


# -- the CPU ------------------------------------------------------------------


@pytest.mark.parametrize("pool", [True, False])
@pytest.mark.parametrize("c", [16, 32])
@pytest.mark.parametrize("ndim,shape", GRID)
def test_plain_version_is_the_module_chain(ndim, shape, c, pool):
    x, w, b = _inputs(shape, c, torch.float64)
    got = k_norm.plain(x, w, b, pool, EPS)
    want = _module_chain(x, w, b, pool).detach()
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-12


def test_entry_takes_the_plain_version_on_the_cpu():
    """Any channel count, autograd through the library chain, no launch."""
    n = k_norm.launches
    for c in (8, 16):
        x, w, b = _inputs((2, 6, 5), c, torch.float64)
        ins = [t.clone().requires_grad_(True) for t in (x, w, b)]
        out = k_norm.norm_relu_pool(*ins, True, EPS)
        assert torch.equal(out, k_norm.plain(x, w, b, True, EPS))
        out.sum().backward()
        assert all(t.grad is not None for t in ins)
    assert k_norm.launches == n


@pytest.mark.parametrize("ndim", [2, 3])
def test_encoder_forward_names_and_order_unchanged(ndim):
    enc = _encoder(ndim, torch.float64)
    x = _images(ndim, 3)
    assert torch.equal(enc(x), _old_forward(enc, x))
    assert list(enc.state_dict()) == [
        f"{kind}.{i}.{p}" for kind in ("convs", "norms") for i in range(5)
        for p in ("weight", "bias")]
    assert all(isinstance(m, nn.LayerNorm) and m.eps == EPS
               for m in enc.norms)


@pytest.mark.parametrize("case", ["channels", "dtype", "rank", "weight",
                                  "device"])
def test_kernel_refuses_what_it_has_no_instance_for(case):
    x, w, b = _inputs((1, 4, 4), 16, torch.float32)
    if case == "channels":
        x, w, b = _inputs((1, 4, 4), 8, torch.float32)
    elif case == "dtype":
        x, w, b = (t.half() for t in (x, w, b))
    elif case == "rank":
        x = x[0]
    elif case == "weight":
        w = w[:8]
    match = {"channels": "C in", "dtype": "float32 or float64",
             "rank": r"\(B, H, W, C\)", "weight": "weight of shape",
             "device": "CUDA"}[case]
    with pytest.raises(ValueError, match=match):
        k_norm.launch(x, w, b, True, EPS)


def test_counters_report_the_kernel():
    assert "encoder_norm" in profiling.counters()
    assert profiling.launch_counts()["encoder_norm"] == k_norm.launches


# -- the card -----------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-10)])
@pytest.mark.parametrize("pool", [True, False])
@pytest.mark.parametrize("c", [16, 32])
@pytest.mark.parametrize("ndim,shape", GRID)
def test_kernel_matches_plain(dev, ndim, shape, c, pool, dtype, tol):
    x, w, b = _inputs(shape, c, dtype, dev)
    n = k_norm.launches
    got = k_norm.norm_relu_pool(x, w, b, pool, EPS)
    assert k_norm.launches == n + 1
    want = k_norm.plain(x.cpu(), w.cpu(), b.cpu(), pool, EPS)
    assert got.shape == want.shape
    assert float((got.cpu() - want).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [True, False])
@pytest.mark.parametrize("c", [16, 32])
@pytest.mark.parametrize("ndim,shape", [(2, (2, 5, 7)), (3, (1, 3, 4, 5))])
def test_backward_passes_gradcheck(dev, ndim, shape, c, pool):
    ins = [t.requires_grad_(True)
           for t in _inputs(shape, c, torch.float64, dev, seed=3)]
    n = k_norm.launches
    assert torch.autograd.gradcheck(
        lambda x, w, b: k_norm.norm_relu_pool(x, w, b, pool, EPS), ins,
        eps=1e-6, atol=1e-7, rtol=1e-5)
    assert k_norm.launches > n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-10)])
@pytest.mark.parametrize("c", [16, 32])
def test_backward_at_ties_routes_to_the_first_pixel(dev, c, dtype, tol):
    """Windows whose second row, and first columns, repeat their first
    (exact ties), and offsets that leave some windows all at or below 0:
    the cotangents equal the plain chain's autograd on the CPU, which
    routes a tie to the first pixel in window order and a ReLU-clipped max
    to none."""
    x, w, b = _inputs((2, 6, 5), c, torch.float64, seed=5, bias_shift=-0.5)
    x[:, 1::2] = x[:, 0::2]
    x[:, :, 1] = x[:, :, 0]
    g = torch.Generator().manual_seed(6)
    go = torch.randn(2, 3, 2, c, generator=g, dtype=torch.float64)
    x, w, b, go = (t.to(dtype) for t in (x, w, b, go))
    want = [t.clone().requires_grad_(True) for t in (x, w, b)]
    out = k_norm.plain(*want, True, EPS)
    assert 0.05 < float((out == 0).to(torch.float64).mean()) < 0.95
    out.backward(go)
    got = [t.to(dev).requires_grad_(True) for t in (x, w, b)]
    k_norm.norm_relu_pool(*got, True, EPS).backward(go.to(dev))
    for u, v in zip(got, want):
        assert float((u.grad.cpu() - v.grad).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("ndim", [2, 3])
def test_encoders_on_the_card_match_the_cpu(dev, ndim):
    """Forward and the gradient of every weight and of the input, float64,
    the card's kernels (K-NORM's forward and backward) against the CPU's
    library chain."""
    outs = []
    for device in ("cpu", dev):
        enc = _encoder(ndim, torch.float64, device, seed=2)
        x = _images(ndim, 3, device).requires_grad_(True)
        y = enc(x)
        g = torch.Generator().manual_seed(7)
        y.backward(torch.randn(y.shape, generator=g,
                               dtype=torch.float64).to(device))
        outs.append([y, x.grad] + [p.grad for p in enc.parameters()])
    for u, v in zip(*outs):
        assert float((u - v.cpu()).abs().max()) <= 1e-10 * max(
            1.0, float(u.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("ndim", [2, 3])
def test_one_encoder_forward_launches_five(dev, ndim):
    enc = _encoder(ndim, torch.float32, dev)
    x = _images(ndim, 2, dev, torch.float32)
    n = k_norm.launches
    with torch.no_grad():
        enc(x)
    assert k_norm.launches == n + 5
    enc(x).sum().backward()
    assert k_norm.launches == n + 15


@pytest.mark.cuda
@pytest.mark.parametrize("ndim", [2, 3])
def test_convolutions_hand_the_kernel_channels_last_rows(dev, ndim):
    """The convolutions' outputs, channels-last views, are contiguous, so
    the wrapper passes them to the kernel without a copy."""
    enc = _encoder(ndim, torch.float32, dev)
    x = _images(ndim, 2, dev, torch.float32)
    with torch.no_grad():
        y = enc.convs[0](x.movedim(-1, 1)).movedim(1, -1)
    assert y.is_contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["channels", "dtype"])
def test_a_cuda_tensor_outside_the_instances_raises(dev, case):
    c, dtype = (8, torch.float32) if case == "channels" else (16,
                                                               torch.float16)
    x, w, b = _inputs((1, 4, 4), c, dtype, dev)
    with pytest.raises(ValueError, match="encoder_norm kernel"):
        k_norm.norm_relu_pool(x, w, b, True, EPS)
    if case == "channels":
        enc = tconv.ConvEncoder(2, features=(8, 8, 8, 8, 8)).to(dev)
        with pytest.raises(ValueError, match="C in"):
            enc(_images(2, 1, dev, torch.float32))
