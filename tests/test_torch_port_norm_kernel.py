"""The row-norm kernels (`lcasr_torch/csrc/norms.cu`, wrapper `ops/norms.py`).

On the CPU: the launch shape that `norm_launch` picks from (rows, D, dtype),
and that CPU tensors never reach the kernels.  On the card (marker `cuda`,
skipped without one; `python -m pytest -m cuda
tests/test_torch_port_norm_kernel.py`): the kernels against the plain eager
versions (`layer_norm_ref`, `rms_norm_ref`), which they replace on CUDA
tensors, on the same tensors: the eager elementwise chain fed the kernel's
statistics gives the kernel's output bit for bit (only the row sums are taken
in another order), and the statistics are within fp32 sum bounds of float64;
gradients against the float64 formula; the parameter gradients the
same bits on two runs; and the launch counts of a flagship decode forward,
a Parakeet forward and a checkpointed training step.  This file imports no
JAX: the CPU path's agreement with the JAX package is
tests/test_torch_port_ops.py's.
"""
import pytest
import torch

from lcasr_torch import kernels
from lcasr_torch.ops import norms
from lcasr_torch.ops.norms import (LayerNorm, NormLaunch, RMSNorm, layer_norm_ref, norm_launch,
                                   rms_norm_ref)

NORM_COUNTS = ("layer_norm_fwd", "layer_norm_bwd", "rms_norm_fwd", "rms_norm_bwd")


# (rows, D, dtype, backward): the decode's rows at the flagship's and
# Parakeet's widths, the subsampling's 80 mel bins, and block rows above 1024
@pytest.mark.parametrize("rows, D, dtype, backward, want", [
    (32768, 768, torch.bfloat16, False, NormLaunch(24, False, 128, 528)),
    (32768, 1024, torch.bfloat16, False, NormLaunch(32, False, 128, 396)),
    (32768, 768, torch.bfloat16, True, NormLaunch(24, False, 128, 396)),
    (32768, 768, torch.float32, False, NormLaunch(24, False, 128, 396)),
    (7, 768, torch.bfloat16, False, NormLaunch(24, False, 128, 2)),
    (1, 80, torch.bfloat16, False, NormLaunch(8, False, 128, 1)),
    (32768, 80, torch.float32, False, NormLaunch(8, False, 128, 924)),
    (32768, 4096, torch.bfloat16, False, NormLaunch(8, True, 512, 528)),
    (32768, 4096, torch.float32, True, NormLaunch(8, True, 512, 528)),
    (3, 16384, torch.bfloat16, False, NormLaunch(32, True, 512, 3)),
    (32768, 16384, torch.float32, False, NormLaunch(32, True, 512, 528)),
    (32768, 1032, torch.bfloat16, False, NormLaunch(8, True, 160, 1584)),
], ids=["768_bf16", "1024_bf16", "768_bwd", "768_fp32", "7_rows", "80_one_row", "80_fp32",
        "4096_bf16", "4096_fp32_bwd", "16384_bf16", "16384_fp32", "1032_bf16"])
def test_norm_launch(rows, D, dtype, backward, want):
    assert norm_launch(rows, D, dtype, backward) == want


@pytest.mark.parametrize("D", [8, 64, 80, 256, 264, 768, 1000, 1024, 1032, 4096, 8200, 16384])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("backward", [False, True])
def test_norm_launch_covers_the_row(D, dtype, backward):
    """Every element has a thread, as the kernels' shape check demands, no
    thread holds more than it must, and the grid never exceeds one group a
    row or what the card holds at once."""
    rows = 5000
    p = norm_launch(rows, D, dtype, backward)
    lanes = p.threads if p.block_rows else 32
    assert lanes * p.elems >= D and lanes * (p.elems - 8) < D
    if p.block_rows:
        assert D > 1024 and p.elems in (8, 16, 32) and p.threads % 32 == 0
        assert 32 <= p.threads <= norms.MAX_BLOCK_THREADS and p.grid <= rows
    else:
        assert D <= 1024 and p.elems in (8, 16, 24, 32) and p.threads == norms.WARP_THREADS
        per_sm = norms.warp_blocks_per_sm(p.elems, torch.finfo(dtype).bits // 8, backward)
        assert p.grid == min(-(-rows // 4), norms.CARD_SMS * per_sm)


def test_warp_blocks_per_sm():
    """The register budgets that `__launch_bounds__` holds the warp kernels
    to (csrc/norms.cu `warp_min_blocks`; the card test holds them to the
    device's occupancy): bf16 forward, bf16 backward, fp32 forward."""
    got = [[norms.warp_blocks_per_sm(e, b, bwd) for e in (8, 16, 24, 32)]
           for b, bwd in ((2, False), (2, True), (4, False))]
    assert got == [[8, 5, 4, 3], [7, 4, 3, 3], [7, 4, 3, 3]]


@pytest.mark.parametrize("D, dtype", [(16392, torch.bfloat16), (100, torch.bfloat16),
                                      (6, torch.float32), (0, torch.float32),
                                      (768, torch.float64)])
def test_norm_launch_refuses(D, dtype):
    with pytest.raises(ValueError, match="row-norm kernels"):
        norm_launch(64, D, dtype)


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    monkeypatch.setattr(norms, "row_norm_fwd", None)  # a call would raise
    monkeypatch.setattr(norms, "row_norm_bwd", None)
    kernels.reset_launch_counts()
    for module in (LayerNorm(48), RMSNorm(48)):
        x = torch.randn(2, 7, 48, requires_grad=True)
        module(x).square().sum().backward()
        assert torch.isfinite(x.grad).all() and torch.isfinite(module.scale.grad).all()
        with torch.no_grad():
            module(x)
    assert all(kernels.launch_counts[k] == 0 for k in NORM_COUNTS)


# ---------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the row-norm kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make_case(dev, rows, D, dtype, seed):
    """x (rows, D) of `dtype` with a mean and a spread that differ by row;
    scale 1 + N(0, 0.1) and bias N(0, 0.1), fp32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((rows, D), generator=g, device=dev) * (
        0.5 + torch.rand((rows, 1), generator=g, device=dev) * 2) + torch.randn(
        (rows, 1), generator=g, device=dev)
    scale = 1 + 0.1 * torch.randn((D,), generator=g, device=dev)
    bias = 0.1 * torch.randn((D,), generator=g, device=dev)
    return x.to(dtype), scale, bias


def bf16_ulp(ref: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values (8 significant bits) at |ref|."""
    exponent = torch.frexp(ref.float().abs().clamp_min(2.0 ** -126)).exponent
    return torch.ldexp(torch.ones_like(ref, dtype=torch.float32), exponent - 8)


# The statistics against float64.  The kernel sums a row in fp32 as at most
# 41 terms in sequence (a lane's 32 values, the warp butterfly's 5 levels, a
# block's 4 more), so its mean is within 41 unit roundoffs (2.5e-6) of the
# row's mean |x|; the variance's terms are positive, so it is within 44 of
# itself, and rstd within half of that plus the root's and the division's
# roundings (< 3e-6).  The eager version's tree sums meet the same bounds.
MEAN_TOL = 2.5e-6
RSTD_TOL = 3e-6


def check_statistics(mean, rstd, x, rms: bool, eps: float):
    xd = x.double()
    if rms:
        var = (xd * xd).mean(-1)
    else:
        m64 = xd.mean(-1)
        var = ((xd - m64[:, None]) ** 2).mean(-1)
        gap = (mean.double() - m64).abs() / xd.abs().mean(-1)
        assert float(gap.max()) <= MEAN_TOL, f"mean: {float(gap.max())} of the row's mean |x|"
    gap = (rstd.double() * torch.sqrt(var + eps) - 1).abs()
    assert float(gap.max()) <= RSTD_TOL, f"rstd: relative gap {float(gap.max())}"


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 7, 32768])
@pytest.mark.parametrize("D", [64, 80, 768, 1000, 1024, 4096])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_forward_matches_eager(card, rows, D, dtype):
    """Only the row sums differ from the eager version: its elementwise
    chain fed the kernel's statistics gives the kernel's output bit for
    bit, and both versions' statistics are within fp32 sum bounds of the
    float64 ones.  (Where y cancels to near 0, the statistics' last-bit
    differences are many bf16 ulps of y: no per-value ulp bound holds.)"""
    x, scale, bias = make_case(card, rows, D, dtype, seed=rows * 7 + D)
    xf = x.float()
    for b, eps, kind in ((bias, 1e-5, "layer_norm"), (None, 1e-6, "rms_norm")):
        rms = b is None
        kernels.reset_launch_counts()
        with torch.no_grad():
            y = norms._row_norm(x, scale, b, eps)  # the decode's route: no statistics
        y_stats, mean, rstd = norms.row_norm_fwd(x, scale, b, eps, stats=True)
        torch.cuda.synchronize()
        assert kernels.launch_counts[f"{kind}_fwd"] == 2 and sum(kernels.launch_counts.values()) == 2
        assert y.dtype == dtype and y.shape == x.shape and torch.equal(y, y_stats)
        h = xf * rstd[:, None] if rms else (xf - mean[:, None]) * rstd[:, None]
        assert torch.equal(y, (h * scale if rms else h * scale + b).to(dtype))
        check_statistics(mean, rstd, x, rms, eps)
        eager_mean = xf.mean(-1)
        ms = (xf * xf).mean(-1) if rms else ((xf - eager_mean[:, None]) ** 2).mean(-1)
        check_statistics(eager_mean, torch.reciprocal(torch.sqrt(ms + eps)), x, rms, eps)


@pytest.mark.cuda
def test_forward_saves_statistics_only_for_a_gradient(card):
    x, scale, bias = make_case(card, 300, 768, torch.bfloat16, seed=1)
    y, mean, rstd = norms.row_norm_fwd(x, scale, bias, 1e-5, stats=True)
    assert mean.shape == rstd.shape == (300,) and mean.dtype == rstd.dtype == torch.float32
    assert norms.row_norm_fwd(x, scale, None, 1e-6, stats=True)[1] is None  # RMSNorm: no mean
    assert norms.row_norm_fwd(x, scale, bias, 1e-5, stats=False)[1:] == (None, None)
    leaf = x.clone().requires_grad_()
    with torch.no_grad():  # no gradient wanted: the forward alone, without statistics
        assert torch.equal(LayerNorm(768).to(card)(leaf), norms.row_norm_fwd(
            x, torch.ones(768, device=card), torch.zeros(768, device=card), 1e-5, False)[0])


def exact_gradients(x, scale, bias, dy, eps):
    """(dx, dscale, dbias) of the norm in float64, by autograd over the
    formula (bias None: RMSNorm)."""
    x, scale, dy = (t.double().requires_grad_() for t in (x, scale, dy))
    bias = None if bias is None else bias.double().requires_grad_()
    if bias is None:
        y = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale
    else:
        mean = x.mean(-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(((x - mean) ** 2).mean(-1, keepdim=True) + eps) * scale + bias
    leaves = [x, scale] + ([] if bias is None else [bias])
    return torch.autograd.grad(y, leaves, dy) + ((None,) if bias is None else ())


# fp32 tolerances against the float64 gradients: dx within GRAD_REL of the
# largest |dx| (a row's two sums over D terms, and the cancellation between
# dy g, their mean and x^ (dy g x^)'s mean); dscale and dbias within
# GRAD_REL of their column's sum of |terms| (a fixed-order sum over the rows)
GRAD_REL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("rows, D", [(1, 64), (7, 80), (32768, 768), (4096, 1024), (513, 4096)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["layer_norm", "rms_norm"])
def test_backward_against_float64(card, rows, D, dtype, kind):
    x, scale, bias = make_case(card, rows, D, dtype, seed=rows + D)
    bias = bias if kind == "layer_norm" else None
    eps = 1e-5 if bias is not None else 1e-6
    dy = torch.randn((rows, D), generator=torch.Generator(device=card).manual_seed(5),
                     device=card).to(dtype)
    leaves = [x.clone().requires_grad_(), scale.clone().requires_grad_()] + (
        [] if bias is None else [bias.clone().requires_grad_()])
    kernels.reset_launch_counts()
    y = norms._row_norm(leaves[0], leaves[1], None if bias is None else leaves[2], eps)
    y.backward(dy)
    torch.cuda.synchronize()
    assert kernels.launch_counts[f"{kind}_fwd"] == kernels.launch_counts[f"{kind}_bwd"] == 1
    want = exact_gradients(x, scale, bias, dy, eps)
    dx = leaves[0].grad
    assert dx.dtype == dtype
    slack = bf16_ulp(want[0]) if dtype == torch.bfloat16 else 0.0
    gap = (dx.double() - want[0]).abs()
    assert bool((gap <= slack + GRAD_REL * want[0].abs().max()).all()), \
        f"dx: largest gap {float(gap.max())} of max |dx| {float(want[0].abs().max())}"
    xd = x.double()
    mean = 0.0 if bias is None else xd.mean(-1, keepdim=True)
    var = (xd * xd if bias is None else (xd - mean) ** 2).mean(-1, keepdim=True)
    xhat = (xd - mean) * torch.rsqrt(var + eps)
    terms = [(dy.double() * xhat).abs().sum(0)] + ([] if bias is None else
                                                   [dy.double().abs().sum(0)])
    for name, leaf, exact, mass in zip(("dscale", "dbias"), leaves[1:], want[1:], terms):
        gap = (leaf.grad.double() - exact).abs()
        assert bool((gap <= GRAD_REL * mass).all()), \
            f"{name}: largest gap {float((gap / mass).max())} of its column's sum of |terms|"


@pytest.mark.cuda
@pytest.mark.parametrize("D", [768, 4096])
def test_parameter_gradients_are_the_same_bits_each_run(card, D):
    x, scale, bias = make_case(card, 32768, D, torch.bfloat16, seed=9)
    y, mean, rstd = norms.row_norm_fwd(x, scale, bias, 1e-5, stats=True)
    dy = torch.randn_like(y)
    first = norms.row_norm_bwd(x, dy, mean, rstd, scale)
    again = norms.row_norm_bwd(x, dy, mean, rstd, scale)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_launch_shapes_fit_the_card(card):
    """The warp kernels' blocks an SM, which `norm_launch`'s grid assumes, are
    what the device holds at once (registers held by `__launch_bounds__`)."""
    import ctypes

    lib = kernels.library("norms.cu")
    for dtype, code in ((torch.bfloat16, 1), (torch.float16, 2), (torch.float32, 0)):
        for elems in (8, 16, 24, 32):
            for backward in (False, True):
                held = ctypes.c_int(0)
                kernels.check(lib, lib.lcasr_row_norm_blocks_per_sm(
                    code, elems, 0, norms.WARP_THREADS, int(backward), ctypes.byref(held)),
                    "row-norm occupancy")
                want = norms.warp_blocks_per_sm(elems, torch.finfo(dtype).bits // 8, backward)
                assert held.value >= want, (dtype, elems, backward, held.value, want)


def count_forward(model, frames):
    kernels.reset_launch_counts()
    audio = torch.randn((1, 80, frames), device="cuda")
    with torch.no_grad():
        model(audio)
    torch.cuda.synchronize()
    return {k: kernels.launch_counts[k] for k in NORM_COUNTS}


@pytest.mark.cuda
def test_flagship_forward_launches(card):
    """One window of the flagship decode: five LayerNorms in each of 9 layers."""
    from lcasr_torch.models.sconformer_xl import FLAGSHIP, SCConformerXL, init_weights_

    model = init_weights_(SCConformerXL(**FLAGSHIP, dtype=torch.bfloat16, device="cuda"),
                          seed=0).eval()
    assert count_forward(model, 16384) == {"layer_norm_fwd": 45, "layer_norm_bwd": 0,
                                           "rms_norm_fwd": 0, "rms_norm_bwd": 0}


@pytest.mark.cuda
def test_parakeet_forward_launches(card):
    """One window of Parakeet-CTC-1.1B: five LayerNorms in each of 42 layers."""
    from lcasr_torch.models.fastconformer import FastConformerCTC

    model = FastConformerCTC(dtype=torch.bfloat16, device="cuda").eval()
    assert count_forward(model, 16384) == {"layer_norm_fwd": 210, "layer_norm_bwd": 0,
                                           "rms_norm_fwd": 0, "rms_norm_bwd": 0}


@pytest.mark.cuda
def test_training_step_launches(card):
    """A training step with every layer recomputed: each LayerNorm runs
    forward twice (the step, the recompute) and backward once."""
    from lcasr_torch.models.sconformer_xl import SCConformerXL, init_weights_

    layers = 2
    model = init_weights_(SCConformerXL(
        vocab_size=64, d_model=768, n_layers=layers, n_heads=6, head_dim=128,
        subsampling_conv_channels=256, checkpoint_every_n_layers=1, dtype=torch.bfloat16,
        device="cuda"), seed=0)
    audio = torch.randn((2, 80, 2048), device="cuda")
    kernels.reset_launch_counts()
    out = model(audio, torch.tensor([2048, 1500], device="cuda"), train=True)
    out["final_posteriors"].float().logsumexp(-1).sum().backward()
    torch.cuda.synchronize()
    assert {k: kernels.launch_counts[k] for k in NORM_COUNTS} == {
        "layer_norm_fwd": 2 * 5 * layers, "layer_norm_bwd": 5 * layers,
        "rms_norm_fwd": 0, "rms_norm_bwd": 0}
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)
