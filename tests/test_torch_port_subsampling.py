"""lcasr_torch's fused dw_striding subsampling against lcasr_tpu's, on the CPU
in fp32.

The JAX side runs its fused Pallas kernel in interpret mode, as
tests/test_subsampling_fused.py runs it; the port's `fused_dw_striding` runs
its kernel's plain version (`dw_striding_chain`), the only thing it can run
on a CPU tensor.  The same parameters go to both: HWIO on the JAX side, OIHW
on the port's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcasr_tpu.ops.subsampling_pallas import fused_dw_striding as jax_fused
from lcasr_torch.ops import subsampling as ts
from tests.test_torch_port_ops import load_port, randomize, t

SHAPES = [  # tests/test_subsampling_fused.py:29-37
    (2, 256, 80, "silu"),
    (1, 512, 80, "gelu"),
    (2, 328, 80, "relu"),
    (1, 256, 64, "silu"),
]
C = 128


def _params(rng):
    """(HWIO tuple for JAX, OIHW list for the port) of one random 3-stage chain."""
    hwio = [rng.normal(size=(3, 3, 1, C)) * 0.2, rng.normal(size=(C,)) * 0.2]
    for _ in range(2):
        hwio += [rng.normal(size=(3, 3, 1, C)) * 0.2, rng.normal(size=(C,)) * 0.2,
                 rng.normal(size=(1, 1, C, C)) * 0.06, rng.normal(size=(C,)) * 0.2]
    hwio = [a.astype(np.float32) for a in hwio]
    oihw = [t(np.ascontiguousarray(a.transpose(3, 2, 0, 1))) if a.ndim == 4 else t(a)
            for a in hwio]
    return tuple(jnp.asarray(a) for a in hwio), oihw


@pytest.mark.parametrize("B,T,F,act", SHAPES)
def test_fused_matches_jax_fused(B, T, F, act):
    """fp32 on both sides, fp32 accumulation in another order: 2e-5, the
    JAX test's own tolerance against its conv chain."""
    rng = np.random.default_rng(B * 1000 + T + F)
    x = rng.normal(size=(B, T, F)).astype(np.float32)
    jp, tp = _params(rng)
    want = np.asarray(jax_fused(jnp.asarray(x), jp, act, True))  # interpret mode
    got = ts.fused_dw_striding(t(x), tp, act)
    assert got.shape == want.shape == (B, T // 8, F // 8, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,T,F,act", SHAPES)
def test_module_with_the_flag_matches_jax_fused(B, T, F, act, monkeypatch):
    """ConvSubsampling under LCASR_FUSED_SUB=1 takes the fused route on these
    shapes (asserted by counting its calls) and equals the JAX module whose
    chain is the fused kernel in interpret mode."""
    import lcasr_tpu.ops.subsampling_pallas as jsp
    from lcasr_tpu.ops.conv import ConvSubsampling as JSub
    from lcasr_torch.ops import conv as tconv

    rng = np.random.default_rng(B + T + F)
    x = rng.normal(size=(B, T, F)).astype(np.float32)
    lengths = np.array([T, T - 37][:B], np.int32)
    kw = dict(feat_in=F, feat_out=48, conv_channels=C, activation=act)
    jm = JSub(**kw)
    variables = randomize(jm.init(jax.random.PRNGKey(0), x, lengths), seed=3)
    # the JAX gate also asks for a TPU backend: open it, and run the kernel
    # in the interpreter, for this test only
    monkeypatch.setattr(jsp, "fused_subsampling_enabled", lambda: True)
    jax_calls, calls = [], []
    monkeypatch.setattr(jsp, "fused_dw_striding",
                        lambda x_, p_, a_: jax_calls.append(1) or jax_fused(x_, p_, a_, True))
    want, want_len = jm.apply(variables, x, lengths)
    assert jax_calls == [1]

    real = ts.fused_dw_striding
    monkeypatch.setattr(tconv, "fused_dw_striding",
                        lambda *a: calls.append(1) or real(*a))
    port = load_port(tconv.ConvSubsampling(**kw), variables)
    monkeypatch.setenv("LCASR_FUSED_SUB", "1")
    got, got_len = port(t(x), t(lengths))
    assert calls == [1]
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    # the `out` projection sums F/8 * 128 terms of O(1): 1e-4
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=0)
    monkeypatch.setenv("LCASR_FUSED_SUB", "0")
    again, _ = port(t(x), t(lengths))
    assert calls == [1]
    np.testing.assert_allclose(again.detach().numpy(), got.detach().numpy(), atol=1e-5, rtol=0)


def test_fused_gradients_match_jax_custom_vjp():
    """Both backwards recompute through the conv chain: the gradients of x
    and of every parameter agree to 1e-5."""
    rng = np.random.default_rng(3)
    B, T, F = 1, 256, 80
    x = rng.normal(size=(B, T, F)).astype(np.float32)
    co = rng.normal(size=(B, T // 8, F // 8, C)).astype(np.float32)
    jp, tp = _params(rng)

    def loss(x_, params_):
        return (jax_fused(x_, params_, "silu", True) * co).sum()

    gx_j, gp_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jp)
    xt = t(x).requires_grad_()
    tp = [p.requires_grad_() for p in tp]
    (ts.fused_dw_striding(xt, tp, "silu") * t(co)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), rtol=1e-5, atol=1e-5)
    for got, want in zip(tp, gp_j):
        want = np.asarray(want)
        want = want.transpose(3, 2, 0, 1) if want.ndim == 4 else want
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=1e-5, atol=1e-5)


def test_fused_gradients_only_where_asked():
    """A frozen parameter gets no gradient and costs no error."""
    rng = np.random.default_rng(4)
    _, tp = _params(rng)
    x = t(rng.normal(size=(1, 64, 64)).astype(np.float32)).requires_grad_()
    tp[4].requires_grad_()
    ts.fused_dw_striding(x, tp, "relu").sum().backward()
    assert x.grad is not None and tp[4].grad is not None and tp[0].grad is None


@pytest.mark.parametrize("bad", ["T", "F", "C", "stages", "act"])
def test_fused_refuses_what_the_kernel_does_not_take(bad):
    """The checks of the wrapper hold on the CPU too: T % 8, F % 8, C % 128,
    three stages, a known activation."""
    rng = np.random.default_rng(5)
    _, tp = _params(rng)
    T, F, act = (250 if bad == "T" else 256), (84 if bad == "F" else 80), "silu"
    if bad == "C":
        tp = [p[:100] if p.ndim == 1 else p[:100, :100 if p.shape[1] > 1 else 1] for p in tp]
    if bad == "stages":
        tp = tp[:6]
    if bad == "act":
        act = "swish"
    with pytest.raises(ValueError):
        ts.fused_dw_striding(torch.zeros(1, T, F), tp, act)


def test_gate_and_eligibility(monkeypatch):
    monkeypatch.delenv("LCASR_FUSED_SUB", raising=False)
    assert not ts.fused_subsampling_enabled()
    monkeypatch.setenv("LCASR_FUSED_SUB", "1")
    assert ts.fused_subsampling_enabled()
    assert ts.fused_eligible(16384, 80, 256, 3) and ts.fused_eligible(120000, 80, 128, 3)
    for args in ((16380, 80, 256, 3), (16384, 84, 256, 3), (16384, 80, 32, 3),
                 (16384, 80, 256, 2)):
        assert not ts.fused_eligible(*args)
    assert not ts.fused_eligible(16384, 80, 256, 3, is_causal=True)


def test_module_keeps_the_conv_chain_for_ineligible_shapes(monkeypatch):
    """Under the flag a shape the fused chain does not take (T % 8 != 0, 32
    channels, causal) runs the conv chain as before."""
    from lcasr_torch.ops import conv as tconv

    monkeypatch.setenv("LCASR_FUSED_SUB", "1")
    monkeypatch.setattr(tconv, "fused_dw_striding",
                        lambda *a: pytest.fail("the fused route was taken"))
    torch.manual_seed(0)
    for kw, T in ((dict(conv_channels=128), 203), (dict(conv_channels=32), 256),
                  (dict(conv_channels=128, is_causal=True), 256)):
        m = tconv.ConvSubsampling(feat_in=80, feat_out=16, **kw)
        y, _ = m(torch.randn(1, T, 80), torch.tensor([T]))
        assert torch.isfinite(y).all()


@pytest.mark.parametrize("C", range(128, 2049, 128))
def test_kernel_takes_every_channel_count_the_gate_accepts(C):
    """Every C that `fused_eligible` accepts up to 2048 (the widest d_model
    in configs/) is one the launch's input check passes, in bf16 and fp32,
    at the decode's window batch and at the 120,000-frame step."""
    for B, T in ((16, 16384), (1, 120000)):
        assert ts.fused_eligible(T, 80, C, 3)
        for dtype in (torch.bfloat16, torch.float32):
            ts.check_kernel_takes(B, T, 80, C, dtype)


@pytest.mark.parametrize("C,F,limit", [(2176, 80, "2048 conv channels"),
                                       (256, 176, "168 input features")])
def test_kernel_refuses_past_its_limits_with_a_message(C, F, limit):
    """Past the kernel's limits the check raises and names the limit, though
    the gate accepts the shape (so such a model raises under the flag on the
    card)."""
    assert ts.fused_eligible(16384, F, C, 3)
    with pytest.raises(ValueError, match=limit):
        ts.check_kernel_takes(16, 16384, F, C, torch.bfloat16)


def test_kernel_refuses_other_dtypes():
    with pytest.raises(TypeError, match="bf16 or fp32"):
        ts.check_kernel_takes(16, 16384, 80, 256, torch.float16)


def _wide_params(rng, C):
    """A random 3-stage chain of C channels, HWIO for JAX and OIHW for the
    port; pointwise weights scaled by 1 / sqrt(C) so that the outputs stay
    O(1) at any width."""
    hwio = [rng.normal(size=(3, 3, 1, C)) * 0.2, rng.normal(size=(C,)) * 0.2]
    for _ in range(2):
        hwio += [rng.normal(size=(3, 3, 1, C)) * 0.2, rng.normal(size=(C,)) * 0.2,
                 rng.normal(size=(1, 1, C, C)) * (0.06 * np.sqrt(128 / C)),
                 rng.normal(size=(C,)) * 0.2]
    hwio = [a.astype(np.float32) for a in hwio]
    oihw = [t(np.ascontiguousarray(a.transpose(3, 2, 0, 1))) if a.ndim == 4 else t(a)
            for a in hwio]
    return tuple(jnp.asarray(a) for a in hwio), oihw


@pytest.mark.parametrize("C,T", [(384, 328), (512, 256)])
def test_fused_matches_jax_fused_at_wide_channels(C, T):
    """The channel counts the kernel now takes beyond 256, against the JAX
    fused kernel in interpret mode, fp32 on both sides: 2e-5, as at 128
    (T = 328 leaves a ragged last tile on both sides)."""
    rng = np.random.default_rng(C + T)
    x = rng.normal(size=(1, T, 80)).astype(np.float32)
    jp, tp = _wide_params(rng, C)
    want = np.asarray(jax_fused(jnp.asarray(x), jp, "silu", True))  # interpret mode
    got = ts.fused_dw_striding(t(x), tp, "silu")
    assert got.shape == want.shape == (1, T // 8, 10, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_chip_smoke_bounds_k8_by_one_exponential_per_chain_value():
    """K8's bound in chip_smoke.py: at the decode shape, one special-function
    operation for each of the chain's 1.7616 G activation values (16 a clock
    on each of 132 SMs at 1,980 MHz) takes 0.4212 ms, above the tensor
    cores' 0.2492 ms and the bytes' 0.063 ms; without silu the tensor cores
    bound it."""
    import chip_smoke as cs

    B, T, F, C = cs.SUB_DECODE_SHAPE
    ms, by, parts, flops = cs.sub_bound(B, T, F, C, 2, "bf16", 132, 1.98e9)
    assert parts["by"] == "special functions" and by == "operations"
    assert ms == pytest.approx(0.4212, abs=1e-4)
    assert parts["tensor cores"] == pytest.approx(0.2492, abs=1e-4)
    assert parts["bytes"] == pytest.approx(0.063, abs=1e-3)
    assert flops == pytest.approx(246.4e9, rel=1e-3)
    ms, by, parts, _ = cs.sub_bound(B, T, F, C, 2, "bf16", 132, 1.98e9, act="relu")
    assert parts["by"] == "tensor cores" and ms == parts["tensor cores"]


@pytest.mark.parametrize("ref", [1.0, -3.0, 0.0078125, 200.0])
def test_chip_smoke_counts_bf16_ulps_at_the_reference(ref):
    """The silu-tail case's measure: one bf16 ulp at ref is 2^(e - 8) for
    |ref| in [2^(e-1), 2^e), so ref plus k of its ulps reads k."""
    import chip_smoke as cs

    r = torch.tensor([ref])
    ulp = torch.ldexp(torch.ones(1), torch.frexp(r)[1] - 8)
    for k in (0.0, 1.0, 2.5):
        assert cs.bf16_ulps(torch, r + k * ulp, r).item() == pytest.approx(k)
