"""lcasr_torch's long convolution (ops/long_conv.py and `conv_type:
longconv` in SCConformerXL) against lcasr_tpu's, on the CPU in fp32.

Both sides compute three FFTs and one GEMM in fp32 (jnp.fft / torch.fft):
outputs agree to 2e-5 of the largest output (float sums of up to a few
hundred terms through FFTs in another order).  Model log-probs keep the
model tests' 1e-4, gradients 1e-4 of each tensor's largest entry with a
floor of 1e-6 of the largest gradient of all (tests/test_torch_port_mamba.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcasr_torch.models.import_jax import flax_from_state_dict, state_dict_from_flax
from lcasr_torch.ops import long_conv as tlc
from tests.test_torch_port_ops import randomize

TOL = 2e-5
ATOL = 1e-4


def _close(got, want, tol=TOL, what=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, float(np.abs(want).max())),
                               rtol=0, err_msg=what)


def _fix_base_rates(tree):
    """`randomize` draws every leaf as a weight; the position kernel's base
    rates are the log's argument and must stay positive."""
    for key, value in tree.items():
        if key == "base_rates":
            tree[key] = np.asarray([0.01, 1.0, 1.0], np.float32) * np.exp(
                np.random.default_rng(0).normal(0.0, 0.1, 3)).astype(np.float32)
        elif isinstance(value, dict):
            _fix_base_rates(value)
    return tree


@pytest.mark.parametrize("window", [7, 5])
def test_kernel_helpers_match_jax(window):
    from lcasr_tpu.ops import long_conv as jlc

    rng = np.random.default_rng(window)
    k = rng.normal(size=(2, 3, 40)).astype(np.float32)
    kt = torch.from_numpy(k)
    _close(tlc.squash_kernel(kt, 0.3), jlc.squash_kernel(jnp.asarray(k), 0.3), what="squash")
    _close(tlc.ma_smooth_kernel(kt, window), jlc.ma_smooth_kernel(jnp.asarray(k), window),
           what="moving average")
    _close(tlc.freq_smooth_kernel(kt, window), jlc.freq_smooth_kernel(jnp.asarray(k), window),
           what="spectrum smoothing")
    x = rng.normal(size=(2, 30, 3)).astype(np.float32)
    kc = rng.normal(size=(3, 12)).astype(np.float32)
    _close(tlc.fft_conv(torch.from_numpy(x), torch.from_numpy(kc)),
           jlc.fft_conv(jnp.asarray(x), jnp.asarray(kc)), what="fft_conv")
    with pytest.raises(ValueError, match="odd"):
        tlc.ma_smooth_kernel(kt, 4)


def test_double_exp_init_has_the_jax_envelope():
    from lcasr_tpu.ops.long_conv import double_exp_init

    want = np.asarray(double_exp_init(1.0)(jax.random.PRNGKey(0), (2, 4, 50)))
    got = tlc.double_exp_init((2, 4, 50), 1.0, torch.Generator().manual_seed(0)).numpy()
    # different random draws under the same envelope: per (head, position)
    # the root mean square over channels and many draws follows it
    env = np.exp(-(np.arange(50) / 50)[None] * np.power(2.0, np.arange(4)[:, None] / 4))
    for arr in (want, got):
        assert arr.shape == (2, 4, 50)
        assert np.all(np.abs(arr) <= 6.0 * env[None])


LONGCONV_CASES = {
    # (position_kernel, bidirectional, L, smoothing); l_max is 24
    "position_bi_short": (True, True, 16, None),
    "position_bi_long": (True, True, 40, None),
    "position_causal": (True, False, 16, None),
    "direct_bi_long": (False, True, 40, None),
    "direct_ma": (False, True, 16, "ma"),
    "direct_freq": (False, True, 40, "freq"),
}


@pytest.mark.parametrize("case", sorted(LONGCONV_CASES))
def test_longconv_module_matches_jax(case):
    """Both kernel sources, both smoothings, L below l_max (the direct
    kernel cropped by the rfft) and above it; padded frames masked."""
    from lcasr_tpu.ops.long_conv import LongConv as JLongConv

    position, bi, L, smooth = LONGCONV_CASES[case]
    kw = dict(l_max=24, bidirectional=bi, position_kernel=position,
              use_ma_smoothing=smooth is not None, smooth_freq=smooth == "freq")
    jm = JLongConv(12, **kw)
    x = np.random.default_rng(1).normal(size=(2, L, 12)).astype(np.float32)
    variables = _fix_base_rates(randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                                          seed=2))
    if not kw["position_kernel"]:  # the direct kernel's scale, so that squash keeps some
        variables["params"]["kernel"] = variables["params"]["kernel"] * 0.05
    port = tlc.LongConv(12, **kw)
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    pad = np.arange(L)[None] >= np.array([L, L - 5])[:, None]
    want = jm.apply(variables, jnp.asarray(x), pad_mask=jnp.asarray(pad))
    got = port(torch.from_numpy(x), pad_mask=torch.from_numpy(pad))
    _close(got, want, what=case)
    # the flax names round-trip
    back = flax_from_state_dict(port.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, variables))


TINY = dict(vocab_size=16, d_model=64, n_layers=2, n_heads=2, head_dim=32,
            subsampling_conv_channels=32, use_rotary=True, conv_type="longconv")


@pytest.mark.parametrize("option", [
    dict(), dict(longconv_position_kernel=False, longconv_ma_smoothing=True),
    dict(longconv_position_kernel=False, longconv_ma_smoothing=True,
         longconv_smooth_freq=True, longconv_weight_init="double_exp"),
], ids=["position", "direct_ma", "direct_freq"])
def test_model_forward_and_gradient_match_jax(option):
    """SCConformerXL with conv_type longconv: log-probs, and the gradient of
    every parameter of a weighted sum of them (eval-mode norms)."""
    from lcasr_tpu.models.sconformer_xl import SCConformerXL as JModel
    from lcasr_torch.models.sconformer_xl import SCConformerXL

    cfg = dict(TINY, **option)
    jm = JModel(**cfg)
    variables = _fix_base_rates(randomize(jm.init(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, 80, 128))), seed=3))
    port = SCConformerXL(**cfg, device="cpu")
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    rng = np.random.default_rng(4)
    audio = rng.normal(size=(2, 80, 200)).astype(np.float32)
    lengths = np.array([200, 131], np.int32)
    weight = rng.normal(size=(2, 25, 17)).astype(np.float32)

    def f(params):
        # the long convolution has no batch statistics: no such collection
        lp = jm.apply({"params": params},
                      jnp.asarray(audio), length=jnp.asarray(lengths))["final_posteriors"]
        return (lp * weight).sum(), lp

    (loss_j, lp_j), g_j = jax.jit(jax.value_and_grad(f, has_aux=True))(variables["params"])
    out = port(torch.from_numpy(audio), length=torch.from_numpy(lengths))
    _close(out["final_posteriors"], lp_j, ATOL, "log-probs")
    (out["final_posteriors"] * torch.from_numpy(weight)).sum().backward()
    want = state_dict_from_flax({"params": jax.tree.map(np.asarray, g_j)})
    params = dict(port.named_parameters())
    assert set(want) == set(params)
    gmax = max(w.abs().max().item() for w in want.values())
    for name, w in want.items():
        tol = 1e-4 * max(w.abs().max().item(), 1e-2 * gmax)
        np.testing.assert_allclose(params[name].grad.numpy(), w.numpy(), atol=tol, rtol=0,
                                   err_msg=name)


def test_longconv_refused_under_context_parallelism():
    from lcasr_torch.models.sconformer_xl import SCConformerXL
    from lcasr_torch.parallel.mesh import bind
    from tests.test_torch_port_analysis import _StubMesh

    model = SCConformerXL(**TINY, seq_axis_name="seq", device="cpu")
    model.parallel.mesh = _StubMesh()
    bind(model, model.parallel)
    with pytest.raises(NotImplementedError, match="position-local convs"):
        model.layers[0](torch.zeros(1, 16, 64))
    with pytest.raises(ValueError, match="conv_type"):
        SCConformerXL(**dict(TINY, conv_type="fft"), device="cpu")
