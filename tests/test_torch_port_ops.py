"""lcasr_torch ops against their lcasr_tpu counterparts, on the CPU in fp32.

Weights come from flax `init`, are redrawn from a numpy seed (so no
parameter sits at a trivial value such as scale 1 or bias 0), go through
`state_dict_from_flax` and are loaded into the port's module with
strict=True.  Inputs come from numpy.  Tolerances are fp32: both sides do
the same arithmetic in another order, so they agree to a few ulps of the
values' magnitude; 1e-5 absolute leaves a margin for sums over a few
hundred terms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcasr_torch.models.import_jax import state_dict_from_flax

ATOL = 1e-5


def randomize(variables, seed=0):
    """numpy copy of a flax variables tree with every float leaf redrawn."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1]
        leaf = np.asarray(leaf)
        if name == "num_batches_tracked" or name == "inv_freq":
            return leaf
        if name == "running_std":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "running_mean":
            return rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)
        if name == "scale" or (name == "weight" and leaf.ndim == 1):
            return (1.0 + rng.normal(0.0, 0.1, leaf.shape)).astype(np.float32)
        if name in ("bias", "depthwise_bias"):
            return rng.normal(0.0, 0.05, leaf.shape).astype(np.float32)
        fan_in = leaf.shape[0] if name == "depthwise_kernel" else int(np.prod(leaf.shape[:-1]))
        return rng.normal(0.0, fan_in ** -0.5, leaf.shape).astype(np.float32)

    def walk(tree, path=()):
        return {k: walk(v, path + (k,)) if isinstance(v, dict) else draw(path + (k,), v)
                for k, v in tree.items()}

    return walk(jax.tree.map(np.asarray, dict(variables)))


def load_port(module, variables):
    """Load flax variables into a port module (strict) and return it in eval."""
    module.load_state_dict(state_dict_from_flax(variables), strict=True)
    return module.eval()


def t(x):
    return torch.from_numpy(np.asarray(x))


def assert_close(got, want, atol=ATOL, rtol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["layer_norm", "rms_norm"])
def test_norms_match_jax(kind):
    from lcasr_tpu.ops.norms import get_norm as jax_norm
    from lcasr_torch.ops.norms import get_norm

    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 7, 48)) * 3 + 1).astype(np.float32)
    jm = jax_norm(kind)(48)
    variables = randomize(jm.init(jax.random.PRNGKey(0), x), seed=2)
    want = jm.apply(variables, x)
    port = load_port(get_norm(kind)(48), variables)
    assert_close(port(t(x)), want)


# ---------------------------------------------------------------------------
# rotary
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("interp,offset", [(1.0, 0), (4.0, 0), (1.0, 13)])
def test_rotary_tables_and_apply_match_jax(interp, offset):
    from lcasr_tpu.ops import rotary as jr
    from lcasr_torch.ops import rotary as tr

    T, D = 40, 32
    cos_j, sin_j = jr.rotary_tables(T + offset, D, base=1.5e6, interpolation_factor=interp)
    cos_t, sin_t = tr.rotary_tables(T + offset, D, base=1.5e6, interpolation_factor=interp)
    # positions up to ~50 times frequencies up to 1: fp32 cos/sin of the
    # same fp32 arguments
    assert_close(cos_t, cos_j, atol=1e-6)
    assert_close(sin_t, sin_j, atol=1e-6)

    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, T, 3, D)).astype(np.float32)
    k = rng.normal(size=(2, T + offset, 3, D)).astype(np.float32)
    qj, kj = jr.apply_rotary(q, k, cos_j, sin_j, q_offset=offset)
    qt, kt = tr.apply_rotary(t(q), t(k), cos_t, sin_t, q_offset=offset)
    assert_close(qt, qj)
    assert_close(kt, kj)


def test_rotary_bf16_promotes_and_casts_back():
    from lcasr_tpu.ops import rotary as jr
    from lcasr_torch.ops import rotary as tr

    rng = np.random.default_rng(4)
    q = rng.normal(size=(1, 16, 2, 32)).astype(np.float32)
    cos_j, sin_j = jr.rotary_tables(16, 32)
    cos_t, sin_t = tr.rotary_tables(16, 32)
    qj, _ = jr.apply_rotary(jnp.asarray(q, jnp.bfloat16), jnp.asarray(q, jnp.bfloat16), cos_j, sin_j)
    qt, _ = tr.apply_rotary(t(q).bfloat16(), t(q).bfloat16(), cos_t, sin_t)
    assert qt.dtype == torch.bfloat16
    # both compute in fp32 from the same bf16 inputs and round once to bf16:
    # at most one bf16 ulp apart where the fp32 values straddle a rounding edge
    assert_close(qt.float(), np.asarray(qj.astype(jnp.float32)), atol=2e-2)


def test_learned_rotary_embedding_matches_jax():
    from lcasr_tpu.ops.rotary import RotaryEmbedding as JRot
    from lcasr_torch.ops.rotary import RotaryEmbedding

    jm = JRot(dim=32, base=1e4, learned_freq=True, interpolation_factor=2.0)
    variables = jm.init(jax.random.PRNGKey(0), 24)
    variables = {"params": {"inv_freq": np.asarray(variables["params"]["inv_freq"]) * 1.3}}
    cos_j, sin_j = jm.apply(variables, 24)
    port = load_port(RotaryEmbedding(32, base=1e4, learned_freq=True,
                                     interpolation_factor=2.0), variables)
    cos_t, sin_t = port(24)
    assert_close(cos_t, cos_j, atol=1e-6)
    assert_close(sin_t, sin_j, atol=1e-6)


# ---------------------------------------------------------------------------
# feed-forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bias", [False, True])
def test_feed_forward_matches_jax(bias):
    from lcasr_tpu.ops.mlp import ConformerFeedForward as JFF
    from lcasr_torch.ops.mlp import ConformerFeedForward

    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 9, 32)).astype(np.float32)
    jm = JFF(32, hidden_dim=128, bias1=bias, bias2=bias)
    variables = randomize(jm.init(jax.random.PRNGKey(0), x), seed=6)
    port = load_port(ConformerFeedForward(32, 128, bias1=bias, bias2=bias), variables)
    assert_close(port(t(x)), jm.apply(variables, x))


# ---------------------------------------------------------------------------
# convolutions
# ---------------------------------------------------------------------------
def test_conv_subsampling_matches_jax_with_ragged_lengths():
    from lcasr_tpu.ops.conv import ConvSubsampling as JSub
    from lcasr_torch.ops.conv import ConvSubsampling

    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 203, 80)).astype(np.float32)
    lengths = np.array([203, 150, 9], np.int32)
    jm = JSub(feat_in=80, feat_out=48, conv_channels=16, use_pallas=False)
    variables = randomize(jm.init(jax.random.PRNGKey(0), x, lengths), seed=8)
    want, want_len = jm.apply(variables, x, lengths)
    port = load_port(ConvSubsampling(feat_in=80, feat_out=48, conv_channels=16), variables)
    got, got_len = port(t(x), t(lengths))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert_close(got, want, atol=1e-4)  # sums over 9*16 and 160 terms of O(1)


def test_conv_subsampling_other_modes_raise():
    from lcasr_torch.ops.conv import ConvSubsampling

    with pytest.raises(NotImplementedError):
        ConvSubsampling(subsampling="striding")
    with pytest.raises(NotImplementedError):
        ConvSubsampling(is_causal=True)


def test_calc_length_matches_jax():
    from lcasr_tpu.ops.conv import calc_length as jcalc
    from lcasr_torch.ops.conv import calc_length

    lengths = np.arange(0, 2000, 7, dtype=np.int32)
    for kw in (dict(all_paddings=2, kernel_size=3, stride=2, ceil_mode=False, repeat_num=3),
               dict(all_paddings=0, kernel_size=2, stride=2, ceil_mode=True, repeat_num=3)):
        np.testing.assert_array_equal(calc_length(t(lengths), **kw).numpy(),
                                      np.asarray(jcalc(jnp.asarray(lengths), **kw)))


def test_conformer_convolution_eval_matches_jax_with_pad_mask():
    from lcasr_tpu.ops.conv import ConformerConvolution as JConv
    from lcasr_torch.ops.conv import ConformerConvolution

    rng = np.random.default_rng(9)
    x = rng.normal(size=(3, 30, 32)).astype(np.float32)
    lengths = np.array([30, 17, 4])
    pad_mask = np.arange(30)[None, :] >= lengths[:, None]
    jm = JConv(d_model=32, kernel_size=9)
    variables = randomize(jm.init(jax.random.PRNGKey(0), x, pad_mask=pad_mask), seed=10)
    want = jm.apply(variables, x, pad_mask=pad_mask, train=False)
    port = load_port(ConformerConvolution(32, 9), variables)
    assert_close(port(t(x), pad_mask=t(pad_mask)), want)
    # train mode is ported now (tests/test_torch_port_train.py holds it
    # against JAX); here: it runs and moves the statistics once
    port(t(x), pad_mask=t(pad_mask), train=True)
    assert int(port.norm.num_batches_tracked) == 1


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("norm", [False, True])
def test_decoder_matches_jax(norm):
    from lcasr_tpu.models.decoder import ASRLinearSCDecoder as JDec
    from lcasr_torch.models.decoder import ASRLinearSCDecoder

    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 6, 32)).astype(np.float32)
    jm = JDec(d_model=32, vocab_size=15, norm=norm)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), x))
    # reprojection is used by self-conditioning only: initialise it too
    variables = randomize(jax.tree.map(np.asarray, {
        "params": {**variables["params"],
                   "reprojection": jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 16)),
                                           method=JDec.project_back)["params"]["reprojection"]}
    }), seed=12)
    port = load_port(ASRLinearSCDecoder(32, 15, norm=norm), variables)
    assert_close(port(t(x)), jm.apply(variables, x))
    assert_close(port(t(x), logits=True), jm.apply(variables, x, logits=True))
    p = rng.normal(size=(2, 6, 16)).astype(np.float32)
    assert_close(port.project_back(t(p)), jm.apply(variables, p, method=JDec.project_back))


# ---------------------------------------------------------------------------
# attention: the kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------
ATTN_CASES = {
    "ragged_and_zero_lengths": dict(lengths=[200, 131, 0]),
    "band": dict(lengths=[200, 131, 0], window=(16, 24)),
    "one_sided_band": dict(lengths=[200, 77, 150], window=(-1, 5)),
    "q_offset": dict(lengths=[230, 131, 0], q_offset=37),
    "q_offset_band": dict(lengths=[200, 160, 60], window=(16, 24), q_offset=37),
    "kv_offset": dict(lengths=[250, 131, 0], q_offset=40, kv_offset=20),
    "no_lengths": dict(),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_ref_matches_pallas_interpret(case):
    """Pallas runs in its interpreter on the CPU (as tests/test_flash_attention.py
    runs it).  Both sides are fp32 with the same pre-scaled q, so o and lse
    agree to fp32 rounding: atol 1e-5."""
    from lcasr_tpu.ops.flash_attention import flash_attention_with_lse as pallas_fwd
    from lcasr_torch.ops.flash_attention import flash_attention_ref, flash_attention_with_lse

    kw = ATTN_CASES[case]
    rng = np.random.default_rng(13)
    B, T, H, D = 3, 200, 2, 32
    q, k, v = (rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(3))
    lengths = np.asarray(kw["lengths"], np.int32) if "lengths" in kw else None
    window = kw.get("window", (-1, -1))
    qo, ko = kw.get("q_offset", 0), kw.get("kv_offset", 0)
    o_j, lse_j = pallas_fwd(
        q, k, v, lengths=None if lengths is None else jnp.asarray(lengths), window=window,
        q_offset=jnp.int32(qo) if qo else None, kv_offset=jnp.int32(ko) if ko else None,
    )
    lt = None if lengths is None else t(lengths)
    o_t, lse_t = flash_attention_ref(t(q), t(k), t(v), lt, window, None, qo, ko)
    assert_close(o_t, o_j)
    assert_close(lse_t, lse_j)
    # the wrapper takes the plain version for CPU tensors
    o_w, lse_w = flash_attention_with_lse(t(q), t(k), t(v), lt, window, None, qo, ko)
    assert torch.equal(o_w, o_t) and torch.equal(lse_w, lse_t)
    if lengths is not None and (lengths == 0).any():
        zero = np.flatnonzero(lengths == 0)
        assert (o_t[zero] == 0).all() and (lse_t[zero] == -1e30).all()


def test_flash_attention_ref_matches_reference_attention_bf16():
    """The plain version in bf16 against lcasr_torch's exact oracle: same
    masks, bf16 output rounding only."""
    from lcasr_torch.ops.attention import reference_attention
    from lcasr_torch.ops.flash_attention import flash_attention_ref

    rng = np.random.default_rng(14)
    q, k, v = (t(rng.normal(size=(2, 70, 2, 64)).astype(np.float32)).bfloat16()
               for _ in range(3))
    lengths = torch.tensor([70, 33], dtype=torch.int32)
    o, _ = flash_attention_ref(q, k, v, lengths, (8, 8))
    want = reference_attention(q, k, v, lengths, lengths, window=(8, 8))
    # the oracle scales q in fp32, the kernel path in bf16: 2^-8 relative
    assert_close(o.float(), want.float(), atol=2e-2)
