"""lcasr_torch's W8A8 projections (ops/qdense.py and the sites of the four
families) against lcasr_tpu's, on the CPU.

  * the int8 product is exact: bit-equal to an int64 product, padding
    included;
  * the int8 values equal the JAX function's (`jnp.rint` of the same fp32
    quotients), and the rescaled output equals `w8a8_dot_general`'s within
    1e-6 relative in fp32 (the same int32 sums and scale products; the
    fp32 multiply may round apart once) and within one bf16 step in bf16;
  * in each family, every projection the policy switches is held against
    `w8a8_dot_general` on the very input it got (1e-6 relative), and the
    sites switched are the policy's; then each family's layers are compared
    with the JAX ones layer by layer from the same inputs, at 2e-4 of the
    largest output.  An input that differs by fp32 rounding can flip one
    `rint` inside a layer and move a row by a quantisation step (a flipped
    key or value moves every row a little), so up to 10% of the outputs may
    lie outside that tolerance, all within a quarter of what quantising
    moves them; and the mean difference from the JAX layer must be below a
    tenth of the mean difference between the quantised and the float layer,
    so that the same sites really are switched on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcasr_torch.models.import_jax import state_dict_from_flax
from lcasr_torch.ops import qdense
from tests.test_torch_port_ops import randomize

LAYER_TOL = 2e-4


def _dn(ndim):
    return (((ndim - 1,), (0,)), ((), ()))


@pytest.mark.parametrize("shape", [(40, 64, 24), (5, 13, 7), (17, 8, 8), (1, 3072, 768)])
def test_int8_product_is_exact(shape):
    M, K, N = shape
    rng = np.random.default_rng(M + K)
    a = rng.integers(-127, 128, (M, K)).astype(np.int8)
    w = rng.integers(-127, 128, (N, K)).astype(np.int8)
    got = qdense.int8_matmul(torch.from_numpy(a), torch.from_numpy(w))
    assert got.dtype == torch.int32 and got.shape == (M, N)
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  a.astype(np.int64) @ w.astype(np.int64).T)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a8_linear_matches_jax(dtype):
    from lcasr_tpu.ops.qdense import w8a8_dot_general

    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 11, 48)).astype(np.float32)
    x[1, 4] = 0.0  # a zero row stays zero
    w = rng.normal(size=(48, 40)).astype(np.float32) * 0.2  # flax (in, out)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                          torch.bfloat16)
    xj, wj = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    want = np.asarray(w8a8_dot_general(xj, wj, _dn(3)).astype(jnp.float32))
    xt, wt = torch.from_numpy(x).to(tdt), torch.from_numpy(w.T.copy()).to(tdt)
    got = qdense.w8a8_linear(xt, wt).float().numpy()
    assert got.dtype == np.float32 and not got[1, 4].any()
    # the int8 values: rint of the same fp32 quotients
    xf = np.asarray(xj.astype(jnp.float32))
    xs = np.maximum(np.abs(xf).max(-1, keepdims=True) / 127.0, 1e-8)
    want_q = np.asarray(jnp.clip(jnp.rint(jnp.asarray(xf) / jnp.asarray(xs)), -127, 127))
    got_q, _ = qdense.quantize_rows(xt)
    np.testing.assert_array_equal(got_q.numpy(), want_q.astype(np.int8))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)


def test_policy_resolution_matches_jax():
    from lcasr_tpu.ops import qdense as jq

    assert qdense.ALL_SITES == jq.ALL_SITES and qdense.AUTO_SITES == jq.AUTO_SITES
    for flag in (False, None, True, "auto", "ff", ("ff", "conv"), ["qkv"], frozenset()):
        assert qdense.resolve_quant_policy(flag) == jq.resolve_quant_policy(flag)
        for site in sorted(jq.ALL_SITES):
            assert qdense.quant_site(flag, site) == jq.quant_site(flag, site)
    for bad in ("fp8", ("ff", "mlp")):
        with pytest.raises(ValueError, match="unknown quant_w8a8 site"):
            jq.resolve_quant_policy(bad)
        with pytest.raises(ValueError, match="unknown quant_w8a8 site"):
            qdense.resolve_quant_policy(bad)


def _close_and_switched(got, want, plain, what):
    want, got, plain = (np.asarray(a, np.float32) for a in (want, got, plain))
    tol = LAYER_TOL * np.abs(want).max()
    diff, moved = np.abs(got - want), np.abs(plain - want)
    assert (diff > tol).mean() <= 0.1, f"{what}: {(diff > tol).mean():.3f} of outputs apart"
    assert diff.max() <= 0.25 * moved.max(), f"{what}: {diff.max()} vs {moved.max()}"
    assert diff.mean() <= 0.1 * moved.mean(), f"{what}: {diff.mean()} vs {moved.mean()}"


def _sites_exact(model, run, flag) -> set:
    """Run `run()` with every quantised projection of `model` recorded, hold
    each against `w8a8_dot_general` (+ bias) on its own input, and return
    the sites seen, which must be among the policy's."""
    from lcasr_tpu.ops.qdense import w8a8_dot_general
    from lcasr_torch.ops.dense import Dense

    w8a8 = jax.jit(w8a8_dot_general, static_argnums=2)  # one compile a shape
    calls = []
    hooks = [m.register_forward_hook(lambda mod, inp, out: calls.append((mod, inp[0], out)))
             for m in model.modules() if isinstance(m, Dense) and m.quant]
    try:
        with torch.no_grad():
            run()
    finally:
        for h in hooks:
            h.remove()
    assert calls
    for mod, x, out in calls:
        x = x.to(mod.dtype).float().numpy()
        want = w8a8(jnp.asarray(x), jnp.asarray(mod.weight.detach().numpy().T), _dn(x.ndim))
        if mod.bias is not None:
            want = want + jnp.asarray(mod.bias.detach().numpy())
        np.testing.assert_allclose(out.float().numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max()), err_msg=mod.site)
    sites = {mod.site for mod, _, _ in calls}
    assert sites <= qdense.resolve_quant_policy(flag)
    return sites


POLICIES = {"all": True, "auto": "auto"}


def _audio(seed, B=2, T=64):
    return np.random.default_rng(seed).normal(size=(B, 80, T)).astype(np.float32)


def _conformer_pair():
    from lcasr_tpu.models.sconformer_xl import SCConformerXL as JModel
    from lcasr_torch.models.sconformer_xl import SCConformerXL

    cfg = dict(vocab_size=16, d_model=64, n_layers=2, n_heads=2, head_dim=32,
               subsampling_conv_channels=32)
    variables = randomize(JModel(**cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 64))),
                          seed=2)
    port = SCConformerXL(**cfg, device="cpu")
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    return cfg, variables, port


@pytest.mark.parametrize("policy", ["all", "auto", "sites"])
def test_conformer_layer_and_decoder_match_jax(policy):
    """A ConformerLayer (qkv, attn_out, ff, conv) and the CTC head
    (decoder) from the same inputs."""
    from lcasr_tpu.models.decoder import ASRLinearSCDecoder as JDecoder
    from lcasr_tpu.models.sconformer_xl import ConformerLayer as JLayer

    flag = POLICIES.get(policy, ("qkv", "conv", "decoder"))
    cfg, variables, port = _conformer_pair()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 20, 64)).astype(np.float32)
    lengths = np.array([20, 13], np.int32)
    pad = ~(np.arange(20)[None] < lengths[:, None])
    layer_vars = {"params": variables["params"]["layers_0"],
                  "batch_stats": variables["batch_stats"]["layers_0"]}

    def jlayer(q):
        return jax.jit(JLayer(d_model=64, n_heads=2, head_dim=32, quant_w8a8=q).apply)(
            layer_vars, jnp.asarray(x), jnp.asarray(lengths), jnp.asarray(pad))

    def jdecoder(q):
        from lcasr_tpu.ops.qdense import quant_site

        return JDecoder(d_model=64, vocab_size=16, quant_w8a8=quant_site(q, "decoder")).apply(
            {"params": variables["params"]["decoder"]}, jnp.asarray(x), logits=True)

    qdense.apply_quant_policy(port, flag)
    xt, lt, pt = torch.from_numpy(x), torch.from_numpy(lengths), torch.from_numpy(pad)
    sites = _sites_exact(port, lambda: port(torch.from_numpy(_audio(2)), torch.tensor([64, 41])),
                         flag)
    assert sites == qdense.resolve_quant_policy(flag) & {"qkv", "attn_out", "ff", "conv",
                                                          "decoder"}
    with torch.no_grad():
        got = port.layers[0](xt, lt, pt).numpy()
        got_dec = port.decoder(xt, logits=True).numpy()
    _close_and_switched(got, jlayer(flag), jlayer(False), f"layer under {flag}")
    if qdense.quant_site(flag, "decoder"):
        _close_and_switched(got_dec, jdecoder(flag), jdecoder(False), f"decoder under {flag}")
    with pytest.raises(ValueError, match="inference-only"):
        port(torch.zeros(1, 80, 64), train=True)
    qdense.apply_quant_policy(port, False)
    port(torch.zeros(1, 80, 64), train=True)


@pytest.mark.parametrize("policy", ["all", "sites"])
def test_mamba_mixer_matches_jax(policy):
    from lcasr_tpu.models.mamba import BiMambaMixer as JMixer
    from lcasr_tpu.models.mamba import Mamba as JModel
    from lcasr_torch.models.mamba import Mamba

    flag = POLICIES.get(policy, ("proj",))
    cfg = dict(vocab_size=16, d_model=64, n_layers=2, subsampling_conv_channels=32)
    variables = randomize(JModel(**cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 64))),
                          seed=4)
    port = Mamba(**cfg, device="cpu", quant_w8a8=flag)
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    x = np.random.default_rng(5).normal(size=(2, 12, 64)).astype(np.float32)
    lengths = np.array([12, 7], np.int32)

    def jmixer(q):
        return jax.jit(JMixer(64, n_layer=2, quant_w8a8=q).apply)(
            {"params": variables["params"]["layers_0"]["mixer"]}, jnp.asarray(x),
            lengths=jnp.asarray(lengths))

    assert _sites_exact(port, lambda: port(torch.from_numpy(_audio(2)), torch.tensor([64, 41])),
                        flag) == qdense.resolve_quant_policy(flag) & {"proj", "decoder"}
    with torch.no_grad():
        got = port.layers[0].mixer(torch.from_numpy(x), torch.from_numpy(lengths)).numpy()
    _close_and_switched(got, jmixer(True), jmixer(False), f"mixer under {flag}")
    with pytest.raises(ValueError, match="inference-only"):
        port(torch.zeros(1, 80, 64), train=True)


@pytest.mark.parametrize("policy", ["all", "auto", "sites"])
def test_enc_dec_decoder_matches_jax(policy):
    """The cross-attention decoder (proj, ff, lm_head) from the same
    tokens and acoustic states."""
    from lcasr_tpu.models.enc_dec_sconformer import CrossAttnDecoder as JDecoder
    from tests.test_torch_port_enc_dec import _pair

    flag = POLICIES.get(policy, ("proj", "lm_head"))
    jm, variables, port = _pair("v1", seed=6, quant_w8a8=flag)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jm.vocab_size, (2, 9)).astype(np.int32)
    a_hidden = rng.normal(size=(2, 16, jm.d_model)).astype(np.float32)
    a_lengths = np.array([16, 10], np.int32)

    def jdecoder(q):
        dec = JDecoder(vocab_size=jm.vocab_size, n_layers=jm.decoder_layers or jm.n_layers,
                       d_model=jm.d_model, n_heads=jm.n_heads, head_dim=jm.head_dim,
                       default_norm="rms_norm", use_rotary=True,
                       rotary_base_freq=jm.rotary_base_freq, quant_w8a8=q)
        return jax.jit(dec.apply)({"params": variables["params"]["language_model_decoder"]},
                                  jnp.asarray(tokens), jnp.asarray(a_hidden),
                                  jnp.asarray(a_lengths))

    args = (torch.from_numpy(tokens).long(), torch.from_numpy(a_hidden),
            torch.from_numpy(a_lengths))
    assert _sites_exact(port, lambda: port(torch.from_numpy(_audio(2)), args[0],
                                           length=torch.tensor([64, 41])),
                        flag) == qdense.resolve_quant_policy(flag)
    with torch.no_grad():
        got = port.language_model_decoder(*args).numpy()
    _close_and_switched(got, jdecoder(flag), jdecoder(False), f"AED decoder under {flag}")
    with pytest.raises(ValueError, match="inference-only"):
        port(torch.zeros(1, 80, 64), train=True)


@pytest.mark.parametrize("policy", ["all", "sites"])
def test_lm_matches_jax(policy):
    from tests.test_torch_port_lm import CFG, lm_pair

    flag = POLICIES.get(policy, ("qkv", "attn_out"))
    jlm, variables, port = lm_pair(CFG, 8)
    tokens = np.random.default_rng(9).integers(0, CFG["vocab_size"], (2, 10)).astype(np.int32)

    def jforward(q):
        return jlm.clone(quant_w8a8=q).apply(variables, jnp.asarray(tokens))

    qdense.apply_quant_policy(port, flag)
    assert _sites_exact(port, lambda: port(torch.from_numpy(tokens).long()),
                        flag) == qdense.resolve_quant_policy(flag) & {"qkv", "attn_out", "ff",
                                                                      "lm_head"}
    with torch.no_grad():
        got = port(torch.from_numpy(tokens).long()).numpy()
    _close_and_switched(got, jforward(flag), jforward(False), f"LM under {flag}")
    with pytest.raises(ValueError, match="inference-only"):
        port(torch.from_numpy(tokens).long(), train=True)


@pytest.mark.parametrize("policy", ["auto", "ff,decoder"])
def test_evaluate_quantised_matches_jax(policy, reference_checkpoint, monkeypatch):
    """`evaluate(quant_w8a8=...)` (a comma list as the CLI gives it) on the
    same `.pt`: the same hypotheses, rows and aggregate as the JAX one."""
    import lcasr_tpu.evaluation.run as jrun
    import lcasr_torch.evaluation.run as trun
    from tests.test_torch_port_eval import _capture_hyps, _rows

    path, _ = reference_checkpoint
    kw = dict(checkpoint=path, dataset="synthetic", seq_len=512, overlap=384,
              verbose=False, dataset_kwargs={"n_recordings": 1, "n_frames": 1500},
              quant_w8a8=policy)
    jhyps, thyps = _capture_hyps(monkeypatch, jrun), _capture_hyps(monkeypatch, trun)
    want = jrun.evaluate(**kw)
    got = trun.evaluate(**kw, device="cpu")
    assert thyps == jhyps and all(thyps)
    assert _rows(got) == _rows(want)


from tests.test_torch_port_eval import reference_checkpoint  # noqa: E402,F401  (a fixture)
