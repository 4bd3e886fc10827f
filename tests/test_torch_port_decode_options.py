"""The streaming decoder's options and the functional decode API of
lcasr_torch against lcasr_tpu's, on the CPU in fp32: int8 / int4 upload,
`cache_upload`, `pipeline_upload`, `fetch_logits`, `fetch_logits_buffered`,
`make_windowed_model_fn`.

The fixture is the one of tests/test_torch_port_streaming.py: a 2-layer
model, a 1,000-frame spectrogram, seq_len 256, overlap 192 and a window batch
of 4 (13 windows: a ragged last window and three padding windows).
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_streaming import N_CLASSES, OVERLAP, SEQ_LEN, WB, decoders  # noqa: F401


def _decoder(tdec, **kw):
    from lcasr_torch.evaluation.streaming import StreamingDecoder

    kw.setdefault("transfer_dtype", torch.float32)
    return StreamingDecoder(tdec.model, N_CLASSES, window_batch_size=WB, device="cpu", **kw)


def _jax_decoder(jdec, **kw):
    from lcasr_tpu.evaluation.streaming import StreamingDecoder as JDec

    return JDec(jdec.model, jdec.variables, N_CLASSES, window_batch_size=WB, **kw)


@pytest.mark.parametrize("spelling", ["int8", torch.int8, np.int8, np.dtype("int8")])
def test_int8_spellings(decoders, spelling):
    assert _decoder(decoders[1], transfer_dtype=spelling).transfer_dtype == "int8"


@pytest.mark.parametrize("spelling,want", [
    (None, torch.bfloat16), ("bfloat16", torch.bfloat16), ("float32", torch.float32),
    (np.float32, torch.float32), (torch.float16, torch.float16), ("int4", "int4"),
])
def test_transfer_dtype_spellings(decoders, spelling, want):
    assert _decoder(decoders[1], transfer_dtype=spelling).transfer_dtype == want


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantised_upload_matches_jax(decoders, kind):
    """The same quantisation parameters and the same dequantised bf16
    values on both sides (the codes are made by the same numpy expressions;
    int4's affine map may differ by one bf16 ulp where XLA contracts
    lo + step * q into an fma), for an odd width too; then the decoders'
    logits.  int8: the inputs are equal, so atol 1e-4 as in
    test_logits_match_jax.  int4: an input off by one bf16 ulp (2^-8
    relative) moves a log-prob by up to 1e-3; atol 5e-3."""
    jdec, tdec, spec = decoders
    jq = _jax_decoder(jdec, transfer_dtype=kind)
    tq = _decoder(tdec, transfer_dtype=kind)
    for width in (1000, 999):
        host = spec[0][:, :width]
        qj, qt = jq._quant_params(host), tq._quant_params(host)
        assert qj[0] == qt[0] == kind
        for a, b in zip(qj[1:], qt[1:]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        dev_j = np.asarray(jq._upload(host, qj).astype(jnp.float32))
        dev_t = tq._upload(host, qt)
        assert dev_t.dtype == torch.bfloat16 and dev_t.shape == (80, width)
        ulp = np.abs(dev_j) * 2.0 ** -7 + 1e-30
        assert (np.abs(dev_t.float().numpy() - dev_j) <= (0 if kind == "int8" else 1) * ulp).all()
        # and the round trip stays near the spectrogram: half a step, and
        # the bf16 roundings of the scale and of the result (2^-8 each)
        step = qt[1] if kind == "int8" else qt[2][:, None]
        err = np.abs(dev_t.float().numpy() - host)
        assert (err <= 0.5 * step + 2.0 ** -7 * (np.abs(host) + step) + 1e-6).all()
    want = jq.logits(spec, seq_len=SEQ_LEN, overlap=OVERLAP)
    got = tq.logits(spec, seq_len=SEQ_LEN, overlap=OVERLAP)
    np.testing.assert_allclose(got, want, atol=1e-4 if kind == "int8" else 5e-3, rtol=0)


def test_int8_silent_spectrogram_has_scale_one(decoders):
    tq = _decoder(decoders[1], transfer_dtype="int8")
    assert tq._quant_params(np.zeros((80, 16), np.float32)) == ("int8", 1.0)


def test_cache_upload_reuses_the_device_spectrogram(decoders, monkeypatch):
    """The second decode of the same array object uploads nothing and gives
    the same logits; another array object uploads again."""
    _, tdec, spec = decoders
    dec = _decoder(tdec, cache_upload=True)
    uploads = []
    real = dec._upload
    monkeypatch.setattr(dec, "_upload", lambda *a, **k: uploads.append(1) or real(*a, **k))
    first = dec.logits(spec, seq_len=SEQ_LEN, overlap=OVERLAP)
    second = dec.logits(spec, seq_len=SEQ_LEN, overlap=OVERLAP)
    assert uploads == [1]
    np.testing.assert_array_equal(first, second)
    np.testing.assert_array_equal(first, tdec.logits(spec, seq_len=SEQ_LEN, overlap=OVERLAP))
    dec.logits(spec.copy(), seq_len=SEQ_LEN, overlap=OVERLAP)
    assert uploads == [1, 1]
    plain = _decoder(tdec)  # without the option every decode uploads
    monkeypatch.setattr(plain, "_upload", lambda *a, **k: uploads.append(2) or real(*a, **k))
    plain.logits(spec, seq_len=SEQ_LEN, overlap=OVERLAP)
    plain.logits(spec, seq_len=SEQ_LEN, overlap=OVERLAP)
    assert uploads == [1, 1, 2, 2]


@pytest.mark.parametrize("transfer", [torch.float32, "int8", "int4"])
def test_pipeline_upload_equals_single_upload(decoders, transfer):
    """Stripes of W * stride frames, one per window group plus a halo stripe:
    the same windows in the same batches, so the logits are the same to the
    last bit.  overlap 64 keeps the halo inside one stripe (4 * 192)."""
    _, tdec, _ = decoders
    spec = np.random.default_rng(5).normal(size=(1, 80, 1600)).astype(np.float32)
    single = _decoder(tdec, transfer_dtype=transfer)
    piped = _decoder(tdec, transfer_dtype=transfer, pipeline_upload=True)
    uploads = []
    real = piped._upload
    piped._upload = lambda *a, **k: uploads.append(a[0].shape[-1]) or real(*a, **k)
    # a ragged last group; two full groups and an empty halo stripe; a halo
    # stripe of one frame
    for n in (1000, 1536, 1537):
        part = spec[:, :, :n]
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = piped.logits(part, seq_len=SEQ_LEN, overlap=64)
        np.testing.assert_array_equal(got, single.logits(part, seq_len=SEQ_LEN, overlap=64))
    assert set(uploads) == {WB * (SEQ_LEN - 64)} and len(uploads) >= 3


def test_pipeline_upload_matches_jax(decoders):
    jdec, tdec, spec = decoders
    want = _jax_decoder(jdec, transfer_dtype=jnp.float32, pipeline_upload=True).logits(
        spec, seq_len=SEQ_LEN, overlap=64)
    got = _decoder(tdec, pipeline_upload=True).logits(spec, seq_len=SEQ_LEN, overlap=64)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_pipeline_upload_warns_when_the_overlap_exceeds_a_stripe(decoders):
    """overlap 192 > W * stride = 2 * 64: the decoder warns and takes the
    single upload, so the result is still right."""
    from lcasr_torch.evaluation.streaming import StreamingDecoder

    _, tdec, spec = decoders
    narrow = StreamingDecoder(tdec.model, N_CLASSES, window_batch_size=2, device="cpu",
                              transfer_dtype=torch.float32, pipeline_upload=True)
    with pytest.warns(UserWarning, match="pipeline_upload disabled"):
        got = narrow.logits(spec, seq_len=SEQ_LEN, overlap=OVERLAP)
    # batches of 2 instead of 4: the same windows, sums in another order
    np.testing.assert_allclose(got, tdec.logits(spec, seq_len=SEQ_LEN, overlap=OVERLAP),
                               atol=1e-5, rtol=0)


def test_pipeline_upload_single_group_takes_the_single_upload(decoders):
    _, tdec, spec = decoders
    piped = _decoder(tdec, pipeline_upload=True)
    part = spec[:, :, :400]  # 3 windows: one group
    np.testing.assert_array_equal(piped.logits(part, seq_len=SEQ_LEN, overlap=OVERLAP),
                                  tdec.logits(part, seq_len=SEQ_LEN, overlap=OVERLAP))


# ---------------------------------------------------------------------------
# functional API
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def model_fns(decoders):
    from lcasr_tpu.evaluation.streaming import make_windowed_model_fn as jmake
    from lcasr_torch.evaluation.streaming import make_windowed_model_fn

    jdec, tdec, spec = decoders
    return jmake(jdec.model, jdec.variables), make_windowed_model_fn(tdec.model), spec


def test_windowed_model_fn_matches_jax(model_fns):
    jfn, tfn, spec = model_fns
    batch = np.zeros((2, 80, 256), np.float32)
    batch[0], batch[1, :, :100] = spec[0, :, :256], spec[0, :, 300:400]
    lengths = np.array([256, 100], np.int32)
    lp_j, len_j = jfn(batch, lengths)
    lp_t, len_t = tfn(batch, lengths)
    assert isinstance(lp_t, torch.Tensor) and not lp_t.requires_grad
    np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=1e-4, rtol=0)
    lp_t2, _ = tfn(torch.from_numpy(batch), torch.from_numpy(lengths))  # tensors too
    assert torch.equal(lp_t, lp_t2)


@pytest.mark.parametrize("n,seq_len,overlap,wb", [
    (1000, 256, 192, 4), (1000, 256, 192, 8), (301, 4096, 0, 8), (700, 256, 64, 3),
])
def test_fetch_logits_matches_jax(model_fns, n, seq_len, overlap, wb):
    """Host-sliced windows at their exact width (a recording shorter than
    seq_len is one window of its own length, not widened), fp32, atol 1e-4."""
    from lcasr_tpu.evaluation.streaming import fetch_logits as jfetch
    from lcasr_torch.evaluation.streaming import fetch_logits

    jfn, tfn, spec = model_fns
    part = spec[:, :, :n]
    want = jfetch(jfn, part, seq_len, overlap, N_CLASSES, window_batch_size=wb)
    got = fetch_logits(tfn, part, seq_len, overlap, N_CLASSES, window_batch_size=wb)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_fetch_logits_equals_streaming_decoder(model_fns, decoders):
    from lcasr_torch.evaluation.streaming import fetch_logits

    _, tfn, spec = model_fns
    got = fetch_logits(tfn, spec, SEQ_LEN, OVERLAP, N_CLASSES, window_batch_size=WB)
    want = decoders[1].logits(spec, seq_len=SEQ_LEN, overlap=OVERLAP)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,seq_len,overlap", [(1000, 256, 64), (1000, 256, 0), (200, 256, 64),
                                               (777, 320, 128)])
def test_fetch_logits_buffered_matches_jax(model_fns, n, seq_len, overlap):
    from lcasr_tpu.evaluation.streaming import fetch_logits_buffered as jbuf
    from lcasr_torch.evaluation.streaming import fetch_logits_buffered

    jfn, tfn, spec = model_fns
    part = spec[:, :, :n]
    want = jbuf(jfn, part, seq_len, overlap, N_CLASSES)
    got = fetch_logits_buffered(tfn, part, seq_len, overlap, N_CLASSES)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_functional_api_refuses_bad_geometry(model_fns):
    from lcasr_torch.evaluation.streaming import fetch_logits, fetch_logits_buffered

    _, tfn, spec = model_fns
    with pytest.raises(ValueError, match="multiple of the downsampling factor"):
        fetch_logits(tfn, spec, 256, 100, N_CLASSES)
    with pytest.raises(ValueError, match="must exceed overlap"):
        fetch_logits(tfn, spec, 256, 256, N_CLASSES)
    with pytest.raises(ValueError, match="even"):
        fetch_logits_buffered(tfn, spec, 256, 63, N_CLASSES)


# ---------------------------------------------------------------------------
# what chip_smoke.py asserts about the opt-in configuration
# ---------------------------------------------------------------------------
def test_chip_smoke_env_flags_set_and_restore(monkeypatch):
    import os

    import chip_smoke

    monkeypatch.setenv("LCASR_ATTN_FWD_DB", "0")
    monkeypatch.delenv("LCASR_FUSED_SUB", raising=False)
    with pytest.raises(RuntimeError):
        with chip_smoke.env_flags(**chip_smoke.OPT_FLAGS):
            assert os.environ["LCASR_ATTN_FWD_DB"] == os.environ["LCASR_FUSED_SUB"] == "1"
            with chip_smoke.env_flags(LCASR_FUSED_SUB=None):
                assert "LCASR_FUSED_SUB" not in os.environ
            assert os.environ["LCASR_FUSED_SUB"] == "1"
            raise RuntimeError("a failing phase")
    assert os.environ["LCASR_ATTN_FWD_DB"] == "0" and "LCASR_FUSED_SUB" not in os.environ


def test_chip_smoke_expect_launches_compares_the_whole_dict():
    import chip_smoke
    from lcasr_torch import kernels

    kernels.reset_launch_counts()
    try:
        kernels.launch_counts["flash_attention_fwd_db"] = 36
        kernels.launch_counts["subsampling_fused"] = 4
        got = chip_smoke.expect_launches(chip_smoke.OPT_DECODE_LAUNCHES, "decode")
        assert got["flash_attention_fwd"] == 0 and set(got) == set(kernels.launch_counts)
        kernels.launch_counts["flash_attention_fwd"] = 1  # K1 must not run under the flag
        with pytest.raises(AssertionError, match="expected"):
            chip_smoke.expect_launches(chip_smoke.OPT_DECODE_LAUNCHES, "decode")
    finally:
        kernels.reset_launch_counts()


def test_chip_smoke_opt_counts_follow_the_geometry():
    """52 windows in 4 batches of 16: 9 layers x 4 K2 and 4 K8 launches; a
    micro step runs every layer's forward twice (remat), the checkpointed
    subsampling's forward twice and the CTC kernels once."""
    import chip_smoke
    from lcasr_torch.evaluation.streaming import _window_positions

    n = len(_window_positions(chip_smoke.TOTAL_FRAMES, chip_smoke.SEQ_LEN, chip_smoke.OVERLAP))
    batches = -(-n // chip_smoke.WINDOW_BATCH)
    layers = chip_smoke.LADDER_CONFIG["model"]["n_layers"]
    assert chip_smoke.OPT_DECODE_LAUNCHES == {"flash_attention_fwd_db": layers * batches,
                                              "subsampling_fused": batches}
    assert chip_smoke.OPT_MAMBA_LAUNCHES == {
        "selective_scan_fwd": chip_smoke.MAMBA_CONFIG["model"]["n_layers"] * batches,
        "subsampling_fused": batches}
    assert chip_smoke.LADDER_CONFIG["model"]["remat_subsampling"]
    assert chip_smoke.OPT_TRAIN_LAUNCHES == {"flash_attention_fwd_db": 2 * layers,
                                             "flash_attention_bwd_fused": layers,
                                             "subsampling_fused": 2,
                                             "ctc_alpha": 1, "ctc_beta": 1}
    for B, T, F in chip_smoke.SUB_MAIN_SHAPES:
        assert T % 8 == 0 and F % 8 == 0


def test_micro_step_under_the_flags_runs_the_fused_chain_twice(monkeypatch):
    """`remat_subsampling` checkpoints the subsampling: its forward, and so
    the fused chain, runs in the forward and again in the backward's
    recompute; the gradients equal those of the step without the flag."""
    from lcasr_torch.models.sconformer_xl import SCConformerXL, init_weights_
    from lcasr_torch.ops import subsampling as ts

    calls = []
    real = ts._FusedDwStriding.forward
    monkeypatch.setattr(ts._FusedDwStriding, "forward",
                        staticmethod(lambda ctx, *a: calls.append(1) or real(ctx, *a)))
    model = init_weights_(SCConformerXL(
        vocab_size=16, d_model=64, n_layers=1, n_heads=2, head_dim=32,
        subsampling_conv_channels=128, remat_subsampling=True, checkpoint_every_n_layers=1,
        device="cpu"), seed=0)
    audio = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 80, 64)).astype(np.float32))
    lengths = torch.tensor([64, 40], dtype=torch.int32)
    grads = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("LCASR_FUSED_SUB", flag)
        model.zero_grad()
        model(audio, length=lengths, train=True)["final_posteriors"].sum().backward()
        grads[flag] = {n: p.grad.clone() for n, p in model.named_parameters()
                       if p.grad is not None}
    assert calls == [1, 1] and set(grads["1"]) == set(grads["0"])
    assert "subsampling.conv_in.weight" in grads["1"]
    for n in grads["0"]:
        np.testing.assert_allclose(grads["1"][n].numpy(), grads["0"][n].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=n)
