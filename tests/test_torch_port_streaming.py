"""lcasr_torch's streaming decoder against lcasr_tpu's, on the CPU in fp32.

A ~1,000-frame spectrogram with seq_len 256, overlap 192 and a window batch
of 4 gives 13 windows: a ragged last window and three zero-length padding
windows in the last batch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcasr_torch.models.import_jax import state_dict_from_flax
from tests.test_torch_port_ops import randomize

CFG = dict(vocab_size=16, d_model=64, n_layers=2, n_heads=2, head_dim=32,
           subsampling_conv_channels=32, use_rotary=True)
N_CLASSES = CFG["vocab_size"] + 1
SEQ_LEN, OVERLAP, WB = 256, 192, 4


@pytest.mark.parametrize("spec_n,seq_len,overlap", [
    (1000, 256, 192), (700, 256, 192), (256, 256, 192), (100, 256, 0),
    (120_000, 16_384, 14_336), (5000, 1024, 0),
])
def test_window_positions_and_lengths_match_jax(spec_n, seq_len, overlap):
    from lcasr_tpu.evaluation import streaming as js
    from lcasr_torch.evaluation import streaming as ts

    assert ts._window_positions(spec_n, seq_len, overlap) == js._window_positions(
        spec_n, seq_len, overlap)
    for u in (0, 1, 7, 8, 9, 255, 256, 15_552, 16_384):
        for mode in ("dw_striding", "vggnet", "stacking"):
            assert ts.subsampled_length(u, 8, mode, window_t=seq_len) == js.subsampled_length(
                u, 8, mode, window_t=seq_len)


def test_flagship_decode_geometry():
    """The 20-minute decode: 52 windows, 4 batches of 16, the last window
    15,552 frames long."""
    from lcasr_torch.evaluation.streaming import _window_positions

    pos = _window_positions(120_000, 16_384, 14_336)
    assert len(pos) == 52 and pos[-1] == (104_448, 15_552)
    assert -(-len(pos) // 16) == 4


@pytest.fixture(scope="module")
def decoders():
    from lcasr_tpu.evaluation.streaming import StreamingDecoder as JDec
    from lcasr_tpu.models.sconformer_xl import SCConformerXL as JModel
    from lcasr_torch.evaluation.streaming import StreamingDecoder
    from lcasr_torch.models.sconformer_xl import SCConformerXL

    jm = JModel(**CFG, use_pallas=False)
    variables = randomize(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 80, SEQ_LEN))), seed=1)
    port = SCConformerXL(**CFG, device="cpu")
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    jdec = JDec(jm, variables, N_CLASSES, window_batch_size=WB, transfer_dtype=jnp.float32)
    tdec = StreamingDecoder(port, N_CLASSES, window_batch_size=WB,
                            transfer_dtype=torch.float32, device="cpu")
    spec = np.random.default_rng(2).normal(size=(1, 80, 1000)).astype(np.float32)
    return jdec, tdec, spec


def test_logits_match_jax(decoders):
    """fp32 on both sides: averaged log-probs agree to atol 1e-4 (see
    tests/test_torch_port_model.py for the reasoning)."""
    jdec, tdec, spec = decoders
    want = jdec.logits(spec, seq_len=SEQ_LEN, overlap=OVERLAP)
    got = tdec.logits(spec, seq_len=SEQ_LEN, overlap=OVERLAP)
    assert got.shape == want.shape == (125, N_CLASSES)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_greedy_ids_match_jax(decoders):
    """Ids are equal except where JAX's top-2 margin is below 1e-5, where
    fp32 rounding may pick either class."""
    jdec, tdec, spec = decoders
    want = jdec.greedy(spec, seq_len=SEQ_LEN, overlap=OVERLAP)
    got = tdec.greedy(spec, seq_len=SEQ_LEN, overlap=OVERLAP)
    assert got.shape == want.shape
    top2 = np.sort(jdec.logits(spec, seq_len=SEQ_LEN, overlap=OVERLAP), axis=-1)[:, -2:]
    close = (top2[:, 1] - top2[:, 0]) < 1e-5
    np.testing.assert_array_equal(got[~close], np.asarray(want)[~close])


def test_bf16_upload_and_greedy_collapse(decoders):
    from lcasr_torch.decoding.greedy import GreedyCTCDecoder
    from lcasr_torch.evaluation.streaming import StreamingDecoder

    _, tdec, spec = decoders
    dec = StreamingDecoder(tdec.model, N_CLASSES, window_batch_size=WB, device="cpu")
    assert dec.transfer_dtype == torch.bfloat16
    ids = dec.greedy(spec, seq_len=SEQ_LEN, overlap=OVERLAP)
    ref = tdec.greedy(spec, seq_len=SEQ_LEN, overlap=OVERLAP)
    # bf16 input rounding flips only near-tied frames
    assert (ids == ref).mean() > 0.9
    blank = N_CLASSES - 1
    collapsed = GreedyCTCDecoder(blank_id=blank)(ids, decode=False)
    onehot = np.eye(N_CLASSES)[ids]
    assert collapsed == GreedyCTCDecoder(blank_id=blank)(onehot, decode=False)
    assert blank not in collapsed


def test_single_window_mode_equals_forward(decoders):
    """seq_len past the recording: one window over all of it, widened to
    4096 frames with the tail masked.  At a length that is a multiple of 8
    the widened window equals the direct forward (at other lengths the last
    frames read act(bias) rows past the true extent: the next test)."""
    _, tdec, _ = decoders
    spec = np.random.default_rng(3).normal(size=(1, 80, 296)).astype(np.float32)
    got = tdec.logits(spec, seq_len=4096, overlap=0)
    with torch.no_grad():
        want = tdec.model(torch.from_numpy(spec))["final_posteriors"][0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("spec_n", [296, 301, 303])
def test_single_window_mode_matches_jax(decoders, spec_n):
    """Both decoders widen the single window to the next multiple of 4096
    frames; when spec_n is not a multiple of 8 the last output frames then
    differ from a window of the exact width by up to 8e-3, so the port must
    widen as the reference does.  fp32, atol 1e-4 as test_logits_match_jax;
    ids equal except at near-ties."""
    jdec, tdec, _ = decoders
    spec = np.random.default_rng(spec_n).normal(size=(1, 80, spec_n)).astype(np.float32)
    want = jdec.logits(spec, seq_len=4096, overlap=0)
    got = tdec.logits(spec, seq_len=4096, overlap=0)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    top2 = np.sort(want, axis=-1)[:, -2:]
    close = (top2[:, 1] - top2[:, 0]) < 1e-5
    ids_j = np.asarray(jdec.greedy(spec, seq_len=4096, overlap=0))
    ids_t = tdec.greedy(spec, seq_len=4096, overlap=0)
    np.testing.assert_array_equal(ids_t[~close], ids_j[~close])


def test_unported_options_raise(decoders):
    """Every option of the JAX decoder is ported (the mesh decode is held
    against JAX in test_torch_port_parallel.py); an integer upload type
    other than int8 / int4 is refused as in the reference."""
    from lcasr_torch.evaluation.streaming import StreamingDecoder

    model = decoders[1].model
    for bad in ("int16", torch.int32, np.uint8, object()):
        with pytest.raises(ValueError):
            StreamingDecoder(model, N_CLASSES, device="cpu", transfer_dtype=bad)
    for kw in (dict(transfer_dtype="int8"), dict(transfer_dtype="int4"),
               dict(pipeline_upload=True), dict(cache_upload=True)):
        StreamingDecoder(model, N_CLASSES, device="cpu", **kw)


def test_decoder_without_device_raises_when_no_gpu(decoders):
    from lcasr_torch.evaluation.streaming import StreamingDecoder

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None means cuda there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingDecoder(decoders[1].model, N_CLASSES)
