"""lcasr_torch's streaming transcriber and server, on the CPU in fp32: the
properties tests/test_serving.py holds for lcasr_tpu's, ids equal to the JAX
`OnlineTranscriber`'s on the same weights, and beam transcripts equal to an
offline `BeamSearch` over the same log-probs.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcasr_torch.data.audio import mel_spectrogram
from lcasr_torch.models.import_jax import state_dict_from_flax
from lcasr_torch.models.sconformer_xl import SCConformerXL
from lcasr_torch.serving import OnlineTranscriber, TranscriptionServer
from tests.test_torch_port_ops import randomize

TINY = dict(vocab_size=16, d_model=64, n_layers=1, n_heads=2, head_dim=32,
            subsampling_conv_channels=32,
            attention_window_size=4)  # local attention: a bounded receptive field


class _IdTokenizer:
    """Integer-token stand-in: decode = space-joined ids."""

    def vocab_size(self):
        return TINY["vocab_size"]

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


def _pair(cfg, seed=None):
    """(JAX model, its variables, the port's model with the same weights on
    the CPU).  seed None: flax's own initialisation, as tests/test_serving.py
    uses (near-flat outputs, whose argmaxes no rounding moves); else every
    leaf redrawn from the seed."""
    from lcasr_tpu.models.sconformer_xl import SCConformerXL as JModel

    jm = JModel(**cfg, use_pallas=False)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 256)))
    variables = (jax.tree.map(np.asarray, dict(variables)) if seed is None
                 else randomize(variables, seed=seed))
    port = SCConformerXL(**cfg, device="cpu")
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jm, variables, port


@pytest.fixture(scope="module")
def model():
    return _pair(TINY)[2]


def _random_wave(seconds, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(int(16000 * seconds),)).astype(np.float32)


def _feed_in_chunks(tr, wave, seed):
    rng = np.random.default_rng(seed)
    pieces, pos = [], 0
    while pos < len(wave):
        n = int(rng.integers(800, 24000))
        pieces.append(tr.feed(wave[pos : pos + n]))
        pos += n
    pieces.append(tr.finish())
    return pieces


def _tr(model, tok=None, **kw):
    kw = {"context_frames": 512, "stride_frames": 128, "right_delay_frames": 128, **kw}
    return OnlineTranscriber(model, tok or _IdTokenizer(), device="cpu", **kw)


def test_incremental_mel_equals_the_offline_frontend(model):
    """Fed in ragged chunks, the incremental mel is the bits of the port's
    offline frontend on the CPU in float64 (cast to fp32), and within 1e-4
    of the JAX fp32 frontend."""
    from lcasr_tpu.data.audio import mel_spectrogram as jmel

    wave = _random_wave(3.0, 0)
    tr = _tr(model, norm="none")
    _feed_in_chunks(tr, wave, 1)
    offline = mel_spectrogram(torch.from_numpy(wave.astype(np.float64)),
                              global_normalisation=False)[0].numpy().astype(np.float32)
    assert tr._mel.shape == offline.shape
    np.testing.assert_array_equal(tr._mel, offline)
    np.testing.assert_allclose(tr._mel, np.asarray(jmel(jnp.asarray(wave), False))[0],
                               rtol=1e-4, atol=1e-4)


def test_streamed_transcript_matches_full_forward(model):
    """The final transcript is the offline greedy decode of one
    full-recording forward: the window margins (256 frames left, 128 right)
    exceed the 1-layer local-attention receptive field, so the finalised
    argmaxes are exact."""
    wave = _random_wave(8.0, 2)  # 801 frames: windows slide past the start
    tok = _IdTokenizer()
    tr = _tr(model, tok, norm="none")
    pieces = _feed_in_chunks(tr, wave, 3)
    mel = mel_spectrogram(torch.from_numpy(wave), global_normalisation=False)
    with torch.no_grad():
        out = model(mel, length=torch.tensor([mel.shape[-1]], dtype=torch.int32))
    lp = out["final_posteriors"][0, : int(out["length"][0])]
    ids, prev = [], tok.vocab_size()
    for i in lp.argmax(-1).tolist():
        if i != tok.vocab_size() and i != prev:
            ids.append(i)
        prev = i
    assert tr.text == tok.decode(ids)
    assert "".join(pieces) == tr.text  # the deltas concatenate to the transcript
    assert any(p for p in pieces[:-1])  # and some came before finish()


def test_ids_match_the_jax_transcriber():
    """The same weights, the same stream, fed in the same chunks: the JAX
    OnlineTranscriber and the port's emit the same ids at the same frames
    (running normalisation, backlog batching on both sides)."""
    from lcasr_tpu.serving import OnlineTranscriber as JTranscriber

    jm, variables, port = _pair(TINY, 4)
    wave = _random_wave(10.0, 12) * 0.3
    kw = dict(context_frames=256, stride_frames=64, right_delay_frames=64, norm="running")
    jtr = JTranscriber(jm, variables, _IdTokenizer(), **kw)
    ttr = OnlineTranscriber(port, _IdTokenizer(), device="cpu", **kw)
    assert _feed_in_chunks(ttr, wave, 6) == _feed_in_chunks(jtr, wave, 6)
    assert ttr._ids == jtr._ids and ttr._id_frames == jtr._id_frames and ttr._ids


def test_running_normalization_converges(model):
    wave = _random_wave(6.0, 4)
    tr = _tr(model, norm="running")
    _feed_in_chunks(tr, wave, 5)
    n = tr._n_mel
    mean = tr._mel_sum / n
    var = (tr._mel_sumsq - n * mean**2) / (n - 1)
    offline = mel_spectrogram(torch.from_numpy(wave))[0].numpy()
    unnorm = mel_spectrogram(torch.from_numpy(wave), global_normalisation=False)[0].numpy()
    online_full = (unnorm - mean[:, None]) / (np.sqrt(var)[:, None] + tr.eps)
    np.testing.assert_allclose(online_full, offline, rtol=1e-3, atol=1e-3)


def test_streaming_with_real_tokenizer_and_word_timestamps():
    from lcasr_torch.data.tokenizer import load_tokenizer

    tok = load_tokenizer()
    port = _pair({**TINY, "vocab_size": tok.vocab_size()}, 1)[2]
    tr = _tr(port, tok, norm="running")
    wave = _random_wave(6.0, 9)
    pieces = _feed_in_chunks(tr, wave, 7)
    assert "".join(pieces) == tr.text
    words = tr.words
    assert words, "random-weight decode should emit something"
    assert " ".join(w["word"] for w in words) == tr.text.strip()
    prev_start = 0.0
    for w in words:
        assert 0.0 <= w["start"] < w["end"] <= len(wave) / 16000 + 1.0, w
        assert w["start"] >= prev_start
        prev_start = w["start"]


def test_finish_on_tiny_stream_does_not_crash(model):
    tr = _tr(model)
    assert tr.feed(np.zeros(100, np.float32)) == ""
    out = tr.finish()
    assert isinstance(out, str) and out == tr.text
    tr2 = _tr(model)
    tr2.feed(np.zeros(1, np.float32))
    assert tr2.finish() == "" and tr2.text == ""


def test_single_shape_for_whole_stream(model):
    """The forward sees one (1, 80, ctx) shape for the whole stream, the
    final flush of a length that is no multiple of sf (801 frames) too."""
    tr = _tr(model, norm="none", max_batch_strides=1)
    shapes = set()
    inner = tr._forward

    def spy(windows, widths):
        shapes.add(tuple(windows.shape))
        return inner(windows, widths)

    tr._forward = spy
    _feed_in_chunks(tr, _random_wave(8.0, 2), 3)
    assert shapes == {(1, 80, 512)}


def test_buffers_stay_bounded(model):
    tr = _tr(model, norm="none")
    wave = _random_wave(20.0, 10)  # 2001 frames >> ctx
    for pos in range(0, len(wave), 8000):
        tr.feed(wave[pos : pos + 8000])
        assert tr._mel.shape[1] <= 512 + 128 + 128 + 16
        assert len(tr._samples) <= 8000 + 2 * 256 + 160
    tr.finish()


def test_backlog_stride_batching_equals_serial(model):
    """A whole recording at once (many strides due in one drain) through the
    batched (k, 80, ctx) forward and the strip upload gives the transcript,
    frames and deltas of the serial path."""
    wave = _random_wave(14.0, 11)
    kw = dict(context_frames=256, stride_frames=64, right_delay_frames=64)
    serial, batched = _tr(model, max_batch_strides=1, **kw), _tr(model, max_batch_strides=8, **kw)
    assert batched.feed(wave) + batched.finish() == serial.feed(wave) + serial.finish()
    assert batched._ids == serial._ids and batched._id_frames == serial._id_frames
    serial, batched = _tr(model, max_batch_strides=1, **kw), _tr(model, max_batch_strides=4, **kw)
    assert _feed_in_chunks(batched, wave, 5) == _feed_in_chunks(serial, wave, 5)
    assert batched.text == serial.text


def test_int8_transfer_close_to_float(model):
    """transfer_dtype='int8': the per-upload quantisation moves the log-probs
    of one window by less than 0.2 (a wrong scale would blow this up), and
    the whole pipeline runs with it; other dtypes are refused."""
    wave = _random_wave(12.0, 31)
    kw = dict(context_frames=256, stride_frames=64, right_delay_frames=64, norm="none")
    mel = mel_spectrogram(torch.from_numpy(wave), global_normalisation=False)[0].numpy()
    win = mel[None, :, :256].astype(np.float32)
    tr_q = _tr(model, transfer_dtype="int8", **kw)
    with torch.no_grad():
        lens = torch.tensor([256], dtype=torch.int32)
        lp_f = model(torch.from_numpy(win), length=lens)["final_posteriors"]
        lp_q = model(tr_q._upload(win), length=lens)["final_posteriors"]
    assert float((lp_f - lp_q).abs().max()) < 0.2
    tr_q.feed_frames(mel)
    tr_q.finish()
    assert isinstance(tr_q.text, str)
    with pytest.raises(ValueError, match="transfer_dtype"):
        _tr(model, transfer_dtype="int4", **kw)


def test_beam_and_device_refusals(model):
    """decoder="beam" is taken (A4 is ported) and another decoder is not;
    without a GPU the default device is refused."""
    assert _tr(model, decoder="beam")._beam.beam_width == 25
    assert TranscriptionServer(model, _IdTokenizer(), decoder="beam", device="cpu").beam_topk == 17
    with pytest.raises(AssertionError):
        _tr(model, decoder="lattice")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            OnlineTranscriber(model, _IdTokenizer())
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TranscriptionServer(model, _IdTokenizer())


# ---------------- batched multi-stream server ----------------
SERVER_KW = dict(context_frames=128, stride_frames=32, right_delay_frames=32)


def _server(model, **kw):
    return TranscriptionServer(model, _IdTokenizer(), device="cpu", **{**SERVER_KW, **kw})


def test_server_matches_single_stream(model):
    """Interleaved server sessions produce exactly the single-stream
    transcripts, with eager pumping and with the event-loop pattern."""
    rng = np.random.default_rng(7)
    streams = [rng.normal(size=(16000 * s,)).astype(np.float32) * 0.1 for s in (2, 3, 1)]
    singles = []
    for audio in streams:
        t = _tr(model, norm="running", **SERVER_KW)
        t.feed(audio)
        t.finish()
        singles.append(t.text)
    server = _server(model, max_streams=4)
    sids = [server.open() for _ in streams]
    got = {sid: "" for sid in sids}
    chunk, pos, tick = 4000, [0] * len(streams), 0
    while any(p < len(a) for p, a in zip(pos, streams)):
        eager = tick % 2 == 0
        for i, sid in enumerate(sids):
            if pos[i] < len(streams[i]):
                got[sid] += server.feed(sid, streams[i][pos[i] : pos[i] + chunk], pump=eager)
                pos[i] += chunk
        if not eager:
            server.pump()
            for sid in sids:
                got[sid] += server.poll(sid)
        tick += 1
    for i in (1, 2, 0):  # finish in another order than opened
        got[sids[i]] += server.poll(sids[i])
        got[sids[i]] += server.finish(sids[i])
    assert server.n_open == 0
    for i, sid in enumerate(sids):
        assert got[sid] == singles[i], (i, got[sid], singles[i])


def test_server_rows_equal_single_stream_with_random_weights():
    """With every weight drawn from a seed (argmaxes that a small change of
    input moves), the server's ids still equal the single-stream path's fed
    in the same chunks: ramp-in windows and the final flushes, narrower than
    ctx, get zeros past their width on both paths."""
    port = _pair(TINY, 4)[2]
    rng = np.random.default_rng(21)
    streams = [rng.normal(size=(int(16000 * s),)).astype(np.float32) * 0.1
               for s in (2.3, 3.1, 1.7)]
    chunk = 4000
    singles = []
    for audio in streams:
        t = _tr(port, norm="running", **SERVER_KW)
        for p in range(0, len(audio), chunk):
            t.feed(audio[p : p + chunk])
        t.finish()
        singles.append(t._ids)
    server = _server(port, max_streams=4)
    sids = [server.open() for _ in streams]
    sessions = [server._session(sid) for sid in sids]
    for p in range(0, max(map(len, streams)), chunk):
        for sid, audio in zip(sids, streams):
            if p < len(audio):
                server.feed(sid, audio[p : p + chunk], pump=False)
        server.pump()
    for sid in sids:
        server.finish(sid)
    for sess, single in zip(sessions, singles):
        assert sess._ids == single and single


def test_server_ingest_only_feed_never_drains(model):
    rng = np.random.default_rng(13)
    streams = [rng.normal(size=(16000 * s,)).astype(np.float32) * 0.1 for s in (3, 1)]
    chunk = 4000
    singles = []
    for audio in streams:
        t = _tr(model, norm="running", **SERVER_KW)
        for p in range(0, len(audio), chunk):
            t.feed(audio[p : p + chunk])
        t.finish()
        singles.append(t.text)
    server = _server(model, max_streams=2)
    sids = [server.open() for _ in streams]
    got = {sid: "" for sid in sids}
    pos, open_ = 0, set(range(len(streams)))
    while open_:  # the CLI loop: the pump=False return is discarded
        for i in sorted(open_):
            if pos < len(streams[i]):
                assert server.feed(sids[i], streams[i][pos : pos + chunk], pump=False) == ""
        server.pump()
        pos += chunk
        for i in sorted(open_):
            got[sids[i]] += server.poll(sids[i])
            if pos >= len(streams[i]):
                got[sids[i]] += server.finish(sids[i])
                open_.discard(i)
    for i, sid in enumerate(sids):
        assert got[sid] == singles[i], (i, got[sid], singles[i])


def test_server_capacity_and_slot_reuse(model):
    server = _server(model, max_streams=2)
    a, b = server.open(), server.open()
    with pytest.raises(RuntimeError, match="capacity"):
        server.open()
    server.finish(a)
    c = server.open()
    assert server.n_open == 2
    for sid in (b, c):
        server.finish(sid)
    with pytest.raises(KeyError):
        server.feed(a, np.zeros(100, np.float32))


def test_server_two_wave_shapes(model):
    """Exactly two forward shapes whatever the sessions do: the full
    (S, 80, ctx) wave and, in lockstep steady state, the (S, 80, stride)
    delta wave."""
    server = _server(model, max_streams=3)
    calls = []
    inner_full, inner_delta = server._forward_full, server._forward_delta

    def spy_full(buf, rows, *rest):
        calls.append(("full", tuple(rows.shape)))
        return inner_full(buf, rows, *rest)

    def spy_delta(buf, deltas, *rest):
        calls.append(("delta", tuple(deltas.shape)))
        return inner_delta(buf, deltas, *rest)

    server._forward_full, server._forward_delta = spy_full, spy_delta
    rng = np.random.default_rng(0)
    sids = [server.open() for _ in range(3)]
    for _ in range(3):
        for sid in sids:
            server.feed(sid, rng.normal(size=(16000,)).astype(np.float32))
    for sid in sids:
        server.finish(sid)
    assert {c for c in calls} == {("full", (3, 80, 128)), ("delta", (3, 80, 32))}
    assert server.delta_wave_count > 0 and server.wave_count > server.delta_wave_count


@pytest.mark.parametrize("transfer_dtype", ["bfloat16", "int8"])
def test_server_compressed_transfer_matches_float32(model, transfer_dtype):
    rng = np.random.default_rng(3)
    streams = [rng.normal(size=(16000 * 2,)).astype(np.float32) * 0.1 for _ in range(2)]

    def run(dtype):
        srv = _server(model, max_streams=2, transfer_dtype=dtype)
        sids = [srv.open() for _ in streams]
        for sid, a in zip(sids, streams):
            srv.feed(sid, a)
        return [srv.text(sid) + srv.finish(sid) for sid in sids]

    assert run(transfer_dtype) == run("float32")


def test_server_int8_heterogeneous_loudness(model):
    """int8 waves carry normalised values, so a quiet session sharing a wave
    with a loud one keeps its transcript."""
    base = np.random.default_rng(17).normal(size=(80, 900)).astype(np.float32)
    mels = [base * 100.0, base * 0.01]

    def run(td):
        server = _server(model, max_streams=2, transfer_dtype=td)
        sids = [server.open(norm="running") for _ in mels]
        for t in range(0, 900, 100):
            for sid, m in zip(sids, mels):
                server.feed_frames(sid, m[:, t : t + 100], pump=False)
            server.pump()
        return [server.finish(sid) for sid in sids]

    assert run("int8") == run("float32")


def test_serving_cli_on_the_cpu(tmp_path, capsys, monkeypatch):
    """`python -m lcasr_torch.serving` on a port checkpoint and two WAV
    files (44.1 kHz stereo and 16 kHz mono): server mode, a summary line."""
    import sys

    from scipy.io import wavfile

    from lcasr_torch.config import Config
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.serving import __main__ as cli
    from lcasr_torch.training.checkpointing import save_checkpoint

    cfg = {**TINY, "vocab_size": load_tokenizer().vocab_size()}
    port = _pair(cfg, 2)[2]
    model_cfg = {k: v for k, v in cfg.items() if k != "vocab_size"}
    save_checkpoint(str(tmp_path), 1, port.state_dict(), config=Config({"model": model_cfg}))
    rng = np.random.default_rng(0)
    wavfile.write(str(tmp_path / "a.wav"), 44100,
                  (rng.normal(size=(44100 * 2, 2)) * 3000).astype(np.int16))
    wavfile.write(str(tmp_path / "b.wav"), 16000,
                  (rng.normal(size=16000 * 3) * 3000).astype(np.int16))
    for files in ([tmp_path / "a.wav"], [tmp_path / "a.wav", tmp_path / "b.wav"]):
        monkeypatch.setattr(sys, "argv", ["serving", str(tmp_path), *map(str, files),
                                          "--context", "256", "--stride", "64",
                                          "--delay", "64", "--device", "cpu"])
        cli.main()
        out = capsys.readouterr().out.strip().splitlines()
        assert out[-1].startswith("-- ") and "RTFx" in out[-1] and out[-1].endswith("on cpu")


# ---------------- beam decoding ----------------
BEAM_OPTS = dict(beam_width=4, alpha=0.0, beta=0.0)


def _offline_beam(port, tok, wave, opts):
    """The offline prefix beam search over one full-recording forward of
    the unnormalised mel (norm="none" on the streaming side)."""
    from lcasr_torch.decoding.beam_search import BeamSearch

    mel = mel_spectrogram(torch.from_numpy(wave), global_normalisation=False)
    with torch.no_grad():
        out = port(mel, length=torch.tensor([mel.shape[-1]], dtype=torch.int32))
    lp = out["final_posteriors"][0, : int(out["length"][0])].float().numpy()
    return BeamSearch(tokenizer=tok, blank_id=tok.vocab_size(), pad_id=0, **opts).run_search(lp)


def _stream_beam(port, wave, opts, topk, **kw):
    tr = _tr(port, norm="none", decoder="beam", beam_opts=opts, beam_topk=topk, **kw)
    pieces = _feed_in_chunks(tr, wave, 3)
    return tr, pieces


@pytest.mark.parametrize("topk", [None, 17])
def test_beam_serving_matches_offline(model, topk):
    """decoder="beam", dense and top-K fetch: the final transcript is the
    offline prefix beam search's over the full forward (the finalised rows
    are exact by the finalisation contract); the deltas end with it."""
    wave = _random_wave(8.0, 11)
    tok = _IdTokenizer()
    tr, pieces = _stream_beam(model, wave, BEAM_OPTS, topk)
    assert tr.text == _offline_beam(model, tok, wave, BEAM_OPTS) and tr.text
    assert pieces[-1] == "" or tr.text.endswith(pieces[-1])
    assert tr.sparse_refetches == 0


def test_beam_serving_lm_fusion_matches_offline(model):
    """alpha > 0 with a deterministic toy LM: the incremental search's LM
    memo across streamed blocks lands on the offline result."""
    V = _IdTokenizer().vocab_size()
    table = np.random.default_rng(99).normal(size=(V, V)).astype(np.float32)
    table -= np.log(np.exp(table).sum(-1, keepdims=True))

    def lm_scores(prefixes):
        return np.stack([table[p[-1] if p else 2] for p in prefixes])

    opts = dict(beam_width=4, alpha=0.3, beta=0.1, lm_scores=lm_scores)
    wave = _random_wave(6.0, 12)
    tr, _ = _stream_beam(model, wave, opts, 8)
    assert tr.text == _offline_beam(model, _IdTokenizer(), wave, opts)


def test_beam_serving_sparse_fetch_tight_and_overflowing(model):
    """The top-K fetch is exact where the above-threshold count fits in K
    (a tight threshold with K = 4), and where it does not (a loose threshold
    with K = 2: every row) the window is fetched again densely: the same
    transcript as the offline search either way."""
    wave = _random_wave(5.0, 13)
    tok = _IdTokenizer()
    tight = dict(BEAM_OPTS, top_am_threshold=-0.5)
    tr, _ = _stream_beam(model, wave, tight, 4)
    assert tr.text == _offline_beam(model, tok, wave, tight)
    loose = dict(BEAM_OPTS, top_am_threshold=-50.0)
    tr, _ = _stream_beam(model, wave, loose, 2)
    assert tr.text == _offline_beam(model, tok, wave, loose) and tr.sparse_refetches > 0


def test_beam_transcript_matches_the_jax_transcriber():
    """The same weights and stream in the same chunks: the JAX and the port's
    beam transcribers (top-K fetch, backlog batching) give the same text."""
    from lcasr_tpu.serving import OnlineTranscriber as JTranscriber

    jm, variables, port = _pair(TINY, 4)
    wave = _random_wave(8.0, 14) * 0.3
    kw = dict(context_frames=256, stride_frames=64, right_delay_frames=64, norm="running",
              decoder="beam", beam_opts=BEAM_OPTS, beam_topk=8)
    jtr = JTranscriber(jm, variables, _IdTokenizer(), **kw)
    ttr = OnlineTranscriber(port, _IdTokenizer(), device="cpu", **kw)
    _feed_in_chunks(jtr, wave, 6)
    _feed_in_chunks(ttr, wave, 6)
    assert ttr.text == jtr.text and ttr.text
    assert ttr._id_frames == jtr._id_frames


def test_server_beam_matches_single_stream():
    """Server sessions in beam mode (top-K fetch per wave) give the
    single-stream beam transcribers' texts, fed in the same chunks."""
    port = _pair(TINY, 4)[2]
    rng = np.random.default_rng(22)
    streams = [rng.normal(size=(int(16000 * s),)).astype(np.float32) * 0.1 for s in (2.3, 3.1)]
    chunk = 4000
    kw = dict(decoder="beam", beam_opts=BEAM_OPTS, beam_topk=8)
    singles = []
    for audio in streams:
        t = _tr(port, norm="running", **SERVER_KW, **kw)
        for p in range(0, len(audio), chunk):
            t.feed(audio[p : p + chunk])
        t.finish()
        singles.append(t.text)
    server = _server(port, max_streams=3, **kw)
    sids = [server.open() for _ in streams]
    got = {sid: "" for sid in sids}
    for p in range(0, max(map(len, streams)), chunk):
        for sid, audio in zip(sids, streams):
            if p < len(audio):
                server.feed(sid, audio[p : p + chunk], pump=False)
        server.pump()
        for sid in sids:
            got[sid] += server.poll(sid)
    sessions = [server._session(sid) for sid in sids]
    for sid in sids:
        server.finish(sid)
    assert [s.text for s in sessions] == singles and all(singles)


def test_serving_cli_beam_on_the_cpu(tmp_path, capsys, monkeypatch):
    """`python -m lcasr_torch.serving ... --decoder beam` in both modes."""
    from scipy.io import wavfile

    from lcasr_torch.config import Config
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.serving import __main__ as cli
    from lcasr_torch.training.checkpointing import save_checkpoint

    cfg = {**TINY, "vocab_size": load_tokenizer().vocab_size()}
    port = _pair(cfg, 2)[2]
    with torch.no_grad():
        port.decoder.ff.weight.mul_(20.0)  # peaked posteriors: few candidates a frame
    model_cfg = {k: v for k, v in cfg.items() if k != "vocab_size"}
    save_checkpoint(str(tmp_path), 1, port.state_dict(), config=Config({"model": model_cfg}))
    rng = np.random.default_rng(1)
    for name in ("a", "b"):
        wavfile.write(str(tmp_path / f"{name}.wav"), 16000,
                      (rng.normal(size=16000 * 2) * 3000).astype(np.int16))
    for files in (["a.wav"], ["a.wav", "b.wav"]):
        monkeypatch.setattr(sys, "argv", ["serving", str(tmp_path),
                                          *[str(tmp_path / f) for f in files],
                                          "--context", "256", "--stride", "64", "--delay", "64",
                                          "--decoder", "beam", "--beam_width", "4",
                                          "--beam_topk", "16", "--device", "cpu"])
        cli.main()
        out = capsys.readouterr().out.strip().splitlines()
        assert out[-1].startswith("-- ") and out[-1].endswith("on cpu")
