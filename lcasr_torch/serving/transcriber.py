"""Online (streaming-input) transcription for serving (the port's copy of
lcasr_tpu/serving/transcriber.py).

Audio arrives in chunks of any size; mel frames are computed incrementally
on the host in float64, by the offline frontend's own per-frame arithmetic
(`data/audio.power_to_mel`), so the incremental mel equals the offline
frontend's on the CPU in float64; the model runs over a fixed-shape sliding
context window, emitting finalised text with a configurable lookahead delay.

Finalisation contract (as buffered transcription's centre crop): a frame's
logits are finalised only once it has `right_delay_frames` of real future
context and the window supplies `context_frames - stride - right_delay` of
left context.  For a model whose receptive field per side (attention window
+ conv stack) fits inside those margins, the finalised logits equal those of
a full-recording forward.

Memory is bounded for indefinite streams: consumed raw samples and mel frames
outside the live decode window are dropped (base-offset ring semantics);
normalisation statistics are carried as running sums and the transcript as
an append-only string.

Normalisation: the reference normalises each recording with its global mel
mean/std (`audio_tools.py:44-57`), which is unavailable online.  Options:
  * norm="running": cumulative mel statistics over the stream so far,
  * norm=(mean, std): precomputed (e.g. corpus-level) statistics,
  * norm="none": the caller feeds pre-normalised audio.

The JAX module shares jitted forwards between sessions; here the forward is
a plain `torch.no_grad()` call of the model the caller placed on `device`
(None: the GPU).  Greedy decoding takes the argmax on the device, so only
int32 ids come back.  decoder="beam" runs an incremental prefix beam search
(`decoding/beam_search.py`, LM-fusable through `beam_opts`) over the
finalised log-prob rows; its fetch is the device's top-K values and ids of
each row and the row's count of classes within the threshold (exact while
the count fits in K, a dense refetch of the window where it does not), or
the dense fp32 rows with `beam_topk=None`.  Mid-stream the text is the live
beams' common prefix; finish() settles on the best beam, which is the
offline search's over the same rows.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from lcasr_torch.data.audio import HOP_LENGTH, N_FFT, power_to_mel
from lcasr_torch.device import resolve_device

_PAD = N_FFT // 2  # center=True padding (reflect), as data/audio.py


def to_host(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Tensors of 4-byte elements on the device -> numpy arrays, in one
    copy (packed as int32 and cut apart on the host)."""
    flat = torch.cat([t.contiguous().view(torch.int32).reshape(-1) for t in tensors])
    host, out, at = flat.cpu().numpy(), [], 0
    for t in tensors:
        n = t.numel()
        out.append(host[at : at + n].view(np.dtype(str(t.dtype).replace("torch.", "")))
                   .reshape(tuple(t.shape)))
        at += n
    return out


def decode_head(lp: torch.Tensor, decoder: str, beam_topk: Optional[int], thr: float):
    """The device's part of a decode step on (k, rows, C) log-probs, still on
    the device: greedy -> (ids int32,); beam with top-K -> (values fp32,
    ids int32, count int32), `count` the classes >= the row's max + thr;
    dense beam -> (fp32 log-probs,)."""
    if decoder == "greedy":
        return (lp.argmax(-1).to(torch.int32),)
    lp = lp.float()
    if beam_topk is None:
        return (lp,)
    vals, idx = torch.topk(lp, beam_topk, dim=-1)
    count = (lp >= lp.max(-1, keepdim=True).values + thr).sum(-1)
    return vals, idx.to(torch.int32), count.to(torch.int32)


def model_device(model, device) -> torch.device:
    """`device` (None: the GPU), which must hold the model's parameters."""
    device = resolve_device(device)
    for p in model.parameters():
        if p.device.type != device.type or (
                device.index is not None and p.device.index != device.index):
            raise ValueError(f"the model's parameters are on {p.device}, not on {device}: "
                             f"place the model there first")
    return device


class OnlineTranscriber:
    """Incremental transcription over a raw-sample stream.

    feed(samples) -> newly finalised text (possibly "")
    finish()      -> remaining text (flushes the tail with end padding)
    text          -> full transcript so far
    """

    def __init__(
        self,
        model,
        tokenizer,
        context_frames: int = 2048,
        stride_frames: int = 512,
        right_delay_frames: int = 512,
        norm: Union[str, Tuple[np.ndarray, np.ndarray]] = "running",
        eps: float = 1e-8,
        decoder: str = "greedy",
        beam_opts: Optional[dict] = None,
        beam_topk: Optional[int] = 32,
        max_batch_strides: int = 8,
        transfer_dtype: Optional[str] = None,
        device=None,
    ):
        sf = getattr(model, "subsampling_factor", 8)
        assert context_frames % sf == 0 and stride_frames % sf == 0
        assert right_delay_frames % sf == 0
        assert context_frames >= stride_frames + right_delay_frames
        assert decoder in ("greedy", "beam")
        self.device = model_device(model, device)
        self.model = model.eval()
        self.tokenizer = tokenizer
        self.blank_id = tokenizer.vocab_size()  # blank is LAST (reference)
        self.sf = sf
        self.ctx = context_frames
        self.stride = stride_frames
        self.delay = right_delay_frames
        self.norm = norm
        self.eps = eps
        self.decoder = decoder
        # backlog stride batching: when the stream is fed faster than real
        # time, several strides are due at once; they ride one (k, 80, ctx)
        # forward instead of k (1, 80, ctx) ones.  Equal to the serial path:
        # the running statistics change only on feed(), never between drain
        # steps.  k is snapped to powers of two up to max_batch_strides.
        self.max_batch_strides = max(1, int(max_batch_strides))
        # transfer_dtype="int8": uploads quantised on the host with one
        # symmetric scale per upload, dequantised on the device
        if transfer_dtype not in (None, "int8"):
            raise ValueError(
                f"transfer_dtype must be None or 'int8', got {transfer_dtype!r}")
        self._q8 = transfer_dtype == "int8"

        # base-offset buffers: _samples holds stream positions
        # [_sample_base, _sample_base + len), _mel holds frames
        # [_mel_base, _mel_base + width); prefixes outside the live decode
        # window are dropped so memory stays bounded
        self._samples = np.zeros((0,), np.float32)
        self._sample_base = 0
        self._n_samples = 0  # total stream samples seen
        self._mel = np.zeros((80, 0), np.float32)  # unnormalised mel frames
        self._mel_base = 0
        self._n_mel = 0  # total mel frames computed
        self._mel_sum = np.zeros((80,), np.float64)
        self._mel_sumsq = np.zeros((80,), np.float64)
        self._frontier = 0  # first not-yet-finalised frame (global)
        self._prev_id = self.blank_id  # CTC collapse carry across chunks
        self._ids: list[int] = []
        # per-token first-emission subsampled frame (global), for `words`
        self._id_frames: list[int] = []
        self._dirty = False
        self._text = ""
        self._finished = False

        # decoder='beam': the incremental prefix beam search over the
        # finalised rows (exact by the finalisation contract); beam_opts go
        # to BeamSearch (beam_width, alpha / beta with lm_scores, pruning)
        self.beam_topk: Optional[int] = None
        self._thr = 0.0
        if decoder == "beam":
            from lcasr_torch.decoding.beam_search import BeamSearch

            opts = dict(beam_opts or {})
            opts.setdefault("pad_id", 0)
            self._beam = BeamSearch(tokenizer=tokenizer, blank_id=self.blank_id, **opts)
            self.sparse_refetches = 0  # dense refetches (observability)
            if beam_topk is not None:
                # the search reads only a frame's above-threshold entries, so
                # the top-K fetch is exact when their count fits in K; the
                # count's threshold is a little looser than the search's, so
                # that fp32 rounding at the boundary can only cause a
                # needless refetch, never a miss
                self.beam_topk = int(min(beam_topk, self.blank_id + 1))
                self._thr = float(self._beam.top_am_threshold) - 1e-3

    # ---------------- device side ----------------
    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """One host array to the device as fp32 (int8: quantised on the host
        with a symmetric per-upload scale, dequantised on the device)."""
        if not self._q8:
            return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(self.device)
        s = float(np.abs(arr).max()) / 127.0 or 1.0
        q = np.clip(np.rint(arr / s), -127, 127).astype(np.int8)
        return (torch.from_numpy(q).to(self.device).float()
                * torch.tensor(s, dtype=torch.float32, device=self.device))

    @torch.no_grad()
    def _forward(self, windows: torch.Tensor, widths, dense: bool = False
                 ) -> Tuple[list, np.ndarray]:
        """(k, 80, ctx) windows on the device -> (the k rows' payloads for
        `_apply`, (k,) output lengths), on the host, in one copy.  `dense`:
        the beam's fp32 log-probs whatever `beam_topk` is."""
        lengths = torch.as_tensor(np.asarray(widths, np.int32), device=self.device)
        out = self.model(windows, length=lengths)
        head = decode_head(out["final_posteriors"], self.decoder,
                           None if dense else self.beam_topk, self._thr)
        *head, out_len = to_host(*head, out["length"].to(torch.int32))
        rows = [tuple(h[i] for h in head) for i in range(len(windows))]
        return [r[0] if len(r) == 1 else r for r in rows], out_len

    # ---------------- incremental mel frontend ----------------
    def _frames_available(self, n_samples: int) -> int:
        """Frames computable without end padding: frame t spans original
        samples [t*hop - pad, t*hop + pad)."""
        if n_samples < _PAD + 1:
            return 0
        return (n_samples - _PAD) // HOP_LENGTH + 1

    def _compute_frames(self, f0: int, f1: int, final: bool) -> np.ndarray:
        """Mel frames [f0, f1), with the offline frontend's center=True
        reflect framing.  `final`: reflect at the stream end too (finish
        only); while streaming only start-reflection can occur."""
        if f1 <= f0:
            return np.zeros((80, 0), np.float32)
        T = self._n_samples
        k = np.arange(N_FFT)[None, :]
        f = np.arange(f0, f1)[:, None]
        orig = f * HOP_LENGTH + k - _PAD  # global sample index
        orig = np.where(orig < 0, -orig, orig)  # reflect at start
        if final:
            # reflect at the end, repeatedly for very short streams (np.pad
            # "reflect" semantics); T >= 2 is guaranteed by _ingest's guard
            for _ in range(int(np.ceil(_PAD / max(T - 1, 1)))):
                orig = np.where(orig > T - 1, 2 * (T - 1) - orig, orig)
                orig = np.where(orig < 0, -orig, orig)
        local = orig - self._sample_base
        assert local.min() >= 0 and local.max() < len(self._samples)
        frames = torch.from_numpy(self._samples[local].astype(np.float64))
        return power_to_mel(frames).numpy().astype(np.float32)  # (80, nf)

    def _ingest(self, end_of_stream: bool) -> None:
        T = self._n_samples
        done = self._n_mel
        if end_of_stream:
            if T < 2:
                return  # sub-millisecond stream: nothing to transcribe
            avail = T // HOP_LENGTH + 1  # offline frame count
        else:
            avail = self._frames_available(T)
        if avail <= done:
            return
        new = self._compute_frames(done, avail, final=end_of_stream)
        self._mel = np.concatenate([self._mel, new], axis=1)
        self._n_mel = avail
        self._mel_sum += new.astype(np.float64).sum(-1)
        self._mel_sumsq += (new.astype(np.float64) ** 2).sum(-1)

    def _norm_params(self) -> Tuple[np.ndarray, np.ndarray]:
        """Current (mean, std) as float32 (80,) vectors: fp32 so that host
        and device normalisation give the same bits (IEEE fp32 subtract and
        divide are correctly rounded on both); the server normalises on the
        device from these same vectors."""
        if self.norm == "none":
            return (np.zeros(80, np.float32), np.ones(80, np.float32))
        if self.norm == "running":
            n = self._n_mel
            mean = self._mel_sum / max(n, 1)
            # unbiased variance, matching the offline ddof=1 normaliser
            var = (self._mel_sumsq - n * mean**2) / max(n - 1, 1)
            std = np.sqrt(np.maximum(var, 0.0)) + self.eps
        else:
            mean, std = self.norm
        return (np.asarray(mean, np.float32).reshape(80),
                np.asarray(std, np.float32).reshape(80))

    def _raw_window(self, lo: int, hi: int) -> np.ndarray:
        """Unnormalised mel [lo, hi) as float32 (the server's device-side
        window buffers hold raw frames; normalisation applies per wave with
        the current statistics)."""
        return np.asarray(
            self._mel[:, lo - self._mel_base : hi - self._mel_base],
            np.float32)

    def _normalized(self, lo: int, hi: int) -> np.ndarray:
        seg = self._raw_window(lo, hi)
        mean, std = self._norm_params()
        if self.norm == "none":
            return seg
        return (seg - mean[:, None]) / std[:, None]

    def _trim(self) -> None:
        """Drop consumed prefixes: samples already framed (keep the lookback
        the next frame needs) and mel frames behind any future window."""
        keep_sample = max(0, self._n_mel * HOP_LENGTH - _PAD)
        if keep_sample > self._sample_base:
            self._samples = self._samples[keep_sample - self._sample_base:]
            self._sample_base = keep_sample
        keep_mel = max(0, self._frontier - self.ctx)
        if keep_mel > self._mel_base:
            self._mel = self._mel[:, keep_mel - self._mel_base:]
            self._mel_base = keep_mel

    # ---------------- decode steps ----------------
    # Split so that `server.TranscriptionServer` can batch many sessions
    # onto one forward: _ready (is a step due?), _prepare (host-side window
    # build), _apply (emit + frontier advance).

    def _ready(self):
        """(end, final) for the next due step, or None."""
        n = self._n_mel
        if n - self._frontier >= self.stride + self.delay:
            # interior step: finalise a stride-sized block with full lookahead
            return (self._frontier + self.stride + self.delay, False)
        if self._finished and self._frontier < n:
            # end of stream: no future context exists, flush the tail
            return (n, True)
        return None

    def _window_start(self, end: int) -> Tuple[int, int]:
        """(win_start, width) of the window ending at `end`: aligned up so
        that win_start stays a multiple of sf (row mapping) and width <= ctx
        (one shape for the whole stream)."""
        win_start = max(0, end - self.ctx)
        win_start += (-win_start) % self.sf
        return win_start, end - win_start

    def _prepare(self, end: int):
        """The fixed-shape (80, ctx) normalised window ending at `end`:
        (window, width, win_start)."""
        win_start, width = self._window_start(end)
        window = self._normalized(win_start, end)
        if width < self.ctx:
            window = np.pad(window, ((0, 0), (0, self.ctx - width)))
        return window, width, win_start

    def _prepare_raw(self, end: int):
        """`_prepare` without normalisation: the server normalises on the
        device with `_norm_params()`."""
        win_start, width = self._window_start(end)
        window = self._raw_window(win_start, end)
        if width < self.ctx:
            window = np.pad(window, ((0, 0), (0, self.ctx - width)))
        return window, width, win_start

    def _emit_beam(self, g0: int, g1: int, win_start: int, log_probs, out_len: int,
                   tail: bool) -> None:
        """Beam-mode finalisation: advance the incremental prefix beam over
        the finalised (rows, C) log-prob block; publish the live beams'
        common prefix mid-stream, the best beam at the end of the stream."""
        r0 = (g0 - win_start) // self.sf
        r1 = out_len if tail else min((g1 - win_start) // self.sf, out_len)
        if r1 > r0:
            row0 = win_start // self.sf
            self._beam.advance(np.asarray(log_probs[r0:r1], np.float32), t0=row0 + r0)
        best = self._beam.best()
        if tail:
            ids, frames = list(best.prefix), list(best.frames)
        else:
            prefixes = self._beam.live_prefixes()
            lcp = prefixes[0]
            for p in prefixes[1:]:
                n = 0
                for a, b in zip(lcp, p):
                    if a != b:
                        break
                    n += 1
                lcp = lcp[:n]
            # the best beam starts with the common prefix, so its
            # timestamps align with the emitted ids
            ids, frames = list(lcp), list(best.frames[: len(lcp)])
        if ids != self._ids:
            self._ids, self._id_frames = ids, frames
            self._dirty = True

    def _densify_beam(self, payload, end: int, final: bool, win_start: int, out_len: int,
                      fin_end: int) -> np.ndarray:
        """A sparse (values, ids, count) payload -> the (rows, C) block
        `_emit_beam` reads.  Rows outside the finalised range stay at -1e30
        (never read).  If a finalised row's count exceeds K, the top-K is
        not provably exact: the window is fetched again, densely."""
        vals, idx, count = payload
        C = self.blank_id + 1
        r0 = (self._frontier - win_start) // self.sf
        r1 = out_len if final else min((fin_end - win_start) // self.sf, out_len)
        if r1 > r0 and int(count[r0:r1].max()) > self.beam_topk:
            self.sparse_refetches += 1
            window, width, _ = self._prepare(end)
            rows, _ = self._forward(self._upload(window[None]), [width], dense=True)
            return rows[0]
        dense = np.full((vals.shape[0], C), -1e30, np.float32)
        if r1 > r0:
            rows = np.arange(r0, r1)
            dense[rows[:, None], idx[r0:r1]] = vals[r0:r1]
        return dense

    def _apply(self, end: int, final: bool, win_start: int, payload, out_len: int) -> None:
        """Consume a forward's output for the step (end, final): this
        session's (rows,) device-argmaxed ids (greedy), its (rows, C) fp32
        log-probs (dense beam) or its (values, ids, count) top-K triple."""
        fin_end = end if final else end - self.delay
        if self.decoder == "beam":
            if isinstance(payload, tuple):
                payload = self._densify_beam(payload, end, final, win_start, out_len, fin_end)
            self._emit_beam(self._frontier, fin_end, win_start, payload, out_len, tail=final)
        else:
            self._emit(self._frontier, fin_end, win_start, payload, out_len, tail=final)
        self._frontier = fin_end

    def _emit(self, g0: int, g1: int, win_start: int, frame_ids, out_len: int,
              tail: bool) -> None:
        """Finalise global frames [g0, g1) from a window forward whose input
        started at `win_start` (a multiple of sf, so subsampled rows align).
        `tail`: take every remaining output row (g1 may not be sf-aligned at
        the end of the stream; the last subsampled row covers a partial
        group)."""
        r0 = (g0 - win_start) // self.sf
        r1 = out_len if tail else min((g1 - win_start) // self.sf, out_len)
        if r1 <= r0:
            return
        ids = np.asarray(frame_ids[r0:r1])
        row0 = win_start // self.sf  # global subsampled row of output row 0
        for j, i in enumerate(ids.tolist()):
            if i != self.blank_id and i != self._prev_id:
                self._ids.append(int(i))
                self._id_frames.append(row0 + r0 + j)
                self._dirty = True
            self._prev_id = i

    def _step(self, end: int, final: bool) -> None:
        """One fixed-shape forward over mel [end-ctx, end), finalising frames
        [frontier, end - delay), or everything through `end` when final."""
        window, width, win_start = self._prepare(end)
        payloads, out_len = self._forward(self._upload(window[None]), [width])
        self._apply(end, final, win_start, payloads[0], int(out_len[0]))

    def _delta(self) -> str:
        """Newly finalised text since the last call."""
        if not self._dirty:
            return ""
        self._dirty = False
        prev = self._text
        self._text = self.tokenizer.decode(self._ids)
        if self._text.startswith(prev):
            return self._text[len(prev):]
        # a BPE re-decode can adjust the boundary (outer whitespace
        # stripping): fall back to the common-prefix delta
        k = 0
        while k < min(len(prev), len(self._text)) and prev[k] == self._text[k]:
            k += 1
        return self._text[k:]

    def _due_interior_ends(self) -> list:
        """Ends of every interior step currently due (full lookahead
        available), up to max_batch_strides: the frontier advances by
        `stride` per interior step, so they are enumerable up front."""
        ends, f, n = [], self._frontier, self._n_mel
        while (n - f >= self.stride + self.delay
               and len(ends) < self.max_batch_strides):
            e = f + self.stride + self.delay
            ends.append(e)
            f = e - self.delay
        return ends

    def _step_many(self, ends: list) -> None:
        """One (k, 80, ctx) forward for k due interior steps, applied in
        stream order; k is snapped down to a power of two (the rest goes to
        the next _drain iteration)."""
        b = 1 << (len(ends).bit_length() - 1)
        ends = ends[:b]
        wins, widths, starts = [], [], []
        for e in ends:
            w, width, ws = self._prepare(e)
            wins.append(w)
            widths.append(width)
            starts.append(ws)
        if all(width == self.ctx for width in widths):
            # steady state (every window full): upload one strip covering
            # the union of the overlapping windows and cut the k windows on
            # the device, the same values in fewer bytes
            assert all(s - starts[0] == i * self.stride for i, s in enumerate(starts))
            strip = self._upload(self._normalized(starts[0], ends[-1]))
            batch = strip.unfold(-1, self.ctx, self.stride).permute(1, 0, 2)
        else:
            batch = self._upload(np.stack(wins))
        payloads, out_len = self._forward(batch, widths)
        for i, e in enumerate(ends):
            self._apply(e, False, starts[i], payloads[i], int(out_len[i]))

    def _drain(self) -> str:
        while True:
            ends = self._due_interior_ends()
            if len(ends) > 1:
                self._step_many(ends)
                continue
            step = self._ready()
            if step is None:
                break
            self._step(*step)
        self._trim()
        return self._delta()

    # ---------------- public API ----------------
    def _feed_ingest(self, samples: np.ndarray) -> None:
        assert not self._finished, "stream already finished"
        assert self._n_mel == 0 or self._n_samples > 0, (
            "stream already fed via feed_frames(); don't mix inputs"
        )
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._samples = np.concatenate([self._samples, samples])
        self._n_samples += len(samples)
        self._ingest(end_of_stream=False)

    def _feed_frames_ingest(self, mel: np.ndarray) -> None:
        assert not self._finished, "stream already finished"
        assert self._n_samples == 0, (
            "stream already fed raw samples; don't mix inputs"
        )
        mel = np.asarray(mel, np.float32)
        if mel.ndim == 3:
            mel = mel[0]
        self._mel = np.concatenate([self._mel, mel], axis=1)
        self._n_mel += mel.shape[1]
        self._mel_sum += mel.astype(np.float64).sum(-1)
        self._mel_sumsq += (mel.astype(np.float64) ** 2).sum(-1)

    def _finish_ingest(self) -> None:
        assert not self._finished, "stream already finished"
        self._finished = True
        if self._n_samples > 0:  # raw-sample mode; frame mode has no tail
            self._ingest(end_of_stream=True)

    def feed(self, samples: np.ndarray) -> str:
        """Append raw 16 kHz samples; returns newly finalised text."""
        self._feed_ingest(samples)
        return self._drain()

    def feed_frames(self, mel: np.ndarray) -> str:
        """Append precomputed (80, T) mel frames, for pipelines whose
        frontend already ran.  Mutually exclusive with feed(); frames are
        used as they are apart from the configured normalisation."""
        self._feed_frames_ingest(mel)
        return self._drain()

    def finish(self) -> str:
        """End of stream: compute the reflect-end-padded tail frames and
        finalise everything remaining (no lookahead left to wait for)."""
        self._finish_ingest()
        return self._drain()

    @property
    def text(self) -> str:
        return self._text

    @property
    def words(self):
        """Word-level timestamps for the finalised transcript so far:
        [{'word', 'start', 'end'} in stream seconds].  Needs a tokenizer
        with `id_to_piece` (the SentencePiece-model tokenizer)."""
        from lcasr_torch.decoding.timestamps import words_from_ids

        return words_from_ids(self.tokenizer, self._ids, self._id_frames, ds_factor=self.sf)
