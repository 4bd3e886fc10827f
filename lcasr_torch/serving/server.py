"""Batched multi-stream transcription serving (the port's copy of
lcasr_tpu/serving/server.py).

Up to `max_streams` concurrent online sessions share one forward of batch
`max_streams`.  Why batch: at batch 1 x ctx 2048 the card's tensor cores
starve, so S sessions cost far less than S times one session's device time,
and S due steps ride one launch sequence instead of S.

Scheduling: `pump()` repeatedly collects every session with a due step
(`OnlineTranscriber._ready`), builds the (S, 80, ctx) batch on the host
(`_prepare_raw`), runs the one forward, and feeds each row back (`_apply`).
Sessions with no due step cost nothing; idle batch rows carry zeros and their
outputs are discarded.  Each row's result is the single-stream path's: the
model is batch-independent at inference (BatchRenorm uses running
statistics; attention and norms are per sample).

Each slot's raw mel window stays on the device between waves (`_win_buf`,
(S, 80, ctx)).  Steady-state waves upload only each due slot's new `stride`
frames and roll the buffer (the delta wave); ramp-in, flush and reused slots
take the full wave, which rewrites the due rows.  Normalisation runs on the
device from per-slot fp32 (mean, std) vectors of each session's current
statistics; columns past a window's width are zero after it, as the
single-stream transcriber pads them, so each row is the single-stream
path's (the JAX server normalises those columns to -mean / std).
Compressed uploads (bfloat16, int8) travel in normalised units
and are un-normalised on the device before they enter the buffer: raw power
mel spans orders of magnitude across bins and sessions, so one shared int8
scale on raw values would zero out quiet bins.

`device=None` means the GPU and raises without one; the model must already
be there.  decoder="beam": each session runs its incremental prefix beam
search over its finalised rows; a wave fetches the device's top-K values,
ids and above-threshold counts of every row and the output lengths in one
copy (or the dense fp32 rows with `beam_topk=None`), and a session whose
finalised row holds more than K classes within the threshold fetches its
window again, densely, on its own.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from lcasr_torch.serving.transcriber import (
    OnlineTranscriber,
    decode_head,
    model_device,
    to_host,
)


class TranscriptionServer:
    """Up to `max_streams` concurrent `OnlineTranscriber` sessions batched
    onto one forward.

    open(**session_kw) -> sid
    feed(sid, samples) / feed_frames(sid, mel) -> newly finalised text
    finish(sid) -> remaining text (closes the session, frees the slot)
    poll(sid) -> finalised text buffered by other sessions' pumps
    text(sid) -> full transcript so far
    """

    def __init__(
        self,
        model,
        tokenizer,
        max_streams: int = 8,
        context_frames: int = 2048,
        stride_frames: int = 512,
        right_delay_frames: int = 512,
        transfer_dtype: str = "float32",
        decoder: str = "greedy",
        beam_opts: Optional[dict] = None,
        beam_topk: Optional[int] = 32,
        device=None,
    ):
        assert max_streams >= 1
        assert decoder in ("greedy", "beam")
        # wave upload format: 'float32' (exact, the default), 'bfloat16'
        # (half the bytes), 'int8' (a quarter: one symmetric scale per wave,
        # quantised on the host, dequantised once on the device)
        assert transfer_dtype in ("float32", "bfloat16", "int8")
        self.device = model_device(model, device)
        self.model = model.eval()
        self.tokenizer = tokenizer
        self.S = max_streams
        self.ctx = context_frames
        self.stride = stride_frames
        self.delay = right_delay_frames
        self.transfer_dtype = transfer_dtype
        self.decoder = decoder
        self.beam_opts = beam_opts
        self.beam_topk = None
        self._thr = 0.0
        if decoder == "beam" and beam_topk is not None:
            from lcasr_torch.decoding.beam_search import DEFAULT_TOP_AM_THRESHOLD

            self.beam_topk = int(min(beam_topk, tokenizer.vocab_size() + 1))
            # looser than the search's threshold: see OnlineTranscriber
            self._thr = float((beam_opts or {}).get(
                "top_am_threshold", DEFAULT_TOP_AM_THRESHOLD)) - 1e-3
        self._win_buf = torch.zeros((self.S, 80, self.ctx), dtype=torch.float32,
                                    device=self.device)
        # dispatch accounting: waves, delta waves, uploaded bytes
        self.wave_count = 0
        self.delta_wave_count = 0
        self.upload_bytes = 0
        self._sessions: Dict[int, OnlineTranscriber] = {}
        self._out: Dict[int, List[str]] = {}
        self._slot: Dict[int, int] = {}  # sid -> fixed buffer row
        self._free_slots = list(range(self.S - 1, -1, -1))
        self._dev_end: Dict[int, Optional[int]] = {}  # sid -> buffered window end
        self._next_sid = 0

    # ---------------- the two device programs ----------------
    def _ingest(self, payload, scale, mean, std) -> torch.Tensor:
        x = payload.float() * scale
        if self.transfer_dtype != "float32":
            x = x * std[:, :, None] + mean[:, :, None]
        return x

    @torch.no_grad()
    def _run(self, new_buf, mean, std, lengths):
        w = (new_buf - mean[:, :, None]) / std[:, :, None]
        # columns past a window's width are zeros after normalisation, as in
        # the single-stream `_prepare` (not -mean / std): the model's last
        # valid rows see them, and every row attends to those
        cols = torch.arange(self.ctx, device=w.device)
        w = w.masked_fill(cols[None, None, :] >= lengths[:, None, None], 0.0)
        out = self.model(w, length=lengths)
        head = decode_head(out["final_posteriors"], self.decoder, self.beam_topk, self._thr)
        return (new_buf,) + head + (out["length"].to(torch.int32),)

    def _forward_full(self, win_buf, rows, due, scale, mean, std, lengths):
        """Full wave: the due rows' buffers become `rows` (S, 80, ctx)."""
        raw = self._ingest(rows, scale, mean, std)
        return self._run(torch.where(due[:, None, None], raw, win_buf), mean, std, lengths)

    def _forward_delta(self, win_buf, deltas, due, scale, mean, std, lengths):
        """Delta wave: each due row's buffer moves on by `stride` frames,
        `deltas` (S, 80, stride)."""
        new = self._ingest(deltas, scale, mean, std)
        rolled = torch.cat([win_buf[:, :, self.stride:], new], dim=-1)
        return self._run(torch.where(due[:, None, None], rolled, win_buf), mean, std, lengths)

    # ---------------- session lifecycle ----------------
    def open(
        self,
        norm: Union[str, Tuple[np.ndarray, np.ndarray]] = "running",
        eps: float = 1e-8,
    ) -> int:
        """Start a session; returns its id.  Raises when at capacity."""
        if len(self._sessions) >= self.S:
            raise RuntimeError(
                f"server at capacity ({self.S} streams); finish() one first"
            )
        session = OnlineTranscriber(
            self.model, self.tokenizer, context_frames=self.ctx,
            stride_frames=self.stride, right_delay_frames=self.delay, norm=norm,
            eps=eps, decoder=self.decoder, beam_opts=self.beam_opts,
            beam_topk=self.beam_topk, device=self.device,
        )
        sid = self._next_sid
        self._next_sid += 1
        self._sessions[sid] = session
        self._out[sid] = []
        self._slot[sid] = self._free_slots.pop()
        self._dev_end[sid] = None  # buffer row not yet valid
        return sid

    def _session(self, sid: int) -> OnlineTranscriber:
        if sid not in self._sessions:
            raise KeyError(f"no open session {sid}")
        return self._sessions[sid]

    # ---------------- batched pump ----------------
    def _to_device(self, host: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(host)
        if self.transfer_dtype == "bfloat16":
            t = t.to(torch.bfloat16)  # rounded on the host: half the bytes travel
        return t.to(self.device)

    def pump(self) -> None:
        """Run due steps for all sessions, one batched forward per wave,
        until no session has a due step; then buffer each session's newly
        finalised text.  Called by feed/feed_frames/finish unless they get
        pump=False: an event loop ingesting a whole arrival tick feeds every
        session with pump=False and pumps once, so that concurrent due steps
        share a wave."""
        while True:
            due = []
            for sid, s in self._sessions.items():
                step = s._ready()
                if step is not None:
                    due.append((sid, s, step))
            if not due:
                break
            # delta wave: every due session advances its already-buffered
            # full window by exactly one stride (the steady state)
            all_delta = all(
                not final
                and self._dev_end[sid] == end - self.stride
                and end - self.ctx >= 0
                for sid, s, (end, final) in due
            )
            lengths = np.full((self.S,), self.ctx, np.int32)  # idle rows
            due_mask = np.zeros((self.S,), bool)
            mean = np.zeros((self.S, 80), np.float32)
            std = np.ones((self.S, 80), np.float32)
            metas = []
            width_cols = self.stride if all_delta else self.ctx
            payload_host = np.zeros((self.S, 80, width_cols), np.float32)
            for sid, s, (end, final) in due:
                i = self._slot[sid]
                due_mask[i] = True
                mean[i], std[i] = s._norm_params()
                if all_delta:
                    win_start, width = end - self.ctx, self.ctx
                    payload_host[i] = s._raw_window(end - self.stride, end)
                else:
                    window, width, win_start = s._prepare_raw(end)
                    payload_host[i] = window
                lengths[i] = width
                # full-width interior windows leave a reusable buffer row;
                # anything else (short ramp-in window, final flush) does not
                self._dev_end[sid] = end if (not final and width == self.ctx) else None
                metas.append((s, i, end, final, win_start))
            if self.transfer_dtype != "float32":
                # compressed uploads travel in normalised units; idle rows
                # have mean 0 and std 1
                payload_host = (payload_host - mean[:, :, None]) / std[:, :, None]
            if self.transfer_dtype == "int8":
                scale = float(np.abs(payload_host).max()) / 127.0 or 1.0
                host = np.clip(np.rint(payload_host / scale), -127, 127).astype(np.int8)
            else:
                scale = 1.0
                host = payload_host
            self.wave_count += 1
            self.delta_wave_count += int(all_delta)
            self.upload_bytes += host.size * (2 if self.transfer_dtype == "bfloat16"
                                              else host.itemsize)
            dev = self.device
            fwd = self._forward_delta if all_delta else self._forward_full
            self._win_buf, *outs = fwd(
                self._win_buf, self._to_device(host),
                torch.from_numpy(due_mask).to(dev),
                torch.tensor(scale, dtype=torch.float32, device=dev),
                torch.from_numpy(mean).to(dev), torch.from_numpy(std).to(dev),
                torch.from_numpy(lengths).to(dev),
            )
            *head, out_lens = to_host(*outs)  # the wave's one fetch
            for s, i, end, final, win_start in metas:
                payload = tuple(h[i] for h in head)
                s._apply(end, final, win_start, payload if len(payload) > 1 else payload[0],
                         int(out_lens[i]))
        for sid, s in self._sessions.items():
            s._trim()
            delta = s._delta()
            if delta:
                self._out[sid].append(delta)

    def _take(self, sid: int) -> str:
        parts = self._out[sid]
        self._out[sid] = []
        return "".join(parts)

    # ---------------- public API ----------------
    def feed(self, sid: int, samples: np.ndarray, pump: bool = True) -> str:
        """Append raw 16 kHz samples to session `sid`; returns its newly
        finalised text (text finalised for other sessions by this pump is
        buffered for their next feed/poll).  pump=False only ingests and
        returns "": it must not drain the buffer, or text finalised for
        this session by another session's pump would be lost to a caller
        that ignores the ingest-only return; batch a tick's arrivals, then
        pump() once and poll()."""
        self._session(sid)._feed_ingest(samples)
        if not pump:
            return ""
        self.pump()
        return self._take(sid)

    def feed_frames(self, sid: int, mel: np.ndarray, pump: bool = True) -> str:
        """Append precomputed (80, T) mel frames to session `sid`."""
        self._session(sid)._feed_frames_ingest(mel)
        if not pump:
            return ""
        self.pump()
        return self._take(sid)

    def poll(self, sid: int) -> str:
        """Collect text finalised for `sid` since its last feed/poll."""
        self._session(sid)
        return self._take(sid)

    def finish(self, sid: int) -> str:
        """End session `sid`: flush its tail, free the slot, return the
        remaining finalised text."""
        session = self._session(sid)
        session._finish_ingest()
        self.pump()
        remaining = self._take(sid)
        del self._sessions[sid]
        del self._out[sid]
        self._free_slots.append(self._slot.pop(sid))
        del self._dev_end[sid]
        return remaining

    def text(self, sid: int) -> str:
        """Full transcript of an open session so far (buffered included)."""
        return self._session(sid).text

    def words(self, sid: int):
        """Word-level timestamps of an open session's finalised transcript
        ([{'word', 'start', 'end'} in stream seconds])."""
        return self._session(sid).words

    @property
    def n_open(self) -> int:
        return len(self._sessions)
