"""Averaged-moving-window streaming decode and the buffered decode
(counterpart of lcasr_tpu/evaluation/streaming.py: `StreamingDecoder`,
`fetch_logits`, `fetch_logits_buffered`, `make_windowed_model_fn`).

Overlapping windows of `seq_len` frames at stride `seq_len - overlap`; the
posteriors of overlapping frames are averaged.  The spectrogram is uploaded
once (or in per-group stripes, `pipeline_upload`); windows are gathered on
the device, `window_batch_size` per forward, with columns past each window's
true length zeroed and the ragged last batch padded with zero-length windows
that add nothing.  `exp(log_probs)` and counts accumulate into fp32
(total, C) buffers on the device at offsets computed on the host; the result
is the argmax (`greedy`) or the log (`logits`) of the average.

When `seq_len` exceeds the recording, one window covers all of it.  Its
static width is then the next multiple of 4096 frames, as in the JAX
decoder, with the tail masked by the true length: the conv subsampling sees
act(bias) rows past the true extent where a window of the exact width sees
zero padding, and the last output frames read them, so the two widths do
not give the same numbers when the recording's length is not a multiple of
8.  Stacking subsampling keeps the exact width (its output length depends
on the static pad), and so does `fetch_logits`.  The JAX package's other
compile buckets (of the buffer rows, the upload width and the batch count)
exist for XLA recompiles only and are dropped: outputs up to `n_out` are
the same.

`transfer_dtype` int8 / int4 quantise the upload on the host (int8: one
symmetric scale per recording; int4: a (lo, step) pair per mel bin, two
codes per byte, big nibble first) and dequantise to bf16 on the device, so
the forward never sees the quantised array.

`mesh` (a `parallel.Mesh`, one process per GPU) decodes data-parallel:
every rank holds the spectrogram, each window batch (W padded to a
multiple of `data`) is cut into `data` parts, each rank forwards its part
and accumulates local sums and counts, and one all-reduce over `data`
merges them, as the JAX decoder's shard_map psums.  Every rank returns the
same result.  `make_cp_windowed_model_fn` is the context-parallel single
pass: the recording's time axis sharded over `seq`.
"""
from __future__ import annotations

import math
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from lcasr_torch.device import resolve_device


def subsampled_length(u_len: int, factor: int, mode: str = "dw_striding",
                      window_t: Optional[int] = None) -> int:
    """Host-side output length of each subsampling mode (`calc_length`)."""
    if mode == "stacking":
        t = window_t if window_t is not None else u_len
        pad = (factor - t % factor) % factor
        return max((u_len + pad) // factor, 1)
    n = u_len
    for _ in range(int(math.log2(factor))):
        if mode == "vggnet":
            n = math.ceil((n - 2) / 2 + 1)
        else:
            n = math.floor((n - 1) / 2 + 1)
    return int(n)


def _window_positions(spec_n: int, seq_len: int, overlap: int):
    """(start, true_length) per window, with the reference's truncation
    guard: one trailing short window is allowed, then the walk stops."""
    positions, last_ulen, kill_next = [], None, False
    for i in range(0, spec_n, seq_len - overlap):
        u_len = min(seq_len, spec_n - i)
        if kill_next:
            break
        if last_ulen is not None and u_len < last_ulen:
            kill_next = True
        last_ulen = u_len
        positions.append((i, u_len))
    return positions


def _output_offsets(positions, seq_len: int, overlap: int, factor: int, mode: str):
    """Per window its first row in the merged buffer and its valid rows; then
    the merged length and the buffer's rows (one padded window of slack)."""
    offsets, n_valid, pos = [], [], 0
    for i, u_len in positions:
        n = subsampled_length(u_len, factor, mode, window_t=seq_len)
        if i != 0:
            pos -= int(overlap / (u_len / n))
        offsets.append(pos)
        n_valid.append(n)
        pos += n
    return offsets, n_valid, pos, pos + subsampled_length(seq_len, factor, mode, window_t=seq_len)


_FLOAT_TRANSFER = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                   "float16": torch.float16}


def _normalize_transfer_dtype(transfer_dtype):
    """"int8", "int4", or a float torch dtype.  Takes the names, torch
    dtypes and numpy dtype spellings (np.int8, np.dtype("int8"), ...); an
    integer type other than the two quantised ones is refused, not cast."""
    if transfer_dtype is None:
        return torch.bfloat16
    if isinstance(transfer_dtype, str):
        name = transfer_dtype
    elif isinstance(transfer_dtype, torch.dtype):
        name = str(transfer_dtype).replace("torch.", "")
    else:
        try:
            name = np.dtype(transfer_dtype).name
        except TypeError:
            raise ValueError(f"unrecognized transfer_dtype: {transfer_dtype!r}") from None
    if name in ("int8", "int4"):
        return name
    if name in _FLOAT_TRANSFER:
        return _FLOAT_TRANSFER[name]
    raise ValueError(f"unsupported transfer_dtype {name!r}: expected one of int8/int4 "
                     "(quantized) or float32/bfloat16/float16")


def dequant(spec_i8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 codes -> bf16 mel values."""
    return spec_i8.to(torch.bfloat16) * scale.to(torch.bfloat16)


def dequant4(packed_u8: torch.Tensor, lo: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """Two 4-bit codes per byte (big nibble first) -> bf16 mel values by the
    per-mel-bin affine parameters."""
    q = torch.stack([(packed_u8 >> 4).float(), (packed_u8 & 0xF).float()], dim=-1)
    q = q.reshape(packed_u8.shape[0], -1)
    return (lo[:, None] + step[:, None] * q).to(torch.bfloat16)


class StreamingDecoder:
    """Device-resident moving-window decoder for one model.

    `device=None` means the GPU and raises without one.  `transfer_dtype`
    is the upload form of the spectrogram: fp32, bf16 (the default) or fp16,
    or "int8" / "int4" (quantised on the host, dequantised to bf16 on the
    device).  `cache_upload` keeps the device spectrogram and reuses it when
    the same host array object is decoded again.  `pipeline_upload` uploads
    one stripe per window group from pinned memory on a side stream, each
    group's forward waiting for its own stripe and the next one's halo only.
    `mesh`: the data-parallel decode (see the module docstring); it takes
    precedence over `pipeline_upload`, which it ignores with a warning."""

    def __init__(self, model, n_classes: int, subsampling_factor: Optional[int] = None,
                 window_batch_size: int = 16, transfer_dtype=torch.bfloat16,
                 subsampling_mode: Optional[str] = None, device=None,
                 pipeline_upload: bool = False, mesh=None, cache_upload: bool = False):
        self.mesh = mesh
        self.n_dp = mesh.size("data") if mesh is not None else 1
        self.transfer_dtype = _normalize_transfer_dtype(transfer_dtype)
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.n_classes = n_classes
        self.ds = subsampling_factor or getattr(model, "subsampling_factor", 8)
        self.mode = subsampling_mode or getattr(model, "subsampling_mode", "dw_striding")
        self.W = window_batch_size
        self.pipeline_upload = pipeline_upload
        self.cache_upload = cache_upload
        self._upload_memo = None  # (host array object, quant, device spec)

    # -- upload ------------------------------------------------------------
    def _quant_params(self, spec: np.ndarray):
        """Per-recording quantisation parameters, from the unpadded
        spectrogram.  int8: one symmetric scale.  int4: per mel bin, its
        [min, max] mapped onto 16 levels."""
        if self.transfer_dtype == "int8":
            return ("int8", float(np.abs(spec).max()) / 127.0 or 1.0)
        if self.transfer_dtype == "int4":
            lo = spec.min(axis=-1).astype(np.float32)
            step = np.maximum((spec.max(axis=-1) - lo) / 15.0, 1e-8).astype(np.float32)
            return ("int4", lo, step)
        return None

    def _put(self, host: np.ndarray, pinned: bool, dtype=None) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(host))
        if pinned and self.device.type == "cuda":
            # cast on the host, so that the pinned copy is the only transfer
            return t.to(dtype or t.dtype).pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device, dtype or t.dtype)

    def _upload(self, host_f32: np.ndarray, quant, pinned: bool = False) -> torch.Tensor:
        """Host cast or quantisation, one copy to the device, and for the
        quantised forms one dequantisation back to bf16 there."""
        if quant is not None and quant[0] == "int8":
            scale = quant[1]
            q = np.clip(np.rint(host_f32 / scale), -127, 127).astype(np.int8)
            return dequant(self._put(q, pinned),
                           torch.tensor(scale, dtype=torch.float32, device=self.device))
        if quant is not None and quant[0] == "int4":
            _, lo, step = quant
            orig_w = host_f32.shape[-1]
            if orig_w % 2:
                host_f32 = np.pad(host_f32, ((0, 0), (0, 1)))
            q = np.clip(np.rint((host_f32 - lo[:, None]) / step[:, None]), 0, 15).astype(np.uint8)
            packed = (q[:, 0::2] << 4) | q[:, 1::2]
            out = dequant4(self._put(packed, pinned), self._put(lo, False),
                           self._put(step, False))
            return out[:, :orig_w] if orig_w % 2 else out
        return self._put(np.asarray(host_f32, np.float32), pinned, self.transfer_dtype)

    # -- forward of one window group -----------------------------------------
    def _accumulate_group(self, spec_dev, base, group, offsets, n_valid, seq_len, W,
                          sums, counts):
        """Gather the group's windows from `spec_dev` (whose column 0 is the
        recording's frame `base`), run them, add their posteriors.  Under a
        mesh: this rank's W / data of them (a rank whose part holds only
        padding windows runs nothing)."""
        if self.mesh is not None:
            W //= self.n_dp
            lo = self.mesh.index("data") * W
            group, offsets, n_valid = group[lo:lo + W], offsets[lo:lo + W], n_valid[lo:lo + W]
            if not group:
                return
        dev = self.device
        T = spec_dev.shape[-1]
        cols = torch.arange(seq_len, device=dev)
        starts = torch.zeros(W, dtype=torch.int64)
        lengths = torch.zeros(W, dtype=torch.int32)
        for j, (i, u_len) in enumerate(group):
            starts[j], lengths[j] = i - base, u_len
        starts, lengths = starts.to(dev), lengths.to(dev)
        idx = (starts[:, None] + cols[None, :]).clamp(0, T - 1)
        wins = spec_dev[:, idx].transpose(0, 1)  # (W, 80, seq_len)
        wins = wins.masked_fill((cols[None, :] >= lengths[:, None])[:, None, :], 0.0)
        log_probs = self.model(wins, length=lengths)["final_posteriors"]
        for j in range(len(group)):  # padding windows add nothing
            off, n = offsets[j], n_valid[j]
            sums[off : off + n] += torch.exp(log_probs[j, :n].float())
            counts[off : off + n] += 1.0

    def _run_pipelined(self, spec, positions, offsets, n_valid, seq_len, overlap, W,
                       sums, counts, quant):
        """One stripe of W * stride frames per window group, all queued for
        upload at once on a side stream; group g's forward waits for stripes
        g and g + 1 (its halo of `overlap` frames) only, so later stripes
        travel while earlier groups compute.  Same windows, same batches:
        the result equals the single-upload decode."""
        stride = seq_len - overlap
        P = W * stride
        G = -(-len(positions) // W)
        cuda = self.device.type == "cuda"
        main = torch.cuda.current_stream(self.device) if cuda else None
        side = torch.cuda.Stream(self.device) if cuda else None
        pieces, events = [], []
        if cuda:
            side.wait_stream(main)
        # G stripes and one halo stripe: the last group's windows reach past
        # G * P into frames that belong to no group of their own
        for g in range(G + 1):
            pc = spec[:, g * P : g * P + P]
            if pc.shape[-1] == 0:
                pieces.append(None)  # no frame of the recording: zeros below
                events.append(None)
                continue
            if pc.shape[-1] < P:
                pc = np.pad(pc, ((0, 0), (0, P - pc.shape[-1])))
            if cuda:
                with torch.cuda.stream(side):
                    piece = self._upload(pc, quant, pinned=True)
                    event = torch.cuda.Event()
                    event.record(side)
                piece.record_stream(main)
            else:
                piece, event = self._upload(pc, quant), None
            pieces.append(piece)
            events.append(event)
        zero = torch.zeros((spec.shape[0], P), dtype=pieces[0].dtype, device=self.device)
        pieces = [zero if p is None else p for p in pieces]
        for g in range(G):
            for event in events[g : g + 2]:
                if event is not None:
                    main.wait_event(event)
            spec_g = torch.cat([pieces[g], pieces[g + 1][:, :overlap]], dim=-1)
            lo = g * W
            self._accumulate_group(spec_g, g * P, positions[lo : lo + W], offsets[lo : lo + W],
                                   n_valid[lo : lo + W], seq_len, W, sums, counts)

    @torch.no_grad()
    def _run(self, spec: np.ndarray, seq_len: int, overlap: int):
        memo_key = spec if self.cache_upload else None
        spec = np.asarray(spec)
        if spec.ndim == 3:
            spec = spec[0]
        spec_n = spec.shape[-1]
        if seq_len > spec_n:  # windowed-attention mode: one window
            if self.mode == "stacking":
                seq_len, overlap = spec_n, 0
            else:
                seq_len, overlap = -(-spec_n // 4096) * 4096, 0
        if overlap % self.ds:
            raise ValueError("overlap must be a multiple of the downsampling factor")
        if seq_len <= overlap:
            raise ValueError(f"seq_len {seq_len} must exceed overlap {overlap}")
        positions = _window_positions(spec_n, seq_len, overlap)
        offsets, n_valid, n_out, total = _output_offsets(positions, seq_len, overlap,
                                                         self.ds, self.mode)

        memo = self._upload_memo
        if memo_key is not None and memo is not None and memo[0] is memo_key:
            quant = memo[1]
        else:
            memo, quant = None, self._quant_params(spec)

        dev = self.device
        sums = torch.zeros((total, self.n_classes), dtype=torch.float32, device=dev)
        counts = torch.zeros((total, 1), dtype=torch.float32, device=dev)
        W = min(self.W, len(positions))
        pipelined = self.pipeline_upload and len(positions) > W
        if self.mesh is not None:
            # W padded to a multiple of the data axis (zero-length windows
            # are inert)
            W = -(-W // self.n_dp) * self.n_dp
            if self.pipeline_upload:
                warnings.warn("pipeline_upload is ignored under data-parallel decode "
                              "(the mesh path takes precedence)", stacklevel=3)
            pipelined = False
        if pipelined and overlap > W * (seq_len - overlap):
            # a group's halo is one stripe; windows reaching further would
            # read clamped frames
            warnings.warn(
                f"pipeline_upload disabled: overlap {overlap} exceeds the one-stripe halo "
                f"(W*stride = {W * (seq_len - overlap)}); raise window_batch_size to "
                f"re-enable", stacklevel=3)
            pipelined = False
        if pipelined:
            self._run_pipelined(spec, positions, offsets, n_valid, seq_len, overlap, W,
                                sums, counts, quant)
        else:
            if memo is not None:
                spec_dev = memo[2]
            else:
                spec_dev = self._upload(spec, quant)  # the one upload
                if memo_key is not None:
                    self._upload_memo = (memo_key, quant, spec_dev)
            for b0 in range(0, len(positions), W):
                self._accumulate_group(spec_dev, 0, positions[b0 : b0 + W],
                                       offsets[b0 : b0 + W], n_valid[b0 : b0 + W],
                                       seq_len, W, sums, counts)
        if self.mesh is not None:  # the ranks' partial overlap-sums, merged
            from lcasr_torch.parallel.collectives import all_reduce_

            all_reduce_(sums, self.mesh.group("data"))
            all_reduce_(counts, self.mesh.group("data"))
        return sums[:n_out] / counts[:n_out].clamp_min(1.0)

    def logits(self, spec: np.ndarray, seq_len: int, overlap: int) -> np.ndarray:
        """Merged averaged log-probs (T', C)."""
        return torch.log(self._run(spec, seq_len, overlap)).cpu().numpy()

    def greedy(self, spec: np.ndarray, seq_len: int, overlap: int) -> np.ndarray:
        """Merged per-frame argmax ids (T',)."""
        return self._run(spec, seq_len, overlap).argmax(-1).cpu().numpy()


# ---------------------------------------------------------------------------
# functional API: host-sliced windows through a model_fn
# ---------------------------------------------------------------------------
def make_windowed_model_fn(model) -> Callable:
    """model_fn(audio (W, 80, T), lengths (W,)) -> (log_probs, out_lens), as
    tensors on the model's device; takes numpy arrays or tensors."""
    model.eval()

    @torch.no_grad()
    def call(audio, length):
        dev = next(model.parameters()).device
        out = model(torch.as_tensor(audio).to(dev),
                    length=torch.as_tensor(length).to(dev, torch.int32))
        return out["final_posteriors"], out["length"]

    return call


def make_cp_windowed_model_fn(model, mesh, seq_axis: str = "seq") -> Callable:
    """Context-parallel single-pass forward (lcasr_tpu's function of the
    same name): the recording's time axis sharded over the mesh `seq` axis
    (`parallel/cp_model.py`), for a windowed-attention decode whose
    one-pass forward exceeds one card's memory.  model_fn(audio (W, 80, T)
    whole on every rank, lengths (W,)) -> (log-probs of the whole sequence,
    out lengths) on every rank; the static width is padded to a multiple of
    n x the subsampling factor, the true lengths mask the pad.  Use it with
    `fetch_logits(..., window_batch_size=1)`.  The model stays bound to the
    mesh (`parallel.cp_model.bind_mesh(model, None)` undoes it)."""
    from lcasr_torch.parallel.cp_model import context_parallel_apply, shard_time

    model.eval()
    n = mesh.size(seq_axis)
    sf = getattr(model, "subsampling_factor", 8)

    @torch.no_grad()
    def call(audio, length):
        dev = next(model.parameters()).device
        audio = torch.as_tensor(np.asarray(audio) if not torch.is_tensor(audio) else audio)
        pad = (-audio.shape[-1]) % (n * sf)
        if pad:
            audio = torch.nn.functional.pad(audio, (0, pad))
        local = shard_time(audio, mesh, seq_axis).to(dev)
        out = context_parallel_apply(model, local, mesh,
                                     lengths=torch.as_tensor(length).to(dev, torch.int32),
                                     seq_axis=seq_axis, gather=True)
        return out["final_posteriors"], out["length"]

    return call


def _progress(items, use_tqdm: bool):
    if not use_tqdm:
        return items
    from tqdm import tqdm  # only for a caller who asks for the bar

    return tqdm(list(items))


@torch.no_grad()
def fetch_logits(model_fn: Callable, spec: np.ndarray, seq_len: int, overlap: int,
                 n_classes: int, subsampling_factor: int = 8, use_tqdm: bool = False,
                 window_batch_size: int = 8,
                 subsampling_mode: str = "dw_striding") -> np.ndarray:
    """Averaged moving window decode of spec (1, 80, T) -> (T', n_classes)
    log-probs, windows sliced on the host at their exact width.
    model_fn(chunks (W, 80, seq_len), lengths (W,)) -> (log_probs, out_lens).
    Prefer `StreamingDecoder` for device-resident decoding."""
    spec = np.asarray(spec)
    spec_n = spec.shape[-1]
    if seq_len > spec_n:
        seq_len, overlap = spec_n, 0
    if overlap % subsampling_factor:
        raise ValueError("overlap must be a multiple of the downsampling factor")
    if seq_len <= overlap:
        raise ValueError(f"seq_len {seq_len} must exceed overlap {overlap}")
    positions = _window_positions(spec_n, seq_len, overlap)
    offsets, _, n_out, total = _output_offsets(positions, seq_len, overlap,
                                               subsampling_factor, subsampling_mode)
    W = window_batch_size
    sums = counts = None
    for b0 in _progress(range(0, len(positions), W), use_tqdm):
        group = positions[b0 : b0 + W]
        batch = np.zeros((W, spec.shape[-2], seq_len), np.float32)
        lengths = np.zeros((W,), np.int32)
        for j, (i, u_len) in enumerate(group):
            batch[j, :, :u_len] = spec[0, :, i : i + u_len]
            lengths[j] = u_len
        log_probs, out_len = model_fn(batch, lengths)
        log_probs = torch.as_tensor(log_probs)
        if sums is None:
            sums = torch.zeros((total, n_classes), dtype=torch.float32, device=log_probs.device)
            counts = torch.zeros((total, 1), dtype=torch.float32, device=log_probs.device)
        out_len = [int(n) for n in torch.as_tensor(out_len).cpu()]
        for j in range(len(group)):  # the batch's padding windows add nothing
            off, n = offsets[b0 + j], out_len[j]
            sums[off : off + n] += torch.exp(log_probs[j, :n].float())
            counts[off : off + n] += 1.0
    return torch.log(sums / counts.clamp_min(1.0))[:n_out].cpu().numpy()


@torch.no_grad()
def fetch_logits_buffered(model_fn: Callable, spec: np.ndarray, seq_len: int, overlap: int,
                          n_classes: int, subsampling_factor: int = 8,
                          use_tqdm: bool = False) -> np.ndarray:
    """Buffered transcription: each chunk of `seq_len - overlap` frames gets
    overlap / 2 frames of context on each side; only the logits of the
    chunk itself are kept, each output frame exactly once."""
    spec = np.asarray(spec)
    spec_n = spec.shape[-1]
    if seq_len > spec_n:
        seq_len, overlap = spec_n, 0
    if overlap % 2:
        raise ValueError("overlap must be even")
    chunk_size = seq_len - overlap
    if chunk_size <= 0:
        raise ValueError(f"seq_len {seq_len} must exceed overlap {overlap}")
    buf = overlap // 2
    outputs = []
    for start in _progress(range(0, spec_n, chunk_size), use_tqdm):
        ctx_start = max(0, start - buf)
        ctx_end = min(spec_n, start + chunk_size + buf)
        audio_chunk = spec[:, :, ctx_start:ctx_end]
        u_len = audio_chunk.shape[-1]
        if u_len < seq_len:
            audio_chunk = np.pad(audio_chunk, ((0, 0), (0, 0), (0, seq_len - u_len)))
        log_probs, out_len = model_fn(audio_chunk, np.array([u_len], np.int32))
        n_valid = int(torch.as_tensor(out_len).cpu()[0])
        lp = torch.as_tensor(log_probs)[0, :n_valid].float().cpu().numpy()
        ratio = u_len / n_valid
        rel_start = start - ctx_start
        center_lo = int(rel_start / ratio)
        center_hi = int(min(rel_start + chunk_size, u_len) / ratio)
        outputs.append(lp[center_lo:center_hi])
        if start + chunk_size >= spec_n:
            break
    return np.concatenate(outputs, axis=0)
