"""Stream WAV file(s) through the online transcriber (the port's copy of
lcasr_tpu/serving/__main__.py).

    python -m lcasr_torch.serving <checkpoint> <audio.wav> [more.wav ...] \
        [--chunk_seconds 0.5] [--context 2048] [--stride 512] [--delay 512] \
        [--transfer_dtype float32|bfloat16|int8] [--decoder greedy|beam] \
        [--beam_width 25] [--beam_topk 32] [--device cuda|cpu]

<checkpoint> is a reference `.pt` file or a checkpoint directory of the port
(`evaluation.run.load_any_checkpoint`).  WAV files are read and resampled to
16 kHz by the port's own reader and resampler (`data/audio.py`); `.npy`
waveforms are 16 kHz.  One file: the single-stream OnlineTranscriber.
Several files: the batched TranscriptionServer, every stream fed
concurrently in chunk_seconds pieces (as live sources would), all due
decode steps sharing one (S, 80, ctx) forward per tick.  Prints each
finalised text delta with its stream-time stamp (prefixed [s<i>] in server
mode); ends with a summary line (audio seconds, wall seconds, aggregate
RTFx, device).
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def read_wave(path: str, device) -> np.ndarray:
    """The left channel of a .wav / .npy file at 16 kHz, on the host."""
    from lcasr_torch.data.audio import SR, grab_left_channel, load_audio, resample

    if path.endswith(".npy"):
        return grab_left_channel(np.load(path).astype(np.float32)).reshape(-1)
    wave, sr = load_audio(path)
    wave = grab_left_channel(wave).reshape(-1)
    if sr != SR:
        wave = resample(wave, sr, SR, device=device).cpu().numpy()
    return wave


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("checkpoint")
    parser.add_argument("audio", nargs="+",
                        help=".wav or .npy waveform(s); more than one: batched server mode")
    parser.add_argument("--chunk_seconds", type=float, default=0.5)
    parser.add_argument("--context", type=int, default=2048)
    parser.add_argument("--stride", type=int, default=512)
    parser.add_argument("--delay", type=int, default=512)
    parser.add_argument("--transfer_dtype", default="float32",
                        choices=["float32", "bfloat16", "int8"],
                        help="server-mode wave upload format")
    parser.add_argument("--decoder", default="greedy", choices=["greedy", "beam"],
                        help="beam = incremental prefix beam search over the finalised "
                             "log-probs (sparse top-K fetch)")
    parser.add_argument("--beam_width", type=int, default=25)
    parser.add_argument("--beam_topk", type=int, default=32,
                        help="the device's sparse fetch width (beam mode); "
                             "0 = dense fp32 log-prob fetch")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu (the kernels' plain versions)")
    args = parser.parse_args()

    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.device import resolve_device
    from lcasr_torch.evaluation.run import build_model, load_any_checkpoint
    from lcasr_torch.serving import OnlineTranscriber, TranscriptionServer

    device = resolve_device(args.device)
    waves = [read_wave(path, device) for path in args.audio]
    cfg, state_dict = load_any_checkpoint(args.checkpoint)
    tokenizer = load_tokenizer()
    model = build_model(cfg, state_dict, tokenizer.vocab_size(), device)
    chunk = max(1, int(args.chunk_seconds * 16000))
    audio_s = sum(len(w) for w in waves) / 16000
    kw = dict(context_frames=args.context, stride_frames=args.stride,
              right_delay_frames=args.delay, device=device, decoder=args.decoder,
              beam_opts=(dict(beam_width=args.beam_width, alpha=0.0, beta=0.0)
                         if args.decoder == "beam" else None),
              beam_topk=args.beam_topk or None)

    if len(waves) == 1:
        if args.transfer_dtype == "bfloat16":
            parser.error("--transfer_dtype bfloat16 is a server-wave-only format; "
                         "single-stream mode supports float32 or int8")
        wave = waves[0]
        tr = OnlineTranscriber(
            model, tokenizer,
            transfer_dtype="int8" if args.transfer_dtype == "int8" else None, **kw)
        t0 = time.perf_counter()
        fed = 0
        for pos in range(0, len(wave), chunk):
            fed += min(chunk, len(wave) - pos)
            delta = tr.feed(wave[pos : pos + chunk])
            if delta:
                print(f"[{fed / 16000:8.2f}s] {delta}", flush=True)
        delta = tr.finish()
        if delta:
            print(f"[{len(wave) / 16000:8.2f}s] {delta}", flush=True)
    else:
        server = TranscriptionServer(model, tokenizer, max_streams=len(waves),
                                     transfer_dtype=args.transfer_dtype, **kw)
        sids = [server.open() for _ in waves]
        t0 = time.perf_counter()
        pos, open_ = 0, set(range(len(waves)))
        while open_:
            for i in sorted(open_):
                if pos < len(waves[i]):
                    server.feed(sids[i], waves[i][pos : pos + chunk], pump=False)
            server.pump()
            pos += chunk
            for i in sorted(open_):
                delta = server.poll(sids[i])
                if delta:
                    print(f"[s{i} {min(pos, len(waves[i])) / 16000:8.2f}s] {delta}",
                          flush=True)
                if pos >= len(waves[i]):
                    delta = server.finish(sids[i])
                    if delta:
                        print(f"[s{i} {len(waves[i]) / 16000:8.2f}s] {delta}", flush=True)
                    open_.discard(i)
    wall = time.perf_counter() - t0
    print(f"-- {audio_s:.1f}s audio in {wall:.2f}s wall "
          f"(aggregate RTFx {audio_s / max(wall, 1e-9):.1f}) on {device}")


if __name__ == "__main__":
    main()
