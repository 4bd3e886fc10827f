"""Traffic driver: a closed loop of long recordings through the port's
averaged moving-window decoder (`StreamingDecoder`), one after another.

Set-up: the model with the seeded weights, a pool of `pool` distinct
recordings of `frames` x `n_mels` fp32 log-mel frames on the host (drawn on
the card from the seed and copied over), the decoder, and `warmup` decodes
of the pool's first recordings (the only shapes the window uses).
Window: recording n is the pool's n mod `pool`; each is decoded as
`StreamingDecoder.greedy` decodes (upload, window groups, averaged
probabilities, argmax, ids to the host) until `seconds` have passed; the
window ends when the last one's ids are on the host.

decode_rtfx = audio seconds of every recording decoded / the window's
wall seconds, over the recordings that decoded (attempted counts every
recording the window started, failed those that raised or gave a
non-finite probability).  The averaged probabilities of `judged`
recordings, drawn from the seed among the window's first `pool`, are
copied to the host as they are made, so that the window's memory peak is
the program's alone, and, once the window is closed and the program freed,
compared with the plain reference's.
"""
from __future__ import annotations

import gc

import numpy as np

from lcbench.harness import judge, program
from lcbench.harness.runner import Outcome, log
from lcbench.reference import decode as ref_decode

KIND = "decode"


def run(ctx) -> Outcome:
    import torch

    from lcasr_torch.evaluation.streaming import StreamingDecoder

    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    frames, seq_len, overlap = tr["frames"], tr["seq_len"], tr["overlap"]
    n_classes = cfg["vocab_size"] + 1
    model, shapes = program.build(cfg, ctx.seed, dev, quant_w8a8=ctx.control)
    gen = torch.Generator(device=dev).manual_seed((ctx.seed * 7919 + 1) % (2 ** 63))
    pool_dev = torch.randn((tr["pool"], tr["n_mels"], frames), generator=gen, device=dev)
    pool = [pool_dev[i:i + 1].cpu().numpy() for i in range(tr["pool"])]
    del pool_dev
    decoder = StreamingDecoder(model, n_classes, window_batch_size=tr["window_batch"],
                               transfer_dtype=getattr(torch, tr["transfer_dtype"]), device=dev)

    bad = torch.zeros((), dtype=torch.bool, device=dev)

    def decode(spec):
        nonlocal bad
        probs = decoder._run(spec, seq_len, overlap)  # StreamingDecoder.greedy's work:
        ids = probs.argmax(-1).cpu().numpy()  # the average, its argmax, ids to the host
        bad = bad | ~torch.isfinite(probs).all()
        return probs, ids

    for i in range(tr["warmup"]):  # the window's every shape and every kernel
        decode(pool[i % len(pool)])
    bad.zero_()
    rng = np.random.default_rng(ctx.seed)
    judged = set(int(i) for i in rng.choice(tr["pool"], tr["judged"], replace=False))
    kept = {}
    done = decoded = failed = 0
    ctx.begin_window()
    while True:
        spec = pool[done % len(pool)]
        try:
            probs, ids = decode(spec)
        except RuntimeError as e:
            failed += 1
            log(f"recording {done} failed: {e}")
        else:
            decoded += 1
            if done in judged:
                kept[done] = (probs.cpu(), ids)
            del probs
        done += 1
        if ctx.elapsed() >= ctx.seconds:
            break
    seconds = ctx.end_window()
    nonfinite = bool(bad)
    audio_s = decoded * frames / tr["frames_per_second"]
    windows = ref_decode.windows(frames, seq_len, overlap)
    view = {"kind": KIND, "model_class": cfg["model_class"], "model": program.model_kwargs(cfg),
            "window_s": seconds, "recordings": decoded,
            "useful_flops": decoded * sum(judge.forward_flops(cfg, u) for _, u in windows)}
    del decoder, model
    gc.collect()
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    checks = judge.decode_checks(ctx, kept, pool, n_classes, shapes)
    if nonfinite:
        checks.append(("nonfinite_probabilities", 1.0, 0.0))
    return Outcome(
        attempted=done, failed=failed + int(nonfinite),
        e2e={"decode_rtfx": (audio_s / seconds, "audio_s/s"),
             "peak_mem_gib": (ctx.memory_peak_bytes / 2 ** 30, "GiB")},
        view=view, checks=checks)
