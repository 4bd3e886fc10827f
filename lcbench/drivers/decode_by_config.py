"""Traffic driver: `decode_stream`'s closed loop of long recordings through the
port's averaged moving-window decoder, for a configuration that names its own
plain reference and FLOP function in its file:

  "reference": <module of lcbench/reference/>   forward(p, cfg, audio, lengths,
                                                stats) and eval_stats(p, cfg)
  "flops": <name in harness/model_flops.FORWARD>
  "seeded_gains": {<leaf name suffix>: gain}    (optional) those weights drawn
                                                at `gain` times weights.py's rule
  "probe": {"op": "<module>:<function>",        (optional) the reading
            "reference": <function of the       `probe_rel_l2`, below
                          reference module>}

so that a further configuration needs no further driver.  Set-up, window,
`decode_rtfx`, `peak_mem_gib` and the judge's readings (`judge.decode_readings`
against the cell's `limits`) are `decode_stream`'s; the weights are
`harness/weights.py`'s, with the configuration's gains, except every BatchNorm
`running_var`, which weights.py has no rule for (its fan-in rule would draw
negative variances): those are drawn from U(0.5, 1.5) by a generator of their
own, seeded from the run's seed, for the program and the reference alike.

`probe_rel_l2`: for each judged recording, once the window is closed, the
program decodes it again and the output of the first call to the probed op
(the first layer's, on the first window group) is kept; the reference's
function gives the same from the same windows, and the reading is
||P - R|| / ||R||, the worst recording's.  It reads a mechanism whose effect
the output of a deep model with seeded weights no longer shows (PERF.md).

In the traced run the driver opens the range `lcbench.relpos_attn` around
each call to the relative-position attention op and logs the call's shape
and lengths into `ctx.calls["relpos_attn"]`, as `harness/spans.py` does for
the other ops.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import math

import numpy as np

from lcbench.harness import judge, program
from lcbench.harness import weights as W
from lcbench.harness.model_flops import forward_flops
from lcbench.harness.runner import Outcome, log
from lcbench.reference import decode as ref_decode

KIND = "decode_by_config"
VAR_LOW, VAR_HIGH = 0.5, 1.5  # BatchNorm running variances, U(low, high)


def batchnorm_variances(shapes, seed: int, device) -> dict:
    """{name: fp32 tensor} of every `running_var`, from the run's seed."""
    import torch

    names = [(n, s) for n, s in shapes if n.rsplit(".", 1)[-1] == "running_var"]
    gen = torch.Generator(device=device).manual_seed((int(seed) * 104729 + 7) % (2 ** 63))
    total = sum(math.prod(s) for _, s in names)
    draw = VAR_LOW + (VAR_HIGH - VAR_LOW) * torch.rand(max(total, 1), generator=gen,
                                                        device=device)
    out, i = {}, 0
    for n, s in names:
        k = math.prod(s)
        out[n] = draw[i:i + k].view(s)
        i += k
    return out


@contextlib.contextmanager
def relpos_spans(calls, on: bool):
    """While open and `on`: the range `lcbench.relpos_attn` around each call
    to the op, its shape and lengths logged into `calls`."""
    if not on:
        yield
        return
    import torch

    import lcasr_torch.ops.rel_pos_attention as op

    inner = op.rel_pos_attention

    def traced(q, k, v, pos, bias_u, bias_v, lengths=None):
        B, T, H, D = q.shape
        calls.add("relpos_attn", B=B, T=T, H=H, D=D, lengths=lengths,
                  elem_bytes=q.element_size())
        with torch.profiler.record_function("lcbench.relpos_attn"):
            return inner(q, k, v, pos, bias_u, bias_v, lengths)

    op.rel_pos_attention = traced
    try:
        yield
    finally:
        op.rel_pos_attention = inner


def run(ctx) -> Outcome:
    import torch

    from lcasr_torch.evaluation.streaming import StreamingDecoder

    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    frames, seq_len, overlap = tr["frames"], tr["seq_len"], tr["overlap"]
    n_classes = cfg["vocab_size"] + 1
    model, shapes = program.build(cfg, ctx.seed, dev, quant_w8a8=ctx.control)
    overrides = driver_weights(model, shapes, ctx.seed, dev, cfg.get("seeded_gains", {}))
    W.fill_(model, overrides)
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
    with relpos_spans(ctx.calls, ctx.trace):
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
    probed = {n: probe_output(cfg, lambda: decode(pool[n % len(pool)])) for n in kept
              } if "probe" in cfg else {}
    audio_s = decoded * frames / tr["frames_per_second"]
    mcfg = program.model_kwargs(cfg)
    windows = ref_decode.windows(frames, seq_len, overlap)
    view = {"kind": KIND, "model_class": cfg["model_class"], "model": mcfg,
            "window_s": seconds, "recordings": decoded,
            "useful_flops": decoded * sum(forward_flops(cfg["flops"], mcfg, u)
                                          for _, u in windows)}
    del decoder, model
    gc.collect()
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    checks = judged_checks(ctx, kept, probed, pool, n_classes, shapes, overrides)
    if nonfinite:
        checks.append(("nonfinite_probabilities", 1.0, 0.0))
    return Outcome(
        attempted=done, failed=failed + int(nonfinite),
        e2e={"decode_rtfx": (audio_s / seconds, "audio_s/s"),
             "peak_mem_gib": (ctx.memory_peak_bytes / 2 ** 30, "GiB")},
        view=view, checks=checks)


def driver_weights(model, shapes, seed: int, device, gains: dict) -> dict:
    """{name: tensor} that replace weights.py's draws in the program and the
    reference: the BatchNorm variances, and the weights whose names end in a
    key of `gains`, at that gain times their seeded value (the program's,
    which the reference draws alike)."""
    out = batchnorm_variances(shapes, seed, device)
    params = dict(model.named_parameters())
    for name, _ in shapes:
        for suffix, gain in gains.items():
            if name.endswith(suffix):
                out[name] = params[name].detach() * float(gain)
    return out


def probe_output(cfg, run):
    """The output of the first call to the configuration's probed op while
    `run()` runs, on the host in fp32."""
    module, _, name = cfg["probe"]["op"].partition(":")
    owner = importlib.import_module(module)
    inner, seen = getattr(owner, name), []

    def keep(*args, **kwargs):
        out = inner(*args, **kwargs)
        if not seen:
            seen.append(out.float().cpu())
        return out

    setattr(owner, name, keep)
    try:
        run()
    finally:
        setattr(owner, name, inner)
    return seen[0]


def judged_checks(ctx, kept, probed, pool, n_classes, shapes, overrides):
    """`judge.decode_checks` with the configuration's own reference module
    and the weights the program got (weights.py's and the overrides), and
    the probe's reading where the configuration has one."""
    import torch

    from lcbench.reference.decode import averaged_probs, windows
    from lcbench.reference.layers import fp32_products

    if not kept:
        return [("judged_recordings", 0.0, -1.0)]
    cfg, tr = ctx.config, ctx.traffic
    ref = importlib.import_module(f"lcbench.reference.{cfg['reference']}")
    p = judge.reference_weights(ctx, shapes)
    p.update(overrides)
    mcfg = program.model_kwargs(cfg)
    stats = ref.eval_stats(p, mcfg)
    worst = dict.fromkeys(judge.DECODE_READINGS + (("probe_rel_l2",) if probed else ()), 0.0)
    with fp32_products():
        for n, (probs, ids) in sorted(kept.items()):
            spec = torch.from_numpy(pool[n % len(pool)][0]).to(ctx.device)
            R = averaged_probs(lambda a, ln: ref.forward(p, mcfg, a, ln, stats=stats),
                               spec, tr["seq_len"], tr["overlap"], n_classes)
            if probs.shape != R.shape:
                return [("shape_mismatch", 1.0, 0.0)]
            for k, v in judge.decode_readings(probs.to(R.device).float(), R, ids).items():
                worst[k] = max(worst[k], v)
            del R
            if n in probed:  # the first window group, as the decoder forms it
                first = windows(spec.shape[-1], tr["seq_len"], tr["overlap"])[:tr["window_batch"]]
                batch = torch.zeros((len(first), spec.shape[0], tr["seq_len"]), device=ctx.device)
                for j, (i, u) in enumerate(first):
                    batch[j, :, :u] = spec[:, i:i + u]
                lengths = torch.tensor([u for _, u in first], device=ctx.device)
                with torch.no_grad():
                    want = getattr(ref, cfg["probe"]["reference"])(p, mcfg, batch, lengths)
                got = probed[n].to(want.device)
                if got.shape != want.shape:
                    return [("probe_shape_mismatch", 1.0, 0.0)]
                worst["probe_rel_l2"] = max(worst["probe_rel_l2"],
                                            float((got - want).norm() / want.norm()))
    log("decode readings, the worst judged recording's: " + ", ".join(
        f"{k} {v!r}" for k, v in worst.items()))
    return judge.compared(ctx, worst)
