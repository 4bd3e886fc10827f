#!/usr/bin/env python3
"""Drive the lcasr_torch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py                  # every phase, as a check of the port
    python3 chip_smoke.py --phases kernels # build + kernel checks only

Phases, in order; any failure raises and exits non-zero:

  1. build    compile every CUDA kernel from lcasr_torch/csrc (nvcc, sm_90a)
              and print the build time, ptxas's register/spill lines and the
              card's name and power limit;
  2. kernels  hold each kernel against its plain PyTorch version on the card
              at the decode's shape and on small edge cases, and time the
              kernel, the plain version and a library call doing the same
              work (the yardstick; the port never calls it);
  3. model    the flagship SCConformerXL (9L-768D-6H, bf16, random weights
              from a numpy seed) on one (16, 80, 16384) window batch: finite,
              normalised log-probs, compared with the same model whose
              attention runs the plain version;
  4. decode   the main path: StreamingDecoder.greedy over a 20-minute
              (120,000-frame) spectrogram, 16,384-frame windows, overlap
              14,336, 16 windows per forward.  The launch counts are zeroed
              just before the first decode and read just after it; then the
              median of 3 timed decodes gives the RTFx.

The line before the last two is one JSON object with each kernel's numbers;
the last line is the device record.  Without a GPU, or without the repo
beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

PHASES = ("kernels", "model", "decode")

# published dense peaks of one H100 SXM (NVIDIA data sheet) for the bound
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

SEQ_LEN, OVERLAP, WINDOW_BATCH = 16_384, 14_336, 16
TOTAL_FRAMES, FRAMES_PER_SECOND = 120_000, 100
EXPECTED_LAUNCHES = 36  # 9 layers x 4 window batches


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, n: int, warmup: int = 2) -> float:
    """Median of n CUDA-event timings of fn() after warmup calls."""
    import numpy as np

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phase 2: flash-attention forward against its plain version
# ---------------------------------------------------------------------------
def attention_cases(torch):
    """(name, B, T, H, D, dtype, lengths, window, q_offset, kv_offset, views)"""
    bf, f32 = torch.bfloat16, torch.float32
    decode_last = [2048, 2048, 2048, 1944] + [0] * 12  # last batch of the decode
    return [
        ("decode_shape_full", 16, 2048, 6, 128, bf, None, (-1, -1), 0, 0, True),
        ("decode_shape_last_batch", 16, 2048, 6, 128, bf, decode_last, (-1, -1), 0, 0, True),
        ("ragged_with_zero", 3, 200, 2, 128, bf, [200, 131, 0], (-1, -1), 0, 0, False),
        ("T_not_multiple_of_64", 2, 333, 3, 128, bf, [333, 100], (-1, -1), 0, 0, False),
        ("band_256_256", 2, 1000, 2, 128, bf, [1000, 700], (256, 256), 0, 0, False),
        ("band_left_only", 2, 300, 2, 128, bf, [300, 211], (64, -1), 0, 0, False),
        ("q_kv_offsets", 2, 300, 2, 128, bf, [320, 150], (-1, -1), 37, 20, False),
        ("offsets_band", 2, 300, 2, 128, bf, [300, 250], (40, 30), 37, 20, False),
        ("D64", 2, 260, 3, 64, bf, [260, 77], (-1, -1), 0, 0, True),
        ("D32", 2, 260, 3, 32, bf, [260, 0], (16, 16), 0, 0, False),
        ("fp32_D128", 2, 333, 2, 128, f32, [333, 120], (-1, -1), 0, 0, True),
        ("fp32_D64_band", 2, 300, 2, 64, f32, [300, 0], (32, 8), 5, 0, False),
        ("fp32_D32", 2, 130, 2, 32, f32, [130, 129], (-1, -1), 0, 0, False),
    ]


def make_qkv(torch, B, T, H, D, dtype, views, gen):
    if views:  # non-contiguous views, as the fused qkv projection gives them
        qkv = torch.randn((B, T, 3, H, D), generator=gen, device="cuda").to(dtype)
        return qkv.unbind(2)
    return tuple(torch.randn((B, T, H, D), generator=gen, device="cuda").to(dtype)
                 for _ in range(3))


def valid_pairs(lengths, B, T, window, q_off, kv_off) -> int:
    """(row, col) pairs this input's masks leave valid: the work it needs."""
    import numpy as np

    lens = np.full(B, T) if lengths is None else np.asarray(lengths)
    rows = q_off + np.arange(T)
    cols = kv_off + np.arange(T)
    total = 0
    for ln in lens:
        ok = (rows[:, None] < min(ln, q_off + T)) & (cols[None, :] < min(ln, kv_off + T))
        if window[1] >= 0:
            ok &= cols[None, :] <= rows[:, None] + window[1]
        if window[0] >= 0:
            ok &= cols[None, :] >= rows[:, None] - window[0]
        total += int(ok.sum())
    return total


def phase_kernels(torch):
    import torch.nn.functional as F

    from lcasr_torch.ops.flash_attention import flash_attention_ref, flash_attention_with_lse

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"o": 0.0, "lse": 0.0}
    for (name, B, T, H, D, dtype, lengths, window, qo, ko, views) in attention_cases(torch):
        q, k, v = make_qkv(torch, B, T, H, D, dtype, views, gen)
        lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device="cuda")
        o, lse = flash_attention_with_lse(q, k, v, lens, window, None, qo, ko)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash_attention_ref(q, k, v, lens, window, None, qo, ko)
        if dtype == torch.bfloat16:
            # the kernel rounds P to bf16 before P.V (as the Pallas kernel
            # does) and both round o to bf16: ~2^-8 relative on O(1) values
            tol_o, tol_lse = 2e-2, 2e-3  # lse: fp32 sums of exact bf16 products
        else:
            # fp32 on both sides, TF32 off: summation order only
            tol_o, tol_lse = 1e-4, 1e-4
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        bad_o = ((o.float() - o_ref.float()).abs() > tol_o + tol_o * o_ref.float().abs()).sum().item()
        log(f"  {name:26s} max|do| {err_o:.3e} (tol {tol_o:g} + {tol_o:g}|o|)  "
            f"max|dlse| {err_lse:.3e} (tol {tol_lse:g})")
        if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
            raise AssertionError(f"{name}: non-finite kernel output")
        if bad_o or err_lse > tol_lse:
            raise AssertionError(f"{name}: kernel disagrees with the plain version")
        if lengths is not None and 0 in lengths:
            zero = [i for i, ln in enumerate(lengths) if ln == 0]
            if not ((o[zero] == 0).all() and (lse[zero] == -1e30).all()):
                raise AssertionError(f"{name}: zero-length rows must give o=0, lse=-1e30")
        if dtype == torch.bfloat16:
            worst["o"] = max(worst["o"], err_o)
            worst["lse"] = max(worst["lse"], err_lse)
        del q, k, v, o, lse, o_ref, lse_ref

    # timing at the decode's shape, full lengths, where all three compute
    # the same function
    B, T, H, D = 16, 2048, 6, 128
    q, k, v = make_qkv(torch, B, T, H, D, torch.bfloat16, True, gen)
    kernel_ms = time_ms(torch, lambda: flash_attention_with_lse(q, k, v), n=30)
    plain_ms = time_ms(torch, lambda: flash_attention_ref(q, k, v), n=5, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), n=30)
    flops = 4 * H * D * valid_pairs(None, B, T, (-1, -1), 0, 0)
    nbytes = 2 * 4 * B * T * H * D + 4 * B * H * T + 4 * B
    t_ops = flops / PEAK_FLOPS["bf16"] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    log(f"  decode shape (16, 2048, 6, 128) bf16: kernel {kernel_ms:.4f} ms "
        f"({flops / kernel_ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
        f"scaled_dot_product_attention {library_ms:.4f} ms, "
        f"bound {max(t_ops, t_bytes):.4f} ms")
    return {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "lcasr_torch/csrc/flash_attn_fwd.cu",
        "replaces": "lcasr_tpu/ops/flash_attention.py:224",
        "replaces_fn": "lcasr_tpu/ops/flash_attention.py:_fwd_kernel",
        "launches": None,
        "max_abs_err": max(worst["o"], worst["lse"]),
        "max_err_o": worst["o"],
        "max_err_lse": worst["lse"],
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }


# ---------------------------------------------------------------------------
# phase 3: one full-width window batch, kernel against plain attention
# ---------------------------------------------------------------------------
def flagship_model(torch):
    from lcasr_torch.models.sconformer_xl import FLAGSHIP, SCConformerXL, init_weights_

    model = SCConformerXL(**FLAGSHIP, dtype=torch.bfloat16, device="cuda")
    return init_weights_(model, seed=0)


def phase_model(torch, model):
    import numpy as np
    from unittest import mock

    import lcasr_torch.models.sconformer_xl as sx
    from lcasr_torch.ops.flash_attention import flash_attention_ref

    rng = np.random.default_rng(1)
    audio = torch.from_numpy(rng.normal(size=(16, 80, SEQ_LEN)).astype(np.float32)).cuda()
    lengths = torch.tensor([SEQ_LEN] * 10 + [15_552, 12_000, 8_191, 4_096, 1_000, 0],
                           dtype=torch.int32, device="cuda")
    with torch.no_grad():
        out = model(audio, length=lengths)
        torch.cuda.synchronize()
        lp, out_len = out["final_posteriors"], out["length"]
        if tuple(lp.shape) != (16, 2048, 4096) or lp.dtype != torch.float32:
            raise AssertionError(f"final_posteriors {tuple(lp.shape)} {lp.dtype}")
        if not torch.isfinite(lp).all():
            raise AssertionError("non-finite log-probs")
        norm_err = (lp.exp().sum(-1) - 1).abs().max().item()
        if norm_err > 1e-3:  # fp32 log-softmax: sums to 1 within float error
            raise AssertionError(f"log-probs do not normalise: {norm_err}")

        def plain(q, k, v, lengths=None, window=(-1, -1)):
            return flash_attention_ref(q, k, v, lengths, window)[0]

        with mock.patch.object(sx, "flash_attention", plain):  # this script only
            lp_plain = model(audio, length=lengths)["final_posteriors"]
        fwd_ms = time_ms(torch, lambda: model(audio, length=lengths), n=3, warmup=1)
    valid = torch.arange(2048, device="cuda")[None, :] < out_len[:, None]
    diff = (lp - lp_plain).abs()[valid]
    agree = (lp.argmax(-1) == lp_plain.argmax(-1))[valid].float().mean().item()
    max_d, mean_d = diff.max().item(), diff.mean().item()
    log(f"  flagship forward (16, 80, 16384) bf16: {fwd_ms:.2f} ms; vs plain attention: "
        f"argmax agreement {agree:.5f}, max|dlogp| {max_d:.4f}, mean|dlogp| {mean_d:.2e}, "
        f"normalisation error {norm_err:.1e}")
    # both runs are bf16 end to end and differ only in where attention
    # rounds (P to bf16 in the kernel); 9 random layers amplify that into
    # small log-prob shifts and flip near-tied argmaxes among 4,096 classes
    if not (agree >= 0.9 and max_d <= 1.0 and mean_d <= 0.05):
        raise AssertionError("flagship model with the kernel disagrees with plain attention")
    return fwd_ms


# ---------------------------------------------------------------------------
# phase 4: the main path, a 20-minute streaming greedy decode
# ---------------------------------------------------------------------------
def phase_decode(torch, model):
    import numpy as np

    from lcasr_torch import kernels
    from lcasr_torch.decoding.greedy import GreedyCTCDecoder
    from lcasr_torch.evaluation.streaming import StreamingDecoder

    n_classes = 4096
    spec = np.random.default_rng(2).normal(size=(1, 80, TOTAL_FRAMES)).astype(np.float32)
    decoder = StreamingDecoder(model, n_classes, window_batch_size=WINDOW_BATCH,
                               transfer_dtype=torch.bfloat16, device="cuda")
    kernels.reset_launch_counts()
    ids = decoder.greedy(spec, seq_len=SEQ_LEN, overlap=OVERLAP)
    launches = dict(kernels.launch_counts)
    if launches["flash_attention_fwd"] != EXPECTED_LAUNCHES:
        raise AssertionError(f"flash_attention_fwd launched {launches} times, "
                             f"expected {EXPECTED_LAUNCHES}")
    if ids.ndim != 1 or ids.shape[0] < TOTAL_FRAMES // 8 - 8:
        raise AssertionError(f"decode gave {ids.shape} ids")
    if ids.min() < 0 or ids.max() >= n_classes:
        raise AssertionError("ids out of range")
    tokens = GreedyCTCDecoder(blank_id=n_classes - 1)(ids, decode=False)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = decoder.greedy(spec, seq_len=SEQ_LEN, overlap=OVERLAP)
        times.append(time.perf_counter() - t0)
    if not np.array_equal(again, ids):
        raise AssertionError("repeated decodes differ")
    audio_s = TOTAL_FRAMES / FRAMES_PER_SECOND
    rtfx = audio_s / float(np.median(times))
    log(f"  20-minute decode: {ids.shape[0]} frame ids, {len(tokens)} tokens after "
        f"collapse, launches {launches}, decode s {[round(t, 4) for t in times]}, "
        f"RTFx (median of 3) {rtfx:.1f}")
    profile_decode(torch, lambda: decoder.greedy(spec, seq_len=SEQ_LEN, overlap=OVERLAP))
    return launches, rtfx


def profile_decode(torch, run) -> None:
    """Device time by kernel over one decode (torch.profiler), and the
    device's idle share of the wall time.  The full table goes to
    build/decode_profile.txt beside this script."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []  # device-side events only: the kernels, not the ops launching them
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            rows.append((e.self_device_time_total, e.count, e.key))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "decode_profile.txt"), "w") as f:
        f.write(f"wall_us {wall_us:.1f} device_busy_us {busy_us:.1f}\n")
        for dev_us, count, key in rows:
            f.write(f"{dev_us:14.1f} {count:8d} {key}\n")
    if not rows:
        log("  profile: no device time recorded (device breakdown not measured)")
        return
    log(f"  profile of one decode (profiler on): wall {wall_us / 1e3:.2f} ms, device "
        f"busy {busy_us / 1e3:.2f} ms, idle share {1 - busy_us / wall_us:.3f}")
    for dev_us, count, key in rows[:15]:
        log(f"    {dev_us / 1e3:10.3f} ms {100 * dev_us / busy_us:5.1f}% x{count:<6d} {key[:100]}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES))
    args = parser.parse_args()
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lcasr_torch import kernels  # fails when the repo is not beside this file

    gpu = gpu_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    log("[1/4] build")
    build_s = kernels.build()
    log(f"  build {build_s:.2f} s into {kernels.BUILD_DIR}")
    for src, text in kernels.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  {src}: {line.strip()}")
    log(f"  gpu: {gpu}")

    results = {}
    if "kernels" in phases:
        log("[2/4] kernels against their plain versions")
        results["flash_attention_fwd"] = phase_kernels(torch)
    model = None
    if "model" in phases:
        log("[3/4] flagship model, one window batch")
        model = flagship_model(torch)
        phase_model(torch, model)
    if "decode" in phases:
        log("[4/4] 20-minute streaming greedy decode (the main path)")
        model = model or flagship_model(torch)
        launches, _ = phase_decode(torch, model)
        for name, n in launches.items():
            results.setdefault(name, {"name": name})["launches"] = n
    name, power = [s.strip() for s in gpu.split(",", 1)]
    for entry in results.values():
        entry.update(gpu=name, power_limit=power)
    print(json.dumps({"kernels": list(results.values())}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
