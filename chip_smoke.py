#!/usr/bin/env python3
"""Drive the lcasr_torch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py                  # every phase, as a check of the port
    python3 chip_smoke.py --phases kernels # build + kernel checks only
    python3 chip_smoke.py --phases train   # build + the training path only

Phases, in order; any failure raises and exits non-zero:

  1. build    compile every CUDA kernel from lcasr_torch/csrc (one nvcc per
              source, in parallel, sm_90a) and print the build time,
              ptxas's register/spill lines and the card's name and power
              limit;
  2. kernels  hold each kernel against its plain PyTorch version on the card
              at the main paths' shapes and on small edge cases: the forward
              K1 and the backward K3 (one pass) and K4 + K5 (split); time
              each against its bound, the plain version and a library call
              doing the same work (the yardstick; the port never calls it);
  3. model    the flagship SCConformerXL (9L-768D-6H, bf16, random weights
              from a numpy seed) on one (16, 80, 16384) window batch: finite,
              normalised log-probs, compared with the same model whose
              attention runs the plain version;
  4. decode   the serving path: StreamingDecoder.greedy over a 20-minute
              (120,000-frame) spectrogram, 16,384-frame windows, overlap
              14,336, 16 windows per forward.  The launch counts are zeroed
              just before the first decode and read just after it; then the
              median of 3 timed decodes gives the RTFx;
  5. train    the training path: the Trainer with the flagship ladder
              configuration (configs/ladder_9l_768d_6h.yaml, started at
              8192 x 8 and stopped at 16384 x 4) on 16 synthetic podcasts,
              launch counts zeroed just before and read just after; save /
              resume; one 16384 x 4 step with the kernels against plain
              attention (loss and whole gradient); a profile of that step;
              a banded 2-layer step (K4 + K5); one 120,000 x 1 step.

The line before the last two is one JSON object with each kernel's numbers;
the last line is the device record.  Without a GPU, or without the repo
beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

PHASES = ("kernels", "model", "decode", "train")

# configs/ladder_9l_768d_6h.yaml, written out: the machine with the card is
# not promised pyyaml (tests/test_torch_port_train.py holds the two equal)
LADDER_CONFIG = {
    "model_class": "SCConformerXL",
    "model": {
        "d_model": 768, "n_heads": 6, "head_dim": 128, "n_layers": 9,
        "subsampling_factor": 8, "subsampling_conv_channels": 256,
        "subsampling_act": "silu", "conv_kernel_size": 9, "use_rotary": True,
        "rotary_base_freq": 1500000.0, "rotary_interpolation_factor": 1.0,
        "self_conditioning": True, "default_norm": "layer_norm",
        "checkpoint_every_n_layers": 1, "remat_policy": "nothing",
        "remat_subsampling": True,
    },
    "data": {"path": "/tmp/lcasr_ladder/pairs.json"},
    "audio_chunking": {"size": 512, "overlap": 0},
    "training": {
        "batch_size": 16, "backprop_every": 1, "backwards_every": 1,
        "clip_value": 0.8, "max_epochs": 1, "random_seed": 1234,
        "dtype": "bfloat16", "ctc_segment_size": 256,
    },
    "sequence_scheduler": {
        "increase_every": 2, "stop_after": 1000000000, "start_after": 0,
        "max_sequence_length": 120000, "increase_by_multiplier": 2.0,
        "batch_size_multiplier": 0.5, "interpolate_rotary": False,
    },
    "optimizer": {"name": "madgrad", "args": {"lr": 3.0e-4}},
    "scheduler": {"warmup_steps": 20, "final_value": 3.0e-5},
    "checkpointing": {"dir": "/tmp/lcasr_ladder/checkpoints", "save_every_n_steps": 4},
    "wandb": {"use": False},
}
# what the smoke run changes: start the ladder at 8192 frames x batch 8 and
# stop at 16384 x 4 (data.path and checkpointing.dir are set at run time)
SMOKE_OVERRIDES = {
    "audio_chunking": {"size": 8192},
    "training": {"batch_size": 8},
    "sequence_scheduler": {"increase_every": 8, "start_after": 0,
                           "max_sequence_length": 16384},
    "checkpointing": {"save_every_n_steps": 10 ** 9},
}
DEVICE = "cuda"
N_PODCASTS, PODCAST_FRAMES = 16, 16_384
LONG_FRAMES = 120_000  # the paper's 20-minute bucket
# one 16384 x 4 step of the kernel model against the same step with plain
# fp32 attention: the loss within LOSS_REL_MAX; the gradient's relative L2
# error and its worst per-tensor cosine deficit (1 - cos) each within
# YARDSTICK_FACTOR times what plain attention in bf16 (the rounding alone)
# shows in the same run, and never past the absolute caps
LOSS_REL_MAX, YARDSTICK_FACTOR, GRAD_REL_L2_MAX, GRAD_COS_MIN = 0.01, 3.0, 0.1, 0.95

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
# phase 2b: flash-attention backward (K3, K4, K5) against its plain version
# ---------------------------------------------------------------------------
BWD_KERNELS = {  # launch-count name -> (kernel symbol, Pallas body it replaces)
    "flash_attention_bwd_fused": ("flash_bwd_kv_bf16<128, true>", 666, "_bwd_fused_kernel"),
    "flash_attention_bwd_dq": ("flash_bwd_q_bf16<128>", 484, "_bwd_dq_kernel"),
    "flash_attention_bwd_dkv": ("flash_bwd_kv_bf16<128, false>", 569, "_bwd_dkv_kernel"),
}
TRAIN_ATTN_SHAPE = (4, 2048, 6, 128)  # (B, T, H, D): a 16384-frame x 4 chunk


def run_bwd(torch, fused: bool, *args):
    """flash_attention_bwd through K3 (fused) or K4 + K5."""
    from lcasr_torch.ops.flash_attention import flash_attention_bwd

    old = os.environ.get("LCASR_FUSED_ATTN_BWD")
    os.environ["LCASR_FUSED_ATTN_BWD"] = "1" if fused else "0"
    try:
        return flash_attention_bwd(*args)
    finally:
        if old is None:
            del os.environ["LCASR_FUSED_ATTN_BWD"]
        else:
            os.environ["LCASR_FUSED_ATTN_BWD"] = old


def kernel_device_ms(torch, fn, names, n: int = 10):
    """Mean device time per launch of each kernel whose name starts with one
    of `names`, over n calls of fn (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for want in names:
            if want.replace(" ", "") in e.key.replace(" ", "") and e.count:
                out[want] = e.self_device_time_total / e.count / 1e3
    missing = [w for w in names if w not in out]
    if missing:
        raise AssertionError(f"profiler recorded no device time for {missing}")
    return out


def phase_kernels_bwd(torch):
    import numpy as np

    from lcasr_torch.ops.flash_attention import (
        flash_attention_bwd_ref, flash_attention_with_lse)

    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {name: 0.0 for name in BWD_KERNELS}
    for (name, B, T, H, D, dtype, lengths, window, qo, ko, views) in attention_cases(torch):
        q, k, v = make_qkv(torch, B, T, H, D, dtype, views, gen)
        lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device="cuda")
        o, lse = flash_attention_with_lse(q, k, v, lens, window, None, qo, ko)
        do = torch.randn((B, T, H, D), generator=gen, device="cuda").to(dtype)
        args = (q, k, v, o, lse, do, lens, window, None, qo, ko)
        want = flash_attention_bwd_ref(*args)
        banded = window[0] >= 0 and window[1] >= 0
        for fused in ((False,) if banded else (True, False)):
            got = run_bwd(torch, fused, *args)
            torch.cuda.synchronize()
            errs = []
            for g, w in zip(got, want):
                if not torch.isfinite(g).all():
                    raise AssertionError(f"{name}: non-finite gradient")
                scale = w.float().abs().max().item()
                err = (g.float() - w.float()).abs().max().item()
                # bf16: the kernels round p and ds to bf16 before their
                # products (as the Pallas kernels do) and dk, dv to bf16 on
                # the way out, ~2^-8 relative; fp32: summation order only
                # (and the order of dq's atomic adds)
                tol = (2e-2 if dtype == torch.bfloat16 else 1e-4) * max(scale, 1.0)
                if err > tol:
                    raise AssertionError(f"{name} fused={fused}: max|d| {err:.3e} > {tol:.3e}")
                errs.append(err)
            if lengths is not None and 0 in lengths:
                zero = [i for i, ln in enumerate(lengths) if ln == 0]
                if not all((g[zero] == 0).all() for g in got):
                    raise AssertionError(f"{name}: zero-length rows must get zero gradients")
            log(f"  {name:26s} {'K3' if fused else 'K4+K5'}: max|d dq| {errs[0]:.3e} "
                f"max|d dk| {errs[1]:.3e} max|d dv| {errs[2]:.3e}")
            if dtype == torch.bfloat16:
                keys = ["flash_attention_bwd_fused"] if fused else [
                    "flash_attention_bwd_dq", "flash_attention_bwd_dkv"]
                for key in keys:
                    worst[key] = max(worst[key], *(errs if fused else
                                     (errs[:1] if key.endswith("dq") else errs[1:])))
        del q, k, v, o, lse, do, want

    # timing at a training shape, full lengths, qkv views as the model gives
    B, T, H, D = TRAIN_ATTN_SHAPE
    q, k, v = make_qkv(torch, B, T, H, D, torch.bfloat16, True, gen)
    o, lse = flash_attention_with_lse(q, k, v)
    do = torch.randn((B, T, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    args = (q, k, v, o, lse, do, None, (-1, -1), None, 0, 0)
    dev = kernel_device_ms(torch, lambda: run_bwd(torch, True, *args),
                           [BWD_KERNELS["flash_attention_bwd_fused"][0]])
    dev.update(kernel_device_ms(torch, lambda: run_bwd(torch, False, *args),
                                [BWD_KERNELS["flash_attention_bwd_dq"][0],
                                 BWD_KERNELS["flash_attention_bwd_dkv"][0]]))
    fused_ms = time_ms(torch, lambda: run_bwd(torch, True, *args), n=20)
    split_ms = time_ms(torch, lambda: run_bwd(torch, False, *args), n=20)
    plain_ms = time_ms(torch, lambda: flash_attention_bwd_ref(*args), n=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    import torch.nn.functional as F

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt)

    def sdpa_fwd_bwd():
        torch.autograd.grad(F.scaled_dot_product_attention(qt, kt, vt), (qt, kt, vt), dot)

    library_ms = time_ms(torch, sdpa_fwd_bwd, n=20) - time_ms(torch, sdpa_fwd, n=20)
    pairs = valid_pairs(None, B, T, (-1, -1), 0, 0)
    elems = B * T * H * D
    stats = 2 * 4 * B * H * T  # lse and delta, fp32
    work = {  # (products of 2*pairs*D flops, bytes read once + written once)
        "flash_attention_bwd_fused": (5, 4 * 2 * elems + stats + 4 * elems + 2 * 2 * elems),
        "flash_attention_bwd_dq": (3, 4 * 2 * elems + stats + 4 * elems),
        "flash_attention_bwd_dkv": (4, 4 * 2 * elems + stats + 2 * 2 * elems),
    }
    out = {}
    for key, (symbol, line, body) in BWD_KERNELS.items():
        n_products, nbytes = work[key]
        flops = n_products * 2 * pairs * D * H
        t_ops = flops / PEAK_FLOPS["bf16"] * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        ms = dev[symbol]
        log(f"  {key} at (4, 2048, 6, 128) bf16: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), bound {max(t_ops, t_bytes):.4f} ms")
        out[key] = {
            "name": key, "route": "cuda",
            "source": "lcasr_torch/csrc/flash_attn_bwd.cu",
            "replaces": f"lcasr_tpu/ops/flash_attention.py:{line}",
            "replaces_fn": f"lcasr_tpu/ops/flash_attention.py:{body}",
            "launches": None, "max_abs_err": worst[key], "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        }
    log(f"  wrappers at (4, 2048, 6, 128): K3 path {fused_ms:.4f} ms, K4+K5 path "
        f"{split_ms:.4f} ms (delta, dq scale and casts included); plain {plain_ms:.4f} ms; "
        f"scaled_dot_product_attention backward (fwd+bwd - fwd) {library_ms:.4f} ms")
    for key in out:
        out[key]["wrapper_ms"] = fused_ms if key.endswith("fused") else split_ms
    return out


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
    profile_run(torch, lambda: decoder.greedy(spec, seq_len=SEQ_LEN, overlap=OVERLAP),
                "decode_profile.txt", "one decode")
    return launches, rtfx


def profile_run(torch, run, filename: str, what: str):
    """Device time by kernel over one run (torch.profiler), and the
    device's idle share of the wall time.  The full table goes to
    build/<filename> beside this script."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []  # device-side events only: the kernels, not the ops launching them
    for e in prof.key_averages():
        # user annotations (e.g. Optimizer.step#MADGRAD.step) span kernels
        # that are counted on their own: leave them out
        if (e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
                and not getattr(e, "is_user_annotation", False)
                and not e.key.startswith("Optimizer.")):
            rows.append((e.self_device_time_total, e.count, e.key))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, filename), "w") as f:
        f.write(f"wall_us {wall_us:.1f} device_busy_us {busy_us:.1f}\n")
        for dev_us, count, key in rows:
            f.write(f"{dev_us:14.1f} {count:8d} {key}\n")
    if not rows:
        log("  profile: no device time recorded (device breakdown not measured)")
        return
    log(f"  profile of {what} (profiler on): wall {wall_us / 1e3:.2f} ms, device "
        f"busy {busy_us / 1e3:.2f} ms, idle share {1 - busy_us / wall_us:.3f}")
    for dev_us, count, key in rows[:15]:
        log(f"    {dev_us / 1e3:10.3f} ms {100 * dev_us / busy_us:5.1f}% x{count:<6d} {key[:100]}")


# ---------------------------------------------------------------------------
# phase 5: the training path (ladder Trainer, CTC, MADGRAD, remat)
# ---------------------------------------------------------------------------
WORDS = ("the podcast has these words about music and long context speech "
         "recognition models trained on hours of audio every week").split()


def make_corpus(directory: str, durations, seed: int = 0) -> dict:
    """Spectrograms (.npy, (1, 80, T)) and word-aligned transcript JSON, in
    the format of tests/test_train_trajectory_parity.py::_make_corpus, with
    words spread over the whole recording."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pairs = {}
    for i, T in enumerate(durations):
        np.save(os.path.join(directory, f"r{i}.spec.npy"),
                rng.normal(size=(1, 80, T)).astype(np.float32))
        words, t = [], 0.15
        while t + 0.25 <= T / 100 - 0.7:
            words.append({"word": WORDS[int(rng.integers(len(WORDS)))],
                          "startTime": f"{t:.2f}s", "endTime": f"{t + 0.25:.2f}s"})
            t += 0.3
        with open(os.path.join(directory, f"r{i}.json"), "w") as f:
            json.dump({"results": [{"alternatives": [{"words": words}]}]}, f)
        pairs[f"r{i}"] = {"audio": os.path.join(directory, f"r{i}.spec.npy"),
                          "txt": os.path.join(directory, f"r{i}.json"), "duration": T / 100}
    return pairs


def merged(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def step_times(metrics_path: str) -> dict:
    """Per sequence length: (ms of each optimizer step, live frames), the
    time of a step being the gap since the log row before it."""
    rows = [json.loads(line) for line in open(metrics_path)]
    out = {}
    for prev, row in zip(rows, rows[1:]):
        if "loss" in row:
            out.setdefault(row["sequence_length"], []).append(
                ((row["ts"] - prev["ts"]) * 1e3, row["frames"]))
    return out


def flat_grads(model):
    return {n: p.grad.detach().float().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def plain_bf16_attention(q, k, v, lengths=None, window=(-1, -1)):
    """Plain attention in q's dtype: bf16 products with fp32 accumulation,
    fp32 softmax, p rounded to bf16; the yardstick of what bf16 rounding
    alone does to the training gradient."""
    import torch

    from lcasr_torch.ops.flash_attention import _scaled, _valid_pairs

    valid = _valid_pairs(q, k, lengths, window, 0, 0)[:, None]
    s = torch.einsum("bthd,bshd->bhts", _scaled(q, None), k).float()
    p = torch.softmax(s.masked_fill(~valid, float("-inf")), -1)
    p = torch.where(valid, p, torch.zeros_like(p)).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", p, v)


def phase_train(torch, workdir: str):
    import tempfile
    from unittest import mock

    import numpy as np

    import lcasr_torch.models.sconformer_xl as sx
    from lcasr_torch import kernels
    from lcasr_torch.config import Config
    from lcasr_torch.data.dataloading import VariableBatchSimpleDataloader, load_json
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.models.registry import load_model
    from lcasr_torch.models.sconformer_xl import init_weights_
    from lcasr_torch.ops.flash_attention import flash_attention_ref
    from lcasr_torch.training.trainer import Trainer, make_chunks

    tok = load_tokenizer()
    tmp = tempfile.mkdtemp(dir=workdir)
    pairs = make_corpus(tmp, [PODCAST_FRAMES] * N_PODCASTS)
    with open(os.path.join(tmp, "pairs.json"), "w") as f:
        json.dump(pairs, f)
    cfg_d = merged(LADDER_CONFIG, SMOKE_OVERRIDES)
    cfg_d = merged(cfg_d, {"data": {"path": os.path.join(tmp, "pairs.json")},
                           "checkpointing": {"dir": os.path.join(tmp, "ckpt")}})
    cfg = Config(cfg_d)

    def fresh_model(seed, config=cfg):
        return init_weights_(load_model(config, tok.vocab_size(), device=DEVICE), seed=seed)

    def loader(trainer, config=cfg):
        return VariableBatchSimpleDataloader(
            pairs=load_json(config["data"]["path"]), tokenizer=tok,
            batch_size=trainer.batch_size, chunk_size=config["audio_chunking"]["size"],
            chunk_overlap=0, random_seed=config["training"]["random_seed"])

    model = fresh_model(0)
    trainer = Trainer(cfg, model, tok, device=DEVICE)
    trainer.init_state()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train(loader(trainer))
    torch.cuda.synchronize()
    ladder_s = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    rows = [json.loads(line) for line in open(os.path.join(trainer.checkpoint_dir, "metrics.jsonl"))]
    losses = [(r["sequence_length"], r["batch_size"], r["loss"]) for r in rows if "loss" in r]
    log(f"  ladder run: {ladder_s:.2f} s, optimizer steps (seq, batch, loss/frame) {losses}")
    first = (cfg_d["audio_chunking"]["size"], cfg_d["training"]["batch_size"])
    ladder = [first, first, (2 * first[0], first[1] // 2), (2 * first[0], first[1] // 2)]
    if [(s, b) for s, b, _ in losses] != ladder:
        raise AssertionError(f"the ladder did not run the optimizer steps {ladder}")
    if not all(np.isfinite(x) for *_, x in losses):
        raise AssertionError("non-finite loss")
    moved = max((p.detach() - before[n]).abs().max().item() for n, p in model.named_parameters())
    if not moved > 0:
        raise AssertionError("the parameters did not move")
    micro = len(losses)  # one chunk per optimizer step here
    want = {"flash_attention_fwd": 18 * micro, "flash_attention_bwd_fused": 9 * micro,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}
    log(f"  launches over the ladder run ({micro} micro steps): {launches}; peak memory "
        f"{peak_gb:.2f} GB")
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")

    # save / resume into a fresh Trainer
    meta = json.load(open(os.path.join(trainer.checkpoint_dir, f"step_{N_PODCASTS}", "meta.json")))
    other = Trainer(cfg, fresh_model(1), tok, device=DEVICE)
    step, epoch, seen = other.resume()
    same = all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                  other.model.state_dict().values()))
    log(f"  resume: step {step}, epoch {epoch}, {len(seen)} seen ids, state equal {same}")
    if not (same and step == meta["podcast_step"] == N_PODCASTS and epoch == meta["epoch"] == 1
            and seen == meta["seen_ids"] and len(seen) == N_PODCASTS
            and other.chunk_size == trainer.chunk_size == PODCAST_FRAMES):
        raise AssertionError("save / resume round trip failed")
    del other

    # per bucket: step wall ms and audio seconds per second
    for seq, items in step_times(os.path.join(trainer.checkpoint_dir, "metrics.jsonl")).items():
        ms = [m for m, _ in items]
        frames = items[-1][1]
        med = float(np.median(ms[1:] if len(ms) > 1 else ms))  # the first step warms up
        log(f"  bucket {seq} frames: step ms {[round(m, 2) for m in ms]}, steady {med:.2f} ms, "
            f"{frames} live frames per step, {frames * 0.01 / (med / 1e3):.1f} audio-s/s")

    # one 16384 x 4 micro step, kernels against plain attention, same weights
    batch = next(iter(VariableBatchSimpleDataloader(pairs, tok, batch_size=4, chunk_size=PODCAST_FRAMES,
                                                    chunk_overlap=0)))
    chunk = make_chunks(*batch[:3], tok, PODCAST_FRAMES, 0, tok.pad_id())[0]
    stats = [b.clone() for b in trainer._stat_buffers()]

    def one_step():
        trainer.zero_pending()
        loss, _ = trainer.micro_step(chunk)
        for b, old in zip(trainer._stat_buffers(), stats):
            b.copy_(old)
        return float(loss), flat_grads(model)

    loss_k, g_k = one_step()

    def plain(q, k, v, lengths=None, window=(-1, -1)):
        return flash_attention_ref(q, k, v, lengths, window)[0]

    with mock.patch.object(sx, "flash_attention", plain):  # this script only
        loss_p, g_p = one_step()
    with mock.patch.object(sx, "flash_attention", plain_bf16_attention):
        loss_b, g_b = one_step()
    den = sum((g_p[n] ** 2).sum().item() for n in g_p)
    # the worst cosine over tensors whose gradient is not ~0 by construction
    # (a bias before BatchRenorm gets only rounding noise: the batch mean
    # takes it out again)
    names = [n for n in g_p if g_p[n].norm().item() > 1e-4 * den ** 0.5]

    def against_plain(g, loss):
        """(loss rel. error, gradient rel. L2 error, worst cosine, its tensor)."""
        num = sum(((g[n] - g_p[n]) ** 2).sum().item() for n in g_p)
        cos = {n: torch.nn.functional.cosine_similarity(g[n].flatten(), g_p[n].flatten(), dim=0).item()
               for n in names}
        worst = min(cos, key=cos.get)
        return abs(loss - loss_p) / abs(loss_p), (num / den) ** 0.5, cos[worst], worst

    kl, kr, kc, kn = against_plain(g_k, loss_k)
    bl, br, bc, bn = against_plain(g_b, loss_b)
    # the step is not reproducible (dq's atomics, the library's backward
    # kernels): the same step again, for scale
    g_k2 = one_step()[1]
    rerun = (sum(((g_k2[n] - g_k[n]) ** 2).sum().item() for n in g_p) / den) ** 0.5
    verdict = (f"16384x4 step against plain fp32 attention (loss {loss_p:.4f}; cosines over {len(names)} "
               f"of {len(g_p)} tensors above 1e-4 of the global gradient norm): kernels: loss rel "
               f"{kl:.2e}, gradient rel L2 {kr:.3e} (a rerun of the kernel step differs by "
               f"{rerun:.3e}), worst cosine {kc:.5f} ({kn}); plain bf16 "
               f"attention (the yardstick): loss rel {bl:.2e}, gradient rel L2 {br:.3e}, worst cosine "
               f"{bc:.5f} ({bn}); gates: loss rel <= {LOSS_REL_MAX:g}, rel L2 <= "
               f"min({GRAD_REL_L2_MAX:g}, {YARDSTICK_FACTOR:g} x yardstick), 1 - cos <= "
               f"min({1 - GRAD_COS_MIN:g}, {YARDSTICK_FACTOR:g} x yardstick)")
    log("  " + verdict)
    if not (kl <= LOSS_REL_MAX and kr <= min(GRAD_REL_L2_MAX, YARDSTICK_FACTOR * br)
            and 1 - kc <= min(1 - GRAD_COS_MIN, YARDSTICK_FACTOR * (1 - bc))):
        raise AssertionError("training step with the kernels disagrees with plain attention: " + verdict)
    del g_k, g_k2, g_p, g_b  # kept, they would count in the 120000-frame step's peak
    trainer.zero_pending()

    # the profile of one 16384 x 4 training step (micro step + optimizer step)
    def train_step():
        trainer.micro_step(chunk)
        trainer.fold_group(100.0 / (PODCAST_FRAMES * 4))
        trainer.optimizer_step(3e-4)

    train_step()  # warm
    synced = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step()
        torch.cuda.synchronize()
        synced.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    make_chunks(*batch[:3], tok, PODCAST_FRAMES, 0, tok.pad_id())
    chunk_ms = (time.perf_counter() - t0) * 1e3
    log(f"  16384x4 step without data loading, synchronised: {[round(x, 2) for x in synced]} ms; "
        f"make_chunks on the host (transcripts, BPE): {chunk_ms:.2f} ms")
    profile_run(torch, train_step, "train_profile.txt", "one 16384x4 training step")

    # the banded path: 2 full-width layers with a window, one step, K4 + K5
    band_cfg = Config(merged(cfg_d, {"model": {"n_layers": 2, "attention_window_size": 256}}))
    band = Trainer(band_cfg, fresh_model(2, band_cfg), tok, device=DEVICE,
                   checkpoint_dir=os.path.join(tmp, "ckpt_band"))
    band.init_state()
    kernels.reset_launch_counts()
    loss, _ = band.micro_step(chunk)
    band.fold_group(1.0)
    band.optimizer_step(3e-4)
    torch.cuda.synchronize()
    band_launches = dict(kernels.launch_counts)
    log(f"  banded 2-layer step (window 256): loss {float(loss):.4f}, launches {band_launches}")
    if not (np.isfinite(float(loss)) and band_launches["flash_attention_bwd_dq"] == 2
            and band_launches["flash_attention_bwd_dkv"] == 2
            and band_launches["flash_attention_bwd_fused"] == 0):
        raise AssertionError("the banded step did not run K4 + K5 once per layer")
    del band

    # one optimizer step of the 20-minute bucket: 120,000 frames x 1
    long_dir = tempfile.mkdtemp(dir=workdir)
    long_pairs = make_corpus(long_dir, [LONG_FRAMES], seed=3)
    with open(os.path.join(long_dir, "pairs.json"), "w") as f:
        json.dump(long_pairs, f)
    long_cfg = Config(merged({k: v for k, v in cfg_d.items() if k != "sequence_scheduler"}, {
        "audio_chunking": {"size": LONG_FRAMES}, "training": {"batch_size": 1},
        "data": {"path": os.path.join(long_dir, "pairs.json")},
        "checkpointing": {"dir": os.path.join(long_dir, "ckpt")}}))
    long_tr = Trainer(long_cfg, model, tok, device=DEVICE)
    long_tr.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    long_tr.train(loader(long_tr, long_cfg))
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    long_launches = dict(kernels.launch_counts)
    long_rows = [json.loads(line) for line in
                 open(os.path.join(long_tr.checkpoint_dir, "metrics.jsonl"))]
    long_loss = [r["loss"] for r in long_rows if "loss" in r]
    long_ms = step_times(os.path.join(long_tr.checkpoint_dir, "metrics.jsonl"))[LONG_FRAMES][0][0]
    long_peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  120000x1 step: loss {long_loss}, step {long_ms:.2f} ms "
        f"({LONG_FRAMES * 0.01 / (long_ms / 1e3):.1f} audio-s/s), run {long_s:.2f} s, peak memory "
        f"{long_peak:.2f} GB, launches {long_launches}")
    if not (len(long_loss) == 1 and np.isfinite(long_loss[0])
            and long_launches["flash_attention_bwd_fused"] == 9):
        raise AssertionError("the 120000-frame step failed")
    return launches, band_launches


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
    log("[1/5] build")
    build_s = kernels.build()
    log(f"  build {build_s:.2f} s into {kernels.BUILD_DIR}")
    for src, text in kernels.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  {src}: {line.strip()}")
    log(f"  gpu: {gpu}")

    results = {}
    if "kernels" in phases:
        log("[2/5] kernels against their plain versions")
        results["flash_attention_fwd"] = phase_kernels(torch)
        results.update(phase_kernels_bwd(torch))
    model = None
    if "model" in phases:
        log("[3/5] flagship model, one window batch")
        model = flagship_model(torch)
        phase_model(torch, model)
    if "decode" in phases:
        log("[4/5] 20-minute streaming greedy decode (the serving path)")
        model = model or flagship_model(torch)
        launches, _ = phase_decode(torch, model)
        results.setdefault("flash_attention_fwd", {"name": "flash_attention_fwd"})[
            "launches"] = launches["flash_attention_fwd"]
    del model
    if "train" in phases:
        log("[5/5] training: the ladder Trainer, 8192x8 -> 16384x4, then 120000x1 "
            "(the training path)")
        workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke_train")
        os.makedirs(workdir, exist_ok=True)
        try:
            ladder, banded = phase_train(torch, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        # K3 runs on the flagship's (non-banded) path: its count is the
        # ladder run's; K4 and K5 run on the banded path: theirs is the
        # banded step's (the ladder run launches them 0 times, as it must)
        for key in BWD_KERNELS:
            entry = results.setdefault(key, {"name": key})
            entry["launches"] = ladder[key] if key.endswith("fused") else banded[key]
            entry["launches_ladder"] = ladder[key]
        results.setdefault("flash_attention_fwd", {"name": "flash_attention_fwd"})[
            "launches_ladder"] = ladder["flash_attention_fwd"]
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
