#!/usr/bin/env python3
"""Drive the lcasr_torch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py                  # every phase, as a check of the port
    python3 chip_smoke.py --phases kernels # build + kernel checks only
    python3 chip_smoke.py --phases train   # build + the training path only
    python3 chip_smoke.py --phases mamba_decode,mamba_train  # the Mamba family only
    python3 chip_smoke.py --phases decode_opt,train_opt  # the opt-in configuration only

Phases, in order; any failure raises and exits non-zero:

  1. build    compile every CUDA kernel from lcasr_torch/csrc (one nvcc per
              source, in parallel, sm_90a) and print the build time,
              ptxas's register/spill lines and the card's name and power
              limit;
  2. kernels  hold each kernel against its plain PyTorch version on the card
              at the main paths' shapes and on small edge cases: the
              attention forward K1, its double-buffered variant K2, the
              backward K3 (one pass) and K4 + K5 (split), the selective scan
              K6 and its backward K7, the fused 8x subsampling K8; time each
              against its bound, the plain version and, where there is one, a
              library call doing the same work (the yardstick; the port never
              calls it).  K1 and K2 are timed by their device work (launches
              of the wrapper's launch function back to back between two events) and by
              whole wrapper calls; K3, K4 and K5 by the profiler, in turns
              with cuDNN's backward, and K4 + K5 also under a (256, 256)
              band; dk and dv must be the same bits in two runs, K4's dq too,
              and K5's those of K3; K7's five gradients the same bits in two
              runs; the build fails on serialised wgmma or spills in the bf16
              entries of K1-K5;
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
              a banded 2-layer step (K4 + K5); one 120,000 x 1 step;
  6. mamba_decode  the full-width bidirectional Mamba (6 layers, d_model 768,
              bf16, random weights from a seed): one window batch with the
              kernel against the plain scan, then the same 20-minute
              streaming decode as phase 4 (6 layers x 4 window batches = 24
              K6 launches), RTFx as the median of 3;
  7. mamba_train  the Trainer with model_class Mamba on the same ladder and
              corpus as phase 5: launch counts (K6 twice per layer and micro
              step under full remat, K7 once), save / resume, one 16384 x 4
              step with the kernels against the plain scan (loss and whole
              gradient), a profile of that step, one 120,000 x 1 step;
  8. decode_opt  the flagship's opt-in decode configuration
              (LCASR_ATTN_FWD_DB=1, LCASR_FUSED_SUB=1; both set and restored
              inside the phase): the 20-minute decode through K2 and K8 (36
              and 4 launches, K1 none), one window batch with the flags
              against without, RTFx with and without; then, flags off, the
              decoder's options: int8 and int4 upload, pipeline_upload,
              cache_upload; then the Mamba's decode with LCASR_FUSED_SUB=1
              (24 K6 and 4 K8 launches);
  9. train_opt  one 16384 x 4 flagship training step under both flags (K2,
              K3 on K2's lse, K8 and its recomputing backward), and under
              each flag alone, against the same step without them (loss and
              whole gradient): K2 alone within a rerun's difference, the
              steps with K8 within that of two other computations of the
              conv chain.

The line before the last two is one JSON object with each kernel's numbers;
the last line is the device record.  Without a GPU, or without the repo
beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

PHASES = ("kernels", "model", "decode", "train", "mamba_decode", "mamba_train",
          "decode_opt", "train_opt")

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
# the bidirectional-Mamba family at the class defaults of its model (6 layers,
# d_model 768: d_inner 1536, dt_rank 48, d_state 16), every block recomputed
# in the backward; the rest is the ladder configuration
MAMBA_CONFIG = dict(LADDER_CONFIG, model_class="Mamba", model={
    "n_layers": 6, "d_model": 768, "subsampling": "dw_striding", "subsampling_factor": 8,
    "subsampling_conv_channels": 256, "subsampling_act": "silu", "self_conditioning": True,
    "checkpoint_every_n_layers": 1,
})
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
MAMBA_EXPECTED_DECODE_LAUNCHES = 24  # 6 layers x 4 window batches
# special-function units: one exp per clock on each of 16 units per SM
SFU_PER_CLOCK_PER_SM = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


OPT_FLAGS = {"LCASR_ATTN_FWD_DB": "1", "LCASR_FUSED_SUB": "1"}


@contextlib.contextmanager
def env_flags(**flags):
    """Set environment flags (None: unset) and restore them on the way out."""
    old = {k: os.environ.get(k) for k in flags}
    try:
        for k, v in flags.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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


def device_ms(torch, fn, n: int = 50, warmup: int = 3) -> float:
    """Device time per call of fn: n calls back to back between two CUDA
    events, no synchronisation inside, divided by n.  fn must enqueue device
    work only (inputs and outputs made once, outside), so the window holds
    the kernels' own time and not the host's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def device_kernel_totals(torch, fn, n: int = 10) -> dict:
    """{kernel name: (device microseconds, launches)} over n calls of fn
    (torch.profiler), after one warm call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}


# the bf16 kernels on TMA, wgmma and warp specialisation, as ptxas and the
# profiler name their templates: the forward K1 / K2
# (csrc/flash_fwd_hopper.cuh), the backward K3 / K5 and K4
# (csrc/flash_attn_bwd.cu)
HOPPER_FWD_SYMBOL = "flash_fwd_hopper"
HOPPER_BWD_SYMBOL = "flash_bwd_hopper"
HOPPER_DQ_SYMBOL = "flash_bwd_dq_hopper"
HOPPER_SOURCES = {"flash_attn_fwd.cu": (HOPPER_FWD_SYMBOL,),
                  "flash_attn_fwd_db.cu": (HOPPER_FWD_SYMBOL,),
                  "flash_attn_bwd.cu": (HOPPER_BWD_SYMBOL, HOPPER_DQ_SYMBOL)}


def ptxas_entries(text: str) -> dict:
    """{function: {"registers": n, "spill_stores": b, "spill_loads": b}} from
    nvcc's -Xptxas=-v output."""
    import re

    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, {})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[fn].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
    return out


def template_entries(text: str) -> dict:
    """{"name<D>" or "name<D, true|false>": ptxas entry} of the template
    kernels in one source's nvcc output (their mangled names demangled)."""
    import re

    out = {}
    for fn, e in ptxas_entries(text).items():
        m = re.search(r"\d(flash_\w+?)ILi(\d+)E(?:Lb([01])E)?E", fn)
        if m:
            flag = "" if m.group(3) is None else (", true" if m.group(3) == "1" else ", false")
            out[f"{m.group(1)}<{m.group(2)}{flag}>"] = e
    return out


def check_hopper_build(build_log: dict) -> dict:
    """Fail if ptxas serialised the wgmma of K1-K5, ignored their setmaxnreg,
    or spilled in their bf16 (Hopper) entries; returns those entries'
    registers and spills."""
    import re

    report = {}
    for src, symbols in HOPPER_SOURCES.items():
        text = build_log.get(src, "")
        if text == "(cached)":
            raise AssertionError(f"{src}: built before this run; its ptxas report is not here")
        for bad in ("wgmma.mma_async instructions are serialized", "setmaxnreg ignored"):
            if bad in text:
                lines = [ln.strip() for ln in text.splitlines() if bad in ln]
                raise AssertionError(f"{src}: ptxas reports '{bad}': {lines[:3]}")
        entries = {fn: e for fn, e in ptxas_entries(text).items()
                   if any(re.search(rf"\d{sym}I", fn) for sym in symbols)}
        for sym in symbols:
            if not any(re.search(rf"\d{sym}I", fn) for fn in entries):
                raise AssertionError(f"{src}: no {sym} entry in ptxas's report")
        for fn, e in entries.items():
            if e.get("spill_stores", 0) or e.get("spill_loads", 0):
                raise AssertionError(f"{src}: {fn} spills: {e}")
        report[src] = entries
    return report


def fwd_entry(torch, q, k, v, db: bool = False):
    """A launch of K1 (db: K2) through the wrapper's own launch function on
    inputs prepared once: q scaled, full lengths and the outputs made
    outside, so that a timing window holds the launches and nothing else of
    the wrapper.  Not counted: these are the comparison's launches, not the
    main path's."""
    from lcasr_torch.ops import flash_attention as fa

    B, Tq, H, D = q.shape
    qs = fa._scaled(q, None)
    lens = fa._lengths(None, B, k.shape[1], q.device).contiguous()
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    return lambda: fa._launch_fwd(qs, k, v, o, lse, lens, (-1, -1), 0, 0, db)


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
        # the edges of the bf16 kernels' 128 x 128 tiles
        ("T127", 2, 127, 2, 128, bf, [127, 100], (-1, -1), 0, 0, False),
        ("T129", 2, 129, 2, 128, bf, [129, 128], (-1, -1), 0, 0, False),
        ("T255", 2, 255, 2, 128, bf, [255, 129], (-1, -1), 0, 0, True),
        ("T257", 2, 257, 2, 128, bf, [257, 256], (-1, -1), 0, 0, True),
        ("T2049", 2, 2049, 2, 128, bf, [2049, 1025], (-1, -1), 0, 0, True),
        # rows 256.. visit tiles from local key 128 on: the first tile starts
        # exactly on a tile edge
        ("left_window_on_tile_edge", 2, 512, 2, 128, bf, [512, 400], (128, -1), 0, 0, False),
        ("shard_offsets_128", 2, 300, 2, 128, bf, [428, 350], (64, -1), 128, 128, False),
        ("decode_last_batch_D64", 16, 2048, 6, 64, bf, decode_last, (-1, -1), 0, 0, True),
        ("decode_last_batch_D32", 16, 2048, 6, 32, bf, decode_last, (-1, -1), 0, 0, True),
        # a 16384 x 4 training micro step's shape, with ragged lengths
        ("train_ragged", 4, 2048, 6, 128, bf, [2048, 1901, 1500, 777], (-1, -1), 0, 0, True),
        # the edges of the bf16 backward's tiles: 128 keys per CTA, a walk
        # over 64-row q tiles
        ("T63", 2, 63, 2, 128, bf, [63, 40], (-1, -1), 0, 0, False),
        ("T65", 2, 65, 2, 128, bf, [65, 64], (-1, -1), 0, 0, False),
        ("T191", 2, 191, 2, 128, bf, [191, 129], (-1, -1), 0, 0, True),
        # band edges that cut 64-row q tiles: the two-sided band runs K4 + K5,
        # the right-only band K3 too
        ("band_edge_in_q_tile", 2, 320, 2, 128, bf, [320, 300], (40, 24), 0, 0, False),
        ("band_right_edge_in_q_tile", 2, 320, 2, 128, bf, [320, 250], (-1, 24), 0, 0, False),
        # rows 128.. begin their window at key 64.., a 64-row edge
        ("left_window_on_q_tile_edge", 2, 384, 2, 128, bf, [384, 300], (64, -1), 0, 0, False),
        ("shard_offsets_64", 2, 300, 2, 128, bf, [364, 280], (-1, -1), 64, 64, False),
        ("D64_T65_band", 2, 65, 2, 64, bf, [65, 33], (16, 16), 0, 0, False),
        ("D32_T191_shard", 2, 191, 3, 32, bf, [255, 100], (-1, 40), 64, 64, True),
        # the edges of K4's tiles: 128 q rows per CTA, a walk over 64-key
        # tiles (T 127, 129, 255 above; both routes take these)
        ("T383", 2, 383, 2, 128, bf, [383, 257], (-1, -1), 0, 0, True),
        # a two-sided band whose edges cut 128-row q tiles and 64-key tiles
        ("band_edge_in_128_tile", 2, 400, 2, 128, bf, [400, 333], (100, 72), 0, 0, False),
        ("shard_offsets_128_band", 2, 300, 2, 128, bf, [428, 350], (96, 40), 128, 128, False),
        ("D64_band_T300", 2, 300, 2, 64, bf, [300, 190], (130, 70), 0, 0, True),
        ("D32_band_T300", 2, 300, 3, 32, bf, [300, 0], (70, 130), 0, 0, False),
    ]


def check_layout_refused(torch, kernel: str):
    """A bf16 view whose H stride is odd (not a multiple of 16 bytes) cannot
    be read by a TMA tensor map: the wrapper must raise and launch nothing."""
    from lcasr_torch import kernels
    from lcasr_torch.ops.flash_attention import flash_attention_with_lse

    x = torch.randn((2, 64, 2, 129), device="cuda").to(torch.bfloat16)[..., :128]
    kernels.reset_launch_counts()
    try:
        flash_attention_with_lse(x, x, x)
    except ValueError as e:
        if any(kernels.launch_counts.values()):
            raise AssertionError(f"a refused layout launched {kernels.launch_counts}")
        log(f"  odd H stride {x.stride()} refused by the wrapper ({kernel} route): {e}")
        return
    raise AssertionError(f"{kernel}: a view with H stride {x.stride(2)} was not refused")


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


def require_k2_equals_k1(torch, case, gen):
    """K2 repeats K1's arithmetic in the same order (the products of one tile
    are issued earlier, not changed): on the same inputs its o and lse must
    be bit-equal to K1's."""
    from lcasr_torch import kernels
    from lcasr_torch.ops.flash_attention import flash_attention_with_lse

    (name, B, T, H, D, dtype, lengths, window, qo, ko, views) = case
    q, k, v = make_qkv(torch, B, T, H, D, dtype, views, gen)
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device="cuda")
    kernels.reset_launch_counts()
    o1, lse1 = flash_attention_with_lse(q, k, v, lens, window, None, qo, ko)
    with env_flags(LCASR_ATTN_FWD_DB="1"):
        o2, lse2 = flash_attention_with_lse(q, k, v, lens, window, None, qo, ko)
    launched = {k_: n for k_, n in kernels.launch_counts.items() if n}
    if launched != {"flash_attention_fwd": 1, "flash_attention_fwd_db": 1}:
        raise AssertionError(f"{name}: launched {launched}, expected one K1 and one K2")
    if not (torch.equal(o1, o2) and torch.equal(lse1, lse2)):
        raise AssertionError(
            f"{name}: K2 differs from K1: max|do| "
            f"{(o1.float() - o2.float()).abs().max().item():.3e}, max|dlse| "
            f"{(lse1 - lse2).abs().max().item():.3e}")


def check_attention_case(torch, case, gen, kernel: str):
    """One case of the forward through the wrapper, which must launch `kernel`
    once and nothing else, against `flash_attention_ref`.  Returns (max |do|,
    max |dlse|, the output)."""
    from lcasr_torch import kernels
    from lcasr_torch.ops.flash_attention import flash_attention_ref, flash_attention_with_lse

    (name, B, T, H, D, dtype, lengths, window, qo, ko, views) = case
    q, k, v = make_qkv(torch, B, T, H, D, dtype, views, gen)
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device="cuda")
    kernels.reset_launch_counts()
    o, lse = flash_attention_with_lse(q, k, v, lens, window, None, qo, ko)
    torch.cuda.synchronize()
    launched = {k_: n for k_, n in kernels.launch_counts.items() if n}
    if launched != {kernel: 1}:
        raise AssertionError(f"{name}: launched {launched}, expected one {kernel}")
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
    return err_o, err_lse, o


def attention_bound(B, T, H, D):
    """(bound ms, bound_by, flops) of one full-length bf16 forward: 4 T^2 D
    operations per (b, h) at the bf16 peak against q, k, v, o, lse and the
    lengths at the memory rate."""
    flops = 4 * H * D * valid_pairs(None, B, T, (-1, -1), 0, 0)
    nbytes = 2 * 4 * B * T * H * D + 4 * B * H * T + 4 * B
    t_ops = flops / PEAK_FLOPS["bf16"] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


def phase_kernels(torch):
    import torch.nn.functional as F

    from lcasr_torch.ops.flash_attention import flash_attention_ref, flash_attention_with_lse

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"o": 0.0, "lse": 0.0}
    for case in attention_cases(torch):
        err_o, err_lse, _ = check_attention_case(torch, case, gen, "flash_attention_fwd")
        if case[5] == torch.bfloat16:
            worst["o"] = max(worst["o"], err_o)
            worst["lse"] = max(worst["lse"], err_lse)

    check_layout_refused(torch, "flash_attention_fwd")

    # timing at the decode's shape, full lengths, where all three compute
    # the same function: the kernels' own device time (launches back to
    # back), then the time of a whole wrapper call
    B, T, H, D = 16, 2048, 6, 128
    q, k, v = make_qkv(torch, B, T, H, D, torch.bfloat16, True, gen)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    k1 = fwd_entry(torch, q, k, v)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)
    kernel_ms, library_ms = device_ms(torch, k1), device_ms(torch, sdpa)
    wrapper_ms = time_ms(torch, lambda: flash_attention_with_lse(q, k, v), n=30)
    library_call_ms = time_ms(torch, sdpa, n=30)
    plain_ms = time_ms(torch, lambda: flash_attention_ref(q, k, v), n=5, warmup=1)
    bound_ms, bound_by, flops = attention_bound(B, T, H, D)
    log(f"  decode shape (16, 2048, 6, 128) bf16: kernel {kernel_ms:.4f} ms of device time "
        f"({flops / kernel_ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / kernel_ms:.1f}% of its bound), "
        f"scaled_dot_product_attention {library_ms:.4f} ms; one call each: wrapper "
        f"{wrapper_ms:.4f} ms, library {library_call_ms:.4f} ms; plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms")
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
        "wrapper_ms": wrapper_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "library_call_ms": library_call_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
    }


# ---------------------------------------------------------------------------
# phase 2a': the double-buffered forward (K2) against the same plain version
# ---------------------------------------------------------------------------
def phase_kernels_db(torch):
    """K2 under LCASR_ATTN_FWD_DB=1 on every attention case that is not banded
    on both sides (a two-sided band is K1's route under the flag too), on the
    two offset cases of tests/test_flash_attention.py (a kv shard wholly
    behind a one-sided window must give exactly 0); bit-equal to K1 on every
    bf16 case it takes and at the decode shape; then its time beside K1's and
    the library's."""
    import torch.nn.functional as F

    from lcasr_torch.ops.flash_attention import flash_attention_ref, flash_attention_with_lse

    bf, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [c for c in attention_cases(torch) if not (c[7][0] >= 0 and c[7][1] >= 0)]
    shard = [  # q rows at global 512.. (128..) with a left window of 64, kv shard at 0.. (64..)
        ("shard_out_of_band_fp32", 1, 128, 2, 64, f32, [1024], (64, -1), 512, 0, False),
        ("shard_out_of_band_bf16", 1, 128, 2, 64, bf, [1024], (64, -1), 512, 0, False),
        ("shard_partly_in_band_fp32", 1, 128, 2, 64, f32, [1024], (64, -1), 128, 64, False),
        ("band_right_only", 2, 300, 2, 128, bf, [300, 211], (-1, 5), 0, 0, False),
    ]
    worst = {"o": 0.0, "lse": 0.0}
    with env_flags(LCASR_ATTN_FWD_DB="1"):
        for case in cases + shard:
            err_o, err_lse, o = check_attention_case(torch, case, gen, "flash_attention_fwd_db")
            if case[0].startswith("shard_out_of_band") and not (o == 0).all():
                raise AssertionError(f"{case[0]}: a shard wholly out of band must give exactly 0")
            if case[5] == bf:
                worst["o"] = max(worst["o"], err_o)
                worst["lse"] = max(worst["lse"], err_lse)
        for c in attention_cases(torch):  # a two-sided band stays on K1 under the flag
            if c[7][0] >= 0 and c[7][1] >= 0:
                check_attention_case(torch, c, gen, "flash_attention_fwd")
    equal = [c for c in cases + shard if c[5] == bf]
    for case in equal:
        require_k2_equals_k1(torch, case, gen)
    log(f"  K2 bit-equal to K1 (o and lse) on the {len(equal)} bf16 cases K2 takes: "
        + ", ".join(c[0] for c in equal))

    B, T, H, D = 16, 2048, 6, 128
    q, k, v = make_qkv(torch, B, T, H, D, bf, True, gen)
    k1 = lambda: flash_attention_with_lse(q, k, v)

    def k2():
        with env_flags(LCASR_ATTN_FWD_DB="1"):
            return flash_attention_with_lse(q, k, v)

    require_k2_equals_k1(torch, ("decode_shape", B, T, H, D, bf, None, (-1, -1), 0, 0, True), gen)
    with env_flags(LCASR_ATTN_FWD_DB="1"):
        check_layout_refused(torch, "flash_attention_fwd_db")
    # device time in turns: K1, K2, K2, K1, the library between; then whole
    # wrapper calls in the same order
    e1, e2 = fwd_entry(torch, q, k, v), fwd_entry(torch, q, k, v, db=True)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)
    d1a, d2a = device_ms(torch, e1), device_ms(torch, e2)
    library_ms = device_ms(torch, sdpa)
    d2b, d1b = device_ms(torch, e2), device_ms(torch, e1)
    t1a, t2a = time_ms(torch, k1, n=30), time_ms(torch, k2, n=30)
    t2b, t1b = time_ms(torch, k2, n=30), time_ms(torch, k1, n=30)
    kernel_ms, k1_ms = min(d2a, d2b), min(d1a, d1b)
    plain_ms = time_ms(torch, lambda: flash_attention_ref(q, k, v), n=3, warmup=1)
    bound_ms, bound_by, flops = attention_bound(B, T, H, D)
    log(f"  K2 at (16, 2048, 6, 128) bf16, bit-equal to K1: "
        f"device time K2 {d2a:.4f} / {d2b:.4f} ms ({flops / kernel_ms / 1e9:.1f} TFLOP/s), K1 in "
        f"the same turns {d1a:.4f} / {d1b:.4f} ms, scaled_dot_product_attention "
        f"{library_ms:.4f} ms; wrapper calls K2 {t2a:.4f} / {t2b:.4f} ms, K1 {t1a:.4f} / "
        f"{t1b:.4f} ms; plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms")
    return {
        "name": "flash_attention_fwd_db", "route": "cuda",
        "source": "lcasr_torch/csrc/flash_attn_fwd_db.cu",
        "replaces": "lcasr_tpu/ops/flash_attention.py:117",
        "replaces_fn": "lcasr_tpu/ops/flash_attention.py:_fwd_kernel_db",
        "launches": None, "max_abs_err": max(worst["o"], worst["lse"]),
        "max_err_o": worst["o"], "max_err_lse": worst["lse"], "max_diff_from_k1": 0.0,
        "ms": kernel_ms, "k1_ms_same_turns": k1_ms, "wrapper_ms": min(t2a, t2b),
        "k1_wrapper_ms_same_turns": min(t1a, t1b), "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
    }


# ---------------------------------------------------------------------------
# phase 2b: flash-attention backward (K3, K4, K5) against its plain version
# ---------------------------------------------------------------------------
BWD_KERNELS = {  # launch-count name -> (kernel symbol, Pallas body it replaces)
    "flash_attention_bwd_fused": ("flash_bwd_hopper<128, true>", 666, "_bwd_fused_kernel"),
    "flash_attention_bwd_dq": ("flash_bwd_dq_hopper<128>", 484, "_bwd_dq_kernel"),
    "flash_attention_bwd_dkv": ("flash_bwd_hopper<128, false>", 569, "_bwd_dkv_kernel"),
}
TRAIN_ATTN_SHAPE = (4, 2048, 6, 128)  # (B, T, H, D): a 16384-frame x 4 chunk


def run_bwd(torch, fused: bool, *args):
    """flash_attention_bwd through K3 (fused) or K4 + K5."""
    from lcasr_torch.ops.flash_attention import flash_attention_bwd

    with env_flags(LCASR_FUSED_ATTN_BWD="1" if fused else "0"):
        return flash_attention_bwd(*args)


def kernel_device_ms(torch, fn, names, n: int = 10):
    """Mean device time per launch of each kernel whose name starts with one
    of `names`, over n calls of fn (torch.profiler)."""
    out = {}
    for key, (us, count) in device_kernel_totals(torch, fn, n).items():
        for want in names:
            if want.replace(" ", "") in key.replace(" ", "") and count:
                out[want] = us / count / 1e3
    missing = [w for w in names if w not in out]
    if missing:
        raise AssertionError(f"profiler recorded no device time for {missing}")
    return out


def bwd_case(torch, case, gen):
    """One attention case through the backward: K3 and K4 + K5 (a
    two-sided band: K4 + K5 only, as `_bwd_impl` chooses) against
    `flash_attention_bwd_ref`, each launching its kernels once; each route
    run twice, whose dk and dv must be the same bits, and on the split route
    dq too (K4 has one writer per element; K3 adds dq across CTAs); K5's dk
    and dv bit-equal to K3's.  Returns {route: (max|d dq|, max|d dk|, max|d dv|)}."""
    from lcasr_torch import kernels
    from lcasr_torch.ops.flash_attention import (
        flash_attention_bwd_ref, flash_attention_with_lse)

    (name, B, T, H, D, dtype, lengths, window, qo, ko, views) = case
    q, k, v = make_qkv(torch, B, T, H, D, dtype, views, gen)
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device="cuda")
    o, lse = flash_attention_with_lse(q, k, v, lens, window, None, qo, ko)
    do = torch.randn((B, T, H, D), generator=gen, device="cuda").to(dtype)
    args = (q, k, v, o, lse, do, lens, window, None, qo, ko)
    want = flash_attention_bwd_ref(*args)
    banded = window[0] >= 0 and window[1] >= 0
    errs, got = {}, {}
    for fused in ((False,) if banded else (True, False)):
        route = "K3" if fused else "K4+K5"
        expected = ({"flash_attention_bwd_fused": 1} if fused else
                    {"flash_attention_bwd_dq": 1, "flash_attention_bwd_dkv": 1})
        kernels.reset_launch_counts()
        got[fused] = run_bwd(torch, fused, *args)
        again = run_bwd(torch, fused, *args)
        torch.cuda.synchronize()
        launched = {k_: n // 2 for k_, n in kernels.launch_counts.items() if n}
        if launched != expected:
            raise AssertionError(f"{name} {route}: launched {launched} per call, expected {expected}")
        errs[route] = []
        for g, w in zip(got[fused], want):
            if not torch.isfinite(g).all():
                raise AssertionError(f"{name} {route}: non-finite gradient")
            scale = w.float().abs().max().item()
            err = (g.float() - w.float()).abs().max().item()
            # bf16: the kernels round p and ds to bf16 before their
            # products (as the Pallas kernels do) and dk, dv to bf16 on
            # the way out, ~2^-8 relative; fp32: summation order only
            # (and the order of dq's adds across CTAs)
            tol = (2e-2 if dtype == torch.bfloat16 else 1e-4) * max(scale, 1.0)
            if err > tol:
                raise AssertionError(f"{name} {route}: max|d| {err:.3e} > {tol:.3e}")
            errs[route].append(err)
        if lengths is not None and 0 in lengths:
            zero = [i for i, ln in enumerate(lengths) if ln == 0]
            if not all((g[zero] == 0).all() for g in got[fused]):
                raise AssertionError(f"{name} {route}: zero-length rows must get zero gradients")
        # dk and dv have one writer per element and a fixed order of products
        if not (torch.equal(got[fused][1], again[1]) and torch.equal(got[fused][2], again[2])):
            raise AssertionError(f"{name} {route}: dk or dv differs between two runs")
        if not fused and not torch.equal(got[fused][0], again[0]):
            raise AssertionError(f"{name} {route}: K4's dq differs between two runs")
        log(f"  {name:26s} {route}: max|d dq| {errs[route][0]:.3e} "
            f"max|d dk| {errs[route][1]:.3e} max|d dv| {errs[route][2]:.3e}")
    if dtype == torch.bfloat16 and not banded and not (
            torch.equal(got[True][1], got[False][1]) and torch.equal(got[True][2], got[False][2])):
        raise AssertionError(f"{name}: K5's dk, dv are not bit-equal to K3's")
    return errs


def sdpa_backward_ms(torch, q, k, v, do, n_prof: int = 10):
    """The library's backward: {kernel: device ms per call} of the kernels
    that scaled_dot_product_attention's forward and backward runs and its
    forward alone does not, from profiler windows."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt)

    def sdpa_fwd_bwd():
        torch.autograd.grad(F.scaled_dot_product_attention(qt, kt, vt), (qt, kt, vt), dot)

    fwd_only = device_kernel_totals(torch, sdpa_fwd, n_prof)
    fwd_bwd = device_kernel_totals(torch, sdpa_fwd_bwd, n_prof)
    bwd = {name: us / n_prof / 1e3 for name, (us, _) in fwd_bwd.items() if name not in fwd_only}
    if not bwd:
        raise AssertionError("the profiler recorded no backward kernel of scaled_dot_product_attention")
    return bwd


def phase_kernels_bwd(torch, registers: dict):
    """K3 and K4 + K5 on every attention case (the forward's, the backward's
    tile edges), bit-equality of dk and dv across runs and between K5 and
    K3; then their device time per launch at a 16384 x 4 micro step's shape
    in turns with cuDNN's backward (through scaled_dot_product_attention),
    each beside its bound.  `registers`: ptxas's registers of each kernel
    symbol, for the record."""
    from lcasr_torch.ops.flash_attention import (
        flash_attention_bwd_ref, flash_attention_with_lse)

    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {name: 0.0 for name in BWD_KERNELS}
    n_equal = 0
    for case in attention_cases(torch):
        errs = bwd_case(torch, case, gen)
        if case[5] == torch.bfloat16:
            worst["flash_attention_bwd_fused"] = max(worst["flash_attention_bwd_fused"],
                                                     *errs.get("K3", [0.0]))
            worst["flash_attention_bwd_dq"] = max(worst["flash_attention_bwd_dq"], errs["K4+K5"][0])
            worst["flash_attention_bwd_dkv"] = max(worst["flash_attention_bwd_dkv"],
                                                   *errs["K4+K5"][1:])
            n_equal += "K3" in errs
    log(f"  dk, dv the same bits in two runs of each route on every case, K4's dq in two "
        f"runs of the split route; K5's dk, dv bit-equal to K3's on the {n_equal} bf16 cases "
        f"both take")

    # device time per launch at a training shape, full lengths, qkv views as
    # the model gives them, in turns: K3, K4 + K5, the library twice, K4 + K5, K3
    B, T, H, D = TRAIN_ATTN_SHAPE
    q, k, v = make_qkv(torch, B, T, H, D, torch.bfloat16, True, gen)
    o, lse = flash_attention_with_lse(q, k, v)
    do = torch.randn((B, T, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    args = (q, k, v, o, lse, do, None, (-1, -1), None, 0, 0)
    sym = {key: entry[0] for key, entry in BWD_KERNELS.items()}
    fused = lambda: run_bwd(torch, True, *args)
    split = lambda: run_bwd(torch, False, *args)
    split_syms = [sym["flash_attention_bwd_dq"], sym["flash_attention_bwd_dkv"]]
    turns = {key: [] for key in BWD_KERNELS}
    library = []

    def time_fused():
        turns["flash_attention_bwd_fused"].append(
            kernel_device_ms(torch, fused, [sym["flash_attention_bwd_fused"]])[
                sym["flash_attention_bwd_fused"]])

    def time_split():
        dev = kernel_device_ms(torch, split, split_syms)
        for key in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            turns[key].append(dev[sym[key]])

    def time_library():
        bwd = sdpa_backward_ms(torch, q, k, v, do)
        library.append(sum(bwd.values()))
        return bwd

    time_fused()
    time_split()
    lib_kernels = time_library()
    time_library()
    time_split()
    time_fused()
    log(f"  scaled_dot_product_attention backward at (4, 2048, 6, 128): "
        + " / ".join(f"{ms:.4f}" for ms in library) + f" ms of device time in "
        f"{len(lib_kernels)} kernels: " + ", ".join(
            f"{name[:60]} {ms:.4f}" for name, ms in sorted(lib_kernels.items(), key=lambda kv: -kv[1])))
    fused_ms = time_ms(torch, fused, n=20)
    split_ms = time_ms(torch, split, n=20)
    plain_ms = time_ms(torch, lambda: flash_attention_bwd_ref(*args), n=3, warmup=1)
    pairs = valid_pairs(None, B, T, (-1, -1), 0, 0)
    elems = B * T * H * D
    stats = 2 * 4 * B * H * T  # lse and delta, fp32
    work = {  # (products of 2*pairs*D flops, bytes read once + written once)
        "flash_attention_bwd_fused": (5, 4 * 2 * elems + stats + 4 * elems + 2 * 2 * elems),
        "flash_attention_bwd_dq": (3, 4 * 2 * elems + stats + 4 * elems),
        "flash_attention_bwd_dkv": (4, 4 * 2 * elems + stats + 2 * 2 * elems),
    }
    library_ms = min(library)
    # the split path under the band of the repo's hour-scale configuration
    # (configs/cp_1hour_tiny.yaml, attention_window_size 256): K4 and K5 at
    # the same shape with window (256, 256), each against the bound of the
    # pairs that band leaves
    band = (256, 256)
    o_band, lse_band = flash_attention_with_lse(q, k, v, None, band)
    band_args = (q, k, v, o_band, lse_band, do, None, band, None, 0, 0)
    band_split = lambda: run_bwd(torch, False, *band_args)
    band_turns = {key: [] for key in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")}
    for _ in range(2):
        dev = kernel_device_ms(torch, band_split, split_syms)
        for key in band_turns:
            band_turns[key].append(dev[sym[key]])
    band_pairs = valid_pairs(None, B, T, band, 0, 0)

    def bound_of(key, n_pairs):
        n_products, nbytes = work[key]
        flops = n_products * 2 * n_pairs * D * H
        t_ops = flops / PEAK_FLOPS["bf16"] * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        return max(t_ops, t_bytes), flops, "operations" if t_ops >= t_bytes else "bytes"

    out = {}
    for key, (symbol, line, body) in BWD_KERNELS.items():
        bound, flops, bound_by = bound_of(key, pairs)
        ms = min(turns[key])
        log(f"  {key} at (4, 2048, 6, 128) bf16: device time per launch "
            + " / ".join(f"{x:.4f}" for x in turns[key]) + f" ms ({flops / ms / 1e9:.1f} TFLOP/s, "
            f"{100 * bound / ms:.1f}% of its {bound:.4f} ms bound; cuDNN's backward "
            f"{library_ms:.4f} ms, {ms / library_ms:.2f}x); {registers.get(symbol, '?')} registers")
        out[key] = {
            "name": key, "route": "cuda",
            "source": "lcasr_torch/csrc/flash_attn_bwd.cu",
            "replaces": f"lcasr_tpu/ops/flash_attention.py:{line}",
            "replaces_fn": f"lcasr_tpu/ops/flash_attention.py:{body}",
            "launches": None, "max_abs_err": worst[key], "ms": ms, "ms_turns": turns[key],
            "plain_ms": plain_ms, "library_ms": library_ms, "library_ms_turns": library,
            "bound_ms": bound, "bound_by": bound_by,
            "registers": registers.get(symbol),
        }
        if key in band_turns:
            b_bound, b_flops, b_by = bound_of(key, band_pairs)
            b_ms = min(band_turns[key])
            log(f"  {key} at (4, 2048, 6, 128) bf16, window (256, 256), {band_pairs} valid pairs: "
                f"device time per launch " + " / ".join(f"{x:.4f}" for x in band_turns[key])
                + f" ms ({b_flops / b_ms / 1e9:.1f} TFLOP/s, {100 * b_bound / b_ms:.1f}% of its "
                f"{b_bound:.4f} ms bound by {b_by})")
            out[key].update(ms_band_256=b_ms, ms_band_256_turns=band_turns[key],
                            bound_ms_band_256=b_bound, bound_by_band_256=b_by)
    log(f"  wrappers at (4, 2048, 6, 128): K3 path {fused_ms:.4f} ms, K4+K5 path "
        f"{split_ms:.4f} ms (delta, dq scale and casts included); plain {plain_ms:.4f} ms")
    for key in out:
        out[key]["wrapper_ms"] = fused_ms if key.endswith("fused") else split_ms
    return out


# ---------------------------------------------------------------------------
# phase 2c: selective scan (K6) and its backward (K7) against their plain versions
# ---------------------------------------------------------------------------
SSM_KERNELS = {  # launch-count name -> (kernel symbol, Pallas body it replaces)
    "selective_scan_fwd": ("selective_scan_fwd_kernel", 78, "_scan_kernel"),
    # K7 is five launches whose names all begin so (csrc/selective_scan.cu)
    "selective_scan_bwd": ("selective_scan_bwd_", 177, "_scan_bwd_kernel"),
}
SSM_DECODE_SHAPE = (32, 2048, 768, 16)  # (Bt, L, D, N): 16 windows, both directions
SSM_TRAIN_SHAPE = (8, 2048, 768, 16)  # a 16384-frame x 4 chunk
SSM_LONG_SHAPE = (2, 15_000, 768, 16)  # the 120,000 x 1 step: 15,000 frames, both directions
# kernel and plain version are both fp32 on the same (possibly bf16-rounded)
# inputs; they differ in exp2 against exp, fused multiply-adds and the order of
# the sums over channels and time: 2e-4 of the largest reference value
SSM_TOL = 2e-4


def ssm_cases(torch):
    """(name, Bt, L, D, x dtype, B/C dtype, B and C as strided slices, wide delta)"""
    bf, f32 = torch.bfloat16, torch.float32
    return [
        ("fp32_L1", 2, 1, 40, f32, f32, False, False),
        ("fp32_L15", 3, 15, 96, f32, f32, False, True),
        ("fp32_L77_strided", 2, 77, 768, f32, f32, True, False),
        ("bf16_L77_D100", 2, 77, 100, bf, bf, False, True),
        ("bf16_L333_strided", 2, 333, 160, bf, bf, True, False),
        ("mixed_L2048_strided", 2, 2048, 768, f32, bf, True, False),  # as the mixer gives
        ("mixed_L15000_strided", *SSM_LONG_SHAPE[:3], f32, bf, True, False),  # the 120,000-frame step
        # the other shapes the main paths launch at, as the mixer gives them
        ("decode_shape_full", *SSM_DECODE_SHAPE[:3], f32, bf, True, False),
        ("train_shape_full", *SSM_TRAIN_SHAPE[:3], f32, bf, True, False),  # 16384 x 4
        ("train_shape_8192x8", 16, 1024, 768, f32, bf, True, False),
        # the edges of K7's split: 32-step chunks, 128-channel blocks of
        # 32-channel passes, one row
        ("fp32_L31_Bt1", 1, 31, 128, f32, f32, False, False),
        ("fp32_L33_D100", 2, 33, 100, f32, f32, False, True),
        ("mixed_L2049_D160", 2, 64 * 32 + 1, 160, f32, bf, True, False),
        ("mixed_L64_D200_Bt1", 1, 64, 200, f32, bf, True, True),
    ]


def ssm_inputs(torch, gen, Bt, L, D, N, x_dtype, bc_dtype, strided, wide):
    """x, delta, A, B, C, g as the mixer gives them: delta a softplus around
    0.05 (`wide`: around 0.7, gains near 0), A = -(1..N) jittered, B and C
    slices of one (Bt, L, 48 + 2N) projection when `strided`."""
    import torch.nn.functional as F

    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    x = randn(Bt, L, D).to(x_dtype)
    delta = F.softplus(randn(Bt, L, D) + (0.0 if wide else -3.0))
    A = -torch.arange(1, N + 1, device="cuda").float() * torch.exp(0.3 * randn(D, N))
    if strided:
        proj = randn(Bt, L, 48 + 2 * N).to(bc_dtype)
        Bm, Cm = proj[..., 48:48 + N], proj[..., 48 + N:]
    else:
        Bm, Cm = randn(Bt, L, N).to(bc_dtype), randn(Bt, L, N).to(bc_dtype)
    return x, delta, A, Bm, Cm, randn(Bt, L, D)


def max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def ssm_bound(torch, kind, shape, x_bytes, bc_bytes, states: bool):
    """(bound ms, 'bytes' or 'operations') of one scan: every input read once
    and every output written once at the memory rate, against the fp32
    operations at the fp32 peak and the exps at the special-function rate
    (16 per clock per SM at the card's highest SM clock)."""
    Bt, L, D, N = shape
    elems, small = Bt * L * D, Bt * L * N
    state_bytes = 4 * Bt * -(-L // 32) * N * D if states else 0
    if kind == "fwd":  # x, delta in; y out; per (t, d, n): 1 exp and 6 flops
        nbytes = elems * (x_bytes + 4 + 4) + 2 * small * bc_bytes + 4 * D * N + state_bytes
        exps, flops = elems * N, 6 * elems * N
    else:  # x, delta, g in; dx, ddelta out; dB, dC, dA.  The function needs
        # one exp per (t, d, n): a_t = exp(delta_t A) serves the recompute and
        # the reverse sweep alike (that K7 computes it twice is its choice);
        # 20 flops
        nbytes = (elems * (x_bytes + 4 * 4) + 2 * small * bc_bytes + 2 * small * 4
                  + 2 * 4 * D * N + state_bytes)
        exps, flops = elems * N, 20 * elems * N
    sfu_rate = (SFU_PER_CLOCK_PER_SM * torch.cuda.get_device_properties(0).multi_processor_count
                * max_sm_clock_hz())
    t_ops = max(flops / PEAK_FLOPS["fp32"], exps / sfu_rate) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def ssm_case(torch, case, gen):
    """One case of K6 and K7 against their plain versions at SSM_TOL of the
    largest reference value; the forward with and without its states the same
    bits, and K7's five gradients the same bits in two runs.  Returns (the
    forward's worst error, the backward's)."""
    from lcasr_torch.ops import ssm

    name, Bt, L, D, xd, bcd, strided, wide = case

    def rel_err(what, got, want):
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite {what}")
        scale = max(want.abs().max().item(), 1e-6)
        err = (got.float() - want.float()).abs().max().item() / scale
        if err > SSM_TOL:
            raise AssertionError(f"{name}: {what} off by {err:.3e} of its largest value "
                                 f"(tolerance {SSM_TOL:g})")
        return err

    x, delta, A, Bm, Cm, g = ssm_inputs(torch, gen, Bt, L, D, 16, xd, bcd, strided, wide)
    y = ssm.selective_scan_fwd(x, delta, A, Bm, Cm)
    y_s, states = ssm.selective_scan_fwd(x, delta, A, Bm, Cm, return_states=True)
    grads = ssm.selective_scan_bwd(x, delta, A, Bm, Cm, states, g)
    again = ssm.selective_scan_bwd(x, delta, A, Bm, Cm, states, g)
    torch.cuda.synchronize()
    if not torch.equal(y, y_s):
        raise AssertionError(f"{name}: y differs with and without the saved states")
    # no atomics and a fixed order of every sum: the same bits each run
    for what, a, b in zip(("dx", "ddelta", "dA", "dB", "dC"), grads, again):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: K7's {what} differs between two runs")
    y_ref, states_ref = ssm.selective_scan_ref(x, delta, A, Bm, Cm, return_states=True)
    grads_ref = ssm.selective_scan_bwd_ref(x, delta, A, Bm, Cm, g)
    e_fwd = [rel_err("y", y, y_ref), rel_err("states", states, states_ref)]
    e_bwd = [rel_err(what, got, want) for what, got, want in
             zip(("dx", "ddelta", "dA", "dB", "dC"), grads, grads_ref)]
    log(f"  {name:22s} K6: y {e_fwd[0]:.2e} states {e_fwd[1]:.2e}   K7: dx {e_bwd[0]:.2e} "
        f"ddelta {e_bwd[1]:.2e} dA {e_bwd[2]:.2e} dB {e_bwd[3]:.2e} dC {e_bwd[4]:.2e} "
        f"(of the largest value; tolerance {SSM_TOL:g}; K7 the same bits in two runs)")
    return max(e_fwd), max(e_bwd)


def kernel_group_ms(torch, fn, prefix: str, n: int = 5) -> float:
    """Device time per call of fn of every kernel whose name contains
    `prefix` (torch.profiler), summed: a wrapper's several launches."""
    totals = device_kernel_totals(torch, fn, n)
    us = sum(t for key, (t, _) in totals.items() if prefix in key)
    if not us:
        raise AssertionError(f"profiler recorded no device time for {prefix}*")
    return us / n / 1e3


def phase_kernels_ssm(torch):
    from lcasr_torch.ops import ssm

    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {name: 0.0 for name in SSM_KERNELS}
    for case in ssm_cases(torch):
        e_fwd, e_bwd = ssm_case(torch, case, gen)
        worst["selective_scan_fwd"] = max(worst["selective_scan_fwd"], e_fwd)
        worst["selective_scan_bwd"] = max(worst["selective_scan_bwd"], e_bwd)

    # timing at the decode's, the training step's and the 120,000-frame
    # step's shapes, x fp32 and B, C bf16 slices of the projection, as the
    # bf16 mixer gives them (the plain versions, Python loops over L, are
    # timed at the first two)
    out, timed = {}, {}
    bwd_prefix = SSM_KERNELS["selective_scan_bwd"][0]
    for label, shape in (("decode", SSM_DECODE_SHAPE), ("train", SSM_TRAIN_SHAPE),
                         ("long", SSM_LONG_SHAPE)):
        Bt, L, D, N = shape
        x, delta, A, Bm, Cm, g = ssm_inputs(torch, gen, Bt, L, D, N, torch.float32,
                                            torch.bfloat16, True, False)
        _, states = ssm.selective_scan_fwd(x, delta, A, Bm, Cm, return_states=True)
        fwd = lambda: ssm.selective_scan_fwd(x, delta, A, Bm, Cm)
        fwd_s = lambda: ssm.selective_scan_fwd(x, delta, A, Bm, Cm, return_states=True)
        bwd = lambda: ssm.selective_scan_bwd(x, delta, A, Bm, Cm, states, g)
        t = {"fwd": time_ms(torch, fwd, n=20), "fwd_states": time_ms(torch, fwd_s, n=20),
             "bwd": time_ms(torch, bwd, n=10)}
        t["bwd_kernel_only"] = kernel_group_ms(torch, bwd, bwd_prefix)
        if label != "long":
            t["fwd_plain"] = time_ms(torch, lambda: ssm.selective_scan_ref(x, delta, A, Bm, Cm),
                                     n=2, warmup=1)
            t["bwd_plain"] = time_ms(
                torch, lambda: ssm.selective_scan_bwd_ref(x, delta, A, Bm, Cm, g), n=2, warmup=1)
        t["fwd_bound"] = ssm_bound(torch, "fwd", shape, 4, 2, False)
        t["fwd_states_bound"] = ssm_bound(torch, "fwd", shape, 4, 2, True)
        t["bwd_bound"] = ssm_bound(torch, "bwd", shape, 4, 2, True)
        timed[label] = t
        plain = (f"plain K6 {t['fwd_plain']:.2f} ms, K7 {t['bwd_plain']:.2f} ms"
                 if "fwd_plain" in t else "plain not timed")
        log(f"  {label} shape {shape}, x fp32, B/C bf16 strided: K6 {t['fwd']:.4f} ms "
            f"(with states {t['fwd_states']:.4f} ms), bound {t['fwd_bound'][0]:.4f} ms by "
            f"{t['fwd_bound'][1]} (with states {t['fwd_states_bound'][0]:.4f} ms); K7 "
            f"{t['bwd']:.4f} ms a wrapper call (device time of its launches "
            f"{t['bwd_kernel_only']:.4f} ms, {100 * t['bwd_bound'][0] / t['bwd_kernel_only']:.1f}% "
            f"of its bound), bound {t['bwd_bound'][0]:.4f} ms by {t['bwd_bound'][1]}; {plain}; "
            f"no library call computes either")
        del x, delta, A, Bm, Cm, g, states
    # K6's row is the decode's launch (no states), K7's the training step's
    for key, (ms, plain, bound, extra) in {
        "selective_scan_fwd": (timed["decode"]["fwd"], timed["decode"]["fwd_plain"],
                               timed["decode"]["fwd_bound"],
                               {"ms_train_shape_with_states": timed["train"]["fwd_states"],
                                "bound_ms_train_shape_with_states":
                                    timed["train"]["fwd_states_bound"][0],
                                "plain_ms_train_shape": timed["train"]["fwd_plain"]}),
        "selective_scan_bwd": (timed["train"]["bwd_kernel_only"], timed["train"]["bwd_plain"],
                               timed["train"]["bwd_bound"],
                               {"wrapper_ms": timed["train"]["bwd"],
                                "ms_decode_shape": timed["decode"]["bwd_kernel_only"],
                                "wrapper_ms_decode_shape": timed["decode"]["bwd"],
                                "bound_ms_decode_shape": timed["decode"]["bwd_bound"][0],
                                "plain_ms_decode_shape": timed["decode"]["bwd_plain"],
                                "ms_long_shape": timed["long"]["bwd_kernel_only"],
                                "wrapper_ms_long_shape": timed["long"]["bwd"],
                                "bound_ms_long_shape": timed["long"]["bwd_bound"][0]}),
    }.items():
        symbol, line, body = SSM_KERNELS[key]
        out[key] = {
            "name": key, "route": "cuda", "source": "lcasr_torch/csrc/selective_scan.cu",
            "replaces": f"lcasr_tpu/ops/ssm.py:{line}",
            "replaces_fn": f"lcasr_tpu/ops/ssm.py:{body}",
            "launches": None, "max_abs_err": worst[key], "ms": ms, "plain_ms": plain,
            "library_ms": None, "bound_ms": bound[0], "bound_by": bound[1], **extra,
        }
    return out


# ---------------------------------------------------------------------------
# phase 2d: the fused 8x subsampling (K8) against the conv chain
# ---------------------------------------------------------------------------
SUB_DECODE_SHAPE = (16, 16_384, 80, 256)  # (B, T, F, C): one window batch
# every shape the main paths launch K8 at: the decode's window batch, the
# ladder's two buckets, the 120,000-frame step
SUB_MAIN_SHAPES = [(16, 16_384, 80), (8, 8_192, 80), (4, 16_384, 80), (1, 120_000, 80)]
SUB_SMALL_CASES = [  # tests/test_subsampling_fused.py:29-37, every activation once
    (2, 256, 80, "silu"), (1, 512, 80, "gelu"), (2, 328, 80, "relu"), (1, 256, 64, "none")]
SUB_TOL_FP32 = 2e-5  # fp32 accumulation in another order than cuDNN's
# bf16: the kernel against the fp32 conv chain may err at most this many times
# what the bf16 conv chain itself errs against it (maximum and mean), and
# nowhere by more than 2e-2 + 2e-2 |y|
SUB_BF16_YARDSTICK_FACTOR, SUB_TOL_BF16 = 1.5, 2e-2


def sub_params(torch, gen, C, dtype):
    """A random 3-stage chain in the module's layout (OIHW), as
    tests/test_subsampling_fused.py draws it."""
    r = lambda *shape, scale=0.2: (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)
    params = [r(C, 1, 3, 3), r(C)]
    for _ in range(2):
        params += [r(C, 1, 3, 3), r(C), r(C, C, 1, 1, scale=0.06), r(C)]
    return params


def sub_bound(B, T, F, C, elem_bytes, dtype_name):
    """(bound ms, bound_by, flops): the chain's operations at the peak of its
    type against x read once, the output written once and the weights."""
    T0, T1, T8, F0, F1, F8 = T // 2, T // 4, T // 8, F // 2, F // 4, F // 8
    flops = 2 * B * (T0 * F0 * C * 9 + T1 * F1 * C * (9 + C) + T8 * F8 * C * (9 + C))
    nbytes = elem_bytes * (B * T * F + B * T8 * F8 * C + 3 * 10 * C + 2 * C * C)
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


def phase_kernels_sub(torch):
    from lcasr_torch import kernels
    from lcasr_torch.ops import subsampling as sub

    bf, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = {"fp32": 0.0, "bf16": 0.0}

    def check(B, T, F, C, dtype, act, tile=None):
        x = torch.randn((B, T, F), generator=gen, device="cuda").to(dtype)
        params = sub_params(torch, gen, C, dtype)
        kernels.reset_launch_counts()
        with env_flags(LCASR_SUB_TILE=None if tile is None else str(tile)):
            y = sub.fused_dw_striding(x, params, act)
        torch.cuda.synchronize()
        if kernels.launch_counts["subsampling_fused"] != 1:
            raise AssertionError("fused_dw_striding did not launch its kernel")
        if tuple(y.shape) != (B, T // 8, F // 8, C) or y.dtype != dtype:
            raise AssertionError(f"K8 output {tuple(y.shape)} {y.dtype}")
        if not torch.isfinite(y).all():
            raise AssertionError("K8: non-finite output")
        ref = sub.dw_striding_chain(x.float()[:, None], [p.float() for p in params], act)
        ref = ref.permute(0, 2, 3, 1)
        err = (y.float() - ref).abs()
        what = f"({B}, {T}, {F}) -> {C} {str(dtype)[6:]} {act}" + (f" tile {tile}" if tile else "")
        if dtype == f32:
            bad = (err > SUB_TOL_FP32 + SUB_TOL_FP32 * ref.abs()).sum().item()
            log(f"  {what:44s} max|dy| {err.max().item():.3e} (tol {SUB_TOL_FP32:g} + "
                f"{SUB_TOL_FP32:g}|y|)")
            worst["fp32"] = max(worst["fp32"], err.max().item())
        else:
            chain = sub.dw_striding_chain(x[:, None], params, act).permute(0, 2, 3, 1)
            yard = (chain.float() - ref).abs()
            bad = (err > SUB_TOL_BF16 + SUB_TOL_BF16 * ref.abs()).sum().item()
            log(f"  {what:44s} max|dy| {err.max().item():.3e} mean {err.mean().item():.3e}; the "
                f"bf16 conv chain (the yardstick) max {yard.max().item():.3e} mean "
                f"{yard.mean().item():.3e}; tolerance {SUB_BF16_YARDSTICK_FACTOR:g} x the "
                f"yardstick and {SUB_TOL_BF16:g} + {SUB_TOL_BF16:g}|y| everywhere")
            if (err.max() > SUB_BF16_YARDSTICK_FACTOR * yard.max()
                    or err.mean() > SUB_BF16_YARDSTICK_FACTOR * yard.mean()):
                raise AssertionError(f"K8 {what}: further from the fp32 chain than "
                                     f"{SUB_BF16_YARDSTICK_FACTOR} x the bf16 chain is")
            worst["bf16"] = max(worst["bf16"], err.max().item())
        if bad:
            raise AssertionError(f"K8 {what}: {bad} values disagree with the conv chain")

    for B, T, F, act in SUB_SMALL_CASES:
        check(B, T, F, 128, f32, act)
    # tiles of 1 and 2 output frames: many tile edges, the first tile's zero
    # rows, a ragged last tile (T/8 = 41)
    check(2, 328, 80, 128, f32, "silu", tile=1)
    check(2, 328, 80, 256, bf, "silu", tile=2)
    check(2, 328, 80, 128, bf, "gelu")
    for B, T, F in SUB_MAIN_SHAPES:
        check(B, T, F, 256, bf, "silu")
        check(B, T, F, 256, f32, "silu")

    # times at the decode's window batch.  No single PyTorch call computes
    # the chain: the comparison is the conv chain itself (five cuDNN
    # convolutions and three activations), which is also the plain version.
    B, T, F, C = SUB_DECODE_SHAPE
    out, times = {}, {}
    for dtype, name in ((bf, "bf16"), (f32, "fp32")):
        x = torch.randn((B, T, F), generator=gen, device="cuda").to(dtype)
        params = sub_params(torch, gen, C, dtype)
        fused = lambda: sub.fused_dw_striding(x, params, "silu")
        chain = lambda: sub.dw_striding_chain(x[:, None], params, "silu").permute(0, 2, 3, 1)
        chain_copy = lambda: chain().contiguous()  # as `out` reads it: C minor
        ta, tc = time_ms(torch, fused, n=10), time_ms(torch, chain, n=5)
        tb, tcc = time_ms(torch, fused, n=10), time_ms(torch, chain_copy, n=5)
        bound_ms, bound_by, flops = sub_bound(B, T, F, C, 2 if dtype == bf else 4, name)
        times[name] = (min(ta, tb), tc, tcc, bound_ms, bound_by)
        log(f"  K8 at (16, 16384, 80) -> 256 {name}: {ta:.4f} / {tb:.4f} ms "
            f"({flops / min(ta, tb) / 1e9:.1f} TFLOP/s), the conv chain {tc:.4f} ms (with the "
            f"copy to C minor {tcc:.4f} ms), bound {bound_ms:.4f} ms by {bound_by}; no single "
            f"library call computes it")
        del x, params
    ms, plain_ms, chain_copy_ms, bound_ms, bound_by = times["bf16"]
    return {
        "name": "subsampling_fused", "route": "cuda",
        "source": "lcasr_torch/csrc/subsampling_fused.cu",
        "replaces": "lcasr_tpu/ops/subsampling_pallas.py:281",
        "replaces_fn": "lcasr_tpu/ops/subsampling_pallas.py:_fused_kernel",
        "launches": None, "max_abs_err": worst["bf16"], "max_abs_err_fp32": worst["fp32"],
        "ms": ms, "plain_ms": plain_ms, "conv_chain_with_copy_ms": chain_copy_ms,
        "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
        "ms_fp32": times["fp32"][0], "plain_ms_fp32": times["fp32"][1],
        "bound_ms_fp32": times["fp32"][3],
    }


# ---------------------------------------------------------------------------
# phases 3 and 6 (first half): one full-width window batch, kernel against plain
# ---------------------------------------------------------------------------
def flagship_model(torch):
    from lcasr_torch.models.sconformer_xl import FLAGSHIP, SCConformerXL, init_weights_

    model = SCConformerXL(**FLAGSHIP, dtype=torch.bfloat16, device=DEVICE)
    return init_weights_(model, seed=0)


def mamba_model(torch, seed: int = 0):
    """The full-width bf16 Mamba of MAMBA_CONFIG, its parameters drawn by the
    model's own initialisers from `seed`."""
    from lcasr_torch.config import Config
    from lcasr_torch.models.registry import load_model

    torch.manual_seed(seed)
    cfg = Config(merged(MAMBA_CONFIG, {"model": {"init_seed": seed}}))
    return load_model(cfg, 4095, device=DEVICE)


def plain_attention(bf16: bool = False):
    """Context in which SCConformerXL's attention is the plain fp32 version,
    or plain attention in bf16 (this script only)."""
    from unittest import mock

    import lcasr_torch.models.sconformer_xl as sx
    from lcasr_torch.ops.flash_attention import flash_attention_ref

    def plain(q, k, v, lengths=None, window=(-1, -1)):
        return flash_attention_ref(q, k, v, lengths, window)[0]

    return mock.patch.object(sx, "flash_attention", plain_bf16_attention if bf16 else plain)


def fp32_subsampling():
    """Context in which the subsampling's conv chain runs in fp32 on the bf16
    model's input and weights, its result rounded to the model's dtype (this
    script only): the yardstick of what the bf16 rounding inside the chain
    alone does to a training step."""
    from unittest import mock

    import lcasr_torch.ops.conv as conv

    real = conv.dw_striding_chain

    def chain(h, params, act="silu", causal=False):
        return real(h.float(), [p.float() for p in params], act, causal).to(h.dtype)

    return mock.patch.object(conv, "dw_striding_chain", chain)


def subsampling_without_cudnn():
    """Context in which the subsampling's bf16 conv chain gives the value that
    PyTorch's own convolution kernels compute with cuDNN off (the same
    roundings, another order of summation), its gradient staying the
    chain's, as K8's does (this script only)."""
    from unittest import mock

    import torch

    import lcasr_torch.ops.conv as conv

    real = conv.dw_striding_chain

    def chain(h, params, act="silu", causal=False):
        y = real(h, params, act, causal)
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=False):
            other = real(h, params, act, causal)
        return (y.float() + (other.float() - y.float()).detach()).to(y.dtype)

    return mock.patch.object(conv, "dw_striding_chain", chain)


def plain_scan(dtype):
    """Context in which `selective_scan` runs the plain versions of K6 and K7
    in `dtype`, on any device (this script only)."""
    from unittest import mock

    from lcasr_torch.ops import ssm

    def fwd(x, delta, A, B, C, return_states=False):
        out = ssm.selective_scan_ref(x, delta, A, B, C, return_states, dtype=dtype)
        return tuple(o.float() for o in out) if return_states else out.float()

    def bwd(x, delta, A, B, C, states, g):
        return tuple(o.float() for o in
                     ssm.selective_scan_bwd_ref(x, delta, A, B, C, g, dtype=dtype))

    # nothing is patched until the `with` is entered
    return mock.patch.multiple(ssm, selective_scan_fwd=fwd, selective_scan_bwd=bwd)


def require_launches(some: bool, what: str) -> None:
    """Raise unless kernels were launched since the counts were last zeroed
    (`some`) or none was (not `some`): a comparison of the kernels with their
    plain versions must run the kernels on one side only."""
    from lcasr_torch import kernels

    n = sum(kernels.launch_counts.values())
    if (n > 0) != some:
        raise AssertionError(f"{what}: {n} kernel launches, expected "
                             f"{'some' if some else 'none'} ({dict(kernels.launch_counts)})")


def window_batch(torch):
    """One (16, 80, 16384) window batch with ragged lengths, from a numpy seed."""
    import numpy as np

    rng = np.random.default_rng(1)
    audio = torch.from_numpy(rng.normal(size=(16, 80, SEQ_LEN)).astype(np.float32)).to(DEVICE)
    lengths = torch.tensor([SEQ_LEN] * 10 + [15_552, 12_000, 8_191, 4_096, 1_000, 0],
                           dtype=torch.int32, device=DEVICE)
    return audio, lengths


def logprob_agreement(torch, lp, lp_other, out_len, what: str):
    """(argmax agreement, max and mean |d log-prob|) over the valid frames of
    two runs of one bf16 model that differ only in where a kernel rounds
    (attention: P to bf16; the scan: the last bit of an fp32 y that is then
    cast to bf16; the fused subsampling: fp32 sums in another order); the
    random layers amplify that into small log-prob shifts and flip near-tied
    argmaxes among 4,096 classes.  Gate: agreement >= 0.9, max <= 1.0, mean
    <= 0.05."""
    valid = torch.arange(lp.shape[1], device=DEVICE)[None, :] < out_len[:, None]
    diff = (lp - lp_other).abs()[valid]
    agree = (lp.argmax(-1) == lp_other.argmax(-1))[valid].float().mean().item()
    max_d, mean_d = diff.max().item(), diff.mean().item()
    if not (agree >= 0.9 and max_d <= 1.0 and mean_d <= 0.05):
        raise AssertionError(f"{what}: argmax agreement {agree:.5f}, max|dlogp| {max_d:.4f}, "
                             f"mean|dlogp| {mean_d:.2e}")
    return agree, max_d, mean_d


def phase_model(torch, model, plain, what: str):
    """One (16, 80, 16384) window batch with ragged lengths: finite,
    normalised fp32 log-probs of the right shape, close to those of the same
    model inside the `plain` context (the kernels' plain versions)."""
    from lcasr_torch import kernels

    audio, lengths = window_batch(torch)
    with torch.no_grad():
        kernels.reset_launch_counts()
        out = model(audio, length=lengths)
        torch.cuda.synchronize()
        require_launches(True, f"{what} forward")
        lp, out_len = out["final_posteriors"], out["length"]
        if tuple(lp.shape) != (16, SEQ_LEN // 8, 4096) or lp.dtype != torch.float32:
            raise AssertionError(f"final_posteriors {tuple(lp.shape)} {lp.dtype}")
        if not torch.isfinite(lp).all():
            raise AssertionError("non-finite log-probs")
        norm_err = (lp.exp().sum(-1) - 1).abs().max().item()
        if norm_err > 1e-3:  # fp32 log-softmax: sums to 1 within float error
            raise AssertionError(f"log-probs do not normalise: {norm_err}")
        with plain:
            kernels.reset_launch_counts()
            lp_plain = model(audio, length=lengths)["final_posteriors"]
            require_launches(False, f"{what} forward inside its plain context")
        fwd_ms = time_ms(torch, lambda: model(audio, length=lengths), n=3, warmup=1)
    agree, max_d, mean_d = logprob_agreement(
        torch, lp, lp_plain, out_len, f"{what} with the kernels against its plain version")
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {what} ({n_params / 1e6:.1f}M parameters) forward (16, 80, {SEQ_LEN}) bf16: "
        f"{fwd_ms:.2f} ms; vs its plain version: argmax agreement {agree:.5f}, max|dlogp| "
        f"{max_d:.4f}, mean|dlogp| {mean_d:.2e}, normalisation error {norm_err:.1e}")
    return fwd_ms


# ---------------------------------------------------------------------------
# phases 4 and 6 (second half): the main path, a 20-minute streaming greedy decode
# ---------------------------------------------------------------------------
def expect_launches(expected: dict, what: str) -> dict:
    """The launch counts since they were last zeroed must be `expected` and 0
    of every other kernel."""
    from lcasr_torch import kernels

    launches = dict(kernels.launch_counts)
    if launches != dict(dict.fromkeys(launches, 0), **expected):
        raise AssertionError(f"{what} launched {launches}, expected {expected} and 0 of "
                             f"every other kernel")
    return launches


def timed_decodes(decoder, spec, n: int = 3, warm: bool = True):
    """(ids, seconds of each of n decodes, after a warm one unless the caller
    has decoded already)."""
    if warm:
        decoder.greedy(spec, seq_len=SEQ_LEN, overlap=OVERLAP)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        ids = decoder.greedy(spec, seq_len=SEQ_LEN, overlap=OVERLAP)
        times.append(time.perf_counter() - t0)
    return ids, times


def phase_decode(torch, model, expected: dict, what: str, profile_file: str):
    """`expected`: the launch counts one decode must show (every other
    kernel 0)."""
    import numpy as np

    from lcasr_torch import kernels
    from lcasr_torch.decoding.greedy import GreedyCTCDecoder
    from lcasr_torch.evaluation.streaming import StreamingDecoder

    n_classes = 4096
    spec = np.random.default_rng(2).normal(size=(1, 80, TOTAL_FRAMES)).astype(np.float32)
    decoder = StreamingDecoder(model, n_classes, window_batch_size=WINDOW_BATCH,
                               transfer_dtype=torch.bfloat16, device=DEVICE)
    kernels.reset_launch_counts()
    ids = decoder.greedy(spec, seq_len=SEQ_LEN, overlap=OVERLAP)
    launches = expect_launches(expected, f"{what} decode")
    if ids.ndim != 1 or ids.shape[0] < TOTAL_FRAMES // 8 - 8:
        raise AssertionError(f"decode gave {ids.shape} ids")
    if ids.min() < 0 or ids.max() >= n_classes:
        raise AssertionError("ids out of range")
    tokens = GreedyCTCDecoder(blank_id=n_classes - 1)(ids, decode=False)
    again, times = timed_decodes(decoder, spec, warm=False)
    if not np.array_equal(again, ids):
        raise AssertionError("repeated decodes differ")
    audio_s = TOTAL_FRAMES / FRAMES_PER_SECOND
    rtfx = audio_s / float(np.median(times))
    log(f"  {what} 20-minute decode: {ids.shape[0]} frame ids, {len(tokens)} tokens after "
        f"collapse, launches {launches}, decode s {[round(t, 4) for t in times]}, "
        f"RTFx (median of 3) {rtfx:.1f}")
    rows = profile_run(torch, lambda: decoder.greedy(spec, seq_len=SEQ_LEN, overlap=OVERLAP),
                       profile_file, f"one {what} decode")
    return launches, rtfx, rows


def profile_run(torch, run, filename: str, what: str):
    """Device time by kernel over one run (torch.profiler), and the
    device's idle share of the wall time.  The full table goes to
    build/<filename> beside this script.  Returns the rows, [(device us,
    launches, kernel name)], largest first."""
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
        return rows
    log(f"  profile of {what} (profiler on): wall {wall_us / 1e3:.2f} ms, device "
        f"busy {busy_us / 1e3:.2f} ms, idle share {1 - busy_us / wall_us:.3f}")
    for dev_us, count, key in rows[:15]:
        log(f"    {dev_us / 1e3:10.3f} ms {100 * dev_us / busy_us:5.1f}% x{count:<6d} {key[:100]}")
    return rows


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


class TrainRun:
    """What phases 5 and 7 share: the tokenizer, 16 synthetic podcasts, the
    smoke ladder's configuration over `base_config`, and the checks of a
    ladder run, of save / resume and of one 120,000-frame step.
    `per_micro` holds the kernel launches one micro step must show (every
    other kernel 0); `make_model(seed, config)` builds the model."""

    def __init__(self, torch, workdir: str, base_config: dict, make_model, per_micro: dict,
                 what: str):
        import tempfile

        from lcasr_torch.config import Config
        from lcasr_torch.data.tokenizer import load_tokenizer

        self.torch, self.workdir, self.what = torch, workdir, what
        self.make_model, self.per_micro = make_model, per_micro
        self.tok = load_tokenizer()
        self.tmp = tempfile.mkdtemp(dir=workdir)
        self.pairs = make_corpus(self.tmp, [PODCAST_FRAMES] * N_PODCASTS)
        with open(os.path.join(self.tmp, "pairs.json"), "w") as f:
            json.dump(self.pairs, f)
        self.cfg_d = merged(merged(base_config, SMOKE_OVERRIDES),
                            {"data": {"path": os.path.join(self.tmp, "pairs.json")},
                             "checkpointing": {"dir": os.path.join(self.tmp, "ckpt")}})
        self.cfg = Config(self.cfg_d)

    def loader(self, trainer, config):
        from lcasr_torch.data.dataloading import VariableBatchSimpleDataloader, load_json

        return VariableBatchSimpleDataloader(
            pairs=load_json(config["data"]["path"]), tokenizer=self.tok,
            batch_size=trainer.batch_size, chunk_size=config["audio_chunking"]["size"],
            chunk_overlap=0, random_seed=config["training"]["random_seed"])

    def expected(self, launches: dict, micro: int) -> dict:
        return dict(dict.fromkeys(launches, 0), **{k: v * micro for k, v in self.per_micro.items()})

    def ladder(self):
        """Train the ladder with the launch counts zeroed just before and
        read just after; check steps, losses, movement, counts, resume.
        Returns (trainer, model, launches)."""
        import numpy as np

        from lcasr_torch import kernels
        from lcasr_torch.training.trainer import Trainer

        torch, cfg, cfg_d = self.torch, self.cfg, self.cfg_d
        model = self.make_model(0, cfg)
        trainer = Trainer(cfg, model, self.tok, device=DEVICE)
        trainer.init_state()
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.train(self.loader(trainer, cfg))
        torch.cuda.synchronize()
        ladder_s = time.perf_counter() - t0
        launches = dict(kernels.launch_counts)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        metrics_path = os.path.join(trainer.checkpoint_dir, "metrics.jsonl")
        rows = [json.loads(line) for line in open(metrics_path)]
        losses = [(r["sequence_length"], r["batch_size"], r["loss"]) for r in rows if "loss" in r]
        log(f"  {self.what} ladder run: {ladder_s:.2f} s, optimizer steps (seq, batch, loss/frame) "
            f"{losses}")
        first = (cfg_d["audio_chunking"]["size"], cfg_d["training"]["batch_size"])
        ladder = [first, first, (2 * first[0], first[1] // 2), (2 * first[0], first[1] // 2)]
        if [(s, b) for s, b, _ in losses] != ladder:
            raise AssertionError(f"the ladder did not run the optimizer steps {ladder}")
        if not all(np.isfinite(x) for *_, x in losses):
            raise AssertionError("non-finite loss")
        moved = max((p.detach() - before[n]).abs().max().item()
                    for n, p in model.named_parameters())
        if not moved > 0:
            raise AssertionError("the parameters did not move")
        micro = len(losses)  # one chunk per optimizer step here
        log(f"  launches over the ladder run ({micro} micro steps): {launches}; peak memory "
            f"{peak_gb:.2f} GB")
        if launches != self.expected(launches, micro):
            raise AssertionError(f"launch counts {launches}, expected "
                                 f"{self.expected(launches, micro)}")

        # save / resume into a fresh Trainer
        meta = json.load(open(os.path.join(trainer.checkpoint_dir, f"step_{N_PODCASTS}",
                                           "meta.json")))
        other = Trainer(cfg, self.make_model(1, cfg), self.tok, device=DEVICE)
        step, epoch, seen = other.resume()
        same = all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                      other.model.state_dict().values()))
        log(f"  resume: step {step}, epoch {epoch}, {len(seen)} seen ids, state equal {same}")
        if not (same and step == meta["podcast_step"] == N_PODCASTS and epoch == meta["epoch"] == 1
                and seen == meta["seen_ids"] and len(seen) == N_PODCASTS
                and other.chunk_size == trainer.chunk_size == PODCAST_FRAMES):
            raise AssertionError("save / resume round trip failed")

        # per bucket: step wall ms and audio seconds per second
        for seq, items in step_times(metrics_path).items():
            ms = [m for m, _ in items]
            frames = items[-1][1]
            med = float(np.median(ms[1:] if len(ms) > 1 else ms))  # the first step warms up
            log(f"  bucket {seq} frames: step ms {[round(m, 2) for m in ms]}, steady {med:.2f} "
                f"ms, {frames} live frames per step, {frames * 0.01 / (med / 1e3):.1f} audio-s/s")
        return trainer, model, launches

    def chunk_16384x4(self):
        """(batch, chunk): one 16384 x 4 chunk of the corpus."""
        from lcasr_torch.data.dataloading import VariableBatchSimpleDataloader
        from lcasr_torch.training.trainer import make_chunks

        batch = next(iter(VariableBatchSimpleDataloader(
            self.pairs, self.tok, batch_size=4, chunk_size=PODCAST_FRAMES, chunk_overlap=0)))
        return batch, make_chunks(*batch[:3], self.tok, PODCAST_FRAMES, 0, self.tok.pad_id())[0]

    def timed_step(self, trainer, chunk, profile_file: str) -> list:
        """One 16384 x 4 training step (micro step + optimizer step) without
        data loading: synchronised wall times, then its profile (returned as
        `profile_run`'s rows)."""
        torch = self.torch

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
        log(f"  16384x4 {self.what} step without data loading, synchronised: "
            f"{[round(x, 2) for x in synced]} ms")
        return profile_run(torch, train_step, profile_file,
                           f"one 16384x4 {self.what} training step")

    def long_step(self, model, kernel_prefix=None):
        """One optimizer step of the 20-minute bucket: 120,000 frames x 1.
        With `kernel_prefix`, the step runs under torch.profiler (device
        activity only) and the device ms of the kernels whose names contain
        it are returned (the step's wall time then includes the profiler)."""
        import tempfile

        import numpy as np

        from lcasr_torch import kernels
        from lcasr_torch.config import Config
        from lcasr_torch.training.trainer import Trainer

        torch = self.torch
        long_dir = tempfile.mkdtemp(dir=self.workdir)
        long_pairs = make_corpus(long_dir, [LONG_FRAMES], seed=3)
        with open(os.path.join(long_dir, "pairs.json"), "w") as f:
            json.dump(long_pairs, f)
        long_cfg = Config(merged(
            {k: v for k, v in self.cfg_d.items() if k != "sequence_scheduler"},
            {"audio_chunking": {"size": LONG_FRAMES}, "training": {"batch_size": 1},
             "data": {"path": os.path.join(long_dir, "pairs.json")},
             "checkpointing": {"dir": os.path.join(long_dir, "ckpt")}}))
        long_tr = Trainer(long_cfg, model, self.tok, device=DEVICE)
        long_tr.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        prof = None
        if kernel_prefix is not None:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA])
        t0 = time.perf_counter()
        with prof if prof is not None else contextlib.nullcontext():
            long_tr.train(self.loader(long_tr, long_cfg))
            torch.cuda.synchronize()
        long_s = time.perf_counter() - t0
        launches = dict(kernels.launch_counts)
        metrics_path = os.path.join(long_tr.checkpoint_dir, "metrics.jsonl")
        loss = [r["loss"] for r in map(json.loads, open(metrics_path)) if "loss" in r]
        ms = step_times(metrics_path)[LONG_FRAMES][0][0]
        peak = torch.cuda.max_memory_allocated() / 1e9
        log(f"  120000x1 {self.what} step: loss {loss}, step {ms:.2f} ms "
            f"({LONG_FRAMES * 0.01 / (ms / 1e3):.1f} audio-s/s), run {long_s:.2f} s, peak memory "
            f"{peak:.2f} GB, launches {launches}")
        if not (len(loss) == 1 and np.isfinite(loss[0])
                and launches == self.expected(launches, 1)):
            raise AssertionError(f"the 120000-frame {self.what} step failed")
        if prof is None:
            return None
        kernel_ms = sum(e.self_device_time_total for e in prof.key_averages()
                        if kernel_prefix in e.key) / 1e3
        log(f"  120000x1 {self.what} step (profiler on): {kernel_prefix}* kernels "
            f"{kernel_ms:.3f} ms of device time")
        return kernel_ms


def grad_error(g, ref, names):
    """(relative L2 error of the whole gradient, worst cosine over `names`, its
    tensor) of g against ref."""
    import torch

    den = sum((ref[n] ** 2).sum().item() for n in ref)
    num = sum(((g[n] - ref[n]) ** 2).sum().item() for n in ref)
    cos = {n: torch.nn.functional.cosine_similarity(g[n].flatten(), ref[n].flatten(), dim=0).item()
           for n in names}
    worst = min(cos, key=cos.get)
    return (num / den) ** 0.5, cos[worst], worst


def gradient_gate(what, ref_name, one_step, ref_ctx, yardsticks: dict, floors=(0.0, 0.0),
                  kernel_ctx=None, plain_contexts: bool = True):
    """One 16384 x 4 micro step with the kernels (inside `kernel_ctx`, when
    given), again (the step may not be reproducible), inside each context of
    `yardsticks` ({name: context}) and inside `ref_ctx` (the reference), on
    the same weights and batch.  `plain_contexts`: the yardsticks and the
    reference must launch no kernel (they are plain versions); False when the
    reference is another configuration of the kernels, whose launches the
    caller checks.  The loss must lie within LOSS_REL_MAX of the reference's;
    the gradient's relative L2 error and worst per-tensor cosine deficit
    (1 - cos) against the reference within `floors` + YARDSTICK_FACTOR times
    the largest of the yardsticks', and never past the absolute caps."""
    from lcasr_torch import kernels

    kernels.reset_launch_counts()
    with kernel_ctx or contextlib.nullcontext():
        loss_k, g_k = one_step()
        require_launches(True, f"{what} step")
        g_k2 = one_step()[1]
    kernels.reset_launch_counts()
    yard_steps = {}
    for name, ctx in yardsticks.items():
        with ctx:
            yard_steps[name] = one_step()
    with ref_ctx:
        loss_r, g_r = one_step()
    if plain_contexts:
        require_launches(False, f"{what} step inside {', '.join(yardsticks)} and {ref_name}")
    den = sum((g_r[n] ** 2).sum().item() for n in g_r)
    # cosines over the tensors whose gradient is not ~0 by construction (a
    # bias before BatchRenorm gets only rounding noise)
    names = [n for n in g_r if g_r[n].norm().item() > 1e-4 * den ** 0.5]
    kr, kc, kn = grad_error(g_k, g_r, names)
    rerun, rerun_c, _ = grad_error(g_k2, g_k, names)
    kl = abs(loss_k - loss_r) / abs(loss_r)
    yard = {name: (abs(loss - loss_r) / abs(loss_r), *grad_error(g, g_r, names))
            for name, (loss, g) in yard_steps.items()}
    yr = max(y[1] for y in yard.values())
    yd = max(1 - y[2] for y in yard.values())
    l2_max = min(GRAD_REL_L2_MAX, floors[0] + YARDSTICK_FACTOR * yr)
    cos_max = min(1 - GRAD_COS_MIN, floors[1] + YARDSTICK_FACTOR * yd)
    verdict = (f"16384x4 {what} step against {ref_name} (loss {loss_r:.4f}; cosines over "
               f"{len(names)} of {len(g_r)} tensors above 1e-4 of the global gradient norm): "
               f"kernels: loss rel {kl:.2e}, gradient rel L2 {kr:.3e} (a rerun of the kernel step "
               f"differs by {rerun:.3e}, worst cosine deficit {1 - rerun_c:.3e}), worst cosine "
               f"deficit {1 - kc:.3e} ({kn}); " + "; ".join(
                   f"{name} (yardstick): loss rel {yl:.2e}, gradient rel L2 {r:.3e}, worst cosine "
                   f"deficit {1 - c:.3e} ({n})" for name, (yl, r, c, n) in yard.items())
               + f"; gates: loss rel <= {LOSS_REL_MAX:g}, rel L2 <= {l2_max:.3e} = "
               f"min({GRAD_REL_L2_MAX:g}, {floors[0]:g} + {YARDSTICK_FACTOR:g} x the largest "
               f"yardstick's), 1 - cos <= {cos_max:.3e} = min({1 - GRAD_COS_MIN:g}, "
               f"{floors[1]:g} + {YARDSTICK_FACTOR:g} x the largest yardstick's)")
    log("  " + verdict)
    if not (kl <= LOSS_REL_MAX and kr <= l2_max and 1 - kc <= cos_max):
        raise AssertionError(f"{what} training step with the kernels disagrees with "
                             f"{ref_name}: " + verdict)
    return {"rel_l2": kr, "cos_deficit": 1 - kc, "rel_l2_max": l2_max, "cos_deficit_max": cos_max}


def phase_train(torch, workdir: str):
    import numpy as np

    from lcasr_torch import kernels
    from lcasr_torch.config import Config
    from lcasr_torch.models.registry import load_model
    from lcasr_torch.models.sconformer_xl import init_weights_
    from lcasr_torch.training.trainer import Trainer, make_chunks

    def fresh_model(seed, config):
        return init_weights_(load_model(config, 4095, device=DEVICE), seed=seed)

    run = TrainRun(torch, workdir, LADDER_CONFIG, fresh_model,
                   {"flash_attention_fwd": 18, "flash_attention_bwd_fused": 9}, "flagship")
    trainer, model, launches = run.ladder()

    # one 16384 x 4 micro step, kernels against plain fp32 attention; the
    # yardstick is plain attention in bf16 (the rounding alone)
    batch, chunk = run.chunk_16384x4()
    stats = [b.clone() for b in trainer._stat_buffers()]

    def one_step():
        trainer.zero_pending()
        loss, _ = trainer.micro_step(chunk)
        for b, old in zip(trainer._stat_buffers(), stats):
            b.copy_(old)
        return float(loss), flat_grads(model)

    gradient_gate("flagship", "plain fp32 attention", one_step, plain_attention(),
                  {"plain bf16 attention": plain_attention(bf16=True)})
    trainer.zero_pending()  # kept, the gradients would count in the 120000-frame step's peak

    t0 = time.perf_counter()
    make_chunks(*batch[:3], run.tok, PODCAST_FRAMES, 0, run.tok.pad_id())
    log(f"  make_chunks on the host (transcripts, BPE): {(time.perf_counter() - t0) * 1e3:.2f} ms")
    rows = run.timed_step(trainer, chunk, "train_profile.txt")
    k3_symbol = BWD_KERNELS["flash_attention_bwd_fused"][0].replace(" ", "")
    k3_rows = [r for r in rows if k3_symbol in r[2].replace(" ", "")]
    busy_us = sum(r[0] for r in rows)
    k3_step = {"ms": sum(r[0] for r in k3_rows) / 1e3, "launches": sum(r[1] for r in k3_rows),
               "share": sum(r[0] for r in k3_rows) / busy_us if busy_us else None}
    log(f"  K3 in the 16384x4 step's profile: {k3_step['ms']:.3f} ms in {k3_step['launches']} "
        f"launches, {k3_step['share']} of the device time")

    # the banded path: 2 full-width layers with a window, one step, K4 + K5
    band_cfg = Config(merged(run.cfg_d, {"model": {"n_layers": 2, "attention_window_size": 256}}))
    band = Trainer(band_cfg, fresh_model(2, band_cfg), run.tok, device=DEVICE,
                   checkpoint_dir=os.path.join(run.tmp, "ckpt_band"))
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

    run.long_step(model)
    return launches, band_launches, k3_step


# ---------------------------------------------------------------------------
# phases 8 and 9: the opt-in configuration (K2, K8) and the decoder's options
# ---------------------------------------------------------------------------
OPT_DECODE_LAUNCHES = {"flash_attention_fwd_db": EXPECTED_LAUNCHES,  # 9 layers x 4 batches
                       "subsampling_fused": 4}  # one per window batch
OPT_MAMBA_LAUNCHES = {"selective_scan_fwd": MAMBA_EXPECTED_DECODE_LAUNCHES,
                      "subsampling_fused": 4}
# one 16384 x 4 micro step under both flags: per layer K2 in the forward and
# again in the recompute, K3 once; the subsampling is checkpointed too
# (`remat_subsampling`), so K8 runs in the forward and again when the backward
# recomputes the subsampling's forward; its own backward is the conv chain's
OPT_TRAIN_LAUNCHES = {"flash_attention_fwd_db": 18, "flash_attention_bwd_fused": 9,
                      "subsampling_fused": 2}
PLAIN_ATTENTION_AGREEMENT = 0.94563  # K1 against plain attention on this batch (PERF.md)


def phase_decode_opt(torch):
    import numpy as np

    from lcasr_torch import kernels
    from lcasr_torch.evaluation.streaming import StreamingDecoder

    n_classes = 4096
    audio_s = TOTAL_FRAMES / FRAMES_PER_SECOND
    rtfx = lambda times: audio_s / float(np.median(times))
    spec = np.random.default_rng(2).normal(size=(1, 80, TOTAL_FRAMES)).astype(np.float32)
    model = flagship_model(torch)  # the weights of phase `decode`
    n_layers = len(model.layers)
    make = lambda **kw: StreamingDecoder(model, n_classes, window_batch_size=WINDOW_BATCH,
                                         device=DEVICE, **kw)
    decoder = make(transfer_dtype=torch.bfloat16)

    # the main path of this slice: the decode with both flags on
    with env_flags(**OPT_FLAGS):
        kernels.reset_launch_counts()
        ids_opt = decoder.greedy(spec, seq_len=SEQ_LEN, overlap=OVERLAP)
        launches = expect_launches(OPT_DECODE_LAUNCHES, "the decode under both flags")
    if ids_opt.ndim != 1 or ids_opt.shape[0] < TOTAL_FRAMES // 8 - 8:
        raise AssertionError(f"decode gave {ids_opt.shape} ids")
    if ids_opt.min() < 0 or ids_opt.max() >= n_classes:
        raise AssertionError("ids out of range")

    # one window batch, with the flags against without
    audio, lengths = window_batch(torch)
    with torch.no_grad():
        with env_flags(**OPT_FLAGS):
            kernels.reset_launch_counts()
            out = model(audio, length=lengths)
            expect_launches({"flash_attention_fwd_db": n_layers, "subsampling_fused": 1},
                            "one window batch under both flags")
        kernels.reset_launch_counts()
        lp_base = model(audio, length=lengths)["final_posteriors"]
        expect_launches({"flash_attention_fwd": n_layers}, "one window batch without the flags")
    if not torch.isfinite(out["final_posteriors"]).all():
        raise AssertionError("non-finite log-probs under the flags")
    agree, max_d, mean_d = logprob_agreement(torch, out["final_posteriors"], lp_base,
                                             out["length"], "both flags against none")
    log(f"  one window batch, both flags against none: argmax agreement {agree:.5f} (the "
        f"kernel against plain attention gave {PLAIN_ATTENTION_AGREEMENT}), max|dlogp| {max_d:.4f}, "
        f"mean|dlogp| {mean_d:.2e}; gate: agreement >= 0.9, max <= 1.0, mean <= 0.05")
    del audio, out, lp_base

    # RTFx without and with the flags, in turns
    ids_base, t_base = timed_decodes(decoder, spec)
    with env_flags(**OPT_FLAGS):
        ids_again, t_opt = timed_decodes(decoder, spec)
        profile_run(torch, lambda: decoder.greedy(spec, seq_len=SEQ_LEN, overlap=OVERLAP),
                    "decode_opt_profile.txt", "one decode under both flags")
    if not np.array_equal(ids_again, ids_opt):
        raise AssertionError("repeated decodes under the flags differ")
    same = float((ids_opt == ids_base).mean())
    log(f"  20-minute decode under both flags: launches {launches}; decode s "
        f"{[round(t, 4) for t in t_opt]}, RTFx (median of 3) {rtfx(t_opt):.1f}; without the "
        f"flags {[round(t, 4) for t in t_base]}, RTFx {rtfx(t_base):.1f}; ids agree at "
        f"{same:.5f}")

    # the decoder's options, flags off
    results = {"rtfx_flags": rtfx(t_opt), "rtfx_no_flags": rtfx(t_base), "ids_agreement": same}
    for kind in ("int8", "int4"):
        kernels.reset_launch_counts()
        ids_q, t_q = timed_decodes(make(transfer_dtype=kind), spec)
        results[f"{kind}_agreement"] = float((ids_q == ids_base).mean())
        log(f"  {kind} upload: ids agree with the bf16-upload decode at "
            f"{results[f'{kind}_agreement']:.5f}; decode s {[round(t, 4) for t in t_q]}, RTFx "
            f"{rtfx(t_q):.1f}")
        if ids_q.shape != ids_base.shape:
            raise AssertionError(f"the {kind} decode gave {ids_q.shape} ids")
    ids_p, t_p = timed_decodes(make(transfer_dtype=torch.bfloat16, pipeline_upload=True), spec)
    if not np.array_equal(ids_p, ids_base):
        raise AssertionError("pipeline_upload changed the ids")
    log(f"  pipeline_upload: ids equal to the single-upload decode; decode s "
        f"{[round(t, 4) for t in t_p]}, RTFx {rtfx(t_p):.1f}")
    cached = make(transfer_dtype=torch.bfloat16, cache_upload=True)
    t0 = time.perf_counter()
    ids_c1 = cached.greedy(spec, seq_len=SEQ_LEN, overlap=OVERLAP)
    t_first = time.perf_counter() - t0
    ids_c2, t_c = timed_decodes(cached, spec)
    if not (np.array_equal(ids_c1, ids_base) and np.array_equal(ids_c2, ids_base)):
        raise AssertionError("cache_upload changed the ids")
    log(f"  cache_upload on one array: first decode {t_first:.4f} s, later ones (no upload) "
        f"{[round(t, 4) for t in t_c]} s, RTFx {rtfx(t_c):.1f}")
    results.update(rtfx_pipeline=rtfx(t_p), rtfx_cached=rtfx(t_c))
    del model, decoder, cached

    # the Mamba family shares ConvSubsampling: its decode under LCASR_FUSED_SUB=1
    mamba = mamba_model(torch)
    mdec = StreamingDecoder(mamba, n_classes, window_batch_size=WINDOW_BATCH,
                            transfer_dtype=torch.bfloat16, device=DEVICE)
    ids_m, t_m = timed_decodes(mdec, spec)
    with env_flags(LCASR_FUSED_SUB="1"):
        kernels.reset_launch_counts()
        ids_mf = mdec.greedy(spec, seq_len=SEQ_LEN, overlap=OVERLAP)
        mamba_launches = expect_launches(OPT_MAMBA_LAUNCHES, "the Mamba decode under LCASR_FUSED_SUB=1")
        _, t_mf = timed_decodes(mdec, spec)
        profile_run(torch, lambda: mdec.greedy(spec, seq_len=SEQ_LEN, overlap=OVERLAP),
                    "mamba_decode_opt_profile.txt", "one Mamba decode under LCASR_FUSED_SUB=1")
    log(f"  Mamba 20-minute decode under LCASR_FUSED_SUB=1: launches {mamba_launches}; decode s "
        f"{[round(t, 4) for t in t_mf]}, RTFx {rtfx(t_mf):.1f}; without the flag "
        f"{[round(t, 4) for t in t_m]}, RTFx {rtfx(t_m):.1f}; ids agree at "
        f"{float((ids_mf == ids_m).mean()):.5f}")
    results.update(rtfx_mamba_flag=rtfx(t_mf), rtfx_mamba_no_flag=rtfx(t_m))
    return launches, mamba_launches, results


def phase_train_opt(torch, workdir: str):
    """One 16384 x 4 flagship training step under both flags, and under each
    flag alone, against the same step without them.  K2 is bit-equal to K1
    (phase `kernels`), so the step under LCASR_ATTN_FWD_DB=1 alone may differ
    from the unflagged step only as two runs of that step differ (K3's dq
    leaves through fp32 atomics): its yardstick is a rerun.  K8 rounds where
    the bf16 conv chain rounds but sums in another order; the steps with K8
    are held against two other computations of the same chain: in fp32, and
    in bf16 by PyTorch's own convolution kernels instead of cuDNN's."""
    from lcasr_torch import kernels
    from lcasr_torch.models.registry import load_model
    from lcasr_torch.models.sconformer_xl import init_weights_
    from lcasr_torch.training.trainer import Trainer

    def fresh_model(seed, config):
        return init_weights_(load_model(config, 4095, device=DEVICE), seed=seed)

    run = TrainRun(torch, workdir, LADDER_CONFIG, fresh_model, OPT_TRAIN_LAUNCHES, "flagship")
    model = fresh_model(0, run.cfg)
    trainer = Trainer(run.cfg, model, run.tok, device=DEVICE)
    trainer.init_state()
    _, chunk = run.chunk_16384x4()
    stats = [b.clone() for b in trainer._stat_buffers()]

    def one_step():
        trainer.zero_pending()
        loss, _ = trainer.micro_step(chunk)
        for b, old in zip(trainer._stat_buffers(), stats):
            b.copy_(old)
        return float(loss), flat_grads(model)

    with env_flags(**OPT_FLAGS):
        kernels.reset_launch_counts()
        one_step()
        launches = expect_launches(OPT_TRAIN_LAUNCHES, "one micro step under both flags")
    kernels.reset_launch_counts()
    one_step()
    expect_launches({"flash_attention_fwd": OPT_TRAIN_LAUNCHES["flash_attention_fwd_db"],
                     "flash_attention_bwd_fused": OPT_TRAIN_LAUNCHES["flash_attention_bwd_fused"]},
                    "one micro step without the flags")
    log(f"  one 16384x4 micro step under both flags: launches {launches}")
    unflagged = "the same step without the flags"
    conv_chains = lambda: {"the conv chain in fp32": fp32_subsampling(),
                           "the bf16 conv chain without cuDNN": subsampling_without_cudnn()}
    gates = {
        "K2": gradient_gate("flagship under LCASR_ATTN_FWD_DB=1", unflagged, one_step,
                            contextlib.nullcontext(), {"a rerun": contextlib.nullcontext()},
                            kernel_ctx=env_flags(LCASR_ATTN_FWD_DB="1"), plain_contexts=False),
        "K8": gradient_gate("flagship under LCASR_FUSED_SUB=1", unflagged, one_step,
                            contextlib.nullcontext(), conv_chains(),
                            kernel_ctx=env_flags(LCASR_FUSED_SUB="1"), plain_contexts=False),
        "both": gradient_gate("flagship under both flags", unflagged, one_step,
                              contextlib.nullcontext(), conv_chains(),
                              kernel_ctx=env_flags(**OPT_FLAGS), plain_contexts=False),
    }
    trainer.zero_pending()
    return launches, gates


# one 16384 x 4 Mamba step: kernel and plain scan are both fp32 scans inside a
# bf16 model, so the reference is the plain scan in fp64 and the yardstick the
# plain scan in fp32; these floors keep the gate meaningful where the
# yardstick's own error is next to nothing
MAMBA_REL_L2_FLOOR, MAMBA_COS_FLOOR = 1e-3, 1e-5


def phase_mamba_train(torch, workdir: str):
    n_layers = MAMBA_CONFIG["model"]["n_layers"]
    remat = MAMBA_CONFIG["model"]["checkpoint_every_n_layers"] == 1
    # a recomputed block runs K6 in the forward and again in the backward
    run = TrainRun(torch, workdir, MAMBA_CONFIG, lambda seed, config: mamba_model(torch, seed),
                   {"selective_scan_fwd": n_layers * (2 if remat else 1),
                    "selective_scan_bwd": n_layers}, "Mamba")
    trainer, model, launches = run.ladder()
    _, chunk = run.chunk_16384x4()

    def one_step():
        trainer.zero_pending()
        loss, _ = trainer.micro_step(chunk)
        return float(loss), flat_grads(model)

    gradient_gate("Mamba", "the plain scan in fp64", one_step, plain_scan(torch.float64),
                  {"the plain scan in fp32": plain_scan(torch.float32)},
                  floors=(MAMBA_REL_L2_FLOOR, MAMBA_COS_FLOOR))
    trainer.zero_pending()
    rows = run.timed_step(trainer, chunk, "mamba_train_profile.txt")
    prefix = SSM_KERNELS["selective_scan_bwd"][0]
    k7_rows = [r for r in rows if prefix in r[2]]
    busy_us = sum(r[0] for r in rows)
    k7_step = {"ms": sum(r[0] for r in k7_rows) / 1e3,
               "launches": sum(r[1] for r in k7_rows),
               "share": sum(r[0] for r in k7_rows) / busy_us if busy_us else None}
    log(f"  K7 in the 16384x4 Mamba step's profile: {k7_step['ms']:.3f} ms in "
        f"{k7_step['launches']} kernel launches (5 per call), {k7_step['share']} of the device time")
    k7_step["long_step_ms"] = run.long_step(model, kernel_prefix=prefix)
    return launches, k7_step


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES))
    args = parser.parse_args()
    phases = args.phases.split(",")
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        parser.error(f"unknown phases {unknown}; choose from {', '.join(PHASES)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lcasr_torch import kernels  # fails when the repo is not beside this file

    # fp32 references are fp32: no TF32 in matrix products or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    log("[1/9] build")
    build_s = kernels.build()
    log(f"  build {build_s:.2f} s into {kernels.BUILD_DIR}")
    for src, text in kernels.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  {src}: {line.strip()}")
    hopper_build = check_hopper_build(kernels.build_log)
    for src, entries in hopper_build.items():
        for fn, e in entries.items():
            log(f"  {src}: {fn}: {e} (no serialised wgmma, setmaxnreg kept)")
    log(f"  gpu: {gpu}")

    results = {}
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke_train")
    if "kernels" in phases:
        log("[2/9] kernels against their plain versions")
        results["flash_attention_fwd"] = phase_kernels(torch)
        results["flash_attention_fwd_db"] = phase_kernels_db(torch)
        bwd_registers = {name: e.get("registers") for name, e in
                         template_entries(kernels.build_log["flash_attn_bwd.cu"]).items()}
        results.update(phase_kernels_bwd(torch, bwd_registers))
        results.update(phase_kernels_ssm(torch))
        results["subsampling_fused"] = phase_kernels_sub(torch)
    model = None
    if "model" in phases:
        log("[3/9] flagship model, one window batch")
        model = flagship_model(torch)
        phase_model(torch, model, plain_attention(), "flagship")
    if "decode" in phases:
        log("[4/9] 20-minute streaming greedy decode (the serving path)")
        model = model or flagship_model(torch)
        launches, _, rows = phase_decode(torch, model,
                                         {"flash_attention_fwd": EXPECTED_LAUNCHES},
                                         "flagship", "decode_profile.txt")
        k1 = results.setdefault("flash_attention_fwd", {"name": "flash_attention_fwd"})
        k1["launches"] = launches["flash_attention_fwd"]
        # K1's device time per launch inside the decode, from its profile
        rows = [r for r in rows if HOPPER_FWD_SYMBOL in r[2]]
        k1["decode_profile_ms"] = (sum(r[0] for r in rows) / sum(r[1] for r in rows) / 1e3
                                   if rows else None)
        log(f"  K1 in the decode's profile: {k1['decode_profile_ms']} ms per launch "
            f"(kernel phase, launches back to back: {k1.get('ms')} ms)")
    del model
    if "train" in phases:
        log("[5/9] training: the ladder Trainer, 8192x8 -> 16384x4, then 120000x1 "
            "(the training path)")
        os.makedirs(workdir, exist_ok=True)
        try:
            ladder, banded, k3_step = phase_train(torch, workdir)
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
        results["flash_attention_bwd_fused"]["train_step_profile"] = k3_step
    if "mamba_decode" in phases:
        log("[6/9] Mamba: one window batch, then the 20-minute streaming greedy decode")
        model = mamba_model(torch)
        phase_model(torch, model, plain_scan(torch.float32), "Mamba")
        launches, _, _ = phase_decode(torch, model,
                                      {"selective_scan_fwd": MAMBA_EXPECTED_DECODE_LAUNCHES},
                                      "Mamba", "mamba_decode_profile.txt")
        del model
        results.setdefault("selective_scan_fwd", {"name": "selective_scan_fwd"})[
            "launches"] = launches["selective_scan_fwd"]
    if "mamba_train" in phases:
        log("[7/9] Mamba training: the ladder Trainer, 8192x8 -> 16384x4, then 120000x1")
        os.makedirs(workdir, exist_ok=True)
        try:
            ladder, k7_step = phase_mamba_train(torch, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        # K7 runs only in training: its count is the ladder run's
        k7 = results.setdefault("selective_scan_bwd", {"name": "selective_scan_bwd"})
        k7["launches"] = ladder["selective_scan_bwd"]
        k7["train_step_profile"] = k7_step
        results.setdefault("selective_scan_fwd", {"name": "selective_scan_fwd"})[
            "launches_ladder"] = ladder["selective_scan_fwd"]
    if "decode_opt" in phases:
        log("[8/9] the opt-in decode configuration (K2, K8) and the decoder's options")
        launches, mamba_launches, numbers = phase_decode_opt(torch)
        for key in ("flash_attention_fwd_db", "subsampling_fused"):
            results.setdefault(key, {"name": key})["launches"] = launches[key]
        results["subsampling_fused"]["launches_mamba_decode"] = mamba_launches["subsampling_fused"]
        results["subsampling_fused"].update(numbers)
    if "train_opt" in phases:
        log("[9/9] one training step under both flags, and under each alone, against the "
            "same step without")
        os.makedirs(workdir, exist_ok=True)
        try:
            launches, gates = phase_train_opt(torch, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        for key, gate in (("flash_attention_fwd_db", "K2"), ("subsampling_fused", "K8")):
            entry = results.setdefault(key, {"name": key})
            entry["launches_train_step"] = launches[key]
            entry["train_step_alone"] = gates[gate]
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
