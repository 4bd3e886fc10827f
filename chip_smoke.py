#!/usr/bin/env python3
"""Drive the lcasr_torch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py                  # every phase, as a check of the port
    python3 chip_smoke.py --phases kernels # build + kernel checks only
    python3 chip_smoke.py --phases train   # build + the training path only
    python3 chip_smoke.py --phases train_d256,utterances  # head_dim 256, utterances
    python3 chip_smoke.py --phases mamba_decode,mamba_train  # the Mamba family only
    python3 chip_smoke.py --phases decode_opt,train_opt  # the opt-in configuration only
    python3 chip_smoke.py --phases audio,serve   # WAV -> WER and the server only
    python3 chip_smoke.py --phases enc_dec       # the encoder-decoder family only
    python3 chip_smoke.py --phases lm            # decoding with a language model only
    python3 chip_smoke.py --phases parallel      # the ring schedule and a world of one
    python3 chip_smoke.py --phases analysis,variants,adapt  # analysis, W8A8, long conv, adaptation
    python3 chip_smoke.py --phases tooling       # preprocessing, tokenizer, averaging, profiling
    python3 chip_smoke.py --phases kernels --scan_source OLD.cu  # K6/K7 bits against OLD.cu's
    python3 chip_smoke.py --phases ctc           # the CTC kernels at the two training lattices
    python3 chip_smoke.py --phases norms         # the row-norm kernels at the decode's rows

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
              and K5's those of K3; K6's y and states and K7's five gradients
              the same bits in two runs; K6's grids at the four main shapes
              logged, each launch a block for every SM; the build fails on
              serialised wgmma or spills in the bf16 entries of K1-K5 (their
              head_dim 256 instantiations among them); K1 and K2 again at
              head_dim 256 (64-key tiles: bf16 and fp32, ragged, banded,
              offset; timed at (16, 2048, 3, 256) beside the bound and
              SDPA); K3 and K4 + K5 at head_dim 256 on their own cases
              (bf16 and fp32, ragged, T off the tiles, bands with tile skip,
              offsets; the same bits in two runs) and timed at
              (4, 2048, 3, 256) beside the bound and cuDNN; K6 and K7 at
              d_state 8 (padded to 16), 32 and 64 on edge cases and at the
              decode and training shapes (the same gates; device ms, bound,
              plain ms, registers and spills per instantiation); the
              class-default Mamba, its mixers at d_state 32: the 20-minute (24
              K6) and a 16384 x 4 micro step (12 K6, 6 K7) gated against the
              plain scan in fp64;
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
              attention (loss and whole gradient); make_chunks with the
              Python and the native BPE; the same step under remat_policy
              "dots" (18 K1 and 9 K3 launches: K1 is recomputed; its peak
              memory beside "nothing"'s, its gradient held to "nothing"'s); a
              profile of that step; a banded 2-layer step (K4 + K5); epochs
              at 16384 x 4 with the Python data path (no prefetch, Python
              BPE, np.load) and the native one (prefetch thread, native BPE
              and .npy reader), in turns, with the device's idle share; one
              120,000 x 1 step;
  6. train_d256  lcasr_6l_768d_3h (6 layers, 3 heads x 256) on the ladder
              configuration: one 16384 x 4 micro step (12 K1, 6 K3 launches)
              against plain fp32 attention, optimizer steps with a falling
              loss, the steady step's wall and device busy time;
  7. utterances  64 seeded utterances written by save_utterances, the
              flagship trained on them by Trainer.train_utterances with
              debug_hooks on (4 steps, finite losses and gradient norms);
              wctc_loss on the card against the CPU in its three modes;
  8. mamba_decode  the full-width bidirectional Mamba (6 layers, d_model 768,
              bf16, random weights from a seed): one window batch with the
              kernel against the plain scan, then the same 20-minute
              streaming decode as phase 4 (6 layers x 4 window batches = 24
              K6 launches), RTFx as the median of 3, K6's share of its profile;
  9. mamba_train  the Trainer with model_class Mamba on the same ladder and
              corpus as phase 5: launch counts (K6 twice per layer and micro
              step under full remat, K7 once), save / resume, one 16384 x 4
              step with the kernels against the plain scan (loss and whole
              gradient), a profile of that step (K6's and K7's device time
              and share), one 120,000 x 1 step under the profiler (K6's and
              K7's device time); make_chunks both ways and the epochs on both
              data paths, as in phase 5;
 10. decode_opt  the flagship's opt-in decode configuration
              (LCASR_ATTN_FWD_DB=1, LCASR_FUSED_SUB=1; both set and restored
              inside the phase): the 20-minute decode through K2 and K8 (36
              and 4 launches, K1 none), one window batch with the flags
              against without, RTFx with and without; then, flags off, the
              decoder's options: int8 and int4 upload, pipeline_upload,
              cache_upload; then the Mamba's decode with LCASR_FUSED_SUB=1
              (24 K6 and 4 K8 launches);
 11. train_opt  one 16384 x 4 flagship training step under both flags (K2,
              K3 on K2's lse, K8 and its recomputing backward), and under
              each flag alone, against the same step without them (loss and
              whole gradient): K2 alone within a rerun's difference, the
              steps with K8 within that of two other computations of the
              conv chain.
 12. audio    a seeded 20-minute stereo WAV at 44.1 kHz (`--seed`): the
              port's reader on the host (both channels, then the left one
              alone, in turns; the same mel), its resampler and mel frontend on
              the card (timed; held against the plain float64 frontend on
              the CPU); `evaluate` from that file to a WER with the
              flagship (36 K1 launches), `evaluate` on `synthetic` at
              120,000 frames in its three modes (36, 531 and 9 K1
              launches), and the head_dim-256 model lcasr_6l_768d_3h from
              the file (24 K1 launches; 24 K2 under LCASR_ATTN_FWD_DB=1);
 13. serve    the flagship behind a TranscriptionServer: 4 sessions fed 60 s
              each in 0.5 s chunks, each session's ids equal to a
              single-stream OnlineTranscriber's, pump latency and RTFx;
              then `python -m lcasr_torch.serving` on a 30 s WAV file.
 14. enc_dec  the encoder-decoder family at its class defaults (6 + 6
              layers, d_model 768, 6 heads x 128, random weights from a
              seed): EncDecSconformer and V2 forwards on a (4, 80, 16384)
              batch with 384 ids (6 K1 launches each, CTC and decoder
              log-probs against plain attention); greedy decoding of a
              16384-frame recording, max 256 tokens: in fp32 the cached and
              full-prefix ids equal and every cached step's logits the full
              pass's, in bf16 timed (encoder ms, ms a token both ways, host
              synchronisations, idle share); the Trainer with loss_mode
              enc_dec on the ladder (6 K1 + 6 K3 a micro step, gradient gate
              against plain attention, save / resume, peak memory, step wall
              and device busy time; a fresh model's loss falling over 5
              steps on one chunk); the V2
              internal-LM ctc_beam_search in fp32 (text equal to plain
              attention's).
 15. lm       decoding with a language model: train_lm at the TransformerLM
              defaults (6 layers, width 512, 8 heads x 64, fp32; batch 32 of
              <= 257 tokens) for 50 steps on a seeded corpus, loss falling,
              the checkpoint reloaded with equal logits; 25 rows x 256 cached
              steps against one full pass, and forked prefixes through
              pos_row / write_rows; create_logits with the flagship (CTC head
              gain LM_CTC_HEAD_GAIN) on two synthetic 120,000-frame
              recordings (36 K1 launches each, no plain attention), the
              candidates a frame; beam_stage at width 25, alpha 0.45, beta
              1.53 on cuts of the dumped frames: host frame-sync and the
              device search (ids equal), rescore_many with 1 slot and with 4
              (ids equal), the prefix search with the LM scorer, the native
              no-LM prefix beam against its Python path; then the flagship
              behind a TranscriptionServer with decoder="beam" (4 sessions
              x 60 s, width 25, top-K 32), each session's text equal to an
              offline BeamSearch over its single-stream log-probs.
 16. parallel the parallel layer on one card (multi-rank runs need one card a
              rank; the CPU tests hold them): every rank's schedule of an
              8-rank ring at the flagship's 20-minute attention (1, 15000,
              6, 128) bf16, blocks of 1,875, with and without a (256, 256)
              band, against one kernel over the sequence (8 K1 a rank
              forward, 8 K3 or 8 K4 + 8 K5 backward; ms both ways); then a
              world of one over NCCL and the mesh {data 1, model 1, seq 1}:
              the flagship 16384 x 4 micro step against the same step
              without a mesh (gradient gate, equal launch counts),
              lcasr_3l_2048d_16h_tp at full width, one optimizer step with
              zero_optimizer against the same step without a mesh (peak
              memory), the 20-minute mesh decode (ids equal to
              StreamingDecoder's) and the context-parallel single pass over
              120,000 frames against the windowed one.
 17. analysis the paper's question on the flagship: attention_summary over a
              seeded one-hour (360,000-frame) spectrogram in one pass (one
              capture forward and one lse launch of K1 a layer; row blocks of
              512 against T' = 45,000, top 8; each layer's mean entropy and
              expected distance), attention_prob_rows of 256 rows in two
              layers against plain fp32 attention on the same captured q, k,
              context_attribution of the middle frame of 16,384 frames (K1
              and K3) held by the gradient gate against plain attention, the
              rotary interpolation probe at factors 1, 2, 4, 8.
 18. variants the 20-minute flagship decode under quant_w8a8 False, "auto"
              and True (RTFx, ids equal to bf16's, 36 K1 each); the int8
              product at fc1's shape bit-equal to the host's; the Mamba (K6),
              EncDecSconformer and TransformerLM forwards at their class
              defaults under W8A8; conv_type longconv at the flagship's width:
              a 16384 x 4 forward and micro step (gated against plain
              attention), and a forward with the direct kernel and frequency
              smoothing.
 19. adapt    SCConformerMeta at its class defaults: MetaTrainer over 16
              seeded 2,048-frame utterances (the frozen parameters the same
              bits after), refine_at_inference; dynamic evaluation of the
              flagship over 36,864 frames at lr 0 (equal to the averaged
              decode) and 8e-5 (moved), the model the same bits after each;
              SelfTrainWrapper on 16,384 frames.
 20. tooling  the host tooling on one path: four seeded 180 s 44.1 kHz WAVs
              preprocessed in two shards on the card (each fp16 .spec.npy
              against the CPU frontend), paired with seeded speaker-tagged
              transcripts, a tokenizer of at most 512 pieces trained on
              them (native and Python encodes equal); the flagship trained two steps in each
              of two seed repeats (18 K1 and 9 K3 a micro step), their
              average equal to the float64 mean bit for bit and loaded
              strictly; one recording decoded under `profiling.trace` (K1's
              rows in the trace), `time_fn` of that decode and
              `time_fn_chain` of K1; the spare components at width 768 on
              (4, 16384, .) against the CPU.  The launcher and `restart`
              (pyyaml) and the download (the network) are left to the CPU
              tests.
 21. ctc      the CTC kernels at the one-hour and 16384 x 22 lattices,
              against PyTorch's CTC.
 22. norms    the row-norm kernels (LayerNorm and RMSNorm, forward and
              backward) at (32768, 768) and (32768, 1024) bf16 against the
              eager versions; device ms beside the byte bound, the eager
              chain's and F.layer_norm / F.rms_norm's (the yardstick).

Each phase's seconds are printed as it ends.

The line before the last two is one JSON object with each kernel's numbers;
the last line is the device record.  Without a GPU, or without the repo
beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

PHASES = ("kernels", "model", "decode", "train", "train_d256", "utterances", "mamba_decode",
          "mamba_train", "decode_opt", "train_opt", "audio", "serve", "enc_dec", "lm",
          "parallel", "analysis", "variants", "adapt", "tooling", "ctc", "norms")

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


def device_kernel_totals(torch, fn, n: int = 10, attempts: int = 3) -> dict:
    """{kernel name: (device microseconds, launches)} over n calls of fn
    (torch.profiler), after one warm call.  Now and then a profiler window on
    the H100 machine holds no device activity at all, though fn launched
    kernels: such a window is taken again, up to `attempts` windows."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        totals = {e.key: (e.self_device_time_total, e.count) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0}
        if totals:
            break
    return totals


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
    # the head_dim 256 instantiations (64-key tiles; K4 32-key tiles) are
    # among them
    for src, want in (("flash_attn_fwd.cu", (f"{HOPPER_FWD_SYMBOL}<256, false>",)),
                      ("flash_attn_fwd_db.cu", (f"{HOPPER_FWD_SYMBOL}<256, true>",)),
                      ("flash_attn_bwd.cu", (f"{HOPPER_BWD_SYMBOL}<256, true>",
                                             f"{HOPPER_BWD_SYMBOL}<256, false>",
                                             f"{HOPPER_DQ_SYMBOL}<256>"))):
        entries = template_entries(build_log[src])
        for name in want:
            if name not in entries:
                raise AssertionError(f"{src}: no {name} in ptxas's report")
            log(f"  {src}: {name}: {entries[name]}")
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


def check_layout_refused(torch, kernel: str, D: int = 128):
    """A bf16 view whose H stride is odd (not a multiple of 16 bytes) cannot
    be read by a TMA tensor map: the wrapper must raise and launch nothing."""
    from lcasr_torch import kernels
    from lcasr_torch.ops.flash_attention import flash_attention_with_lse

    x = torch.randn((2, 64, 2, D + 1), device="cuda").to(torch.bfloat16)[..., :D]
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
# phase 2a'': K1 and K2 at head_dim 256 (64-key tiles), the forward only
# ---------------------------------------------------------------------------
D256_SHAPE = (16, 2048, 3, 256)  # lcasr_6l_768d_3h's window batch: 3 heads x 256


def d256_cases(torch):
    """K1 / K2 cases at D = 256 (`attention_cases`' tuple), at the edges of
    its 64-key tiles: ragged lengths with a zero, T off the tile grid, a band
    whose tiles are skipped, q/kv offsets, fp32 (the SIMT bodies' largest
    tiles), the decode's shape and its last batch."""
    bf, f32 = torch.bfloat16, torch.float32
    B, T, H, D = D256_SHAPE
    decode_last = [2048, 2048, 2048, 1944] + [0] * 12
    return [
        ("D256_decode_shape_full", B, T, H, D, bf, None, (-1, -1), 0, 0, True),
        ("D256_decode_last_batch", B, T, H, D, bf, decode_last, (-1, -1), 0, 0, True),
        ("D256_ragged_with_zero", 3, 200, 2, D, bf, [200, 131, 0], (-1, -1), 0, 0, False),
        ("D256_T_not_multiple_of_64", 2, 333, 3, D, bf, [333, 100], (-1, -1), 0, 0, False),
        ("D256_T65", 2, 65, 2, D, bf, [65, 64], (-1, -1), 0, 0, False),
        ("D256_T191", 2, 191, 2, D, bf, [191, 129], (-1, -1), 0, 0, True),
        ("D256_band_256_256", 2, 1000, 2, D, bf, [1000, 700], (256, 256), 0, 0, False),
        ("D256_band_left_only", 2, 300, 2, D, bf, [300, 211], (64, -1), 0, 0, False),
        # rows 128.. begin their window at key 64.., a tile edge
        ("D256_left_window_on_tile_edge", 2, 384, 2, D, bf, [384, 300], (64, -1), 0, 0, False),
        ("D256_q_kv_offsets", 2, 300, 2, D, bf, [320, 150], (-1, -1), 37, 20, False),
        ("D256_offsets_band", 2, 300, 2, D, bf, [300, 250], (40, 30), 37, 20, False),
        ("D256_shard_offsets_64", 2, 300, 2, D, bf, [364, 280], (-1, 40), 64, 64, True),
        ("D256_fp32", 2, 333, 2, D, f32, [333, 120], (-1, -1), 0, 0, True),
        ("D256_fp32_band", 2, 300, 2, D, f32, [300, 0], (32, 8), 5, 0, False),
        ("D256_fp32_offsets", 2, 130, 2, D, f32, [150, 129], (-1, -1), 20, 10, False),
    ]


def phase_kernels_d256(torch, registers: dict):
    """K1 and K2 at D = 256 against `flash_attention_ref` on `d256_cases`
    (K2 on the cases not banded on both sides, bit-equal to K1 on the bf16
    ones), the refused layout; then device time at
    (16, 2048, 3, 256) in turns (K1, K2, SDPA, K2, K1) beside the bound.
    `registers`: ptxas's entries of flash_attn_fwd{,_db}.cu's templates.
    Returns {kernel name: its D = 256 numbers}."""
    import torch.nn.functional as F

    from lcasr_torch.ops.flash_attention import flash_attention_ref

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = {"flash_attention_fwd": 0.0, "flash_attention_fwd_db": 0.0}
    for case in d256_cases(torch):
        err_o, err_lse, _ = check_attention_case(torch, case, gen, "flash_attention_fwd")
        if case[5] == bf:
            worst["flash_attention_fwd"] = max(worst["flash_attention_fwd"], err_o, err_lse)
    db_cases = [c for c in d256_cases(torch) if not (c[7][0] >= 0 and c[7][1] >= 0)]
    with env_flags(LCASR_ATTN_FWD_DB="1"):
        for case in db_cases:
            err_o, err_lse, _ = check_attention_case(torch, case, gen, "flash_attention_fwd_db")
            if case[5] == bf:
                worst["flash_attention_fwd_db"] = max(worst["flash_attention_fwd_db"],
                                                      err_o, err_lse)
    for case in (c for c in db_cases if c[5] == bf):
        require_k2_equals_k1(torch, case, gen)
    log(f"  D = 256: K2 bit-equal to K1 on {sum(c[5] == bf for c in db_cases)} bf16 cases")
    check_layout_refused(torch, "flash_attention_fwd", D=256)
    with env_flags(LCASR_ATTN_FWD_DB="1"):
        check_layout_refused(torch, "flash_attention_fwd_db", D=256)

    B, T, H, D = D256_SHAPE
    q, k, v = make_qkv(torch, B, T, H, D, bf, True, gen)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    e1, e2 = fwd_entry(torch, q, k, v), fwd_entry(torch, q, k, v, db=True)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)
    d1a, d2a = device_ms(torch, e1), device_ms(torch, e2)
    library_ms = device_ms(torch, sdpa)
    d2b, d1b = device_ms(torch, e2), device_ms(torch, e1)
    plain_ms = time_ms(torch, lambda: flash_attention_ref(q, k, v), n=3, warmup=1)
    bound_ms, bound_by, flops = attention_bound(B, T, H, D)
    out = {}
    for name, (a, b_), flag in (("flash_attention_fwd", (d1a, d1b), "false"),
                                ("flash_attention_fwd_db", (d2a, d2b), "true")):
        ms = min(a, b_)
        entry = registers.get(f"flash_fwd_hopper<256, {flag}>", {})
        out[name] = {"ms_d256": ms, "ms_d256_turns": [a, b_], "bound_ms_d256": bound_ms,
                     "bound_by_d256": bound_by, "plain_ms_d256": plain_ms,
                     "library_ms_d256": library_ms, "max_abs_err_d256": worst[name],
                     "registers_d256": entry.get("registers"),
                     "spill_bytes_d256": entry.get("spill_stores", 0) + entry.get("spill_loads", 0)}
        log(f"  {name} at {D256_SHAPE} bf16: device {a:.4f} / {b_:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% of its bound), "
            f"scaled_dot_product_attention {library_ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}); ptxas {entry}")
    return out


# ---------------------------------------------------------------------------
# phase 2b: flash-attention backward (K3, K4, K5) against its plain version
# ---------------------------------------------------------------------------
BWD_KERNELS = {  # launch-count name -> (kernel symbol, Pallas body it replaces)
    "flash_attention_bwd_fused": ("flash_bwd_hopper<128, true>", 666, "_bwd_fused_kernel"),
    "flash_attention_bwd_dq": ("flash_bwd_dq_hopper<128>", 484, "_bwd_dq_kernel"),
    "flash_attention_bwd_dkv": ("flash_bwd_hopper<128, false>", 569, "_bwd_dkv_kernel"),
}
TRAIN_ATTN_SHAPE = (4, 2048, 6, 128)  # (B, T, H, D): a 16384-frame x 4 chunk
# lcasr_6l_768d_3h's 16384 x 4 chunk: 3 heads x 256, the work of the shape above
D256_TRAIN_ATTN_SHAPE = (4, 2048, 3, 256)


def bwd_d256_cases(torch):
    """Backward cases at D = 256 (`attention_cases`' tuple), at the edges of
    its tiles (K3 / K5: 64 keys a CTA, 64-row q tiles; K4: 128 q rows a CTA,
    32-key tiles): a training chunk with ragged lengths, a zero length, T off
    the tile grid, two-sided bands whose tiles are skipped (K4 + K5 only), a
    left-only band, q/kv offsets, fp32 (the SIMT bodies at eight threads a
    row)."""
    bf, f32 = torch.bfloat16, torch.float32
    B, T, H, D = D256_TRAIN_ATTN_SHAPE
    return [
        ("D256_train_ragged", B, T, H, D, bf, [2048, 1901, 1500, 777], (-1, -1), 0, 0, True),
        ("D256_ragged_with_zero", 3, 200, 2, D, bf, [200, 131, 0], (-1, -1), 0, 0, False),
        ("D256_T_not_multiple_of_64", 2, 333, 3, D, bf, [333, 100], (-1, -1), 0, 0, False),
        ("D256_T63", 2, 63, 2, D, bf, [63, 40], (-1, -1), 0, 0, False),
        ("D256_T65", 2, 65, 2, D, bf, [65, 64], (-1, -1), 0, 0, False),
        ("D256_T191", 2, 191, 2, D, bf, [191, 129], (-1, -1), 0, 0, True),
        ("D256_band_256_256", 2, 1000, 2, D, bf, [1000, 700], (256, 256), 0, 0, False),
        ("D256_band_edge_in_tiles", 2, 400, 2, D, bf, [400, 333], (100, 72), 0, 0, False),
        ("D256_band_left_only", 2, 300, 2, D, bf, [300, 211], (64, -1), 0, 0, False),
        ("D256_q_kv_offsets", 2, 300, 2, D, bf, [320, 150], (-1, -1), 37, 20, False),
        ("D256_offsets_band", 2, 300, 2, D, bf, [300, 250], (40, 30), 37, 20, False),
        ("D256_shard_offsets_64", 2, 300, 2, D, bf, [364, 280], (-1, 40), 64, 64, True),
        ("D256_fp32", 2, 333, 2, D, f32, [333, 120], (-1, -1), 0, 0, True),
        ("D256_fp32_band", 2, 300, 2, D, f32, [300, 0], (32, 8), 5, 0, False),
        ("D256_fp32_offsets", 2, 130, 2, D, f32, [150, 129], (-1, -1), 20, 10, False),
    ]


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


def bwd_timings(torch, shape, gen, band=None) -> dict:
    """Device time per launch of K3, K4 and K5 at a training shape (full
    lengths, qkv views as the model gives them) in turns with cuDNN's
    backward (through scaled_dot_product_attention): K3, K4 + K5, the
    library twice, K4 + K5, K3; the wrappers' times, the plain version's,
    and each kernel's bound from the pairs it must cover.  `band`: K4 and K5
    again under that two-sided band, against the bound of the pairs it
    leaves.  Returns {kernel name: numbers}."""
    from lcasr_torch.ops.flash_attention import (
        flash_attention_bwd_ref, flash_attention_with_lse)

    B, T, H, D = shape
    q, k, v = make_qkv(torch, B, T, H, D, torch.bfloat16, True, gen)
    o, lse = flash_attention_with_lse(q, k, v)
    do = torch.randn((B, T, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    args = (q, k, v, o, lse, do, None, (-1, -1), None, 0, 0)
    sym = {key: entry[0].replace("<128", f"<{D}") for key, entry in BWD_KERNELS.items()}
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
    log(f"  scaled_dot_product_attention backward at {shape}: "
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
    band_turns = {key: [] for key in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")}
    if band is not None:
        o_band, lse_band = flash_attention_with_lse(q, k, v, None, band)
        band_args = (q, k, v, o_band, lse_band, do, None, band, None, 0, 0)
        band_split = lambda: run_bwd(torch, False, *band_args)
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
    for key in BWD_KERNELS:
        bound, flops, bound_by = bound_of(key, pairs)
        ms = min(turns[key])
        log(f"  {key} at {shape} bf16: device time per launch "
            + " / ".join(f"{x:.4f}" for x in turns[key]) + f" ms ({flops / ms / 1e9:.1f} TFLOP/s, "
            f"{100 * bound / ms:.1f}% of its {bound:.4f} ms bound; cuDNN's backward "
            f"{library_ms:.4f} ms, {ms / library_ms:.2f}x)")
        out[key] = {"ms": ms, "ms_turns": turns[key], "plain_ms": plain_ms,
                    "library_ms": library_ms, "library_ms_turns": library,
                    "bound_ms": bound, "bound_by": bound_by,
                    "wrapper_ms": fused_ms if key.endswith("fused") else split_ms}
        if band is not None and key in band_turns:
            b_bound, b_flops, b_by = bound_of(key, band_pairs)
            b_ms = min(band_turns[key])
            log(f"  {key} at {shape} bf16, window {band}, {band_pairs} valid pairs: "
                f"device time per launch " + " / ".join(f"{x:.4f}" for x in band_turns[key])
                + f" ms ({b_flops / b_ms / 1e9:.1f} TFLOP/s, {100 * b_bound / b_ms:.1f}% of its "
                f"{b_bound:.4f} ms bound by {b_by})")
            out[key].update(ms_band_256=b_ms, ms_band_256_turns=band_turns[key],
                            bound_ms_band_256=b_bound, bound_by_band_256=b_by)
    log(f"  wrappers at {shape}: K3 path {fused_ms:.4f} ms, K4+K5 path "
        f"{split_ms:.4f} ms (delta, dq scale and casts included); plain {plain_ms:.4f} ms")
    return out


def phase_kernels_bwd(torch, registers: dict):
    """K3 and K4 + K5 on every attention case (the forward's, the backward's
    tile edges) and on the D = 256 cases, bit-equality of dk and dv across
    runs and between K5 and K3; then their device time per launch at a
    16384 x 4 micro step's shape, at D = 128 (the flagship) and D = 256
    (lcasr_6l_768d_3h), each beside its bound and cuDNN's backward.
    `registers`: ptxas's entries of each kernel template, for the record."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {name: 0.0 for name in BWD_KERNELS}
    worst_d256 = {name: 0.0 for name in BWD_KERNELS}
    n_equal = 0
    for case in attention_cases(torch) + bwd_d256_cases(torch):
        errs = bwd_case(torch, case, gen)
        if case[5] == torch.bfloat16:
            w = worst_d256 if case[4] == 256 else worst
            w["flash_attention_bwd_fused"] = max(w["flash_attention_bwd_fused"],
                                                 *errs.get("K3", [0.0]))
            w["flash_attention_bwd_dq"] = max(w["flash_attention_bwd_dq"], errs["K4+K5"][0])
            w["flash_attention_bwd_dkv"] = max(w["flash_attention_bwd_dkv"], *errs["K4+K5"][1:])
            n_equal += "K3" in errs
    log(f"  dk, dv the same bits in two runs of each route on every case, K4's dq in two "
        f"runs of the split route; K5's dk, dv bit-equal to K3's on the {n_equal} bf16 cases "
        f"both take")

    # the split path under the band of the repo's hour-scale configuration
    # (configs/cp_1hour_tiny.yaml, attention_window_size 256)
    times = bwd_timings(torch, TRAIN_ATTN_SHAPE, gen, band=(256, 256))
    times_d256 = bwd_timings(torch, D256_TRAIN_ATTN_SHAPE, gen)
    out = {}
    for key, (symbol, line, body) in BWD_KERNELS.items():
        sym256 = symbol.replace("<128", "<256")
        entry, entry256 = registers.get(symbol, {}), registers.get(sym256, {})
        log(f"  {key}: ptxas {symbol} {entry}, {sym256} {entry256}")
        out[key] = dict(times[key], **{
            "name": key, "route": "cuda",
            "source": "lcasr_torch/csrc/flash_attn_bwd.cu",
            "replaces": f"lcasr_tpu/ops/flash_attention.py:{line}",
            "replaces_fn": f"lcasr_tpu/ops/flash_attention.py:{body}",
            "launches": None, "max_abs_err": worst[key],
            "registers": entry.get("registers"),
            "max_abs_err_d256": worst_d256[key], "registers_d256": entry256.get("registers"),
            "spill_bytes_d256": entry256.get("spill_stores", 0) + entry256.get("spill_loads", 0),
        })
        out[key].update({f"{name}_d256": value for name, value in times_d256[key].items()})
    return out


# ---------------------------------------------------------------------------
# phase 2c: selective scan (K6) and its backward (K7) against their plain versions
# ---------------------------------------------------------------------------
SSM_KERNELS = {  # launch-count name -> (kernel symbol, Pallas body it replaces)
    # K6 is one or two launches (selective_scan_fwd_local, _body) and K7 five,
    # whose names all begin so (csrc/selective_scan.cu)
    "selective_scan_fwd": ("selective_scan_fwd_", 78, "_scan_kernel"),
    "selective_scan_bwd": ("selective_scan_bwd_", 177, "_scan_bwd_kernel"),
}
SSM_DECODE_SHAPE = (32, 2048, 768, 16)  # (Bt, L, D, N): 16 windows, both directions
SSM_TRAIN_SHAPE = (8, 2048, 768, 16)  # a 16384-frame x 4 chunk
SSM_LONG_SHAPE = (2, 15_000, 768, 16)  # the 120,000 x 1 step: 15,000 frames, both directions
# every shape the main paths launch K6 at: the decode, the ladder's two
# buckets and the 120,000-frame step
SSM_MAIN_SHAPES = {"decode": SSM_DECODE_SHAPE, "16384x4": SSM_TRAIN_SHAPE,
                   "8192x8": (16, 1024, 768, 16), "120000x1": SSM_LONG_SHAPE}
# kernel and plain version are both fp32 on the same (possibly bf16-rounded)
# inputs; they differ in exp2 against exp, fused multiply-adds and the order of
# the sums over channels and time: 2e-4 of the largest reference value
SSM_TOL = 2e-4
# the scan at d_state other than 16: N = 8 runs the N = 16 kernels on
# inputs padded to 16 states, 32 and 64 their own instantiations; each N gets
# these edge cases and the decode and training shapes, at the gates above
SSM_OTHER_D_STATES = (8, 32, 64)
SSM_D_STATE_CASES = ("fp32_L1", "fp32_L15", "fp32_L77_strided", "bf16_L77_D100",
                     "mixed_L2049_D160", "fp32_L33_2seg_Bt1", "mixed_L100_D37_odd",
                     "decode_shape_full", "train_shape_full")


def ssm_cases(torch):
    """(name, Bt, L, D, x dtype, B/C dtype, B and C as strided slices ("odd":
    at an odd offset, rows not 16-byte aligned), wide delta)"""
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
        # the edges of K6's split (ops/ssm.py fwd_segments): 27 segments of
        # 64 steps and one step more; 29 of them less one step; two
        # one-chunk segments, the second of one step; 34 segments at a D cut
        # by the 64-channel block, one row; rows of x and delta that are not
        # 16-byte aligned (plain loads for cp.async's copies), B and C too
        ("mixed_L1729_27seg_plus1", 2, 27 * 64 + 1, 768, f32, bf, True, False),
        ("mixed_L1855_29seg_minus1", 2, 29 * 64 - 1, 768, f32, bf, True, True),
        ("fp32_L33_2seg_Bt1", 1, 33, 64, f32, f32, False, False),
        ("mixed_L1057_D100_Bt1", 1, 33 * 32 + 1, 100, f32, bf, True, False),
        ("mixed_L100_D37_odd", 2, 100, 37, f32, bf, "odd", False),
        ("fp32_L70_D37_odd", 2, 70, 37, f32, f32, "odd", True),
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
        off = 47 if strided == "odd" else 48
        proj = randn(Bt, L, off + 2 * N).to(bc_dtype)
        Bm, Cm = proj[..., off:off + N], proj[..., off + N:]
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


def ssm_case(torch, case, gen, N: int = 16):
    """One case of K6 and K7 at d_state N against their plain versions at
    SSM_TOL of the largest reference value; the forward with and without its
    states the same bits, K6's y and states and K7's five gradients the same
    bits in two runs.  Returns (the forward's worst error, the backward's)."""
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

    x, delta, A, Bm, Cm, g = ssm_inputs(torch, gen, Bt, L, D, N, xd, bcd, strided, wide)
    y = ssm.selective_scan_fwd(x, delta, A, Bm, Cm)
    y_s, states = ssm.selective_scan_fwd(x, delta, A, Bm, Cm, return_states=True)
    y_again, states_again = ssm.selective_scan_fwd(x, delta, A, Bm, Cm, return_states=True)
    grads = ssm.selective_scan_bwd(x, delta, A, Bm, Cm, states, g)
    again = ssm.selective_scan_bwd(x, delta, A, Bm, Cm, states, g)
    torch.cuda.synchronize()
    if not torch.equal(y, y_s):
        raise AssertionError(f"{name}: y differs with and without the saved states")
    if not (torch.equal(y_s, y_again) and torch.equal(states, states_again)):
        raise AssertionError(f"{name}: K6's y or states differ between two runs")
    # no atomics and a fixed order of every sum: the same bits each run
    for what, a, b in zip(("dx", "ddelta", "dA", "dB", "dC"), grads, again):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: K7's {what} differs between two runs")
    y_ref, states_ref = ssm.selective_scan_ref(x, delta, A, Bm, Cm, return_states=True)
    grads_ref = ssm.selective_scan_bwd_ref(x, delta, A, Bm, Cm, g)
    if states.shape[2] != N:  # a padded d_state: its states stay exactly 0
        if states[:, :, N:].abs().max().item() != 0:
            raise AssertionError(f"{name}: a padded state of N = {N} is not 0")
        states = states[:, :, :N]
    e_fwd = [rel_err("y", y, y_ref), rel_err("states", states, states_ref)]
    e_bwd = [rel_err(what, got, want) for what, got, want in
             zip(("dx", "ddelta", "dA", "dB", "dC"), grads, grads_ref)]
    log(f"  {name:24s} N {N:2d} K6 ({ssm.fwd_segments(Bt, L, D)} seg): y {e_fwd[0]:.2e} states "
        f"{e_fwd[1]:.2e}   K7: dx {e_bwd[0]:.2e} ddelta {e_bwd[1]:.2e} dA {e_bwd[2]:.2e} "
        f"dB {e_bwd[3]:.2e} dC {e_bwd[4]:.2e} (of the largest value; tolerance {SSM_TOL:g}; "
        f"K6 and K7 the same bits in two runs)")
    return max(e_fwd), max(e_bwd)


def kernel_group_ms(torch, fn, prefix: str, n: int = 5) -> float:
    """Device time per call of fn of every kernel whose name contains
    `prefix` (torch.profiler), summed: a wrapper's several launches."""
    totals = device_kernel_totals(torch, fn, n)
    us = sum(t for key, (t, _) in totals.items() if prefix in key)
    if not us:
        raise AssertionError(f"profiler recorded no device time for {prefix}*")
    return us / n / 1e3


# K6's split of the time axis (ops/ssm.py fwd_segments) swept: the wrapper's
# own choice, and cuts for 2, 4 and 8 blocks an SM of the 132 that
# ops/ssm.py assumes (its FWD_SPLIT_BLOCKS, 8, and its FWD_FILL_BLOCKS were
# chosen at d_state 16's 128-thread blocks; at 32 and 64 a block has 256
# and 512 threads), at the decode shape too, which the wrapper leaves unsplit
SSM_SPLIT_SWEEP = (2, 4, 8)
SSM_SPLIT_SHAPES = {"decode": SSM_DECODE_SHAPE, "16384x4": SSM_TRAIN_SHAPE,
                    "long": SSM_LONG_SHAPE}


def ssm_split_sweep(torch, gen) -> dict:
    """K6 at the decode shape (no states) and the 16384x4 and 120,000-frame
    shapes (with states, as the training forward) for each built d_state,
    under each split of SSM_SPLIT_SWEEP and the wrapper's own: ms a wrapper
    call by CUDA events over 20 calls back to back (`device_ms`; the
    wrapper enqueues only K6's launches), the best of two rounds taken in
    turn.  Returns {N: {shape: {"ms": {choice:
    ms}, "segments": {choice: S}}}}."""
    from lcasr_torch.ops import ssm

    kept = ssm.FWD_FILL_BLOCKS, ssm.FWD_SPLIT_BLOCKS
    choices = {"wrapper": kept,
               **{f"{k}_an_sm": (sys.maxsize, k * 132) for k in SSM_SPLIT_SWEEP}}
    out = {}
    t0 = time.perf_counter()
    try:
        for N in ssm.KERNEL_D_STATES:
            out[N] = {}
            for label, shape in SSM_SPLIT_SHAPES.items():
                Bt, L, D, _ = shape
                states = label != "decode"
                x, delta, A, Bm, Cm, _g = ssm_inputs(torch, gen, Bt, L, D, N, torch.float32,
                                                     torch.bfloat16, True, False)
                best, segs = {}, {}
                for _round in range(2):
                    for c, (fill, split) in choices.items():
                        ssm.FWD_FILL_BLOCKS, ssm.FWD_SPLIT_BLOCKS = fill, split
                        segs[c] = ssm.fwd_segments(Bt, L, D)
                        ms = device_ms(torch, lambda: ssm.selective_scan_fwd(
                            x, delta, A, Bm, Cm, return_states=states), n=20)
                        best[c] = min(best.get(c, ms), ms)
                ssm.FWD_FILL_BLOCKS, ssm.FWD_SPLIT_BLOCKS = kept
                out[N][label] = {"ms": best, "segments": segs}
                log(f"  K6 split sweep N {N:2d} at {label} {(Bt, L, D)}"
                    f"{' with states' if states else ''}: " + ", ".join(
                        f"{c} ({segs[c]} seg) {best[c]:.4f} ms" for c in choices))
                del x, delta, A, Bm, Cm, _g
    finally:
        ssm.FWD_FILL_BLOCKS, ssm.FWD_SPLIT_BLOCKS = kept
    log(f"  K6 split sweep: {time.perf_counter() - t0:.1f} s")
    return out


def check_fwd_grids(torch) -> dict:
    """K6's grid of every launch at each main shape, from the library (the
    grids it launches), held equal to `ssm.fwd_grids` and to at least one
    block on every SM."""
    import ctypes

    from lcasr_torch import kernels
    from lcasr_torch.ops import ssm

    lib = kernels.library("selective_scan.cu")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for label, (Bt, L, D, _) in SSM_MAIN_SHAPES.items():
        S = ssm.fwd_segments(Bt, L, D)
        seg_steps = -(-ssm._n_chunks(L) // S) * 32
        grids = {}
        for kind, name in enumerate(("selective_scan_fwd_local", "selective_scan_fwd_body")):
            g = (ctypes.c_int * 3)()
            rc = lib.lcasr_selective_scan_fwd_grid(Bt, L, D, S, kind, g)
            if rc < 0:
                raise AssertionError(f"K6 refuses {S} segments at {label} {(Bt, L, D)}")
            if rc == 0:
                grids[name] = tuple(g)
        blocks = {name: g[0] * g[1] * g[2] for name, g in grids.items()}
        log(f"  K6 at {label} {(Bt, L, D)}: {S} segment(s) of "
            f"{seg_steps} steps; grids {grids}, blocks {blocks} of 128 "
            f"threads on {sms} SMs")
        if grids != ssm.fwd_grids(Bt, L, D) or min(blocks.values()) < sms:
            raise AssertionError(f"K6's grids at {label}: {grids}, expected "
                                 f"{ssm.fwd_grids(Bt, L, D)}, each at least {sms} blocks")
        out[label] = {"segments": S, "grids": grids}
    return out


def phase_kernels_ssm(torch):
    from lcasr_torch.ops import ssm

    grids = check_fwd_grids(torch)
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
    fwd_prefix = SSM_KERNELS["selective_scan_fwd"][0]
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
        t["fwd_device"] = kernel_group_ms(torch, fwd, fwd_prefix)
        t["fwd_states_device"] = kernel_group_ms(torch, fwd_s, fwd_prefix)
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
        log(f"  {label} shape {shape}, x fp32, B/C bf16 strided: K6 device {t['fwd_device']:.4f}"
            f" ms, {100 * t['fwd_bound'][0] / t['fwd_device']:.1f}% of its bound (with states "
            f"{t['fwd_states_device']:.4f} ms, "
            f"{100 * t['fwd_states_bound'][0] / t['fwd_states_device']:.1f}%), wrapper call "
            f"{t['fwd']:.4f} ms (with states {t['fwd_states']:.4f}), bound "
            f"{t['fwd_bound'][0]:.4f} ms by {t['fwd_bound'][1]} (with states "
            f"{t['fwd_states_bound'][0]:.4f} ms); K7 "
            f"{t['bwd']:.4f} ms a wrapper call (device time of its launches "
            f"{t['bwd_kernel_only']:.4f} ms, {100 * t['bwd_bound'][0] / t['bwd_kernel_only']:.1f}% "
            f"of its bound), bound {t['bwd_bound'][0]:.4f} ms by {t['bwd_bound'][1]}; {plain}; "
            f"no library call computes either")
        del x, delta, A, Bm, Cm, g, states
    d_states = ssm_d_state_cases(torch, gen, timed)
    split_sweep = ssm_split_sweep(torch, gen)
    # K6's row is the decode's launch (no states), K7's the training step's;
    # both by the device time of their launches
    for key, (ms, plain, bound, extra) in {
        "selective_scan_fwd": (timed["decode"]["fwd_device"], timed["decode"]["fwd_plain"],
                               timed["decode"]["fwd_bound"],
                               {"wrapper_ms": timed["decode"]["fwd"],
                                "ms_train_shape_with_states": timed["train"]["fwd_states_device"],
                                "wrapper_ms_train_shape_with_states": timed["train"]["fwd_states"],
                                "bound_ms_train_shape_with_states":
                                    timed["train"]["fwd_states_bound"][0],
                                "plain_ms_train_shape": timed["train"]["fwd_plain"],
                                "ms_long_shape": timed["long"]["fwd_device"],
                                "ms_long_shape_with_states": timed["long"]["fwd_states_device"],
                                "bound_ms_long_shape": timed["long"]["fwd_bound"][0],
                                "grids": grids, "split_sweep": split_sweep}),
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
            "d_state_cases": d_states[key],
        }
    return out


def scan_bits_against(torch, src: str) -> dict:
    """K6 and K7 at d_state 16 from this checkout against the same wrappers
    launching the kernels built from `src`, the selective_scan.cu of another
    commit whose two launch functions take the same arguments (the workspace
    sizes stay this build's): y without and with the states, the states and
    the five gradients must be the same bits, at the decode, training and
    120,000-frame shapes and on the cases of SSM_D_STATE_CASES."""
    import ctypes

    from lcasr_torch import kernels
    from lcasr_torch.ops import ssm

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "scan_source")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "selective_scan_source.so")
    subprocess.run([kernels._find_nvcc(), *kernels.NVCC_FLAGS, "-o", so, src], check=True,
                   capture_output=True, timeout=600)
    new = kernels.library("selective_scan.cu")
    other = kernels._bind("selective_scan.cu", ctypes.CDLL(so))
    launches = ("lcasr_selective_scan_fwd", "lcasr_selective_scan_bwd")

    class Mixed:  # the other build's launches, this build's sizes and messages
        def __getattr__(self, name):
            return getattr(other if name in launches else new, name)

    def run(inputs):
        x, delta, A, Bm, Cm, g = inputs
        y = ssm.selective_scan_fwd(x, delta, A, Bm, Cm)
        y_s, states = ssm.selective_scan_fwd(x, delta, A, Bm, Cm, return_states=True)
        return (y, y_s, states, *ssm.selective_scan_bwd(x, delta, A, Bm, Cm, states, g))

    cases = {c[0]: c for c in ssm_cases(torch)}
    shapes = [(name, cases[name][1:]) for name in SSM_D_STATE_CASES] + [
        (label, shape[:3] + (torch.float32, torch.bfloat16, True, False))
        for label, shape in (("decode", SSM_DECODE_SHAPE), ("train", SSM_TRAIN_SHAPE),
                             ("long", SSM_LONG_SHAPE))]
    gen = torch.Generator(device="cuda").manual_seed(11)
    for name, (Bt, L, D, xd, bcd, strided, wide) in shapes:
        inputs = ssm_inputs(torch, gen, Bt, L, D, 16, xd, bcd, strided, wide)
        mine = run(inputs)
        kernels._libs["selective_scan.cu"] = Mixed()
        try:
            theirs = run(inputs)
        finally:
            kernels._libs["selective_scan.cu"] = new
        torch.cuda.synchronize()
        for what, a, b in zip(("y", "y with states", "states", "dx", "ddelta", "dA", "dB", "dC"),
                              mine, theirs):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: {what} differs from {src}'s bits at d_state 16")
    log(f"  K6 and K7 at d_state 16: y, states and the five gradients the same bits as {src} "
        f"on {len(shapes)} cases ({', '.join(n for n, _ in shapes)})")
    return {"source": src, "cases": [n for n, _ in shapes], "equal": True}


def scan_registers(build_log: dict) -> dict:
    """{N: {"kernel<B and C's type, states>": ptxas entry}} of the scan's
    template instantiations in nvcc's output."""
    import re

    out = {}
    for fn, e in ptxas_entries(build_log["selective_scan.cu"]).items():
        m = re.search(r"\d(selective_scan_[a-z_]+)ILi(\d+)E(13__nv_bfloat16|f)?(?:Lb([01])E)?E", fn)
        if m:
            tags = [{"13__nv_bfloat16": "bf16", "f": "fp32"}.get(m.group(3), ""),
                    {"1": "states", "0": "no states"}.get(m.group(4), "")]
            name = m.group(1) + (f"<{', '.join(t for t in tags if t)}>" if any(tags) else "")
            out.setdefault(int(m.group(2)), {})[name] = e
    return out


def ssm_d_state_cases(torch, gen, timed16: dict) -> dict:
    """K6 and K7 at each of SSM_OTHER_D_STATES: the cases of SSM_D_STATE_CASES
    against the plain versions at SSM_TOL, then device ms at the decode
    shape (K6, no states) and the training shape (K6 with states, K7),
    the plain versions' ms at those shapes, each bound at the true N, and
    ptxas's registers and spills of each instantiation; N = 16's numbers
    from `timed16` beside them.  Returns {kernel: {N: numbers}}."""
    from lcasr_torch import kernels
    from lcasr_torch.ops import ssm

    registers = scan_registers(kernels.build_log)
    for N in sorted(registers):
        for name, e in sorted(registers[N].items()):
            log(f"  scan N = {N}: {name}: {e}")
    cases = {c[0]: c for c in ssm_cases(torch)}
    fwd_prefix = SSM_KERNELS["selective_scan_fwd"][0]
    bwd_prefix = SSM_KERNELS["selective_scan_bwd"][0]
    out = {"selective_scan_fwd": {}, "selective_scan_bwd": {}}
    for N in (16,) + SSM_OTHER_D_STATES:
        built = ssm.kernel_d_state(N)
        regs = {k: v for k, v in registers.get(built, {}).items()}
        if N == 16:
            d, tr = timed16["decode"], timed16["train"]
            fwd = {"ms": d["fwd_device"], "plain_ms": d["fwd_plain"], "bound_ms": d["fwd_bound"][0],
                   "bound_by": d["fwd_bound"][1], "ms_train_shape_with_states":
                   tr["fwd_states_device"]}
            bwd = {"ms": tr["bwd_kernel_only"], "plain_ms": tr["bwd_plain"],
                   "bound_ms": tr["bwd_bound"][0], "bound_by": tr["bwd_bound"][1]}
        else:
            worst_f = worst_b = 0.0
            for name in SSM_D_STATE_CASES:
                e_f, e_b = ssm_case(torch, cases[name], gen, N)
                worst_f, worst_b = max(worst_f, e_f), max(worst_b, e_b)
            t = {}
            for label, shape in (("decode", SSM_DECODE_SHAPE[:3] + (N,)),
                                 ("train", SSM_TRAIN_SHAPE[:3] + (N,))):
                x, delta, A, Bm, Cm, g = ssm_inputs(torch, gen, *shape, torch.float32,
                                                    torch.bfloat16, True, False)
                _, states = ssm.selective_scan_fwd(x, delta, A, Bm, Cm, return_states=True)
                if label == "decode":
                    t["fwd"] = kernel_group_ms(
                        torch, lambda: ssm.selective_scan_fwd(x, delta, A, Bm, Cm), fwd_prefix)
                    t["fwd_plain"] = time_ms(torch, lambda: ssm.selective_scan_ref(
                        x, delta, A, Bm, Cm), n=1, warmup=1)
                    t["fwd_bound"] = ssm_bound(torch, "fwd", shape, 4, 2, False)
                else:
                    t["fwd_states"] = kernel_group_ms(torch, lambda: ssm.selective_scan_fwd(
                        x, delta, A, Bm, Cm, return_states=True), fwd_prefix)
                    t["bwd"] = kernel_group_ms(torch, lambda: ssm.selective_scan_bwd(
                        x, delta, A, Bm, Cm, states, g), bwd_prefix)
                    t["bwd_plain"] = time_ms(torch, lambda: ssm.selective_scan_bwd_ref(
                        x, delta, A, Bm, Cm, g), n=1, warmup=1)
                    t["bwd_bound"] = ssm_bound(torch, "bwd", shape, 4, 2, True)
                del x, delta, A, Bm, Cm, g, states
            fwd = {"ms": t["fwd"], "plain_ms": t["fwd_plain"], "bound_ms": t["fwd_bound"][0],
                   "bound_by": t["fwd_bound"][1], "ms_train_shape_with_states": t["fwd_states"],
                   "max_abs_err": worst_f}
            bwd = {"ms": t["bwd"], "plain_ms": t["bwd_plain"], "bound_ms": t["bwd_bound"][0],
                   "bound_by": t["bwd_bound"][1], "max_abs_err": worst_b}
        for key, numbers in (("selective_scan_fwd", fwd), ("selective_scan_bwd", bwd)):
            prefix = SSM_KERNELS[key][0]
            numbers["kernel_d_state"] = built
            numbers["registers"] = {k: v for k, v in regs.items() if k.startswith(prefix)}
            out[key][N] = numbers
        log(f"  d_state {N} (kernels built for {built}): K6 decode shape {fwd['ms']:.4f} ms "
            f"(bound {fwd['bound_ms']:.4f} by {fwd['bound_by']}, "
            f"{100 * fwd['bound_ms'] / fwd['ms']:.1f}%; plain {fwd['plain_ms']:.2f}), with "
            f"states at the training shape {fwd['ms_train_shape_with_states']:.4f}; K7 training "
            f"shape {bwd['ms']:.4f} ms (bound {bwd['bound_ms']:.4f} by {bwd['bound_by']}, "
            f"{100 * bwd['bound_ms'] / bwd['ms']:.1f}%; plain {bwd['plain_ms']:.2f})")
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
SUB_WIDE_CHANNELS = (384, 768, 2048)  # 2048: the widest d_model in configs/
SUB_TOL_FP32 = 2e-5  # fp32 accumulation in another order than cuDNN's
# bf16: the kernel against the fp32 conv chain may err at most this many times
# what the bf16 conv chain itself errs against it (maximum and mean), and
# nowhere by more than 2e-2 + 2e-2 |y|
SUB_BF16_YARDSTICK_FACTOR, SUB_TOL_BF16 = 1.5, 2e-2
# the silu-tail case: at most 1% of K8's output values may differ by more
# than 2 bf16 ulps from the chain rounded where the kernel rounds
SILU_TAIL_SHAPE = (2, 1024, 80, 256)  # (B, T, F, C)
SILU_TAIL_ULPS, SILU_TAIL_LIMIT = 2, 0.01


def sub_params(torch, gen, C, dtype):
    """A random 3-stage chain in the module's layout (OIHW), as
    tests/test_subsampling_fused.py draws it."""
    r = lambda *shape, scale=0.2: (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)
    params = [r(C, 1, 3, 3), r(C)]
    for _ in range(2):
        params += [r(C, 1, 3, 3), r(C), r(C, C, 1, 1, scale=0.06), r(C)]
    return params


def rounded_chain(torch, x, params, act):
    """The fp32 conv chain on bf16 x and parameters, rounded to bf16 where the
    kernel rounds: after stage 0's activation, after each depthwise conv and
    after each pointwise activation.  (B, T, F) -> (B, T/8, F/8, C), fp32."""
    import torch.nn.functional as Fn

    from lcasr_torch.ops import subsampling as sub

    f = sub.ACTS[act]
    r = lambda v: v.to(torch.bfloat16).float()
    k0, b0, kd1, bd1, kp1, bp1, kd2, bd2, kp2, bp2 = [p.float() for p in params]
    C = k0.shape[0]
    h = r(f(sub.strided_conv(x.float()[:, None], k0, b0)))
    for kd, bd, kp, bp in ((kd1, bd1, kp1, bp1), (kd2, bd2, kp2, bp2)):
        h = r(sub.strided_conv(h, kd, bd, groups=C))
        h = r(f(Fn.conv2d(h, kp, bp)))
    return h.permute(0, 2, 3, 1)


def bf16_ulps(torch, y, ref):
    """|y - ref| in units of the bf16 spacing at ref (ref != 0)."""
    _, e = torch.frexp(ref)  # |ref| in [2^(e-1), 2^e): spacing 2^(e-8)
    return (y.float() - ref).abs() / torch.ldexp(torch.ones_like(ref), e - 8)


def silu_tail_case(torch, gen):
    """The negative tail of K8's silu, value by value: whole-output checks
    pass a silu by tanh.approx.  bf16 x in (-1, 1), stage-0 weights in
    (-0.25, 0.25) and a bias in (-9.6, -9.4): every stage-0 pre-activation
    lies in (-12, -4), most below -8, where such a silu errs by more than
    bf16's rounding on the H100 (PERF.md §6).  After stage 0 only the centre tap of each depthwise conv and the
    diagonal of each pointwise conv are non-zero (in (0.5, 1)), and the biases
    zero: each output value is a chain of one-channel operations on one
    stage-0 value, so that value's error reaches the output whole.  K8's
    output against `rounded_chain`: at most SILU_TAIL_LIMIT of the values may
    differ by more than SILU_TAIL_ULPS bf16 ulps.  Returns that share."""
    from lcasr_torch import kernels
    from lcasr_torch.ops import subsampling as sub

    B, T, F, C = SILU_TAIL_SHAPE
    bf = torch.bfloat16
    u = lambda *shape, lo, hi: (lo + (hi - lo) * torch.rand(shape, generator=gen,
                                                             device="cuda")).to(bf)
    x = u(B, T, F, lo=-1.0, hi=1.0)
    params = [u(C, 1, 3, 3, lo=-0.25, hi=0.25), u(C, lo=-9.6, hi=-9.4)]
    zero = torch.zeros(C, device="cuda", dtype=bf)
    for _ in range(2):
        kd = torch.zeros(C, 1, 3, 3, device="cuda", dtype=bf)
        kd[:, 0, 1, 1] = u(C, lo=0.5, hi=1.0)
        kp = torch.diag(u(C, lo=0.5, hi=1.0))[:, :, None, None].contiguous()
        params += [kd, zero, kp, zero]
    pre = sub.strided_conv(x.float()[:, None], params[0].float(), params[1].float())
    if not (pre.max() < -4 and pre.min() > -12):
        raise AssertionError(f"silu tail: stage-0 pre-activations in [{pre.min().item():.3f}, "
                             f"{pre.max().item():.3f}], not inside (-12, -4)")
    kernels.reset_launch_counts()
    y = sub.fused_dw_striding(x, params, "silu")
    torch.cuda.synchronize()
    if kernels.launch_counts["subsampling_fused"] != 1:
        raise AssertionError("fused_dw_striding did not launch its kernel")
    ref = rounded_chain(torch, x, params, "silu")
    if not (ref < 0).all():
        raise AssertionError("silu tail: the reference holds values that are not negative")
    ulps = bf16_ulps(torch, y, ref)
    share = (ulps > SILU_TAIL_ULPS).float().mean().item()
    log(f"  silu tail {SILU_TAIL_SHAPE[:3]} -> {C} bf16, stage-0 pre-activations in "
        f"[{pre.min().item():.3f}, {pre.max().item():.3f}]: {100 * share:.4f}% of the values "
        f"beyond {SILU_TAIL_ULPS} bf16 ulps of the chain rounded where K8 rounds (limit "
        f"{100 * SILU_TAIL_LIMIT:g}%), at most {ulps.max().item():.2f} ulps")
    if share > SILU_TAIL_LIMIT:
        raise AssertionError(f"K8 silu tail: {100 * share:.4f}% of the values beyond "
                             f"{SILU_TAIL_ULPS} ulps (limit {100 * SILU_TAIL_LIMIT:g}%)")
    return share


def sub_bound(B, T, F, C, elem_bytes, dtype_name, sms, clock_hz, act="silu"):
    """(bound ms, bound_by, parts, flops): the larger of three times, the
    chain's multiply-adds at the peak of their type (the tensor cores' in
    bf16), one special-function operation (an exp) per silu value of the
    chain at SFU_PER_CLOCK_PER_SM x `sms` x `clock_hz` (the card's SM count
    and highest SM clock), and x read once, the output written once and the
    weights.  The values counted are the chain's own (B (T/2 F/2 + T/4 F/4 +
    T/8 F/8) C), not those a kernel recomputes on its tiles' edges.  `parts`
    holds the three times and names the one that bounds ("tensor cores" or
    "fp32 cores", "special functions", "bytes"); bound_by is "operations"
    for either kind of operation."""
    T0, T1, T8, F0, F1, F8 = T // 2, T // 4, T // 8, F // 2, F // 4, F // 8
    flops = 2 * B * (T0 * F0 * C * 9 + T1 * F1 * C * (9 + C) + T8 * F8 * C * (9 + C))
    values = B * (T0 * F0 + T1 * F1 + T8 * F8) * C
    nbytes = elem_bytes * (B * T * F + B * T8 * F8 * C + 3 * 10 * C + 2 * C * C)
    sfu_rate = SFU_PER_CLOCK_PER_SM * sms * clock_hz
    mma = "tensor cores" if dtype_name == "bf16" else "fp32 cores"
    parts = {mma: flops / PEAK_FLOPS[dtype_name] * 1e3,
             "special functions": (values if act == "silu" else 0) / sfu_rate * 1e3,
             "bytes": nbytes / PEAK_BYTES_PER_S * 1e3}
    by = max(parts, key=parts.get)
    parts["by"] = by
    return parts[by], ("bytes" if by == "bytes" else "operations"), parts, flops


def sub_checks(torch, gen, wide: bool = True):
    """Every K8 check against the conv chain: the silu tail, the small
    cases (every activation), the small tiles, the wide channel counts and
    the main shapes.  Returns the largest errors by dtype and the silu
    tail's share; raises at the first failed case.  `wide`: the channel
    counts above 256 too (the first K8 took 128 and 256 only)."""
    from lcasr_torch import kernels
    from lcasr_torch.ops import subsampling as sub

    bf, f32 = torch.bfloat16, torch.float32
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

    tail_share = silu_tail_case(torch, gen)
    cases = [(B, T, F, 128, f32, act, None) for B, T, F, act in SUB_SMALL_CASES]
    # tiles of 1 and 2 output frames: many tile edges, the first tile's zero
    # rows, a ragged last tile (T/8 = 41)
    cases += [(2, 328, 80, 128, f32, "silu", 1), (2, 328, 80, 256, bf, "silu", 2),
              (2, 328, 80, 128, bf, "gelu", None)]
    # the channel counts beyond 256 the kernel takes (every multiple of 128
    # up to 2048): a ragged last tile, and tiles of one frame
    cases += [(2, 328, 80, C, dtype, "silu", tile) for C in SUB_WIDE_CHANNELS if wide
              for dtype in (bf, f32) for tile in (None, 1)]
    cases += [(B, T, F, 256, dtype, "silu", None) for B, T, F in SUB_MAIN_SHAPES
              for dtype in (bf, f32)]
    for case in cases:
        check(*case)
    return worst, tail_share


def phase_kernels_sub(torch):
    from lcasr_torch.ops import subsampling as sub

    bf, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst, tail_share = sub_checks(torch, gen)

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
        bound_ms, bound_by, parts, flops = sub_bound(
            B, T, F, C, 2 if dtype == bf else 4, name,
            torch.cuda.get_device_properties(0).multi_processor_count, max_sm_clock_hz())
        times[name] = (min(ta, tb), tc, tcc, bound_ms, bound_by, parts)
        log(f"  K8 at (16, 16384, 80) -> 256 {name}: {ta:.4f} / {tb:.4f} ms "
            f"({flops / min(ta, tb) / 1e9:.1f} TFLOP/s), the conv chain {tc:.4f} ms (with the "
            f"copy to C minor {tcc:.4f} ms), bound {bound_ms:.4f} ms by {parts['by']} "
            f"({', '.join(f'{k} {v:.4f}' for k, v in parts.items() if k != 'by')} ms); no "
            f"single library call computes it")
        del x, params
    ms, plain_ms, chain_copy_ms, bound_ms, bound_by, parts = times["bf16"]
    return {
        "name": "subsampling_fused", "route": "cuda",
        "source": "lcasr_torch/csrc/subsampling_fused.cu",
        "replaces": "lcasr_tpu/ops/subsampling_pallas.py:281",
        "replaces_fn": "lcasr_tpu/ops/subsampling_pallas.py:_fused_kernel",
        "launches": None, "max_abs_err": worst["bf16"], "max_abs_err_fp32": worst["fp32"],
        "ms": ms, "plain_ms": plain_ms, "conv_chain_with_copy_ms": chain_copy_ms,
        "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by, "bound_parts": parts,
        "ms_fp32": times["fp32"][0], "plain_ms_fp32": times["fp32"][1],
        "bound_ms_fp32": times["fp32"][3], "silu_tail_share": tail_share,
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

    def chain(h, params, act="silu", causal=False, seq=None):
        return real(h.float(), [p.float() for p in params], act, causal, seq).to(h.dtype)

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

    def chain(h, params, act="silu", causal=False, seq=None):
        y = real(h, params, act, causal, seq)
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=False):
            other = real(h, params, act, causal, seq)
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


# one CTC loss, forward and backward, a training micro step on the card
CTC_LAUNCHES = {"ctc_alpha": 1, "ctc_beta": 1}
# every LayerNorm and RMSNorm on the card: they run on both sides of each
# comparison here, and phase `norms` and tests/test_torch_port_norm_kernel.py
# count them
NORM_LAUNCHES = ("layer_norm_fwd", "layer_norm_bwd", "rms_norm_fwd", "rms_norm_bwd")


def without_norms(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if k not in NORM_LAUNCHES}


def require_launches(some: bool, what: str) -> None:
    """Raise unless kernels were launched since the counts were last zeroed
    (`some`) or none was (not `some`): a comparison of the kernels with their
    plain versions must run the kernels on one side only.  The CTC and
    row-norm kernels are not counted: a model runs them on both sides of the
    comparisons that hold the other kernels to their plain versions."""
    from lcasr_torch import kernels

    n = sum(v for k, v in without_norms(kernels.launch_counts).items() if k not in CTC_LAUNCHES)
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
    of every other kernel but the row norms'."""
    from lcasr_torch import kernels

    launches = dict(kernels.launch_counts)
    counted = without_norms(launches)
    if counted != dict(dict.fromkeys(counted, 0), **expected):
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
        self.make_model, self.per_micro = make_model, {**per_micro, **CTC_LAUNCHES}
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
        """`launches` as they must read after `micro` micro steps, the row
        norms' as they read."""
        norms = {k: v for k, v in launches.items() if k in NORM_LAUNCHES}
        return dict(dict.fromkeys(launches, 0), **norms,
                    **{k: v * micro for k, v in self.per_micro.items()})

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

    def make_chunks_both_ways(self, batch) -> dict:
        """`make_chunks` of one 16384 x 4 batch with the Python BPE and with
        the native BPE, in turns (Python, native, native, Python), each the
        median of 3 calls; the two give the same chunks."""
        import numpy as np

        from lcasr_torch.data.tokenizer import load_tokenizer
        from lcasr_torch.training.trainer import make_chunks

        toks = {"python": load_tokenizer(use_native=False), "native": self.tok}
        chunks = {kind: make_chunks(*batch[:3], tok, PODCAST_FRAMES, 0, tok.pad_id())
                  for kind, tok in toks.items()}
        if not (len(chunks["python"]) == len(chunks["native"]) and all(
                np.array_equal(a[k], b[k]) for a, b in zip(chunks["python"], chunks["native"])
                for k in a)):
            raise AssertionError("make_chunks differs between the Python and the native BPE")
        turns = {"python": [], "native": []}
        for kind in ("python", "native", "native", "python"):
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                make_chunks(*batch[:3], toks[kind], PODCAST_FRAMES, 0, toks[kind].pad_id())
                times.append((time.perf_counter() - t0) * 1e3)
            turns[kind].append(float(np.median(times)))
        n_words = sum(len(t) for t in batch[2])
        log(f"  {self.what} make_chunks of one 16384x4 batch ({n_words} words), labels equal: "
            f"Python BPE {turns['python']} ms, native BPE {turns['native']} ms (turns)")
        return {"make_chunks_ms_python": turns["python"], "make_chunks_ms_native": turns["native"]}

    def host_side_runs(self, model) -> dict:
        """One epoch of the 16 podcasts at 16384 x 4 (4 optimizer steps, a
        batch each) through `Trainer.train` with the Python data path (no
        prefetch, the Python BPE and `np.load`) and with the native one
        (the prefetch thread, the native BPE and the native reader), in
        turns (python, native, native, python): the steady step is the
        median gap between the optimizer steps' log rows, which spans
        loading, make_chunks, the micro step and the optimizer step.  Then
        one profiled epoch of each for the device's idle share.  No
        checkpoint is written at the end of these epochs."""
        import tempfile

        import numpy as np

        from lcasr_torch.config import Config
        from lcasr_torch.data.dataloading import VariableBatchSimpleDataloader
        from lcasr_torch.data.tokenizer import load_tokenizer
        from lcasr_torch.training.trainer import Trainer

        torch = self.torch
        base = merged({k: v for k, v in self.cfg_d.items() if k != "sequence_scheduler"},
                      {"audio_chunking": {"size": PODCAST_FRAMES}, "training": {"batch_size": 4}})
        toks = {"python": load_tokenizer(use_native=False), "native": self.tok}

        def epoch(kind, profile_file=None):
            ckpt = tempfile.mkdtemp(dir=self.tmp)
            tr = Trainer(Config(merged(base, {"checkpointing": {"dir": ckpt}})), model,
                         toks[kind], device=DEVICE)
            tr.init_state()
            tr.save = lambda *a, **k: None
            new = kind == "native"
            loader = VariableBatchSimpleDataloader(
                self.pairs, toks[kind], batch_size=4, chunk_size=PODCAST_FRAMES,
                chunk_overlap=0, prefetch=new, native=new)
            torch.cuda.synchronize()
            if profile_file:
                return profile_idle_share(profile_run(
                    torch, lambda: tr.train(loader), profile_file,
                    f"one {self.what} epoch, {kind} data path"), profile_file)
            tr.train(loader)
            torch.cuda.synchronize()
            ts = [json.loads(line)["ts"] for line in open(os.path.join(ckpt, "metrics.jsonl"))
                  if '"loss"' in line]
            gaps = [(b - a) * 1e3 for a, b in zip(ts, ts[1:])]
            if len(ts) != N_PODCASTS // 4:
                raise AssertionError(f"{len(ts)} optimizer steps in an epoch of {N_PODCASTS} "
                                     f"podcasts at batch 4")
            return float(np.median(gaps)), gaps

        steps = {"python": [], "native": []}
        for kind in ("python", "native", "native", "python"):
            med, gaps = epoch(kind)
            steps[kind].append(med)
            log(f"  {self.what} 16384x4 epoch, {kind} data path: step gaps "
                f"{[round(g, 2) for g in gaps]} ms, steady {med:.2f} ms")
        idle = {kind: epoch(kind, f"{self.what.lower()}_epoch_{kind}_profile.txt")
                for kind in ("python", "native")}
        log(f"  {self.what} steady 16384x4 step: Python data path {steps['python']} ms, "
            f"native {steps['native']} ms (turns); device idle share over a profiled epoch: "
            f"Python {idle['python']}, native {idle['native']}")
        return {"step_ms_python": steps["python"], "step_ms_native": steps["native"],
                "idle_share_python": idle["python"], "idle_share_native": idle["native"]}

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

    def long_step(self, model, kernel_prefixes=()):
        """One optimizer step of the 20-minute bucket: 120,000 frames x 1.
        With `kernel_prefixes`, the step runs under torch.profiler (device
        activity only) and {prefix: device ms of the kernels whose names
        contain it} is returned (the step's wall time then includes the
        profiler)."""
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
        if kernel_prefixes:
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
        # one step logs one row and has no row before it to time it from:
        # its time is then the whole run's
        ms = step_times(metrics_path).get(LONG_FRAMES, [(1e3 * long_s, None)])[0][0]
        peak = torch.cuda.max_memory_allocated() / 1e9
        log(f"  120000x1 {self.what} step: loss {loss}, step {ms:.2f} ms "
            f"({LONG_FRAMES * 0.01 / (ms / 1e3):.1f} audio-s/s), run {long_s:.2f} s, peak memory "
            f"{peak:.2f} GB, launches {launches}")
        if not (len(loss) == 1 and np.isfinite(loss[0])
                and launches == self.expected(launches, 1)):
            raise AssertionError(f"the 120000-frame {self.what} step failed")
        if prof is None:
            return None
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        kernel_ms = {prefix: sum(e.self_device_time_total for e in events if prefix in e.key) / 1e3
                     for prefix in kernel_prefixes}
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        log(f"  120000x1 {self.what} step (profiler on): device busy {busy_ms:.3f} ms; "
            + ", ".join(f"{p}* kernels {v:.3f} ms ({100 * v / max(busy_ms, 1e-9):.1f}%)"
                        for p, v in kernel_ms.items()))
        kernel_ms["busy"] = busy_ms
        return kernel_ms


def profile_share(rows, prefix: str, what: str, where: str) -> dict:
    """{"ms", "launches", "share"} of the kernels whose names contain
    `prefix` in `profile_run`'s rows."""
    mine = [r for r in rows if prefix in r[2]]
    busy_us = sum(r[0] for r in rows)
    out = {"ms": sum(r[0] for r in mine) / 1e3, "launches": sum(r[1] for r in mine),
           "share": sum(r[0] for r in mine) / busy_us if busy_us else None}
    log(f"  {what} in {where}'s profile: {out['ms']:.3f} ms in {out['launches']} kernel "
        f"launches, {out['share']} of the device time")
    return out


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
                  kernel_ctx=None, plain_contexts: bool = True, shape: str = "16384x4",
                  min_numel: int = 0):
    """One 16384 x 4 micro step with the kernels (inside `kernel_ctx`, when
    given), again (the step may not be reproducible), inside each context of
    `yardsticks` ({name: context}) and inside `ref_ctx` (the reference), on
    the same weights and batch.  `plain_contexts`: the yardsticks and the
    reference must launch no kernel (they are plain versions); False when the
    reference is another configuration of the kernels, whose launches the
    caller checks.  The loss must lie within LOSS_REL_MAX of the reference's;
    the gradient's relative L2 error and worst per-tensor cosine deficit
    (1 - cos) against the reference within `floors` + YARDSTICK_FACTOR times
    the largest of the yardsticks', and never past the absolute caps.
    `min_numel`: tensors of fewer values stay out of the cosines (they stay
    in the relative L2 error): the long convolution's three base rates have
    a gradient that is a sum of large terms cancelling, whose direction
    rounding alone turns around."""
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
    names = [n for n in g_r if g_r[n].norm().item() > 1e-4 * den ** 0.5
             and g_r[n].numel() >= min_numel]
    kr, kc, kn = grad_error(g_k, g_r, names)
    rerun, rerun_c, _ = grad_error(g_k2, g_k, names)
    kl = abs(loss_k - loss_r) / abs(loss_r)
    yard = {name: (abs(loss - loss_r) / abs(loss_r), *grad_error(g, g_r, names))
            for name, (loss, g) in yard_steps.items()}
    yr = max(y[1] for y in yard.values())
    yd = max(1 - y[2] for y in yard.values())
    l2_max = min(GRAD_REL_L2_MAX, floors[0] + YARDSTICK_FACTOR * yr)
    cos_max = min(1 - GRAD_COS_MIN, floors[1] + YARDSTICK_FACTOR * yd)
    verdict = (f"{shape} {what} step against {ref_name} (loss {loss_r:.4f}; cosines over "
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
    from lcasr_torch.training.trainer import Trainer

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
    host = run.make_chunks_both_ways(batch)
    host["remat_dots"] = remat_dots_step(torch, model, one_step)
    trainer.zero_pending()
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

    host.update(run.host_side_runs(model))
    run.long_step(model)
    return launches, band_launches, k3_step, host


@contextlib.contextmanager
def remat_policy(model, policy: str):
    """The model's checkpointed layers under another remat policy while
    inside (the attribute `SCConformerXL.__init__` sets from it)."""
    from lcasr_torch.models import sconformer_xl

    old = model.remat_contexts
    model.remat_contexts = {"nothing": sconformer_xl._remat_contexts,
                            "dots": sconformer_xl._remat_contexts_dots}[policy]
    try:
        yield
    finally:
        model.remat_contexts = old


# one 16384 x 4 flagship micro step under remat_policy "dots": the matrix
# products' outputs are saved, and K1 (no aten op) is recomputed, as JAX's
# dots_saveable recomputes its Pallas call: per layer K1 in the forward and
# again in the recompute, K3 once
DOTS_LAUNCHES = {"flash_attention_fwd": 18, "flash_attention_bwd_fused": 9, **CTC_LAUNCHES}
# "dots" computes what "nothing" computes, so the two steps differ only as
# two runs of one step do (K3's dq atomics); these floors keep a rerun that
# happens to repeat the bits from closing the gate at 0
DOTS_FLOORS = (1e-4, 1e-6)


def remat_dots_step(torch, model, one_step) -> dict:
    """The flagship's 16384 x 4 micro step under remat_policy "dots": its
    launch counts, its peak memory beside "nothing"'s, and its gradients
    held to "nothing"'s by the gradient gate, whose yardstick is a rerun of
    the "nothing" step (K3 adds dq by atomics, so two runs differ)."""
    from lcasr_torch import kernels

    peaks = {}
    for policy in ("nothing", "dots"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        with remat_policy(model, policy):
            one_step()
        torch.cuda.synchronize()
        peaks[policy] = torch.cuda.max_memory_allocated() / 1e9
        launches = expect_launches(DOTS_LAUNCHES, f"one flagship micro step, remat {policy}")
    log(f"  flagship 16384x4 micro step: launches under remat dots {launches}; peak memory "
        f"{peaks['dots']:.2f} GB under dots, {peaks['nothing']:.2f} GB under nothing")
    gate = gradient_gate("flagship under remat_policy dots", "remat_policy nothing", one_step,
                         contextlib.nullcontext(), {"a rerun": contextlib.nullcontext()},
                         floors=DOTS_FLOORS, kernel_ctx=remat_policy(model, "dots"),
                         plain_contexts=False)
    return {"launches": launches, "peak_gb_dots": peaks["dots"],
            "peak_gb_nothing": peaks["nothing"], "gate": gate}


# ---------------------------------------------------------------------------
# phase 5b: lcasr_6l_768d_3h (head_dim 256) trains on K1 and K3
# ---------------------------------------------------------------------------
# configs/model_zoo.yaml:63-68 on the ladder configuration: 3 heads x 256
D256_TRAIN_CONFIG = merged(LADDER_CONFIG, {"model": {"n_layers": 6, "n_heads": 3,
                                                     "head_dim": 256}})
# per micro step: K1 in each layer's forward and recompute, K3 once a layer
D256_TRAIN_LAUNCHES = {"flash_attention_fwd": 12, "flash_attention_bwd_fused": 6,
                       **CTC_LAUNCHES}
D256_OPT_STEPS = 5


def phase_train_d256(torch, workdir: str) -> dict:
    """lcasr_6l_768d_3h at its full size: one 16384 x 4 micro step with its
    launch counts, the gradient gate against plain fp32 attention (plain
    bf16 attention the yardstick), D256_OPT_STEPS optimizer steps on the
    same chunk with a finite, falling loss, and the steady step's wall and
    device busy time."""
    import numpy as np

    from lcasr_torch import kernels
    from lcasr_torch.models.registry import load_model
    from lcasr_torch.models.sconformer_xl import init_weights_
    from lcasr_torch.training.trainer import Trainer

    def fresh_model(seed, config):
        return init_weights_(load_model(config, 4095, device=DEVICE), seed=seed)

    run = TrainRun(torch, workdir, D256_TRAIN_CONFIG, fresh_model, D256_TRAIN_LAUNCHES,
                   "lcasr_6l_768d_3h")
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

    kernels.reset_launch_counts()
    one_step()
    launches = expect_launches(D256_TRAIN_LAUNCHES, "one lcasr_6l_768d_3h micro step")
    gate = gradient_gate("lcasr_6l_768d_3h", "plain fp32 attention", one_step, plain_attention(),
                         {"plain bf16 attention": plain_attention(bf16=True)})
    losses = []
    for _ in range(D256_OPT_STEPS):
        trainer.zero_pending()
        loss, _ = trainer.micro_step(chunk)
        trainer.fold_group(100.0 / (PODCAST_FRAMES * 4))
        trainer.optimizer_step(3e-4)
        losses.append(float(loss))
    log(f"  lcasr_6l_768d_3h: {D256_OPT_STEPS} optimizer steps on one 16384x4 chunk, "
        f"loss {[round(x, 3) for x in losses]}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"lcasr_6l_768d_3h loss {losses} is not finite and falling")
    rows = run.timed_step(trainer, chunk, "train_d256_profile.txt")
    return {"launches": launches, "gate": gate, "losses": losses,
            "device_busy_ms": sum(r[0] for r in rows) / 1e3}


# ---------------------------------------------------------------------------
# phase 5c: presegmented utterances, debug hooks, wild-card CTC
# ---------------------------------------------------------------------------
N_UTTERANCES, UTTERANCE_FRAMES, UTTERANCE_BATCH = 64, 2048, 16
WCTC_SHAPE = (4, 256, 4096, 40)  # (B, T, classes, labels): a 2048-frame batch's lattice
WCTC_TOL = 1e-4  # of the CPU's largest |value| / |gradient|: fp32 sums in another order


def phase_utterances(torch, workdir: str) -> dict:
    """64 seeded 2048-frame utterances written by `save_utterances`, then
    the flagship trained on them through `Trainer.train_utterances` (4
    optimizer steps of 16) with `debug_hooks` on: every step's loss finite,
    its gradient statistics logged with a finite global norm, and 18 K1 and
    9 K3 launches a step.  Then `wctc_loss` on the card, its value and
    gradient in each mode against the CPU's."""
    import tempfile

    import numpy as np

    from lcasr_torch import kernels
    from lcasr_torch.config import Config
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.data.utterances import UtteranceDataloader, save_utterances
    from lcasr_torch.models.registry import load_model
    from lcasr_torch.models.sconformer_xl import init_weights_
    from lcasr_torch.ops.ctc import wctc_loss
    from lcasr_torch.training.trainer import Trainer

    tmp = tempfile.mkdtemp(dir=workdir)
    per_rec = PODCAST_FRAMES // UTTERANCE_FRAMES
    pairs = make_corpus(tmp, [PODCAST_FRAMES] * (N_UTTERANCES // per_rec), seed=4)
    tok = load_tokenizer()
    utt_dir = os.path.join(tmp, "utterances")
    t0 = time.perf_counter()
    saved = save_utterances(pairs, utt_dir, tok, chunk_size=UTTERANCE_FRAMES)
    save_s = time.perf_counter() - t0
    if len(saved) != N_UTTERANCES:
        raise AssertionError(f"save_utterances wrote {len(saved)} files, not {N_UTTERANCES}")
    cfg = Config(merged({k: v for k, v in LADDER_CONFIG.items() if k != "sequence_scheduler"},
                        {"training": {"batch_size": UTTERANCE_BATCH},
                         "data": {"utterances_dir": utt_dir},
                         "checkpointing": {"dir": os.path.join(tmp, "ckpt")}}))
    model = init_weights_(load_model(cfg, tok.vocab_size(), device=DEVICE), seed=0)
    trainer = Trainer(cfg, model, tok, device=DEVICE)
    trainer.debug_hooks = True
    loader = UtteranceDataloader(utt_dir, batch_size=UTTERANCE_BATCH,
                                 random_seed=cfg["training"]["random_seed"])
    n_steps = N_UTTERANCES // UTTERANCE_BATCH
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    steps = trainer.train_utterances(loader)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = expect_launches({"flash_attention_fwd": 18 * n_steps,
                                "flash_attention_bwd_fused": 9 * n_steps,
                                **{k: v * n_steps for k, v in CTC_LAUNCHES.items()}},
                               f"{n_steps} utterance steps")
    rows = [json.loads(line) for line in open(os.path.join(tmp, "ckpt", "metrics.jsonl"))]
    losses = [r["loss"] for r in rows if "utterance_step" in r]
    norms = [r["grad/global_norm"] for r in rows if "grad/global_norm" in r]
    n_stats = max(len(r) for r in rows if "grad/global_norm" in r) if norms else 0
    log(f"  {N_UTTERANCES} utterances saved in {save_s:.2f} s; train_utterances: {steps} steps "
        f"in {train_s:.2f} s, loss {[round(x, 3) for x in losses]}, grad/global_norm "
        f"{[round(x, 4) for x in norms]} ({n_stats} statistics a step), launches {launches}")
    if not (steps == n_steps and len(losses) == n_steps and all(np.isfinite(losses))
            and len(norms) == n_steps and all(np.isfinite(norms))):
        raise AssertionError("utterance training: a step, a loss or a gradient norm is missing "
                             "or not finite")
    del trainer, model

    # wild-card CTC on the card against the CPU, every mode, ragged lengths
    B, T, C, U = WCTC_SHAPE
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(B, T, C)).astype(np.float32)).log_softmax(-1)
    labels = torch.from_numpy(rng.integers(0, C - 1, (B, U)))
    il = torch.tensor([T, T - 37, T // 2, T - 1])
    ll = torch.tensor([U, U - 9, U // 2, 0])
    wctc = {}
    for mode in ("soft", "max_prob", "sum_prob"):
        out = {}
        for dev in ("cpu", DEVICE):
            lp = x.to(dev).detach().requires_grad_()
            t0 = time.perf_counter()
            value = wctc_loss(lp, labels.to(dev), il.to(dev), ll.to(dev), mode=mode)
            value.backward()
            if dev != "cpu":
                torch.cuda.synchronize()
            out[dev] = (value.item(), lp.grad.cpu(), (time.perf_counter() - t0) * 1e3)
        v_err = abs(out[DEVICE][0] - out["cpu"][0]) / abs(out["cpu"][0])
        g_err = float((out[DEVICE][1] - out["cpu"][1]).abs().max() / out["cpu"][1].abs().max())
        log(f"  wctc_loss {mode} at {WCTC_SHAPE}: value {out[DEVICE][0]:.4f} (rel {v_err:.2e} "
            f"against the CPU), gradient {g_err:.2e} of the largest; card {out[DEVICE][2]:.1f} "
            f"ms with the backward, CPU {out['cpu'][2]:.1f} ms (tolerance {WCTC_TOL:g})")
        if not (v_err <= WCTC_TOL and g_err <= WCTC_TOL):
            raise AssertionError(f"wctc_loss {mode} on the card disagrees with the CPU")
        wctc[mode] = {"value_rel_err": v_err, "grad_err": g_err, "card_ms": out[DEVICE][2]}
    return {"steps": steps, "losses": losses, "global_norms": norms, "launches": launches,
            "wctc": wctc}


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
                      "subsampling_fused": 2, **CTC_LAUNCHES}
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
                     "flash_attention_bwd_fused": OPT_TRAIN_LAUNCHES["flash_attention_bwd_fused"],
                     **CTC_LAUNCHES},
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
    batch, chunk = run.chunk_16384x4()

    def one_step():
        trainer.zero_pending()
        loss, _ = trainer.micro_step(chunk)
        return float(loss), flat_grads(model)

    gradient_gate("Mamba", "the plain scan in fp64", one_step, plain_scan(torch.float64),
                  {"the plain scan in fp32": plain_scan(torch.float32)},
                  floors=(MAMBA_REL_L2_FLOOR, MAMBA_COS_FLOOR))
    trainer.zero_pending()
    rows = run.timed_step(trainer, chunk, "mamba_train_profile.txt")
    fwd_prefix, bwd_prefix = (SSM_KERNELS[k][0] for k in ("selective_scan_fwd",
                                                           "selective_scan_bwd"))
    k6_step = profile_share(rows, fwd_prefix, "K6", "the 16384x4 Mamba step")
    k7_step = profile_share(rows, bwd_prefix, "K7 (5 kernels a call)", "the 16384x4 Mamba step")
    host = run.make_chunks_both_ways(batch)
    host.update(run.host_side_runs(model))
    long_ms = run.long_step(model, kernel_prefixes=(fwd_prefix, bwd_prefix))
    k6_step["long_step_ms"], k7_step["long_step_ms"] = long_ms[fwd_prefix], long_ms[bwd_prefix]
    return launches, k6_step, k7_step, host


# ---------------------------------------------------------------------------
# phases 10 and 11: from a WAV file to a transcript and a WER, and the
# streaming server
# ---------------------------------------------------------------------------
WAV_SECONDS, WAV_RATE = 20 * 60, 44_100  # the paper's 20-minute bucket, a CD rate
D256_MODEL = dict(n_layers=6, n_heads=3, head_dim=256)  # configs/model_zoo.yaml:63-68
SERVE_STREAMS, SERVE_SECONDS, SERVE_CHUNK_S = 4, 60, 0.5
SERVE_KW = dict(context_frames=2048, stride_frames=512, right_delay_frames=512)
# the card's fp32 mel against the plain float64 frontend on the CPU, both
# normalised: fp32 FFT and filterbank sums carry ~1e-7 of each frame's
# power; after the per-bin normalisation that stays far below this
MEL_TOL = 1e-4  # of the largest |value|
RESAMPLE_TOL = 1e-5  # of the largest |sample|: fp32 taps and sums against float64


def amw_forwards(n_frames: int) -> int:
    """Forwards of an averaged-moving-window decode of n_frames: window
    batches of WINDOW_BATCH (4 at 120,000 frames)."""
    from lcasr_torch.evaluation.streaming import _window_positions

    return -(-len(_window_positions(n_frames, SEQ_LEN, OVERLAP)) // WINDOW_BATCH)


def buffered_forwards(n_frames: int) -> int:
    """Forwards of a buffered decode: one per chunk of SEQ_LEN - OVERLAP
    frames (59 at 120,000 frames)."""
    return -(-n_frames // (SEQ_LEN - OVERLAP))


def write_wav(path: str, seconds: int, rate: int, seed: int) -> None:
    """A stereo int16 WAV of tones that glide and noise, from `seed`,
    written with its RIFF header by hand (the port reads it)."""
    import struct

    import numpy as np

    rng = np.random.default_rng(seed)
    n = seconds * rate
    t = np.arange(n, dtype=np.float64) / rate
    f = 220.0 * 2 ** (np.sin(2 * np.pi * t / 7.0) + 0.5 * np.sin(2 * np.pi * t / 53.0))
    phase = 2 * np.pi * np.cumsum(f) / rate
    left = 0.35 * np.sin(phase) + 0.15 * np.sin(3.01 * phase) + 0.05 * rng.standard_normal(n)
    right = 0.3 * np.sin(2 * np.pi * 330.0 * t) + 0.05 * rng.standard_normal(n)
    data = np.clip(np.stack([left, right], 1) * 32767, -32768, 32767).astype("<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, 2, rate, rate * 4, 4, 16)
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(data)) + b"WAVE")
        fh.write(b"fmt " + struct.pack("<I", len(fmt)) + fmt)
        fh.write(b"data" + struct.pack("<I", len(data)) + data)


def save_port_checkpoint(torch, directory: str, model_cfg: dict, seed: int) -> str:
    """A checkpoint directory of the port (`training/checkpointing.py`) for
    an SCConformerXL of `model_cfg` (bf16 compute), weights from `seed`."""
    from lcasr_torch.config import Config
    from lcasr_torch.models.sconformer_xl import SCConformerXL, init_weights_
    from lcasr_torch.training.checkpointing import save_checkpoint

    model = init_weights_(SCConformerXL(**model_cfg, dtype=torch.bfloat16, device="cpu"), seed)
    cfg = {k: v for k, v in model_cfg.items() if k != "vocab_size"}
    return save_checkpoint(directory, 0, model.state_dict(),
                           config=Config({"model": dict(cfg, dtype="bfloat16")}))


def rev16_layout(base: str, wav: str, text: str) -> None:
    """The rev16 adapter's layout (test.txt, audio/<id>.wav,
    transcripts/<id>.txt) around one file, so that `evaluate` reads it."""
    os.makedirs(os.path.join(base, "audio"), exist_ok=True)
    os.makedirs(os.path.join(base, "transcripts"), exist_ok=True)
    os.replace(wav, os.path.join(base, "audio", "smoke.wav"))
    with open(os.path.join(base, "test.txt"), "w") as fh:
        fh.write("smoke")
    with open(os.path.join(base, "transcripts", "smoke.txt"), "w") as fh:
        fh.write(text)


def synced_s(torch, fn, n: int = 3):
    """(result, median wall seconds of n synchronised calls after a warm one)."""
    import numpy as np

    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, float(np.median(times))


def run_evaluate(checkpoint: str, expected: dict, what: str, **kw):
    """`evaluate` with the launch counts zeroed just before and read just
    after: they must be `expected` (0 of every other kernel)."""
    import math

    from lcasr_torch import kernels
    from lcasr_torch.evaluation.run import evaluate

    kernels.reset_launch_counts()
    summary = evaluate(checkpoint=checkpoint, verbose=False, device=DEVICE, **kw)
    launches = expect_launches(expected, what)
    rows = summary["rows"]
    if not rows or any(r["words"] <= 0 or not math.isfinite(r["wer"]) for r in rows):
        raise AssertionError(f"{what}: rows {rows}")
    if summary["device"] != DEVICE:
        raise AssertionError(f"{what} ran on {summary['device']}")
    log(f"  {what}: {len(rows)} row(s), WER {summary['wer']:.4f} over {summary['words']} "
        f"words, RTFx {summary['rtfx']:.1f}, launches {launches}")
    return summary, launches


def phase_audio(torch, workdir: str, seed: int) -> dict:
    """A seeded 20-minute stereo WAV at 44.1 kHz through the port's
    frontend on the card (timed, and held against the plain float64 CPU
    frontend), then through `evaluate`: the flagship's averaged moving
    window (36 K1 launches), the three modes on `synthetic`, and the
    head_dim-256 model (24 K1 launches; again on K2 under its flag)."""
    import math

    import numpy as np

    from lcasr_torch.data import audio
    from lcasr_torch.data.audio import (
        SR, grab_left_channel, load_audio, load_left_channel, mel_spectrogram, resample)
    from lcasr_torch.models.sconformer_xl import FLAGSHIP

    wav = os.path.join(workdir, "smoke.wav")
    write_wav(wav, WAV_SECONDS, WAV_RATE, seed)
    out = {}
    # the host parse of `load_audio` (both channels converted, the left one
    # copied out) and of `load_left_channel` (the left channel, one copy),
    # in turns
    def both_channels():
        wave, sr = load_audio(wav)
        return np.ascontiguousarray(grab_left_channel(wave)), sr

    parse = {"both": [], "left": []}
    lefts = {}
    for kind, fn in (("both", both_channels), ("left", lambda: load_left_channel(wav)),
                     ("left", lambda: load_left_channel(wav)), ("both", both_channels)):
        t0 = time.perf_counter()
        lefts[kind] = fn()
        parse[kind].append(1e3 * (time.perf_counter() - t0))
    (left_np, sr), (left_both, _) = lefts["left"], lefts["both"]
    if not np.array_equal(left_np, left_both):
        raise AssertionError("the left channel differs between the two host parses")
    load_s = min(parse["left"]) / 1e3
    # the frontend, stage by stage: host parse, then the card
    left = torch.from_numpy(left_np).to(DEVICE)
    wave16, resample_s = synced_s(torch, lambda: resample(left, sr, SR))
    mel, mel_s = synced_s(torch, lambda: mel_spectrogram(wave16))
    mel_both = mel_spectrogram(resample(torch.from_numpy(left_both).to(DEVICE), sr, SR))
    if not torch.equal(mel, mel_both):
        raise AssertionError("the mel differs between the two host parses")
    log(f"  host WAV parse of {WAV_SECONDS} s stereo int16 at {sr} Hz: load_audio (both "
        f"channels) {[round(x, 1) for x in parse['both']]} ms, load_left_channel "
        f"{[round(x, 1) for x in parse['left']]} ms (turns); the mel the same bits")
    out.update(parse_ms_both_channels=parse["both"], parse_ms_left_channel=parse["left"])
    wave = np.ascontiguousarray(left_np)
    if tuple(mel.shape) != (1, 80, WAV_SECONDS * 100 + 1) or not torch.isfinite(mel).all():
        raise AssertionError(f"mel {tuple(mel.shape)}, finite {bool(torch.isfinite(mel).all())}")
    # the plain float64 frontend on the CPU on the same samples: the
    # resampler on the first minute, the mel on the whole 16 kHz waveform
    head = torch.from_numpy(wave[:, : 60 * sr].astype(np.float64))
    g = math.gcd(sr, SR)
    ref16 = audio._resample_poly(head, SR // g, sr // g)  # float64 on the CPU
    got16 = resample(head.to(DEVICE).float(), sr, SR).double().cpu()
    r_err = float((got16 - ref16).abs().max() / ref16.abs().max())
    ref_mel = mel_spectrogram(wave16.double().cpu())
    m_err = float((mel.double().cpu() - ref_mel).abs().max() / ref_mel.abs().max())
    log(f"  frontend of {WAV_SECONDS} s at {sr} Hz stereo int16: host parse {1e3 * load_s:.1f} ms "
        f"(host), resample on the card {1e3 * resample_s:.2f} ms, mel {1e3 * mel_s:.2f} ms; "
        f"card against float64 CPU: resample {r_err:.2e} (tol {RESAMPLE_TOL:g}), mel "
        f"{m_err:.2e} of the largest value (tol {MEL_TOL:g})")
    if not (r_err <= RESAMPLE_TOL and m_err <= MEL_TOL):
        raise AssertionError(f"the card's frontend disagrees: resample {r_err}, mel {m_err}")
    out.update(load_audio_ms=1e3 * load_s, resample_ms=1e3 * resample_s, mel_ms=1e3 * mel_s,
               resample_err=r_err, mel_err=m_err)
    del left, wave16, mel, mel_both, ref_mel, wave, lefts, left_np, left_both

    base = os.path.join(workdir, "rev16")
    rev16_layout(base, wav, "the podcast has these words about long context speech")
    flagship = save_port_checkpoint(torch, os.path.join(workdir, "flagship"), FLAGSHIP, seed)
    d256 = save_port_checkpoint(torch, os.path.join(workdir, "d256"),
                                dict(FLAGSHIP, **D256_MODEL), seed)
    amw = dict(seq_len=SEQ_LEN, overlap=OVERLAP)
    wav_kw = dict(dataset="rev16", dataset_kwargs={"base_path": base}, **amw)
    n_layers = FLAGSHIP["n_layers"]
    # `synthetic` first: its first decode also warms the process up (the
    # RTFx of `evaluate` times the decode of each recording, not the frontend)
    synth = dict(dataset="synthetic", dataset_kwargs={"n_recordings": 1,
                                                      "n_frames": TOTAL_FRAMES})
    for mode, n_fwd in (("averaged_moving_window", amw_forwards(TOTAL_FRAMES)),
                        ("buffered", buffered_forwards(TOTAL_FRAMES)),
                        ("windowed_attention", 1)):
        summary, launches = run_evaluate(
            flagship, {"flash_attention_fwd": n_layers * n_fwd},
            f"flagship, synthetic 120,000 frames, {mode}", evaluation_mode=mode, **synth, **amw)
        out[f"synthetic_{mode}"] = {"rtfx": summary["rtfx"], "wer": summary["wer"],
                                    "launches": launches["flash_attention_fwd"]}
    wav_fwd = amw_forwards(WAV_SECONDS * 100 + 1)
    summary, _ = run_evaluate(flagship, {"flash_attention_fwd": n_layers * wav_fwd},
                              "flagship, WAV -> WER, averaged moving window", **wav_kw)
    decode_ms = 1e3 * WAV_SECONDS / summary["rtfx"]
    frontend_ms = out["load_audio_ms"] + out["resample_ms"] + out["mel_ms"]
    share = frontend_ms / (frontend_ms + decode_ms)
    log(f"  the frontend's share of the 20-minute decode from the WAV file: {frontend_ms:.1f} ms "
        f"of {frontend_ms + decode_ms:.1f} ms ({100 * share:.1f}%; the host's WAV parse "
        f"{out['load_audio_ms']:.1f} ms of it)")
    out["wav_flagship"] = {"rtfx": summary["rtfx"], "wer": summary["wer"],
                           "decode_ms": decode_ms, "frontend_share": share}
    d256_launches = D256_MODEL["n_layers"] * wav_fwd
    summary, _ = run_evaluate(d256, {"flash_attention_fwd": d256_launches},
                              "lcasr_6l_768d_3h (D = 256), WAV -> WER", **wav_kw)
    out["wav_d256"] = {"rtfx": summary["rtfx"], "launches": d256_launches}
    with env_flags(LCASR_ATTN_FWD_DB="1"):
        summary, _ = run_evaluate(d256, {"flash_attention_fwd_db": d256_launches},
                                  "lcasr_6l_768d_3h (D = 256) under LCASR_ATTN_FWD_DB=1",
                                  **wav_kw)
    out["wav_d256_k2"] = {"rtfx": summary["rtfx"], "launches": d256_launches}
    return out


def finalised_frames(tr) -> list:
    """The argmax id of every output frame `tr` finalises, in order (before
    the CTC collapse), recorded from its `_emit`."""
    import numpy as np

    out, real = [], tr._emit

    def emit(g0, g1, win_start, frame_ids, out_len, tail):
        r0 = (g0 - win_start) // tr.sf
        r1 = out_len if tail else min((g1 - win_start) // tr.sf, out_len)
        out.extend(np.asarray(frame_ids[r0:r1]).tolist())
        return real(g0, g1, win_start, frame_ids, out_len, tail)

    tr._emit = emit
    return out


def phase_serve(torch, workdir: str, seed: int) -> dict:
    """The flagship behind a TranscriptionServer: 4 sessions, each fed 60 s
    of a seeded WAV's left channel in 0.5 s chunks, pumped once a tick;
    every session's finalised frame ids (and so its token ids) equal to a
    single-stream OnlineTranscriber's on the same chunks; pump latency and
    the streams' RTFx; then the serving CLI as a subprocess on a WAV file of
    its own."""
    import numpy as np

    from lcasr_torch import kernels
    from lcasr_torch.data.audio import SR, grab_left_channel, load_audio, resample
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.models.sconformer_xl import FLAGSHIP
    from lcasr_torch.serving import OnlineTranscriber, TranscriptionServer

    wav = os.path.join(workdir, "serve.wav")
    write_wav(wav, SERVE_STREAMS * SERVE_SECONDS, WAV_RATE, seed + 1)
    wave, sr = load_audio(wav)
    left = resample(grab_left_channel(wave), sr, SR, device=DEVICE)[0].cpu().numpy()
    n = SERVE_SECONDS * SR
    streams = [left[i * n : (i + 1) * n] for i in range(SERVE_STREAMS)]
    chunk = int(SERVE_CHUNK_S * SR)
    tok = load_tokenizer()
    model = flagship_model(torch)

    server = TranscriptionServer(model, tok, max_streams=SERVE_STREAMS, device=DEVICE,
                                 **SERVE_KW)
    sids = [server.open() for _ in streams]
    frames = [finalised_frames(server._session(sid)) for sid in sids]
    kernels.reset_launch_counts()
    pump_ms, busy = [], []  # every tick's pump; the pumps that ran a wave
    t0 = time.perf_counter()
    for pos in range(0, n, chunk):
        for sid, audio in zip(sids, streams):
            server.feed(sid, audio[pos : pos + chunk], pump=False)
        t1, w0 = time.perf_counter(), server.wave_count
        server.pump()
        torch.cuda.synchronize()
        pump_ms.append(1e3 * (time.perf_counter() - t1))
        if server.wave_count > w0:
            busy.append(pump_ms[-1])
    for sid in sids:
        server.finish(sid)
    wall = time.perf_counter() - t0
    n_layers, waves = len(model.layers), server.wave_count
    launches = expect_launches({"flash_attention_fwd": n_layers * waves}, "the server's run")
    rtfx = SERVE_STREAMS * SERVE_SECONDS / wall
    log(f"  server, {SERVE_STREAMS} sessions x {SERVE_SECONDS} s in {SERVE_CHUNK_S} s chunks: "
        f"{waves} waves ({server.delta_wave_count} delta), launches {launches}; "
        f"pump over all {len(pump_ms)} ticks median {np.median(pump_ms):.2f} ms, p90 "
        f"{np.percentile(pump_ms, 90):.2f} ms; over the {len(busy)} ticks with a wave median "
        f"{np.median(busy):.2f} ms, p90 {np.percentile(busy, 90):.2f} ms; streams' RTFx "
        f"{rtfx:.1f} (fed as fast as they are taken)")

    n_ids = []
    for i, audio in enumerate(streams):
        tr = OnlineTranscriber(model, tok, device=DEVICE, **SERVE_KW)
        single = finalised_frames(tr)
        for pos in range(0, n, chunk):
            tr.feed(audio[pos : pos + chunk])
        tr.finish()
        n_ids.append(len(tr._ids))
        if single != frames[i]:
            same = sum(a == b for a, b in zip(frames[i], single))
            raise AssertionError(f"session {i}: {len(frames[i])} finalised frames from the "
                                 f"server, {len(single)} single-stream, {same} equal")
    log(f"  every session's finalised frame ids ({[len(f) for f in frames]}) equal the "
        f"single-stream transcriber's, so do its token ids ({n_ids})")
    del model, server

    # the serving CLI on a 30 s excerpt at 44.1 kHz (the resampler runs)
    ckpt = save_port_checkpoint(torch, os.path.join(workdir, "serve_ckpt"), FLAGSHIP, seed)
    clip = os.path.join(workdir, "clip.wav")
    write_wav(clip, 30, WAV_RATE, seed + 2)
    res = subprocess.run([sys.executable, "-m", "lcasr_torch.serving", ckpt, clip,
                          "--device", DEVICE],
                         capture_output=True, text=True, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = res.stdout.strip().splitlines()
    if res.returncode != 0 or not lines or not lines[-1].startswith("-- ") or len(lines) < 2:
        raise AssertionError(f"python -m lcasr_torch.serving: rc {res.returncode}, stdout "
                             f"{res.stdout[-2000:]!r}, stderr {res.stderr[-2000:]!r}")
    log(f"  python -m lcasr_torch.serving: rc 0, {len(lines) - 1} transcript lines, "
        f"'{lines[-1]}'")
    return {"pump_ms_median": float(np.median(pump_ms)),
            "pump_ms_p90": float(np.percentile(pump_ms, 90)),
            "pump_ms_median_waves": float(np.median(busy)),
            "pump_ms_p90_waves": float(np.percentile(busy, 90)),
            "waves": waves,
            "launches": launches["flash_attention_fwd"], "rtfx": rtfx}


# ---------------------------------------------------------------------------
# phase 14: the encoder-decoder family (EncDecSconformer, V2)
# ---------------------------------------------------------------------------
# lcasr_tpu/models/enc_dec_sconformer.py:364-388, the class defaults, written
# out: 6 encoder layers, d_model 768, 6 heads x 128, the decoder as deep as
# the encoder, 256 conv channels, silu, rotary base 10000, CTC weight 0.5,
# self-conditioning; on the ladder configuration with loss_mode enc_dec
# (bf16 compute over fp32 parameters).  The family has no remat option.
ENC_DEC_CONFIG = merged(dict(LADDER_CONFIG, model_class="EncDecSconformer", model={
    "n_layers": 6, "d_model": 768, "n_heads": 6, "head_dim": 128,
    "subsampling_factor": 8, "subsampling_conv_channels": 256, "subsampling_act": "silu",
    "ctc_loss_weight": 0.5, "self_conditioning": True, "default_norm": "layer_norm",
    "conv_kernel_size": 9, "use_rotary": True, "rotary_base_freq": 10000.0,
}), {"training": {"loss_mode": "enc_dec"}})
# K1 in each encoder layer's forward, K3 in its backward: nothing is
# recomputed (the JAX class has no remat either); the decoder's attention is
# plain torch, as in the JAX package
ENC_DEC_TRAIN_LAUNCHES = {"flash_attention_fwd": 6, "flash_attention_bwd_fused": 6,
                          **CTC_LAUNCHES}
ENC_DEC_FWD_LAUNCHES = {"flash_attention_fwd": 6}  # one encoder forward of one window
ENC_DEC_BATCH, ENC_DEC_FRAMES, ENC_DEC_TEXT = 4, 16_384, 384  # the forward's batch
ENC_DEC_LENGTHS = (16_384, 12_000, 8_192, 4_096)
GREEDY_FRAMES, MAX_GENERATE, BEAM_FRAMES, BEAM_WIDTH = 16_384, 256, 4_096, 4
ENC_DEC_OPT_STEPS = 5
# random weights give near-uniform CTC posteriors over 4096 classes, where
# nearly every class clears the beam search's -6 threshold (some 16,000
# candidate beams a frame); the decoding models' CTC head weights are scaled
# by this so that their posteriors are peaked as a trained head's are
# (about 2% of the classes within 6 of the top, by the draw's Gaussian
# tail).  The training models keep the draw as it is, as the other training
# phases' models do
CTC_HEAD_GAIN = 4.0
# the cached step's fp32 logits against the full pass's, at every position:
# fp32 sums in another order through 6 decoder layers at width 768 (the CPU
# parity test holds 2e-4 at width 64); a wrong cache slot, mask or position
# moves logits by O(1)
STEP_TOL = 1e-3  # of max(1, the largest |logit|)


def enc_dec_model(torch, v2: bool, dtype, seed: int = 0, weights=None,
                  ctc_gain: float = CTC_HEAD_GAIN):
    """The full-width EncDecSconformer (v2: V2) of ENC_DEC_CONFIG computing in
    `dtype`, its weights those of the model `weights` or drawn by
    `init_weights_(seed)` with the CTC head scaled by `ctc_gain`."""
    from lcasr_torch.config import Config
    from lcasr_torch.models.registry import load_model
    from lcasr_torch.models.sconformer_xl import init_weights_

    cfg = merged(ENC_DEC_CONFIG, {"training": {"dtype": {torch.bfloat16: "bfloat16",
                                                          torch.float32: "float32"}[dtype]}})
    if v2:
        cfg["model_class"] = "EncDecSconformerV2"
    model = load_model(Config(cfg), 4095, device=DEVICE)
    if weights is not None:
        model.load_state_dict(weights.state_dict(), strict=True)
        return model
    init_weights_(model, seed=seed)
    with torch.no_grad():
        model.decoder.ff.weight.mul_(ctc_gain)
    return model


def enc_dec_forward(torch, model, what: str) -> dict:
    """One (4, 80, 16384) batch with ragged lengths and 4 seeded sequences
    of 384 ids: finite CTC log-probs and decoder logits of the right shapes,
    ENC_DEC_FWD_LAUNCHES K1 launches and 0 of every other kernel, both
    outputs close to the same model's with plain attention in its encoder
    (`logprob_agreement`, phase `model`'s gate; the decoder's logits through
    a log-softmax)."""
    import numpy as np

    from lcasr_torch import kernels

    rng = np.random.default_rng(21)
    audio = torch.from_numpy(rng.normal(size=(ENC_DEC_BATCH, 80, ENC_DEC_FRAMES))
                             .astype(np.float32)).to(DEVICE)
    lengths = torch.tensor(ENC_DEC_LENGTHS, dtype=torch.int32, device=DEVICE)
    text = torch.from_numpy(rng.integers(1, 4095, size=(ENC_DEC_BATCH, ENC_DEC_TEXT))).to(DEVICE)
    with torch.no_grad():
        kernels.reset_launch_counts()
        out = model(audio, text, length=lengths)
        torch.cuda.synchronize()
        launches = expect_launches(ENC_DEC_FWD_LAUNCHES, f"one {what} forward")
        ctc, lm = out["final_posteriors_ctc"], out["final_posteriors_lm"]
        T = ENC_DEC_FRAMES // 8
        if (tuple(ctc.shape) != (ENC_DEC_BATCH, T, 4096) or ctc.dtype != torch.float32
                or tuple(lm.shape) != (ENC_DEC_BATCH, ENC_DEC_TEXT, 4095)):
            raise AssertionError(f"{what}: CTC {tuple(ctc.shape)} {ctc.dtype}, "
                                 f"decoder {tuple(lm.shape)}")
        if not (torch.isfinite(ctc).all() and torch.isfinite(lm).all()):
            raise AssertionError(f"{what}: non-finite outputs")
        with plain_attention():
            kernels.reset_launch_counts()
            plain = model(audio, text, length=lengths)
            require_launches(False, f"{what} forward with plain attention")
        fwd_ms = time_ms(torch, lambda: model(audio, text, length=lengths), n=3, warmup=1)
    agree = logprob_agreement(torch, ctc, plain["final_posteriors_ctc"], out["length"],
                              f"{what} CTC log-probs with K1 against plain attention")
    full = torch.full((ENC_DEC_BATCH,), ENC_DEC_TEXT, device=DEVICE)
    agree_lm = logprob_agreement(
        torch, torch.log_softmax(lm.float(), -1),
        torch.log_softmax(plain["final_posteriors_lm"].float(), -1), full,
        f"{what} decoder log-probs with K1 against plain attention")
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {what} ({n_params / 1e6:.1f}M parameters) forward ({ENC_DEC_BATCH}, 80, "
        f"{ENC_DEC_FRAMES}) + {ENC_DEC_TEXT} ids bf16: {fwd_ms:.2f} ms, launches {launches}; "
        f"vs plain attention: CTC argmax agreement {agree[0]:.5f}, max|dlogp| {agree[1]:.4f}, "
        f"mean {agree[2]:.2e}; decoder {agree_lm[0]:.5f}, {agree_lm[1]:.4f}, {agree_lm[2]:.2e}")
    return {"forward_ms": fwd_ms, "launches": launches["flash_attention_fwd"],
            "ctc_agreement": agree, "decoder_agreement": agree_lm}


@contextlib.contextmanager
def counted(obj, name: str, counter: dict):
    """Count the calls of obj.name inside (this script only)."""
    from unittest import mock

    real = getattr(obj, name)

    def wrapper(*args, **kwargs):
        counter[name] = counter.get(name, 0) + 1
        return real(*args, **kwargs)

    with mock.patch.object(obj, name, wrapper):
        yield


def host_syncs(torch, fn) -> int:
    """The synchronising CUDA calls fn makes, by PyTorch's sync debug mode."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def enc_dec_greedy_fp32(torch, model, audio, what: str) -> dict:
    """fp32: the cached and the full-prefix greedy decodes give the same ids,
    and at every position of the cached decode its step's logits are those
    of one full pass over its final token buffer, within STEP_TOL."""
    from unittest import mock

    from lcasr_torch.models.enc_dec_sconformer import generate_greedy, generate_greedy_cached

    steps, real = [], model.decoder_step

    def recorded(*args, **kwargs):
        logits, caches = real(*args, **kwargs)
        steps.append(logits[0])
        return logits, caches

    with mock.patch.object(model, "decoder_step", recorded):
        ids_cached = generate_greedy_cached(model, audio, max_generate=MAX_GENERATE)
    ids_full = generate_greedy(model, audio, max_generate=MAX_GENERATE)
    with torch.no_grad():
        a_hidden, _, length = model.encode(audio)
        tokens = torch.zeros((1, MAX_GENERATE), dtype=torch.int64, device=DEVICE)
        tokens[0, 1:1 + len(ids_cached)] = torch.tensor(ids_cached, device=DEVICE)
        full = model.generate_step(tokens, a_hidden, length)[0, :len(steps)]
        step_err = (torch.stack(steps) - full).abs().max().item()
    scale = max(1.0, full.abs().max().item())
    log(f"  {what} fp32 greedy: {len(ids_cached)} ids cached, {len(ids_full)} full-prefix, "
        f"equal {ids_cached == ids_full}; the cached steps against one full pass over "
        f"{len(steps)} positions: max|dlogit| {step_err:.3e} (gate {STEP_TOL * scale:.3e})")
    if ids_cached != ids_full or step_err > STEP_TOL * scale:
        raise AssertionError(f"{what} fp32: cached greedy ids {ids_cached[:20]}... against "
                             f"full-prefix {ids_full[:20]}..., step error {step_err}")
    return {"ids": len(ids_cached), "step_max_abs_err": step_err}


def enc_dec_greedy_bf16(torch, model, audio, what: str, idle_share: bool) -> dict:
    """bf16: the encoder's ms, each decode's ms per emitted token (its wall
    less the encoder's, over its decoder calls; the mean of 2 after a warm
    one, which counts the decoder calls and the host synchronisations),
    tokens per second, with `idle_share` the device's idle share over one
    cached decode, and the first position where the two decodes' ids differ
    (reported, not gated: near-ties of a bf16 argmax)."""
    import numpy as np

    from lcasr_torch import kernels
    from lcasr_torch.models.enc_dec_sconformer import generate_greedy, generate_greedy_cached

    with torch.no_grad():
        kernels.reset_launch_counts()
        model.encode(audio)
        torch.cuda.synchronize()
        expect_launches(ENC_DEC_FWD_LAUNCHES, f"{what} encoder")
        encoder_ms = time_ms(torch, lambda: model.encode(audio), n=5)
    out = {"encoder_ms": encoder_ms}
    ids = {}
    for name, fn in (("cached", generate_greedy_cached), ("full_prefix", generate_greedy)):
        calls = {}
        method = "decoder_step" if name == "cached" else "generate_step"
        with counted(model, method, calls):
            syncs = host_syncs(torch, lambda: ids.__setitem__(
                name, fn(model, audio, max_generate=MAX_GENERATE)))
        steps = calls[method]
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(model, audio, max_generate=MAX_GENERATE)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = float(np.mean(walls))
        if syncs < steps:  # each decoder call ends in one eos check
            log(f"  sync debug mode recorded {syncs} synchronisations for {steps} eos checks: "
                f"host synchronisations not measured")
            syncs = None
        per_token = (wall - encoder_ms) / steps
        out[name] = {"decode_ms": walls, "steps": steps, "ms_per_token": per_token,
                     "tokens_per_s": 1e3 / per_token, "host_syncs": syncs,
                     "host_syncs_per_token": syncs / steps if syncs is not None else None}
        log(f"  {what} bf16 {name} greedy: {len(ids[name])} ids in {steps} decoder calls, "
            f"decode {[round(w, 2) for w in walls]} ms, encoder {encoder_ms:.2f} ms, "
            f"{per_token:.3f} ms per token ({1e3 / per_token:.1f} tokens/s), {syncs} host "
            f"synchronisations in the decode")
    if idle_share:
        out["cached"]["idle_share"] = device_idle_share(
            torch, lambda: generate_greedy_cached(model, audio, max_generate=MAX_GENERATE),
            f"one bf16 cached {what} greedy decode")
    a, b = ids["cached"], ids["full_prefix"]
    first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 None if len(a) == len(b) else min(len(a), len(b)))
    out["first_difference"] = first
    log(f"  {what} bf16: cached and full-prefix ids "
        + ("equal" if first is None else f"first differ at position {first}"))
    return out


def device_idle_share(torch, run, what: str):
    """1 - the device's busy time over the wall time of one run, by
    torch.profiler with device activity only (a decode's hundred thousand
    host-side ops would take the profiler minutes to tabulate), or None
    where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    share = 1 - busy_us / wall_us if busy_us else None
    log(f"  profile of {what} (device activity): wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms, idle share {share}")
    return share


def profile_idle_share(rows, filename: str):
    """The idle share of the wall time `profile_run` wrote to build/<filename>."""
    if not rows:
        return None
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", filename)
    wall = float(open(path).readline().split()[1])
    return 1 - sum(r[0] for r in rows) / wall


def enc_dec_train(torch, workdir: str) -> dict:
    """The Trainer with loss_mode enc_dec on ENC_DEC_CONFIG: the ladder run
    (8192 x 8 -> 16384 x 4 on 16 podcasts) with its launch counts and save /
    resume; one 16384 x 4 micro step's launches and peak memory; the
    gradient gate against plain fp32 attention (plain bf16 attention the
    yardstick); ENC_DEC_OPT_STEPS optimizer steps of a fresh model on one
    chunk with a finite, falling loss; the steady step's wall, device busy
    time and idle share."""
    import numpy as np

    from lcasr_torch import kernels
    from lcasr_torch.training.trainer import Trainer

    run = TrainRun(torch, workdir, ENC_DEC_CONFIG,
                   lambda seed, config: enc_dec_model(torch, False, torch.bfloat16, seed,
                                                      ctc_gain=1.0),
                   ENC_DEC_TRAIN_LAUNCHES, "EncDecSconformer")
    trainer, model, ladder = run.ladder()
    _, chunk = run.chunk_16384x4()
    stats = [b.clone() for b in trainer._stat_buffers()]

    def one_step():
        trainer.zero_pending()
        loss, _ = trainer.micro_step(chunk)
        for b, old in zip(trainer._stat_buffers(), stats):
            b.copy_(old)
        return float(loss), flat_grads(model)

    trainer.zero_pending()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    one_step()
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = expect_launches(ENC_DEC_TRAIN_LAUNCHES, "one EncDecSconformer micro step")
    log(f"  EncDecSconformer 16384x4 micro step ({int(chunk['label_lengths'].max())} labels at "
        f"most, padded to {chunk['labels'].shape[1]}): launches {launches}, peak memory "
        f"{peak_gb:.2f} GB")
    gate = gradient_gate("EncDecSconformer", "plain fp32 attention", one_step,
                         plain_attention(), {"plain bf16 attention": plain_attention(bf16=True)})
    # a fresh model and optimizer, as in phase train_d256: MADGRAD's dual
    # averaging carries the ladder run's sums, and from them the loss on one
    # chunk swung up and down (H100 runs)
    fresh = Trainer(run.cfg, enc_dec_model(torch, False, torch.bfloat16, 2, ctc_gain=1.0),
                    run.tok, device=DEVICE, checkpoint_dir=os.path.join(run.tmp, "ckpt_fresh"))
    fresh.init_state()
    losses = []
    for _ in range(ENC_DEC_OPT_STEPS):
        fresh.zero_pending()
        loss, _ = fresh.micro_step(chunk)
        fresh.fold_group(100.0 / (PODCAST_FRAMES * 4))
        fresh.optimizer_step(3e-4)
        losses.append(float(loss))
    log(f"  EncDecSconformer, a fresh model: {ENC_DEC_OPT_STEPS} optimizer steps on one 16384x4 "
        f"chunk, loss {[round(x, 4) for x in losses]}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"EncDecSconformer loss {losses} is not finite and falling")
    del fresh
    trainer.zero_pending()
    rows = run.timed_step(trainer, chunk, "enc_dec_train_profile.txt")
    return {"launches_ladder": ladder, "launches": launches, "peak_gb_micro_step": peak_gb,
            "gate": gate, "losses": losses, "device_busy_ms": sum(r[0] for r in rows) / 1e3,
            "idle_share": profile_idle_share(rows, "enc_dec_train_profile.txt")}


def enc_dec_beam(torch, model) -> dict:
    """`ctc_beam_search` on the fp32 V2 with the port's tokenizer: a
    BEAM_FRAMES recording, BEAM_WIDTH beams; the text equals the text of the
    same model with plain attention in its encoder.  Wall seconds and
    decoder calls."""
    import numpy as np

    from lcasr_torch import kernels
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.models.enc_dec_sconformer import ctc_beam_search

    tok = load_tokenizer()
    audio = torch.from_numpy(np.random.default_rng(23).normal(size=(1, 80, BEAM_FRAMES))
                             .astype(np.float32)).to(DEVICE)
    calls = {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with counted(model, "generate_step", calls):
        text = ctc_beam_search(model, audio, tok, beam_width=BEAM_WIDTH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = expect_launches(ENC_DEC_FWD_LAUNCHES, "the V2 beam search")
    with plain_attention():
        kernels.reset_launch_counts()
        plain = ctc_beam_search(model, audio, tok, beam_width=BEAM_WIDTH)
        require_launches(False, "the V2 beam search with plain attention")
    log(f"  V2 ctc_beam_search, fp32, {BEAM_FRAMES} frames, width {BEAM_WIDTH}: {wall:.2f} s, "
        f"{calls['generate_step']} decoder calls, {len(text.split())} words, launches "
        f"{launches}; equal to plain attention's text: {text == plain}")
    if text != plain or not text:
        raise AssertionError(f"V2 beam text {text[:200]!r} against plain attention's "
                             f"{plain[:200]!r}")
    return {"wall_s": wall, "decoder_calls": calls["generate_step"],
            "words": len(text.split())}


def phase_enc_dec(torch, workdir: str) -> dict:
    import numpy as np

    out, seconds = {}, {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return result

    audio = torch.from_numpy(np.random.default_rng(22).normal(size=(1, 80, GREEDY_FRAMES))
                             .astype(np.float32)).to(DEVICE)
    for v2, what in ((False, "EncDecSconformer"), (True, "EncDecSconformerV2")):
        model = part(f"build_{what}", enc_dec_model, torch, v2, torch.bfloat16)
        out[f"forward_{what}"] = part(f"forward_{what}", enc_dec_forward, torch, model, what)
        out[f"greedy_bf16_{what}"] = part(f"greedy_bf16_{what}", enc_dec_greedy_bf16, torch,
                                          model, audio, what, not v2)
        fp32 = part(f"build_fp32_{what}", enc_dec_model, torch, v2, torch.float32, 0, model)
        del model
        out[f"greedy_fp32_{what}"] = part(f"greedy_fp32_{what}", enc_dec_greedy_fp32, torch,
                                          fp32, audio, what)
        if v2:
            out["beam"] = part("beam", enc_dec_beam, torch, fp32)
        del fp32
    out["train"] = part("train", enc_dec_train, torch, workdir)
    log(f"  phase enc_dec seconds: {seconds}")
    out["seconds"] = seconds
    return out


# ---------------------------------------------------------------------------
# phase 15: decoding with a language model (TransformerLM, the beam searches)
# ---------------------------------------------------------------------------
# lcasr_tpu/models/lm.py:26-41 and lcasr_tpu/cli/train_lm.py:67-80, the class
# and CLI defaults: vocabulary 4095, width 512, 6 layers, 8 heads x 64, fp32;
# batch 32 of at most 256 tokens, AdamW 3e-4 after a global-norm clip of 1
LM_MODEL = dict(d_model=512, n_layers=6, n_heads=8, head_dim=64)
LM_TRAIN = dict(batch_size=32, seq_len=256, lr=3e-4, steps=50)
# lcasr_tpu/cli/lm_rescore.py:77-90 (width 25, alpha 0.45, beta 1.53, bos 2)
# and serving/__main__.py:39-41 (width 25, top-K 32)
LM_SEARCH = dict(beam_width=25, alpha=0.45, beta=1.53)
LM_SERVE_TOPK = 32
# the flagship's CTC head for decoding is scaled by this gain: random weights
# otherwise give near-uniform posteriors with thousands of candidates a
# frame, where a trained model gives 1-5 (CTC_HEAD_GAIN's 4 still leaves
# some 2% of the 4096 classes within 6 of the top; 32 leaves 3-4 a frame,
# at most 7, on an NVIDIA H100 80GB HBM3)
LM_CTC_HEAD_GAIN = 32.0
LM_RECORDINGS = 1  # synthetic recordings of LONG_FRAMES mel frames each
# the searches' cuts: CTC frames of the recording (the widths are not cut);
# random weights make nearly every frame an LM step, 10-16 ms a frame on
# an NVIDIA H100 80GB HBM3, and the script keeps near half its time limit
LM_FS_FRAMES = 1_024  # host frame-sync and the device search
LM_MANY_SLICES, LM_MANY_FRAMES = 4, 512  # rescore_many with 1 slot and with 4
LM_PREFIX_FRAMES = 512  # the prefix search with the LM scorer
LM_NATIVE_FRAMES = 1_024  # the no-LM prefix search, native against Python
LM_MAX_CANDIDATES = 8  # the device search's default max_candidates
# a cached step's fp32 log-probs against one full causal pass: fp32 sums in
# another order through 6 layers of width 512 (the CPU parity test holds 1e-5
# at width 64); a wrong cache cell, mask or position moves them by O(1)
LM_STEP_TOL = 1e-3
LM_STEP_ROWS, LM_STEP_TOKENS, LM_FORK_AT = 25, 256, 128


def lm_corpus(path: str, seed: int, n_lines: int = 1_500) -> None:
    """Seeded text over WORDS, 5-300 words a line: short and long lines, so
    that batches fill every width bucket up to the 256-token cut."""
    import numpy as np

    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        for _ in range(n_lines):
            n = int(rng.integers(5, 300))
            fh.write(" ".join(WORDS[i] for i in rng.integers(0, len(WORDS), n)) + "\n")


def lm_train(torch, workdir: str) -> dict:
    """train_lm at the defaults for LM_TRAIN["steps"] steps: falling loss,
    the steady step's ms (steps 11 on, each ending in the loss's read-back),
    peak memory; the checkpoint reloaded by load_lm_checkpoint gives the
    trained weights' logits, bit for bit."""
    import json as json_
    from unittest import mock

    import numpy as np

    from lcasr_torch.cli.lm_rescore import load_lm_checkpoint
    from lcasr_torch.cli.train_lm import train_lm
    from lcasr_torch.models.lm import TransformerLM
    from lcasr_torch.training import checkpointing

    text = os.path.join(workdir, "lm_corpus.txt")
    lm_corpus(text, seed=31)
    saved, real_save = {}, checkpointing.save_checkpoint

    def save(directory, step, model_state, **kw):
        saved.update(model_state)  # the live parameters at the last step
        return real_save(directory, step, model_state, **kw)

    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(checkpointing, "save_checkpoint", save):
        path = train_lm(text, os.path.join(workdir, "lm"), **LM_MODEL, **LM_TRAIN,
                        save_every=LM_TRAIN["steps"], log_every=1, seed=7, device=DEVICE)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rows = [json_.loads(line) for line in open(os.path.join(workdir, "lm", "metrics.jsonl"))]
    losses = [r["loss"] for r in rows]
    step_ms = 1e3 * (rows[-1]["wall_s"] - rows[10]["wall_s"]) / (len(rows) - 11)
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"the LM's loss did not fall: {losses}")
    lm = load_lm_checkpoint(path, device=DEVICE)
    ref = TransformerLM(vocab_size=lm.vocab_size, **LM_MODEL, device=DEVICE)
    ref.load_state_dict(saved)
    tok = torch.from_numpy(np.random.default_rng(3).integers(0, lm.vocab_size, (4, 200))).to(
        DEVICE)
    with torch.no_grad():
        if not torch.equal(lm(tok), ref.eval()(tok)):
            raise AssertionError("the reloaded LM's logits differ from the trained weights'")
    n_params = sum(p.numel() for p in lm.parameters())
    log(f"  train_lm ({n_params / 1e6:.1f}M parameters, batch {LM_TRAIN['batch_size']} x "
        f"<= {LM_TRAIN['seq_len'] + 1} tokens, fp32): loss {losses[0]:.3f} -> {losses[-1]:.3f} "
        f"over {len(losses)} steps (mean of the first 5 {first:.3f}, of the last 5 {last:.3f}); "
        f"step {step_ms:.2f} ms; peak memory {peak:.2f} GiB; reloaded: equal logits")
    return {"lm": lm, "path": path, "step_ms": step_ms, "peak_gib": peak,
            "loss_first": losses[0], "loss_last": losses[-1], "params": n_params}


def lm_cached_against_full(torch, lm) -> dict:
    """fp32, LM_STEP_ROWS rows x LM_STEP_TOKENS tokens: every cached step's
    log-probs within LM_STEP_TOL of one full causal pass; then a fork: 5
    parents' prefixes of LM_FORK_AT tokens, 25 children reading them through
    pos_row and writing their own cells (write_rows), each child's log-probs
    those of the full pass over its parent's prefix and its own tokens."""
    import numpy as np

    B, U, P = LM_STEP_ROWS, LM_STEP_TOKENS, LM_FORK_AT
    rng = np.random.default_rng(5)
    tok = torch.from_numpy(rng.integers(0, lm.vocab_size, (B, U))).to(DEVICE)
    shape = (lm.n_layers, 2, B, lm.n_heads, U + 1, lm.head_dim)
    worst = 0.0
    with torch.no_grad():
        full = torch.log_softmax(lm(tok).float(), -1)
        cache = torch.zeros(shape, device=DEVICE)
        lengths = torch.zeros((B,), dtype=torch.int32, device=DEVICE)
        t0 = time.perf_counter()
        for t in range(U):
            logits, cache, lengths = lm(tok[:, t : t + 1], cache=cache, cache_lengths=lengths)
            worst = max(worst, float((torch.log_softmax(logits[:, 0].float(), -1)
                                      - full[:, t]).abs().max()))
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / U
        # the fork: children j read parent j % 5's first P cells
        parents = torch.arange(B, device=DEVICE) % 5
        pos_row = parents[:, None].repeat(1, U + 1)
        child = torch.cat([tok[parents, :P], tok[:, P:]], 1)
        ref = torch.log_softmax(lm(child).float(), -1)
        cache = torch.zeros(shape, device=DEVICE)
        lengths = torch.zeros((B,), dtype=torch.int32, device=DEVICE)
        for t in range(P):  # only rows 0-4 (the parents) write their prefix
            _, cache, lengths = lm(tok[:, t : t + 1], cache=cache, cache_lengths=lengths,
                                   write_mask=torch.arange(B, device=DEVICE) < 5)
        lengths = torch.full((B,), P, dtype=torch.int32, device=DEVICE)
        rows = torch.arange(B, device=DEVICE)
        fork = 0.0
        for t in range(P, U):
            pos_row[:, t] = rows  # each child's own cell from here on
            logits, cache, lengths = lm(child[:, t : t + 1], cache=cache, cache_lengths=lengths,
                                        pos_row=pos_row, write_rows=rows)
            fork = max(fork, float((torch.log_softmax(logits[:, 0].float(), -1)
                                    - ref[:, t]).abs().max()))
    log(f"  cached LM steps, fp32, {B} rows x {U} tokens: max |d log-prob| against the full "
        f"pass {worst:.2e}, {step_ms:.2f} ms a step; forked prefixes through pos_row / "
        f"write_rows: {fork:.2e} (tolerance {LM_STEP_TOL})")
    if not (worst <= LM_STEP_TOL and fork <= LM_STEP_TOL):
        raise AssertionError(f"cached LM steps against the full pass: {worst}, fork {fork}")
    return {"max_abs_logprob": worst, "fork_max_abs_logprob": fork, "step_ms": step_ms}


def lm_acoustic_checkpoint(torch, directory: str) -> str:
    """The flagship (bf16 compute) with its CTC head scaled by
    LM_CTC_HEAD_GAIN, as a checkpoint of the port."""
    from lcasr_torch.config import Config
    from lcasr_torch.models.sconformer_xl import FLAGSHIP, SCConformerXL, init_weights_
    from lcasr_torch.training.checkpointing import save_checkpoint

    model = init_weights_(SCConformerXL(**FLAGSHIP, dtype=torch.bfloat16, device="cpu"), 0)
    with torch.no_grad():
        model.decoder.ff.weight.mul_(LM_CTC_HEAD_GAIN)
    cfg = {k: v for k, v in FLAGSHIP.items() if k != "vocab_size"}
    return save_checkpoint(directory, 0, model.state_dict(),
                           config=Config({"model": dict(cfg, dtype="bfloat16")}))


def candidates_per_frame(lp, threshold: float = -6.0):
    """The search's candidates of each frame: ids >= 1 above max + threshold."""
    import numpy as np

    return ((lp > lp.max(-1, keepdims=True) + np.float32(threshold))[:, 1:]).sum(-1)


def lm_create_logits(torch, workdir: str, ckpt: str) -> dict:
    """create_logits over LM_RECORDINGS synthetic 120,000-frame recordings:
    36 K1 launches each and no call of plain attention; the candidates a
    frame (and what other head gains would give, from the same logits)."""
    import numpy as np

    from lcasr_torch import kernels
    from lcasr_torch.cli.lm_rescore import create_logits
    from lcasr_torch.ops import flash_attention as fa

    out = os.path.join(workdir, "logits")
    plain = {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with counted(fa, "flash_attention_ref", plain):
        create_logits(ckpt, "synthetic", "test", out, seq_len=SEQ_LEN, overlap=OVERLAP,
                      dataset_kwargs={"n_recordings": LM_RECORDINGS, "n_frames": LONG_FRAMES},
                      device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = expect_launches({"flash_attention_fwd": EXPECTED_LAUNCHES * LM_RECORDINGS},
                               "create_logits")
    if plain:
        raise AssertionError(f"create_logits called plain attention: {plain}")
    logs = [np.load(os.path.join(out, f"synthetic_{i}.npz"))["logits"].astype(np.float32)
            for i in range(LM_RECORDINGS)]
    # (fp16 at rest, as in the JAX dumps: log-probs below -65504 become -inf)
    if any(lg.shape != (LONG_FRAMES // 8, 4096) or np.isnan(lg).any()
           or not np.isfinite(lg.max(-1)).all() for lg in logs):
        raise AssertionError(f"dumped logits {[lg.shape for lg in logs]}")
    n = np.concatenate([candidates_per_frame(lg) for lg in logs])
    # the same differences of logits at another gain g scale by g / gain
    # (the head's bias aside): what other gains would give
    other = {g: float(np.mean(np.concatenate([candidates_per_frame(
        lg, -6.0 * LM_CTC_HEAD_GAIN / g) for lg in logs]))) for g in (4.0, 8.0, 32.0)}
    log(f"  create_logits, {LM_RECORDINGS} x {LONG_FRAMES} frames (CTC head gain "
        f"{LM_CTC_HEAD_GAIN}): {wall:.1f} s with the .npz writes, launches {launches}, plain "
        f"attention calls 0; candidates a frame: mean {n.mean():.3f}, max {int(n.max())}, "
        f"blank the argmax on {float(np.mean([(lg.argmax(-1) == 4095).mean() for lg in logs])):.3f}"
        f" of frames; mean at other gains {other}")
    return {"dir": out, "logits": logs, "wall_s": wall,
            "launches": launches["flash_attention_fwd"],
            "candidates_mean": float(n.mean()), "candidates_max": int(n.max())}


def cut_dir(base: str, name: str, parts) -> str:
    """A logits directory of `parts` ((id, (T, C) log-probs), ...) in the
    create_logits format."""
    import numpy as np

    d = os.path.join(base, name)
    os.makedirs(d, exist_ok=True)
    for rid, lp in parts:
        np.savez(os.path.join(d, f"{rid}.npz"), logits=lp.astype(np.float16),
                 gold="this is a synthetic gold transcript")
    return d


def lm_rescore(torch, workdir: str, dumped: dict, lm_path: str) -> dict:
    """beam_stage over the dumped logits at LM_SEARCH, frames cut as the
    LM_*_FRAMES say: ids of every decode recorded through the tokenizer.
    Host and device frame-sync ids equal; rescore_many with 4 slots equal to
    1 slot; the native no-LM prefix beam equal to its Python path.  For each
    path its wall time, LM steps, peak memory, and for the device search its
    host synchronisations a segment."""
    from unittest import mock

    from lcasr_torch.cli.lm_rescore import beam_stage
    from lcasr_torch.data.tokenizer import SentencePieceBPE, load_tokenizer
    from lcasr_torch.decoding.beam_search import BeamSearch, TorchLMScorer
    from lcasr_torch.decoding.frame_sync import CachedTransformerLM
    from lcasr_torch.decoding.frame_sync_device import DeviceFrameSyncBeamSearch

    lp0 = dumped["logits"][0]  # the dump's fp16 values, as beam_stage reads them
    n = candidates_per_frame(lp0[:LM_FS_FRAMES])
    if n.max() > LM_MAX_CANDIDATES:
        frame = int(n.argmax())
        raise AssertionError(f"frame {frame} of the device search's input has {int(n[frame])} "
                             f"candidates > max_candidates {LM_MAX_CANDIDATES}")
    dirs = {
        "fs": cut_dir(workdir, "cut_fs", [("r0", lp0[:LM_FS_FRAMES])]),
        "many": cut_dir(workdir, "cut_many", [
            (f"s{i}", lp0[i * LM_MANY_FRAMES : (i + 1) * LM_MANY_FRAMES])
            for i in range(LM_MANY_SLICES)]),
        "prefix": cut_dir(workdir, "cut_prefix", [("r0", lp0[:LM_PREFIX_FRAMES])]),
    }
    runs = {
        "frame_sync": ("fs", dict(decoder="frame_sync", lm=lm_path)),
        "device": ("fs", dict(decoder="frame_sync", lm=lm_path, device_search=True)),
        "many_1": ("many", dict(decoder="frame_sync", lm=lm_path, parallel_recordings=1)),
        "many_4": ("many", dict(decoder="frame_sync", lm=lm_path,
                                parallel_recordings=LM_MANY_SLICES)),
        "prefix_lm": ("prefix", dict(decoder="prefix", lm=lm_path)),
    }
    out = {}
    for name, (d, kw) in runs.items():
        ids, calls = [], {}
        real_decode = SentencePieceBPE.decode

        def decode(self, i, real=real_decode, ids=ids):
            ids.append([int(x) for x in i])
            return real(self, i)

        def run():
            return beam_stage(dirs[d], device=DEVICE, results_csv=os.path.join(
                workdir, "results.csv"), **LM_SEARCH, **kw)

        syncs, real_many = [], DeviceFrameSyncBeamSearch.run_search_many

        def search_many(self, *a, real=real_many, syncs=syncs, **k):
            # the device search's own host synchronisations (loading the LM
            # checkpoint, outside it, syncs once a parameter)
            out = []
            syncs.append(host_syncs(torch, lambda: out.append(real(self, *a, **k))))
            return out[0]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with mock.patch.object(SentencePieceBPE, "decode", decode), \
                mock.patch.object(DeviceFrameSyncBeamSearch, "run_search_many", search_many), \
                counted(CachedTransformerLM, "step", calls), \
                counted(DeviceFrameSyncBeamSearch, "_lm_apply", calls), \
                counted(TorchLMScorer, "__call__", calls):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        frames = LM_FS_FRAMES if d == "fs" else (
            LM_MANY_SLICES * LM_MANY_FRAMES if d == "many" else LM_PREFIX_FRAMES)
        steps = sum(calls.values())
        out[name] = {"wall_s": wall, "frames": frames, "ms_a_frame": 1e3 * wall / frames,
                     "lm_steps": steps, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                     "ids": ids, "tokens": [len(i) for i in ids]}
        if name == "device":
            segments = -(-LM_FS_FRAMES // 2048)
            out[name].update(host_syncs=sum(syncs), segments=segments,
                             syncs_a_segment=sum(syncs) / segments)
        log(f"  beam_stage {name}: {frames} frames in {wall:.2f} s ({1e3 * wall / frames:.2f} ms "
            f"a frame), {steps} LM calls, {out[name]['tokens']} tokens, peak "
            f"{out[name]['peak_gib']:.2f} GiB"
            + (f", {sum(syncs)} host syncs in the search over {out[name]['segments']} "
               f"segment(s)" if name == "device" else ""))
    if out["device"]["ids"] != out["frame_sync"]["ids"]:
        a, b = out["device"]["ids"][0], out["frame_sync"]["ids"][0]
        same = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        raise AssertionError(f"device search ids differ from the host's at token {same} "
                             f"({len(a)} / {len(b)} tokens)")
    # (the 4 slots finish, and decode, in another order than one at a time)
    if sorted(out["many_4"]["ids"]) != sorted(out["many_1"]["ids"]):
        raise AssertionError("rescore_many with 4 slots differs from 1 slot")
    if not all(out["frame_sync"]["ids"]) or not all(out["prefix_lm"]["ids"]):
        raise AssertionError("a search emitted nothing")

    # the native no-LM prefix beam against its Python path (the library
    # built before the clock starts)
    from lcasr_torch import native

    native.library("beam")
    tok = load_tokenizer()
    lp = lp0[:LM_NATIVE_FRAMES]
    kw = dict(tokenizer=tok, beam_width=LM_SEARCH["beam_width"], blank_id=tok.vocab_size(),
              pad_id=tok.pad_id())
    native, python = BeamSearch(**kw), BeamSearch(**kw)
    python.force_python = True
    t0 = time.perf_counter()
    native.run_search(lp)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    python.run_search(lp)
    t_python = time.perf_counter() - t0
    state = [[(b.prefix, b.p_blank, b.p_non_blank, b.frames) for b in s._beams.values()]
             for s in (native, python)]
    if state[0] != state[1]:
        raise AssertionError("the native no-LM prefix beam differs from its Python path")
    log(f"  no-LM prefix beam over {LM_NATIVE_FRAMES} frames: native {t_native * 1e3:.1f} ms, "
        f"Python {t_python * 1e3:.1f} ms, the same beams bit for bit")
    out["native_prefix"] = {"native_s": t_native, "python_s": t_python,
                            "frames": LM_NATIVE_FRAMES}
    for v in out.values():
        v.pop("ids", None)
    return out


def lm_serve_beam(torch, workdir: str, seed: int) -> dict:
    """The flagship (head gain LM_CTC_HEAD_GAIN) behind a TranscriptionServer
    with decoder="beam", width 25, top-K 32: 4 sessions fed 60 s each in
    0.5 s chunks.  Each session's final text equals an offline BeamSearch
    over its single-stream transcriber's finalised log-probs (dense fetch);
    sparse refetches, the pump's ms a wave, K1 launches."""
    import numpy as np

    from lcasr_torch import kernels
    from lcasr_torch.data.audio import SR, grab_left_channel, load_audio, resample
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.decoding.beam_search import BeamSearch
    from lcasr_torch.serving import OnlineTranscriber, TranscriptionServer

    wav = os.path.join(workdir, "serve.wav")
    write_wav(wav, SERVE_STREAMS * SERVE_SECONDS, WAV_RATE, seed + 3)
    wave, sr = load_audio(wav)
    left = resample(grab_left_channel(wave), sr, SR, device=DEVICE)[0].cpu().numpy()
    n = SERVE_SECONDS * SR
    streams = [left[i * n : (i + 1) * n] for i in range(SERVE_STREAMS)]
    chunk = int(SERVE_CHUNK_S * SR)
    tok = load_tokenizer()
    model = flagship_model(torch)
    with torch.no_grad():
        model.decoder.ff.weight.mul_(LM_CTC_HEAD_GAIN)
    opts = dict(beam_width=LM_SEARCH["beam_width"], alpha=0.0, beta=0.0)
    beam_kw = dict(decoder="beam", beam_opts=opts, **SERVE_KW)

    server = TranscriptionServer(model, tok, max_streams=SERVE_STREAMS, device=DEVICE,
                                 beam_topk=LM_SERVE_TOPK, **beam_kw)
    sids = [server.open() for _ in streams]
    sessions = [server._session(sid) for sid in sids]
    kernels.reset_launch_counts()
    wave_ms = []
    t0 = time.perf_counter()
    for pos in range(0, n, chunk):
        for sid, audio in zip(sids, streams):
            server.feed(sid, audio[pos : pos + chunk], pump=False)
        t1, w0 = time.perf_counter(), server.wave_count
        server.pump()
        torch.cuda.synchronize()
        if server.wave_count > w0:
            wave_ms.append(1e3 * (time.perf_counter() - t1) / (server.wave_count - w0))
    for sid in sids:
        server.finish(sid)
    wall = time.perf_counter() - t0
    waves = server.wave_count
    launches = expect_launches({"flash_attention_fwd": len(model.layers) * waves},
                               "the beam server's run")
    refetches = sum(s.sparse_refetches for s in sessions)

    for i, audio in enumerate(streams):
        tr = OnlineTranscriber(model, tok, device=DEVICE, beam_topk=None, **beam_kw)
        blocks, real = [], tr._beam.advance

        def advance(lp, t0=0, blocks=blocks, real=real):
            blocks.append(np.array(lp))
            return real(lp, t0=t0)

        tr._beam.advance = advance
        for pos in range(0, n, chunk):
            tr.feed(audio[pos : pos + chunk])
        tr.finish()
        offline = BeamSearch(tokenizer=tok, blank_id=tok.vocab_size(), pad_id=0, **opts)
        text = offline.run_search(np.concatenate(blocks))
        if sessions[i].text != text or not text:
            raise AssertionError(f"session {i}: the server's beam text {sessions[i].text[:200]!r}"
                                 f" against the offline search's {text[:200]!r}")
    log(f"  beam server, {SERVE_STREAMS} sessions x {SERVE_SECONDS} s in {SERVE_CHUNK_S} s "
        f"chunks, width {opts['beam_width']}, top-K {LM_SERVE_TOPK}: {waves} waves, launches "
        f"{launches}, sparse refetches {refetches}; pump a wave median "
        f"{np.median(wave_ms):.2f} ms, p90 {np.percentile(wave_ms, 90):.2f} ms; streams' RTFx "
        f"{SERVE_STREAMS * SERVE_SECONDS / wall:.1f}; every session's text equals the offline "
        f"search over its single-stream log-probs ({[len(s.text.split()) for s in sessions]} "
        f"words)")
    return {"waves": waves, "launches": launches["flash_attention_fwd"],
            "sparse_refetches": refetches, "wave_ms_median": float(np.median(wave_ms)),
            "wave_ms_p90": float(np.percentile(wave_ms, 90)),
            "rtfx": SERVE_STREAMS * SERVE_SECONDS / wall}


def phase_lm(torch, workdir: str, seed: int) -> dict:
    out, seconds = {}, {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return result

    trained = part("train", lm_train, torch, workdir)
    lm = trained.pop("lm")
    out["train"] = {k: v for k, v in trained.items() if k != "path"}
    out["cached"] = part("cached", lm_cached_against_full, torch, lm)
    del lm
    ckpt = part("checkpoint", lm_acoustic_checkpoint, torch, os.path.join(workdir, "am"))
    dumped = part("create_logits", lm_create_logits, torch, workdir, ckpt)
    out["create_logits"] = {k: v for k, v in dumped.items() if k not in ("logits", "dir")}
    out["rescore"] = part("rescore", lm_rescore, torch, workdir, dumped, trained["path"])
    del dumped
    out["serve"] = part("serve", lm_serve_beam, torch, workdir, seed)
    log(f"  phase lm seconds: {seconds}")
    out["seconds"] = seconds
    return out


# ---------------------------------------------------------------------------
# phase 16: parallelism on torch.distributed
# ---------------------------------------------------------------------------
# the flagship's attention at the 20-minute decode (120,000 frames / 8), cut
# into the blocks of an 8-rank ring: 1,875 tokens, a multiple of no tile
RING_SHAPE = (1, 15_000, 6, 128)
RING_RANKS = 8
RING_WINDOWS = ((-1, -1), (256, 256))
RING_LSE_TOL = 1e-3  # merged lse against one K1's, both fp32 sums of the same products
# configs/lcasr_3l_2048d_16h_tp.yaml written out (tests/test_torch_port_tp.py
# holds the two equal); one optimizer step on a 16384 x 4 chunk
TP_CONFIG = {
    "model_class": "SCConformerXL",
    "model": {"d_model": 2048, "n_heads": 16, "head_dim": 128, "n_layers": 3,
              "subsampling_factor": 8, "subsampling_conv_channels": 256,
              "subsampling_act": "silu", "conv_kernel_size": 9, "use_rotary": True,
              "rotary_base_freq": 1500000.0, "rotary_interpolation_factor": 1.0,
              "self_conditioning": True, "default_norm": "layer_norm",
              "checkpoint_every_n_layers": 1},
    "training": {"batch_size": 704, "backprop_every": 1, "backwards_every": 1,
                 "clip_value": 0.8, "max_epochs": 1, "random_seed": 1234, "dtype": "bfloat16"},
    "optimizer": {"name": "madgrad", "args": {"lr": 3.0e-3}},
    "scheduler": {"warmup_steps": 1500, "final_value": 3.0e-5},
    "parallel": {"mesh": {"data": 2, "model": 4, "seq": 1}, "zero_optimizer": True},
}
TP_STEP_LR = 3.0e-3
MULTI_RANK_NOTE = (
    "multi-rank runs are not possible on one card (NCCL takes one rank a device); the CPU "
    "tests hold them against lcasr_tpu over gloo: tests/test_torch_port_parallel.py "
    "({data: 2}: Trainer step, two optimizer steps, mesh decode), tests/test_torch_port_cp.py "
    "({seq: 4}: halo exchange, gather and ring attention, full-model forward and training), "
    "tests/test_torch_port_tp.py ({data: 2, model: 2} with ZeRO, its checkpoint, the CLI "
    "in two processes)")


def rel_err(a, ref) -> float:
    return ((a.float() - ref.float()).norm() / ref.float().norm()).item()


def ring_schedule(torch, window) -> dict:
    """Every rank's ring schedule of an 8-rank ring, block by block on this
    card (`ring_step_fwd` / `merge` / `ring_finish`, then `ring_step_bwd`
    against the merged lse), against one kernel over the whole sequence:
    the output and the gradients within YARDSTICK_FACTOR times the single
    kernel's error against its own fp32 run, the lse within RING_LSE_TOL;
    8 K1 launches a rank forward, 8 K3 (banded: 8 K4 + 8 K5) backward."""
    from lcasr_torch import kernels
    from lcasr_torch.ops.flash_attention import flash_attention_bwd, flash_attention_with_lse
    from lcasr_torch.parallel import ring_attention as ra

    B, T, H, D = RING_SHAPE
    n, t = RING_RANKS, RING_SHAPE[1] // RING_RANKS
    gen = torch.Generator(device=DEVICE).manual_seed(16)
    q, k, v, do = (torch.randn(RING_SHAPE, generator=gen, device=DEVICE, dtype=torch.bfloat16)
                   for _ in range(4))
    lens = torch.full((B,), T, dtype=torch.int32, device=DEVICE)
    blk = [[x[:, j * t:(j + 1) * t].contiguous() for j in range(n)] for x in (q, k, v, do)]

    def ring_fwd():
        outs = []
        for i in range(n):  # rank i: its queries against every block in ring order
            acc = ra.ring_init(blk[0][i])
            for s in range(n):
                j = (i - s) % n
                acc = ra.merge(*acc, *ra.ring_step_fwd(blk[0][i], blk[1][j], blk[2][j], lens,
                                                       window, None, i * t, j * t))
            outs.append(ra.ring_finish(*acc, q.dtype))
        return outs

    def ring_bwd(outs):
        dq = []
        dk = [torch.zeros((B, t, H, D), dtype=torch.float32, device=DEVICE) for _ in range(n)]
        dv = [torch.zeros_like(x) for x in dk]
        for i, (o, lse) in enumerate(outs):
            dqi = torch.zeros((B, t, H, D), dtype=torch.float32, device=DEVICE)
            for s in range(n):
                j = (i - s) % n
                dq_s, dk_s, dv_s = ra.ring_step_bwd(blk[0][i], blk[1][j], blk[2][j], o, lse,
                                                    blk[3][i], lens, window, None, i * t, j * t)
                dqi += dq_s.float()
                dk[j] += dk_s.float()
                dv[j] += dv_s.float()
            dq.append(dqi)
        return [torch.cat(g, 1).to(q.dtype) for g in (dq, dk, dv)]

    o1, lse1 = flash_attention_with_lse(q, k, v, lens, window)
    g1 = flash_attention_bwd(q, k, v, o1, lse1, do, lens, window)
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    o32, lse32 = flash_attention_with_lse(q32, k32, v32, lens, window)
    g32 = flash_attention_bwd(q32, k32, v32, o32, lse32, do32, lens, window)
    kernels.reset_launch_counts()
    outs = ring_fwd()
    torch.cuda.synchronize()
    banded = window[0] >= 0 and window[1] >= 0
    fwd = expect_launches({"flash_attention_fwd": n * n}, f"ring forward, window {window}")
    kernels.reset_launch_counts()
    g = ring_bwd(outs)
    torch.cuda.synchronize()
    bwd = expect_launches({"flash_attention_bwd_dq": n * n, "flash_attention_bwd_dkv": n * n}
                          if banded else {"flash_attention_bwd_fused": n * n},
                          f"ring backward, window {window}")
    o = torch.cat([x[0] for x in outs], 1)
    lse = torch.cat([x[1] for x in outs], 2)
    errs = {"o": (rel_err(o, o32), rel_err(o1, o32))}
    errs.update({name: (rel_err(a, ref), rel_err(b, ref))
                 for name, a, b, ref in zip(("dq", "dk", "dv"), g, g1, g32)})
    lse_d = (lse - lse1).abs().max().item()
    max_abs = (o.float() - o1.float()).abs().max().item()
    verdict = (f"ring of {n} x {t} at {RING_SHAPE} bf16, window {window}: merged lse vs one K1 "
               f"{lse_d:.2e} (<= {RING_LSE_TOL:g}), max|o - one K1| {max_abs:.3e}; rel L2 "
               f"against the fp32 kernels, ring / one kernel: " + ", ".join(
                   f"{k} {a:.3e} / {b:.3e}" for k, (a, b) in errs.items())
               + f" (gate: ring <= {YARDSTICK_FACTOR:g} x one kernel's); launches forward "
               f"{n} a rank {fwd}, backward {n} a rank {bwd}")
    log("  " + verdict)
    if not (lse_d <= RING_LSE_TOL and all(a <= YARDSTICK_FACTOR * b + 1e-7
                                          for a, b in errs.values())):
        raise AssertionError("the ring schedule disagrees with one kernel: " + verdict)
    ms = {"ring_fwd": time_ms(torch, ring_fwd, n=5),
          "one_fwd": time_ms(torch, lambda: flash_attention_with_lse(q, k, v, lens, window), n=5),
          "ring_bwd": time_ms(torch, lambda: ring_bwd(outs), n=5),
          "one_bwd": time_ms(torch, lambda: flash_attention_bwd(q, k, v, o1, lse1, do, lens,
                                                                  window), n=5)}
    log(f"  ring ms (all {n} ranks' steps in series on this card) against one kernel over "
        f"the sequence: forward {ms['ring_fwd']:.3f} vs {ms['one_fwd']:.3f}, backward "
        f"{ms['ring_bwd']:.3f} vs {ms['one_bwd']:.3f}")
    return {"window": list(window), "launches_fwd": fwd, "launches_bwd": bwd, "lse_diff": lse_d,
            "max_abs_err": max_abs, "rel_l2": errs, "ms": ms}


def world_of_one_flagship(torch, run, chunk, mesh) -> dict:
    """One 16384 x 4 flagship micro step on the mesh of one, and the same
    step through the context-parallel path at seq 1 (context_parallel_apply:
    the time shard, the halo exchanges, the gathered K / V and log-probs,
    the statistics summed over data and seq), each against the same step
    without a mesh (other Trainers on other copies of the weights), under
    the gradient gate with the step without a mesh, run again, as the
    yardstick; the launch counts of the three steps equal."""
    from lcasr_torch import kernels
    from lcasr_torch.models.registry import load_model
    from lcasr_torch.models.sconformer_xl import init_weights_
    from lcasr_torch.training.trainer import Trainer

    def fresh_model(seed, config):
        return init_weights_(load_model(config, 4095, device=DEVICE), seed=seed)

    trainers = {
        "plain": Trainer(run.cfg, fresh_model(0, run.cfg), run.tok, device=DEVICE,
                         checkpoint_dir=os.path.join(run.tmp, "plain")),
        "mesh": Trainer(run.cfg, fresh_model(0, run.cfg), run.tok, device=DEVICE, mesh=mesh,
                        checkpoint_dir=os.path.join(run.tmp, "mesh")),
        "cp": Trainer(run.cfg, fresh_model(0, run.cfg), run.tok, device=DEVICE, mesh=mesh,
                      checkpoint_dir=os.path.join(run.tmp, "cp")),
    }
    trainers["cp"].context_parallel = True  # the seq-sharded micro step at seq 1
    active = {}
    stats = {k: [b.clone() for b in tr._stat_buffers()] for k, tr in trainers.items()}

    @contextlib.contextmanager
    def use(name):
        active["name"] = name
        yield

    def one_step():
        tr = trainers[active["name"]]
        tr.zero_pending()
        loss, _ = tr.micro_step(chunk)
        for b, old in zip(tr._stat_buffers(), stats[active["name"]]):
            b.copy_(old)
        return float(loss), flat_grads(tr.model)

    launches = {}
    for name in trainers:
        with use(name):
            kernels.reset_launch_counts()
            one_step()
            torch.cuda.synchronize()
            launches[name] = dict(kernels.launch_counts)
    log(f"  micro step launches: on the mesh {launches['mesh']}, context-parallel at seq 1 "
        f"{launches['cp']}, without {launches['plain']}")
    layers = LADDER_CONFIG["model"]["n_layers"]  # K1 forward and again in the recompute
    if (launches["mesh"] != launches["plain"] or launches["cp"] != launches["plain"]
            or launches["mesh"]["flash_attention_fwd"] != 2 * layers):
        raise AssertionError(f"launch counts differ: {launches}")
    gates = {name: gradient_gate(what, "the same step without a mesh", one_step, use("plain"),
                                 {"the step without a mesh, again": use("plain")},
                                 floors=(1e-4, 1e-6), kernel_ctx=use(name), plain_contexts=False)
             for name, what in (("mesh", "flagship on a mesh of one"),
                                ("cp", "flagship context-parallel at seq 1"))}
    # the micro step's wall ms in turns (plain, mesh, cp, cp, mesh, plain) x 2
    ms = {"plain": [], "mesh": [], "cp": []}
    for name in ("plain", "mesh", "cp", "cp", "mesh", "plain") * 2:
        tr = trainers[name]
        tr.zero_pending()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.micro_step(chunk)
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) * 1e3)
        for b, old in zip(tr._stat_buffers(), stats[name]):
            b.copy_(old)
    for tr in trainers.values():
        tr.zero_pending()
    log(f"  flagship 16384 x 4 micro step wall ms in turns: on the mesh "
        f"{[round(x, 1) for x in ms['mesh']]}, context-parallel at seq 1 "
        f"{[round(x, 1) for x in ms['cp']]}, without {[round(x, 1) for x in ms['plain']]}")
    return dict(gates["mesh"], cp=gates["cp"], launches=launches["mesh"], step_ms=ms)


def world_of_one_tp_zero(torch, run, chunk, mesh) -> dict:
    """lcasr_3l_2048d_16h_tp at full width: one optimizer step with
    zero_optimizer on the mesh of one, the model cut by `parallelize` over
    the model axis of size 1 (every projection's tensor-parallel mode and
    its collectives; ZeRO's reduce-scatter, global norm and all-gather),
    against the same step without a mesh.  A row-parallel projection adds
    its bias after the all-reduce, so in bf16 it rounds twice (the product,
    then the sum) where the layer without a mesh rounds once; the reference
    is therefore the step without a mesh whose row projections round so
    (`bias_after_product`).  The parameters' change on the mesh lies within
    YARDSTICK_FACTOR times that reference's two runs apart (K3's dq atomics
    do not repeat bit for bit), and within YARDSTICK_FACTOR times the
    larger of the plain step's two runs apart and the rounding's own effect
    from the plain step.  The model is built once: every run starts from
    the same device copy of the weights, the runs without a mesh first,
    then `parallelize` cuts it for the two on the mesh; the parameters'
    changes stay on the device (the plain and the rounded ones are kept,
    the others compared as they come), and each run's peak memory is
    counted without those copies."""
    from lcasr_torch.config import Config
    from lcasr_torch.models.registry import load_model
    from lcasr_torch.models.sconformer_xl import init_weights_
    from lcasr_torch.parallel.tensor_parallel import parallelize
    from lcasr_torch.training.trainer import Trainer

    cfg_d = merged(TP_CONFIG, {"parallel": {"mesh": {"data": 1, "model": 1, "seq": 1}},
                               "checkpointing": {"dir": os.path.join(run.tmp, "ckpt")}})
    # without a mesh: no parallel section (the Trainer would build the mesh of one)
    cfg_plain = {k: v for k, v in cfg_d.items() if k != "parallel"}
    model = init_weights_(load_model(Config(cfg_d), 4095, device=DEVICE), seed=3)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    names = [k for k, _ in model.named_parameters()]

    def rel(a, b):
        return ((a.double() - b.double()).norm() / b.double().norm()).item()

    kept, errs, out = {}, {}, {}
    held = sum(v.numel() * v.element_size() for v in start.values())
    for name in ("plain", "rounded", "rounded_again", "plain_again", "mesh", "mesh_again"):
        on_mesh = name.startswith("mesh")
        model.load_state_dict(start)
        if name == "rounded":
            bias_after_product(torch, model)
        elif name == "plain_again":
            for m in model.modules():  # the row projections' own forward back
                m.__dict__.pop("forward", None)
        elif name == "mesh":
            parallelize(model, mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(Config(cfg_d if on_mesh else cfg_plain), model, run.tok,
                     device=DEVICE, mesh=mesh if on_mesh else None,
                     checkpoint_dir=os.path.join(run.tmp, name))
        tr.init_state()
        t0 = time.perf_counter()
        loss, _ = tr.micro_step(chunk)
        tr.fold_group(100.0 / (PODCAST_FRAMES * 4))
        tr.optimizer_step(TP_STEP_LR)
        torch.cuda.synchronize()
        out[f"{name}_step_ms"] = (time.perf_counter() - t0) * 1e3
        out[f"{name}_peak_gb"] = (torch.cuda.max_memory_allocated() - held) / 1e9
        out[f"{name}_loss"] = float(loss)
        params = dict(model.named_parameters())
        delta = torch.cat([(params[k].detach().float() - start[k].float()).reshape(-1)
                           for k in names])
        if name in ("plain", "rounded"):
            kept[name] = delta
            held += delta.numel() * delta.element_size()
        if name == "rounded":
            errs["rounding"] = rel(delta, kept["plain"])
        elif name == "rounded_again":
            errs["rerun_r"] = rel(delta, kept["rounded"])
        elif name == "plain_again":
            errs["rerun"] = rel(delta, kept["plain"])
        elif name == "mesh":
            errs["mesh_err"], errs["mesh_r"] = rel(delta, kept["plain"]), rel(delta,
                                                                             kept["rounded"])
            # at model 1 every projection of the layout is cut: 6 a layer,
            # and the decoder's two
            n_cut = 6 * TP_CONFIG["model"]["n_layers"] + 2
            if not (tr.zero_opt and len(model.tp_layout) == n_cut):
                raise AssertionError(f"zero_optimizer {tr.zero_opt}, {len(model.tp_layout)} "
                                     f"tensor-parallel projections, not {n_cut}")
            out["zero_state_numel"] = sum(
                t.numel() for st in tr.optimizer.inner.state.values() for t in st.values()
                if torch.is_tensor(t))
            out["tp_projections"] = len(model.tp_layout)
        del tr, delta, params  # the next run's peak must not hold these parameters
    del model, kept, start
    torch.cuda.empty_cache()
    mesh_err, rerun, mesh_r, rerun_r, rounding = (
        errs[k] for k in ("mesh_err", "rerun", "mesh_r", "rerun_r", "rounding"))
    loss_rel = abs(out["mesh_loss"] - out["plain_loss"]) / abs(out["plain_loss"])
    verdict = (f"lcasr_3l_2048d_16h_tp ({n_params / 1e6:.1f}M parameters) one ZeRO optimizer "
               f"step on the mesh of one vs without: loss rel {loss_rel:.2e}; parameter change "
               f"rel L2 against the step without a mesh rounded as the row projections round "
               f"{mesh_r:.3e} (its two runs: {rerun_r:.3e}), against the plain step "
               f"{mesh_err:.3e} (its two runs: {rerun:.3e}; the rounding alone: "
               f"{rounding:.3e}); step ms (one model, runs without a mesh first): without "
               f"{out['plain_step_ms']:.1f}, rounded {out['rounded_step_ms']:.1f}, "
               f"{out['rounded_again_step_ms']:.1f}, without {out['plain_again_step_ms']:.1f}, "
               f"on the mesh (cut by parallelize at model 1: {out['tp_projections']} "
               f"tensor-parallel projections) {out['mesh_step_ms']:.1f}, "
               f"{out['mesh_again_step_ms']:.1f}; peak memory of a run on the mesh "
               f"{out['mesh_peak_gb']:.2f} / {out['mesh_again_peak_gb']:.2f} GB, without "
               f"{out['plain_peak_gb']:.2f} / {out['plain_again_peak_gb']:.2f} GB (the script's "
               f"copies of the weights and changes not counted); MADGRAD state "
               f"{out['zero_state_numel'] / 1e6:.1f}M values (3 x the parameters at data 1)")
    log("  " + verdict)
    if not (math.isfinite(out["mesh_loss"]) and loss_rel <= LOSS_REL_MAX
            and mesh_r <= YARDSTICK_FACTOR * rerun_r + 1e-6
            and mesh_err <= YARDSTICK_FACTOR * max(rerun, rounding) + 1e-6):
        raise AssertionError("the ZeRO step on the mesh of one disagrees: " + verdict)
    out.update(rel_l2=mesh_err, rerun_rel_l2=rerun, rounded_rel_l2=mesh_r,
               rounded_rerun_rel_l2=rerun_r, rounding_rel_l2=rounding, loss_rel=loss_rel,
               params=n_params)
    return out


def bias_after_product(torch, model) -> None:
    """Round `model`'s row-parallel projections (out_proj, fc2, the
    reprojection) as `Dense.tp`'s row path does, without its collective:
    the product in the compute dtype, then the bias added."""
    from lcasr_torch.parallel.partition import tp_layout

    for prefix, mode in tp_layout(model, 1).items():
        if mode.startswith("row"):
            dense = model.get_submodule(prefix)

            def forward(x, d=dense):
                y = torch.nn.functional.linear(x.to(d.dtype), d.weight.to(d.dtype))
                return y + d.bias.to(d.dtype) if d.bias is not None else y

            dense.forward = forward


def world_of_one_decode(torch, mesh) -> dict:
    """The 20-minute decode through the mesh decode (data 1) against
    StreamingDecoder without a mesh: equal ids, 36 K1 each; then the
    context-parallel single pass (seq 1) over all 120,000 frames against
    the windowed single pass."""
    import numpy as np

    from lcasr_torch import kernels
    from lcasr_torch.evaluation.streaming import (
        StreamingDecoder, fetch_logits, make_cp_windowed_model_fn, make_windowed_model_fn)
    from lcasr_torch.parallel.cp_model import bind_mesh

    model = flagship_model(torch)
    spec = np.random.default_rng(2).normal(size=(1, 80, TOTAL_FRAMES)).astype(np.float32)
    ids, launches = {}, {}
    for name, m in (("plain", None), ("mesh", mesh)):
        dec = StreamingDecoder(model, 4096, window_batch_size=WINDOW_BATCH,
                               transfer_dtype=torch.bfloat16, device=DEVICE, mesh=m)
        kernels.reset_launch_counts()
        ids[name] = dec.greedy(spec, seq_len=SEQ_LEN, overlap=OVERLAP)
        launches[name] = expect_launches({"flash_attention_fwd": EXPECTED_LAUNCHES},
                                         f"the {name} decode")
    same = bool(np.array_equal(ids["mesh"], ids["plain"]))
    log(f"  20-minute decode on the mesh (data 1) vs without: {ids['mesh'].shape[0]} ids, equal "
        f"{same}, launches {launches['mesh']}")
    if not same:
        raise AssertionError("the mesh decode's ids differ from StreamingDecoder's")
    one = {}
    for name, fn in (("windowed", make_windowed_model_fn(model)),
                     ("cp", make_cp_windowed_model_fn(model, mesh))):
        kernels.reset_launch_counts()
        one[name] = torch.from_numpy(fetch_logits(fn, spec, seq_len=TOTAL_FRAMES, overlap=0,
                                                  n_classes=4096, window_batch_size=1))
        expect_launches({"flash_attention_fwd": model.n_layers}, f"the {name} single pass")
    bind_mesh(model, None)
    out_len = torch.tensor([one["cp"].shape[0]])
    agree, max_d, mean_d = logprob_agreement(torch, one["cp"][None].to(DEVICE),
                                             one["windowed"][None].to(DEVICE),
                                             out_len.to(DEVICE),
                                             "the context-parallel single pass (seq 1)")
    log(f"  single pass over {TOTAL_FRAMES} frames, context-parallel (seq 1) vs windowed: "
        f"argmax agreement {agree:.5f}, max|dlogp| {max_d:.3e}, mean|dlogp| {mean_d:.2e}")
    del model
    return {"ids_equal": same, "launches": launches["mesh"], "cp_single_pass": {
        "agreement": agree, "max_dlogp": max_d, "mean_dlogp": mean_d}}


def phase_parallel(torch, workdir: str) -> dict:
    """The ring schedule on the card, then a world of one over NCCL: the
    flagship micro step, the TP model's ZeRO step, the mesh decode."""
    import torch.distributed as dist

    from lcasr_torch.parallel.mesh import make_mesh, maybe_init_distributed

    log("  " + MULTI_RANK_NOTE)
    out, seconds = {}, {}
    t0 = time.perf_counter()
    out["ring"] = [ring_schedule(torch, w) for w in RING_WINDOWS]
    seconds["ring"] = round(time.perf_counter() - t0, 1)
    init = os.path.join(workdir, "nccl_world")
    if os.path.exists(init):
        os.remove(init)
    maybe_init_distributed(num_processes=1, process_id=0, init_method=f"file://{init}")
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"the world of one runs {dist.get_backend()}, not NCCL")
        mesh = make_mesh({"data": 1, "model": 1, "seq": 1})
        # the first collective on a group builds its NCCL communicator: do
        # it here, not inside a timed step
        for axis in ("data", "model", "seq"):
            dist.all_reduce(torch.zeros(1, device=DEVICE), group=mesh.group(axis))
        log(f"  world of one over {dist.get_backend()}: {mesh}")
        run = TrainRun(torch, workdir, LADDER_CONFIG, None, {}, "flagship")
        _, chunk = run.chunk_16384x4()
        for name, fn, args in (("flagship", world_of_one_flagship, (torch, run, chunk, mesh)),
                               ("tp_zero", world_of_one_tp_zero, (torch, run, chunk, mesh)),
                               ("decode", world_of_one_decode, (torch, mesh))):
            t0 = time.perf_counter()
            out[name] = fn(*args)
            seconds[name] = round(time.perf_counter() - t0, 1)
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    log(f"  phase parallel seconds: {seconds}")
    out["seconds"] = seconds
    return out


# ---------------------------------------------------------------------------
# phases 17-19: the paper's analysis, the model variants, test-time adaptation
# ---------------------------------------------------------------------------
HOUR_FRAMES = 360_000  # one hour of 10 ms frames: T' = 45,000 after the 8x subsampling
SUMMARY_ROW_BLOCK, SUMMARY_TOP_K = 512, 8
PROB_LAYERS, PROB_ROWS = (0, 8), (22_400, 256)  # two layers' rows in the middle of the hour
# probability rows against plain fp32 attention on the kernel's own bf16-scaled q: the
# same fp32 scores, the lse summed in another order
PROB_TOL = 1e-4
ATTRIBUTION_FRAMES = 16_384
PROBE_FACTORS = (1.0, 2.0, 4.0, 8.0)
W8A8_POLICIES = (False, "auto", True)
INT8_GEMM_SHAPE = (32_768, 768, 3_072)  # fc1 of one 16-window batch: (M, K, N)
LM_W8A8_ROWS = (25, 4)  # full-pass rows, and a cached step's rows (below _int_mm's 17)
META_UTTERANCES, META_FRAMES, META_BATCH = 16, 2_048, 2
META_REFINE_ITERATIONS = 10
DYN_FRAMES, DYN_NEGATIVES, DYN_LR = 36_864, 2, 8e-5
SELFTRAIN_FRAMES, SELFTRAIN_ITERATIONS = 16_384, 2
# the long convolution's gate takes no cosine of its 3 base rates (see gradient_gate)
LONGCONV_COS_MIN_NUMEL = 64


def seeded_spec(seed: int, frames: int):
    import numpy as np

    return np.random.default_rng(seed).normal(size=(1, 80, frames)).astype(np.float32)


def peak_gb(torch) -> float:
    return torch.cuda.max_memory_allocated() / 1e9


def same_bits(torch, before: dict, model, what: str, keys=None) -> None:
    """Every tensor of `model.state_dict()` named in `keys` (all: None) is
    the same bits as in `before`."""
    after = model.state_dict()
    for k in (keys if keys is not None else before):
        if not torch.equal(after[k], before[k]):
            raise AssertionError(f"{what}: {k} changed")


def analysis_summary(torch, model, spec) -> dict:
    """attention_summary over the hour in one pass: 2 K1 a layer (the
    capture, then the lse), the statistics' ranges, each layer's means."""
    import numpy as np

    from lcasr_torch import kernels
    from lcasr_torch.evaluation import analysis

    L = model.n_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    summary = analysis.attention_summary(model, spec, row_block=SUMMARY_ROW_BLOCK,
                                         top_k=SUMMARY_TOP_K)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = expect_launches({"flash_attention_fwd": 2 * L}, "attention_summary")
    peak = peak_gb(torch)
    T = summary[0]["entropy"].shape[-1]
    layers = []
    for i, s in enumerate(summary):
        ent, dist, tv, ti = (s[k] for k in ("entropy", "expected_distance", "topk_probs",
                                             "topk_cols"))
        ok = (np.isfinite(ent).all() and ent.min() >= -1e-4 and ent.max() <= np.log(T) + 1e-3
              and dist.min() >= 0 and dist.max() < T and (np.diff(tv, axis=-1) <= 0).all()
              and ti.min() >= 0 and ti.max() < T)
        if not ok:
            raise AssertionError(f"layer {i}'s attention statistics are out of range")
        layers.append({"mean_entropy": float(ent.mean()),
                       "mean_expected_distance": float(dist.mean()),
                       "mean_topk_mass": float(tv.sum(-1).mean())})
    log(f"  attention_summary over {spec.shape[-1]} frames (T' = {T}, row block "
        f"{SUMMARY_ROW_BLOCK}, top {SUMMARY_TOP_K}): {seconds:.2f} s, peak memory {peak:.2f} GB, "
        f"launches {launches}")
    for i, layer in enumerate(layers):
        log(f"    layer {i}: mean entropy {layer['mean_entropy']:.4f} nats (uniform "
            f"{np.log(T):.4f}), mean expected distance {layer['mean_expected_distance']:.1f} "
            f"frames, mean top-{SUMMARY_TOP_K} mass {layer['mean_topk_mass']:.4f}")
    return {"seconds": seconds, "peak_gb": peak, "launches": launches, "frames": spec.shape[-1],
            "T_sub": T, "layers": layers}


def analysis_prob_rows(torch, model, spec) -> dict:
    """attention_prob_rows of PROB_ROWS in two layers (10 K1 each: the
    capture and the lse) against plain fp32 attention with
    return_weights=True on the same captured q, k: within PROB_TOL of it on
    the q that the kernel scales in bf16, within YARDSTICK_FACTOR times that
    scale's own rounding of it on the unscaled q; valid rows sum to 1."""
    from lcasr_torch import kernels
    from lcasr_torch.evaluation import analysis
    from lcasr_torch.ops.attention import reference_attention
    from lcasr_torch.ops.flash_attention import _scaled

    r0, n = PROB_ROWS
    captured = analysis._captured_qkv(model, spec)
    out = {}
    for layer in PROB_LAYERS:
        kernels.reset_launch_counts()
        rows = analysis.attention_prob_rows(model, spec, layer, PROB_ROWS)
        launches = expect_launches({"flash_attention_fwd": model.n_layers + 1},
                                   f"attention_prob_rows of layer {layer}")
        rows = torch.from_numpy(rows).to(DEVICE)
        q, k, v, _ = captured[layer]
        with torch.no_grad():
            ref32 = reference_attention(q[:, r0:r0 + n], k, v, window=model.window,
                                        q_offset=r0, return_weights=True)[1]
            qs = _scaled(q[:, r0:r0 + n], None)
            ref_scaled = reference_attention(qs, k, v, window=model.window, q_offset=r0,
                                             softmax_scale=1.0, return_weights=True)[1]
        err_scaled = (rows - ref_scaled).abs().max().item()
        err32 = (rows - ref32).abs().max().item()
        rounding = (ref_scaled - ref32).abs().max().item()
        row_sum = (rows.sum(-1) - 1).abs().max().item()
        log(f"  layer {layer} rows {r0}-{r0 + n - 1} of {q.shape[1]}: max |p - plain fp32| "
            f"{err32:.3e} (the bf16 scaling of q alone: {rounding:.3e}), against plain fp32 on "
            f"the bf16-scaled q {err_scaled:.3e} (tolerance {PROB_TOL:g}), max |row sum - 1| "
            f"{row_sum:.2e}, max p {rows.max().item():.4f}, launches {launches}")
        if not (err_scaled <= PROB_TOL and err32 <= YARDSTICK_FACTOR * rounding + PROB_TOL
                and row_sum <= 1e-3):
            raise AssertionError(f"attention_prob_rows of layer {layer} disagree with plain "
                                 f"attention: {err_scaled}, {err32} (rounding {rounding}), "
                                 f"row sums {row_sum}")
        out[f"layer_{layer}"] = {"max_abs_err_fp32": err32, "max_abs_err_scaled_q": err_scaled,
                                 "scale_rounding": rounding, "row_sum_err": row_sum}
    del captured
    return out


def analysis_attribution(torch, model) -> dict:
    """context_attribution of the middle output frame of a 16,384-frame
    input (9 K1 + 9 K3), held by `gradient_gate` against plain fp32
    attention (yardstick: plain bf16 attention); the "loss" is the
    attribution's total."""
    import numpy as np

    from lcasr_torch import kernels
    from lcasr_torch.evaluation import analysis

    audio = seeded_spec(6, ATTRIBUTION_FRAMES)
    frame = ATTRIBUTION_FRAMES // 16  # the middle of T' = 2048

    def one_step():
        g = analysis.context_attribution(model, audio, frame)
        return float(g.sum()), {"attribution": torch.from_numpy(g).to(DEVICE)}

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    total, g = one_step()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = expect_launches({"flash_attention_fwd": model.n_layers,
                                "flash_attention_bwd_fused": model.n_layers},
                               "context_attribution")
    a = g["attribution"].cpu().numpy()
    centre = float(a[ATTRIBUTION_FRAMES // 2 - 512: ATTRIBUTION_FRAMES // 2 + 512].sum() / a.sum())
    log(f"  context_attribution of output frame {frame} over {ATTRIBUTION_FRAMES} frames: "
        f"{seconds * 1e3:.1f} ms, launches {launches}, share of the attribution within "
        f"512 frames of the centre {centre:.4f}")
    if not (np.isfinite(a).all() and total > 0):
        raise AssertionError("the attribution is not finite and positive")
    gate = gradient_gate("context attribution", "plain fp32 attention", one_step,
                         plain_attention(), {"plain bf16 attention": plain_attention(bf16=True)},
                         shape=f"1x{ATTRIBUTION_FRAMES}")
    return {"seconds": seconds, "launches": launches, "centre_share": centre, **gate}


def analysis_probe(torch, model) -> dict:
    """rotary_interpolation_probe over 20 minutes in one pass a factor."""
    from lcasr_torch import kernels
    from lcasr_torch.evaluation import analysis

    spec = seeded_spec(7, LONG_FRAMES)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    probe = analysis.rotary_interpolation_probe(model, spec, PROBE_FACTORS)
    seconds = time.perf_counter() - t0
    launches = expect_launches({"flash_attention_fwd": len(PROBE_FACTORS) * model.n_layers},
                               "rotary_interpolation_probe")
    if model.rotary_interpolation_factor != 1.0:
        raise AssertionError("the probe left the model's interpolation factor changed")
    log(f"  rotary_interpolation_probe over {LONG_FRAMES} frames: {seconds:.2f} s, launches "
        f"{launches}: " + ", ".join(f"x{f:g}: mean max log-prob {r['mean_max_logprob']:.4f}, "
                                     f"blank {r['blank_fraction']:.4f}" for f, r in probe.items()))
    return {"seconds": seconds, "launches": launches,
            "factors": {str(f): r for f, r in probe.items()}}


def phase_analysis(torch) -> dict:
    """The paper's question at its scale on the flagship: attention
    statistics over one hour, probability rows against plain attention,
    attribution through K3, the rotary probe."""
    model = flagship_model(torch)
    spec = seeded_spec(5, HOUR_FRAMES)
    out, seconds = {}, {}
    for name, fn, args in (("summary", analysis_summary, (torch, model, spec)),
                           ("prob_rows", analysis_prob_rows, (torch, model, spec)),
                           ("attribution", analysis_attribution, (torch, model)),
                           ("probe", analysis_probe, (torch, model))):
        t0 = time.perf_counter()
        out[name] = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        torch.cuda.empty_cache()
    log(f"  phase analysis seconds: {seconds}")
    out["seconds"] = seconds
    return out


def variants_w8a8_decode(torch, model) -> dict:
    """The 20-minute decode under each W8A8 policy (36 K1 each): RTFx as the
    median of 3 after a warm decode, and the share of frame ids equal to the
    bf16 decode's."""
    import numpy as np

    from lcasr_torch import kernels
    from lcasr_torch.evaluation.streaming import StreamingDecoder
    from lcasr_torch.ops.qdense import apply_quant_policy

    spec = seeded_spec(2, TOTAL_FRAMES)
    decoder = StreamingDecoder(model, 4096, window_batch_size=WINDOW_BATCH,
                               transfer_dtype=torch.bfloat16, device=DEVICE)
    out, ids0 = {}, None
    try:
        for policy in W8A8_POLICIES:
            apply_quant_policy(model, policy)
            kernels.reset_launch_counts()
            ids = decoder.greedy(spec, seq_len=SEQ_LEN, overlap=OVERLAP)
            launches = expect_launches({"flash_attention_fwd": EXPECTED_LAUNCHES},
                                       f"the decode under quant_w8a8={policy!r}")
            _, times = timed_decodes(decoder, spec, warm=False)
            ids0 = ids if ids0 is None else ids0
            same = float((ids == ids0).mean())
            rtfx = TOTAL_FRAMES / FRAMES_PER_SECOND / float(np.median(times))
            n_quant = sum(1 for m in model.modules() if getattr(m, "quant", False))
            out[str(policy)] = {"rtfx": rtfx, "decode_s": times, "ids_equal_share": same,
                                "launches": launches, "quantised_projections": n_quant}
            log(f"  20-minute decode, quant_w8a8={policy!r} ({n_quant} projections int8): "
                f"RTFx {rtfx:.1f} (decode s {[round(t, 4) for t in times]}), ids equal to the "
                f"bf16 decode's {same:.5f}, launches {launches}")
    finally:
        apply_quant_policy(model, False)
    return out


def variants_int8_gemm(torch) -> dict:
    """The int8 product at fc1's shape on the card, bit-equal to the host's
    product (float64 BLAS: every partial sum is an integer below 2^53, so
    it is exact; the first 256 rows also in int64), timed beside the bf16
    product and the whole W8A8 projection (quantisation included)."""
    import torch.nn.functional as F

    from lcasr_torch.ops import qdense

    M, K, N = INT8_GEMM_SHAPE
    gen = torch.Generator().manual_seed(7)
    a = torch.randint(-127, 128, (M, K), dtype=torch.int8, generator=gen)
    w = torch.randint(-127, 128, (N, K), dtype=torch.int8, generator=gen)
    a_d, w_d = a.to(DEVICE), w.to(DEVICE)
    y = qdense.int8_matmul(a_d, w_d).cpu()
    host = (a.double() @ w.double().t()).long()
    head = a[:256].long() @ w.long().t()
    equal = bool(torch.equal(y.long(), host) and torch.equal(host[:256], head))
    xb = torch.randn((M, K), generator=gen).to(DEVICE, torch.bfloat16)
    wb = (torch.randn((N, K), generator=gen) * K ** -0.5).to(DEVICE, torch.bfloat16)
    times = {"int8_ms": time_ms(torch, lambda: qdense.int8_matmul(a_d, w_d), n=20),
             "bf16_ms": time_ms(torch, lambda: F.linear(xb, wb), n=20),
             "w8a8_linear_ms": time_ms(torch, lambda: qdense.w8a8_linear(xb, wb), n=20)}
    ops = 2 * M * K * N
    log(f"  int8 product ({M} x {K}) @ ({K} x {N}) on the card: equal to the host's "
        f"{equal}; int8 {times['int8_ms']:.3f} ms ({ops / times['int8_ms'] / 1e9:.0f} TOP/s), "
        f"bf16 {times['bf16_ms']:.3f} ms, the W8A8 projection with its quantisation "
        f"{times['w8a8_linear_ms']:.3f} ms")
    if not equal:
        raise AssertionError("the int8 product on the card differs from the host's")
    return {"bit_equal": equal, **times}


def _agreement(torch, lp, ref):
    """(argmax agreement, mean |d|) of two outputs over every position."""
    return (float((lp.argmax(-1) == ref.argmax(-1)).float().mean()),
            float((lp.float() - ref.float()).abs().mean()))


def variants_families(torch) -> dict:
    """One forward each of the Mamba (K6), EncDecSconformer and
    TransformerLM at their class defaults under quant_w8a8=True, beside the
    same forward without; plus the encoder-decoder's cached greedy decode
    and the LM's cached step with a few rows (the int8 product's padding)."""
    import numpy as np

    from lcasr_torch import kernels
    from lcasr_torch.models.enc_dec_sconformer import generate_greedy_cached
    from lcasr_torch.models.lm import TransformerLM
    from lcasr_torch.models.sconformer_xl import init_weights_
    from lcasr_torch.ops.qdense import apply_quant_policy

    out = {}
    audio, lengths = window_batch(torch)
    audio, lengths = audio[:4], lengths[[0, 11, 12, 13]]
    runs = {}

    model = mamba_model(torch)
    runs["Mamba"] = (model, lambda m: m(audio, length=lengths)["final_posteriors"],
                     {"selective_scan_fwd": model.n_layers})
    enc = enc_dec_model(torch, False, torch.bfloat16)
    text = torch.from_numpy(np.random.default_rng(3).integers(0, 4095, (4, 384))).to(DEVICE)
    runs["EncDecSconformer"] = (
        enc, lambda m: m(audio, text, length=lengths)["final_posteriors_lm"],
        {"flash_attention_fwd": enc.n_layers})
    # LM_MODEL: the class defaults
    lm = init_weights_(TransformerLM(vocab_size=4095, **LM_MODEL, dtype=torch.bfloat16,
                                     device=DEVICE), seed=4)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, 4095, (LM_W8A8_ROWS[0], 256))).to(DEVICE)
    runs["TransformerLM"] = (lm, lambda m: m(tokens), {})
    for name, (m, fwd, expected) in runs.items():
        with torch.no_grad():
            ref = fwd(m)
            apply_quant_policy(m, True)
            kernels.reset_launch_counts()
            got = fwd(m)
            torch.cuda.synchronize()
            launches = expect_launches(expected, f"the {name} forward under W8A8")
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"the {name} forward under W8A8 is not finite")
        agree, mean_d = _agreement(torch, got, ref)
        n_quant = sum(1 for mod in m.modules() if getattr(mod, "quant", False))
        out[name] = {"argmax_agreement": agree, "mean_abs_diff": mean_d, "launches": launches,
                     "quantised_projections": n_quant}
        log(f"  {name} at its class defaults under quant_w8a8=True ({n_quant} projections "
            f"int8): argmax agreement with bf16 {agree:.5f}, mean |d| {mean_d:.3e}, "
            f"launches {launches}")
    with torch.no_grad():
        ids = generate_greedy_cached(enc, audio[:1, :, :8_192], max_generate=32)
        B = LM_W8A8_ROWS[1]
        cache = torch.zeros((lm.n_layers, 2, B, lm.n_heads, 9, lm.head_dim), device=DEVICE,
                            dtype=torch.bfloat16)
        clen = torch.zeros((B,), dtype=torch.int32, device=DEVICE)
        for t in range(8):
            logits, cache, clen = lm(tokens[:B, t:t + 1], cache=cache, cache_lengths=clen)
        if not torch.isfinite(logits.float()).all():
            raise AssertionError("the LM's cached W8A8 step is not finite")
    out["EncDecSconformer"]["greedy_ids"] = len(ids)
    log(f"  under W8A8: the encoder-decoder's cached greedy decode gave {len(ids)} ids, the "
        f"LM's cached step with {B} rows finite logits")
    del runs, model, enc, lm
    return out


def longconv_initialised(torch, model, seed: int):
    """`model` (weights from `init_weights_`) with every long convolution
    drawn by its own initialisers from `seed`, as a fresh model has it:
    `init_weights_` would give the position kernel's MLP N(0, 1 / fan_in)
    weights, a kernel ~500 times the module's N(0, 0.002^2) one, whose
    convolutions over 2,048 frames blow the activations up until bf16
    rounding alone turns the gradient around."""
    from lcasr_torch.ops.long_conv import ConformerLongConvolution

    torch.manual_seed(seed)
    for layer in model.layers:
        conv = layer.conv
        fresh = ConformerLongConvolution(
            conv.long_conv.d_model, l_max=conv.long_conv.l_max,
            position_kernel=conv.long_conv.position_kernel,
            weight_init=conv.long_conv.weight_init)
        conv.load_state_dict(fresh.state_dict())
    return model


def variants_longconv(torch, workdir: str) -> dict:
    """The flagship's width with conv_type longconv: one 16384 x 4 forward
    (9 K1) and one micro step through the Trainer (18 K1 + 9 K3: every
    layer recomputed), its loss and gradient gated against plain fp32
    attention as phase train gates the flagship's; then one forward with
    the direct kernel and frequency smoothing."""
    from lcasr_torch import kernels
    from lcasr_torch.config import Config
    from lcasr_torch.models.registry import load_model
    from lcasr_torch.models.sconformer_xl import FLAGSHIP, SCConformerXL, init_weights_
    from lcasr_torch.training.trainer import Trainer

    cfg_d = merged(LADDER_CONFIG, {"model": {"conv_type": "longconv"}})
    run = TrainRun(torch, workdir, cfg_d, None, {}, "longconv")
    batch, chunk = run.chunk_16384x4()
    model = longconv_initialised(torch, init_weights_(load_model(run.cfg, 4095, device=DEVICE),
                                                      seed=5), seed=5)
    trainer = Trainer(run.cfg, model, run.tok, device=DEVICE,
                      checkpoint_dir=os.path.join(run.tmp, "ckpt_longconv"))
    trainer.init_state()
    audio = torch.from_numpy(chunk["audio"]).to(DEVICE)
    lens = torch.from_numpy(chunk["audio_lengths"]).to(DEVICE)
    out = {}
    with torch.no_grad():
        kernels.reset_launch_counts()
        lp = model(audio, length=lens)["final_posteriors"]
        out["forward_launches"] = expect_launches({"flash_attention_fwd": model.n_layers},
                                                  "the longconv forward")
    if not torch.isfinite(lp).all():
        raise AssertionError("the longconv forward is not finite")
    kernels.reset_launch_counts()
    trainer.zero_pending()
    loss, _ = trainer.micro_step(chunk)
    torch.cuda.synchronize()
    out["step_launches"] = expect_launches(
        {"flash_attention_fwd": 2 * model.n_layers, "flash_attention_bwd_fused": model.n_layers,
         **CTC_LAUNCHES}, "the longconv micro step")

    def one_step():
        trainer.zero_pending()
        loss, _ = trainer.micro_step(chunk)
        return float(loss), flat_grads(model)

    out["gate"] = gradient_gate("longconv", "plain fp32 attention", one_step, plain_attention(),
                                {"plain bf16 attention": plain_attention(bf16=True)},
                                min_numel=LONGCONV_COS_MIN_NUMEL)
    trainer.zero_pending()
    del trainer, model
    direct = longconv_initialised(torch, init_weights_(SCConformerXL(
        **FLAGSHIP, conv_type="longconv", longconv_position_kernel=False,
        longconv_ma_smoothing=True, longconv_smooth_freq=True, longconv_weight_init="double_exp",
        dtype=torch.bfloat16, device=DEVICE), seed=6), seed=6)
    with torch.no_grad():
        kernels.reset_launch_counts()
        lp = direct(audio, length=lens)["final_posteriors"]
        out["direct_launches"] = expect_launches({"flash_attention_fwd": direct.n_layers},
                                                 "the direct-kernel longconv forward")
    norm_err = (lp.exp().sum(-1) - 1).abs().max().item()
    if not (torch.isfinite(lp).all() and norm_err <= 1e-3):
        raise AssertionError("the direct-kernel longconv forward is not finite and normalised")
    log(f"  longconv: forward launches {out['forward_launches']}, micro step loss "
        f"{float(loss):.4f} launches {out['step_launches']}; the direct kernel with frequency "
        f"smoothing: forward finite, normalisation error {norm_err:.1e}, launches "
        f"{out['direct_launches']}")
    del direct
    return out


def phase_variants(torch, workdir: str) -> dict:
    out, seconds = {}, {}
    model = flagship_model(torch)
    for name, fn, args in (("w8a8_decode", variants_w8a8_decode, (torch, model)),
                           ("int8_gemm", variants_int8_gemm, (torch,)),
                           ("families", variants_families, (torch,)),
                           ("longconv", variants_longconv, (torch, workdir))):
        t0 = time.perf_counter()
        out[name] = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        torch.cuda.empty_cache()
    log(f"  phase variants seconds: {seconds}")
    out["seconds"] = seconds
    return out


def adapt_meta(torch, workdir: str) -> dict:
    """SCConformerMeta at its class defaults (vocab 4095, bf16):
    MetaTrainer.train_utterances over META_UTTERANCES seeded utterances of
    META_FRAMES frames (7 K1 + 1 K3 a step: the frozen encoder's 6, the
    meta layer's forward and backward); only the meta branch moves; then
    refine_at_inference for META_REFINE_ITERATIONS iterations."""
    import numpy as np

    from lcasr_torch import kernels
    from lcasr_torch.config import Config
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.data.utterances import UtteranceDataloader, save_utterances
    from lcasr_torch.models.sconformer_meta import (
        META_PARAM_PREFIXES, SCConformerMeta, refine_at_inference)
    from lcasr_torch.models.sconformer_xl import init_weights_
    from lcasr_torch.training.meta import MetaTrainer

    tok = load_tokenizer()
    corpus = os.path.join(workdir, "meta_corpus")
    os.makedirs(corpus, exist_ok=True)
    # two recordings, cut into META_UTTERANCES utterances
    pairs = make_corpus(corpus, [META_FRAMES * META_UTTERANCES // 2] * 2, seed=8)
    utt_dir = os.path.join(workdir, "meta_utterances")
    n_utt = len(save_utterances(pairs, utt_dir, tok, chunk_size=META_FRAMES))
    if n_utt != META_UTTERANCES:
        raise AssertionError(f"save_utterances wrote {n_utt} utterances")
    model = init_weights_(SCConformerMeta(vocab_size=4095, dtype=torch.bfloat16,
                                          device=DEVICE), seed=9)
    cfg = Config({"training": {"loss": "l2", "batch_size": META_BATCH, "max_epochs": 1},
                  "audio_chunking": {"size": META_FRAMES},
                  "optimizer": {"name": "madgrad", "args": {"lr": 1e-3}},
                  "scheduler": {"warmup_steps": 0}})
    ckpt = os.path.join(workdir, "meta_ckpt")
    trainer = MetaTrainer(cfg, model, tok, checkpoint_dir=ckpt, device=DEVICE).init_state()
    frozen = [k for k, _ in model.named_parameters() if not k.startswith(META_PARAM_PREFIXES)]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loader = UtteranceDataloader(utt_dir, batch_size=META_BATCH, shuffle=True, random_seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    steps = trainer.train_utterances(loader)
    torch.cuda.synchronize()
    launches = expect_launches({"flash_attention_fwd": 7 * steps,
                                "flash_attention_bwd_fused": steps,
                                **{k: v * steps for k, v in CTC_LAUNCHES.items()}},
                               "meta training")
    peak = peak_gb(torch)
    same_bits(torch, before, model, "meta training (a frozen parameter)", frozen)
    moved = sum(1 for k, p in model.named_parameters()
                if k.startswith(META_PARAM_PREFIXES) and not torch.equal(p, before[k]))
    rows = [json.loads(line) for line in open(os.path.join(ckpt, "metrics.jsonl"))]
    ms = [(b["ts"] - a["ts"]) * 1e3 for a, b in zip(rows, rows[1:])]
    losses = {k: [r[k] for r in rows] for k in ("meta_loss_1", "meta_loss_2", "cosim")}
    if not (moved and all(np.isfinite(v).all() for v in losses.values())):
        raise AssertionError(f"meta training: {moved} meta tensors moved, losses {losses}")
    log(f"  meta training, {n_utt} utterances of {META_FRAMES} frames, {steps} steps of "
        f"{META_BATCH}: step ms (from the second) {[round(t, 1) for t in ms]}, meta_loss_1 "
        f"{[round(v, 4) for v in losses['meta_loss_1']]}, meta_loss_2 (permuted rows) "
        f"{[round(v, 4) for v in losses['meta_loss_2']]}, cosim "
        f"{[round(v, 4) for v in losses['cosim']]}; peak memory {peak:.2f} GB, launches "
        f"{launches}; {len(frozen)} frozen tensors the same bits, {moved} meta tensors moved")
    batch = next(iter(loader))
    audio = torch.from_numpy(batch["audio"]).to(DEVICE)
    lens = torch.from_numpy(batch["audio_lengths"]).to(DEVICE)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    refined = refine_at_inference(model, audio, lens, iterations=META_REFINE_ITERATIONS)
    torch.cuda.synchronize()
    refine_ms = (time.perf_counter() - t0) * 1e3
    refine_launches = expect_launches(
        {"flash_attention_fwd": 6 + META_REFINE_ITERATIONS}, "refine_at_inference")
    if not torch.isfinite(refined["final_posteriors"]).all():
        raise AssertionError("refine_at_inference is not finite")
    log(f"  refine_at_inference, {META_REFINE_ITERATIONS} iterations on ({audio.shape[0]}, 80, "
        f"{audio.shape[-1]}): {refine_ms:.1f} ms, launches {refine_launches}")
    del trainer, model
    return {"steps": steps, "step_ms": ms, "losses": losses, "launches": launches,
            "peak_gb": peak, "refine_ms": refine_ms, "refine_launches": refine_launches}


def dyn_eval_chunks(frames: int) -> int:
    """Chunks of `dynamic_eval_ctc_loss` over `frames` (the moving-window rule)."""
    n, last = 0, None
    for i in range(0, frames, SEQ_LEN - OVERLAP):
        u = min(SEQ_LEN, frames - i)
        n += 1
        if last is not None and u < last:
            break
        last = u
    return n


def adapt_dynamic_eval(torch, model) -> dict:
    """dynamic_eval_ctc_loss on the flagship over DYN_FRAMES frames: at lr 0
    its log-probs agree with StreamingDecoder's averaged decode, at lr 8e-5
    they differ; after either, the state_dict is the same bits as before."""
    import numpy as np

    from lcasr_torch import kernels
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.evaluation.dynamic_eval import dynamic_eval_ctc_loss
    from lcasr_torch.evaluation.streaming import StreamingDecoder

    tok = load_tokenizer()
    spec = seeded_spec(10, DYN_FRAMES)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    n_chunks = dyn_eval_chunks(DYN_FRAMES)
    L = model.n_layers
    out = {}
    for name, lr in (("lr0", 0.0), ("adapted", DYN_LR)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        lp = dynamic_eval_ctc_loss(model, spec, SEQ_LEN, OVERLAP, tok,
                                   num_negatives=DYN_NEGATIVES, epochs=1, lr=lr)
        seconds = time.perf_counter() - t0
        launches = expect_launches({"flash_attention_fwd": 2 * L * n_chunks,
                                    "flash_attention_bwd_fused": L * n_chunks,
                                    **{k: v * n_chunks for k, v in CTC_LAUNCHES.items()}},
                                   f"dynamic evaluation at lr {lr}")
        same_bits(torch, before, model, f"dynamic evaluation at lr {lr}")
        out[name] = {"seconds": seconds, "launches": launches, "peak_gb": peak_gb(torch),
                     "lp": lp}
        log(f"  dynamic evaluation of {DYN_FRAMES} frames at lr {lr:g} ({n_chunks} chunks of "
            f"{SEQ_LEN}, overlap {OVERLAP}, {DYN_NEGATIVES} negatives): {seconds:.2f} s, "
            f"peak memory {out[name]['peak_gb']:.2f} GB, launches {launches}; the state_dict "
            f"the same bits after")
    plain = StreamingDecoder(model, 4096, window_batch_size=WINDOW_BATCH,
                             transfer_dtype=torch.float32, device=DEVICE).logits(
        spec, seq_len=SEQ_LEN, overlap=OVERLAP)
    lp0, lp1 = out["lr0"].pop("lp"), out["adapted"].pop("lp")
    if lp0.shape != plain.shape:
        raise AssertionError(f"dynamic evaluation gave {lp0.shape}, the decode {plain.shape}")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))[None].to(DEVICE)  # noqa: E731
    n = torch.tensor([plain.shape[0]], device=DEVICE)
    agree, max_d, mean_d = logprob_agreement(torch, t(lp0), t(plain), n,
                                             "dynamic evaluation at lr 0 against the decode")
    moved = float(np.abs(lp1 - lp0).max())
    log(f"  at lr 0 against StreamingDecoder's averaged decode: argmax agreement {agree:.5f}, "
        f"max|dlogp| {max_d:.3e}, mean|dlogp| {mean_d:.2e}; at lr {DYN_LR:g} the log-probs "
        f"move by up to {moved:.3e}")
    if not moved > max(10 * max_d, 1e-3):
        raise AssertionError(f"dynamic evaluation at lr {DYN_LR} did not move the log-probs "
                             f"({moved} against {max_d} at lr 0)")
    out.update(agreement=agree, max_dlogp=max_d, mean_dlogp=mean_d, adapted_max_dlogp=moved)
    return out


def adapt_selftrain(torch, model) -> dict:
    """SelfTrainWrapper on one SELFTRAIN_FRAMES-frame utterance for
    SELFTRAIN_ITERATIONS iterations: 9 K1 a pseudo-label pass and a step
    forward, 9 K3 a step, 9 K1 the final pass; the model the same bits
    after."""
    from lcasr_torch import kernels
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.evaluation.selftrain import SelfTrainWrapper

    L, it = model.n_layers, SELFTRAIN_ITERATIONS
    before = {k: v.clone() for k, v in model.state_dict().items()}
    audio = seeded_spec(11, SELFTRAIN_FRAMES)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = SelfTrainWrapper(model, load_tokenizer(), n_iterations=it)(audio)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = expect_launches({"flash_attention_fwd": (2 * it + 1) * L,
                                "flash_attention_bwd_fused": it * L,
                                **{k: v * it for k, v in CTC_LAUNCHES.items()}}, "self-training")
    same_bits(torch, before, model, "self-training")
    if not torch.isfinite(out["final_posteriors"]).all():
        raise AssertionError("self-training's output is not finite")
    log(f"  SelfTrainWrapper, {it} iterations on {SELFTRAIN_FRAMES} frames: {seconds:.2f} s, "
        f"launches {launches}; the state_dict the same bits after")
    return {"seconds": seconds, "launches": launches}


def phase_adapt(torch, workdir: str) -> dict:
    out, seconds = {}, {}
    t0 = time.perf_counter()
    out["meta"] = adapt_meta(torch, workdir)
    seconds["meta"] = round(time.perf_counter() - t0, 1)
    torch.cuda.empty_cache()
    model = flagship_model(torch)
    for name, fn in (("dynamic_eval", adapt_dynamic_eval), ("selftrain", adapt_selftrain)):
        t0 = time.perf_counter()
        out[name] = fn(torch, model)
        seconds[name] = round(time.perf_counter() - t0, 1)
        torch.cuda.empty_cache()
    log(f"  phase adapt seconds: {seconds}")
    out["seconds"] = seconds
    return out


# ---------------------------------------------------------------------------
# phase 2 (end): the Mamba at d_state 32 on its main paths (K6, K7 at N = 32)
# ---------------------------------------------------------------------------
MAMBA_D_STATE = 32


def phase_mamba_d_state(torch, workdir: str) -> dict:
    """The class-default Mamba with its mixers at `d_state` 32 (the mixer's
    option; the model builds its mixers at the mixer's default, which is
    made 32 while the model is built, as the CPU parity test does on both
    sides): the 20-minute decode (24 K6 launches) and one 16384 x 4 micro
    step (12 K6 and 6 K7 under full remat) gated against the plain scan in
    fp64, each with its launch counts zeroed just before and read just
    after."""
    from lcasr_torch import kernels
    from lcasr_torch.config import Config
    from lcasr_torch.models import mamba
    from lcasr_torch.models.registry import load_model
    from lcasr_torch.training.trainer import Trainer

    base = mamba.BiMambaMixer

    class Mixer(base):
        def __init__(self, d_model, d_state=MAMBA_D_STATE, **kw):
            super().__init__(d_model, d_state=d_state, **kw)

    def make(seed, config=None):
        torch.manual_seed(seed)
        cfg = Config(merged(MAMBA_CONFIG, {"model": {"init_seed": seed}}))
        mamba.BiMambaMixer = Mixer
        try:
            return load_model(cfg, 4095, device=DEVICE)
        finally:
            mamba.BiMambaMixer = base

    model = make(0)
    n_state = model.layers[0].mixer.A_log.shape[-1]
    if n_state != MAMBA_D_STATE:
        raise AssertionError(f"the d_state {MAMBA_D_STATE} Mamba has {n_state} states")
    launches, rtfx, _ = phase_decode(torch, model,
                                     {"selective_scan_fwd": MAMBA_EXPECTED_DECODE_LAUNCHES},
                                     f"Mamba d_state {MAMBA_D_STATE}",
                                     "mamba_d_state_decode_profile.txt")
    del model
    n_layers = MAMBA_CONFIG["model"]["n_layers"]
    per_micro = {"selective_scan_fwd": 2 * n_layers, "selective_scan_bwd": n_layers,
                 **CTC_LAUNCHES}
    run = TrainRun(torch, workdir, MAMBA_CONFIG, make, per_micro,
                   f"Mamba d_state {MAMBA_D_STATE}")
    model = make(0)
    trainer = Trainer(run.cfg, model, run.tok, device=DEVICE)
    trainer.init_state()
    _, chunk = run.chunk_16384x4()

    def one_step():
        trainer.zero_pending()
        loss, _ = trainer.micro_step(chunk)
        return float(loss), flat_grads(model)

    kernels.reset_launch_counts()
    one_step()
    step_launches = expect_launches(per_micro, f"the d_state {MAMBA_D_STATE} micro step")
    gate = gradient_gate(f"Mamba d_state {MAMBA_D_STATE}", "the plain scan in fp64", one_step,
                         plain_scan(torch.float64),
                         {"the plain scan in fp32": plain_scan(torch.float32)},
                         floors=(MAMBA_REL_L2_FLOOR, MAMBA_COS_FLOOR))
    return {"decode_launches": launches["selective_scan_fwd"], "decode_rtfx": rtfx,
            "step_launches": {k: step_launches[k] for k in per_micro}, "step_gate": gate}


# ---------------------------------------------------------------------------
# phase 20: the host tooling on one path: WAVs -> preprocessing in two shards
# -> pairs -> a trained tokenizer; the flagship trained in two seed repeats
# -> their average -> a profiled, timed decode; the spare components
# ---------------------------------------------------------------------------
TOOLING_WAVS, TOOLING_SECONDS = 4, 180  # seeded 44.1 kHz stereo recordings
TOOLING_VOCAB = 512
TOOLING_WORD_S = 0.6  # seconds from one word to the next
TOOLING_CHUNK = 9216  # two chunks of each 18,001-frame recording: two steps a repeat
TOOLING_REPEATS = (1, 2)
TOOLING_STEP = f"step_{TOOLING_WAVS}"  # the checkpoint each repeat saves at its end
CHAIN_SHAPE = (16, 2048, 6, 128)  # K1 in time_fn_chain: the decode's shape
SPARE_SHAPE = (4, 16_384)  # (B, T) of the spare components at width 768
SPARE_TOL = 1e-4  # of the largest |value|: fp32 sums in another order


def tooling_words(seed: int, n_words: int) -> list:
    """A seeded word-aligned transcript: Zipf-drawn pseudo-words of one to
    three syllables, TOOLING_WORD_S apart (few enough tokens for CTC over a
    chunk), the speaker changing now and then."""
    import numpy as np

    rng = np.random.default_rng(seed)
    syllables = ["ka", "lo", "mi", "ren", "tas", "vo", "du", "shen", "pri", "gal", "nor", "e",
                 "qua", "zi", "bel", "tor"]
    vocab_rng = np.random.default_rng(1234)  # the same vocabulary in every recording
    vocab = ["".join(vocab_rng.choice(syllables, size=int(vocab_rng.integers(1, 4))))
             for _ in range(600)]
    ranks = np.minimum(rng.zipf(1.3, size=n_words), len(vocab)) - 1
    words, speaker = [], 1
    for i, r in enumerate(ranks):
        if rng.uniform() < 0.05:
            speaker = int(rng.integers(1, 4))
        t = 0.15 + TOOLING_WORD_S * i
        words.append({"word": vocab[r], "startTime": f"{t:.2f}s", "endTime": f"{t + 0.25:.2f}s",
                      "speakerTag": speaker})
    return words


def tooling_spare(torch) -> dict:
    """The four spare components at width 768 on (4, 16384, .) on the card
    against the same modules on the CPU in fp32 (TF32 off): the largest
    |difference| over the largest |value|, at most SPARE_TOL."""
    import copy

    from lcasr_torch.models.positional import ScaledSinuEmbedding
    from lcasr_torch.ops.conv import Conv1DSubsampling, TimeReductionModule
    from lcasr_torch.ops.mlp import SwiGLU

    B, T = SPARE_SHAPE
    gen = torch.Generator().manual_seed(5)
    x768 = torch.randn(B, T, 768, generator=gen)
    x80 = torch.randn(B, T, 80, generator=gen)
    lengths = torch.tensor([T - i * (T // B) for i in range(B)], dtype=torch.int32)
    torch.manual_seed(6)
    cases = {
        "SwiGLU": (SwiGLU(768), lambda m, d: m(x768.to(d))),
        "Conv1DSubsampling_train": (Conv1DSubsampling(8, 80, 768, 256, batch_norm=True),
                                    lambda m, d: m(x80.to(d), lengths.to(d), train=True)[0]),
        "Conv1DSubsampling_eval": (Conv1DSubsampling(8, 80, 768, 256, batch_norm=True),
                                   lambda m, d: m(x80.to(d), lengths.to(d))[0]),
        "TimeReductionModule": (TimeReductionModule(768, 768),
                                lambda m, d: m(x768[:, :T - 1].to(d), (lengths - 1).to(d))[0]),
        "ScaledSinuEmbedding": (ScaledSinuEmbedding(768), lambda m, d: m(x768.to(d))),
    }
    out = {}
    for name, (module, run) in cases.items():
        with torch.no_grad():
            for p in module.parameters():  # off the initial values, which are symmetric
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
        card = copy.deepcopy(module).to(DEVICE)
        with torch.no_grad():
            want = run(module, "cpu")
            got = run(card, DEVICE).cpu()
        err = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-6)
        if not (got.shape == want.shape and torch.isfinite(got).all() and err <= SPARE_TOL):
            raise AssertionError(f"{name} on the card: {tuple(got.shape)}, error {err:.3e} of "
                                 f"the largest value (tolerance {SPARE_TOL:g})")
        if name == "Conv1DSubsampling_train":
            for (key, a), b in zip(module.state_dict().items(), card.state_dict().values()):
                if (a.float() - b.cpu().float()).abs().max().item() > 1e-5:
                    raise AssertionError(f"{name}: {key} moved otherwise on the card")
        out[name] = {"shape": list(got.shape), "rel_err": err, "tolerance": SPARE_TOL}
        log(f"  {name} on (4, 16384, .) at width 768: {tuple(got.shape)}, error {err:.2e} of "
            f"the largest value (tolerance {SPARE_TOL:g})")
    return out


def phase_tooling(torch, workdir: str, seed: int) -> dict:
    import numpy as np

    from lcasr_torch import kernels
    from lcasr_torch.config import Config
    from lcasr_torch.data import preprocess
    from lcasr_torch.data.audio import processing_chain
    from lcasr_torch.data.dataloading import (VariableBatchSimpleDataloader,
                                              chunk_text_and_speakers_json, load_json)
    from lcasr_torch.data.tokenizer import SentencePieceBPE, load_tokenizer
    from lcasr_torch.data.train_tokenizer import retrieve_all_text, train_tokenizer
    from lcasr_torch.evaluation.streaming import StreamingDecoder
    from lcasr_torch.models.registry import load_model
    from lcasr_torch.models.sconformer_xl import init_weights_
    from lcasr_torch.ops.flash_attention import flash_attention
    from lcasr_torch.training.checkpointing import (avg_all_models_in_dir, load_checkpoint,
                                                    parameter_names)
    from lcasr_torch.training.trainer import Trainer
    from lcasr_torch.utils import profiling

    out, t_phase = {}, time.perf_counter()
    n_layers = LADDER_CONFIG["model"]["n_layers"]
    log("  left out here: the launcher and `restart` (they need pyyaml) and "
        "`download_pretrained` (it needs the network); the CPU tests run them")
    # 1-2. WAVs, preprocessed in two shards on the card
    audio_dir, txt_dir = os.path.join(workdir, "audio"), os.path.join(workdir, "txt")
    wavs = []
    for i in range(TOOLING_WAVS):
        d = os.path.join(audio_dir, "podcasts", f"show{i % 2}", f"ep{i}")
        os.makedirs(d)
        wavs.append(os.path.join(d, "rec.wav"))
        write_wav(wavs[-1], TOOLING_SECONDS, WAV_RATE, seed + 100 + i)
    t0 = time.perf_counter()
    for shard in range(2):
        preprocess.main(["-audio", audio_dir, "--shard_index", str(shard), "--num_shards", "2",
                         "--device", DEVICE])
    torch.cuda.synchronize()
    out["preprocess_s"] = time.perf_counter() - t0
    worst = 0.0
    for wav in wavs:
        got = np.load(wav.replace(".wav", ".spec.npy"))
        want = processing_chain(wav, device="cpu").numpy()
        step = np.spacing(np.abs(got)).astype(np.float32)
        diff = np.abs(got.astype(np.float32) - want)
        scale = np.abs(want).max()
        if got.dtype != np.float16 or got.shape != want.shape or not (
                diff <= MEL_TOL * scale + step).all():
            raise AssertionError(f"{wav}: the fp16 spectrogram {got.shape} is off the CPU's "
                                 f"{want.shape} by {diff.max():.3e} (tolerance {MEL_TOL:g} of "
                                 f"{scale:.3f} + one fp16 step)")
        worst = max(worst, float((diff / scale).max()))
    out["preprocess_worst_rel"] = worst
    log(f"  preprocessed {TOOLING_WAVS} x {TOOLING_SECONDS} s WAVs in two shards on the card: "
        f"{out['preprocess_s']:.2f} s; each fp16 .spec.npy within {worst:.2e} of the largest "
        f"value of the CPU frontend's (tolerance {MEL_TOL:g} + one fp16 step)")

    # 3. seeded speaker-tagged transcripts, paired
    for i, wav in enumerate(wavs):
        rel = os.path.relpath(os.path.dirname(wav), audio_dir)
        os.makedirs(os.path.join(txt_dir, rel))
        words = tooling_words(seed + 200 + i, int((TOOLING_SECONDS - 1) / TOOLING_WORD_S))
        with open(os.path.join(txt_dir, rel, "rec.json"), "w") as f:
            json.dump({"results": [{"alternatives": [{"words": words}]}]}, f)
    pairs_path = os.path.join(workdir, "pairs.json")
    pairs = preprocess.add_durations(preprocess.pair_audio_txt(audio_dir, txt_dir,
                                                               save_path=pairs_path))
    with open(pairs_path, "w") as f:
        json.dump(pairs, f)
    frames = np.load(wavs[0].replace(".wav", ".spec.npy"), mmap_mode="r").shape[-1]
    if len(pairs) != TOOLING_WAVS or {p["duration"] for p in pairs.values()} != {frames / 100}:
        raise AssertionError(f"pairs {pairs}")
    first = load_json(next(iter(pairs.values()))["txt"])["results"][0]["alternatives"][0]["words"]
    _, speakers = chunk_text_and_speakers_json(first, TOOLING_CHUNK, 0, frames)
    log(f"  {len(pairs)} pairs of {frames / 100:.2f} s; speakers per {TOOLING_CHUNK}-frame "
        f"chunk of the first: {speakers}")

    # 4. a tokenizer trained on the transcripts
    texts = retrieve_all_text(pairs)
    t0 = time.perf_counter()
    tok_path = train_tokenizer(texts, os.path.join(workdir, "tok.model"), vocab_size=TOOLING_VOCAB)
    out["tokenizer_s"] = time.perf_counter() - t0
    native, plain = SentencePieceBPE(tok_path), SentencePieceBPE(tok_path, use_native=False)
    for text in texts:
        ids = plain.encode(text)
        if native.encode(text) != ids or plain.decode(ids) != text:
            raise AssertionError("the trained tokenizer's native and Python encodes differ, "
                                 "or its text does not round-trip")
    out["tokenizer_pieces"] = plain.vocab_size()
    log(f"  tokenizer: {plain.vocab_size()} pieces (asked {TOOLING_VOCAB}) from "
        f"{sum(len(t.split()) for t in texts)} words in {out['tokenizer_s']:.2f} s; native and "
        f"Python encodes equal, the text round-trips")

    # 5. the flagship trained for two steps in each of two seed repeats
    tok = load_tokenizer()
    root = os.path.join(workdir, "repeats")
    # a recomputed layer launches K1 in the forward and again in the backward
    per_micro = {"flash_attention_fwd": 2 * n_layers, "flash_attention_bwd_fused": n_layers,
                 **CTC_LAUNCHES}
    train_s = {}
    for repeat in TOOLING_REPEATS:
        cfg = Config(merged(merged(LADDER_CONFIG, SMOKE_OVERRIDES), {
            "data": {"path": pairs_path}, "audio_chunking": {"size": TOOLING_CHUNK},
            "training": {"batch_size": TOOLING_WAVS, "random_seed": repeat},
            "checkpointing": {"dir": os.path.join(root, f"repeat_{repeat}")}}))
        model = init_weights_(load_model(cfg, tok.vocab_size(), device=DEVICE), seed=repeat)
        trainer = Trainer(cfg, model, tok, device=DEVICE)
        trainer.init_state()
        loader = VariableBatchSimpleDataloader(
            pairs=load_json(pairs_path), tokenizer=tok, batch_size=TOOLING_WAVS,
            chunk_size=TOOLING_CHUNK, chunk_overlap=0, random_seed=repeat)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.train(loader)
        torch.cuda.synchronize()
        train_s[repeat] = time.perf_counter() - t0
        launches = dict(kernels.launch_counts)
        rows = [json.loads(line) for line in open(os.path.join(trainer.checkpoint_dir,
                                                               "metrics.jsonl"))]
        losses = [r["loss"] for r in rows if "loss" in r]
        # a loss of 0 is a chunk whose every row's CTC path was impossible
        if len(losses) != 2 or not all(np.isfinite(x) and x > 0 for x in losses):
            raise AssertionError(f"repeat {repeat}: optimizer steps with losses {losses}, "
                                 f"expected two finite and positive")
        expect_launches({k: 2 * v for k, v in per_micro.items()}, f"repeat {repeat}'s two steps")
        out.setdefault("train_launches", {})[repeat] = launches
        log(f"  repeat {repeat}: two steps of the flagship at {TOOLING_WAVS} x {TOOLING_CHUNK}, "
            f"losses {[round(x, 4) for x in losses]}, launches {launches}, "
            f"{train_s[repeat]:.2f} s with the final checkpoint")
        del trainer, model
    out["train_s"] = train_s

    # 6. their average, against this phase's own float64 mean
    t0 = time.perf_counter()
    avg = avg_all_models_in_dir(root, TOOLING_STEP)
    out["average_s"] = time.perf_counter() - t0
    states = [load_checkpoint(os.path.join(root, f"repeat_{r}", TOOLING_STEP),
                              map_location="cpu") for r in TOOLING_REPEATS]
    names = parameter_names(states[0][1]["config"])
    mean = {n: ((states[0][0]["model"][n].double() + states[1][0]["model"][n].double())
                / len(TOOLING_REPEATS)).float() for n in names}
    if avg.keys() != mean.keys() or not all(torch.equal(avg[n], mean[n]) for n in names):
        raise AssertionError("avg_all_models_in_dir differs from the float64 mean")
    model = load_model(Config(states[0][1]["config"]), tok.vocab_size(), device=DEVICE)
    model.load_state_dict(dict(states[0][0]["model"], **avg), strict=True)
    model.eval()
    del states
    log(f"  average of {len(TOOLING_REPEATS)} repeats at {TOOLING_STEP}: {len(avg)} parameters "
        f"(buffers left out), bit-equal to the float64 mean, loaded strictly; "
        f"{out['average_s']:.2f} s")

    # 7-8. one recording decoded under the profiler's trace, then timed
    spec = np.load(wavs[0].replace(".wav", ".spec.npy")).astype(np.float32)
    decoder = StreamingDecoder(model, 4096, window_batch_size=WINDOW_BATCH,
                               transfer_dtype=torch.bfloat16, device=DEVICE)
    kernels.reset_launch_counts()
    ids = decoder.greedy(spec, seq_len=SEQ_LEN, overlap=OVERLAP)
    k1 = kernels.launch_counts["flash_attention_fwd"]
    expect_launches({"flash_attention_fwd": k1}, "the averaged model's decode")
    if k1 == 0 or k1 % n_layers:
        raise AssertionError(f"the decode launched K1 {k1} times, not {n_layers} a window batch")
    trace_dir = os.path.join(workdir, "trace")
    with profiling.trace(trace_dir) as prof:
        again = decoder.greedy(spec, seq_len=SEQ_LEN, overlap=OVERLAP)
    traced = sum(e.count for e in prof.key_averages()
                 if HOPPER_FWD_SYMBOL in e.key and e.device_type == torch.autograd.DeviceType.CUDA)
    files = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    if not np.array_equal(ids, again) or traced != k1 or not files:
        raise AssertionError(f"the traced decode: ids equal {np.array_equal(ids, again)}, "
                             f"{traced} {HOPPER_FWD_SYMBOL} rows against {k1} launches, "
                             f"trace files {files}")
    timed = profiling.time_fn(decoder.greedy, spec, seq_len=SEQ_LEN, overlap=OVERLAP,
                              warmup=1, iters=3)
    B, T, H, D = CHAIN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn(B, T, H, D, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    chain = profiling.time_fn_chain(lambda x: flash_attention(x, k, v), q, n=20)
    out.update(decode_k1_launches=k1, traced_k1_rows=traced, decode_time=timed,
               k1_chain=chain)
    log(f"  the averaged model's decode of one {frames / 100:.2f} s recording: {k1} K1 launches, "
        f"the profiler's trace ({files[0]}) has {traced} {HOPPER_FWD_SYMBOL} rows; time_fn "
        f"{timed['mean_s'] * 1e3:.2f} ms a decode (mean of {timed['iters']}); time_fn_chain of "
        f"K1 at {CHAIN_SHAPE} {chain['ms']:.4f} ms a call (20 calls queued, with the chain's "
        f"multiply and add)")
    del model, decoder

    # 9. the spare components
    out["spare"] = tooling_spare(torch)
    out["seconds"] = time.perf_counter() - t_phase
    return out


class PhaseClock:
    """Seconds of each phase, logged as it ends."""

    def __init__(self):
        self.seconds, self._name, self._t0 = {}, None, None

    def start(self, name: str) -> None:
        self.stop()
        self._name, self._t0 = name, time.perf_counter()

    def stop(self) -> None:
        if self._name is not None:
            self.seconds[self._name] = round(time.perf_counter() - self._t0, 1)
            log(f"  phase {self._name}: {self.seconds[self._name]} s")
            self._name = None


# ---------------------------------------------------------------------------
# phase 21: the CTC kernels (csrc/ctc.cu) at the two training lattices
# ---------------------------------------------------------------------------
# (B, T', classes, label slots): the one-hour step (S = 15,043 pieces, the
# corpus generator's words through the port's tokenizer) and the ladder's
# 16384 x 22 (S ~700)
CTC_SHAPES = {"one_hour": (1, 45000, 4096, 15043), "16384x22": (22, 2048, 4096, 704)}
CTC_RUNS = {"one_hour": 3, "16384x22": 10}  # timed forward + backward pairs
HBM_BYTES_S = 3.35e12


def ctc_bound_ms(B, T, C, U, sms, clock_hz) -> dict:
    """The least time of each pass, the larger of its special functions at
    16 a clock an SM and its bytes at 3.35 TB/s.  Forward: at most two expf
    and one logf a state a step; log-alpha written once and each row's
    distinct emissions read once.  Backward: one more expf (the
    posterior); log-alpha and the log-probs read once, the gradient written
    once.  The T-step chain bounds the kernels far above either."""
    S2, sfu = 2 * U + 1, 16 * sms * clock_hz
    fwd = max(3 * B * T * S2 / sfu, 4 * B * T * (S2 + min(C, U + 1)) / HBM_BYTES_S)
    bwd = max(4 * B * T * S2 / sfu, 4 * B * T * (S2 + 2 * C) / HBM_BYTES_S)
    return {"fwd": 1e3 * fwd, "bwd": 1e3 * bwd}


def phase_ctc(torch, seed: int) -> dict:
    """At each lattice of CTC_SHAPES: the partition and how many of its
    clusters the card holds at once; the kernels against PyTorch's CTC
    (tests/test_torch_port_ctc_kernel.py's yardstick: log-alpha, the nll
    and alpha + beta PyTorch's bits, the gradient the fp64 class sums of
    PyTorch's posteriors within GRAD_REL, and F.ctc_loss's own gap from
    those sums beside ours); one ctc_alpha and one ctc_beta launch count
    for a forward that needs the gradient; then device ms (CUDA events) of
    the training forward (`ctc_lattice`: both recursions and the
    gradient), of alpha alone (a forward without gradient), per kernel
    from the profiler, beside their bound and F.ctc_loss's own forward and
    backward (`library_ms`, the yardstick; the port never calls it on the
    card)."""
    import ctypes

    from lcasr_torch import kernels
    from lcasr_torch.ops import ctc as ctc_ops
    from tests.test_torch_port_ctc_kernel import (GRAD_REL, exact_gradient, library_gradient,
                                                  library_posteriors)

    lib = kernels.library("ctc.cu")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = max_sm_clock_hz()
    out = {}
    for name, (B, T, C, U) in CTC_SHAPES.items():
        part = ctc_ops.ctc_partition(B, 2 * U + 1)
        active = ctypes.c_int(0)
        kernels.check(lib, lib.lcasr_ctc_active_clusters(part.cluster, part.threads,
                                                         part.per_thread, ctypes.byref(active)),
                      "ctc occupancy")
        g = torch.Generator(device=DEVICE).manual_seed(seed)
        lp = torch.log_softmax(torch.randn((B, T, C), generator=g, device=DEVICE) * 2, -1)
        labels = torch.randint(0, C - 1, (B, U), generator=g, device=DEVICE)
        il = torch.full((B,), T, dtype=torch.long, device=DEVICE)
        ll = torch.full((B,), U, dtype=torch.long, device=DEVICE)
        weight = torch.ones((B,), device=DEVICE)
        blank = C - 1

        nll_a, alpha = ctc_ops.ctc_alpha(lp, labels, il, ll, blank)
        kernels.reset_launch_counts()
        nll, grad, sums = ctc_ops.ctc_lattice(lp, labels, il, ll, blank)
        launches = expect_launches(CTC_LAUNCHES, f"the CTC at {name}")
        nll_r, alpha_r, sums_r, post_r, ext = library_posteriors(lp, labels, il, ll, blank)
        bits = (torch.equal(alpha, alpha_r) and torch.equal(nll_a, nll_r)
                and torch.equal(nll, nll_r))
        del alpha, alpha_r
        sums_bits = torch.equal(sums, sums_r)  # full lengths: every state is the rows'
        del sums, sums_r
        exact = exact_gradient(lp, post_r, ext, il, nll_r, weight)
        mass = post_r.sum(2)
        mass_range = (float(mass.min()), float(mass.max()))
        del post_r, mass
        grad_rel = float(((grad.double() - exact).abs() / exact.abs().clamp_min(1.0)).max())
        lib_grad = library_gradient(lp, labels, il, ll, blank, weight)
        lib_rel = float(((lib_grad.double() - exact).abs() / exact.abs().clamp_min(1.0)).max())
        del grad, lib_grad, exact
        log(f"  CTC {name} (B, T, C, U) = {(B, T, C, U)}: {part}, {active.value} clusters at "
            f"once; log-alpha and nll {'the same bits as' if bits else 'NOT the bits of'} "
            f"torch._ctc_loss's, alpha + beta {'the same bits as' if sums_bits else 'NOT the bits of'} "
            f"PyTorch's (posteriors' sum a frame {mass_range[0]:.6g} to {mass_range[1]:.6g}); "
            f"gradient against the fp64 class sums: ours {grad_rel:.3e} (limit {GRAD_REL:g}), "
            f"F.ctc_loss's {lib_rel:.3e} (relative to max(1, |value|)); launches {launches}")
        if not (bits and sums_bits and grad_rel <= GRAD_REL):
            raise AssertionError(f"the CTC kernels disagree with PyTorch's at {name}")

        def events(fn, runs):
            ms = []
            for _ in range(runs):
                e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                e[0].record()
                fn()
                e[1].record()
                e[1].synchronize()
                ms.append(e[0].elapsed_time(e[1]))
            return ms

        train_ms = events(lambda: ctc_ops.ctc_lattice(lp, labels, il, ll, blank), CTC_RUNS[name])
        alpha_ms = events(lambda: ctc_ops.ctc_alpha(lp, labels, il, ll, blank), CTC_RUNS[name])
        per_kernel = {k: v[0] / 1e3 / v[1] for k, v in device_kernel_totals(
            torch, lambda: ctc_ops.ctc_lattice(lp, labels, il, ll, blank), n=2).items()
            if "ctc_" in k}
        lib_fwd, lib_bwd = [], []
        for _ in range(2 if name == "one_hour" else 5):
            x = lp.detach().clone().requires_grad_()
            e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            e[0].record()
            loss = torch.nn.functional.ctc_loss(x.transpose(0, 1), labels, il, ll, blank=blank,
                                                reduction="none", zero_infinity=True).sum()
            e[1].record()
            loss.backward()
            e[2].record()
            e[2].synchronize()
            lib_fwd.append(e[0].elapsed_time(e[1]))
            lib_bwd.append(e[1].elapsed_time(e[2]))
            del x, loss
        bound = ctc_bound_ms(B, T, C, U, sms, clock_hz)
        entry = {"shape": [B, T, C, U], "partition": part._asdict(),
                 "active_clusters": active.value, "alpha_nll_bits_equal": bits,
                 "sums_bits_equal": sums_bits, "posterior_mass": mass_range,
                 "grad_rel": grad_rel, "library_grad_rel": lib_rel, "train_ms": train_ms,
                 "alpha_ms": alpha_ms, "per_kernel_ms": per_kernel, "library_fwd_ms": lib_fwd,
                 "library_bwd_ms": lib_bwd, "bound_ms": bound,
                 "us_per_step": {"train": 1e3 * min(train_ms) / T,
                                 "alpha": 1e3 * min(alpha_ms) / T}}
        log(f"  CTC {name}: the training forward (both recursions, the gradient) "
            f"{min(train_ms):.3f}-{max(train_ms):.3f} ms ({entry['us_per_step']['train']:.3f} us "
            f"a step; bound {bound['fwd'] + bound['bwd']:.3f}), alpha alone "
            f"{min(alpha_ms):.3f}-{max(alpha_ms):.3f} ms ({entry['us_per_step']['alpha']:.3f} us "
            f"a step; bound {bound['fwd']:.3f}); per kernel {per_kernel}; F.ctc_loss "
            f"(library_ms) forward {min(lib_fwd):.2f}-{max(lib_fwd):.2f}, backward "
            f"{min(lib_bwd):.2f}-{max(lib_bwd):.2f} ms")
        out[name] = entry
        del lp, labels
        torch.cuda.empty_cache()
    return out


NORM_SHAPES = ((32768, 768), (32768, 1024))  # a window group's rows: flagship, Parakeet


def norm_bound_ms(rows: int, D: int, backward: bool) -> float:
    """The least time of a bf16 row norm at 3.35 TB/s: the forward reads x
    and writes y; the backward reads x, dy, mean and rstd and writes dx,
    dscale and dbias."""
    nbytes = rows * D * 2 * (3 if backward else 2) + (rows * 8 + D * 8 if backward else 0)
    return 1e3 * nbytes / HBM_BYTES_S


def phase_norms(torch, seed: int) -> dict:
    """At each of NORM_SHAPES in bf16, LayerNorm and RMSNorm: the kernels
    against the eager versions (the forward's largest gap in bf16 ulps, the
    backward's dx / dscale / dbias gaps from the eager autograd's); device
    ms (CUDA events over 50 calls back to back, and each kernel's own time
    by the profiler) of the forward without statistics, with them, and the
    backward, beside the byte bound, the eager chain's ms and F.layer_norm /
    F.rms_norm's (`library_ms`, the yardstick; the port never calls them)."""
    from lcasr_torch.ops import norms
    from tests.test_torch_port_norm_kernel import bf16_ulp, make_case

    F = torch.nn.functional
    out = {}
    for kind, eps in (("layer_norm", 1e-5), ("rms_norm", 1e-6)):
        for rows, D in NORM_SHAPES:
            x, scale, bias = make_case(DEVICE, rows, D, torch.bfloat16, seed)
            bias = bias if kind == "layer_norm" else None
            ref = ((lambda t: norms.layer_norm_ref(t, scale, bias, eps)) if bias is not None
                   else (lambda t: norms.rms_norm_ref(t, scale, eps)))
            lib_args = (scale.to(torch.bfloat16), None if bias is None else bias.to(torch.bfloat16))
            library = ((lambda t: F.layer_norm(t, (D,), *lib_args, eps)) if bias is not None
                       else (lambda t: F.rms_norm(t, (D,), lib_args[0], eps)))
            with torch.no_grad():
                y = norms._row_norm(x, scale, bias, eps)
                y_ref = ref(x)
            # the eager output: equal in most values, many ulps off only where y
            # cancels near 0 (the statistics' last bits); the eager elementwise
            # chain fed the kernel's own statistics: the same bits
            same = float((y == y_ref).float().mean())
            ulps = float(((y.float() - y_ref.float()).abs() / bf16_ulp(y_ref)).max())
            dy = torch.randn_like(y)
            _, mean, rstd = norms.row_norm_fwd(x, scale, bias, eps, stats=True)
            h = (x.float() * rstd[:, None] if bias is None
                 else (x.float() - mean[:, None]) * rstd[:, None])
            chain_bits = torch.equal(y, (h * scale if bias is None else h * scale + bias).to(y.dtype))
            grads = norms.row_norm_bwd(x, dy, mean, rstd, scale)
            leaves = [x.clone().requires_grad_(), scale.clone().requires_grad_()] + (
                [] if bias is None else [bias.clone().requires_grad_()])
            y_eager = (norms.rms_norm_ref(leaves[0], leaves[1], eps) if bias is None
                       else norms.layer_norm_ref(leaves[0], leaves[1], leaves[2], eps))
            eager_grads = torch.autograd.grad(y_eager, leaves, dy, retain_graph=True)
            gaps = {name: float((a.float() - b.float()).abs().max() / b.float().abs().max())
                    for name, a, b in zip(("dx", "dscale", "dbias"), grads, eager_grads)}
            if (not chain_bits or gaps["dx"] > 1e-2
                    or max(v for k, v in gaps.items() if k != "dx") > 1e-4):
                raise AssertionError(f"{kind} {rows} x {D}: the eager chain on the kernel's "
                                     f"statistics {'equal' if chain_bits else 'NOT equal'}, "
                                     f"gradient gaps from the eager autograd's {gaps}")

            def fwd():
                norms.row_norm_fwd(x, scale, bias, eps, stats=False)

            def fwd_stats():
                norms.row_norm_fwd(x, scale, bias, eps, stats=True)

            def bwd():
                norms.row_norm_bwd(x, dy, mean, rstd, scale)

            def eager_bwd():
                torch.autograd.grad(y_eager, leaves, dy, retain_graph=True)

            lib_leaves = [x.clone().requires_grad_()] + [
                t.clone().requires_grad_() for t in lib_args if t is not None]
            y_lib = (F.layer_norm(lib_leaves[0], (D,), lib_leaves[1], lib_leaves[2], eps)
                     if bias is not None else F.rms_norm(lib_leaves[0], (D,), lib_leaves[1], eps))

            def library_bwd():
                torch.autograd.grad(y_lib, lib_leaves, dy, retain_graph=True)

            with torch.no_grad():
                ms = {"fwd": device_ms(torch, fwd), "fwd_stats": device_ms(torch, fwd_stats),
                      "eager_fwd": device_ms(torch, lambda: ref(x), n=10),
                      "library_fwd": device_ms(torch, lambda: library(x))}
            ms.update(bwd=device_ms(torch, bwd), eager_bwd=device_ms(torch, eager_bwd, n=10),
                      library_bwd=device_ms(torch, library_bwd))
            kernel_ms = {}
            for name, fn in (("fwd", fwd), ("fwd_stats", fwd_stats), ("bwd", bwd)):
                totals = device_kernel_totals(torch, fn, n=20)
                kernel_ms[name] = {k: v[0] / 1e3 / v[1] for k, v in totals.items()}
            bound = {"fwd": norm_bound_ms(rows, D, False), "bwd": norm_bound_ms(rows, D, True)}
            own = {name: sum(v for k, v in per.items() if "row_norm" in k or "column_sum" in k)
                   for name, per in kernel_ms.items()}
            entry = {"shape": [rows, D], "dtype": "bf16", "fwd_equal_share": same,
                     "fwd_max_ulps": ulps, "grad_gaps": gaps,
                     "ms": ms, "kernel_ms": kernel_ms, "bound_ms": bound,
                     "roofline": {"fwd": bound["fwd"] / own["fwd"],
                                  "bwd": bound["bwd"] / own["bwd"]}}
            log(f"  {kind} ({rows}, {D}) bf16: forward equal to the eager chain's in "
                f"{100 * same:.3f}% of values (at most {ulps:g} ulp off), its bits on the "
                f"kernel's statistics, "
                f"gradient gaps {gaps}; device ms: forward {ms['fwd']:.4f} (kernel "
                f"{own['fwd']:.4f}, bound {bound['fwd']:.4f}: "
                f"{100 * entry['roofline']['fwd']:.1f}%), with statistics "
                f"{ms['fwd_stats']:.4f}, backward {ms['bwd']:.4f} (kernels {own['bwd']:.4f}, "
                f"bound {bound['bwd']:.4f}: {100 * entry['roofline']['bwd']:.1f}%); eager "
                f"{ms['eager_fwd']:.4f} / {ms['eager_bwd']:.4f}; library_ms "
                f"{ms['library_fwd']:.4f} / {ms['library_bwd']:.4f}; per kernel {kernel_ms}")
            out[f"{kind}_{D}"] = entry
            del x, y, y_ref, dy, leaves, y_eager, lib_leaves, y_lib
            torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES))
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the WAV files and weights of phases audio and serve")
    parser.add_argument("--scan_source", default=None,
                        help="with phase kernels: hold K6 and K7 at d_state 16 to the bits of "
                             "this selective_scan.cu (another commit's)")
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
    clock = PhaseClock()
    clock.start("build")
    log("[1/22] build")
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
        clock.start("kernels")
        log("[2/22] kernels against their plain versions")
        results["flash_attention_fwd"] = phase_kernels(torch)
        results["flash_attention_fwd_db"] = phase_kernels_db(torch)
        fwd_registers = {**template_entries(kernels.build_log["flash_attn_fwd.cu"]),
                         **template_entries(kernels.build_log["flash_attn_fwd_db.cu"])}
        for name, numbers in phase_kernels_d256(torch, fwd_registers).items():
            results[name].update(numbers)
        results.update(phase_kernels_bwd(
            torch, template_entries(kernels.build_log["flash_attn_bwd.cu"])))
        results.update(phase_kernels_ssm(torch))
        if args.scan_source:
            results["selective_scan_fwd"]["bits_against"] = scan_bits_against(
                torch, args.scan_source)
        results["subsampling_fused"] = phase_kernels_sub(torch)
        log(f"  the class-default Mamba at d_state {MAMBA_D_STATE}: the 20-minute decode and a "
            f"16384 x 4 micro step")
        os.makedirs(workdir, exist_ok=True)
        try:
            mamba_n = phase_mamba_d_state(torch, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        results["selective_scan_fwd"]["d_state_cases"][MAMBA_D_STATE]["launches"] = {
            "decode": mamba_n["decode_launches"],
            "micro_step": mamba_n["step_launches"]["selective_scan_fwd"]}
        results["selective_scan_bwd"]["d_state_cases"][MAMBA_D_STATE]["launches"] = {
            "micro_step": mamba_n["step_launches"]["selective_scan_bwd"]}
        results["selective_scan_fwd"]["mamba_d_state_32"] = mamba_n
    model = None
    if "model" in phases:
        clock.start("model")
        log("[3/22] flagship model, one window batch")
        model = flagship_model(torch)
        phase_model(torch, model, plain_attention(), "flagship")
    if "decode" in phases:
        clock.start("decode")
        log("[4/22] 20-minute streaming greedy decode (the serving path)")
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
        clock.start("train")
        log("[5/22] training: the ladder Trainer, 8192x8 -> 16384x4, then 120000x1 "
            "(the training path)")
        os.makedirs(workdir, exist_ok=True)
        try:
            ladder, banded, k3_step, host = phase_train(torch, workdir)
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
        results["flash_attention_fwd"]["train_host_side"] = host
    if "train_d256" in phases:
        clock.start("train_d256")
        log("[6/22] lcasr_6l_768d_3h (head_dim 256) trains: K1 and K3 at D = 256")
        os.makedirs(workdir, exist_ok=True)
        try:
            d256 = phase_train_d256(torch, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        for key in ("flash_attention_fwd", "flash_attention_bwd_fused"):
            entry = results.setdefault(key, {"name": key})
            entry["launches_train_d256"] = d256["launches"][key]
        results["flash_attention_bwd_fused"]["train_d256"] = {
            k: v for k, v in d256.items() if k != "launches"}
    if "utterances" in phases:
        clock.start("utterances")
        log("[7/22] utterance training with debug hooks, and wild-card CTC on the card")
        os.makedirs(workdir, exist_ok=True)
        try:
            utt = phase_utterances(torch, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        for key in ("flash_attention_fwd", "flash_attention_bwd_fused"):
            results.setdefault(key, {"name": key})["launches_utterances"] = utt["launches"][key]
        results["flash_attention_fwd"]["utterances_phase"] = {
            k: v for k, v in utt.items() if k != "launches"}
    if "mamba_decode" in phases:
        clock.start("mamba_decode")
        log("[8/22] Mamba: one window batch, then the 20-minute streaming greedy decode")
        model = mamba_model(torch)
        phase_model(torch, model, plain_scan(torch.float32), "Mamba")
        launches, rtfx, rows = phase_decode(
            torch, model, {"selective_scan_fwd": MAMBA_EXPECTED_DECODE_LAUNCHES}, "Mamba",
            "mamba_decode_profile.txt")
        del model
        k6 = results.setdefault("selective_scan_fwd", {"name": "selective_scan_fwd"})
        k6["launches"] = launches["selective_scan_fwd"]
        k6["decode_profile"] = dict(profile_share(rows, SSM_KERNELS["selective_scan_fwd"][0],
                                                  "K6", "the Mamba decode"), rtfx=rtfx)
    if "mamba_train" in phases:
        clock.start("mamba_train")
        log("[9/22] Mamba training: the ladder Trainer, 8192x8 -> 16384x4, then 120000x1")
        os.makedirs(workdir, exist_ok=True)
        try:
            ladder, k6_step, k7_step, host = phase_mamba_train(torch, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        # K7 runs only in training: its count is the ladder run's
        k7 = results.setdefault("selective_scan_bwd", {"name": "selective_scan_bwd"})
        k7["launches"] = ladder["selective_scan_bwd"]
        k7["train_step_profile"] = k7_step
        k6 = results.setdefault("selective_scan_fwd", {"name": "selective_scan_fwd"})
        k6["launches_ladder"] = ladder["selective_scan_fwd"]
        k6["train_step_profile"] = k6_step
        k6["train_host_side"] = host
    if "decode_opt" in phases:
        clock.start("decode_opt")
        log("[10/22] the opt-in decode configuration (K2, K8) and the decoder's options")
        launches, mamba_launches, numbers = phase_decode_opt(torch)
        for key in ("flash_attention_fwd_db", "subsampling_fused"):
            results.setdefault(key, {"name": key})["launches"] = launches[key]
        results["subsampling_fused"]["launches_mamba_decode"] = mamba_launches["subsampling_fused"]
        results["subsampling_fused"].update(numbers)
    if "train_opt" in phases:
        clock.start("train_opt")
        log("[11/22] one training step under both flags, and under each alone, against the "
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
    if "audio" in phases or "serve" in phases:
        audio_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                                 "smoke_audio")
        os.makedirs(audio_dir, exist_ok=True)
        try:
            k1 = results.setdefault("flash_attention_fwd", {"name": "flash_attention_fwd"})
            if "audio" in phases:
                clock.start("audio")
                log("[12/22] from a WAV file to a transcript and a WER: the frontend on the "
                    "card, evaluate in its three modes, the head_dim-256 model")
                audio = phase_audio(torch, audio_dir, args.seed)
                k1["audio_phase"] = audio
                k1["launches_d256_decode"] = audio["wav_d256"]["launches"]
                results.setdefault("flash_attention_fwd_db", {"name": "flash_attention_fwd_db"})[
                    "launches_d256_decode"] = audio["wav_d256_k2"]["launches"]
            if "serve" in phases:
                clock.start("serve")
                log("[13/22] the streaming server: 4 sessions on the flagship, then the CLI")
                k1["serve_phase"] = phase_serve(torch, audio_dir, args.seed)
        finally:
            shutil.rmtree(audio_dir, ignore_errors=True)
    if "enc_dec" in phases:
        clock.start("enc_dec")
        log("[14/22] the encoder-decoder family: forwards, greedy decoding both ways, "
            "enc_dec training, the internal-LM beam search")
        os.makedirs(workdir, exist_ok=True)
        try:
            enc_dec = phase_enc_dec(torch, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        k1 = results.setdefault("flash_attention_fwd", {"name": "flash_attention_fwd"})
        k3 = results.setdefault("flash_attention_bwd_fused", {"name": "flash_attention_bwd_fused"})
        k1["launches_enc_dec_forward"] = enc_dec["forward_EncDecSconformer"]["launches"]
        k1["launches_enc_dec_forward_v2"] = enc_dec["forward_EncDecSconformerV2"]["launches"]
        for key, entry in (("flash_attention_fwd", k1), ("flash_attention_bwd_fused", k3)):
            entry["launches_enc_dec_micro_step"] = enc_dec["train"]["launches"][key]
            entry["launches_enc_dec_ladder"] = enc_dec["train"]["launches_ladder"][key]
        k1["enc_dec_phase"] = enc_dec
    if "lm" in phases:
        clock.start("lm")
        log("[15/22] decoding with a language model: train_lm, cached steps, create_logits, "
            "the beam searches, beam serving")
        lm_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke_lm")
        os.makedirs(lm_dir, exist_ok=True)
        try:
            lm_out = phase_lm(torch, lm_dir, args.seed)
        finally:
            shutil.rmtree(lm_dir, ignore_errors=True)
        k1 = results.setdefault("flash_attention_fwd", {"name": "flash_attention_fwd"})
        k1["launches_lm_create_logits"] = lm_out["create_logits"]["launches"]
        k1["launches_lm_serve_beam"] = lm_out["serve"]["launches"]
        k1["lm_phase"] = lm_out
    if "parallel" in phases:
        clock.start("parallel")
        log("[16/22] parallelism: the ring schedule on the card, then a world of one over NCCL "
            "(the flagship step, the TP model's ZeRO step, the mesh decode)")
        par_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                               "smoke_parallel")
        os.makedirs(par_dir, exist_ok=True)
        try:
            par = phase_parallel(torch, par_dir)
        finally:
            shutil.rmtree(par_dir, ignore_errors=True)
        full, band = par["ring"]
        k1 = results.setdefault("flash_attention_fwd", {"name": "flash_attention_fwd"})
        k1["ring_phase"] = {"full": {k: full[k] for k in ("launches_fwd", "lse_diff",
                                                          "max_abs_err", "ms")},
                            "band": {k: band[k] for k in ("launches_fwd", "lse_diff",
                                                          "max_abs_err", "ms")}}
        k1["launches_parallel_flagship_step"] = par["flagship"]["launches"]["flash_attention_fwd"]
        k1["launches_parallel_mesh_decode"] = par["decode"]["launches"]["flash_attention_fwd"]
        k1["parallel_phase"] = {k: par[k] for k in ("flagship", "tp_zero", "decode", "seconds")}
        for key, ring in (("flash_attention_bwd_fused", full), ("flash_attention_bwd_dq", band),
                          ("flash_attention_bwd_dkv", band)):
            entry = results.setdefault(key, {"name": key})
            entry["launches_ring"] = ring["launches_bwd"][key]
            entry["ring_phase"] = {"window": ring["window"], "rel_l2": ring["rel_l2"],
                                   "ms": ring["ms"]}
    k1 = results.setdefault("flash_attention_fwd", {"name": "flash_attention_fwd"})
    k3 = results.setdefault("flash_attention_bwd_fused", {"name": "flash_attention_bwd_fused"})
    if "analysis" in phases:
        clock.start("analysis")
        log("[17/22] the paper's analysis on the flagship: attention statistics over one hour, "
            "probability rows against plain attention, attribution, the rotary probe")
        ana = phase_analysis(torch)
        k1["launches_analysis_summary"] = ana["summary"]["launches"]["flash_attention_fwd"]
        k1["launches_attribution"] = ana["attribution"]["launches"]["flash_attention_fwd"]
        k3["launches_attribution"] = ana["attribution"]["launches"]["flash_attention_bwd_fused"]
        k1["launches_rotary_probe"] = ana["probe"]["launches"]["flash_attention_fwd"]
        k1["analysis_phase"] = ana
    if "variants" in phases:
        clock.start("variants")
        log("[18/22] model variants: the W8A8 decode under three policies, the int8 product, "
            "the other families under W8A8, long convolutions")
        var_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                               "smoke_variants")
        os.makedirs(var_dir, exist_ok=True)
        try:
            var = phase_variants(torch, var_dir)
        finally:
            shutil.rmtree(var_dir, ignore_errors=True)
        k1["launches_w8a8_decode"] = {p: v["launches"]["flash_attention_fwd"]
                                      for p, v in var["w8a8_decode"].items()}
        k1["launches_longconv_step"] = var["longconv"]["step_launches"]["flash_attention_fwd"]
        k3["launches_longconv_step"] = var["longconv"]["step_launches"][
            "flash_attention_bwd_fused"]
        results.setdefault("selective_scan_fwd", {"name": "selective_scan_fwd"})[
            "launches_w8a8_mamba_forward"] = var["families"]["Mamba"]["launches"][
            "selective_scan_fwd"]
        k1["variants_phase"] = var
    if "adapt" in phases:
        clock.start("adapt")
        log("[19/22] test-time adaptation: the meta-learning conformer and its trainer, "
            "dynamic evaluation, self-training")
        adapt_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                                 "smoke_adapt")
        os.makedirs(adapt_dir, exist_ok=True)
        try:
            adapt = phase_adapt(torch, adapt_dir)
        finally:
            shutil.rmtree(adapt_dir, ignore_errors=True)
        for key, entry in (("flash_attention_fwd", k1), ("flash_attention_bwd_fused", k3)):
            entry["launches_meta_train"] = adapt["meta"]["launches"][key]
            entry["launches_dynamic_eval"] = adapt["dynamic_eval"]["adapted"]["launches"][key]
            entry["launches_selftrain"] = adapt["selftrain"]["launches"][key]
        k1["launches_meta_refine"] = adapt["meta"]["refine_launches"]["flash_attention_fwd"]
        k1["adapt_phase"] = adapt
    if "tooling" in phases:
        clock.start("tooling")
        log("[20/22] the host tooling: preprocessing, pairs, a tokenizer, two seed repeats "
            "averaged, a profiled decode, the spare components")
        tool_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                                "smoke_tooling")
        shutil.rmtree(tool_dir, ignore_errors=True)
        os.makedirs(tool_dir)
        try:
            tooling = phase_tooling(torch, tool_dir, args.seed)
        finally:
            shutil.rmtree(tool_dir, ignore_errors=True)
        k1 = results.setdefault("flash_attention_fwd", {"name": "flash_attention_fwd"})
        k3 = results.setdefault("flash_attention_bwd_fused", {"name": "flash_attention_bwd_fused"})
        k1["launches_tooling_decode"] = tooling["decode_k1_launches"]
        for key, entry in (("flash_attention_fwd", k1), ("flash_attention_bwd_fused", k3)):
            entry["launches_tooling_micro_step"] = tooling["train_launches"][1][key] // 2
        k1["time_fn_chain_ms"] = tooling["k1_chain"]["ms"]
        k1["tooling_phase"] = tooling
    if "ctc" in phases:
        clock.start("ctc")
        log("[21/22] the CTC kernels at the one-hour and 16384 x 22 lattices, against PyTorch's "
            "CTC")
        results["ctc"] = {"name": "ctc_alpha + ctc_beta", **phase_ctc(torch, args.seed)}
    if "norms" in phases:
        clock.start("norms")
        log("[22/22] the row-norm kernels at a window group's rows, against the eager chain")
        results["norms"] = {"name": "layer_norm + rms_norm", **phase_norms(torch, args.seed)}
    clock.stop()
    log(f"  phase seconds: {clock.seconds}")
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
