#!/usr/bin/env python3
"""Experiments on the bf16 attention backward (K3, and K4 + K5), each in a
patched copy of the port; the repo's own files are never modified.

    python3 scripts/attention_bwd_experiments.py controls  # on a machine with an H100
    python3 scripts/attention_bwd_experiments.py variants

Each experiment copies `lcasr_torch/` and `chip_smoke.py` into
`build/bwd_experiments/<name>/`, patches the copy's `csrc/flash_attn_bwd.cu`,
and runs the backward checks of `chip_smoke.py` there (`bwd_case` on every
case of `attention_cases`: K3 and K4 + K5 against `flash_attention_bwd_ref`,
dk and dv the same bits in two runs, K5's equal to K3's).

  controls  plant one fault each; a control passes when the checks fail.
            Exit 0 only if every fault was caught.
  variants  alternative designs; each must pass the checks, then K3's,
            K4's and K5's device time per launch at (4, 2048, 6, 128) bf16 (profiler)
            is taken in turns with the repo's source (base, variants,
            variants in reverse, base), each with its registers and spills.
            Exit 0 only if every variant passed the checks.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join("lcasr_torch", "csrc", "flash_attn_bwd.cu")

# planted faults: name -> [(text in the source, its replacement)]
CONTROLS = {
    # ds = p dp, without the row's delta
    "no_delta": [("(dp[4 * j + e] - ((e & 1) ? d2.y : d2.x))", "(dp[4 * j + e])")],
    # a band no longer makes every tile an edge tile: tiles inside the
    # length go unmasked under a band
    "band_tiles_unmasked": [("const bool key_edge = p.left >= 0 || p.right >= 0 ||",
                             "const bool key_edge =")],
    # at D 128 the second consumer adds its dq columns onto the first's
    "dq_columns": [("(TL::DQ_SPLIT ? cw * 64 : 0) + blk * DQ_BOX_COLS", "blk * DQ_BOX_COLS")],
    # K4: ds = p dp, without the row's delta
    "k4_no_delta": [("dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - del[e >> 1]);",
                     "dp[4 * j + e] = s[4 * j + e] * dp[4 * j + e];")],
    # K4: a band no longer makes every key tile an edge tile
    "k4_band_tiles_unmasked": [("const bool row_edge = p.left >= 0 || p.right >= 0 ||",
                                "const bool row_edge =")],
}

_STAGED_DQ = """        unsigned char* part = reinterpret_cast<unsigned char*>(sDQ + cw * HBQ * TL::DQ_N);
        if (tid == 0) hopper::bulk_wait_read();  // the last tile's adds have read it
        hopper::named_sync(DQ_BAR + cw, 128);
#pragma unroll
        for (int j = 0; j < TL::DQ_N / 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = warp * 16 + g + 8 * r, col = 8 * j + 2 * t;
            const int cb = col % DQ_BOX_COLS;
            *reinterpret_cast<float2*>(part + col / DQ_BOX_COLS * (HBQ * 128) + row * 128 +
                                       (((cb >> 2) ^ (row & 7)) << 4) + (cb & 3) * 4) =
                make_float2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
          }
        hopper::fence_proxy_async();
        hopper::named_sync(DQ_BAR + cw, 128);
        if (tid == 0) {
#pragma unroll
          for (int blk = 0; blk < TL::DQ_N / DQ_BOX_COLS; ++blk)
            hopper::tma_reduce_add_4d(&tdq, part + blk * (HBQ * 128),
                                      (TL::DQ_SPLIT ? cw * 64 : 0) + blk * DQ_BOX_COLS,
                                      h, q0, b);
          hopper::bulk_commit();
        }
"""
_RED_V4 = """        // thread pairs (t, t ^ 1) trade halves so that each holds four
        // consecutive columns of one row: the even one row g, the odd one g + 8
        const int odd = t & 1;
        const int row = q0 + warp * 16 + g + 8 * odd;
        const int col = (TL::DQ_SPLIT ? cw * 64 : 0) + 2 * (t & ~1);
        float* dst = p.dq + (((long long)b * p.Tq + row) * p.H + h) * D + col;
        const bool live = p.q_off + row < lim.q_hi;
#pragma unroll
        for (int j = 0; j < TL::DQ_N / 8; ++j) {
          const float a0 = dq[4 * j], a1 = dq[4 * j + 1];
          const float b0 = dq[4 * j + 2], b1 = dq[4 * j + 3];
          const float r0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
          const float r1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
          const float4 v = odd ? make_float4(r0, r1, b0, b1) : make_float4(a0, a1, r0, r1);
          if (live) atomicAdd(reinterpret_cast<float4*>(dst + 8 * j), v);
        }
"""

_DS_AND_BOTH = """      hopper::wgmma_wait<0>();
      hopper::fence_all<HBQ / 2>(dp);"""
_PACK_BOTH = """      uint32_t pa[HBQ / 16][4], da[HBQ / 16][4];
      hopper::pack_frags<HBQ / 16>(pa, s);
      hopper::pack_frags<HBQ / 16>(da, dp);
"""
_ISSUE_BOTH = """      hopper::fence_all<D / 2>(dv);
      hopper::fence_all<D / 2>(dk);
      hopper::fence_frags<HBQ / 16>(pa);
      hopper::fence_frags<HBQ / 16>(da);
      hopper::wgmma_fence();
      issue_rows_times_tile<D>(dv, pa, tO);
      issue_rows_times_tile<D>(dk, da, tQ);
      hopper::wgmma_commit();
"""

# design alternatives: name -> [(text in the source, its replacement)]
VARIANTS = {
    # K4 with 128-key tiles: s and dp take 64 registers each instead of 32
    "k4_keys_128": [("constexpr int DQ_KEYS = 64;", "constexpr int DQ_KEYS = 128;")],
    # dq added from registers by four-float red.global.add (thread pairs
    # trade halves of their rows) instead of staged and TMA reduce-added
    "red_v4": [(_STAGED_DQ, _RED_V4)],
    # dv += p^T do issued as soon as p^T is packed, in flight while ds^T is
    # computed; dk += ds^T q after
    "early_dv": [(_DS_AND_BOTH, """      uint32_t pa[HBQ / 16][4], da[HBQ / 16][4];
      hopper::pack_frags<HBQ / 16>(pa, s);
      hopper::fence_all<D / 2>(dv);
      hopper::fence_frags<HBQ / 16>(pa);
      hopper::wgmma_fence();
      issue_rows_times_tile<D>(dv, pa, tO);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_all<HBQ / 2>(dp);"""), (_PACK_BOTH, "      hopper::pack_frags<HBQ / 16>(da, dp);\n"),
                 (_ISSUE_BOTH, """      hopper::fence_all<D / 2>(dk);
      hopper::fence_frags<HBQ / 16>(da);
      hopper::wgmma_fence();
      issue_rows_times_tile<D>(dk, da, tQ);
      hopper::wgmma_commit();
""")],
}

CHECK = """
import json, sys
import torch
import chip_smoke as cs
from lcasr_torch import kernels

kernels.build()
entries = cs.template_entries(kernels.build_log["flash_attn_bwd.cu"])
serialised = "wgmma.mma_async instructions are serialized" in kernels.build_log["flash_attn_bwd.cu"]
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(1)
for case in cs.attention_cases(torch):
    try:
        cs.bwd_case(torch, case, gen)
    except AssertionError as e:
        print("CAUGHT", e)
        sys.exit(1)
print("NOT CAUGHT")
if "--time" in sys.argv:
    B, T, H, D = cs.TRAIN_ATTN_SHAPE
    q, k, v = cs.make_qkv(torch, B, T, H, D, torch.bfloat16, True, gen)
    from lcasr_torch.ops.flash_attention import flash_attention_with_lse
    o, lse = flash_attention_with_lse(q, k, v)
    do = torch.randn((B, T, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    args = (q, k, v, o, lse, do, None, (-1, -1), None, 0, 0)
    out = {"serialised_wgmma": serialised}
    for key, fused in (("flash_attention_bwd_fused", True), ("flash_attention_bwd_dkv", False),
                       ("flash_attention_bwd_dq", False)):
        sym = cs.BWD_KERNELS[key][0]
        ms = cs.kernel_device_ms(torch, lambda: cs.run_bwd(torch, fused, *args), [sym])[sym]
        out[key] = {"ms": ms, "ptxas": entries.get(sym)}
    print("TIMES " + json.dumps(out))
"""


def prepare(name: str, patches) -> str:
    copy = os.path.join(ROOT, "build", "bwd_experiments", name)
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "lcasr_torch"), os.path.join(copy, "lcasr_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), copy)
    path = os.path.join(copy, SOURCE)
    text = open(path).read()
    for old, new in patches:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: a text to replace is not in {SOURCE} exactly once")
        text = text.replace(old, new)
    open(path, "w").write(text)
    return copy


def run_check(copy: str, *flags: str):
    proc = subprocess.run([sys.executable, "-c", CHECK, *flags], cwd=copy, capture_output=True,
                          text=True, timeout=900)
    lines = (proc.stdout + proc.stderr).strip().splitlines()
    caught = proc.returncode != 0 and any(ln.startswith("CAUGHT") for ln in lines)
    verdict = next((ln for ln in lines if ln.startswith(("CAUGHT", "NOT CAUGHT"))),
                   lines[-1] if lines else "(no output)")
    times = next((json.loads(ln[6:]) for ln in lines if ln.startswith("TIMES ")), None)
    return caught, verdict, times


def controls() -> int:
    ok = True
    for name, patches in CONTROLS.items():
        caught, verdict, _ = run_check(prepare(name, patches))
        print(f"control {name}: {'caught' if caught else 'NOT caught'}: {verdict[:400]}", flush=True)
        ok &= caught
    return 0 if ok else 1


def variants() -> int:
    copies = {"base": prepare("base", [])}
    copies.update({name: prepare(name, patches) for name, patches in VARIANTS.items()})
    order = list(copies)
    ok = True
    for name in order + order[::-1]:
        caught, verdict, times = run_check(copies[name], "--time")
        if caught or times is None:
            print(f"variant {name}: FAILED the checks: {verdict[:400]}", flush=True)
            ok = False
            continue
        print(f"variant {name}: " + json.dumps(times), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) != 2 or sys.argv[1] not in ("controls", "variants"):
        raise SystemExit(__doc__)
    sys.exit(controls() if sys.argv[1] == "controls" else variants())
