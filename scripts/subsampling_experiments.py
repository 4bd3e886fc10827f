#!/usr/bin/env python3
"""Experiments on the fused 8x subsampling K8, each in a copy of the port;
the repo's own files are never modified.

    python3 scripts/subsampling_experiments.py controls     # on a machine with an H100
    python3 scripts/subsampling_experiments.py variants [names]
    python3 scripts/subsampling_experiments.py time <tree>  # K8 of another checkout

  controls  copy `lcasr_torch/` and `chip_smoke.py` into
            `build/subsampling_experiments/<name>/`, plant one fault in the
            copy's kernel, and run the K8 checks of `chip_smoke.py` there
            (`sub_checks`: the silu tail value by value, every activation,
            tiles of 1 and 2 frames, the channel counts above 256, the main
            shapes).  A control passes when the checks fail.  Exit 0 only if
            every fault was caught.
  variants  alternative kernels in such copies: `first_kernel` is the first
            K8 (`scripts/subsampling_first_kernel.cu`, a SIMT / mma.sync body
            for 128 or 256 channels), kept here and out of the package; the
            `first_stop_*` variants are that body cut short after one of its
            stages (a guarded read of the stage's last buffer keeps its work
            alive), so that their times split the whole one's; the others
            change the repo's kernel (`clocks` builds it with its phase
            clocks and prints each phase's share of a CTA's time).  Checked
            variants must pass the same checks; then K8's device time at the
            decode's window batch (16, 16384, 80) -> 256 bf16 (profiler: every
            kernel whose name contains "subsampling_fused") is taken in turns
            with the repo's source (base, variants, variants in reverse,
            base), with ptxas's registers and spills.  Exit 0 only if every
            checked variant passed.
  time      K8 of the `lcasr_torch` in <tree> (for example an unpacked
            `git archive` of an earlier commit) at the same shape: device
            time, and one wrapper call by CUDA events; with the card's name
            and power limit.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join("lcasr_torch", "csrc", "subsampling_fused.cu")
FIRST_KERNEL = os.path.join("scripts", "subsampling_first_kernel.cu")
# a patch is (file, text in it, its replacement); FIRST replaces the copy's
# kernel source by the first K8 before the patches after it apply
FIRST = (SOURCE, None, FIRST_KERNEL)


def env_patch(name: str, value: str):
    """A patch that sets an environment variable for the copy's run."""
    return (None, name, value)


# a patch that builds the copy with the kernel's phase clocks
# (-DLCASR_K8_CLOCKS) and prints each phase's share of thread 0's clocks
CLOCKS = (None, "--clocks", None)
K8_PHASES = ("input", "stage0", "dw1", "a_barrier", "pw1_wait", "pw1", "epilogue1", "dw2",
             "pw2_wait", "pw2", "tile_end")

# silu as h + h tanh.approx(h), h = v / 2: one special-function operation,
# but off by 4-7 half-ulps of bf16 below v = -8 on the H100 (PERF.md §6);
# in the repo's bf16 kernel and in the first K8
TANH = ("[&] {\n"
        "        const float h = 0.5f * v;\n"
        "        float th;\n"
        "        asm(\"tanh.approx.f32 %0, %1;\" : \"=f\"(th) : \"f\"(h));\n"
        "        return fmaf(h, th, h);\n"
        "      }()")
TANH_SILU = ("  if constexpr (ACT == ACT_SILU) return v * rcp_ftz(1.f + hopper::ex2(v * -1.4426950408889634f));",
             "  if constexpr (ACT == ACT_SILU) return " + TANH + ";")
FIRST_TANH_SILU = ("      return FAST ? __fdividef(v, 1.f + __expf(-v)) : v / (1.f + expf(-v));",
                   "      return FAST ? " + TANH + " : v / (1.f + expf(-v));")

# act(bias) kept in the stage-0 rows left of the input instead of the next
# stage's zero padding: the fp32 kernel (the same in both sources), the
# bf16 kernel of the repo, the first bf16 kernel
ZERO_ROW_FP32 = (SOURCE, "    const int a = item / groups, q = item % groups;\n"
                         "    const bool zero_row = 4 * j0 - 3 + a < 0;",
                 "    const int a = item / groups, q = item % groups;\n"
                 "    const bool zero_row = false;")
ZERO_ROW_DROPPED = [
    ZERO_ROW_FP32,
    (SOURCE, "  if (4 * j0 - 3 + a < 0)\n    zero_row<NT>(L, dst);\n  else\n",
     "  if (false)\n    zero_row<NT>(L, dst);\n  else\n"),
]
FIRST_ZERO_ROW_DROPPED = [
    ZERO_ROW_FP32,
    (SOURCE, "    const int a = item / nj, j = item % nj;\n"
             "    const bool zero_row = 4 * j0 - 3 + a < 0;",
     "    const int a = item / nj, j = item % nj;\n"
     "    const bool zero_row = false;"),
]

# planted faults: name -> patches
CONTROLS = {
    # the silu as h + h tanh.approx(h)
    "tanh_silu": [(SOURCE, *TANH_SILU)],
    # act(bias) kept in the stage-0 rows left of the input (both kernels)
    "zero_row_dropped": ZERO_ROW_DROPPED,
    # every pointwise weight tile loaded from the next K-slice of input
    # channels (the last from the first)
    "weight_tile_one_slice_off": [
        (SOURCE, "(r % nk) * KS, 0,", "((r + 1) % nk) * KS, 0,")],
    # the first K8 with the tanh.approx silu: passes every whole-output gate
    # of the first chip runs, must fail the silu-tail case
    "first_kernel_tanh_silu": [FIRST, (SOURCE, *FIRST_TANH_SILU)],
    # the first K8 keeps act(bias) in the stage-0 rows left of the input
    # instead of the next stage's zero padding
    "first_kernel_zero_row_dropped": [FIRST] + FIRST_ZERO_ROW_DROPPED,
}


def stop_before(anchor: str, buffer: str):
    """The first K8 returning just before the line `anchor`, its last buffer
    read under a condition the launch never meets (act < 0) so that the
    compiler keeps the work before."""
    return [FIRST, (SOURCE, anchor,
                    f"  if (act < 0) static_cast<T*>(p.out)[tid] = from_f<T>(to_f({buffer}[tid]));\n"
                    "  return;\n" + anchor)]


# design alternatives: name -> patches; those in TIMED_ONLY compute a part of
# the function and are timed without the checks
VARIANTS = {
    "first_kernel": [FIRST],
    # the input tile and the zero columns, nothing else
    "first_stop_after_load": stop_before(
        "  // ---- stage 0 and the first depthwise conv, one slice of channels at a time ----\n",
        "sX"),
    # + stage 0 and the first depthwise conv, slice by slice
    "first_stop_after_stage0_dw1": stop_before(
        "  // ---- pointwise 1 + act into sS as stage 1's output (frequency -1 zero) ----\n", "sH"),
    # + the first pointwise product and its activation
    "first_stop_after_pw1": stop_before(
        "  // ---- the second depthwise conv: (To, F/8, C) into sH ----\n", "sS"),
}
# the repo's kernel without one of its parts (the weight ring still runs):
# what each part costs beside the others
VARIANTS.update({
    "no_build_a": [(SOURCE, "      if (kc % 256 == 0)\n        build_a<2, ACT>(p, L, sX, sS, sA, cb, kc, j0);\n"
                            "      else\n        build_a<1, ACT>(p, L, sX, sS, sA, cb, kc, j0);\n",
                    "      __syncthreads();\n")],
    "no_weight_loads": [
        (SOURCE, "      hopper::mbar_arrive_expect_tx(&full[s], (uint32_t)NG * KS * 2);\n"
                 "      hopper::tma_load_4d(slots + (size_t)s * NG * KS, map, &full[s], (r % nk) * KS, 0,\n"
                 "                          (r / nk) * NG, 0);\n",
         "      hopper::mbar_arrive(&full[s]);\n      (void)map;\n")],
    "no_pw1_products": [(SOURCE, "              hopper::wgmma_m64n128k16_ss(acc, da, db, 1);\n", "")],
    "no_pw2_products": [(SOURCE, "            hopper::wgmma_m64n64k16_ss<0, 0>(acc2, da, db, 1);\n", "")],
    # the tile of 3 output frames, whose smaller A leaves room for 4 weight
    # slots (the default at F 80, C 256: 4 frames, 2 slots)
    "tile_3": [env_patch("LCASR_SUB_TILE", "3")],
    "tile_3_clocks": [env_patch("LCASR_SUB_TILE", "3"), CLOCKS],
    # stage 0 one row a pass, not two
    "stage0_one_row": [(SOURCE, "constexpr int STAGE0_ROWS = 2;", "constexpr int STAGE0_ROWS = 1;")],
    # the repo's kernel with its phase clocks (timed with their cost)
    "clocks": [CLOCKS],
    "no_build_a_clocks": [(SOURCE, "      if (kc % 256 == 0)\n        build_a<2, ACT>(p, L, sX, sS, sA, cb, kc, j0);\n"
                                   "      else\n        build_a<1, ACT>(p, L, sX, sS, sA, cb, kc, j0);\n",
                           "      __syncthreads();\n"), CLOCKS],
})
# silu with one special-function operation: z = 2^(-|v| log2 e) by
# ex2.approx, 1 / (1 + z) from a linear seed (error <= 1/17 on (1, 2]) and
# two Newton steps on the FMA pipes (error < 2e-5)
SILU_FMA = """__device__ __forceinline__ float silu_fma(float v) {
  const float z = hopper::ex2(-fabsf(v) * 1.4426950408889634f);
  const float d = 1.f + z;
  float r = fmaf(-0.47058823529411764f, d, 1.4117647058823530f);
  float e = fmaf(-d, r, 1.f);
  r = fmaf(r, e, r);
  e = fmaf(-d, r, 1.f);
  r = fmaf(r, e, r);
  return v * (v < 0.f ? z * r : r);
}

"""
VARIANTS.update({
    # every silu of the bf16 kernel by silu_fma: one special-function
    # operation a value
    "silu_fma": [
        (SOURCE, "template <int ACT>\n__device__ __forceinline__ float act_fast(float v) {",
         SILU_FMA + "template <int ACT>\n__device__ __forceinline__ float act_fast(float v) {"),
        (SOURCE, "  if constexpr (ACT == ACT_SILU) return v * rcp_ftz(1.f + hopper::ex2(v * -1.4426950408889634f));",
         "  if constexpr (ACT == ACT_SILU) return silu_fma(v);")],
    # the silu by __expf and __fdividef (their denormal-range handling: three
    # more instructions a value)
    "silu_no_ftz": [
        (SOURCE, "  if constexpr (ACT == ACT_SILU) return v * rcp_ftz(1.f + hopper::ex2(v * -1.4426950408889634f));",
         "  if constexpr (ACT == ACT_SILU) return __fdividef(v, 1.f + __expf(-v));")],
})
TIMED_ONLY = {"first_stop_after_load", "first_stop_after_stage0_dw1", "first_stop_after_pw1",
              "no_build_a", "no_build_a_clocks", "no_weight_loads", "no_pw1_products", "no_pw2_products"}

SHAPE = "B, T, F, C = cs.SUB_DECODE_SHAPE\n"
PHASES_LINE = f"NAMES = {K8_PHASES!r}\nPHASES = {len(K8_PHASES)}\n"

CHECK = PHASES_LINE + """
import json
import sys
import torch
import chip_smoke as cs
from lcasr_torch import kernels
from lcasr_torch.ops import subsampling as sub

kernels.SOURCES = ("subsampling_fused.cu",)  # the other kernels are not run here
if "--clocks" in sys.argv:
    kernels.NVCC_FLAGS += ("-DLCASR_K8_CLOCKS",)
kernels.build()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
if "--no-check" not in sys.argv:
    try:
        cs.sub_checks(torch, torch.Generator(device="cuda").manual_seed(4),
                      wide="--first" not in sys.argv)
    except (AssertionError, RuntimeError) as e:
        print("CAUGHT", str(e).replace(chr(10), " ")[:300])
        sys.exit(1)
    print("NOT CAUGHT")
if "--time" in sys.argv:
""" + "    " + SHAPE + """
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((B, T, F), generator=gen, device="cuda").to(torch.bfloat16)
    params = cs.sub_params(torch, gen, C, torch.bfloat16)
    fn = lambda: sub.fused_dw_striding(x, params, "silu")
    ms = cs.kernel_group_ms(torch, fn, "subsampling_fused", n=10)
    regs = {fn_: e for fn_, e in cs.ptxas_entries(kernels.build_log["subsampling_fused.cu"]).items()
            if "subsampling" in fn_}
    out = {"ms": ms, "card": cs.gpu_line(), "ptxas": regs}
    if "--clocks" in sys.argv:
        import ctypes
        lib = kernels.library("subsampling_fused.cu")
        buf = (ctypes.c_ulonglong * PHASES)()
        lib.lcasr_subsampling_clocks(buf)  # cleared
        fn()
        torch.cuda.synchronize()
        lib.lcasr_subsampling_clocks(buf)
        out["clock_shares"] = {k: round(v / sum(buf), 4) for k, v in zip(NAMES, buf)}
    print("TIMES " + json.dumps(out))
"""

TIME = """
import sys
sys.path.insert(0, sys.argv[1])  # the tree's lcasr_torch first
import importlib.util
import torch
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[2])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from lcasr_torch import kernels
from lcasr_torch.ops import subsampling as sub

assert sub.__file__.startswith(sys.argv[1]), sub.__file__
kernels.build()
print("card:", cs.gpu_line())
for fn, e in cs.ptxas_entries(kernels.build_log["subsampling_fused.cu"]).items():
    if "subsampling" in fn:
        print("ptxas:", fn[:60], e)
""" + SHAPE + """
gen = torch.Generator(device="cuda").manual_seed(5)
x = torch.randn((B, T, F), generator=gen, device="cuda").to(torch.bfloat16)
params = cs.sub_params(torch, gen, C, torch.bfloat16)
fn = lambda: sub.fused_dw_striding(x, params, "silu")
k8 = cs.kernel_group_ms(torch, fn, "subsampling_fused", n=10)
wrapper = cs.time_ms(torch, fn, n=10)
bound = cs.sub_bound(B, T, F, C, 2, "bf16", torch.cuda.get_device_properties(0).multi_processor_count,
                     cs.max_sm_clock_hz())
print(f"K8 {(B, T, F)} -> {C} bf16: {k8:.4f} ms of device time, wrapper call {wrapper:.4f} ms; "
      f"bound {bound[0]:.4f} ms by {bound[2]['by']}", flush=True)
"""


def prepare(name: str, patches) -> str:
    copy = os.path.join(ROOT, "build", "subsampling_experiments", name)
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "lcasr_torch"), os.path.join(copy, "lcasr_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), copy)
    for rel, old, new in patches:
        if rel is None:  # an environment variable, set by run_check
            continue
        path = os.path.join(copy, rel)
        if old is None:
            shutil.copy(os.path.join(ROOT, new), path)
            continue
        text = open(path).read()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: a text to replace is not in {rel} exactly once")
        open(path, "w").write(text.replace(old, new))
    return copy


def run_check(copy: str, patches, *flags: str):
    if FIRST in patches:  # the first K8 takes 128 and 256 channels only
        flags += ("--first",)
    env = dict(os.environ, **{name: value for rel, name, value in patches
                              if rel is None and value is not None})
    flags += tuple(name for rel, name, value in patches if rel is None and value is None)
    proc = subprocess.run([sys.executable, "-c", CHECK, *flags], cwd=copy, capture_output=True,
                          text=True, timeout=900, env=env)
    lines = (proc.stdout + proc.stderr).strip().splitlines()
    caught = proc.returncode != 0 and any(ln.startswith("CAUGHT") for ln in lines)
    verdict = next((ln for ln in lines if ln.startswith(("CAUGHT", "NOT CAUGHT"))),
                   lines[-1] if lines else "(no output)")
    tail = next((ln.strip() for ln in lines if ln.startswith("  silu tail")), None)
    if tail:
        verdict += f" [{tail}]"
    times = next((ln[6:] for ln in lines if ln.startswith("TIMES ")), None)
    if times is None and "--time" in flags:
        verdict = " | ".join(lines[-5:])
    return caught, verdict, times


def variants(names) -> int:
    copies = {"base": prepare("base", [])}
    copies.update({name: prepare(name, VARIANTS[name]) for name in names})
    order = list(copies)
    ok = True
    for name in order + order[::-1]:
        flags = ("--time", "--no-check") if name in TIMED_ONLY else ("--time",)
        caught, verdict, times = run_check(copies[name], VARIANTS.get(name, []), *flags)
        if caught or times is None:
            print(f"variant {name}: FAILED: {verdict[:400]}", flush=True)
            ok = False
            continue
        print(f"variant {name}: {times}", flush=True)
    return 0 if ok else 1


def controls(names) -> int:
    ok = True
    for name in names:
        caught, verdict, _ = run_check(prepare(name, CONTROLS[name]), CONTROLS[name])
        print(f"control {name}: {'caught' if caught else 'NOT caught'}: {verdict[:800]}", flush=True)
        ok &= caught
    return 0 if ok else 1


def time_tree(tree: str) -> int:
    tree = os.path.abspath(tree)
    proc = subprocess.run([sys.executable, "-c", TIME, tree, os.path.join(ROOT, "chip_smoke.py")],
                          cwd=tree, timeout=900)
    return proc.returncode


def chosen(table: dict, names) -> list:
    unknown = sorted(set(names) - set(table))
    if unknown:
        raise SystemExit(f"unknown names {unknown}; choose from {', '.join(table)}")
    return list(names) or list(table)


if __name__ == "__main__":
    if len(sys.argv) >= 2 and sys.argv[1] == "controls":
        sys.exit(controls(chosen(CONTROLS, sys.argv[2:])))
    if len(sys.argv) >= 2 and sys.argv[1] == "variants":
        sys.exit(variants(chosen(VARIANTS, sys.argv[2:])))
    if len(sys.argv) == 3 and sys.argv[1] == "time":
        sys.exit(time_tree(sys.argv[2]))
    raise SystemExit(__doc__)
