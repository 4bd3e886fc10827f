#!/usr/bin/env python3
"""Experiments on the selective-scan forward K6, each in a copy of the port;
the repo's own files are never modified.

    python3 scripts/scan_fwd_experiments.py controls     # on a machine with an H100
    python3 scripts/scan_fwd_experiments.py variants
    python3 scripts/scan_fwd_experiments.py time <tree>  # K6 of another checkout

  controls  copy `lcasr_torch/` and `chip_smoke.py` into
            `build/scan_fwd_experiments/<name>/`, plant one fault in the
            copy's split of the time axis, and run the scan checks of
            `chip_smoke.py` there (`ssm_case` on every case of `ssm_cases`:
            K6 and K7 against their plain versions, y the same bits with and
            without the states and in two runs).  A control passes when the
            checks fail.  Exit 0 only if every fault was caught.
  variants  alternative designs in such copies, `first_kernel` among them:
            the first K6 (one thread per (row, channel) walking the whole
            sequence, 128 channels a block), kept here and out of the
            package.  Each must pass the same checks; then K6's device time
            per call (profiler: every kernel whose name contains
            "selective_scan_fwd"), with and without the states, at the
            decode, training and 120,000-frame shapes of `chip_smoke.py` is
            taken in turns with the repo's source (base, variants, variants
            in reverse, base), with ptxas's registers and spills.  Exit 0
            only if every variant passed the checks.
  time      K6 of the `lcasr_torch` in <tree> (for example an unpacked
            `git archive` of an earlier commit) at the same shapes: device
            time, and one wrapper call by CUDA events; with the card's name
            and power limit.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join("lcasr_torch", "csrc", "selective_scan.cu")
OPS = os.path.join("lcasr_torch", "ops", "ssm.py")

# planted faults: name -> [(file, text in it, its replacement)]
CONTROLS = {
    # the fold forgets the segments before the last: each entry is the exit
    # of the segment before it from a zero entry
    "carry_dropped": [(SOURCE, "h[k] = ep[(long long)k * p.D] + ex2(A2[k] * g) * h[k];",
                       "h[k] = ep[(long long)k * p.D];")],
    # the gain of a segment at half its sum of delta
    "half_gain": [(SOURCE, "h[k] = ep[(long long)k * p.D] + ex2(A2[k] * g) * h[k];",
                   "h[k] = ep[(long long)k * p.D] + ex2(A2[k] * 0.5f * g) * h[k];")],
    # every segment's body starts from a zero entry
    "zero_entry": [(SOURCE, "for (int i = 0; i < seg; ++i) {", "for (int i = 0; i < 0; ++i) {")],
}

# the first K6: `launch_first` and its kernel, added to the source
FIRST_KERNEL = r"""// 16 consecutive fp32 values from shared memory, as four 16-byte reads.
__device__ __forceinline__ void lds16(const float* row, float (&out)[16]) {
  const float4* v = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 q = v[i];
    out[4 * i] = q.x, out[4 * i + 1] = q.y, out[4 * i + 2] = q.z, out[4 * i + 3] = q.w;
  }
}

constexpr int FIRST_THREADS = 128;  // channels per forward block

// ---------------------------------------------------------------------------
// K6: forward.  grid (ceil(D / 128), Bt), 128 threads.
// ---------------------------------------------------------------------------
template <typename BT, bool STATES>
__global__ void __launch_bounds__(FIRST_THREADS)
selective_scan_fwd_kernel(ScanParams p, float* __restrict__ y,
                          float* __restrict__ states) {
  __shared__ float xs[TC][FIRST_THREADS];
  __shared__ float ds[TC][FIRST_THREADS];
  __shared__ __align__(16) float Bs[TC][N];
  __shared__ __align__(16) float Cs[TC][N];
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int d = blockIdx.x * FIRST_THREADS + tid;
  const bool live = d < p.D;

  float A2[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    A2[n] = live ? p.A[(long long)d * N + n] * LOG2E : 0.f;
    h[n] = 0.f;
  }
  const float* xp = p.x + (long long)b * p.sx_b + d;
  const float* dp = p.delta + (long long)b * p.sd_b + d;
  float* yp = y + (long long)b * p.L * p.D + d;

  for (int c = 0; c < p.n_chunks; ++c) {
    const int t0 = c * TC;
    const int len = min(TC, p.L - t0);
    __syncthreads();  // the chunk before has been read
    stage_bc<BT, FIRST_THREADS>(p, b, t0, len, Bs, Cs);
    {
      // the chunk's x and delta of this channel: all loads, then all stores
      float xr[TC], dr[TC];
#pragma unroll
      for (int t = 0; t < TC; ++t) {
        const bool ok = live && t < len;
        xr[t] = ok ? xp[(long long)(t0 + t) * p.sx_l] : 0.f;
        dr[t] = ok ? dp[(long long)(t0 + t) * p.sd_l] : 0.f;
      }
#pragma unroll
      for (int t = 0; t < TC; ++t) {
        xs[t][tid] = xr[t];
        ds[t][tid] = dr[t];
      }
    }
    if (STATES && live) {
      float* sp = states + ((long long)b * p.n_chunks + c) * N * p.D + d;
#pragma unroll
      for (int n = 0; n < N; ++n) sp[(long long)n * p.D] = h[n];
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int t = 0; t < len; ++t) {
        const float dt = ds[t][tid];
        const float dtx = dt * xs[t][tid];
        float Bt[N], Ct[N];
        lds16(Bs[t], Bt);
        lds16(Cs[t], Ct);
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = ex2(dt * A2[n]) * h[n] + dtx * Bt[n];
          acc += h[n] * Ct[n];
        }
        yp[(long long)(t0 + t) * p.D] = acc;
      }
    }
  }
}

template <typename BT>
cudaError_t launch_first(const ScanParams& p, int Bt, float* y, float* states,
                       cudaStream_t stream) {
  const dim3 grid((p.D + FIRST_THREADS - 1) / FIRST_THREADS, Bt);
  if (states != nullptr)
    selective_scan_fwd_kernel<BT, true><<<grid, FIRST_THREADS, 0, stream>>>(p, y, states);
  else
    selective_scan_fwd_kernel<BT, false><<<grid, FIRST_THREADS, 0, stream>>>(p, y, nullptr);
  return cudaGetLastError();
}

"""

# design alternatives: name -> [(file, text in it, its replacement)]
VARIANTS = {
    "first_kernel": [
        (SOURCE, "template <typename BT>\ncudaError_t launch_fwd(",
         FIRST_KERNEL + "template <typename BT>\ncudaError_t launch_fwd("),
        (SOURCE, "  if (w.segments > 1) {\n    auto local",
         "  return launch_first<BT>(p, Bt, w.y, w.states, stream);\n"
         "  if (w.segments > 1) {\n    auto local"),
    ],
    # two steps of a chunk unrolled, not four
    "unroll_2": [(SOURCE, "#pragma unroll 4\n    for (int t = 0; t < TC; ++t) {",
                  "#pragma unroll 2\n    for (int t = 0; t < TC; ++t) {")],
    # where the time axis is split, two or four blocks an SM a launch, not eight
    "split_2_blocks": [(OPS, "FWD_SPLIT_BLOCKS = 8 * 132", "FWD_SPLIT_BLOCKS = 2 * 132")],
    "split_4_blocks": [(OPS, "FWD_SPLIT_BLOCKS = 8 * 132", "FWD_SPLIT_BLOCKS = 4 * 132")],
}

SHAPES = """
SHAPES = (("decode", cs.SSM_DECODE_SHAPE), ("train", cs.SSM_TRAIN_SHAPE),
          ("long", cs.SSM_LONG_SHAPE))
"""

CHECK = """
import sys
import torch
import chip_smoke as cs
from lcasr_torch import kernels

""" + SHAPES + """
kernels.build()
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(2)
for case in cs.ssm_cases(torch):
    try:
        cs.ssm_case(torch, case, gen)
    except AssertionError as e:
        print("CAUGHT", e)
        sys.exit(1)
print("NOT CAUGHT")
if "--time" in sys.argv:
    import json
    from lcasr_torch.ops import ssm

    entries = cs.ptxas_entries(kernels.build_log["selective_scan.cu"])
    times = {}
    for label, (Bt, L, D, N) in SHAPES:
        x, delta, A, Bm, Cm, _ = cs.ssm_inputs(torch, gen, Bt, L, D, N, torch.float32,
                                               torch.bfloat16, True, False)
        for states in (False, True):
            fwd = lambda: ssm.selective_scan_fwd(x, delta, A, Bm, Cm, return_states=states)
            times[label + ("_states" if states else "")] = cs.kernel_group_ms(
                torch, fwd, "selective_scan_fwd", n=10)
    regs = {fn: e for fn, e in entries.items() if "selective_scan_fwd" in fn}
    print("TIMES " + json.dumps({"ms": times, "ptxas": regs}))
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
from lcasr_torch.ops import ssm

assert ssm.__file__.startswith(sys.argv[1]), ssm.__file__
kernels.build()
print("card:", cs.gpu_line())
for fn, e in cs.ptxas_entries(kernels.build_log["selective_scan.cu"]).items():
    if "selective_scan_fwd" in fn:
        print("ptxas:", fn.split("selective_scan_")[1][:40], e)
gen = torch.Generator(device="cuda").manual_seed(2)
""" + SHAPES + """
for label, shape in SHAPES:
    Bt, L, D, N = shape
    x, delta, A, Bm, Cm, _ = cs.ssm_inputs(torch, gen, Bt, L, D, N, torch.float32,
                                           torch.bfloat16, True, False)
    for states in (False, True):
        fwd = lambda: ssm.selective_scan_fwd(x, delta, A, Bm, Cm, return_states=states)
        k6 = cs.kernel_group_ms(torch, fwd, "selective_scan_fwd", n=10)
        wrapper = cs.time_ms(torch, fwd, n=20)
        bound = cs.ssm_bound(torch, "fwd", shape, 4, 2, states)
        print(f"{label} {shape} states {states}: K6 {k6:.4f} ms of device time, wrapper call "
              f"{wrapper:.4f} ms; bound {bound[0]:.4f} ms by {bound[1]}", flush=True)
    del x, delta, A, Bm, Cm
"""


def prepare(name: str, patches) -> str:
    copy = os.path.join(ROOT, "build", "scan_fwd_experiments", name)
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "lcasr_torch"), os.path.join(copy, "lcasr_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), copy)
    for rel, old, new in patches:
        path = os.path.join(copy, rel)
        text = open(path).read()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: a text to replace is not in {rel} exactly once")
        open(path, "w").write(text.replace(old, new))
    return copy


def run_check(copy: str, *flags: str):
    proc = subprocess.run([sys.executable, "-c", CHECK, *flags], cwd=copy, capture_output=True,
                          text=True, timeout=900)
    lines = (proc.stdout + proc.stderr).strip().splitlines()
    caught = proc.returncode != 0 and any(ln.startswith("CAUGHT") for ln in lines)
    verdict = next((ln for ln in lines if ln.startswith(("CAUGHT", "NOT CAUGHT"))),
                   lines[-1] if lines else "(no output)")
    times = next((ln[6:] for ln in lines if ln.startswith("TIMES ")), None)
    return caught, verdict, times


def variants(names) -> int:
    copies = {"base": prepare("base", [])}
    copies.update({name: prepare(name, VARIANTS[name]) for name in names})
    order = list(copies)
    ok = True
    for name in order + order[::-1]:
        caught, verdict, times = run_check(copies[name], "--time")
        if caught or times is None:
            print(f"variant {name}: FAILED the checks: {verdict[:400]}", flush=True)
            ok = False
            continue
        print(f"variant {name}: {times}", flush=True)
    return 0 if ok else 1


def controls() -> int:
    ok = True
    for name, patches in CONTROLS.items():
        caught, verdict, _ = run_check(prepare(name, patches))
        print(f"control {name}: {'caught' if caught else 'NOT caught'}: {verdict[:400]}", flush=True)
        ok &= caught
    return 0 if ok else 1


def time_tree(tree: str) -> int:
    tree = os.path.abspath(tree)
    proc = subprocess.run([sys.executable, "-c", TIME, tree, os.path.join(ROOT, "chip_smoke.py")],
                          cwd=tree, timeout=900)
    return proc.returncode


if __name__ == "__main__":
    if len(sys.argv) == 2 and sys.argv[1] == "controls":
        sys.exit(controls())
    if len(sys.argv) >= 2 and sys.argv[1] == "variants":
        names = sys.argv[2:] or list(VARIANTS)
        unknown = sorted(set(names) - set(VARIANTS))
        if unknown:
            raise SystemExit(f"unknown variants {unknown}; choose from {', '.join(VARIANTS)}")
        sys.exit(variants(names))
    if len(sys.argv) == 3 and sys.argv[1] == "time":
        sys.exit(time_tree(sys.argv[2]))
    raise SystemExit(__doc__)
