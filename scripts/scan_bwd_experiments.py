#!/usr/bin/env python3
"""Experiments on the selective-scan backward K7, each in a copy of the port;
the repo's own files are never modified.

    python3 scripts/scan_bwd_experiments.py controls     # on a machine with an H100
    python3 scripts/scan_bwd_experiments.py variants
    python3 scripts/scan_bwd_experiments.py time <tree>  # K7 of another checkout

  controls  copy `lcasr_torch/` and `chip_smoke.py` into
            `build/scan_experiments/<name>/`, plant one fault in the copy's
            `csrc/selective_scan.cu`, and run the scan checks of
            `chip_smoke.py` there (`ssm_case` on every case of `ssm_cases`:
            K6 and K7 against their plain versions, K7 the same bits in two
            runs).  A control passes when the checks fail.  Exit 0 only if
            every fault was caught.
  variants  alternative designs in such copies; each must pass the same
            checks, then K7's device time per call at the training shape
            (8, 2048, 768, 16), kernel by kernel (profiler), is taken in
            turns with the repo's source (base, variants, variants in
            reverse, base), with ptxas's registers and spills.  Exit 0 only
            if every variant passed the checks.
  time      K7 of the `lcasr_torch` in <tree> (for example an unpacked
            `git archive` of an earlier commit) at the decode, training and
            120,000-frame shapes of `chip_smoke.py`: the device time of its
            kernels (every kernel whose name contains "selective_scan_bwd"),
            the device time of every kernel of one wrapper call (the sums
            of the partials included), and one wrapper call by CUDA events;
            with the card's name and power limit.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join("lcasr_torch", "csrc", "selective_scan.cu")

# planted faults: name -> [(text in the source, its replacement)]
CONTROLS = {
    # pass 2 hands every chunk a zero carry: the chunks after it are lost
    "carry_dropped": [("        col[c * cstride] = v;\n", "        col[c * cstride] = 0.f;\n")],
    # pass 2 takes the gain of a chunk at half its sum of delta
    "wrong_gain": [("v = o[k] + ex2(A2 * s[k]) * v;", "v = o[k] + ex2(0.5f * A2 * s[k]) * v;")],
    # the sums over channels keep the first 8 of the 16 warps of a pass
    "half_the_warps": [("for (int wi = 0; wi < BWD_WARPS; ++wi)",
                        "for (int wi = 0; wi < BWD_WARPS / 2; ++wi)")],
}

# design alternatives: name -> [(text in the source, its replacement)]
VARIANTS = {
    # no minimum of two blocks an SM for the chunk pass: its registers are
    # then not held to 64 (no spill), and one block of 512 threads runs on an SM
    "chunk_one_block": [("__global__ void __launch_bounds__(BWD_THREADS, 2)\nselective_scan_bwd_chunk(",
                         "__global__ void __launch_bounds__(BWD_THREADS)\nselective_scan_bwd_chunk(")],
    # 64 channels a block: twice the blocks, half the passes in each
    "group_64": [("constexpr int BWD_GROUP = 128;", "constexpr int BWD_GROUP = 64;")],
}

CHECK = """
import sys
import torch
import chip_smoke as cs
from lcasr_torch import kernels

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
    Bt, L, D, N = cs.SSM_TRAIN_SHAPE
    x, delta, A, Bm, Cm, g = cs.ssm_inputs(torch, gen, Bt, L, D, N, torch.float32,
                                           torch.bfloat16, True, False)
    _, states = ssm.selective_scan_fwd(x, delta, A, Bm, Cm, return_states=True)
    bwd = lambda: ssm.selective_scan_bwd(x, delta, A, Bm, Cm, states, g)
    totals = cs.device_kernel_totals(torch, bwd, 5)
    per = {}
    for key, (us, _) in totals.items():
        for part in ("local", "carry", "chunk", "reduce_bc", "reduce_da"):
            if "selective_scan_bwd_" + part in key:
                per[part] = per.get(part, 0.0) + us / 5 / 1e3
    regs = {fn.split("selective_scan_bwd_")[1][:12]: e for fn, e in entries.items()
            if "selective_scan_bwd_" in fn}
    print("TIMES " + json.dumps({"ms": sum(per.values()), "kernels": per, "ptxas": regs}))
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
gen = torch.Generator(device="cuda").manual_seed(2)
for label, shape in (("decode", cs.SSM_DECODE_SHAPE), ("train", cs.SSM_TRAIN_SHAPE),
                     ("long", cs.SSM_LONG_SHAPE)):
    Bt, L, D, N = shape
    x, delta, A, Bm, Cm, g = cs.ssm_inputs(torch, gen, Bt, L, D, N, torch.float32,
                                           torch.bfloat16, True, False)
    _, states = ssm.selective_scan_fwd(x, delta, A, Bm, Cm, return_states=True)
    bwd = lambda: ssm.selective_scan_bwd(x, delta, A, Bm, Cm, states, g)
    k7 = cs.kernel_group_ms(torch, bwd, "selective_scan_bwd")
    every = cs.kernel_group_ms(torch, bwd, "")
    wrapper = cs.time_ms(torch, bwd, n=10)
    bound = cs.ssm_bound(torch, "bwd", shape, 4, 2, True)
    print(f"{label} {shape}: K7 kernels {k7:.4f} ms of device time, every kernel of the call "
          f"{every:.4f} ms, wrapper call {wrapper:.4f} ms; bound {bound[0]:.4f} ms by {bound[1]}",
          flush=True)
    del x, delta, A, Bm, Cm, g, states
"""


def prepare(name: str, patches) -> str:
    copy = os.path.join(ROOT, "build", "scan_experiments", name)
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
    times = next((ln[6:] for ln in lines if ln.startswith("TIMES ")), None)
    return caught, verdict, times


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
    if len(sys.argv) == 2 and sys.argv[1] in ("controls", "variants"):
        sys.exit(controls() if sys.argv[1] == "controls" else variants())
    if len(sys.argv) == 3 and sys.argv[1] == "time":
        sys.exit(time_tree(sys.argv[2]))
    raise SystemExit(__doc__)
