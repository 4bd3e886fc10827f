"""One run of one cell: the card's checks, the window's edges, the traced
run's reduction, the per-layer metrics, the forbidden-module check and the
result line.

A driver (`drivers/<name>.py`) gets a `Context`, builds the program and
the traffic (set-up), calls `begin_window()`, drives the path until
`seconds` have passed, calls `end_window()`, frees the program, judges the
outputs it kept against the reference, and returns an `Outcome`.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from lcbench.harness import registry
from lcbench.harness.spans import CallLog

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "lcasr_tpu")  # compared by top-level name
CHECKOUT = os.path.dirname(registry.ROOT)


def cache_dirs() -> None:
    """Compile caches at fixed directories inside the checkout, so that only
    a checkout's first run of a cell compiles (the port's own kernels build
    into build/lcasr_torch_kernels/ beside its package)."""
    build = os.path.join(CHECKOUT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(build, "inductor_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Outcome:
    attempted: int
    failed: int
    e2e: Dict[str, Tuple[float, str]]        # name -> (value, unit)
    view: dict                               # what the per-layer readers read
    checks: List[Tuple[str, float, float]]   # (name, value, limit): value <= limit passes


@dataclass
class Context:
    seed: int
    seconds: float
    trace: bool
    device: object
    chips: int
    workload: dict
    config: dict
    traffic: dict
    t_start: float
    control: bool = False
    calls: CallLog = field(default_factory=CallLog)
    setup_s: Optional[float] = None
    t0: Optional[float] = None
    memory_peak_bytes: int = 0
    trace_summary: Optional[dict] = None
    _profiler: object = None
    _window_range: object = None
    _spans: object = None

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def begin_window(self) -> None:
        """Set-up ends here: every shape was warmed up and the card is idle."""
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        if self.trace:
            from lcbench.harness import spans
            from lcbench.harness.trace import SPAN_PREFIX, WINDOW, Profiler

            self._spans = spans.installed(self.calls)
            self._spans.__enter__()
            self._profiler = Profiler()
            self._profiler.start()
            self._window_range = torch.profiler.record_function(SPAN_PREFIX + WINDOW)
            self._window_range.__enter__()
        self.calls.active = True
        self.t0 = time.perf_counter()
        self.setup_s = self.t0 - self.t_start

    def end_window(self) -> float:
        """The window's wall seconds, once the card has finished its work."""
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize()
        seconds = self.elapsed()
        self.calls.active = False
        if self.device.type == "cuda":
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
        if self.trace:
            from lcbench.harness.trace import reduce_events

            self._window_range.__exit__(None, None, None)
            self._profiler.stop()
            self._spans.__exit__(None, None, None)
            self.trace_summary = reduce_events(self._profiler.raw_events())
            self._profiler = None
        return seconds


def card_facts() -> dict:
    """The card's name, SM count, highest SM clock and power limit."""
    import torch

    facts = {"kind": torch.cuda.get_device_name(0),
             "sms": torch.cuda.get_device_properties(0).multi_processor_count}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm,power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        clock, power = (float(v) for v in out.strip().splitlines()[0].split(","))
        facts["clock_hz"], facts["power_limit_w"] = clock * 1e6, power
    except (OSError, subprocess.SubprocessError, ValueError):
        facts["clock_hz"], facts["power_limit_w"] = None, None
    return facts


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def per_layer(outcome: Outcome, ctx: Context, facts: dict) -> Dict[str, dict]:
    view = dict(outcome.view, trace=ctx.trace_summary, calls=ctx.calls.calls,
                sms=facts["sms"], clock_hz=facts["clock_hz"])
    out = {}
    for name, mod in registry.metrics().items():
        value = mod.read(view)
        if value is not None:
            if not math.isfinite(value):
                raise ValueError(f"per-layer metric {name} read {value}")
            out[name] = {"value": value, "unit": mod.UNIT}
    return out


def run(args, t_start: float) -> Tuple[int, Optional[dict]]:
    """(exit code, result) of one run of the cell `args.workload`, on the card."""
    import torch

    spec = registry.workload(args.workload)
    chips = int(spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"this cell needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2, None
    return run_cell(dict(spec, name=args.workload), registry.config(spec["config"]),
                    registry.traffic(spec["traffic"]), int(args.seed), float(args.seconds),
                    bool(int(args.trace)), torch.device("cuda", 0), t_start, args.control,
                    args.fault)


def run_cell(spec: dict, config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
             device, t_start: float, control: bool = False, fault: Optional[str] = None
             ) -> Tuple[int, Optional[dict]]:
    """(exit code, result) of one run of a cell given whole; the tests call
    it on the CPU at small sizes, past the card's checks.  `control` and
    `fault` (faults.py) read the comparisons' upper ends; no benchmark run
    sets either."""
    from lcbench.harness import faults

    chips = int(spec["chips"])
    ctx = Context(seed=seed, seconds=seconds, trace=trace, device=device, chips=chips,
                  workload=spec, config=config, traffic=traffic, t_start=t_start,
                  control=control)
    driver = registry.driver(ctx.traffic["driver"])
    with faults.planted(fault):
        outcome = driver.run(ctx)
    found = forbidden_modules()
    if found:
        log(f"modules that no run may load are loaded: {found}")
        return 3, None
    facts = card_facts() if device.type == "cuda" else {
        "kind": "cpu", "sms": 1, "clock_hz": None, "power_limit_w": None}
    correct = bool(outcome.checks) and all(v <= lim for _, v, lim in outcome.checks)
    if ctx.trace:
        metrics = per_layer(outcome, ctx, facts)
    else:
        metrics = {k: {"value": v, "unit": u} for k, (v, u) in outcome.e2e.items()}
        metrics["setup_s"] = {"value": ctx.setup_s, "unit": "s"}
    result = {
        "correct": bool(correct),
        "attempted": int(outcome.attempted),
        "failed": int(outcome.failed),
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": facts["kind"], "count": chips,
                   "memory_peak_bytes": ctx.memory_peak_bytes,
                   "power_limit_w": facts["power_limit_w"]},
    }
    if ctx.trace:
        summary = ctx.trace_summary
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = summary["breakdown"]
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in outcome.checks}
    for name, v, lim in outcome.checks:
        log(f"check {name}: {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}")
    return 0, result


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one benchmark cell of lcasr_torch once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="run the cell's control (the lower precision) in the program's "
                         "place; never part of a benchmark run")
    ap.add_argument("--fault", default=None,
                    help="plant a fault under the timed path (harness/faults.py); never part "
                         "of a benchmark run")
    args = ap.parse_args(argv)
    code, result = run(args, t_start)
    if result is not None:
        print(json.dumps(result), flush=True)
    return code
