"""The program's own spans in the traced run: the `lcasr.*` ranges that
lcasr_torch opens while a profiler records (lcasr_torch/utils/profiling.py),
reduced from the same raw kineto events as trace.py's reduction.

  * device_s: each kernel's seconds in the window, credited once, to the
    innermost `lcasr.*` range open on its launching thread when it was
    launched (found by the launch's correlation id, as trace.py does), or
    to "(none)" outside every range; they sum to the kernels' summed
    durations (`kernel_s`);
  * idle_s: the window's idle stretches (the window less the union of the
    kernels' intervals) cut by the innermost range open on the thread that
    opened the window; they sum to `window_s - busy_s`;
  * host_s, calls: the summed wall length of each span's ranges (what is
    nested in them included) and their number, on every thread;
  * syncs: the blocking runtime calls (`BLOCKING`) in the window, by the
    innermost range open on the calling thread (or "(none)").

`readings` turns the reduction into the per-layer numbers it was built for;
`python3 -m lcbench.harness.program_spans --workload <cell> --seed <n>
--seconds <s>` makes one traced run of a cell, as `run.py --trace 1` does,
and prints its result line, then the reduction, the readings and the
harness's own spans (`lcbench.*`) beside them.
"""
from __future__ import annotations

import contextlib
import json
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from lcbench.harness.trace import SPAN_PREFIX, WINDOW, _is_device, idle_gaps, union_length

PROGRAM_PREFIX = "lcasr."
NONE = "(none)"
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
            "cudaMemcpy")
MAKE_CHUNKS = ("train.make_chunks", "train.chunk_audio", "train.chunk_text", "train.tokenize",
               "train.assemble")

Range = Tuple[float, float, str]  # (start, end, span) in seconds


def _innermost_segments(ranges: List[Range], lo: float, hi: float) -> List[Range]:
    """[lo, hi) cut into stretches, each named by the innermost of `ranges`
    (one thread's: they nest) open over it, or NONE."""
    out: List[Range] = []
    cur, stack = lo, []  # stack: (end, name), innermost last

    def emit(end, name):
        nonlocal cur
        end = min(max(end, cur), hi)
        if end > cur:
            out.append((cur, end, name))
        cur = max(cur, end)

    for s, e, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= s:
            end, top = stack.pop()
            emit(end, top)
        emit(s, stack[-1][1] if stack else NONE)
        stack.append((min(e, stack[-1][0]) if stack else e, name))
    while stack:
        end, top = stack.pop()
        emit(end, top)
    emit(hi, NONE)
    return out


def _innermost_at(ranges: List[Range], times: List[Tuple[float, object]]):
    """(key, innermost range open at t or NONE) for each (t, key), one thread's."""
    rs, k, open_ = sorted(ranges), 0, []
    for t, key in sorted(times, key=lambda tk: tk[0]):
        while k < len(rs) and rs[k][0] <= t:
            open_.append(rs[k])
            k += 1
        open_ = [r for r in open_ if r[1] >= t]
        yield key, max(open_, key=lambda r: (r[0], -r[1]))[2] if open_ else NONE


def ranges_of(events, prefix: str) -> Tuple[Dict[int, List[Range]], Tuple[float, float, int]]:
    """({thread: [(start, end, span)]} of the host ranges named `prefix` +
    span, the window's (start, end, thread))."""
    ranges, window = defaultdict(list), None
    for ev in events:
        if _is_device(ev):
            continue
        name = ev.name()
        start = ev.start_ns() / 1e9
        end = start + ev.duration_ns() / 1e9
        if name == SPAN_PREFIX + WINDOW:
            window = (start, end, ev.start_thread_id())
        elif name.startswith(prefix):
            ranges[ev.start_thread_id()].append((start, end, name[len(prefix):]))
    if window is None:
        raise RuntimeError("the trace holds no window range")
    return ranges, window


def reduce_program(events) -> dict:
    """Raw kineto events -> {'device_s', 'idle_s', 'host_s', 'calls',
    'syncs', 'kernel_s', 'busy_s', 'window_s'} of the program's spans over
    the window."""
    events = list(events)
    ranges, (lo, hi, window_tid) = ranges_of(events, PROGRAM_PREFIX)
    kernels, runtime = [], []  # kernels: (start, end, correlation id)
    for ev in events:
        name = ev.name()
        if _is_device(ev):
            if (name.startswith((SPAN_PREFIX, PROGRAM_PREFIX))
                    or getattr(ev, "is_user_annotation", lambda: False)()):
                continue  # the device-side copy of a host range
            start = ev.start_ns() / 1e9
            end = start + ev.duration_ns() / 1e9
            if end > lo and start < hi:
                kernels.append((max(start, lo), min(end, hi), ev.correlation_id()))
        elif name.startswith("cu"):  # the CUDA runtime's and the cu* API's calls
            runtime.append((ev.start_thread_id(), ev.start_ns() / 1e9, ev.correlation_id(),
                            name))

    seconds = defaultdict(float)
    for s, e, corr in kernels:
        seconds[corr] += e - s
    device_s, syncs = defaultdict(float), defaultdict(int)
    launches, calls_in = defaultdict(list), defaultdict(list)
    for tid, t, corr, name in runtime:
        if corr in seconds:
            launches[tid].append((t, corr))
        if name in BLOCKING and lo <= t < hi:
            calls_in[tid].append((t, name))
    credited = set()
    for tid, items in launches.items():
        for corr, span in _innermost_at(ranges.get(tid, []), items):
            if corr not in credited:
                credited.add(corr)
                device_s[span] += seconds[corr]
    for corr, s in seconds.items():
        if corr not in credited:  # launched outside the trace or the window
            device_s[NONE] += s
    for tid, items in calls_in.items():
        for _, span in _innermost_at(ranges.get(tid, []), items):
            syncs[span] += 1

    intervals = [(s, e) for s, e, _ in kernels]
    busy = union_length(intervals)
    idle_s = defaultdict(float)
    gaps = idle_gaps(intervals, lo, hi)
    segments = _innermost_segments(ranges.get(window_tid, []), lo, hi)
    g = 0
    for s, e, span in segments:  # both sorted and disjoint: one sweep
        while g < len(gaps) and gaps[g][1] <= s:
            g += 1
        j = g
        while j < len(gaps) and gaps[j][0] < e:
            idle_s[span] += min(e, gaps[j][1]) - max(s, gaps[j][0])
            j += 1

    host_s, calls = defaultdict(float), defaultdict(int)
    for rs in ranges.values():
        for s, e, span in rs:
            if e > lo and s < hi:
                host_s[span] += min(e, hi) - max(s, lo)
                calls[span] += 1
    return {"device_s": dict(device_s), "idle_s": dict(idle_s), "host_s": dict(host_s),
            "calls": dict(calls), "syncs": dict(syncs), "kernel_s": sum(seconds.values()),
            "busy_s": busy, "window_s": hi - lo}


def readings(program: dict, kind: str) -> Dict[str, float]:
    """The per-layer numbers the spans were built for, in a cell of `kind`
    ("decode" or "train"); a number whose spans ran nothing is left out."""
    dev, busy, out = program["device_s"], program["busy_s"], {}
    if kind == "decode" and busy > 0:
        out["decode.average_share"] = 100.0 * dev.get("decode.average", 0.0) / busy
        out["decode.norm_share"] = 100.0 * dev.get("norm", 0.0) / busy
    if kind == "train" and busy > 0:
        out["train.ctc_share"] = 100.0 * (dev.get("ctc_fwd", 0.0) + dev.get("ctc_bwd", 0.0)) / busy
        out["idle_share.train.make_chunks"] = 100.0 * sum(
            program["idle_s"].get(s, 0.0) for s in MAKE_CHUNKS) / program["window_s"]
        steps = program["calls"].get("train.optimizer_step", 0)
        if steps:
            inside = sum(n for span, n in program["syncs"].items() if span != NONE)
            out["train.syncs_per_step"] = inside / steps
    return out


def top(program: dict, n: int = 10) -> Dict[str, list]:
    """The `n` spans with most device, idle and host seconds, and syncs."""
    return {key: sorted(([k, v] for k, v in program[key].items()), key=lambda kv: -kv[1])[:n]
            for key in ("device_s", "idle_s", "host_s", "syncs")}


@contextlib.contextmanager
def kept(found: dict):
    """While open, every traced run's reduction (trace.reduce_events, which
    Context.end_window calls) also puts this module's reduction of the same
    events into `found` under 'program', and the harness's own spans'
    device and host seconds under 'harness_device_s' / 'harness_host_s'."""
    from lcbench.harness import trace

    reduce_events = trace.reduce_events

    def reduce_both(events):
        events = list(events)
        summary = reduce_events(events)
        found["program"] = reduce_program(events)
        harness, _ = ranges_of(events, SPAN_PREFIX)
        host = defaultdict(float)
        for rs in harness.values():
            for s, e, span in rs:
                host[span] += e - s
        found["harness_device_s"], found["harness_host_s"] = summary["spans"], dict(host)
        return summary

    trace.reduce_events = reduce_both
    try:
        yield found
    finally:
        trace.reduce_events = reduce_events


def main(argv: Optional[list] = None) -> int:
    import argparse

    from lcbench.harness import registry, runner

    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description="One traced run of a cell, with the reduction "
                                             "of the program's own spans.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    args.trace, args.control, args.fault = 1, False, None
    runner.cache_dirs()
    with kept({}) as found:
        code, result = runner.run(args, t_start)
    if result is not None:
        print(json.dumps(result), flush=True)
    if "program" in found:
        traffic = registry.traffic(registry.workload(args.workload)["traffic"])
        kind = registry.driver(traffic["driver"]).KIND
        print(json.dumps(dict(found, readings=readings(found["program"], kind),
                              top=top(found["program"]))), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
