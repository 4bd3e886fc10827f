"""The traced run: `torch.profiler` over the window, and the reduction of its
raw events to what the per-layer metrics read.

  * kernels: every device activity of the trace (kernels, copies, sets),
    as (start, end, name) in seconds;
  * busy: the union of those intervals, so that work on a side stream that
    overlaps the main one counts once (a sum of kernel times counts it
    twice); idle is the window less the union;
  * spans: the device time of the kernels launched inside each of the
    harness's profiler ranges (`lcbench.<span>`, opened by `spans.py`),
    found by the launch's correlation id and the range that holds the
    launch on the launching thread, whatever the kernels are named;
  * breakdown: the device operations that took most time, and the longest
    idle gaps, each named by the innermost host operation running at the
    gap's middle.

The profiler's function-event tree is never built: the raw kineto events
are enough and take a fraction of the time on a window of 10^5 kernels.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "lcbench."
WINDOW = "window"
NAME_CHARS = 160  # of a kernel's name in the breakdown
_RUNTIME_LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                   "cudaLaunchCooperativeKernel", "cudaMemcpyAsync", "cudaMemsetAsync",
                   "cudaGraphLaunch", "cuLaunchKernelEx")


def union_length(intervals: List[Tuple[float, float]]) -> float:
    """Total length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals: List[Tuple[float, float]], lo: float, hi: float
              ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi) that no interval covers."""
    gaps, cur = [], lo
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(s, e) for s, e in gaps if e > s]


class Profiler:
    """Start and stop `torch.profiler` around the window (CPU and CUDA
    activities, no shapes or stacks: they cost time in the window)."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def start(self) -> None:
        self.prof.__enter__()

    def stop(self) -> None:
        self.prof.__exit__(None, None, None)

    def raw_events(self) -> list:
        results = self.prof.profiler.kineto_results
        return list(results.events())


def _is_device(ev) -> bool:
    return str(ev.device_type()).rsplit(".", 1)[-1] in ("CUDA", "PrivateUse1")


def window_of(events) -> Tuple[float, float]:
    """(start, end) in seconds of the `lcbench.window` range, which the
    harness opens when the window starts and closes after its last
    synchronise."""
    for ev in events:
        if ev.name() == SPAN_PREFIX + WINDOW and not _is_device(ev):
            start = ev.start_ns() / 1e9
            return start, start + ev.duration_ns() / 1e9
    raise RuntimeError("the trace holds no window range")


def reduce_events(events) -> dict:
    """Raw kineto events -> {'kernels', 'busy_s', 'window_s', 'spans',
    'span_calls', 'breakdown'} over the window's range."""
    lo, hi = window_of(events)
    kernels, host, launches = [], defaultdict(list), {}
    ranges = defaultdict(list)  # thread -> [(start, end, name)] of lcbench.* ranges
    for ev in events:
        name = ev.name()
        start = ev.start_ns() / 1e9
        end = start + ev.duration_ns() / 1e9
        if _is_device(ev):
            if name.startswith(SPAN_PREFIX) or getattr(ev, "is_user_annotation", lambda: False)():
                continue  # the device-side copy of a host range, no work of its own
            if end <= lo or start >= hi:
                continue
            kernels.append((max(start, lo), min(end, hi), name[:NAME_CHARS], ev.correlation_id()))
            continue
        tid = ev.start_thread_id()
        if name == SPAN_PREFIX + WINDOW:
            continue
        if name.startswith(SPAN_PREFIX):
            ranges[tid].append((start, end, name[len(SPAN_PREFIX):]))
            host[tid].append((start, end, name))
        elif name in _RUNTIME_LAUNCH or name.startswith(("cudaLaunch", "cuLaunch")):
            launches[ev.correlation_id()] = (tid, start)
        else:
            host[tid].append((start, end, name))
    intervals = [(s, e) for s, e, _, _ in kernels]
    busy = union_length(intervals)

    # kernel -> span by its launch: a sweep over each thread's launches in
    # time order, keeping the ranges open at that time (they nest, so the
    # open list stays as short as the nesting is deep)
    by_corr = {}
    for s, e, _, corr in kernels:
        by_corr.setdefault(corr, []).append(e - s)
    per_thread = defaultdict(list)
    for corr, (tid, t) in launches.items():
        if corr in by_corr:
            per_thread[tid].append((t, corr))
    spans: Dict[str, float] = defaultdict(float)
    sorted_ranges = {t: sorted(r) for t, r in ranges.items()}
    for tid, items in per_thread.items():
        rs, k, open_ = sorted_ranges.get(tid, []), 0, []
        for t, corr in sorted(items):
            while k < len(rs) and rs[k][0] <= t:
                open_.append(rs[k])
                k += 1
            open_ = [r for r in open_ if r[1] >= t]
            for rname in {r[2] for r in open_}:
                spans[rname] += sum(by_corr[corr])
    span_calls = {}
    for rs in sorted_ranges.values():
        for s, e, rname in rs:
            if lo <= s < hi:
                span_calls[rname] = span_calls.get(rname, 0) + 1

    # breakdown: device operations by total time; idle gaps by host operation
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, name, _ in kernels:
        by_name[name] += e - s
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle_gaps(intervals, lo, hi), key=lambda g: -(g[1] - g[0]))[:10]
    named = []
    all_host = sorted((s, e, n) for rs in host.values() for s, e, n in rs)
    host_starts = [h[0] for h in all_host]
    for gs, ge in gaps:
        mid = (gs + ge) / 2
        i = bisect.bisect_right(host_starts, mid)
        best: Optional[Tuple[float, float, str]] = None
        for j in range(i - 1, max(-1, i - 4000), -1):
            hs, he, hn = all_host[j]
            if hs <= mid <= he and (best is None or hs > best[0]):
                best = (hs, he, hn)
        named.append([best[2][:NAME_CHARS] if best else "(no host operation)", ge - gs])
    return {
        "kernels": kernels,
        "busy_s": busy,
        "window_s": hi - lo,
        "spans": dict(spans),
        "span_calls": span_calls,
        "breakdown": {"device_ops": [[n, t] for n, t in device_ops], "idle_gaps": named},
    }
