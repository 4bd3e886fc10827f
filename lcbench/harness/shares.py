"""What the per-layer metrics share: the bounds of the calls the traced
window made, summed by span."""
from __future__ import annotations

from lcbench.harness import bounds


def lengths_of(call):
    t = call.get("lengths")
    return None if t is None else t.detach().cpu().numpy()


def attention_ms(calls, backward: bool) -> float:
    fn = bounds.attention_bwd_bound if backward else bounds.attention_bound
    return sum(fn(c["B"], c["T"], c["H"], c["D"], lengths_of(c))[0] for c in calls)


def share(bound_ms: float, device_s: float):
    """100 x bound / device time, or None where nothing ran."""
    if device_s <= 0.0 or bound_ms <= 0.0:
        return None
    return 100.0 * bound_ms / 1e3 / device_s
