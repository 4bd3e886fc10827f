"""The selective scan forward's share of its roofline in the decode: the
bound of the calls' work (one exp and 6 flops per (t, d, n) at the fp32 and
special-function rates, or the bytes read and written) over the device
time of the kernels launched inside the calls to the op, in %."""
from lcbench.harness import bounds, shares

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "scan kernels", "decode_rtfx"


def read(view):
    calls = view["calls"].get("scan_fwd")
    if view.get("kind") != "decode" or not calls or not view.get("clock_hz"):
        return None
    bound = sum(bounds.ssm_bound("fwd", c["shape"], c["x_bytes"], c["bc_bytes"], c["states"],
                                 view["sms"], view["clock_hz"])[0] for c in calls)
    return shares.share(bound, view["trace"]["spans"].get("scan_fwd", 0.0))
