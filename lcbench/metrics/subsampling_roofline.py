"""The subsampling conv chain's share of its roofline in the decode: the
bound of the chain's work (its multiply-adds at the tensor cores' peak, one
exp per silu value, or its bytes) over the device time of the kernels
launched inside the calls to the chain (the cuDNN convolutions, or the
fused kernel under its flag), in %."""
from lcbench.harness import bounds, shares

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "subsampling", "decode_rtfx"


def read(view):
    calls = view["calls"].get("subsampling")
    if view.get("kind") != "decode" or not calls or not view.get("clock_hz"):
        return None
    bound = sum(bounds.sub_bound(c["B"], c["T"], c["F"], c["C"], c["elem_bytes"],
                                 "bf16" if c["elem_bytes"] == 2 else "fp32", view["sms"],
                                 view["clock_hz"], c["act"])[0] for c in calls)
    return shares.share(bound, view["trace"]["spans"].get("subsampling", 0.0))
