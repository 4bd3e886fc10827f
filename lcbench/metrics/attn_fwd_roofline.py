"""The attention forward's share of its roofline in the decode: the bound of
the calls' work (4 T^2 D a head over the pairs their lengths leave valid, at
the bf16 peak, or their bytes at the memory rate) over the device time of
the kernels launched inside the calls to the op, in %."""
from lcbench.harness import shares

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "attention kernels", "decode_rtfx"


def read(view):
    calls = view["calls"].get("attn_fwd")
    if view.get("kind") != "decode" or not calls:
        return None
    return shares.share(shares.attention_ms(calls, backward=False),
                        view["trace"]["spans"].get("attn_fwd", 0.0))
