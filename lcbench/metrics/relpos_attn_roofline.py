"""The relative-position attention op's share of its roofline in the decode:
the bound of the calls' work (6 T^2 D a head over the pairs their lengths
leave valid at the bf16 peak, or q, k, v, the position table and the output
at the memory rate; `harness/relpos_bounds.py`) over the device time of the
kernels launched inside the driver's `lcbench.relpos_attn` ranges, in %."""
from lcbench.harness import shares
from lcbench.harness.relpos_bounds import relpos_attention_bound

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "rel-pos attention", "decode_rtfx"


def read(view):
    calls = view["calls"].get("relpos_attn")
    if view.get("kind") != "decode_by_config" or not calls or not view.get("trace"):
        return None
    bound = sum(relpos_attention_bound(c["B"], c["T"], c["H"], c["D"], shares.lengths_of(c),
                                       c["elem_bytes"])[0] for c in calls)
    return shares.share(bound, view["trace"]["spans"].get("relpos_attn", 0.0))
