"""The attention's share of its roofline in training, forward and backward
calls together (the recomputed forwards are calls too): the bound of the
calls' work (forward 4 T^2 D, fused backward 10 T^2 D a head, at the bf16
peak, or their bytes) over the device time of the kernels launched inside
the calls to the op and to its backward, in %."""
from lcbench.harness import shares

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "attention kernels", "train_audio_s_per_s"


def read(view):
    fwd, bwd = view["calls"].get("attn_fwd", []), view["calls"].get("attn_bwd", [])
    if view.get("kind") != "train" or not (fwd or bwd):
        return None
    spans = view["trace"]["spans"]
    bound = shares.attention_ms(fwd, backward=False) + shares.attention_ms(bwd, backward=True)
    return shares.share(bound, spans.get("attn_fwd", 0.0) + spans.get("attn_bwd", 0.0))
