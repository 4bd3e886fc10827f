"""Model FLOP utilisation of the decode: the model FLOPs of the recordings
decoded in the window (harness/flops.py, from the configuration's widths
and each window's true length) over the window's seconds and the card's
bf16 peak, in %."""
from lcbench.harness.bounds import PEAK_FLOPS

UNIT, SOURCE, LAYER, MOVES = "%", "host_clock", "model fwd", "decode_rtfx"


def read(view):
    if view.get("kind") != "decode" or not view.get("useful_flops"):
        return None
    return 100.0 * view["useful_flops"] / view["window_s"] / PEAK_FLOPS["bf16"]
