"""Model FLOP utilisation of the decode of a configuration that names its FLOP
function (`harness/model_flops.py`; for FastConformerCTC the position term
and `linear_pos` counted): the model FLOPs of the recordings decoded in the
window, from each window's true length, over the window's seconds and the
card's bf16 peak, in %."""
from lcbench.harness.bounds import PEAK_FLOPS

UNIT, SOURCE, LAYER, MOVES = "%", "host_clock", "model fwd", "decode_rtfx"


def read(view):
    if view.get("kind") != "decode_by_config" or not view.get("useful_flops"):
        return None
    return 100.0 * view["useful_flops"] / view["window_s"] / PEAK_FLOPS["bf16"]
