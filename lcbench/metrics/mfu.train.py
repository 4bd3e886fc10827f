"""Model FLOP utilisation of training: forward and backward of every step in
the window (three times the forward, recomputation not counted) over the
window's seconds and the card's bf16 peak, in %."""
from lcbench.harness.bounds import PEAK_FLOPS

UNIT, SOURCE, LAYER, MOVES = "%", "host_clock", "model fwd / bwd", "train_audio_s_per_s"


def read(view):
    if view.get("kind") != "train" or not view.get("useful_flops"):
        return None
    return 100.0 * view["useful_flops"] / view["window_s"] / PEAK_FLOPS["bf16"]
