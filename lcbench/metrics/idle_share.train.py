"""The share of the traced training window in which no device activity ran:
1 - the union of the kernels' intervals over the window, in %."""

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "device", "train_audio_s_per_s"


def read(view):
    tr = view.get("trace")
    if view.get("kind") != "train" or not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
