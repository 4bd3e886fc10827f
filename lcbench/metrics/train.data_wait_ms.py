"""Wall time the Trainer spent in its loader's next() during the window, per
optimizer step (the harness wraps the loader it hands Trainer.train)."""

UNIT, SOURCE, LAYER, MOVES = "ms", "host_clock", "trainer host per batch", "train_audio_s_per_s"


def read(view):
    if view.get("kind") != "train" or not view.get("steps"):
        return None
    return 1e3 * view["data_wait_s"] / view["steps"]
