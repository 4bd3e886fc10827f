"""`correct` comes out false where it must: the cells' controls and each fault
a cell can have, planted under the timed path of a whole run (the card's
checks skipped, everything else as a run does it) at a small size on the
CPU, judged against the cells' own limits; and a sound run at that size
comes out true."""
import math
import time

import pytest
import torch

from lcbench.harness import registry, runner

CELLS = ("flagship.decode_20min", "mamba.decode_20min", "flagship.train_16384x22",
         "flagship.train_360000x1")


def small(cell: str):
    """The cell's files, cut to a size the CPU runs in seconds: every
    family's widths and depth cut, the recordings, windows and batches
    shortened; the limits are the cell's own."""
    spec = dict(registry.workload(cell), name=cell)
    cfg = registry.config(spec["config"])
    tr = registry.traffic(spec["traffic"])
    if tr["driver"] == "decode_stream":
        # deep and wide enough that the control's int8 shows as it does at
        # the cell's own size
        if cfg["model_class"] == "SCConformerXL":
            cfg["model"].update(d_model=128, n_heads=2, head_dim=64, n_layers=4,
                                subsampling_conv_channels=64)
        else:
            cfg["model"].update(d_model=128, n_layers=4, subsampling_conv_channels=64)
        cfg["vocab_size"] = 127
        tr.update(frames=3000, seq_len=1024, overlap=512, window_batch=4, pool=1, judged=1,
                  warmup=1)
    else:
        cfg["model"].update(d_model=64, n_heads=2, head_dim=32, n_layers=2,
                            subsampling_conv_channels=32)
        tr.update(podcasts=4, podcast_frames=3072, batch=min(tr["batch"], 2),
                  chunk=min(tr["chunk"], 3072 if tr["batch"] == 1 else 1024))
    return spec, cfg, tr


def run(cell, seed=4000000123, control=False, fault=None):
    spec, cfg, tr = small(cell)
    seconds = 3.0 if tr["driver"] == "decode_stream" else 0.5
    code, result = runner.run_cell(spec, cfg, tr, seed, seconds, False, torch.device("cpu"),
                                   time.perf_counter(), control, fault)
    assert code == 0 and result["attempted"] > 0
    return result


def failed_checks(result):
    return [k for k, c in result["checks"].items() if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    result = run(cell)
    assert result["correct"], result["checks"]


# the one-hour cell's control (its first step's loss in fp8) shows only at
# widths and lengths the CPU does not run in a test's time; it is read on
# the card (PERF.md)
@pytest.mark.parametrize("cell", CELLS[:3])
def test_the_control_is_not_correct(cell):
    result = run(cell, control=True)
    assert not result["correct"] and failed_checks(result), result["checks"]


@pytest.mark.parametrize("cell,fault", [
    ("flagship.decode_20min", "answer_altered"),
    ("flagship.decode_20min", "half_batch"),
    ("mamba.decode_20min", "answer_altered"),
    ("mamba.decode_20min", "half_batch"),
    ("flagship.train_16384x22", "state_unchanged"),
    ("flagship.train_16384x22", "half_batch"),
    ("flagship.train_360000x1", "state_unchanged"),  # batch 1: no half to leave out
])
def test_a_planted_fault_is_not_correct(cell, fault):
    result = run(cell, fault=fault)
    assert not result["correct"] and failed_checks(result), result["checks"]


def test_a_state_left_unchanged_reads_one():
    checks = run("flagship.train_16384x22", fault="state_unchanged")["checks"]
    assert math.isclose(checks["update_gap"]["value"], 1.0, rel_tol=1e-6)
    assert math.isclose(checks["grad1_gap"]["value"], 1.0, rel_tol=1e-6)
