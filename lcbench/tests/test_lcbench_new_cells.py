"""The cell whose driver reads its reference from the configuration
(`decode_by_config`, `parakeet.decode_20min`): a sound run at a small size on
the CPU is correct, a run with the position term dropped
(`harness/model_faults.py`) is not, the per-layer metrics read what the
driver leaves, and the new reference loads nothing of the program.  The int8
control shows at the cell's 42 layers of 1024 (PERF.md), not at 4 of 128."""
import os
import subprocess
import sys
import textwrap
import time

import torch

from lcbench.harness import model_faults, registry, runner

REPO = os.path.dirname(registry.ROOT)
CELL = "parakeet.decode_20min"


def small():
    """The cell's files cut to a size the CPU runs in seconds: 4 layers of
    128, a 30-s recording, 1024-frame windows; the limits are the cell's own."""
    spec = dict(registry.workload(CELL), name=CELL)
    cfg = registry.config(spec["config"])
    tr = registry.traffic(spec["traffic"])
    cfg["model"].update(d_model=128, n_heads=2, head_dim=64, n_layers=4,
                        subsampling_conv_channels=64)
    cfg["vocab_size"] = 127
    tr.update(frames=3000, seq_len=1024, overlap=512, window_batch=4, pool=1, judged=1, warmup=1)
    return spec, cfg, tr


def run(fault=None, trace=False, seed=4000000123):
    spec, cfg, tr = small()
    with model_faults.planted(fault):
        code, result = runner.run_cell(spec, cfg, tr, seed, 2.0, trace, torch.device("cpu"),
                                       time.perf_counter())
    assert code == 0 and result["attempted"] > 0
    return result


def test_a_sound_run_is_correct():
    result = run()
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"kl_mean", "probe_rel_l2"}


def test_the_position_term_dropped_is_not_correct():
    result = run(fault="position_term_dropped")
    assert not result["correct"], result["checks"]
    probe = result["checks"]["probe_rel_l2"]
    assert probe["value"] > 10 * probe["limit"]


def test_the_traced_run_reports_its_metrics():
    from lcbench.harness import spans

    result = run(trace=True)
    assert 0 < result["metrics"]["mfu.decode_relpos"]["value"]
    # the CPU has no device trace: the roofline from a trace summary standing
    # in for the card's
    log = spans.CallLog()
    log.active = True
    log.add("relpos_attn", B=16, T=2048, H=8, D=128, lengths=None, elem_bytes=2)
    share = registry.metrics()["relpos_attn_roofline"].read(
        {"kind": "decode_by_config", "calls": log.calls,
         "trace": {"spans": {"relpos_attn": 0.004}}})
    assert abs(share - 100 * 0.4169027911183013 / 4.0) < 1e-6


def test_the_new_references_load_nothing_of_the_program():
    script = textwrap.dedent('''
        import sys
        import lcbench.reference.fastconformer, lcbench.reference.frontend
        print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))
        ''')
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    loaded = set(out.stdout.split())
    assert "lcbench" in loaded and "lcasr_torch" not in loaded and "jax" not in loaded
