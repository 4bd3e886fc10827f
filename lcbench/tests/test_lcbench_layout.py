"""The harness is driven by files found by name; BENCHMARK.json keeps to the
contract's names and units; nothing that runs on the card loads JAX or the
JAX package, and the reference loads nothing of the program."""
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

from lcbench.harness import registry

LCBENCH = registry.ROOT
REPO = os.path.dirname(LCBENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _benchmark():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_cell_resolves_by_name():
    bench = _benchmark()
    for cell in bench["workloads"]:
        spec = registry.workload(cell["name"])
        assert spec["config"] == cell["config"] and spec["traffic"] == cell["traffic"]
        assert spec["chips"] == cell["chips"] and spec["why"] == cell["why"]
        registry.config(spec["config"])
        registry.driver(registry.traffic(spec["traffic"])["driver"])
    for cfg in bench["configs"]:
        assert os.path.isfile(os.path.join(REPO, cfg["file"]))
        assert registry.config(cfg["name"])["reduced"] == cfg["reduced"]
    metrics = registry.metrics()
    for m in bench["per_layer"]:
        mod = metrics[m["name"]]
        assert (mod.UNIT, mod.SOURCE, mod.MOVES, mod.LAYER) == (
            m["unit"], m["source"], m["moves"], m["layer"])


def test_names_and_units_keep_to_the_contract():
    bench = _benchmark()
    entries = bench["end_to_end"] + bench["per_layer"] + bench["workloads"] + bench["configs"]
    names = [e["name"] for e in entries]
    assert all(NAME.match(n) for n in names), names
    assert len(set(e["name"] for e in bench["end_to_end"] + bench["per_layer"])) == \
        len(bench["end_to_end"]) + len(bench["per_layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    for c in bench["workloads"]:
        assert len(c["why"]) <= 200 and "\n" not in c["why"]


def test_a_new_cell_config_and_metric_are_found_without_an_edit(tmp_path):
    copy = tmp_path / "lcbench"
    shutil.copytree(LCBENCH, copy, ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "configs" / "tiny_model.json").write_text(json.dumps(
        {"model_class": "SCConformerXL", "source": "x", "reduced": [], "model": {}}))
    (copy / "traffic" / "short_mix.json").write_text(json.dumps({"driver": "decode_stream"}))
    (copy / "workloads" / "tiny.short.json").write_text(json.dumps(
        {"config": "tiny_model", "traffic": "short_mix", "chips": 1, "why": "a test"}))
    (copy / "metrics" / "new.metric.py").write_text(textwrap.dedent('''
        UNIT, SOURCE, LAYER, MOVES = "ms", "host_clock", "device", "decode_rtfx"
        def read(view):
            return 1.0
        '''))
    script = textwrap.dedent('''
        from lcbench.harness import registry
        spec = registry.workload("tiny.short")
        print(registry.config(spec["config"])["model_class"],
              registry.traffic(spec["traffic"])["driver"],
              registry.driver("decode_stream").__name__,
              "new.metric" in registry.metrics(),
              registry.metrics()["new.metric"].read({}))
        ''')
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=str(tmp_path)), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["SCConformerXL", "decode_stream", "lcbench.drivers.decode_stream",
                                  "True", "1.0"]


FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "lcasr_tpu"}


def _top_level_modules_after(imports: str) -> set:
    script = imports + ("\nimport sys\n"
                        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_nothing_that_runs_on_the_card_loads_jax():
    loaded = _top_level_modules_after(textwrap.dedent('''
        import lcbench.run
        from lcbench.harness import registry, runner, judge, spans, trace, corpus, program
        for d in registry.names("drivers", ".py"):
            registry.driver(d)
        registry.metrics()
        import lcbench.reference.sconformer, lcbench.reference.mamba
        import lcbench.reference.train, lcbench.reference.decode
        import lcasr_torch.evaluation.streaming, lcasr_torch.training.trainer
        import lcasr_torch.models.sconformer_xl, lcasr_torch.models.mamba
        '''))
    assert "lcasr_torch" in loaded  # the program is there: the check has teeth
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level_modules_after(textwrap.dedent('''
        import lcbench.reference.sconformer, lcbench.reference.mamba
        import lcbench.reference.train, lcbench.reference.decode, lcbench.reference.layers
        '''))
    assert "lcasr_torch" not in loaded and not loaded & FORBIDDEN


def test_without_a_card_a_run_prints_no_result_and_fails():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal is what a card-less run shows")
    out = subprocess.run([sys.executable, os.path.join(LCBENCH, "run.py"), "--workload",
                          "flagship.decode_20min", "--seed", "3000000000", "--seconds", "1",
                          "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout.strip() == "", (out.returncode, out.stdout)
