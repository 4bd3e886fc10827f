"""lcasr_torch's eval sweep (evaluation/eval_manager.py) and the comparison
with the published WERs (evaluation/compare.py) against lcasr_tpu's, on
the CPU.

The sweep runs both packages' `evaluate` on the same reference-layout
`.pt` (fp32 models; tests/test_torch_port_eval.py holds the two decodes
equal): the CSV rows are the same, WERs exactly.  A resumed sweep decodes
only the recordings missing from the CSV and appends no row twice.
"""
import csv
import os

import pytest
import yaml

from tests.test_torch_port_eval import reference_checkpoint  # noqa: F401  (a fixture)


def _sweep_config(tmp_path, ckpt, results, **extra):
    cfg = {"results_csv": str(results), "overlap_ratio": 0.75,
           "evaluation_mode": "averaged_moving_window", "seq_lens": [512],
           "models": [{"name": "tiny", "checkpoint": ckpt}],
           "datasets": [{"name": "synthetic", "splits": ["test"]}],
           "dataset_kwargs": {"synthetic": {"n_recordings": 2, "n_frames": 1500}}, **extra}
    path = tmp_path / f"sweep_{os.path.basename(str(results))}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _read(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _key(r):
    return (r["dataset"], r["split"], str(r["recording"]), r["model"], int(r["seq_len"]),
            float(r["overlap_ratio"]))


def test_sweep_matches_jax_and_resumes(reference_checkpoint, tmp_path):  # noqa: F811
    from lcasr_tpu.evaluation import eval_manager as jem
    from lcasr_torch.evaluation import eval_manager as tem

    path, _ = reference_checkpoint
    jcsv, tcsv = tmp_path / "jax.csv", tmp_path / "port.csv"
    jem.run_sweep(_sweep_config(tmp_path, path, jcsv))
    rows = tem.run_sweep(_sweep_config(tmp_path, path, tcsv), device="cpu")
    want, got = _read(jcsv), _read(tcsv)
    assert list(got[0]) == list(want[0])  # the same columns in the same order
    assert len(got) == len(want) == len(rows) == 3  # two recordings and the aggregate
    by_key = {_key(r): r for r in want}
    for r in got:
        w = by_key[_key(r)]
        assert float(r["wer"]) == float(w["wer"]) and float(r["words"]) == float(w["words"])

    # a crash after the first recording: its row is kept, the rest goes
    kept = [r for r in got if str(r["recording"]) == str(got[0]["recording"])]
    with open(tcsv, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(got[0]))
        writer.writeheader()
        writer.writerows(kept)
    new = tem.run_sweep(_sweep_config(tmp_path, path, tcsv), device="cpu")
    assert len(new) == 2  # the missing recording and the aggregate
    resumed = _read(tcsv)
    assert sorted(map(_key, resumed)) == sorted(map(_key, got))  # no row twice
    agg = [r for r in resumed if r["recording"] == "__aggregate__"][0]
    want_agg = [r for r in want if r["recording"] == "__aggregate__"][0]
    assert float(agg["wer"]) == pytest.approx(float(want_agg["wer"]), rel=1e-12)
    # and a finished configuration is skipped
    assert tem.run_sweep(_sweep_config(tmp_path, path, tcsv), device="cpu") == []


def test_decode_options_are_forwarded(tmp_path, monkeypatch):
    import lcasr_torch.evaluation.run as trun
    from lcasr_torch.evaluation import eval_manager as tem

    calls = []

    def fake_evaluate(**kw):
        calls.append(kw)
        return {"rows": [{"recording": "r0", "wer": 0.5, "words": 4}]}

    monkeypatch.setattr(trun, "evaluate", fake_evaluate)
    results = tmp_path / "opts.csv"
    cfg = _sweep_config(tmp_path, "ckpt.pt", results, transfer_dtype="int8",
                        pipeline_upload=True, cache_upload=True, quant_w8a8="auto",
                        seq_lens=[1024, 2048])
    tem.run_sweep(cfg, device="cpu")
    assert [c["seq_len"] for c in calls] == [1024, 2048]
    for c in calls:
        assert c["transfer_dtype"] == "int8" and c["pipeline_upload"] is True
        assert c["cache_upload"] is True and c["quant_w8a8"] == "auto"
        assert c["overlap"] == int(c["seq_len"] * 0.75) and c["device"] == "cpu"
        assert c["dataset_kwargs"] == {"n_recordings": 2, "n_frames": 1500}
        assert "data_parallel" not in c
    assert len(_read(results)) == 4


def test_compare_matches_jax_against_the_model_zoo(tmp_path, capsys):
    from lcasr_tpu.evaluation import compare as jcompare
    from lcasr_torch.evaluation import compare as tcompare

    assert tcompare.load_expected() == jcompare.load_expected()
    zoo = tcompare.load_expected()
    (model, dataset, seq_len), wer = sorted(zoo.items())[0]
    rows = [{"dataset": dataset, "split": "test", "recording": "__aggregate__", "model": model,
             "seq_len": seq_len, "overlap_ratio": 0.875, "wer": wer + 0.001, "words": 100},
            {"dataset": dataset, "split": "dev", "recording": "__aggregate__", "model": model,
             "seq_len": seq_len, "overlap_ratio": 0.875, "wer": wer + 0.5, "words": 100},
            {"dataset": dataset, "split": "test", "recording": "x", "model": model,
             "seq_len": seq_len, "overlap_ratio": 0.875, "wer": 0.9, "words": 10},
            {"dataset": dataset, "split": "test", "recording": "__aggregate__",
             "model": "not_in_zoo", "seq_len": seq_len, "overlap_ratio": 0.875, "wer": 0.1,
             "words": 10}]
    path = tmp_path / "results.csv"
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    got = tcompare.compare(str(path))
    want = jcompare.compare(str(path))
    assert len(got) == len(want) == 1 and got[0]["ok"]
    for g, w in zip(got, want):
        assert g == pytest.approx(w)
    assert not tcompare.compare(str(path), tolerance=0.0)[0]["ok"]
    with pytest.raises(SystemExit) as exit_info:
        tcompare.main([str(path), "--tolerance", "0.0"])
    assert exit_info.value.code == 1 and "FAIL" in capsys.readouterr().out
