"""YAML-driven eval sweep: models x datasets x splits x context lengths ->
CSV rows (the port's copy of lcasr_tpu/evaluation/eval_manager.py).

  * overlap = seq_len x overlap_ratio;
  * configurations whose aggregate row is already in the results CSV are
    skipped: the CSV doubles as the golden-results database;
  * recordings already in the CSV for a configuration are neither decoded
    nor appended again (crash resume); the aggregate is derived anew from
    the old and the new rows;
  * rows are keyed by (dataset, split, recording, model, seq_len,
    overlap_ratio).

The decode options `transfer_dtype`, `pipeline_upload`, `cache_upload`,
`data_parallel`, `context_parallel` and `quant_w8a8` of the config are
passed on to `evaluate`.  The CSV is read and written with the standard
library's `csv` (the JAX module uses pandas; the columns and their order
are the same); YAML is read by `Config.load`.

    python -m lcasr_torch.evaluation.eval_manager -config sweep.yaml [--device cpu]
"""
from __future__ import annotations

import argparse
import csv
import os
from typing import Any, Dict, List, Optional

from lcasr_torch.config import Config

DECODE_OPTIONS = ("transfer_dtype", "pipeline_upload", "cache_upload", "data_parallel",
                  "context_parallel", "quant_w8a8")


def _row_key(row: Dict[str, Any]) -> tuple:
    return (str(row["dataset"]), str(row["split"]), str(row["recording"]), str(row["model"]),
            int(row["seq_len"]), float(row["overlap_ratio"]))


def load_existing(results_csv: str):
    """(the key set, the rows as dicts) of the results CSV."""
    if not os.path.exists(results_csv):
        return set(), []
    with open(results_csv, newline="") as f:
        records = list(csv.DictReader(f))
    return {_row_key(r) for r in records}, records


def _append_csv(path: str, rows: List[Dict[str, Any]]) -> None:
    """Append rows under the file's own column order (new columns at the
    end of the header of a new file only)."""
    if not rows:
        return
    cols = []
    for r in rows:
        cols += [c for c in r if c not in cols]
    exists = os.path.exists(path)
    if exists:
        with open(path, newline="") as f:
            cols = next(csv.reader(f))
    with open(path, "a" if exists else "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=cols, extrasaction="ignore")
        if not exists:
            writer.writeheader()
        writer.writerows(rows)


def run_sweep(config_path: str, results_csv: Optional[str] = None,
              device=None) -> List[Dict[str, Any]]:
    from lcasr_torch.evaluation.run import evaluate

    cfg = Config.load(config_path)
    results_csv = results_csv or cfg.get("results_csv", "eval_results.csv")
    existing, existing_rows = load_existing(results_csv)
    overlap_ratio = cfg.get("overlap_ratio", 0.875)
    mode = cfg.get("evaluation_mode", "averaged_moving_window")
    dataset_kwargs = cfg.get("dataset_kwargs", Config({})).to_dict()
    decode_opts = {k: cfg.get(k) for k in DECODE_OPTIONS if cfg.get(k) is not None}

    all_rows: List[Dict[str, Any]] = []
    for model_entry in cfg.get("models", []):
        name, ckpt = model_entry["name"], model_entry["checkpoint"]
        seq_lens = model_entry.get("seq_lens", cfg.get("seq_lens", [16384]))
        for dataset_entry in cfg.get("datasets", []):
            dataset = dataset_entry["name"]
            for split in dataset_entry.get("splits", ["test"]):
                for seq_len in seq_lens:
                    probe = {"dataset": dataset, "split": split, "recording": "__aggregate__",
                             "model": name, "seq_len": seq_len, "overlap_ratio": overlap_ratio}
                    key = _row_key(probe)
                    if key in existing:
                        print(f"skip (already evaluated): {probe}")
                        continue
                    cfg_key = key[:2] + key[3:]
                    prior = [r for r in existing_rows
                             if _row_key(r)[:2] + _row_key(r)[3:] == cfg_key
                             and str(r["recording"]) != "__aggregate__"]
                    done_ids = {str(r["recording"]) for r in prior}
                    if done_ids:
                        print(f"resume: {len(done_ids)} recordings already done")
                    summary = evaluate(
                        checkpoint=ckpt, dataset=dataset, split=split, seq_len=seq_len,
                        overlap=int(seq_len * overlap_ratio), evaluation_mode=mode,
                        dataset_kwargs=dataset_kwargs.get(dataset, {}),
                        skip_recordings=done_ids, device=device, **decode_opts)
                    rows = [{**probe, "recording": r["recording"], "wer": r["wer"],
                             "words": r["words"]} for r in summary["rows"]]
                    combined = prior + rows
                    total_words = sum(float(r["words"]) for r in combined)
                    # wer x words is a recording's error count; an empty
                    # reference (wer inf, words 0) cannot give it back and
                    # stays out of the aggregate
                    agg_wer = sum(float(r["wer"]) * float(r["words"]) for r in combined
                                  if float(r["words"]) > 0) / max(total_words, 1.0)
                    rows.append({**probe, "wer": agg_wer, "words": total_words})
                    all_rows.extend(rows)
                    _append_csv(results_csv, rows)
    return all_rows


def main(args=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-config", "--config", required=True)
    parser.add_argument("-results", "--results_csv", default=None)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu (the kernels' plain versions)")
    ns = parser.parse_args(args)
    run_sweep(ns.config, ns.results_csv, device=ns.device)


if __name__ == "__main__":
    main()
