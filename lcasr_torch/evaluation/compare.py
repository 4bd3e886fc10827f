"""Compare eval-sweep results with the published WERs (the port's copy of
lcasr_tpu/evaluation/compare.py).

The published README WER table lives in `configs/model_zoo.yaml`
(`expected_wer_<dataset>` per model, at the paper's three context lengths);
this tool joins an `eval_manager` results CSV against it:

    python -m lcasr_torch.evaluation.compare results.csv [--tolerance 0.005]

Exit status 1 if any matched row exceeds the tolerance.  Published-WER
parity has not been reproduced by this repo: the zoo's numbers are targets.
"""
from __future__ import annotations

import argparse
import csv
import os
from typing import Any, Dict, List, Optional

from lcasr_torch.utils.resources import find_repo_file

# the paper's three eval context lengths: 10 s / 2.7 min / 20 min of mel frames
CONTEXT_SEQ_LENS = (1024, 16384, 120000)

DEFAULT_ZOO = find_repo_file(os.path.join("configs", "model_zoo.yaml"))


def load_expected(zoo_path: Optional[str] = None) -> Dict[tuple, float]:
    """(model, dataset, seq_len) -> published WER (a fraction, e.g. 0.068)."""
    import yaml  # only here: the card's machine is not promised pyyaml

    with open(zoo_path or DEFAULT_ZOO) as f:
        zoo = yaml.safe_load(f)["zoo"]
    expected = {}
    for model, entry in zoo.items():
        for key, values in entry.items():
            if key.startswith("expected_wer_"):
                dataset = key[len("expected_wer_"):]
                for seq_len, wer_pct in zip(CONTEXT_SEQ_LENS, values):
                    expected[(model, dataset, seq_len)] = wer_pct / 100.0
    return expected


def compare(results_csv: str, zoo_path: Optional[str] = None, tolerance: float = 0.005,
            split: str = "test") -> List[Dict[str, Any]]:
    """One report row per aggregate row of `split` that the zoo knows:
    {model, dataset, seq_len, wer, expected, delta, ok}."""
    expected = load_expected(zoo_path)
    with open(results_csv, newline="") as f:
        rows = [r for r in csv.DictReader(f) if str(r["recording"]) == "__aggregate__"]
    report = []
    for row in rows:
        if "split" in row and str(row["split"]) != split:
            continue
        key = (str(row["model"]), str(row["dataset"]), int(float(row["seq_len"])))
        if key not in expected:
            continue
        wer, exp = float(row["wer"]), expected[key]
        report.append({"model": key[0], "dataset": key[1], "seq_len": key[2], "wer": wer,
                       "expected": exp, "delta": wer - exp, "ok": wer <= exp + tolerance})
    return report


def main(args=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("results_csv")
    parser.add_argument("--zoo", default=None)
    parser.add_argument("--tolerance", type=float, default=0.005,
                        help="absolute WER slack over the published number (0.5 pt)")
    parser.add_argument("--split", default="test",
                        help="which split's aggregates to judge (the published table is test)")
    ns = parser.parse_args(args)
    report = compare(ns.results_csv, ns.zoo, ns.tolerance, ns.split)
    if not report:
        print("no rows matched the zoo's published table "
              "(model names must be zoo keys, e.g. lcasr_9l_768d_6h)")
        raise SystemExit(0)
    width = max(len(r["model"]) for r in report)
    for r in report:
        print(f"{'ok  ' if r['ok'] else 'FAIL'} {r['model']:<{width}} {r['dataset']:<12} "
              f"seq {r['seq_len']:>6}: WER {r['wer']:.4f} (published {r['expected']:.4f}, "
              f"delta {r['delta']:+.4f})")
    if any(not r["ok"] for r in report):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
