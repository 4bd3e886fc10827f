"""Experiment launcher: template expansion, job submission and restarts
(counterpart of lcasr_tpu/cli/launcher.py).

  * a template YAML carries a `template_info` block whose `template_keys`
    are dot-paths with one value per run (e.g. 12 runs = 4 sequence lengths
    x 3 seeds); `expand_template` writes one config per run, after an
    optional model-zoo entry (`configs/model_zoo.yaml`) is laid over it;
  * `submit` renders a job script per config (a SLURM script asking for one
    GPU that runs `python -m lcasr_torch.cli.train`) and hands it to
    `sbatch`, or only writes it with `dry_run`;
  * `restart` resubmits a crashed run with the same config and a new random
    data seed, to step past the batch that crashed it.

Needs pyyaml (imported inside the functions).

    python -m lcasr_torch.cli.launcher expand -template T.yaml -out DIR
        [--model NAME] [--zoo Z.yaml] [--submit [--dry_run]]
    python -m lcasr_torch.cli.launcher restart -config RUN.yaml [...]
        [--dry_run] [--keep_seed] [--seed N]
"""
from __future__ import annotations

import argparse
import os
import random
import subprocess
from typing import Any, Dict, List

from lcasr_torch.config import Config
from lcasr_torch.utils.resources import find_repo_file

DEFAULT_JOB_TEMPLATE = """#!/bin/bash
#SBATCH --time=96:00:00
#SBATCH --mem=150G
#SBATCH --gres=gpu:1
#SBATCH --output={log_path}
python -m lcasr_torch.cli.train -config {config_path}
"""

DEFAULT_ZOO = find_repo_file(os.path.join("configs", "model_zoo.yaml"))


def apply_zoo_model(template: Dict[str, Any], model_name: str,
                    zoo_path: str = None) -> Dict[str, Any]:
    """Lay a model-zoo entry's dot-path overrides over a template, making the
    mappings on the way where the template lacks them."""
    import yaml

    with open(zoo_path or DEFAULT_ZOO) as f:
        zoo = yaml.safe_load(f)["zoo"]
    if model_name not in zoo:
        raise ValueError(
            f"unknown zoo model {model_name!r}; available: {sorted(zoo)}"
        )
    for path, value in (zoo[model_name].get("overrides") or {}).items():
        node = template
        parts = path.split(".")
        for p in parts[:-1]:
            # an empty YAML section (`scheduler:`) parses to None
            if not isinstance(node.get(p), dict):
                node[p] = {}
            node = node[p]
        node[parts[-1]] = value
    return template


def expand_template(template_path: str, out_dir: str,
                    zoo_model: str = None, zoo_path: str = None) -> List[str]:
    """Write `<template>[_<model>]_run<i>.yaml` for each run under out_dir;
    returns their paths."""
    import yaml

    with open(template_path) as f:
        template = yaml.safe_load(f)
    if zoo_model:
        template = apply_zoo_model(template, zoo_model, zoo_path)
    info = template.pop("template_info", {})
    keys: List[str] = info.get("template_keys", [])
    if not keys:
        raise ValueError("template_info.template_keys missing")

    def get_path(d: Dict[str, Any], path: str):
        node = d
        for p in path.split("."):
            node = node[p]
        return node

    def set_path(d: Dict[str, Any], path: str, value):
        node = d
        parts = path.split(".")
        for p in parts[:-1]:
            node = node[p]
        node[parts[-1]] = value

    n_runs = len(get_path(template, keys[0]))
    for k in keys:
        assert len(get_path(template, k)) == n_runs, (
            f"template key {k} must list {n_runs} values"
        )

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    base = os.path.splitext(os.path.basename(template_path))[0]
    if zoo_model:
        base = f"{base}_{zoo_model}"
    for run in range(n_runs):
        cfg = yaml.safe_load(yaml.safe_dump(template))  # deep copy
        for k in keys:
            set_path(cfg, k, get_path(template, k)[run])
        path = os.path.join(out_dir, f"{base}_run{run}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f, sort_keys=False)
        paths.append(path)
    return paths


def submit(config_paths: List[str], job_template: str = DEFAULT_JOB_TEMPLATE,
           submit_cmd: str = "sbatch", dry_run: bool = False) -> List[str]:
    """Write `<config>.sh` beside each config and, unless dry_run, submit it."""
    scripts = []
    for cfg_path in config_paths:
        script = job_template.format(
            config_path=cfg_path, log_path=cfg_path.replace(".yaml", ".log")
        )
        script_path = cfg_path.replace(".yaml", ".sh")
        with open(script_path, "w") as f:
            f.write(script)
        scripts.append(script_path)
        if not dry_run:
            subprocess.run([submit_cmd, script_path], check=False)
    return scripts


def restart(config_path: str, dry_run: bool = False,
            keep_seed: bool = False, seed: str = "random") -> str:
    """Resubmit a crashed run.  Its `training.random_seed` is drawn anew
    (0..1,000,000) unless `keep_seed`; `seed` pins an integer instead."""
    if not keep_seed:
        cfg = Config.load(config_path)
        new_seed = (
            random.randint(0, 1000000) if seed == "random" else int(seed)
        )
        cfg = cfg.apply_overrides([f"training.random_seed={new_seed}"])
        cfg.save(config_path)
        print(f"re-randomized data seed -> {new_seed}")
    if not dry_run:
        submit([config_path])
    return config_path


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)
    e = sub.add_parser("expand")
    e.add_argument("-template", required=True)
    e.add_argument("-out", required=True)
    e.add_argument("--model", default=None,
                   help="model-zoo entry to overlay (configs/model_zoo.yaml)")
    e.add_argument("--zoo", default=None, help="alternate zoo file")
    e.add_argument("--submit", action="store_true")
    e.add_argument("--dry_run", action="store_true")
    r = sub.add_parser("restart")
    r.add_argument("-config", required=True, nargs="+",
                   help="one or more run configs to resubmit")
    r.add_argument("--dry_run", action="store_true")
    r.add_argument("--keep_seed", action="store_true",
                   help="do not re-randomize the data seed")
    r.add_argument("--seed", default="random",
                   help="'random' or an explicit integer seed")
    args = parser.parse_args(argv)

    if args.cmd == "expand":
        paths = expand_template(args.template, args.out,
                                zoo_model=args.model, zoo_path=args.zoo)
        print("\n".join(paths))
        if args.submit:
            submit(paths, dry_run=args.dry_run)
    elif args.cmd == "restart":
        for cfg_path in args.config:
            restart(cfg_path, dry_run=args.dry_run,
                    keep_seed=args.keep_seed, seed=args.seed)


if __name__ == "__main__":
    main()
