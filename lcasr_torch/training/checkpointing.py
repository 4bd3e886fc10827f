"""Checkpoint save/load (counterpart of lcasr_tpu/training/checkpointing.py).

A checkpoint is a directory `step_<podcast_step>/` with the arrays in
`arrays.pt` (`torch.save` of the model's state_dict, BatchRenorm running
statistics included, and the optimizer's) and `meta.json`, the JAX
package's contract: podcast_step, epoch, seen_ids, the full config and
both schedulers' states.  `meta.json` is written last and marks the
checkpoint complete.

`average_checkpoints` / `avg_all_models_in_dir` average checkpoints across
seed repeats as the JAX package does: the parameters only, summed in float64
and cast to float32, returned alone.  `arrays.pt` holds the model's
parameters and buffers (BatchRenorm's statistics) together, so the
parameters are told by their names: those of `named_parameters()` of the
model that the checkpoint's own `meta.json` config builds (`load_model` on
the meta device, which allocates nothing; names do not depend on the
vocabulary's size).
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from lcasr_torch.config import Config


def save_checkpoint(
    directory: str,
    step: int,
    model_state: Dict[str, torch.Tensor],
    optimizer_state: Optional[Dict[str, Any]] = None,
    config: Optional[Config] = None,
    scheduler_state: Optional[Dict[str, Any]] = None,
    sequence_scheduler_state: Optional[Dict[str, Any]] = None,
    seen_ids: Optional[List[str]] = None,
    epoch: int = 0,
) -> str:
    path = os.path.abspath(os.path.join(directory, f"step_{step}"))
    os.makedirs(path, exist_ok=True)
    torch.save({"model": model_state, "optimizer": optimizer_state},
               os.path.join(path, "arrays.pt"))
    meta = {
        "podcast_step": step,
        "epoch": epoch,
        "seen_ids": seen_ids or [],
        "config": config.to_dict() if config is not None else {},
        "scheduler": scheduler_state or {},
        "sequence_scheduler": sequence_scheduler_state or {},
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    return path


def find_latest_checkpoint(directory: str, pattern: str = r"step_(\d+)") -> Optional[str]:
    """The complete checkpoint (one with meta.json) of the highest step."""
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        m = re.fullmatch(pattern, name)
        if (m and int(m.group(1)) > best_step
                and os.path.exists(os.path.join(directory, name, "meta.json"))):
            best, best_step = name, int(m.group(1))
    return os.path.join(directory, best) if best else None


def load_checkpoint(path: str, map_location=None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(arrays {'model', 'optimizer'}, meta dict)."""
    arrays = torch.load(os.path.join(path, "arrays.pt"), map_location=map_location,
                        weights_only=True)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return arrays, meta


def parameter_names(config: Dict[str, Any]) -> List[str]:
    """The names of the parameters (not buffers) of the model `config` (a
    checkpoint's config dict) builds."""
    from lcasr_torch.models.registry import load_model

    with torch.device("meta"):
        model = load_model(Config.from_dict(config), vocab_size=2, device="meta")
    return [name for name, _ in model.named_parameters()]


def average_checkpoints(paths: List[str]) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor}: each parameter's mean over the checkpoints,
    summed in float64 in the order of `paths`, then divided and cast."""
    assert paths, "no checkpoints to average"
    acc = None
    for p in paths:
        arrays, meta = load_checkpoint(p, map_location="cpu")
        state = arrays["model"]
        names = parameter_names(meta["config"])
        missing = [n for n in names if n not in state]
        if missing:
            raise ValueError(f"{p}: parameters {missing[:5]} of its config's model are not "
                             f"in arrays.pt")
        if acc is None:
            acc = {n: state[n].to(torch.float64) for n in names}
        else:
            if set(names) != set(acc):
                raise ValueError(f"{p} holds another model's parameters than {paths[0]}")
            for n in names:
                acc[n] += state[n].to(torch.float64)
    n = float(len(paths))
    return {k: (a / n).to(torch.float32) for k, a in acc.items()}


def avg_all_models_in_dir(directory: str, step_name: Optional[str] = None
                          ) -> Dict[str, torch.Tensor]:
    """Average the same step across the seed-repeat folders of `directory`
    (`directory/<repeat>/<step_name>/`, folders in sorted order); `step_name`
    None takes each folder's latest checkpoint, and where no folder has one,
    the complete `step_N` checkpoints of `directory` itself."""
    paths = []
    for d in sorted(os.listdir(directory)):
        sub = os.path.join(directory, d)
        if not os.path.isdir(sub):
            continue
        if step_name is not None:
            cand = os.path.join(sub, step_name)
            if os.path.exists(os.path.join(cand, "meta.json")):
                paths.append(cand)
        else:
            latest = find_latest_checkpoint(sub)
            if latest:
                paths.append(latest)
    if not paths and step_name is None:
        paths = sorted(
            os.path.join(directory, d)
            for d in os.listdir(directory)
            if re.fullmatch(r"step_(\d+)", d)
            and os.path.exists(os.path.join(directory, d, "meta.json"))
        )
    return average_checkpoints(paths)
