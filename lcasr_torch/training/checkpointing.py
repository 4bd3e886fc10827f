"""Checkpoint save/load (counterpart of lcasr_tpu/training/checkpointing.py).

A checkpoint is a directory `step_<podcast_step>/` with the arrays in
`arrays.pt` (`torch.save` of the model's state_dict, BatchRenorm running
statistics included, and the optimizer's) and `meta.json`, the JAX
package's contract: podcast_step, epoch, seen_ids, the full config and
both schedulers' states.  `meta.json` is written last and marks the
checkpoint complete.
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
