"""Training metrics logging: wandb when enabled, JSONL file always (the
port's copy of lcasr_tpu/training/metrics.py; wandb is imported only when
`use_wandb` is set).

The reference logs loss/frame, blank probability, lr, seq len, batch size,
epoch and spec_augment per optimizer step to wandb (reference
`exp/train.py:297-306`).  wandb is optional here; every run also appends a
JSONL metrics stream that the eval/bench tooling can read back.

Each row's `ts` is the host's wall time (`time.time()`) when the row was
written, not a step time on the card's clock: the card runs behind the host,
so the gap between two rows is the host's time between them, which leaves
out work still queued on the card.  Step times on the card's clock come from
a profiler trace (the Trainer's `lcasr.train.*` ranges, utils/profiling.py).
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: str = ".", use_wandb: bool = False, wandb_config: Optional[Dict] = None):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._fh = open(self.path, "a")
        self.wandb = None
        if use_wandb:
            try:
                import wandb

                cfg = wandb_config or {}
                if cfg.get("id"):
                    wandb.init(
                        project=cfg.get("project_name", "lcasr_torch"),
                        id=cfg["id"],
                        resume="must",
                        config=cfg,
                        allow_val_change=True,
                    )
                else:
                    wandb.init(
                        project=cfg.get("project_name", "lcasr_torch"),
                        name=cfg.get("name"),
                        config=cfg,
                    )
                self.wandb = wandb
            except Exception:
                self.wandb = None

    def log(self, metrics: Dict[str, Any]) -> None:
        rec = {"ts": time.time(), **metrics}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self.wandb is not None:
            self.wandb.log(metrics)

    def close(self) -> None:
        self._fh.close()
