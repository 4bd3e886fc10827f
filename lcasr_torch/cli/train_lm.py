"""Train the first-party TransformerLM on transcript text (the port's copy of
lcasr_tpu/cli/train_lm.py).

The reference's rescoring LM comes from an external package (`lming`,
reference `eval/tedlium/tlm_beam.py:5-6`); this CLI closes the loop in the
repo: transcript text (one utterance per line) -> next-token training of
`models/lm.py:TransformerLM` -> a checkpoint of the port
(`training/checkpointing.py`, the config embedded as {"model_class":
"TransformerLM", "model": ...}) that `cli/lm_rescore beam -lm` loads.

    python -m lcasr_torch.cli.train_lm -text all_text.txt -save ckpts/lm \
        --d_model 512 --n_layers 6 --steps 20000 [--device cpu]

The optimizer is optax.chain(clip_by_global_norm(1.0), adamw(lr,
weight_decay=0.01)) of the JAX CLI: `clip_grad_norm_(1.0)`, then
`torch.optim.AdamW` (decoupled decay on every parameter, eps outside the
square root, the same bias corrections).  `clip_grad_norm_` divides by the
norm + 1e-6 where optax divides by the norm: a relative 1e-6 on a clipped
step.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch


def batches_from_text(
    lines: List[str],
    tokenizer,
    batch_size: int,
    seq_len: int,
    seed: int = 1234,
    bos_id: int = 2,
    pad_id: int = 0,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless shuffled ((B, U) int32 tokens, (B,) lengths) batches: bos +
    ids, padded.  Lines longer than seq_len are split into seq_len-token
    windows, so long transcripts contribute everything."""
    rng = np.random.default_rng(seed)
    rows: List[List[int]] = []
    for line in lines:
        ids = tokenizer.encode(line.strip())
        if not ids:
            continue
        for i in range(0, len(ids), seq_len):
            window = ids[i : i + seq_len]
            if window:
                rows.append([bos_id] + window)
    if not rows:
        raise ValueError("no non-empty tokenized lines in the corpus")
    while True:
        order = rng.permutation(len(rows))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            batch = [rows[j] for j in order[i : i + batch_size]]
            # the padded width in buckets of 32 (capped at the row ceiling);
            # padded positions are masked out of lm_loss by `lengths`
            U = max(len(r) for r in batch)
            U = min(-(-U // 32) * 32, seq_len + 1)
            out = np.full((batch_size, U), pad_id, np.int32)
            lengths = np.zeros((batch_size,), np.int32)
            for k, r in enumerate(batch):
                out[k, : len(r)] = r
                lengths[k] = len(r)
            yield out, lengths


def make_optimizer(model, lr: float = 3e-4) -> torch.optim.Optimizer:
    """AdamW as optax.adamw(lr, weight_decay=0.01) sets it."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01)


def train_step(model, optimizer, tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """One optimizer step on one batch; returns the loss (on the device)."""
    from lcasr_torch.models.lm import lm_loss

    optimizer.zero_grad(set_to_none=True)
    loss = lm_loss(model, tokens, lengths)
    loss.backward()
    torch.nn.utils.clip_grad_norm_(model.parameters(), 1.0)
    optimizer.step()
    return loss.detach()


def train_lm(
    text_path: str,
    save_dir: str,
    d_model: int = 512,
    n_layers: int = 6,
    n_heads: int = 8,
    head_dim: int = 64,
    batch_size: int = 32,
    seq_len: int = 256,
    lr: float = 3e-4,
    steps: int = 20000,
    save_every: int = 5000,
    log_every: int = 50,
    seed: int = 1234,
    device=None,
    tokenizer=None,
) -> Optional[str]:
    """Train and save; returns the last checkpoint's path.  `metrics.jsonl`
    in `save_dir` gets {"step", "loss", "wall_s"} at step 1 and every
    `log_every` steps (wall_s: seconds since the first step began).
    `device=None` means the GPU and raises without one."""
    from lcasr_torch.config import Config
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.device import resolve_device
    from lcasr_torch.models.lm import TransformerLM
    from lcasr_torch.models.sconformer_xl import init_weights_
    from lcasr_torch.training import checkpointing

    device = resolve_device(device)
    tokenizer = tokenizer or load_tokenizer()
    lm_cfg = dict(vocab_size=tokenizer.vocab_size(), d_model=d_model, n_layers=n_layers,
                  n_heads=n_heads, head_dim=head_dim)
    model = init_weights_(TransformerLM(**lm_cfg, device=device), seed)
    optimizer = make_optimizer(model, lr)

    with open(text_path) as f:
        lines = [line for line in f if line.strip()]
    it = batches_from_text(lines, tokenizer, batch_size, seq_len, seed=seed)
    cfg = Config({"model_class": "TransformerLM", "model": lm_cfg})

    os.makedirs(save_dir, exist_ok=True)
    path = None
    with open(os.path.join(save_dir, "metrics.jsonl"), "a") as metrics:
        t0 = time.perf_counter()
        for step in range(1, steps + 1):
            tokens, lengths = next(it)
            loss = train_step(model, optimizer, torch.from_numpy(tokens).to(device),
                              torch.from_numpy(lengths).to(device))
            if step % log_every == 0 or step == 1:
                metrics.write(json.dumps({"step": step, "loss": float(loss),
                                          "wall_s": time.perf_counter() - t0}) + "\n")
                metrics.flush()
            if step % save_every == 0 or step == steps:
                path = checkpointing.save_checkpoint(save_dir, step, model.state_dict(),
                                                     config=cfg)
    return path


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-text", required=True, help="one transcript per line")
    ap.add_argument("-save", required=True, help="checkpoint directory")
    ap.add_argument("--d_model", type=int, default=512)
    ap.add_argument("--n_layers", type=int, default=6)
    ap.add_argument("--n_heads", type=int, default=8)
    ap.add_argument("--head_dim", type=int, default=64)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--seq_len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--save_every", type=int, default=5000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the CPU)")
    args = ap.parse_args()
    path = train_lm(
        args.text, args.save, d_model=args.d_model, n_layers=args.n_layers,
        n_heads=args.n_heads, head_dim=args.head_dim, batch_size=args.batch_size,
        seq_len=args.seq_len, lr=args.lr, steps=args.steps, save_every=args.save_every,
        device=args.device,
    )
    print(f"saved {path}")


if __name__ == "__main__":
    main()
