"""Loss-based evaluation: per-recording CTC loss instead of WER (the port's
copy of lcasr_tpu/evaluation/loss_eval.py).

Counterpart of reference `eval/rev16_loss/run.py:83-144` /
`eval/spotify_loss/run.py:95-127`: a domain-shift probe that scores a
checkpoint by CTC negative log-likelihood over the full recording's
averaged-moving-window logits (the same decode the WER eval uses),
normalised per target token.  `target` picks the reference variant:

  * "gold": NLL of the gold transcript (spotify_loss `:107-120`),
  * "hypothesis": NLL of the model's own greedy transcript re-tokenised
    (rev16_loss `:106-117`): a confidence probe that needs no gold text.

The JAX module pads both axes to buckets so that its jitted lattice compiles
once per size class; PyTorch runs eagerly, so the port computes the loss at
the exact sizes (length masking made the padding inert there).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from lcasr_torch.data.tokenizer import load_tokenizer
from lcasr_torch.decoding.greedy import GreedyCTCDecoder
from lcasr_torch.device import resolve_device
from lcasr_torch.evaluation.datasets import get_dataset_fn
from lcasr_torch.evaluation.run import build_model, load_any_checkpoint
from lcasr_torch.evaluation.streaming import StreamingDecoder
from lcasr_torch.ops.ctc import ctc_loss


def evaluate_loss(
    checkpoint: str,
    dataset: str,
    split: str = "test",
    seq_len: int = 16384,
    overlap: int = -1,
    target: str = "gold",
    dataset_kwargs: Optional[Dict[str, Any]] = None,
    verbose: bool = True,
    device=None,
) -> Dict[str, Any]:
    if target not in ("gold", "hypothesis"):
        raise ValueError(f"target must be gold|hypothesis, got {target}")
    device = resolve_device(device)
    cfg, state_dict = load_any_checkpoint(checkpoint)
    tokenizer = load_tokenizer()
    n_classes = tokenizer.vocab_size() + 1
    model = build_model(cfg, state_dict, tokenizer.vocab_size(), device)
    streamer = StreamingDecoder(model, n_classes, device=device)
    decoder = GreedyCTCDecoder(tokenizer, blank_id=n_classes - 1)
    if overlap == -1:
        overlap = int(seq_len * 0.875)

    data = get_dataset_fn(dataset)(split, **{"device": device, **(dataset_kwargs or {})})
    rows: List[Dict[str, Any]] = []
    total_nll, total_tokens = 0.0, 0
    for item in data:
        spec, gold = item["process_fn"](item)
        log_probs = streamer.logits(np.asarray(spec), seq_len=seq_len, overlap=overlap)
        text = decoder(log_probs) if target == "hypothesis" else gold
        ids = tokenizer.encode(text)
        if not ids:
            continue
        nll = float(ctc_loss(
            torch.as_tensor(log_probs, dtype=torch.float32, device=device)[None],
            torch.as_tensor(ids, dtype=torch.long, device=device)[None],
            torch.tensor([log_probs.shape[0]], device=device),
            torch.tensor([len(ids)], device=device),
        ))
        rows.append({
            "recording": item["id"],
            "nll": nll,
            "tokens": len(ids),
            "frames": int(log_probs.shape[0]),
            "nll_per_token": nll / len(ids),
        })
        total_nll += nll
        total_tokens += len(ids)
        if verbose:
            print(f"{item['id']}: nll/token {nll / len(ids):.4f}")
    return {
        "dataset": dataset,
        "split": split,
        "target": target,
        # the reference's final_loss = sum(losses) / sum(target_lengths)
        "nll_per_token": total_nll / max(total_tokens, 1),
        "rows": rows,
    }
