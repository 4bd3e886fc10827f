"""Dynamic evaluation: per-recording test-time adaptation on pseudo-labels
(counterpart of lcasr_tpu/evaluation/dynamic_eval.py).

For each recording: chunk as the moving-window decode chunks; for each of
`epochs` passes over the chunks, decode greedy pseudo-labels from the clean
chunk, take the CTC loss of `num_negatives` SpecAugmented copies against
them (divided by frames x num_negatives), and take a MADGRAD step.  The
clean chunk's log-probs (from the forward before that chunk's step) are
merged with the usual overlap averaging.

The JAX function never changes the caller's variables.  A torch model is
changed in place by its optimizer, so every parameter and buffer is saved
before the recording and copied back after it, bit for bit.  The
adaptation forward runs the norms as inference does (running statistics,
no update) while autograd records it, as the JAX step differentiates an
eval-mode apply; on the card its attention backward is K3.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch

from lcasr_torch.data.augmentation import SpecAugment
from lcasr_torch.decoding.greedy import GreedyCTCDecoder
from lcasr_torch.ops.ctc import ctc_loss
from lcasr_torch.optim.madgrad import MADGRAD

DEFAULT_SPEC_AUGMENT = {
    "n_time_masks": 2,
    "n_freq_masks": 3,
    "freq_mask_param": 42,
    "time_mask_param": -1,
    "min_p": 0.05,
    "zero_masking": False,
}


@contextlib.contextmanager
def restored(model: torch.nn.Module):
    """Every parameter and buffer of `model` as it was on entry, bit for bit,
    once the block ends; the parameters' gradients are cleared."""
    saved = {k: v.detach().clone() for k, v in model.state_dict().items()}
    try:
        yield model
    finally:
        with torch.no_grad():
            model.load_state_dict(saved)
        for p in model.parameters():
            p.grad = None


def pseudo_labels(decoder, tokenizer, clean_lp: np.ndarray, rows: int, bucket: int):
    """Greedy pseudo-labels of one clean decode as (rows, U) ids padded with
    the tokenizer's pad id (U a multiple of `bucket`) and their lengths.
    An empty decode gives empty targets: the step still runs, on blank
    supervision alone."""
    text = decoder(clean_lp)
    ids = tokenizer.encode(text) if text else []
    U = max(bucket, -(-len(ids) // bucket) * bucket)
    pseudo = np.full((rows, U), tokenizer.pad_id(), np.int64)
    pseudo[:, : len(ids)] = ids
    return torch.from_numpy(pseudo), torch.full((rows,), len(ids), dtype=torch.int64)


def adapt_step(model, optimizer, batch: torch.Tensor, lengths: torch.Tensor,
               pseudo: torch.Tensor, pseudo_len: torch.Tensor, num_negatives: int,
               blank_id: int) -> torch.Tensor:
    """One MADGRAD step on the CTC loss of the first `num_negatives` rows of
    `batch` against `pseudo`, divided by rows x frames."""
    out = model(batch, length=lengths)
    lp = out["final_posteriors"][:num_negatives].float()
    loss = ctc_loss(lp, pseudo, out["length"][:num_negatives], pseudo_len,
                    blank_id=blank_id) / (lp.shape[0] * lp.shape[1])
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


def dynamic_eval_ctc_loss(
    model,
    spec: np.ndarray,  # (1, 80, T)
    seq_len: int,
    overlap: int,
    tokenizer,
    num_negatives: int = 2,
    epochs: int = 1,
    lr: float = 8e-5,
    spec_augment_config: Optional[Dict] = None,
    subsampling_factor: int = 8,
    seed: int = 0,
    shuffle: bool = False,
) -> np.ndarray:
    """(frames, classes) log-probs of the adapted decode; the model is left
    as it was."""
    spec_n = spec.shape[-1]
    n_classes = tokenizer.vocab_size() + 1
    blank_id = n_classes - 1
    if seq_len > spec_n:
        seq_len, overlap = spec_n, 0
    if overlap % subsampling_factor:
        raise ValueError(f"overlap {overlap} is not a multiple of {subsampling_factor}")
    device = next(model.parameters()).device
    augmentation = SpecAugment(**(spec_augment_config or DEFAULT_SPEC_AUGMENT))
    decoder = GreedyCTCDecoder(tokenizer, blank_id=blank_id)

    # chunk exactly like the moving-window decode
    chunks = {}
    last_ulen, kill_next = None, False
    for i in range(0, spec_n, seq_len - overlap):
        chunk = spec[:, :, i : i + seq_len]
        u_len = chunk.shape[-1]
        if kill_next:
            break
        if last_ulen is not None and u_len < last_ulen:
            kill_next = True
        last_ulen = u_len
        if u_len < seq_len:
            chunk = np.pad(chunk, ((0, 0), (0, 0), (0, seq_len - u_len)))
        chunks[i] = (chunk, u_len)

    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    model_outputs = {}
    with restored(model):
        optimizer = MADGRAD(model.parameters(), lr=lr)
        for _ in range(epochs):
            order = list(chunks)
            if shuffle:
                rng.shuffle(order)
            for i in order:
                chunk, u_len = chunks[i]
                audio = torch.as_tensor(np.asarray(chunk, np.float32), device=device)
                with torch.no_grad():
                    out = model(audio, length=torch.full((1,), u_len, dtype=torch.int32,
                                                         device=device))
                n_valid = int(out["length"][0])
                clean_lp = out["final_posteriors"][0, :n_valid].double().cpu().numpy()
                pseudo, pseudo_len = pseudo_labels(decoder, tokenizer, clean_lp,
                                                   num_negatives, 64)
                reps = audio.repeat(num_negatives + 1, 1, 1)
                lengths = torch.full((num_negatives + 1,), u_len, dtype=torch.int32,
                                     device=device)
                aug = augmentation(gen, reps[:num_negatives], lengths[:num_negatives])
                batch = torch.cat([aug, reps[num_negatives:]], dim=0)
                adapt_step(model, optimizer, batch, lengths, pseudo.to(device),
                           pseudo_len.to(device), num_negatives, blank_id)
                model_outputs[i] = {"probs": np.exp(clean_lp), "ds_len": n_valid,
                                    "overlap_ds": int(overlap / (u_len / n_valid))}

    total = spec_n // subsampling_factor + seq_len // subsampling_factor + 16
    all_logits = np.zeros((total, n_classes), np.float64)
    count = np.zeros((total, 1), np.float64)
    pos = 0
    for i in sorted(model_outputs):
        mo = model_outputs[i]
        if i != 0:
            pos -= mo["overlap_ds"]
        all_logits[pos : pos + mo["ds_len"]] += mo["probs"]
        count[pos : pos + mo["ds_len"]] += 1
        pos += mo["ds_len"]
    seen = count[:, 0] != 0
    return np.log(all_logits[seen] / count[seen]).astype(np.float32)
