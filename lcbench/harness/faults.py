"""Faults planted under the timed path, to show that `correct` comes out false
when the program is wrong: the tests run them at a small size on the CPU,
and `run.py --fault` reads them on the card at a cell's own size.  No
benchmark run plants one.

  answer_altered   decode: one row of a recording's averaged probabilities
                   moved onto its least likely class, where they are made;
  half_batch       decode: each window group runs its first half of windows
                   only, and the rows average over those; train: each chunk
                   keeps its first half of rows, their loss doubled, the
                   mean taken over the rest;
  state_unchanged  train: the optimizer's step returns the state as it was.
"""
from __future__ import annotations

import contextlib

FAULTS = ("answer_altered", "half_batch", "state_unchanged")


@contextlib.contextmanager
def planted(name):
    """Plant the fault `name` (None: nothing) for as long as the context is open."""
    if name is None:
        yield
        return
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}: one of {FAULTS}")
    from lcasr_torch.evaluation.streaming import StreamingDecoder
    from lcasr_torch.optim.madgrad import MADGRAD
    from lcasr_torch.training.trainer import Trainer

    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, owner.__dict__[attr]))
        setattr(owner, attr, value)

    if name == "answer_altered":
        run = StreamingDecoder._run

        def altered(self, spec, seq_len, overlap):
            probs = run(self, spec, seq_len, overlap).clone()
            row = probs.shape[0] // 2
            least = probs[row].argmin()
            probs[row] = 0.0
            probs[row, least] = 1.0
            return probs

        patch(StreamingDecoder, "_run", altered)
    elif name == "half_batch":
        group = StreamingDecoder._accumulate_group
        micro = Trainer.micro_step

        def half_group(self, spec_dev, base, grp, offsets, n_valid, seq_len, W, sums, counts):
            k = max(1, len(grp) // 2)
            return group(self, spec_dev, base, grp[:k], offsets[:k], n_valid[:k], seq_len,
                         W, sums, counts)

        def half_rows(self, chunk, augment=False):
            k = max(1, chunk["audio"].shape[0] // 2)
            half = {key: v[:k] for key, v in chunk.items()}
            half["weight"] = half["weight"] * (chunk["audio"].shape[0] / k)
            return micro(self, half, augment)

        patch(StreamingDecoder, "_accumulate_group", half_group)
        patch(Trainer, "micro_step", half_rows)
    else:
        patch(MADGRAD, "step", lambda self, closure=None: None)
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)
