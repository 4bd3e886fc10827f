"""LR schedule + sequence-length warmup manager (the port's copy of
lcasr_tpu/optim/scheduling.py; pure Python).

Counterparts of reference `lcasr/utils/scheduling.py`:

* `CosineLRScheduler` (`:3-29`): linear warmup counted in optimizer *steps*;
  once warmup finishes, the schedule is re-based to cosine decay counted in
  *podcasts seen* (recordings), with an offset so the cosine starts at its
  peak at the switch-over point (interplay at reference
  `exp/train.py:203-207,319-320`).

* `SequenceWarmupManager` (`:33-98`): after `increase_every` recordings,
  sequence length ×= multiplier (default 2) and batch size ×= 0.5, until
  `max_sequence_length` — THE long-context training mechanism (512 frames
  → 360k frames over one epoch).

Both are host-side Python state machines (they gate bucket changes and
dataloader rebuilds); the scheduler exposes its current LR as a plain
float that `optim.factory.set_learning_rate` writes into the optimizer.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple


class CosineLRScheduler:
    def __init__(self, warmup_steps: int, peak_value: float, final_value: float):
        self.is_warmup = True
        self.warmup_steps = warmup_steps
        self.peak_value = peak_value
        self.final_value = final_value
        self.offset = 0
        self.steps = 1
        self.last_epoch = 0
        # torch _LRScheduler.__init__ runs an initial step() at last_epoch=0
        self._last_lr = self._compute_lr()

    def is_warming_up(self) -> bool:
        return self.is_warmup and self.last_epoch < self.warmup_steps

    def set_cosine_schedule(self, total_recordings: int, cur_podcast: int) -> None:
        """Switch from warmup to cosine, re-based on recordings seen.

        Reference-parity detail (found by the cross-framework trajectory
        test): torch's `_LRScheduler.get_last_lr()` returns the lr CACHED at
        the last `.step()` call — it is NOT recomputed when
        set_cosine_schedule rewrites last_epoch/offset.  So for the rest of
        the current podcast batch the reference keeps training at the final
        warmup lr (= peak), and the cosine value first takes effect at the
        batch-end `step(epoch=cur_podcast)`.  We reproduce that by caching
        `_last_lr` and leaving it untouched here."""
        self.last_epoch = 0
        self.is_warmup = False
        self.steps = total_recordings - cur_podcast + 1
        self.offset = -cur_podcast

    def _compute_lr(self) -> float:
        if self.is_warmup:
            return self.peak_value * min(1.0, self.last_epoch / max(1, self.warmup_steps))
        return self.final_value + 0.5 * (self.peak_value - self.final_value) * (
            1 + math.cos((self.last_epoch + self.offset) / self.steps * math.pi)
        )

    def get_last_lr(self) -> float:
        """The lr as of the last step() — torch `_LRScheduler` caching
        semantics (the optimizer's param_group lr is likewise only written
        on step() upstream)."""
        return self._last_lr

    def step(self, epoch: int | None = None) -> float:
        """During warmup call with no args per optimizer step; after warmup
        call with epoch=cur_podcast per batch (reference exp/train.py:319-320)."""
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self._last_lr = self._compute_lr()
        return self._last_lr

    def state_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        if "_last_lr" not in state:  # checkpoints from before the lr cache
            self._last_lr = self._compute_lr()


class SequenceWarmupManager:
    def __init__(
        self,
        increase_every: int,  # -1 to disable
        stop_after: int,
        start_after: int,
        initial_sequence_length: int,
        initial_batch_size: int,
        max_sequence_length: int,
        increase_by_multiplier: float = 2.0,
        batch_size_multiplier: float = 0.5,
        cur_position: int = 0,
        steps_since_last_increase: int = 0,
        **kwargs,
    ):
        self.increase_every = increase_every
        self.stop_after = stop_after
        self.start_after = start_after
        self.max_sequence_length = max_sequence_length
        self.increase_by_multiplier = increase_by_multiplier
        self.cur_position = cur_position
        self.batch_size_multiplier = batch_size_multiplier
        self.cur_sequence_length = initial_sequence_length
        self.cur_batch_size = initial_batch_size
        self.steps_since_last_increase = steps_since_last_increase

    def _increase(self, next_seq_len: int) -> Tuple[bool, int, int]:
        self.steps_since_last_increase = 0
        self.cur_sequence_length = next_seq_len
        self.cur_batch_size = max(int(self.cur_batch_size * self.batch_size_multiplier), 1)
        return True, self.cur_sequence_length, self.cur_batch_size

    def step(self, steps: int = 1) -> Tuple[bool, int, int]:
        """Advance by `steps` recordings; returns (updated, seq_len, batch)."""
        noop = (False, self.cur_sequence_length, self.cur_batch_size)
        if self.increase_every == -1:
            return noop
        next_seq_len = max(int(self.cur_sequence_length * self.increase_by_multiplier), 1)

        self.cur_position += steps
        if self.cur_position < self.start_after:
            return noop
        if (
            self.cur_position >= self.stop_after
            and self.steps_since_last_increase < self.increase_every / 2
        ):
            return noop
        if self.cur_sequence_length * self.increase_by_multiplier > self.max_sequence_length:
            if self.cur_sequence_length != self.max_sequence_length:
                next_seq_len = self.max_sequence_length
            else:
                return noop
        elif (
            self.cur_position >= self.stop_after
            and self.steps_since_last_increase >= self.increase_every / 2
        ):
            return self._increase(next_seq_len)

        self.steps_since_last_increase += steps
        if self.steps_since_last_increase >= self.increase_every:
            return self._increase(next_seq_len)
        return noop

    def state_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
