"""The meta-gradient-prediction trainer (counterpart of
lcasr_tpu/training/meta.py).

Trains only the meta branch of `SCConformerMeta` to predict the gradient of
the CTC loss with respect to the encoder's representations:

  * the encoder runs in training mode (its batch statistics move, as the
    JAX step's mutable `batch_stats` do) under no_grad: nothing of its graph
    is kept, as JAX's `stop_gradient` keeps nothing;
  * `repr_grads = d ctc_loss / d reprs`, from the decoder head alone;
  * the meta branch predicts them from (logits, initial signal); objective
    l2 | mse | cosine, normalised by batch_size x chunk_size x 6 (the
    reference's divisor, from the config);
  * a control loss against row-permuted true gradients (`meta_loss_2`) and
    the mean cosine dissimilarity (`cosim`) are logged each step;
  * the optimizer (global-norm clip + MADGRAD by default) holds the meta
    parameters only, so every other parameter keeps its bits.

The permutation of the control loss comes from the trainer's own
`torch.Generator` (JAX draws it with `jax.random.permutation`); `step`
takes one from the caller to compare the two.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from lcasr_torch.config import Config
from lcasr_torch.device import resolve_device
from lcasr_torch.models.base import decay_mask
from lcasr_torch.models.sconformer_meta import SCConformerMeta, meta_param_mask
from lcasr_torch.ops.ctc import ctc_loss
from lcasr_torch.optim.factory import build_optimizer, set_learning_rate
from lcasr_torch.optim.scheduling import CosineLRScheduler
from lcasr_torch.training.metrics import MetricsLogger


def _cos_sim(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    an = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True).clamp_min(eps)
    bn = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True).clamp_min(eps)
    return (an * bn).sum(-1)


def make_meta_loss_fn(kind: str):
    """(a, b, d) -> loss over (rows, V) inputs; `d` is the divisor."""
    if kind == "l2":
        return lambda a, b, d: torch.sqrt(((a - b) ** 2).sum(-1) + 1e-12).sum() / d
    if kind == "mse":
        return lambda a, b, d: ((a - b) ** 2).sum() / d
    if kind == "cosine":
        return lambda a, b, d: (1.0 - _cos_sim(a, b)).mean()
    raise ValueError(f"unknown meta loss {kind!r}")


class MetaTrainer:
    """Utterance-level meta training of a `SCConformerMeta`."""

    def __init__(self, config: Config, model: SCConformerMeta, tokenizer,
                 checkpoint_dir: Optional[str] = None, device=None, seed: int = 999):
        self.config = config
        self.model = model
        self.tokenizer = tokenizer
        self.device = resolve_device(device)
        tr = config.get("training", Config({}))
        self.loss_kind = tr.get("loss", "l2")
        self.loss_fn = make_meta_loss_fn(self.loss_kind)
        self.clip_value = tr.get("clip_value", 0.8)
        self.max_epochs = tr.get("max_epochs", 1)
        self.batch_size = tr.get("batch_size", 2)
        self.chunk_size = config.get("audio_chunking", Config({})).get("size", 2048)
        self.norm_div = float(self.batch_size * self.chunk_size * 6)
        self.blank_id = tokenizer.vocab_size() if tokenizer is not None else model.vocab_size
        opt_cfg = config.get("optimizer", Config({}))
        self.opt_args = opt_cfg.get("args", Config({}))
        self.optimizer_name = opt_cfg.get("name", "madgrad")
        sched = config.get("scheduler", Config({}))
        self.scheduler = CosineLRScheduler(
            warmup_steps=sched.get("warmup_steps", 0),
            peak_value=self.opt_args.get("lr", 1e-3),
            final_value=sched.get("final_value", 0.0))  # the reference decays to zero
        self.metrics = MetricsLogger(
            log_dir=checkpoint_dir or "./checkpoints",
            use_wandb=config.get("wandb", Config({})).get("use", False))
        self.seed = seed
        self.optimizer = None

    def init_state(self) -> "MetaTrainer":
        """The optimizer over the meta parameters (clip and decay included:
        of the meta branch only its norm scales decay), and the generator
        of the control loss's permutations."""
        trainable = meta_param_mask(self.model)
        decay = decay_mask(self.model)
        named = [(n, p) for n, p in self.model.named_parameters() if trainable[n]]
        self.meta_params = [p for _, p in named]
        self.optimizer = build_optimizer(
            named, self.optimizer_name, lr=self.opt_args.get("lr", 1e-3),
            weight_decay=self.opt_args.get("weight_decay", 0.0), clip_value=self.clip_value,
            weight_decay_mask={n: decay[n] for n, _ in named})
        self.generator = torch.Generator().manual_seed(self.seed)
        return self

    def step(self, audio: torch.Tensor, audio_lengths: torch.Tensor, labels: torch.Tensor,
             label_lengths: torch.Tensor, perm: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        """One optimizer step of the meta branch; returns the step's
        meta_loss_1, meta_loss_2, cosim, original_loss and blank_p (device
        scalars).  `perm`: the rows' permutation of the control loss."""
        model = self.model
        with torch.no_grad():
            enc = model.encode(audio, audio_lengths, train=True)
        reprs = enc["reprs"].detach().requires_grad_(True)
        with torch.enable_grad():
            original_loss = ctc_loss(model.decode_reprs(reprs), labels, enc["length"],
                                     label_lengths, blank_id=self.blank_id)
            (repr_grads,) = torch.autograd.grad(original_loss, reprs)
        with torch.no_grad():
            logits = model.decode_reprs(reprs.detach(), return_logits=True)
        a = repr_grads.reshape(-1, repr_grads.shape[-1]).float()
        gp = model.meta_predict(logits, enc["initial_signal"], enc["lengths_arg"], train=True)
        b = gp.float().reshape(-1, gp.shape[-1])
        meta_loss_1 = self.loss_fn(a, b, self.norm_div)
        grads = torch.autograd.grad(meta_loss_1, self.meta_params, allow_unused=True)
        for p, g in zip(self.meta_params, grads):
            p.grad = g if g is not None else torch.zeros_like(p)  # JAX's zero gradient
        with torch.no_grad():
            if perm is None:
                perm = torch.randperm(a.shape[0], generator=self.generator)
            meta_loss_2 = self.loss_fn(a[perm.to(a.device)], b, self.norm_div)
            cosim = (1.0 - _cos_sim(a, b)).mean()
            blank_p = (logits.argmax(-1) == self.blank_id).float().mean()
        self.optimizer.step()
        self.optimizer.zero_grad()
        return {"meta_loss_1": meta_loss_1.detach(), "meta_loss_2": meta_loss_2,
                "cosim": cosim, "original_loss": original_loss.detach(), "blank_p": blank_p}

    def train_utterances(self, dataloader, epochs: Optional[int] = None) -> int:
        """Epochs over utterance batches (audio padded to a multiple of 256
        frames, labels to a multiple of 16, as the JAX loop pads them);
        returns the number of steps."""
        if self.optimizer is None:
            self.init_state()
        step = 0
        for epoch in range(epochs if epochs is not None else self.max_epochs):
            for batch in dataloader:
                a = np.asarray(batch["audio"], np.float32)
                audio = np.zeros((a.shape[0], 80, -(-a.shape[-1] // 256) * 256), np.float32)
                audio[:, :, : a.shape[-1]] = a
                t = np.asarray(batch["text"], np.int64)
                labels = np.zeros((t.shape[0], -(-t.shape[-1] // 16) * 16), np.int64)
                labels[:, : t.shape[-1]] = t
                lr = self.scheduler.step()
                set_learning_rate(self.optimizer, lr)
                dev = self.device
                out = self.step(
                    torch.from_numpy(audio).to(dev),
                    torch.as_tensor(np.asarray(batch["audio_lengths"]), dtype=torch.int32,
                                    device=dev),
                    torch.from_numpy(labels).to(dev),
                    torch.as_tensor(np.asarray(batch["text_lengths"]), dtype=torch.int32,
                                    device=dev))
                frames = max(int(np.asarray(batch["audio_lengths"]).sum()), 1)
                step += 1
                self.metrics.log({
                    "meta_loss_1": float(out["meta_loss_1"]),
                    "meta_loss_2": float(out["meta_loss_2"]),
                    "cosim": float(out["cosim"]),
                    "original_loss": float(out["original_loss"]) / frames * 100,
                    "blank_p": float(out["blank_p"]),
                    "learning_rate": lr,
                    "epoch": epoch,
                    "utterance_step": step,
                })
        return step
