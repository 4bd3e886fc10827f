"""Chunked long-form CTC training loop on one GPU (counterpart of
lcasr_tpu/training/trainer.py `make_chunks` and `Trainer.train`).

  * one batch = a set of whole podcasts; `make_chunks` splits them into
    chunk_size-frame windows trained in order, padded to a static
    (batch, 80, chunk_size) shape; finished samples stay in the batch with
    weight 0;
  * gradient accumulation: `backwards_every` chunks form a group whose
    gradient is folded in with weight 100 * group / (chunk * batch), and an
    optimizer step follows every `backprop_every` chunks (and at the end
    of the batch);
  * the loss is logged per acoustic frame with the live-frame blank
    probability; a non-finite loss zeroes every pending gradient, keeps the
    BatchRenorm statistics of before the chunk, and 100 in a row abort;
  * the learning rate warms up by optimizer steps and then follows a
    cosine over recordings; the SequenceWarmupManager doubles the chunk
    and halves the batch, rebuilding the dataloader (and bumping the
    rotary interpolation factor when asked);
  * save / resume with the JAX package's `meta.json` contract;
  * `train_utterances`: presegmented utterance batches
    (`data/utterances.py`), one optimizer step a batch;
  * `debug_hooks = True` logs the accumulated gradient's per-parameter
    statistics before each optimizer step (`training/debug_hooks.py`);
  * `training.loss_mode: enc_dec` trains the encoder-decoder family on the
    joint CTC + CE loss (`micro_step`).

Parallelism (`parallel.mesh` or a `mesh=` argument, over the world that
`parallel.maybe_init_distributed` joined; one process per GPU):
  * data: B is padded to a multiple of `data` with weight-0 rows and each
    rank takes its rows; the loss is each rank's share of the global sum
    (normalised by global counts under enc_dec), batch-renorm statistics
    are summed over `data`, the gradient is accumulated in one flat buffer
    and all-reduced once per optimizer step, then clipped by the global
    norm;
  * seq (context parallelism, SCConformerXL): each rank also takes its
    time shard of every chunk (`context_parallel_apply`); the log-probs
    are gathered over `seq` for the CTC loss, which every seq rank
    computes alike;
  * model (tensor parallelism, SCConformerXL): the model is cut into this
    rank's shard (`parallel/tensor_parallel.py`);
  * `parallel.zero_optimizer`: the parameters are views of one flat
    buffer, the gradient buffer is reduce-scattered into each rank's range
    of it and the optimizer state kept for that range only
    (`optim/zero.py`).
Only rank 0 writes metrics and checkpoints, and a checkpoint holds whole
tensors whatever the mesh.  A mesh that asks for more ranks than the world
has runs on one device, as the JAX trainer does.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from lcasr_torch.config import Config
from lcasr_torch.data.augmentation import SpecAugment
from lcasr_torch.data.dataloading import (
    chunk_spectogram,
    chunk_text_json,
    reset_seen_ids,
)
from lcasr_torch.device import resolve_device
from lcasr_torch.models.base import decay_mask
from lcasr_torch.ops.conv import BatchRenorm
from lcasr_torch.ops.ctc import ctc_loss
from lcasr_torch.optim.factory import build_optimizer, param_groups, set_learning_rate
from lcasr_torch.optim.scheduling import CosineLRScheduler, SequenceWarmupManager
from lcasr_torch.optim.zero import ZeroShards, flat_buffer
from lcasr_torch.parallel.collectives import all_reduce_
from lcasr_torch.parallel.cp_model import bind_mesh, context_parallel_apply, shard_time
from lcasr_torch.parallel.mesh import make_mesh, world_size
from lcasr_torch.parallel.partition import (
    gather_state_dict, gather_tensor, shard_state_dict, shard_tensor)
from lcasr_torch.parallel.tensor_parallel import parallelize, refuse_family
from lcasr_torch.training import checkpointing
from lcasr_torch.training.debug_hooks import grad_statistics
from lcasr_torch.training.metrics import MetricsLogger
from lcasr_torch.utils.profiling import span

LABEL_BUCKET = 64


def _bucket(n: int, multiple: int = LABEL_BUCKET) -> int:
    return max(multiple, -(-n // multiple) * multiple)


def make_chunks(audio: np.ndarray, audio_lengths: np.ndarray, txt: List[list], tokenizer,
                chunk_size: int, chunk_overlap: int, pad_id: int) -> List[Dict[str, np.ndarray]]:
    """Chunk a batch of podcasts into fixed-shape training chunks (the JAX
    package's function: static batch, finished samples at weight 0, label
    widths bucketed to multiples of 64, textless chunks skipped).  Each
    chunk's transcripts go through `tokenizer.encode_batch` at once (one
    crossing into the native BPE a chunk)."""
    with span("train.make_chunks"):
        B = audio.shape[0]
        with span("train.chunk_audio"):
            audio_chunks = chunk_spectogram(audio, chunk_size, chunk_overlap)
        with span("train.chunk_text"):
            txt_chunks = [chunk_text_json(t, chunk_size, chunk_overlap, audio.shape[-1])
                          for t in txt]
        culm = np.zeros(B, np.int64)
        out = []
        for ix, chunk in enumerate(audio_chunks):
            active = culm <= audio_lengths
            u_len = chunk.shape[-1]
            cur_lengths = u_len - np.clip(culm + u_len - audio_lengths - chunk_overlap, 0, None)
            cur_lengths = np.clip(cur_lengths, 0, u_len) * active
            live = [b for b in range(B) if active[b]]
            enc = [[] for _ in range(B)]
            with span("train.tokenize"):
                for b, ids in zip(live, tokenizer.encode_batch([txt_chunks[b][ix] for b in live])):
                    enc[b] = ids
            t_lens = np.array([len(e) for e in enc], np.int64)
            if t_lens.max(initial=0) == 0:
                culm += u_len - (chunk_overlap if ix != 0 else 0)
                continue
            with span("train.assemble"):
                labels = np.full((B, _bucket(int(t_lens.max()))), pad_id, np.int64)
                for b, e in enumerate(enc):
                    labels[b, : len(e)] = e
                padded = chunk
                if u_len < chunk_size:
                    padded = np.pad(chunk, ((0, 0), (0, 0), (0, chunk_size - u_len)))
                out.append({
                    "audio": padded.astype(np.float32),
                    "audio_lengths": cur_lengths.astype(np.int32),
                    "labels": labels,
                    "label_lengths": t_lens.astype(np.int32),
                    "weight": (active & (cur_lengths > 0)).astype(np.float32),
                })
            culm += u_len - (chunk_overlap if ix != 0 else 0)
        return out


class _NoMetrics:
    """The metrics sink of ranks other than 0."""

    def log(self, metrics) -> None:
        pass


class Trainer:
    """`Trainer(config, model, tokenizer)`, then `init_state()`, `resume()`
    and `train(dataloader, ...)`.  The model's parameters are the state.
    `device=None` means the GPU and raises without one; the model must be
    on the trainer's device.  `mesh`: a `parallel.Mesh` (else one is built
    from `parallel.mesh` when the world is large enough)."""

    def __init__(self, config: Config, model, tokenizer, checkpoint_dir: Optional[str] = None,
                 device=None, mesh=None):
        self.config = config
        self.model = model
        self.tokenizer = tokenizer
        self.device = resolve_device(device)
        on = next(model.parameters()).device
        if on.type != self.device.type:
            raise ValueError(f"the model is on {on}, the trainer on {self.device}")
        self.optimizer = None

        # the (data, model, seq) mesh: passed in, or built from parallel.mesh
        # when the world has the ranks it needs
        self.mesh = mesh
        par_cfg = config.get("parallel", Config({}))
        mesh_shape = par_cfg.get("mesh", None)
        if self.mesh is None and mesh_shape:
            shape = mesh_shape.to_dict() if hasattr(mesh_shape, "to_dict") else dict(mesh_shape)
            need = int(np.prod([max(1, int(v)) for v in shape.values()]))
            have = world_size()
            if need > have:
                print(f"parallel.mesh {shape} needs {need} devices, have {have} — "
                      f"running single-device")
            elif dist.is_available() and dist.is_initialized():
                self.mesh = make_mesh(shape)
        self.zero_opt = bool(par_cfg.get("zero_optimizer", False)) and self.mesh is not None
        mesh = self.mesh
        self.dp, self.tp, self.cp = ((mesh.size("data"), mesh.size("model"), mesh.size("seq"))
                                     if mesh is not None else (1, 1, 1))
        self.is_main = mesh is None or mesh.rank == 0
        self._zero = None  # ZeroShards under zero_optimizer

        tr = config.get("training", Config({}))
        # 'ctc' (SCConformerXL, Mamba) or 'enc_dec' (the joint loss of the
        # encoder-decoder family)
        self.loss_mode = tr.get("loss_mode", "ctc")
        self.ctc_loss_weight = config.get("model", Config({})).get("ctc_loss_weight", 0.5)
        self.backprop_every = tr.get("backprop_every", 1)
        self.backwards_every = tr.get("backwards_every", 1)
        assert self.backprop_every >= self.backwards_every
        self.clip_value = tr.get("clip_value", 0.8)
        # accepted for the config's sake: the CTC value and gradient do not
        # depend on it (ops/ctc.py)
        self.ctc_segment_size = tr.get("ctc_segment_size", None)
        self.max_epochs = tr.get("max_epochs", 1)
        self.batch_size = tr.get("batch_size", 2)
        self.chunk_size = config.get("audio_chunking", Config({})).get("size", 2048)
        self.chunk_overlap = 0
        self.blank_id = tokenizer.vocab_size()

        opt_cfg = config.get("optimizer", Config({}))
        self.opt_args = opt_cfg.get("args", Config({}))
        self.optimizer_name = opt_cfg.get("name", "madgrad")
        self.weight_decay_groups = opt_cfg.get("weight_decay_groups", "default")
        if self.weight_decay_groups not in ("default", "none"):
            raise NotImplementedError(
                f"Unknown weight_decay_groups {self.weight_decay_groups}, "
                f"must be one of [default, none]")

        sched_cfg = config.get("scheduler", Config({}))
        self.scheduler = CosineLRScheduler(
            warmup_steps=sched_cfg.get("warmup_steps", 0),
            peak_value=self.opt_args.get("lr", 1e-3),
            final_value=sched_cfg.get("final_value", 0.0),
        )
        self.sequence_scheduler = None
        if "sequence_scheduler" in config:
            self.sequence_scheduler = SequenceWarmupManager(
                initial_batch_size=self.batch_size,
                initial_sequence_length=self.chunk_size,
                **config["sequence_scheduler"].to_dict(),
            )
            self.chunk_size = self.sequence_scheduler.cur_sequence_length
            self.batch_size = self.sequence_scheduler.cur_batch_size

        if mesh is not None:
            # every rank starts from rank 0's weights (a model built without
            # a seed differs from rank to rank)
            with torch.no_grad():
                for t in list(model.parameters()) + list(model.buffers()):
                    dist.broadcast(t, src=0)
            if self.tp > 1:
                parallelize(model, mesh)
            if self.cp > 1:
                refuse_family(model, "context parallelism")
                if self.loss_mode != "ctc":
                    raise ValueError("context-parallel training supports loss_mode='ctc' only")
                sf = getattr(model, "subsampling_factor", 8)
                if self.chunk_size % (self.cp * sf):
                    raise ValueError(f"audio_chunking.size={self.chunk_size} must divide seq "
                                     f"shards ({self.cp}) x subsampling factor ({sf})")
            # batch statistics over the global batch (context_parallel_apply
            # adds the seq axis at each micro step)
            bind_mesh(model, mesh, stat_axes=("data",))
        # the micro step runs the model on this rank's time shard through
        # context_parallel_apply: on whenever seq > 1 (a mesh of one may set
        # it to run that path's collectives at size 1)
        self.context_parallel = self.cp > 1

        self.augmentation = None
        if "spec_augment" in config:
            self.augmentation = SpecAugment(**config["spec_augment"].to_dict())
        self.start_augment_after_n_epochs = tr.get("start_spec_augment_after_n_epochs", -1)
        if self.augmentation is not None and self.start_augment_after_n_epochs == -1:
            import warnings

            warnings.warn("spec_augment is configured but "
                          "training.start_spec_augment_after_n_epochs is unset/-1 — "
                          "augmentation will NEVER be applied", stacklevel=2)
        self.augment_generator = torch.Generator(device=self.device).manual_seed(999)

        model_cfg = config.get("model", Config({}))
        self.rotary_interp_bump = bool(
            model_cfg.get("use_rotary", False)
            and config.get("sequence_scheduler", Config({})).get("interpolate_rotary", False))
        self.rotary_interpolation_factor = model_cfg.get("rotary_interpolation_factor", 1.0)

        self.checkpoint_dir = checkpoint_dir or config.get(
            "checkpointing", Config({})).get("dir", "./checkpoints")
        self.metrics = MetricsLogger(
            log_dir=self.checkpoint_dir,
            use_wandb=config.get("wandb", Config({})).get("use", False),
            wandb_config=config.get("wandb", Config({})).to_dict() if "wandb" in config else None,
        ) if self.is_main else _NoMetrics()
        self._acc: Dict[torch.nn.Parameter, torch.Tensor] = {}
        # under a mesh: the accumulated gradient in one flat buffer (the
        # layout of optim/zero.py), `_acc` its views
        self._flat_acc: Optional[torch.Tensor] = None
        self._acc_started = False
        self.debug_hooks = False  # per-parameter gradient statistics (-debug_hooks)

    # -- state ----------------------------------------------------------------
    def init_state(self) -> None:
        """Build the optimizer over the model's parameters (under
        zero_optimizer: over this rank's slices of them)."""
        named = list(self.model.named_parameters())
        mask = decay_mask(self.model) if self.weight_decay_groups == "default" else None
        wd = self.opt_args.get("weight_decay", 0.0)
        if self.zero_opt:
            named = [(n, p) for n, p in named if p.requires_grad]
            self._zero = ZeroShards([p for _, p in named], self.mesh.axis("data"))
            # the parameters' names in the buffer's order, and in the groups
            # and the order of an optimizer without ZeRO (for checkpoints)
            self._trainable_names = [n for n, _ in named]
            self._whole_groups = [g["params"] for g in
                                  param_groups([(n, n) for n, _ in named], wd, mask)]
            self._whole_names = [n for g in self._whole_groups for n in g]
            named = [(named[i][0], torch.nn.Parameter(v))
                     for (i, _, _), v in zip(self._zero.pieces, self._zero.local())]
            self._zero_slices = [p for _, p in named]
        self.optimizer = build_optimizer(
            named,
            name=self.optimizer_name,
            lr=self.opt_args.get("lr", 1e-3),
            weight_decay=wd,
            momentum=self.opt_args.get("momentum", 0.9),
            clip_value=self.clip_value,
            weight_decay_mask=mask,
        )
        # names of the optimizer's state indices, in its order
        name_of = {id(p): n for n, p in named}
        self._opt_names = [name_of[id(p)] for g in self.optimizer.param_groups
                           for p in g["params"]]

    def _params(self):
        return [p for p in self.model.parameters() if p.requires_grad]

    def _stat_buffers(self) -> List[torch.Tensor]:
        return [b for m in self.model.modules() if isinstance(m, BatchRenorm)
                for b in (m.running_mean, m.running_std, m.num_batches_tracked)]

    # -- steps ----------------------------------------------------------------
    def _upload(self, x: np.ndarray) -> torch.Tensor:
        """A host array on the trainer's device.  To the GPU through pinned
        memory (PyTorch's caching host allocator) and without blocking the
        host, so the copy runs while the host goes on."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _rank_rows(self, chunk: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Under a mesh: B padded to a multiple of `data` with weight-0 rows
        (length 0: no loss, no batch statistics), then this rank's rows."""
        d, i = self.dp, self.mesh.index("data")
        B = chunk["audio"].shape[0]
        pad = (-B) % d
        rows = (B + pad) // d
        out = {}
        for k, v in chunk.items():
            if pad:
                v = np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)], axis=0)
            out[k] = v[i * rows:(i + 1) * rows]
        return out

    def _data_sum(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """A value summed (or reduced by `op`) over the data axis; itself
        without a mesh."""
        if self.mesh is None:
            return x
        return all_reduce_(x.detach().clone(), self.mesh.group("data"), op)

    def micro_step(self, chunk: Dict[str, np.ndarray], augment: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Forward and backward of one chunk; the raw gradient of its
        weighted CTC sum (under `enc_dec`: of its joint loss) adds into
        `p.grad`.  Returns (loss, blank_p), both still on the device.
        Under a mesh the gradient is this rank's part (the optimizer step
        reduces it) and the loss and blank_p are the whole chunk's."""
        dev = self.device
        if self.mesh is not None:
            chunk = self._rank_rows(chunk)
            if self._flat_acc is None:
                self.zero_pending()
        with span("train.upload"):
            audio, lengths, weight, labels, label_lengths = (self._upload(chunk[k]) for k in (
                "audio", "audio_lengths", "weight", "labels", "label_lengths"))
        if augment and self.augmentation is not None:
            audio = self.augmentation(self.augment_generator, audio, lengths)
        if self.loss_mode == "enc_dec":
            loss = self._enc_dec_loss(audio, lengths, weight, labels, label_lengths)
            loss.backward()
            return self._data_sum(loss.detach()), torch.zeros((), device=dev)
        if self.context_parallel:
            # this rank's time shard, the lengths global; the log-probs are
            # gathered over seq, so every seq rank computes the whole CTC loss
            out = context_parallel_apply(self.model, shard_time(audio, self.mesh), self.mesh,
                                         lengths, train=True, data_axis="data", gather=True)
        else:
            out = self.model(audio, length=lengths, train=True)
        log_probs = out["final_posteriors"].float()
        nll = ctc_loss(log_probs, labels, out["length"], label_lengths,
                       blank_id=self.blank_id, reduction="none",
                       segment_size=self.ctc_segment_size)
        # impossible alignments carry the 1e30 sentinel (zero gradient);
        # keep them out of the loss metric
        nll = torch.where(nll < 1e29, nll, torch.zeros_like(nll))
        loss = (nll * weight).sum()
        loss.backward()
        with torch.no_grad():
            am = log_probs.argmax(-1)
            live = ((torch.arange(am.shape[1], device=dev)[None, :] < out["length"][:, None])
                    & (weight > 0)[:, None])
            counts = self._data_sum(torch.stack([(live & (am == self.blank_id)).sum(),
                                                 live.sum()]).float())
            blank_p = counts[0] / counts[1].clamp_min(1)
        return self._data_sum(loss.detach()), blank_p

    def _enc_dec_loss(self, audio, lengths, weight, labels, label_lengths) -> torch.Tensor:
        """The joint loss of the JAX trainer's `enc_dec` mode, normalised per
        chunk as the reference's compacted batch is: the CTC sum over
        (live rows x the longest subsampled length) x 100, and the CE of the
        shifted targets (eos 0 at `label_lengths`) over (live rows x the
        longest live label + 1), weighted by ctc_loss_weight and 1 - it.
        Dead rows (weight 0) and the label padding count in neither."""
        ctc_w = self.ctc_loss_weight
        text_bos = torch.nn.functional.pad(labels, (1, 0), value=0)  # bos 0
        out = self.model(audio, text_sequence=text_bos, length=lengths, train=True)
        live = weight > 0
        # the whole batch's counts under a mesh: the ranks' losses sum to it
        n_live = self._data_sum(live.sum().float()).clamp_min(1.0)
        n_sub = self._data_sum(out["length"].max().float(),
                               dist.ReduceOp.MAX).clamp_min(1.0)
        loss = torch.zeros((), device=audio.device)
        ctc_out = out["final_posteriors_ctc"]
        if ctc_out is not None and ctc_w > 0:
            nll = ctc_loss(ctc_out.float(), labels, out["length"], label_lengths,
                           blank_id=self.blank_id, reduction="none",
                           segment_size=self.ctc_segment_size)
            nll = torch.where(nll < 1e29, nll, torch.zeros_like(nll))
            loss = loss + ctc_w * (nll * weight).sum() / (n_live * n_sub) * 100.0
        B, U1 = text_bos.shape
        targets = torch.cat([text_bos[:, 1:], torch.zeros_like(text_bos[:, :1])], dim=1)
        pos = torch.arange(U1, device=audio.device)[None, :]
        t_len_bos = label_lengths.long() + 1
        targets = torch.where(pos == (t_len_bos - 1)[:, None], 0, targets)
        valid = (pos < t_len_bos[:, None]) & live[:, None]
        logp = torch.log_softmax(out["final_posteriors_lm"].float(), dim=-1)
        ce = -logp.gather(-1, targets[..., None].long())[..., 0]
        ce_sum = torch.where(valid, ce, torch.zeros_like(ce)).sum()
        u1_ref = (self._data_sum(torch.where(live, label_lengths, 0).max().float(),
                                 dist.ReduceOp.MAX) + 1.0).clamp_min(1.0)
        return loss + (1 - ctc_w) * ce_sum / (n_live * u1_ref)

    @torch.no_grad()
    def fold_group(self, weight: float) -> None:
        """acc += weight * group gradient (the reference's per-group loss
        weight, by linearity), and clear the group gradient."""
        with span("train.fold"):
            if self.mesh is not None:
                return self._fold_flat(weight)
            ps = [p for p in self._params() if p.grad is not None]
            fresh = [p for p in ps if p not in self._acc]
            seen = [p for p in ps if p in self._acc]
            if fresh:  # multi-tensor ops: one launch for all the tensors
                grads = [p.grad for p in fresh]
                torch._foreach_mul_(grads, weight)
                self._acc.update(zip(fresh, grads))
            if seen:
                torch._foreach_add_([self._acc[p] for p in seen], [p.grad for p in seen],
                                    alpha=weight)
            for p in ps:
                p.grad = None

    def _fold_flat(self, weight: float) -> None:
        """fold_group under a mesh: the first group of an optimizer step
        accumulated its gradient in the flat buffer itself (`p.grad` are its
        views), later groups in fresh tensors."""
        params = self._params()
        if not self._acc_started:
            self._flat_acc.mul_(weight)
            self._acc_started = True
        else:
            ps = [p for p in params if p.grad is not None]
            if ps:
                torch._foreach_add_([self._acc[p] for p in ps], [p.grad for p in ps],
                                    alpha=weight)
        for p in params:
            p.grad = None

    def zero_pending(self) -> None:
        if self.mesh is not None:
            # the next backward accumulates into the zeroed flat buffer
            params = self._params()
            if self._flat_acc is None:
                self._flat_acc, views = flat_buffer(params, self.dp if self.zero_opt else 1)
                self._acc = dict(zip(params, views))
            else:
                self._flat_acc.zero_()
            for p in params:
                p.grad = self._acc[p]
            self._acc_started = False
            return
        self._acc = {}
        for p in self._params():
            p.grad = None

    def grad_statistics(self) -> Dict[str, float]:
        """`debug_hooks.grad_statistics` of the accumulated gradient (zeros
        for a parameter that has none, as in the JAX package's tree)."""
        return grad_statistics({
            name: self._acc[p] if p in self._acc else torch.zeros_like(p)
            for name, p in self.model.named_parameters() if p.requires_grad})

    def optimizer_step(self, lr: float) -> None:
        """Clip and apply the accumulated gradient at learning rate lr."""
        with span("train.optimizer_step"):
            if self.mesh is not None:
                return self._mesh_optimizer_step(lr)
            if self.debug_hooks:
                self.metrics.log(self.grad_statistics())
            for p in self._params():
                p.grad = self._acc.get(p)
            set_learning_rate(self.optimizer, lr)
            self.optimizer.step()
            self.zero_pending()

    def _tp_sharded(self) -> List[bool]:
        """Per trainable parameter: is it cut over the model axis?"""
        layout = getattr(self.model, "tp_layout", {})
        out = []
        for name, p in self.model.named_parameters():
            if p.requires_grad:
                prefix, _, leaf = name.rpartition(".")
                mode = layout.get(prefix)
                out.append(mode is not None and not (leaf == "bias" and mode.startswith("row")))
        return out

    def _global_norm(self, grads: List[torch.Tensor], sharded: List[bool]) -> torch.Tensor:
        """The norm of the whole gradient from this rank's pieces: summed
        over data under ZeRO (the pieces partition the parameters), over
        model for the tensors tensor parallelism cuts (`sharded`, one flag
        a gradient); a replicated one counts once."""
        norms = torch.stack(torch._foreach_norm(grads)).float() ** 2
        mask = torch.tensor(sharded, device=norms.device)
        sq = torch.stack([norms[mask].sum(), norms[~mask].sum()])
        if self.zero_opt:
            all_reduce_(sq, self.mesh.group("data"))
        sq[0:1] = all_reduce_(sq[0:1].clone(), self.mesh.group("model"))
        return sq.sum().sqrt()

    @torch.no_grad()
    def _mesh_optimizer_step(self, lr: float) -> None:
        """The accumulated gradient summed over the ranks that hold other
        data (seq, then data: one all-reduce of the flat buffer each, or
        under ZeRO one reduce-scatter over data), clipped by the global
        norm, applied; under ZeRO the updated ranges are all-gathered back
        into the parameters."""
        params = self._params()
        all_reduce_(self._flat_acc, self.mesh.group("seq"))
        if not self.zero_opt:
            all_reduce_(self._flat_acc, self.mesh.group("data"))
        if self.debug_hooks:
            if self.zero_opt or self.tp > 1:
                raise NotImplementedError("debug_hooks under tensor parallelism or ZeRO: the "
                                          "gradient is not whole on any rank")
            self.metrics.log(self.grad_statistics())
        sharded = self._tp_sharded()
        if self.zero_opt:
            targets, grads = self._zero_slices, self._zero.reduce_scatter(self._flat_acc)
            sharded = [sharded[i] for i, _, _ in self._zero.pieces]
        else:
            targets, grads = params, [self._acc[p] for p in params]
        for t, g in zip(targets, grads):
            t.grad = g
        set_learning_rate(self.optimizer, lr)
        self.optimizer.step(norm=self._global_norm(grads, sharded))
        if self.zero_opt:
            self._zero.all_gather()
            for t in targets:
                t.grad = None
        self.zero_pending()

    # -- training loop ----------------------------------------------------------
    def train(self, dataloader, step: int = 0, epoch: int = 0,
              seen_ids: Optional[List[str]] = None) -> None:
        if self.optimizer is None:
            self.init_state()
        cfg = self.config
        seen_ids = list(seen_ids or [])
        pad_id = self.tokenizer.pad_id()
        save_every = cfg.get("checkpointing", Config({})).get("save_every_n_steps", 1000)
        self.zero_pending()

        cur_podcast, last_save = step, step
        total_recordings = dataloader.total_recordings() * self.max_epochs
        nans_in_a_row = 0
        finished = epoch >= self.max_epochs
        data_iter = iter(dataloader)
        rng = random.Random(cfg.get("training", Config({})).get("random_seed", 12345))

        while not finished:
            try:
                with span("train.data_wait"):
                    audio, audio_lengths, txt, ids = next(data_iter)
            except StopIteration:
                epoch += 1
                seen_ids = reset_seen_ids(seen_ids, epoch - 1)
                if epoch >= self.max_epochs:
                    finished = True
                    continue
                dataloader.update(batch_size=dataloader.batch_size, seen_ids=seen_ids,
                                  random_seed=rng.randint(0, 10000))
                data_iter = iter(dataloader)
                continue

            # marked seen before training it, as the reference does
            seen_ids.extend(ids)
            cur_batch_size = audio.shape[0]
            cur_podcast += cur_batch_size
            if cur_podcast - last_save > save_every:
                self.save(cur_podcast, epoch, seen_ids)
                last_save = cur_podcast
                self.metrics.log({"checkpoint_saved": cur_podcast})

            if self.scheduler.is_warmup and not self.scheduler.is_warming_up():
                self.scheduler.set_cosine_schedule(total_recordings=total_recordings,
                                                   cur_podcast=cur_podcast)

            chunks = make_chunks(audio, audio_lengths, txt, self.tokenizer,
                                 self.chunk_size, self.chunk_overlap, pad_id)
            augment = (self.start_augment_after_n_epochs != -1
                       and epoch >= self.start_augment_after_n_epochs
                       and self.augmentation is not None
                       and not self.scheduler.is_warmup)

            cur_loss, cur_frames, steps_since_bw = 0.0, 0, 0
            blank_prob = 0.0
            for ix, chunk in enumerate(chunks):
                with span("train.host_read"):
                    stats = [b.clone() for b in self._stat_buffers()]
                loss, blank_p = self.micro_step(chunk, augment)
                with span("train.host_read"):
                    loss_f, blank_f = float(loss), float(blank_p)
                if not np.isfinite(loss_f):
                    self.metrics.log({"nan": True})
                    with torch.no_grad():  # the chunk's statistics are dropped too
                        for b, old in zip(self._stat_buffers(), stats):
                            b.copy_(old)
                    self.zero_pending()
                    steps_since_bw = 0
                    nans_in_a_row += 1
                    if nans_in_a_row > 100:
                        raise RuntimeError("100 NaNs in a row, aborting")
                    continue
                nans_in_a_row = 0
                blank_prob = blank_f
                cur_loss += loss_f
                cur_frames += int(chunk["audio_lengths"].sum())
                steps_since_bw += 1

                is_last = ix + 1 == len(chunks)
                if (ix + 1) % self.backwards_every == 0 or is_last:
                    self.fold_group(100.0 * steps_since_bw / (self.chunk_size * self.batch_size))
                    steps_since_bw = 0
                if (ix + 1) % self.backprop_every == 0 or is_last:
                    lr = self.scheduler.get_last_lr()
                    self.optimizer_step(lr)
                    if self.scheduler.is_warmup:
                        self.scheduler.step()
                    self.metrics.log({
                        "loss": 100.0 * cur_loss / max(cur_frames, 1),
                        "blank_p": blank_prob,
                        "learning_rate": lr,
                        "sequence_length": self.chunk_size,
                        "batch_size": self.batch_size,
                        "epoch": epoch,
                        "podcast": cur_podcast,
                        "spec_augment": int(augment),
                        "frames": cur_frames,
                    })
                    cur_loss, cur_frames = 0.0, 0

            if not self.scheduler.is_warmup:
                self.scheduler.step(epoch=cur_podcast)

            if self.sequence_scheduler is not None:
                updated, new_seq, new_bs = self.sequence_scheduler.step(steps=cur_batch_size)
                if updated:
                    self.chunk_size = new_seq
                    self.batch_size = new_bs
                    dataloader.update(batch_size=new_bs, seen_ids=seen_ids)
                    data_iter = iter(dataloader)
                    if self.rotary_interp_bump:
                        self.rotary_interpolation_factor *= (
                            self.sequence_scheduler.increase_by_multiplier)
                        self.model.rotary_pos_emb.interpolation_factor = (
                            self.rotary_interpolation_factor)

        self.save(cur_podcast, epoch, seen_ids)

    def train_utterances(self, dataloader, epochs: int = 1) -> int:
        """Utterance-level training (lcasr_tpu `Trainer.train_utterances`,
        after the reference's train_sa.py): one optimizer step a batch of
        presegmented utterances, the gradient weighted by 100 / the batch's
        frames; audio padded to a multiple of 256 frames and labels to a
        multiple of 64; the warmup hands over to the cosine, which then
        runs over the utterances seen.  A non-finite loss skips the batch
        and keeps the running statistics of before it.  Logs `loss`,
        `blank_p`, `learning_rate`, `epoch` and `utterance_step`; returns
        the number of optimizer steps."""
        if self.optimizer is None:
            self.init_state()
        if hasattr(dataloader, "total_recordings"):
            total = dataloader.total_recordings() * epochs
        else:  # a plain list of batches
            total = max(1, len(dataloader)) * epochs
        step = seen = 0
        self.zero_pending()
        for epoch in range(epochs):
            for batch in dataloader:
                if self.scheduler.is_warmup and not self.scheduler.is_warming_up():
                    self.scheduler.set_cosine_schedule(total_recordings=total, cur_podcast=seen)
                n, _, width = batch["audio"].shape
                audio = np.zeros((n, 80, _bucket(width, 256)), np.float32)
                audio[:, :, :width] = batch["audio"]
                text = batch["text"]
                labels = np.zeros((n, _bucket(text.shape[-1])), np.int64)
                labels[:, : text.shape[-1]] = text
                chunk = {"audio": audio,
                         "audio_lengths": np.asarray(batch["audio_lengths"], np.int32),
                         "labels": labels,
                         "label_lengths": np.asarray(batch["text_lengths"], np.int32),
                         "weight": np.ones((n,), np.float32)}
                stats = [b.clone() for b in self._stat_buffers()]
                loss, blank_p = self.micro_step(chunk)
                seen += n
                if not np.isfinite(float(loss)):
                    with torch.no_grad():
                        for b, old in zip(self._stat_buffers(), stats):
                            b.copy_(old)
                    self.zero_pending()
                    continue
                lr = self.scheduler.step() if self.scheduler.is_warmup else self.scheduler.step(
                    epoch=seen)
                frames = max(int(batch["audio_lengths"].sum()), 1)
                self.fold_group(100.0 / frames)
                self.optimizer_step(lr)
                step += 1
                self.metrics.log({"loss": float(loss) / frames * 100, "blank_p": float(blank_p),
                                  "learning_rate": lr, "epoch": epoch, "utterance_step": step})
        return step

    # -- checkpoints ------------------------------------------------------------
    def _whole_state(self):
        """(model state_dict, optimizer state_dict) as whole tensors under
        the port's names, whatever the mesh: tensor-parallel shards
        gathered over model, ZeRO slices over data (every rank takes part)."""
        model_state = self.model.state_dict()
        opt_state = self.optimizer.state_dict()
        if self.mesh is None:
            return model_state, opt_state
        names = self._opt_names
        if self.zero_opt:
            # the parameters are views of the ZeRO buffer: whole tensors of
            # their own, so that the checkpoint does not hold the buffer
            model_state = {k: v.clone() for k, v in model_state.items()}
            opt_state, names = self._zero_whole_opt_state(opt_state), self._whole_names
        layout = getattr(self.model, "tp_layout", {})
        axis = self.mesh.axis("model")
        model_state = gather_state_dict(model_state, layout, axis)
        state = {}
        for i, st in opt_state["state"].items():
            state[i] = {k: gather_tensor(names[i], v, layout, axis)
                        if torch.is_tensor(v) and v.dim() > 0 else v for k, v in st.items()}
        return model_state, dict(opt_state, state=state)

    def _zero_whole_opt_state(self, opt_state):
        """This rank's optimizer state (on its pieces) -> the state of the
        whole parameters (of this rank's tensor-parallel shard), indexed as
        an optimizer without ZeRO indexes it: one all-gather per kind of
        state tensor.  Every piece is stepped at every step, so the kinds and
        the scalars (the step count) are the same on every piece."""
        inner = self.optimizer.inner
        pieces = [inner.state.get(p, {}) for p in self._zero_slices]
        whole = [{} for _ in self._zero.shapes]
        for k, v in pieces[0].items():
            if torch.is_tensor(v) and v.dim() > 0:
                for w, t in zip(whole, self._zero.gather([st[k] for st in pieces])):
                    w[k] = t
            else:
                for w in whole:
                    w[k] = v.clone() if torch.is_tensor(v) else v
        index = {n: j for j, n in enumerate(self._whole_names)}
        return {"state": {index[n]: w for n, w in zip(self._trainable_names, whole) if w},
                "param_groups": [dict(g, params=[index[n] for n in names]) for g, names
                                 in zip(opt_state["param_groups"], self._whole_groups)]}

    def _zero_piece_opt_state(self, opt_state, cut_model):
        """The inverse of `_zero_whole_opt_state`: a whole optimizer state
        -> this rank's, on its pieces (`cut_model(name, tensor)` cuts a
        whole tensor to this rank's tensor-parallel shard first)."""
        by_name = {self._whole_names[int(j)]: st for j, st in opt_state["state"].items()}
        piece_of = {self._trainable_names[i]: (i, a, b) for i, a, b in self._zero.pieces}
        state = {}
        for j, n in enumerate(self._opt_names):
            if n in by_name:
                i, a, b = piece_of[n]
                state[j] = {k: self._zero.cut(i, a, b, cut_model(n, v))
                            if torch.is_tensor(v) and v.dim() > 0 else v
                            for k, v in by_name[n].items()}
        mine = self.optimizer.state_dict()["param_groups"]
        return {"state": state, "param_groups": [dict(g, params=m["params"]) for g, m
                                                 in zip(opt_state["param_groups"], mine)]}

    def save(self, step: int, epoch: int, seen_ids: List[str]) -> Optional[str]:
        """Write step_<step>/ (rank 0 only; under a mesh every rank must
        call it, as it gathers the state)."""
        model_state, opt_state = self._whole_state()
        if not self.is_main:
            return None
        return checkpointing.save_checkpoint(
            self.checkpoint_dir, step=step,
            model_state=model_state,
            optimizer_state=opt_state,
            config=self.config,
            scheduler_state=self.scheduler.state_dict(),
            sequence_scheduler_state=(self.sequence_scheduler.state_dict()
                                      if self.sequence_scheduler else None),
            seen_ids=seen_ids, epoch=epoch,
        )

    def resume(self) -> Tuple[int, int, List[str]]:
        """Load the latest checkpoint of checkpoint_dir into the model, the
        optimizer and the schedulers; returns (step, epoch, seen_ids)."""
        if self.optimizer is None:
            self.init_state()
        latest = checkpointing.find_latest_checkpoint(self.checkpoint_dir)
        if latest is None:
            return 0, 0, []
        arrays, meta = checkpointing.load_checkpoint(latest, map_location=self.device)
        stale = [k for k in arrays["model"] if k.startswith("decoder.reprojection.")]
        if stale and self.model.decoder.reprojection is None:
            raise ValueError(
                f"{latest}: the checkpoint holds {stale}, which this model has no use for "
                "(its decoder reprojects only with self_conditioning and more than one "
                "layer); it was written before the port stopped creating the unused "
                "reprojection, and its optimizer state counts those parameters too, so "
                "it cannot resume this model")
        model_state, opt_state = arrays["model"], arrays.get("optimizer")
        if self.mesh is not None:
            model_state, opt_state = self._shard_state(model_state, opt_state)
        # (under ZeRO the optimizer's pieces are views of the parameters)
        self.model.load_state_dict(model_state, strict=True)
        if opt_state:
            self.optimizer.load_state_dict(opt_state)
        if meta.get("scheduler"):
            self.scheduler.load_state_dict(meta["scheduler"])
        if self.sequence_scheduler is not None and meta.get("sequence_scheduler"):
            self.sequence_scheduler.load_state_dict(meta["sequence_scheduler"])
            self.chunk_size = self.sequence_scheduler.cur_sequence_length
            self.batch_size = self.sequence_scheduler.cur_batch_size
        return meta["podcast_step"], meta["epoch"], meta["seen_ids"]

    def _shard_state(self, model_state, opt_state):
        """Whole checkpoint tensors -> this rank's: cut over model by the
        tensor-parallel layout, optimizer state also over data under ZeRO."""
        layout = getattr(self.model, "tp_layout", {})
        heads = getattr(self.model, "tp_heads", {})
        m, i = self.tp, self.mesh.index("model")
        model_state = shard_state_dict(model_state, layout, i, m, heads)
        if opt_state and self.zero_opt:
            opt_state = self._zero_piece_opt_state(
                opt_state, lambda name, v: shard_tensor(name, v, layout, i, m, heads))
        elif opt_state:
            state = {}
            for j, st in opt_state["state"].items():
                name = self._opt_names[int(j)]
                state[j] = {}
                for k, v in st.items():
                    if torch.is_tensor(v) and v.dim() > 0:
                        v = shard_tensor(name, v, layout, i, m, heads)
                    state[j][k] = v
            opt_state = dict(opt_state, state=state)
        return model_state, opt_state
