"""Traffic driver: the port's `Trainer.train` at one bucket of the sequence
ladder, on its own loader (`VariableBatchSimpleDataloader`, native `.npy`
reader, prefetch thread), one optimizer step a chunk.

Set-up: a corpus of `podcasts` seeded podcasts of `podcast_frames` frames in
the run's TMPDIR, each listed to the loader under `ids_per_podcast` ids, so
that an epoch holds many batches and the prefetch thread loads the next
batch while one trains, as on a real corpus, without more data written; the
model with the seeded weights, the Trainer (MADGRAD,
clip, bf16, per-layer remat as the configuration states; checkpoints off;
the learning-rate schedule resumed past its warmup, as a run is at any
bucket of the ladder after its first), and its first `warmup_steps` steps,
of which the reference follows the first `followed_steps` (all, where the
mix does not say).  The same Trainer then
trains on.  The window holds whole batches, each with its loading and
chunking on the host: it opens when the first batch after those steps is
fetched and closes at the first batch boundary after `seconds` have
passed, once the card has finished.  Epochs are cycled so the window
never runs dry.

train_audio_s_per_s = the audio seconds of the valid frames of every
optimizer step in the window / the window's wall seconds.
train.data_wait_ms = wall time in the loader's next() per step.
attempted = the window's micro steps; failed = those whose loss was not
finite (the Trainer skips them: they reach no optimizer step).
"""
from __future__ import annotations

import gc
import math
import shutil
import tempfile

from lcbench.harness import corpus, judge, program, spans
from lcbench.harness.runner import Outcome

KIND = "train"


class WindowClosed(Exception):
    """Raised from the Trainer's optimizer step once the window has closed."""


class TimedLoader:
    """The Trainer's loader, with `before_batch()` called before each batch is
    fetched (it opens and closes the window, which holds whole batches) and
    the wall time of each fetch counted while the window is open."""

    def __init__(self, inner, ctx, before_batch):
        self.inner, self.ctx, self.before_batch, self.wait_s = inner, ctx, before_batch, 0.0
        self.batch_ids = []  # the podcasts of each batch fetched, in row order

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __iter__(self):
        import time

        it = iter(self.inner)
        while True:
            self.before_batch()
            t = time.perf_counter()
            try:
                with spans.host_range("loader_next", self.ctx.trace):
                    item = next(it)
            except StopIteration:
                return
            if self.ctx.calls.active:
                self.wait_s += time.perf_counter() - t
            self.batch_ids.append(list(item[3]))
            yield item


def lr_at(tr: dict, podcasts_seen: int) -> float:
    """The schedule's learning rate after `podcasts_seen` recordings: the
    cosine from `lr` to `final_lr` over `cosine_recordings`."""
    peak, final = tr["lr"], tr["final_lr"]
    return final + 0.5 * (peak - final) * (
        1 + math.cos(podcasts_seen / tr["cosine_recordings"] * math.pi))


def listed(pairs: dict, copies: int) -> dict:
    """The corpus as the loader sees it: each podcast under `copies` ids."""
    return {f"{k}.{c}": v for k, v in pairs.items() for c in range(copies)}


def trainer_config(cfg: dict, tr: dict, seed: int, ckpt: str) -> dict:
    return {
        "model_class": cfg["model_class"],
        "model": dict(cfg["model"]),
        "audio_chunking": {"size": tr["chunk"], "overlap": 0},
        "training": {"batch_size": tr["batch"], "backprop_every": 1, "backwards_every": 1,
                     "clip_value": tr["clip"], "max_epochs": 10 ** 9,
                     "random_seed": seed % (2 ** 31), "dtype": cfg["dtype"]},
        "optimizer": {"name": "madgrad", "args": {"lr": tr["lr"]}},
        "scheduler": {"warmup_steps": 0, "final_value": tr["final_lr"]},
        "checkpointing": {"dir": ckpt, "save_every_n_steps": 10 ** 15},
        "wandb": {"use": False},
    }


def run(ctx) -> Outcome:
    import torch

    from lcasr_torch.config import Config
    from lcasr_torch.data.dataloading import VariableBatchSimpleDataloader
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.training.trainer import Trainer

    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    tmp = tempfile.mkdtemp(prefix="lcbench_corpus_")
    try:
        pairs = listed(corpus.make(tmp, tr["podcasts"], tr["podcast_frames"], ctx.seed, dev),
                       tr["ids_per_podcast"])
        model, shapes = program.build(cfg, ctx.seed, dev)
        tok = load_tokenizer()
        trainer = Trainer(Config(trainer_config(cfg, tr, ctx.seed, tmp + "/ckpt")), model, tok,
                          checkpoint_dir=tmp + "/ckpt", device=dev)
        trainer.init_state()
        trainer.scheduler.load_state_dict({"is_warmup": False, "steps": tr["cosine_recordings"],
                                           "offset": 0, "last_epoch": 0, "_last_lr": tr["lr"]})
        loader = VariableBatchSimpleDataloader(
            pairs, tok, batch_size=tr["batch"], chunk_size=tr["chunk"], chunk_overlap=0,
            random_seed=ctx.seed % (2 ** 31))
        state, loader = _drive(ctx, trainer, loader, tr)
        view = {"kind": KIND, "model_class": cfg["model_class"],
                "model": program.model_kwargs(cfg), "window_s": state["window_s"],
                "steps": state["steps"], "useful_flops": state["flops"],
                "data_wait_s": loader.wait_s}
        blank = tok.vocab_size()
        trainable = [n for n, p in model.named_parameters() if p.requires_grad]
        del trainer, model, loader
        gc.collect()
        torch.cuda.empty_cache() if dev.type == "cuda" else None
        checks = _judge(ctx, state, shapes, trainable, blank, pairs, tok.pad_id())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return Outcome(
        attempted=state["attempted"], failed=state["failed"],
        e2e={"train_audio_s_per_s": (state["audio_s"] / state["window_s"], "audio_s/s"),
             "peak_mem_gib": (ctx.memory_peak_bytes / 2 ** 30, "GiB")},
        view=view, checks=checks)


def _drive(ctx, trainer, loader, tr):
    """Train until the window closes; keep what the reference follows.
    Returns (the run's state, the timed loader)."""
    import numpy as np

    from lcbench.harness import flops as F

    warm, follow = tr["warmup_steps"], tr.get("followed_steps", tr["warmup_steps"])
    st = {"n": 0, "chunks": [], "loss": [], "steps": 0, "attempted": 0, "audio_s": 0.0,
          "flops": 0.0, "failed": 0, "pending": None, "position": (-1, -1)}
    micro, opt_step = trainer.micro_step, trainer.optimizer_step
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    mcfg = program.model_kwargs(ctx.config)

    def micro_step(chunk, augment=False):
        batch = len(timed.batch_ids) - 1
        st["position"] = (batch, st["position"][1] + 1 if st["position"][0] == batch else 0)
        loss, blank_p = micro(chunk, augment)
        st["pending"] = (chunk, loss)
        if ctx.calls.active:  # the Trainer reads the loss on the host next anyway
            st["attempted"] += 1
            st["failed"] += not np.isfinite(float(loss))
        return loss, blank_p

    def optimizer_step(lr):
        opt_step(lr)
        st["n"] += 1
        chunk, loss = st["pending"]
        if st["n"] <= follow:
            batch, c = st["position"]
            st["chunks"].append((timed.batch_ids[batch], c, chunk))
            st["loss"].append(float(loss))
            if st["n"] == 1:  # the first gradient as MADGRAD got it: s / lamb
                inner = trainer.optimizer.inner
                lamb = (lr + inner.defaults["eps"]) * math.sqrt(1.0)
                st["grad1"] = {names[id(p)]: float(inner.state[p]["s"].norm()) / lamb
                               if "s" in inner.state.get(p, {}) else 0.0
                               for g in inner.param_groups for p in g["params"]}
            if st["n"] == follow:
                st["params"] = {n: p.detach().to("cpu", copy=True)
                                for n, p in trainer.model.named_parameters()}
        if ctx.calls.active:
            st["steps"] += 1
            lengths = chunk["audio_lengths"]
            st["audio_s"] += float(lengths.sum()) / tr["frames_per_second"]
            st["flops"] += F.train_step_flops(ctx.config["model_class"], mcfg, lengths)

    def before_batch():
        if ctx.calls.active and ctx.elapsed() >= ctx.seconds:
            st["window_s"] = ctx.end_window()
            raise WindowClosed
        if not ctx.calls.active and ctx.t0 is None and st["n"] >= max(warm, follow):
            ctx.begin_window()

    timed = TimedLoader(loader, ctx, before_batch)
    trainer.micro_step, trainer.optimizer_step = micro_step, optimizer_step
    try:
        trainer.train(timed)
    except WindowClosed:
        pass
    return st, timed


def _judge(ctx, st, shapes, trainable, blank, pairs, pad_id):
    from lcasr_torch.data.tokenizer import DEFAULT_TOKENIZER_PATH

    from lcbench.reference.data import Tokenizer, batch_chunks, same_feed
    from lcbench.reference.train import follow

    # the feed, worked out again from the raw corpus: the podcasts of each
    # followed step's batch (the loader's order), its chunk
    tok = Tokenizer(DEFAULT_TOKENIZER_PATH)
    cache, chunks, same = {}, [], True
    for ids, c, program_chunk in st["chunks"]:
        key = tuple(ids)
        if key not in cache:
            cache[key] = batch_chunks(pairs, ids, ctx.traffic["chunk"], tok,
                                      ctx.traffic["frames_per_second"], pad_id)
        chunks.append(cache[key][c])
        same = same and same_feed(program_chunk, chunks[-1])
    del cache
    ref = judge.reference_module(ctx.config)
    weights = judge.reference_weights(ctx, shapes)
    mcfg = program.model_kwargs(ctx.config)
    stats = {k: dict(v, steps=0) for k, v in ref.eval_stats(weights, mcfg).items()}
    readings = {"loss": st["loss"], "grad1": st["grad1"], "params": st["params"]}
    tr = ctx.traffic
    per_batch = tr["podcast_frames"] // tr["chunk"]  # steps a batch
    lrs = [lr_at(tr, (k // per_batch) * tr["batch"]) for k in range(len(chunks))]
    if ctx.control:  # the reference in fp8 in the program's place
        from lcbench.reference.layers import Quant

        ctrl = follow(ref.forward, mcfg, weights, trainable,
                      {k: dict(v) for k, v in stats.items()}, chunks, lrs,
                      ctx.traffic["clip"], blank, ctx.device, q=Quant())
        readings = {"loss": ctrl["loss"],
                    "grad1": {n: float(g.norm()) for n, g in ctrl["grad1"].items()},
                    "params": ctrl["params"]}
        del ctrl
    refr = follow(ref.forward, mcfg, weights, trainable, stats, chunks, lrs,
                  ctx.traffic["clip"], blank, ctx.device)
    return [("feed_mismatch", 0.0 if same else 1.0, 0.0)] + judge.train_checks(
        ctx, readings, refr, weights)
