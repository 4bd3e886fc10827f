"""Training CLI: `python -m lcasr_torch.cli.train -config cfg.yaml`
(counterpart of lcasr_tpu/cli/train.py): config -> tokenizer -> model ->
trainer -> checkpoint resume (seen_ids / step / epoch) -> duration-bucketed
dataloader -> train loop.  The same flags, plus `--device` (default: the
GPU; `--device cpu` runs the plain versions of the kernels).  The JAX
CLI's multi-host flags are accepted and refused unless left unset.
"""
from __future__ import annotations

import argparse
import random
import time

import torch

from lcasr_torch.config import Config
from lcasr_torch.data.dataloading import VariableBatchSimpleDataloader, load_json
from lcasr_torch.data.tokenizer import load_tokenizer
from lcasr_torch.models.base import count_params
from lcasr_torch.models.registry import load_model
from lcasr_torch.training.trainer import Trainer


def main(args=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-config", "--config", type=str, required=True)
    parser.add_argument("-reset_step", "--reset_step", action="store_true")
    parser.add_argument("-rm_sched", "--remove_scheduler", action="store_true",
                        help="ignore the scheduler state in the checkpoint")
    parser.add_argument("-anomaly", "--anomaly", action="store_true",
                        help="enable torch.autograd anomaly detection")
    parser.add_argument("-debug_hooks", "--debug_hooks", action="store_true",
                        help="log per-parameter gradient statistics")
    parser.add_argument("-coordinator", "--coordinator_address", default=None)
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("-o", "--overrides", nargs="*", default=[])
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; 'cpu' runs the plain versions)")
    ns = parser.parse_args(args)
    if ns.coordinator_address or (ns.num_processes or 1) > 1:
        raise NotImplementedError("multi-host training is not ported yet")
    if ns.anomaly:
        torch.autograd.set_detect_anomaly(True)

    config = Config.load(ns.config)
    if ns.overrides:
        config = config.apply_overrides(ns.overrides)
    tokenizer = load_tokenizer()
    model = load_model(config, tokenizer.vocab_size(), device=ns.device)
    trainer = Trainer(config, model, tokenizer, device=ns.device)
    trainer.debug_hooks = ns.debug_hooks
    trainer.init_state()
    print(f"model: {count_params(model) / 1e6:.2f}M parameters")

    sched_backup = trainer.scheduler.state_dict()
    step, epoch, seen_ids = trainer.resume()
    if ns.remove_scheduler:
        trainer.scheduler.load_state_dict(sched_backup)
    if ns.reset_step:
        step, epoch, seen_ids = 0, 0, []
    print(f"Starting from podcast: {len(seen_ids)}")

    random_seed = config.get("training", Config({})).get("random_seed", 1234)
    if random_seed == "random":
        random_seed = int(time.time()) % 10000
        print(f"random seed: {random_seed}")
    random.seed(random_seed)
    # presegmented-utterance training: data.utterances_dir holds the output
    # of data.utterances.save_utterances
    utt_dir = config.get("data", Config({})).get("utterances_dir", None)
    if utt_dir:
        from lcasr_torch.data.utterances import UtteranceDataloader

        dataloader = UtteranceDataloader(utt_dir, batch_size=trainer.batch_size,
                                         random_seed=random_seed)
        trainer.train_utterances(dataloader, epochs=trainer.max_epochs)
        return

    dataloader = VariableBatchSimpleDataloader(
        pairs=load_json(config["data"]["path"]),
        tokenizer=tokenizer,
        batch_size=trainer.batch_size,
        chunk_size=config["audio_chunking"]["size"],
        chunk_overlap=config["audio_chunking"].get("overlap", 0),
        seen_ids=seen_ids,
        random_seed=random_seed,
    )
    if dataloader.batch_size != trainer.batch_size:
        dataloader.update(batch_size=trainer.batch_size, seen_ids=seen_ids)
    trainer.train(dataloader, step=step, epoch=epoch, seen_ids=seen_ids)


if __name__ == "__main__":
    main()
