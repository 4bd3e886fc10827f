"""Training CLI: `python -m lcasr_torch.cli.train -config cfg.yaml`
(counterpart of lcasr_tpu/cli/train.py): config -> tokenizer -> model ->
trainer -> checkpoint resume (seen_ids / step / epoch) -> duration-bucketed
dataloader -> train loop.  The same flags, plus `--device` (default: the
GPU; `--device cpu` runs the plain versions of the kernels).

One process per GPU: `torchrun --nproc_per_node 8 -m lcasr_torch.cli.train
-config configs/lcasr_9l_768d_6h.yaml` (its RANK / WORLD_SIZE / LOCAL_RANK
/ MASTER_ADDR / MASTER_PORT are read), or on many hosts the JAX CLI's flags
`--coordinator_address host:port --num_processes N --process_id i` on each
(`--coordinator_address` also takes an init URL such as file:///path).  The
Trainer then builds `parallel.mesh` over the world; NCCL on the GPU, gloo
with `--device cpu`.
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
    parser.add_argument("-coordinator", "--coordinator_address", default=None,
                        help="multi-host: coordinator host:port (or an init URL such as "
                             "file:///path); one process per GPU with --num_processes / "
                             "--process_id, or launch with torchrun")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--dist_timeout", type=float, default=None,
                        help="seconds before a collective of the process group fails")
    parser.add_argument("-o", "--overrides", nargs="*", default=[])
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; 'cpu' runs the plain versions)")
    ns = parser.parse_args(args)
    from lcasr_torch.parallel.mesh import maybe_init_distributed, rank, world_size

    url = ns.coordinator_address if ns.coordinator_address and "://" in ns.coordinator_address \
        else None
    if maybe_init_distributed(None if url else ns.coordinator_address, ns.num_processes,
                              ns.process_id, device=ns.device, init_method=url,
                              timeout=ns.dist_timeout):
        print(f"distributed: process {rank()}/{world_size()}")
    if ns.anomaly:
        torch.autograd.set_detect_anomaly(True)

    config = Config.load(ns.config)
    if ns.overrides:
        config = config.apply_overrides(ns.overrides)
    tokenizer = load_tokenizer()
    torch.manual_seed(12345)  # the same initial weights on every rank (the JAX init key)
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
