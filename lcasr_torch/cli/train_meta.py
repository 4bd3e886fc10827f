"""Meta-gradient-prediction training CLI (counterpart of
lcasr_tpu/cli/train_meta.py):

    python -m lcasr_torch.cli.train_meta -config cfg.yaml [-o key=value ...] [--device cpu]

Utterance batches (the output of `data.utterances.save_utterances`, in
`data.utterance_folder`), an `SCConformerMeta` built from the config, and
`training.meta.MetaTrainer`.  `model.load_pretrained_from` names an
SCConformerXL checkpoint (a port checkpoint directory or a reference
`.pt`) whose shared modules (subsampling, layers, decoder, ...) start the
encoder.  `--device` defaults to cuda.
"""
from __future__ import annotations

import argparse

import torch

from lcasr_torch.config import Config
from lcasr_torch.data.tokenizer import load_tokenizer
from lcasr_torch.data.utterances import UtteranceDataloader
from lcasr_torch.models.base import count_params
from lcasr_torch.models.registry import load_model
from lcasr_torch.models.sconformer_meta import SCConformerMeta
from lcasr_torch.training.meta import MetaTrainer


def load_pretrained(model: torch.nn.Module, path: str) -> int:
    """Copy the parameters and statistics of `path` whose names the model
    has (the flax tree's top-level submodules line up one to one); returns
    the number of top-level modules loaded."""
    from lcasr_torch.evaluation.run import load_any_checkpoint

    _, state_dict = load_any_checkpoint(path)
    own = model.state_dict()
    shared = {k: v for k, v in state_dict.items() if k in own and own[k].shape == v.shape}
    model.load_state_dict(shared, strict=False)
    return len({k.split(".")[0] for k in shared})


def main(args=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-config", "--config", type=str, required=True)
    parser.add_argument("-o", "--overrides", nargs="*", default=[])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu (the kernels' plain versions)")
    ns = parser.parse_args(args)

    config = Config.load(ns.config)
    if ns.overrides:
        config = config.apply_overrides(ns.overrides)
    tokenizer = load_tokenizer()
    torch.manual_seed(12345)
    model = load_model(config, tokenizer.vocab_size(), device=ns.device,
                       model_class=SCConformerMeta)
    trainer = MetaTrainer(
        config, model, tokenizer, device=ns.device,
        checkpoint_dir=config.get("checkpointing", Config({})).get("dir", "./checkpoints"))
    pretrained = config.get("model", Config({})).get("load_pretrained_from", None)
    if pretrained:
        print(f"loaded {load_pretrained(model, pretrained)} pretrained submodules from "
              f"{pretrained}")
    trainer.init_state()
    print(f"model: {count_params(model) / 1e6:.2f}M parameters")
    tr = config.get("training", Config({}))
    dataloader = UtteranceDataloader(config["data"]["utterance_folder"],
                                     batch_size=tr.get("batch_size", 8), shuffle=True,
                                     random_seed=tr.get("random_seed", 1234))
    steps = trainer.train_utterances(dataloader)
    print(f"meta training: {steps} steps")


if __name__ == "__main__":
    main()
