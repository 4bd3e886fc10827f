"""The system under test: the port's model of a configuration, built without
initialising anything on the host and filled with the seeded weights."""
from __future__ import annotations

from lcbench.harness import weights as W


def model_kwargs(cfg: dict) -> dict:
    """The configuration's model options (its `model` section plus the
    vocabulary), as the port's constructor takes them."""
    kw = dict(cfg["model"])
    kw["vocab_size"] = cfg["vocab_size"]
    return kw


def build(cfg: dict, seed: int, device, quant_w8a8=False):
    """(model, [(name, shape)] of its seeded tensors) for configuration
    `cfg` on `device`, in its compute dtype; `quant_w8a8` switches the port's own
    int8 projections on (the decode cells' control)."""
    import torch

    from lcasr_torch.models.registry import get_model_class

    cls = get_model_class(cfg)
    kw = model_kwargs(cfg)
    kw["dtype"] = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["dtype"]]
    if quant_w8a8:
        kw["quant_w8a8"] = True
    meta = torch.device("meta")
    with meta:
        model = cls(**kw, device=meta)
    model = model.to_empty(device=device)
    _restore_tables(model, device)
    shapes = W.model_shapes(model)
    W.fill_(model, W.seeded_tensors(shapes, seed, device))
    model.eval()
    return model, shapes


def _restore_tables(model, device) -> None:
    """What the constructor computed rather than drew, redone on the
    device after the meta build: the rotary frequencies (the module's own
    function) and the batch-renorm step counts (zero)."""
    import torch

    from lcasr_torch.ops.rotary import _inv_freq

    with torch.no_grad():
        for name, buf in model.named_buffers():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "inv_freq":
                owner = model.get_submodule(name.rsplit(".", 1)[0])
                buf.copy_(_inv_freq(owner.dim, owner.base, device))
            elif leaf == "num_batches_tracked":
                buf.zero_()
