"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the GPU.  Without one this raises: the port never falls
    back to the CPU unless the caller asks for it with `device="cpu"`."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "lcasr_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
