"""Parallelism on torch.distributed (counterpart of lcasr_tpu/parallel/):
the (data, model, seq) mesh, the collectives with their adjoints, context
parallel attention (gather and ring), full-model context parallelism,
tensor parallelism and the partition rules.  ZeRO is `optim/zero.py`."""
from lcasr_torch.parallel.mesh import Mesh, make_mesh, maybe_init_distributed  # noqa: F401
