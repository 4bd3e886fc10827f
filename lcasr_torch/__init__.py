"""lcasr_torch: the PyTorch / CUDA port of lcasr_tpu for NVIDIA Hopper.

It keeps lcasr_tpu's module layout (ops/, models/, evaluation/, decoding/)
so each module's JAX counterpart is easy to find.  It imports torch, numpy
and the standard library only, never JAX or lcasr_tpu.  Entry points run on
the GPU unless the caller passes `device="cpu"`; on the CPU every kernel
wrapper runs its plain PyTorch version.
"""
