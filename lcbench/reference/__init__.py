"""The plain reference: the two model families, their averaged moving-window
decode and their training step (CTC, global-norm clip, MADGRAD), written
in plain PyTorch from the architectures' equations and computed in fp32
with TF32 off.

It imports nothing of the program (`lcasr_torch`) and nothing of the JAX
package, and takes nothing the program made: the harness hands it the
weights and the inputs it made itself, and the program's outputs only to
be judged.  `Quant` switches every matrix product's operands to fp8
(e4m3, one scale a tensor): the control that the comparisons must fail.
"""
