"""FastConformerCTC: NVIDIA NeMo's FastConformer encoder with a CTC head, the
architecture of Parakeet-CTC-1.1B (FastConformer-XXL: 42 layers at d_model
1024, 8 heads of 128; huggingface.co/nvidia/parakeet-ctc-1.1b, NeMo's
`examples/asr/conf/fastconformer/fast-conformer_ctc_bpe.yaml`,
arXiv:2305.05084).

  subsampling: 8x dw_striding (ops/conv.py `ConvSubsampling`), ReLU, its
      output projection with a bias; then x * sqrt(d_model) (xscaling);
  n x layer, pre-norm residual:
      x += 1/2 FF1(LN x); x += MHSA(LN x); x += Conv(LN x, pad mask);
      x += 1/2 FF2(LN x); x = LN x
  FF: Linear(d, 4d) -> Swish -> Linear(4d, d), with biases;
  MHSA: relative-position attention (ops/rel_pos_attention.py) over the
      sinusoid table of the window's T' positions, built on the fly;
  Conv: pointwise (2d, bias) -> GLU -> padded frames zeroed -> depthwise
      (K, 'same', bias) -> BatchNorm (running statistics) -> Swish ->
      pointwise (d, bias);
  head: log_softmax(Linear(d, vocab + 1)) in fp32, blank last (NeMo's
      `ConvASRDecoder`, a kernel-1 conv).

No self-conditioning, no norm before the head.  Parameters are fp32 and
`dtype` is the compute dtype, as in the other families; every `Dense` has
a W8A8 site (`quant_w8a8`, ops/qdense.py).  Inference only: NeMo's
training (dropout, batch statistics) is not ported.  The flattened
subsampling output has its channels minor, as in the port's other models
(NeMo flattens (C, F') with F' minor: a NeMo checkpoint's `out` weight
would be permuted on import).

    forward(audio (B, feat_in, T), length (B,) or None)
      -> {'final_posteriors': (B, T', vocab + 1) fp32 log-probs, 'length'}

`device=None` means the GPU and raises without one.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from lcasr_torch.device import resolve_device
from lcasr_torch.ops.attention import length_mask
from lcasr_torch.ops.conv import ConformerConvolution, ConvSubsampling
from lcasr_torch.ops.dense import Dense
from lcasr_torch.ops.mlp import ConformerFeedForward
from lcasr_torch.ops.norms import LayerNorm
from lcasr_torch.ops.qdense import apply_quant_policy
from lcasr_torch.ops.rel_pos_attention import RelPositionAttention, sinusoid_table
from lcasr_torch.utils.profiling import span


class FastConformerLayer(nn.Module):
    """1/2 FF1 -> rel-pos MHSA -> Conv -> 1/2 FF2 -> norm_out, pre-norm residual."""

    def __init__(self, d_model: int, n_heads: int, head_dim: int, ff_dim: int,
                 conv_kernel_size: int = 9, dtype: torch.dtype = torch.float32):
        super().__init__()

        def ff():
            return ConformerFeedForward(d_model, ff_dim, bias1=True, bias2=True, dtype=dtype,
                                        site="ff", activation="swish")

        self.ff1_norm, self.ff1 = LayerNorm(d_model), ff()
        self.attn_norm = LayerNorm(d_model)
        self.attend = RelPositionAttention(d_model, n_heads, head_dim, dtype=dtype)
        self.conv_norm = LayerNorm(d_model)
        self.conv = ConformerConvolution(d_model, conv_kernel_size, "batch_norm", dtype=dtype)
        self.ff2_norm, self.ff2 = LayerNorm(d_model), ff()
        self.norm_out = LayerNorm(d_model)

    def forward(self, x, pe, lengths=None, pad_mask=None):
        with span("ff"):
            x = self.ff1(self.ff1_norm(x)) * 0.5 + x
        with span("attention"):
            x = self.attend(self.attn_norm(x), pe, lengths) + x
        with span("conv"):
            x = self.conv(self.conv_norm(x), pad_mask=pad_mask) + x
        with span("ff"):
            x = self.ff2(self.ff2_norm(x)) * 0.5 + x
        return self.norm_out(x)


class FastConformerCTC(nn.Module):
    NOT_PORTED = {}

    def __init__(
        self,
        vocab_size: int = 1024,
        feat_in: int = 80,
        n_layers: int = 42,
        d_model: int = 1024,
        n_heads: int = 8,
        head_dim: int = 128,
        ff_expansion_factor: int = 4,
        subsampling_factor: int = 8,
        subsampling_conv_channels: int = 256,
        conv_kernel_size: int = 9,
        xscaling: bool = True,
        quant_w8a8=False,  # False | True | "auto" | site names (ops/qdense.py)
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.d_model = d_model
        self.subsampling_factor = subsampling_factor
        self.xscale = math.sqrt(d_model) if xscaling else None
        self.subsampling = ConvSubsampling(
            subsampling_factor=subsampling_factor, feat_in=feat_in, feat_out=d_model,
            conv_channels=subsampling_conv_channels, activation="relu",
            subsampling="dw_striding", dtype=dtype, out_bias=True)
        self.layers = nn.ModuleList(
            FastConformerLayer(d_model, n_heads, head_dim, d_model * ff_expansion_factor,
                               conv_kernel_size=conv_kernel_size, dtype=dtype)
            for _ in range(n_layers))
        self.decoder = Dense(d_model, vocab_size + 1, dtype=dtype, site="decoder")
        apply_quant_policy(self, quant_w8a8)
        self.to(device)
        self.eval()

    def forward(self, audio_signal: torch.Tensor, length: Optional[torch.Tensor] = None,
                train: bool = False):
        if train:
            raise NotImplementedError("FastConformerCTC is ported for inference only")
        x = audio_signal.transpose(1, 2).to(self.dtype)  # (B, T, feat)
        B = x.shape[0]
        have_lengths = length is not None
        if not have_lengths:
            length = torch.full((B,), x.shape[1], dtype=torch.int32, device=x.device)
        x, length = self.subsampling(x, length.to(x.device))
        if self.xscale is not None:
            x = x * self.xscale
        N = x.shape[1]
        lengths_arg = length if have_lengths else None
        pad_mask = ~length_mask(length, N) if have_lengths else None
        pe = sinusoid_table(N, self.d_model, x.device)
        for layer in self.layers:
            x = layer(x, pe, lengths_arg, pad_mask)
        with span("head"):
            out = torch.log_softmax(self.decoder(x).float(), dim=-1)
        return {"final_posteriors": out, "length": length}
