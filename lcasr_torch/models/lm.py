"""Causal transformer language model for CTC beam-search fusion (the port's
copy of lcasr_tpu/models/lm.py).

The reference's LM rescoring uses an external package (`lming`, reference
`eval/tedlium/tlm_beam.py:5-6`); this first-party equivalent makes the
rescoring pipeline self-contained: a pre-norm causal transformer over the
BPE vocabulary, trained on transcript text (`cli/train_lm.py`) and adapted
into the beam searches by `make_lm_scorer` (prefix search), `decoding.
frame_sync.CachedTransformerLM` (host frame-synchronous search) and
`decoding.frame_sync_device` (the search on the device).

Module and parameter names follow the flax tree one to one: `embed`
(leaf `embedding`, (vocab, d_model)), per layer `attn_norm_{i}`, `qkv_{i}`
(packed (3, H, D) on its output), `out_{i}`, `ff_norm_{i}`, `ff_{i}`
(`fc1`, `fc2`), then `norm_out` and `lm_head` (with its bias).  The
attention is plain torch, as the JAX package computes it with einsum
outside any Pallas kernel: fp32 scores scaled by D^-1/2, masked to
NEG_INF, fp32 softmax, the result in the compute dtype.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lcasr_torch.device import resolve_device
from lcasr_torch.models.enc_dec_sconformer import Embed
from lcasr_torch.ops.attention import NEG_INF
from lcasr_torch.ops.dense import Dense
from lcasr_torch.ops.mlp import ConformerFeedForward
from lcasr_torch.ops.norms import get_norm
from lcasr_torch.ops.qdense import TRAIN_REFUSAL, apply_quant_policy
from lcasr_torch.ops.rotary import _inv_freq, apply_rotary, rotary_tables, rotate_half


class TransformerLM(nn.Module):
    """forward(tokens (B, U)) -> logits (B, U, vocab); with a cache, one
    token a row: (logits (B, 1, vocab), cache, cache_lengths).

    `device=None` means the GPU and raises without one."""

    NOT_PORTED: dict = {}  # every option of the JAX model is taken

    def __init__(
        self,
        vocab_size: int = 4095,
        d_model: int = 512,
        n_layers: int = 6,
        n_heads: int = 8,
        head_dim: int = 64,
        rotary_base_freq: float = 10000.0,
        default_norm: str = "rms_norm",
        quant_w8a8=False,  # False | True | "auto" | site names (ops/qdense.py)
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.vocab_size, self.d_model = vocab_size, d_model
        self.n_layers, self.n_heads, self.head_dim = n_layers, n_heads, head_dim
        self.rotary_base_freq = rotary_base_freq
        self.dtype = dtype
        Norm = get_norm(default_norm)
        hd = n_heads * head_dim
        self.embed = Embed(vocab_size, d_model, dtype=dtype)
        for i in range(n_layers):
            self.add_module(f"attn_norm_{i}", Norm(d_model))
            self.add_module(f"qkv_{i}", Dense(d_model, 3 * hd, bias=False, dtype=dtype,
                                              site="qkv"))
            self.add_module(f"out_{i}", Dense(hd, d_model, bias=False, dtype=dtype,
                                              site="attn_out"))
            self.add_module(f"ff_norm_{i}", Norm(d_model))
            self.add_module(f"ff_{i}", ConformerFeedForward(d_model, dtype=dtype, site="ff"))
        self.norm_out = Norm(d_model)
        self.lm_head = Dense(d_model, vocab_size, dtype=dtype, site="lm_head")
        apply_quant_policy(self, quant_w8a8)
        self.to(device)

    def forward(
        self,
        tokens: torch.Tensor,
        cache: Optional[torch.Tensor] = None,  # (L, 2, B, H, Nmax, D)
        cache_lengths: Optional[torch.Tensor] = None,  # (B,)
        write_mask: Optional[torch.Tensor] = None,  # (B,) bool
        pos_row: Optional[torch.Tensor] = None,  # (B, Nmax) int
        write_rows: Optional[torch.Tensor] = None,  # (B,) int
        train: bool = False,
    ):
        """tokens (B, U) -> logits (B, U, vocab).  `train` only guards the
        W8A8 policy (a quantised model refuses to train); the model has no
        dropout or batch statistics.

        Cached decoding (the reference beam search's per-beam KV caches):
        pass `cache` / `cache_lengths` and one token a row (U == 1); returns
        (logits (B, 1, vocab), cache, cache_lengths + write_mask).  The cache
        is a fixed-size buffer in the reference's (L, 2, B, H, Nmax, D)
        layout, UPDATED IN PLACE; rows write at their own `cache_lengths`
        position and rotate at it, so every beam continues at its absolute
        position.  As in the JAX model the cached path rotates q and k with
        the fp32 tables, so both are fp32 from there on.

        `write_mask` (default all True): a masked-off row keeps its cache
        cells and its length exactly (its logits are junk).  A write at
        `cache_lengths == Nmax` is dropped: callers bound the steps on the
        host, as `decoding.frame_sync.CachedTransformerLM` does.

        `pos_row` ((B, Nmax)): attention reads K/V at position n of row b
        from physical row `pos_row[b, n]`, so a beam search shares a
        parent's cached prefix with its forked children without permuting
        the buffer.  `write_rows` ((B,)): the physical row of row b's write
        (default b).

        The writes are one `index_put_` of B cells a layer, never a select
        over the whole buffer (the JAX docstring records that such a select
        ran a 200-row cache out of memory).  torch has no scatter that drops
        out-of-bounds indices, and selecting the written rows with a boolean
        mask would cost a host synchronisation a step; so a row that does
        not write repeats the write of the first row that does (the same
        cell, the same value: duplicate writes of equal bits), or, where no
        row writes, writes back the value its cell already holds.  Only the
        selected rows' cells change, with no host synchronisation."""
        if train and self.quant_sites:
            raise ValueError(TRAIN_REFUSAL)
        B, U = tokens.shape
        H, D = self.n_heads, self.head_dim
        x = self.embed(tokens)
        if cache is None:
            cos, sin = rotary_tables(U, D, base=self.rotary_base_freq, device=tokens.device)
            causal = torch.ones((U, U), dtype=torch.bool, device=tokens.device).tril()
        else:
            assert U == 1, "cached decoding feeds one token per row"
            Nmax = cache.shape[4]
            dev = tokens.device
            inv_freq = _inv_freq(D, self.rotary_base_freq, dev)
            freqs = cache_lengths.float()[:, None, None] * inv_freq  # (B, 1, D/2)
            emb = torch.cat([freqs, freqs], -1)
            cos_q, sin_q = emb.cos()[:, :, None, :], emb.sin()[:, :, None, :]
            rows = torch.arange(B, device=dev)
            if write_mask is None:
                write_mask = torch.ones((B,), dtype=torch.bool, device=dev)
            put = write_mask & (cache_lengths < Nmax)
            pos = cache_lengths.clamp(max=Nmax - 1).long()
            w_rows = (rows if write_rows is None else write_rows).long()
            # rows that do not write repeat the first writer's cell (or, with
            # no writer, their own cell's value): see the docstring
            # (index_select with a 1-element index: a 0-d index tensor would
            # be read back to the host)
            first = put.int().argmax().view(1)
            any_put = put.any()
            t_rows = torch.where(put, w_rows, w_rows.index_select(0, first))
            t_pos = torch.where(put, pos, pos.index_select(0, first))
            heads = torch.arange(H, device=dev)[None, :]
            visible = (torch.arange(Nmax, device=dev)[None, :]
                       <= cache_lengths[:, None])[:, None, None, :]
            if pos_row is not None:
                gather_rows = pos_row.long()  # (B, Nmax)
                cols = torch.arange(Nmax, device=dev)[None, :]

        for i in range(self.n_layers):
            h = getattr(self, f"attn_norm_{i}")(x)
            q, k, v = getattr(self, f"qkv_{i}")(h).view(B, U, 3, H, D).unbind(2)
            if cache is None:
                q, k = apply_rotary(q, k, cos, sin)
                s = torch.einsum("bthd,bshd->bhts", q.float() * D ** -0.5, k.float())
                s = torch.where(causal, s, NEG_INF)
                o = torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), v.float())
            else:
                q = q * cos_q + rotate_half(q) * sin_q
                k = k * cos_q + rotate_half(k) * sin_q
                for j, new in ((0, k[:, 0]), (1, v[:, 0])):
                    layer = cache[i, j]  # (B, H, Nmax, D), a view
                    new = new.to(cache.dtype)
                    old = layer[t_rows, :, t_pos]  # (B, H, D)
                    val = torch.where(put[:, None, None], new,
                                      torch.where(any_put, new.index_select(0, first), old))
                    layer.index_put_((t_rows[:, None], heads, t_pos[:, None]), val)
                if pos_row is not None:
                    # (B, Nmax, H, D): position n of row b from row pos_row[b, n]
                    k_buf = cache[i, 0].permute(0, 2, 1, 3)[gather_rows, cols]
                    v_buf = cache[i, 1].permute(0, 2, 1, 3)[gather_rows, cols]
                    s = torch.einsum("bthd,bshd->bhts", q.float() * D ** -0.5, k_buf.float())
                    s = torch.where(visible, s, NEG_INF)
                    o = torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), v_buf.float())
                else:
                    s = torch.einsum("bthd,bhsd->bhts", q.float() * D ** -0.5, cache[i, 0].float())
                    s = torch.where(visible, s, NEG_INF)
                    o = torch.einsum("bhts,bhsd->bthd", torch.softmax(s, -1), cache[i, 1].float())
            o = o.to(x.dtype)
            x = x + getattr(self, f"out_{i}")(o.reshape(B, U, H * D))
            h = getattr(self, f"ff_norm_{i}")(x)
            x = x + getattr(self, f"ff_{i}")(h)

        logits = self.lm_head(self.norm_out(x))
        if cache is None:
            return logits
        return logits, cache, cache_lengths + write_mask.to(cache_lengths.dtype)


def lm_loss(model: TransformerLM, tokens: torch.Tensor,
            lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross-entropy over the valid positions; tokens include bos."""
    logits = model(tokens, train=True)
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits[:, :-1].float(), -1)
    ce = -logp.gather(-1, targets[..., None])[..., 0]
    if lengths is not None:
        valid = (torch.arange(targets.shape[1], device=tokens.device)[None, :]
                 < (lengths - 1)[:, None])
        return torch.where(valid, ce, 0.0).sum() / valid.sum().clamp(min=1)
    return ce.mean()


def make_lm_scorer(model: TransformerLM, bos_id: int = 2, pad_id: int = 0):
    """The batched `lm_scores` hook of `decoding.beam_search.BeamSearch`,
    running `model` on its own device."""
    from lcasr_torch.decoding.beam_search import TorchLMScorer

    device = next(model.parameters()).device
    model = model.eval()

    @torch.no_grad()
    def fn(tokens: np.ndarray) -> np.ndarray:
        return model(torch.from_numpy(tokens).to(device)).float().cpu().numpy()

    @torch.no_grad()
    def fn_last(tokens: np.ndarray, last: np.ndarray) -> np.ndarray:
        logits = model(torch.from_numpy(tokens).to(device))
        rows = torch.from_numpy(last.astype(np.int64)).to(device)
        # only the scored position leaves the device
        row = logits[torch.arange(len(last), device=device), rows]
        return torch.log_softmax(row.float(), -1).cpu().numpy()

    return TorchLMScorer(fn, fn_last=fn_last, bos_id=bos_id, pad_id=pad_id)
