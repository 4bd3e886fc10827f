"""FastConformerCTC (Parakeet-CTC-1.1B's architecture) against the plain fp32
reference of the benchmark, `lcbench/reference/fastconformer.py`, on the CPU.

Tolerance: log-probs within 1e-5 in fp32.  Both sides compute the same
products in fp32 (the port's attention through one matrix product, a
strided view and `scaled_dot_product_attention`, the reference's through a
gather by relative position and an explicit softmax), so they differ by the
order of fp32 sums over up to 512 terms and a 33-way log-softmax: the
measured gap at this size is 9.5e-7.  Each of the three perturbations
below (the biases u, v zeroed; the position term zeroed; the input scale
sqrt(d_model) left out) moves the log-probs by more than 100x that
tolerance.
"""
import json
import math
import os

import pytest
import torch

from lcasr_torch.models.fastconformer import FastConformerCTC
from lcasr_torch.ops.rel_pos_attention import rel_pos_attention, sinusoid_table
from lcbench.reference import fastconformer as ref

ATOL = 1e-5
TINY = dict(vocab_size=32, n_layers=2, d_model=64, n_heads=4, head_dim=16,
            subsampling_conv_channels=32)
T_IN = 512
LENGTHS = (512, 301)  # one ragged row
CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "lcbench", "configs", "parakeet_ctc_1.1b.json")


def _seeded(model, seed=0):
    """Weights N(0, 1/fan_in), biases and u, v N(0, 0.3^2), norm scales near
    1, BatchNorm statistics mean N(0, 0.1^2) and variance U(0.5, 1.5)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "running_var":
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
            elif leaf == "running_mean":
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))
            elif leaf in ("scale", "weight") and t.dim() == 1:
                t.copy_(1.0 + 0.1 * torch.randn(t.shape, generator=gen))
            elif t.dim() == 1 or leaf.startswith("pos_bias"):
                t.copy_(0.3 * torch.randn(t.shape, generator=gen))
            else:
                t.copy_(torch.randn(t.shape, generator=gen) * math.prod(t.shape[1:]) ** -0.5)
    return model


def _weights(model):
    return {n: t.detach().clone() for n, t in
            list(model.named_parameters()) + list(model.named_buffers())}


def _inputs(seed=1):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((len(LENGTHS), 80, T_IN), generator=gen), torch.tensor(LENGTHS)


def _valid(lengths_out, n):
    return torch.arange(n)[None, :] < lengths_out[:, None]


def _port(model, audio, lengths):
    with torch.no_grad():
        out = model(audio, length=lengths)
    return out["final_posteriors"], out["length"]


def _reference(p, audio, lengths, **cfg):
    with torch.no_grad():
        return ref.forward(p, dict(TINY, **cfg), audio, lengths)


def test_matches_the_plain_reference_in_fp32():
    model = _seeded(FastConformerCTC(**TINY, device="cpu"))
    audio, lengths = _inputs()
    got, got_len = _port(model, audio, lengths)
    want, want_len = _reference(_weights(model), audio, lengths)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 64, 33)
    assert torch.equal(got_len, want_len)
    valid = _valid(want_len, got.shape[1])
    gap = (got - want).abs()[valid].max().item()
    assert gap <= ATOL, gap


def _moved(model, audio, lengths, base):
    got, got_len = _port(model, audio, lengths)
    return (got - base).abs()[_valid(got_len, got.shape[1])].max().item()


@pytest.mark.parametrize("perturbation", ["uv_zero", "position_zero", "no_xscaling"])
def test_each_term_moves_the_output(perturbation):
    model = _seeded(FastConformerCTC(**TINY, device="cpu"))
    audio, lengths = _inputs()
    base, _ = _port(model, audio, lengths)
    if perturbation == "no_xscaling":
        other = FastConformerCTC(**TINY, xscaling=False, device="cpu")
        other.load_state_dict(model.state_dict())
    else:
        other = model
        with torch.no_grad():
            for layer in model.layers:
                if perturbation == "uv_zero":
                    layer.attend.pos_bias_u.zero_()
                    layer.attend.pos_bias_v.zero_()
                else:
                    layer.attend.linear_pos.weight.zero_()  # p = PE W_pos = 0
    assert _moved(other, audio, lengths, base) > 100 * ATOL


def test_the_judges_probe_is_the_first_layers_op():
    """`first_attention`, the reference's side of the Parakeet cell's
    `probe_rel_l2`, equals the output of the port's first call to the op."""
    import lcasr_torch.ops.rel_pos_attention as op

    model = _seeded(FastConformerCTC(**TINY, device="cpu"))
    audio, lengths = _inputs()
    seen, inner = [], op.rel_pos_attention

    def keep(*args, **kwargs):
        seen.append(inner(*args, **kwargs))
        return seen[-1]

    op.rel_pos_attention = keep
    try:
        _port(model, audio, lengths)
    finally:
        op.rel_pos_attention = inner
    assert len(seen) == TINY["n_layers"]
    with torch.no_grad():
        want = ref.first_attention(_weights(model), TINY, audio, lengths)
    torch.testing.assert_close(seen[0], want, atol=ATOL, rtol=0)


def test_position_term_equals_a_double_loop():
    """The op's scores hold (q_i + v) . p(i - j): its output against softmax
    attention over scores built pair by pair, with a padded key."""
    gen = torch.Generator().manual_seed(3)
    B, T, H, D = 2, 7, 3, 4
    q, k, v = (torch.randn((B, T, H, D), generator=gen, dtype=torch.float64) for _ in range(3))
    table = torch.randn((2 * T - 1, H, D), generator=gen, dtype=torch.float64)  # row T-1-r: p(r)
    u, vb = (torch.randn((H, D), generator=gen, dtype=torch.float64) for _ in range(2))
    lengths = torch.tensor([T, T - 2])
    got = rel_pos_attention(q, k, v, table, u, vb, lengths)
    want = torch.zeros_like(got)
    for b in range(B):
        n = int(lengths[b])
        for h in range(H):
            for i in range(n):
                scores = torch.empty(T, dtype=torch.float64)
                for j in range(T):
                    p = table[T - 1 - (i - j), h]
                    scores[j] = ((q[b, i, h] + u[h]) @ k[b, j, h]
                                 + (q[b, i, h] + vb[h]) @ p) / math.sqrt(D)
                    if j >= n:
                        scores[j] = -10000.0
                want[b, i, h] = torch.softmax(scores, 0) @ v[b, :, h]
    torch.testing.assert_close(got, want, atol=1e-12, rtol=1e-12)


def test_sinusoid_table_rows_run_from_t_minus_one_down():
    pe = sinusoid_table(5, 8)
    r = torch.arange(4, -5, -1, dtype=torch.float64)[:, None]
    freq = 10000.0 ** (-torch.arange(0, 8, 2, dtype=torch.float64) / 8)
    torch.testing.assert_close(pe[:, 0::2].double(), torch.sin(r * freq), atol=1e-6, rtol=0)
    torch.testing.assert_close(pe[:, 1::2].double(), torch.cos(r * freq), atol=1e-6, rtol=0)


def test_streaming_decoder_equals_the_reference_decode():
    from lcasr_torch.evaluation.streaming import StreamingDecoder
    from lcbench.reference.decode import averaged_probs

    model = _seeded(FastConformerCTC(**TINY, device="cpu"))
    spec = torch.randn((80, 1800), generator=torch.Generator().manual_seed(5))
    decoder = StreamingDecoder(model, TINY["vocab_size"] + 1, window_batch_size=2,
                               transfer_dtype=torch.float32, device="cpu")
    got = decoder._run(spec[None].numpy(), 512, 256)
    p = _weights(model)
    with torch.no_grad():
        want = averaged_probs(lambda a, ln: ref.forward(p, TINY, a, ln), spec, 512, 256,
                              TINY["vocab_size"] + 1)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_load_model_builds_the_configuration_file():
    from lcasr_torch.config import Config
    from lcasr_torch.models.registry import load_model

    with open(CONFIG) as f:
        cfg = json.load(f)
    assert cfg["reduced"] == [] and cfg["model_class"] == "FastConformerCTC"
    model = load_model(Config({"model": cfg["model"], "model_class": cfg["model_class"]}),
                       cfg["vocab_size"], device="meta")
    assert isinstance(model, FastConformerCTC)
    assert len(model.layers) == 42 and model.layers[0].attend.n_heads == 8
    assert model.layers[0].attend.head_dim == 128
    assert model.layers[0].ff1.fc1.weight.shape == (4096, 1024)
    assert model.decoder.weight.shape == (1025, 1024)
    n = sum(t.numel() for t in model.parameters())
    assert n == 1_062_540_289 and abs(n / 1.06e9 - 1) < 0.01
    sites = {m.site for m in model.modules() if type(m).__name__ == "Dense"}
    # None: the subsampling's output projection, as in the other families
    assert sites == {None, "qkv", "attn_out", "proj", "ff", "conv", "decoder"}


def test_quant_policy_reaches_every_site():
    model = FastConformerCTC(**TINY, quant_w8a8=True, device="cpu")
    quant = [m.quant for m in model.modules() if type(m).__name__ == "Dense"
             and m.site is not None]
    assert quant and all(quant) and model.quant_sites
    audio, lengths = _inputs()
    out, _ = _port(_seeded(model), audio, lengths)
    assert torch.isfinite(out).all()


def test_meta_build_leaves_no_table_to_overwrite():
    """`lcbench/harness/program.build` fills every floating buffer from the
    seed: the model keeps none but BatchNorm's statistics, and the built
    model agrees with the reference on the same weights."""
    from lcbench.harness import program

    cfg = {"model_class": "FastConformerCTC", "dtype": "float32", "vocab_size": 32,
           "model": {k: v for k, v in TINY.items() if k != "vocab_size"}}
    model, shapes = program.build(cfg, 3000000001, torch.device("cpu"))
    floating = {n.rsplit(".", 1)[-1] for n, b in model.named_buffers() if b.is_floating_point()}
    assert floating == {"running_mean", "running_var"}
    p = _weights(model)
    p.update({n: 0.5 + torch.rand(t.shape) for n, t in p.items() if n.endswith("running_var")})
    with torch.no_grad():
        for n, t in model.named_buffers():
            if n.endswith("running_var"):
                t.copy_(p[n])
    audio, lengths = _inputs()
    got, got_len = _port(model, audio, lengths)
    want, _ = _reference(p, audio, lengths)
    assert (got - want).abs()[_valid(got_len, got.shape[1])].max().item() <= ATOL
