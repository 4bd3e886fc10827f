"""The CTC kernels (`lcasr_torch/csrc/ctc.cu`, wrapper `ops/ctc.py`).

On the CPU: the partition that spreads a lattice over a cluster
(`ctc_partition`), and that CPU tensors never reach the kernels.  On the
card (marker `cuda`, skipped without one; `python -m pytest -m cuda
tests/test_torch_port_ctc_kernel.py`): the kernels against PyTorch's CTC,
which they replace on CUDA tensors (`check_against_library`): log-alpha,
the nll and alpha + beta at every state the same bits as PyTorch's, the
gradient the class sums of PyTorch's posteriors.  This file imports no JAX: the CPU path's
agreement with the JAX package is tests/test_torch_port_ctc.py's.
"""
import pytest
import torch
import torch.nn.functional as F

from lcasr_torch import kernels
from lcasr_torch.ops import ctc as ctc_ops
from lcasr_torch.ops.ctc import MAX_CLUSTER, MAX_THREADS, Partition, ctc_loss, ctc_partition


# (batch, states): the one-hour step (T' 45,000, S 15,043), the ladder's
# 16384 x 22 (S ~700), an empty label, a lattice wider than a cluster holds
# in registers, and a batch whose clusters must shrink to fit the card
@pytest.mark.parametrize("batch, states, want", [
    (1, 30087, Partition(cluster=16, threads=960, per_thread=2, tiles=1)),
    (22, 1409, Partition(cluster=1, threads=736, per_thread=2, tiles=1)),
    (4, 1, Partition(cluster=1, threads=32, per_thread=1, tiles=1)),
    (1, 200001, Partition(cluster=16, threads=800, per_thread=4, tiles=4)),
    (16, 30087, Partition(cluster=8, threads=960, per_thread=4, tiles=1)),
], ids=["one_hour", "16384x22", "empty_label", "wider_than_a_cluster", "large_batch"])
def test_partition(batch, states, want):
    assert ctc_partition(batch, states) == want


@pytest.mark.parametrize("states", [1, 3, 31, 1024, 1025, 2049, 30087, 65537, 131073, 500001])
@pytest.mark.parametrize("batch", [1, 8, 22, 200])
def test_partition_covers_the_lattice(batch, states):
    """Every state has a thread, no CTA exceeds the launch limits, and the
    batch's clusters fit the card's SMs at once where a cluster is used."""
    p = ctc_partition(batch, states)
    assert p.tiles * p.cluster * p.threads * p.per_thread >= states
    assert p.threads % 32 == 0 and 32 <= p.threads <= MAX_THREADS
    assert p.cluster in (1, 2, 4, 8, 16) and p.cluster <= MAX_CLUSTER
    assert p.per_thread in ctc_ops.PER_THREAD
    assert p.cluster == 1 or batch * p.cluster <= ctc_ops.CARD_SMS
    # no tile is all padding
    assert (p.tiles - 1) * p.cluster * p.threads * p.per_thread < states


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    monkeypatch.setattr(ctc_ops, "ctc_alpha", None)  # a call would raise
    monkeypatch.setattr(ctc_ops, "ctc_lattice", None)
    kernels.reset_launch_counts()
    lp = torch.log_softmax(torch.randn(2, 12, 5), -1).requires_grad_()
    loss = ctc_loss(lp, torch.tensor([[1, 2], [3, 0]]), torch.tensor([12, 7]),
                    torch.tensor([2, 1]))
    loss.backward()
    assert torch.isfinite(lp.grad).all()
    assert kernels.launch_counts["ctc_alpha"] == kernels.launch_counts["ctc_beta"] == 0


# ---------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CTC kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make_case(dev, B, T, C, U, seed, blank=None, input_lengths=None, label_lengths=None,
              repeat_every=0, scale=2.0):
    """log-probs (B, T, C) of random logits, labels (B, U) drawn from the
    classes other than blank (every `repeat_every`-th a repeat of the one
    before), and int64 lengths (T and U where not given)."""
    blank = C - 1 if blank is None else blank
    g = torch.Generator(device=dev).manual_seed(seed)
    lp = torch.log_softmax(torch.randn((B, T, C), generator=g, device=dev) * scale, -1)
    labels = torch.randint(0, C - 1, (B, U), generator=g, device=dev)
    labels = labels + (labels >= blank).long()  # skip the blank
    if repeat_every:
        labels[:, repeat_every::repeat_every] = labels[:, repeat_every - 1:-1:repeat_every]
    il = torch.full((B,), T, dtype=torch.long, device=dev) if input_lengths is None \
        else torch.tensor(input_lengths, dtype=torch.long, device=dev)
    ll = torch.full((B,), U, dtype=torch.long, device=dev) if label_lengths is None \
        else torch.tensor(label_lengths, dtype=torch.long, device=dev)
    return lp, labels, il, ll, blank


def kernel_side(lp, labels, il, ll, blank, weight, part=None):
    """(raw nll, log-alpha) of the alpha kernel alone, and (raw nll,
    alpha + beta, gradient of sum(weight x nll with inf -> 0)) of the
    lattice and gradient kernels."""
    nll_a, alpha = ctc_ops.ctc_alpha(lp, labels, il, ll, blank, part)
    nll, grad, sums = ctc_ops.ctc_lattice(lp, labels, il, ll, blank, part)
    return nll_a, alpha, nll, sums, grad * weight[:, None, None]


def reversed_rows(x, lengths):
    """x (B, N, ...) with each row's first lengths[b] entries in reverse
    order (the rest: entry 0's)."""
    N = x.shape[1]
    idx = (lengths[:, None] - 1 - torch.arange(N, device=x.device)[None, :]).clamp_min(0)
    return x.gather(1, idx.view(*idx.shape, *([1] * (x.dim() - 2))).expand_as(x))


def library_posteriors(lp, labels, il, ll, blank):
    """PyTorch's raw nll, log-alpha, alpha + beta and posteriors exp(alpha +
    beta + nll - lp), the last two (B, T, 2 max(ll) + 1) and NaN off the
    rows' lattices, and the states' classes.  Beta is the alpha of the
    problem reversed in time and in labels, whose recursion is PyTorch's
    beta recursion term for term: the same bits."""
    B, T, _ = lp.shape
    nll, alpha = torch._ctc_loss(lp.transpose(0, 1), labels, il, ll, blank, False)
    _, alpha_rev = torch._ctc_loss(reversed_rows(lp, il).transpose(0, 1).contiguous(),
                                   reversed_rows(labels, ll).contiguous(), il, ll, blank, False)
    S2 = alpha.shape[2]
    t = torch.arange(T, device=lp.device)[None, :, None]
    s = torch.arange(S2, device=lp.device)[None, None, :]
    live = (t < il[:, None, None]) & (s <= 2 * ll[:, None, None])
    t_rev = (il[:, None, None] - 1 - t).clamp_min(0).expand(B, T, S2)
    s_rev = (2 * ll[:, None, None] - s).clamp_min(0).expand(B, T, S2)
    sums = alpha + alpha_rev.gather(1, t_rev).gather(2, s_rev)
    del alpha_rev
    ext = torch.full((B, S2), blank, dtype=torch.long, device=lp.device)
    ext[:, 1::2] = labels[:, : S2 // 2]
    ext = torch.where(s[0] <= 2 * ll[:, None], ext, torch.full_like(ext, blank))
    post = ((sums + nll[:, None, None]) - lp.gather(2, ext[:, None, :].expand(B, T, S2))).exp_()
    nan = torch.full_like(post, float("nan"))
    sums = torch.where(live, sums, nan)
    post = torch.where(live & torch.isfinite(nll)[:, None, None], post, nan)
    return nll, alpha, sums, post, ext


def exact_gradient(lp, post, ext, il, nll, weight, rows=4096):
    """(exp(lp) - the class sums of `post`) x weight, the sums in fp64; 0 at
    t >= input_length and on rows whose nll is +inf (zero_infinity)."""
    B, T, C = lp.shape
    out = torch.empty((B, T, C), dtype=torch.float64, device=lp.device)
    for t0 in range(0, T, rows):
        p = post[:, t0:t0 + rows].double().nan_to_num(0.0)
        sums = torch.zeros((B, p.shape[1], C), dtype=torch.float64, device=lp.device)
        sums.scatter_add_(2, ext[:, None, :].expand_as(p), p)
        out[:, t0:t0 + rows] = (lp[:, t0:t0 + rows].double().exp() - sums) * weight[:, None, None]
    t = torch.arange(T, device=lp.device)[None, :, None]
    return torch.where((t < il[:, None, None]) & (nll[:, None, None] != float("inf")), out,
                       torch.zeros_like(out))


def library_gradient(lp, labels, il, ll, blank, weight):
    x = lp.detach().clone().requires_grad_()
    out = F.ctc_loss(x.transpose(0, 1), labels, il, ll, blank=blank, reduction="none",
                     zero_infinity=True)
    (out * weight).sum().backward()
    return x.grad


GRAD_REL = 1e-5  # fp32 class sums of up to 15,044 posteriors, against fp64


def check_against_library(lp, labels, il, ll, blank, part=None):
    """The nll, log-alpha and alpha + beta: PyTorch's bits (so beta is its
    beta, bit for bit).  The gradient: the class sums of PyTorch's
    posteriors taken in fp64, within GRAD_REL of max(1, |value|).  Against
    F.ctc_loss's gradient the gap may not exceed F.ctc_loss's own gap from
    the same fp64 sums (its blank column goes through a logsumexp of alpha
    + beta, ~2 x nll in magnitude, so it keeps ~2 nll x 2^-24 of relative
    error: ~1e-5 at an nll of 140, ~2e-3 at 36,665) plus GRAD_REL."""
    B = lp.shape[0]
    weight = torch.linspace(0.5, 1.5, B, device=lp.device)
    nll_a, alpha, nll, sums, grad = kernel_side(lp, labels, il, ll, blank, weight, part)
    nll_r, alpha_r, sums_r, post_r, ext = library_posteriors(lp, labels, il, ll, blank)
    assert torch.equal(nll_a, nll) and torch.equal(nll, nll_r), (nll_a, nll, nll_r)
    rows = il > 0  # PyTorch leaves log-alpha unwritten where input_length is 0
    width = alpha_r.shape[2]
    assert torch.equal(alpha[rows][:, :, :width], alpha_r[rows])
    del alpha, alpha_r
    live = ~torch.isnan(sums_r)
    assert torch.equal(sums[:, :, :width][live], sums_r[live])
    del sums, sums_r, live
    exact = exact_gradient(lp, post_r, ext, il, nll_r, weight)
    del post_r
    err = ((grad.double() - exact).abs() / exact.abs().clamp_min(1.0)).max().item()
    assert err <= GRAD_REL, err
    lib = library_gradient(lp, labels, il, ll, blank, weight)
    lib_gap = (lib.double() - exact).abs().max().item()
    gap = (grad - lib).abs().max().item()
    assert gap <= lib_gap + GRAD_REL * max(1.0, exact.abs().max().item()), (gap, lib_gap)
    return nll, grad


@pytest.mark.cuda
def test_one_hour_lattice(card):
    """(1, 45,000, 4,096), S = 15,043: the one-hour step's CTC, the full
    cluster."""
    lp, labels, il, ll, blank = make_case(card, 1, 45000, 4096, 15043, seed=2**31 + 7)
    assert ctc_partition(1, 2 * 15043 + 1).cluster == 16
    check_against_library(lp, labels, il, ll, blank)


@pytest.mark.cuda
def test_ladder_16384x22_lattices(card):
    """(22, 2,048, 4,096), S ~700: one CTA a row; rows of several lengths."""
    il = [2048 - 37 * i for i in range(22)]
    ll = [700 - 13 * i for i in range(22)]
    lp, labels, il, ll, blank = make_case(card, 22, 2048, 4096, 704, seed=11,
                                          input_lengths=il, label_lengths=ll)
    assert ctc_partition(22, 2 * 704 + 1).cluster == 1
    check_against_library(lp, labels, il, ll, blank)


@pytest.mark.cuda
@pytest.mark.parametrize("blank", [None, 0, 17], ids=["blank_last", "blank_0", "blank_17"])
def test_edge_rows(card, blank):
    """Zero-length labels, impossible alignments (too few frames; repeats
    needing blanks between), input_length < T and 0, repeated labels, and
    a blank that is not the last class."""
    lp, labels, _, _, blank = make_case(card, 6, 40, 33, 12, seed=3, blank=blank, repeat_every=3)
    il = torch.tensor([40, 31, 9, 13, 0, 40], device=card)
    ll = torch.tensor([12, 0, 12, 12, 3, 5], device=card)
    nll, grad = check_against_library(lp, labels, il, ll, blank)
    assert nll[0].isfinite() and nll[1].isfinite()
    assert nll[2] == float("inf") and nll[3] == float("inf") and nll[4] == float("inf")
    assert (grad[2:5] == 0).all() and (grad[1, 31:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("part", [
    Partition(cluster=2, threads=32, per_thread=1, tiles=3),
    Partition(cluster=4, threads=64, per_thread=2, tiles=2),
    Partition(cluster=8, threads=32, per_thread=4, tiles=1),
    Partition(cluster=16, threads=32, per_thread=1, tiles=2),
    Partition(cluster=1, threads=96, per_thread=4, tiles=2),
], ids=lambda p: f"c{p.cluster}_t{p.threads}_k{p.per_thread}_tiles{p.tiles}")
def test_partitions_agree(card, part):
    """Every partition computes PyTorch's CTC: halos across CTAs, across
    tiles (alpha from log-alpha in memory, beta from the edge scratch), and
    every states-a-thread the kernels are built for."""
    U = (part.tiles * part.cluster * part.threads * part.per_thread - 2) // 2  # fills the tiles
    lp, labels, il, ll, blank = make_case(card, 3, U + 40, 29, U, seed=5, repeat_every=7,
                                          input_lengths=[U + 40, U + 25, U + 9],
                                          label_lengths=[U, U - 30, U - 2])
    check_against_library(lp, labels, il, ll, blank, part=part)


@pytest.mark.cuda
def test_gradient_is_the_same_bits_each_run(card):
    lp, labels, il, ll, blank = make_case(card, 2, 3000, 512, 900, seed=9, repeat_every=5)
    weight = torch.ones(2, device=card)
    grads = [kernel_side(lp, labels, il, ll, blank, weight)[4] for _ in range(3)]
    assert torch.equal(grads[0], grads[1]) and torch.equal(grads[0], grads[2])


@pytest.mark.cuda
def test_a_micro_step_runs_the_kernels_once(card, tmp_path, monkeypatch):
    """One Trainer micro step on the card: one `ctc_alpha` and one
    `ctc_beta` launch, and `F.ctc_loss` never sees a CUDA tensor."""
    import numpy as np

    from lcasr_torch.config import Config
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.models.registry import load_model
    from lcasr_torch.training.trainer import Trainer

    library_ctc = F.ctc_loss

    def cpu_only(log_probs, *args, **kwargs):
        assert log_probs.device.type == "cpu", "F.ctc_loss called on a CUDA tensor"
        return library_ctc(log_probs, *args, **kwargs)

    monkeypatch.setattr(ctc_ops.F, "ctc_loss", cpu_only)
    tok = load_tokenizer()
    cfg = Config({
        "model_class": "SCConformerXL",
        "model": {"d_model": 64, "n_layers": 2, "n_heads": 2, "head_dim": 32,
                  "subsampling_conv_channels": 32, "checkpoint_every_n_layers": 1},
        "audio_chunking": {"size": 1024, "overlap": 0},
        "training": {"batch_size": 2, "dtype": "bfloat16"},
        "optimizer": {"name": "madgrad", "args": {"lr": 1e-4}},
        "scheduler": {"warmup_steps": 1, "final_value": 0.0},
        "checkpointing": {"dir": str(tmp_path), "save_every_n_steps": 10 ** 6},
        "wandb": {"use": False},
    })
    trainer = Trainer(cfg, load_model(cfg, tok.vocab_size(), device="cuda"), tok, device="cuda")
    trainer.init_state()
    rng = np.random.default_rng(0)
    chunk = {"audio": rng.normal(size=(2, 80, 1024)).astype(np.float32),
             "audio_lengths": np.array([1024, 800], np.int32),
             "labels": rng.integers(1, 4000, size=(2, 40)).astype(np.int64),
             "label_lengths": np.array([40, 25], np.int32),
             "weight": np.ones((2,), np.float32)}
    kernels.reset_launch_counts()
    loss, _ = trainer.micro_step(chunk)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert kernels.launch_counts["ctc_alpha"] == 1 and kernels.launch_counts["ctc_beta"] == 1
