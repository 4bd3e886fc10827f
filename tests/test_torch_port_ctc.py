"""lcasr_torch's CTC loss against lcasr_tpu's, on the CPU in fp32.

Both sides take log-probs from a log_softmax of the same numpy logits;
gradients are compared with respect to those logits (the port's CTC
backward is PyTorch's, whose gradient is exact through a log_softmax,
`lcasr_torch/ops/ctc.py`).  Tolerance: values are sums of up to ~40
log-probs of magnitude ~2 computed in fp32 by two recursions, agreeing to
~1e-5 relative; gradients are posteriors minus probabilities in [-1, 1],
agreeing to ~1e-6, so 1e-4 relative on values and 1e-5 absolute on
gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcasr_tpu.ops.ctc import ctc_loss as jax_ctc
from lcasr_torch.ops.ctc import SENTINEL, ctc_loss

# rows: repeats, a full row, a zero-length label, an impossible alignment
# (6 labels with 2 repeats need 8 frames; 5 are given), and input length 0
LABELS = np.array([[1, 1, 2, 3, 0, 0], [2, 3, 4, 5, 1, 2], [0, 0, 0, 0, 0, 0],
                   [1, 1, 2, 2, 3, 4], [3, 0, 0, 0, 0, 0]], np.int32)
LABEL_LENGTHS = np.array([3, 6, 0, 6, 1], np.int32)
INPUT_LENGTHS = np.array([30, 22, 9, 5, 0], np.int32)


def _both(reduction, segment_size, blank, C=9, T=30, seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(len(LABELS), T, C)).astype(np.float32) * 2
    w = rng.uniform(0.5, 1.5, len(LABELS)).astype(np.float32)
    labels = np.where(LABELS >= blank, LABELS + 1, LABELS) if blank < C - 1 else LABELS

    def jf(x):
        nll = jax_ctc(jax.nn.log_softmax(x, -1), jnp.asarray(labels), jnp.asarray(INPUT_LENGTHS),
                      jnp.asarray(LABEL_LENGTHS), blank_id=blank, reduction="none",
                      segment_size=segment_size)
        nll_live = jnp.where(nll < 1e29, nll, 0.0)
        return (nll_live * w).sum(), nll

    (_, nll_j), g_j = jax.value_and_grad(jf, has_aux=True)(logits)
    x = torch.from_numpy(logits).requires_grad_()
    nll_t = ctc_loss(torch.log_softmax(x, -1), torch.from_numpy(labels),
                     torch.from_numpy(INPUT_LENGTHS), torch.from_numpy(LABEL_LENGTHS),
                     blank_id=blank, reduction="none", segment_size=segment_size)
    live = torch.where(nll_t < 1e29, nll_t, torch.zeros_like(nll_t))
    (live * torch.from_numpy(w)).sum().backward()
    reduced = ctc_loss(torch.log_softmax(x.detach(), -1), torch.from_numpy(labels),
                       torch.from_numpy(INPUT_LENGTHS), torch.from_numpy(LABEL_LENGTHS),
                       blank_id=blank, reduction=reduction)
    want_reduced = jax_ctc(jax.nn.log_softmax(logits, -1), labels, INPUT_LENGTHS,
                           LABEL_LENGTHS, blank_id=blank, reduction=reduction)
    return (np.asarray(nll_j), nll_t.detach().numpy(), np.asarray(g_j), x.grad.numpy(),
            np.asarray(want_reduced), reduced.numpy())


@pytest.mark.parametrize("segment_size", [None, 8], ids=["monolithic", "segment_8"])
@pytest.mark.parametrize("blank", [8, 0], ids=["blank_last", "blank_0"])
def test_values_and_gradients_match_jax(segment_size, blank):
    nll_j, nll_t, g_j, g_t, _, _ = _both("none", segment_size, blank)
    np.testing.assert_allclose(nll_t, nll_j, rtol=1e-4)
    np.testing.assert_allclose(g_t, g_j, atol=1e-5)


def test_sentinel_and_zero_gradient_for_impossible_alignments():
    nll_j, nll_t, _, g_t, _, _ = _both("none", None, 8)
    assert nll_t[3] == nll_j[3] == SENTINEL  # too few frames
    assert nll_t[4] == nll_j[4] == SENTINEL  # no frames at all
    assert (g_t[3] == 0).all() and (g_t[4] == 0).all()
    assert np.isfinite(nll_t[2]) and nll_t[2] < 1e29  # empty label: all blanks


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_reductions_match_jax(reduction):
    *_, want, got = _both(reduction, None, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_segment_size_does_not_change_the_result():
    a = _both("none", None, 8)
    b = _both("none", 16, 8)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[3], b[3])
