"""lcasr_torch's selective-scan ops against lcasr_tpu's, on the CPU in fp32.

On the CPU the port's `selective_scan` runs its plain versions (the
sequential recurrence and the written-out reverse recurrence); the CUDA
kernels are held against those same plain versions on the card by
chip_smoke.py.  Inputs come from numpy.  Tolerances: both sides are fp32 and
differ in the order of operations (JAX's reference is a log-depth associative
scan, the Pallas kernels and the port are sequential), so outputs agree to a
few 1e-6 of their scale; 1e-5 relative to the largest value leaves a margin
and still catches a wrong index, sign or term (those show at 1e-2 or more).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcasr_tpu.ops import ssm as jssm
from lcasr_torch.ops import ssm
from tests.test_torch_port_ops import assert_close, load_port, randomize, t

REL = 1e-5


def _inputs(Bt, L, D, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(Bt, L, D)).astype(np.float32)
    delta = np.log1p(np.exp(rng.normal(size=(Bt, L, D)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(D, N))).astype(np.float32)
    Bm = rng.normal(size=(Bt, L, N)).astype(np.float32)
    Cm = rng.normal(size=(Bt, L, N)).astype(np.float32)
    Dskip = rng.normal(size=(D,)).astype(np.float32)
    return x, delta, A, Bm, Cm, Dskip


def _close(got, want, rel=REL, name=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=rel * scale, rtol=0,
                               err_msg=name)


@pytest.mark.parametrize("L,with_d", [(40, True), (77, False), (5, True), (1, False)],
                         ids=["L40_D", "L77", "L5_D", "L1"])
def test_selective_scan_matches_jax_reference(L, with_d):
    x, delta, A, Bm, Cm, Dskip = _inputs(2, L, 12, 16, seed=L)
    skip = Dskip if with_d else None
    want = jssm.selective_scan(*map(jnp.asarray, (x, delta, A, Bm, Cm)),
                               None if skip is None else jnp.asarray(skip), use_pallas=False)
    got = ssm.selective_scan(t(x), t(delta), t(A), t(Bm), t(Cm), None if skip is None else t(skip))
    assert got.dtype == torch.float32 and got.shape == (2, L, 12)
    _close(got, want)


def test_selective_scan_other_state_sizes_on_the_cpu():
    """The plain version takes any d_state; the kernels take the built ones
    (16, 32 and 64) and say so, the wrappers padding the others up."""
    x, delta, A, Bm, Cm, Dskip = _inputs(2, 12, 4, 3, seed=1)
    want = jssm.selective_scan(*map(jnp.asarray, (x, delta, A, Bm, Cm, Dskip)), use_pallas=False)
    _close(ssm.selective_scan(*map(t, (x, delta, A, Bm, Cm, Dskip))), want)
    cuda_like = [t(a) for a in (x, delta, A, Bm, Cm)]
    with pytest.raises(ValueError, match="d_state 16"):
        ssm._check_kernel_inputs(*cuda_like)


def test_selective_scan_matches_pallas_interpret():
    """The Pallas forward kernel in interpret mode (L not a multiple of its
    16-row group, so its zero-delta tail padding runs too)."""
    x, delta, A, Bm, Cm, Dskip = _inputs(2, 40, 128, 16, seed=2)
    want = jssm.selective_scan(*map(jnp.asarray, (x, delta, A, Bm, Cm, Dskip)), use_pallas=True)
    _close(ssm.selective_scan(*map(t, (x, delta, A, Bm, Cm, Dskip))), want)


def test_chunk_entry_states_are_the_recurrence_states():
    x, delta, A, Bm, Cm, _ = _inputs(2, 70, 6, 16, seed=3)
    y, states = ssm.selective_scan_ref(*map(t, (x, delta, A, Bm, Cm)), return_states=True)
    assert states.shape == (2, 3, 16, 6) and states.is_contiguous()
    assert torch.equal(states[:, 0], torch.zeros(2, 16, 6))
    h = np.zeros((2, 6, 16), np.float32)
    for step in range(64):
        h = np.exp(delta[:, step, :, None] * A) * h + (
            delta[:, step, :, None] * x[:, step, :, None]) * Bm[:, step, None, :]
        if step + 1 in (32, 64):
            _close(states[:, (step + 1) // 32], h.transpose(0, 2, 1))
    _close(y, ssm.selective_scan_ref(*map(t, (x, delta, A, Bm, Cm))).numpy(), rel=0.0)


GRADS = ("dx", "ddelta", "dA", "dB", "dC")


def _jax_grads(fn, x, delta, A, Bm, Cm, w):
    loss = lambda *a: (fn(*a) * w).sum()
    return jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, (x, delta, A, Bm, Cm)))


@pytest.mark.parametrize("L", [45, 9], ids=["L45", "L9"])
def test_bwd_ref_matches_jax_grad(L):
    x, delta, A, Bm, Cm, _ = _inputs(2, L, 10, 16, seed=4)
    w = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)
    want = _jax_grads(jssm._selective_scan_ref, x, delta, A, Bm, Cm, w)
    got = ssm.selective_scan_bwd_ref(*map(t, (x, delta, A, Bm, Cm, w)))
    for name, g, wv in zip(GRADS, got, want):
        assert g.dtype == torch.float32
        _close(g, wv, name=name)


def test_bwd_ref_matches_pallas_backward(monkeypatch):
    """The native Pallas backward in interpret mode
    (LCASR_NATIVE_SSM_BWD=force), all five gradients."""
    monkeypatch.setenv("LCASR_NATIVE_SSM_BWD", "force")
    x, delta, A, Bm, Cm, _ = _inputs(1, 24, 128, 16, seed=6)
    w = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)
    want = _jax_grads(jssm._selective_scan_fast, x, delta, A, Bm, Cm, w)
    got = ssm.selective_scan_bwd_ref(*map(t, (x, delta, A, Bm, Cm, w)))
    for name, g, wv in zip(GRADS, got, want):
        _close(g, wv, name=name)


def test_bwd_ref_matches_torch_autograd_through_the_forward_ref():
    """The written-out reverse recurrence is not autograd: hold the two
    against each other (fp64, so only the algebra can differ)."""
    arrs = [t(a).double().requires_grad_() for a in _inputs(2, 37, 5, 16, seed=8)[:5]]
    w = torch.from_numpy(np.random.default_rng(9).normal(size=(2, 37, 5)))
    y = ssm.selective_scan_ref(*arrs, dtype=torch.float64)
    want = torch.autograd.grad((y * w).sum(), arrs)
    got = ssm.selective_scan_bwd_ref(*[a.detach() for a in arrs], w, dtype=torch.float64)
    for name, g, wv in zip(GRADS, got, want):
        torch.testing.assert_close(g, wv, rtol=1e-10, atol=1e-10, msg=name)


def test_autograd_function_gives_all_six_gradients_in_the_inputs_dtypes():
    """`selective_scan` end to end (the Function, the skip term and the
    casts) against jax.grad of the JAX function; bf16 B and C get bf16
    gradients."""
    x, delta, A, Bm, Cm, Dskip = _inputs(2, 33, 8, 16, seed=10)
    w = np.random.default_rng(11).normal(size=x.shape).astype(np.float32)
    want = jax.jit(jax.grad(
        lambda *a: (jssm.selective_scan(*a, use_pallas=False) * w).sum(),
        argnums=tuple(range(6))))(*map(jnp.asarray, (x, delta, A, Bm, Cm, Dskip)))
    arrs = [t(a).requires_grad_() for a in (x, delta, A, Bm, Cm, Dskip)]
    (ssm.selective_scan(*arrs) * t(w)).sum().backward()
    for name, a, wv in zip(GRADS + ("dD",), arrs, want):
        _close(a.grad, wv, name=name)
    # without a gradient the forward asks for no states
    with torch.no_grad():
        y = ssm.selective_scan(*[a.detach() for a in arrs])
    assert not y.requires_grad
    Bb, Cb = (t(a).bfloat16().requires_grad_() for a in (Bm, Cm))
    ssm.selective_scan(t(x), t(delta), t(A), Bb, Cb).sum().backward()
    assert Bb.grad.dtype == torch.bfloat16 and Cb.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("bias", [True, False])
def test_causal_conv1d_matches_jax(bias):
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 19, 6)).astype(np.float32)
    k = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32) if bias else None
    want = jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(k), None if b is None else jnp.asarray(b))
    got = ssm.causal_conv1d(t(x), t(k), None if b is None else t(b))
    assert_close(got, want)
    # causal: output t ignores inputs after t
    x2 = x.copy()
    x2[:, 10:] = 0.0
    assert torch.equal(ssm.causal_conv1d(t(x2), t(k))[:, :10], ssm.causal_conv1d(t(x), t(k))[:, :10])
    # a bf16 activation with an fp32 bias promotes to fp32, as in JAX
    out = ssm.causal_conv1d(t(x).bfloat16(), t(k).bfloat16(), None if b is None else t(b))
    jout = jssm.causal_conv1d(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                              None if b is None else jnp.asarray(b))
    assert str(out.dtype).replace("torch.", "") == str(jout.dtype)


def test_flip_with_lengths_matches_jax_on_ragged_lengths():
    rng = np.random.default_rng(13)
    x = rng.normal(size=(4, 12, 3)).astype(np.float32)
    lengths = np.array([12, 5, 1, 0], np.int32)
    want = jssm.flip_with_lengths(jnp.asarray(x), jnp.asarray(lengths))
    got = ssm.flip_with_lengths(t(x), t(lengths))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[1, 5:].numpy(), x[1, 5:])  # padding stays
    np.testing.assert_array_equal(ssm.flip_with_lengths(t(x), None).numpy(), x[:, ::-1])
    # an involution: flipping back restores the input
    assert torch.equal(ssm.flip_with_lengths(got, t(lengths)), t(x))


@pytest.mark.parametrize("norm,norm_out,T", [(True, False, 61), (False, True, 64), (True, True, 7)])
def test_stacking_subsampling_matches_jax(norm, norm_out, T):
    from lcasr_tpu.ops.conv import StackingSubsampling as JStack
    from lcasr_torch.ops.conv import StackingSubsampling

    jm = JStack(subsampling_factor=8, feat_in=80, feat_out=32, norm=norm, norm_out=norm_out)
    rng = np.random.default_rng(14)
    x = rng.normal(size=(3, T, 80)).astype(np.float32)
    lengths = np.array([T, max(T - 9, 1), 1], np.int32)
    v = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lengths)), seed=15)
    want, want_len = jm.apply(v, jnp.asarray(x), jnp.asarray(lengths))
    port = load_port(StackingSubsampling(8, 80, 32, norm=norm, norm_out=norm_out), v)
    with torch.no_grad():
        got, got_len = port(t(x), t(lengths))
    assert_close(got, want, atol=1e-4)  # two GEMMs over 640 and 128 terms
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got_len.dtype == torch.int32


def test_kernels_are_registered_for_the_build():
    from lcasr_torch import kernels

    assert "selective_scan.cu" in kernels.SOURCES
    assert (kernels.CSRC / "selective_scan.cu").exists()
    assert {"selective_scan_fwd", "selective_scan_bwd"} <= set(kernels.launch_counts)
    # the CPU wrappers run the plain versions and count nothing
    kernels.reset_launch_counts()
    x, delta, A, Bm, Cm, _ = _inputs(1, 4, 2, 16, seed=16)
    ssm.selective_scan(*map(t, (x, delta, A, Bm, Cm)))
    assert kernels.launch_counts["selective_scan_fwd"] == 0


# ---------------------------------------------------------------------------
# K7's split of the time axis, written out in torch: the algebra the kernel
# implements (csrc/selective_scan.cu, passes 1-3), held against jax.grad and
# the Pallas backward before the card runs it.  Kept out of the package,
# which keeps one plain version, `selective_scan_bwd_ref`.
# ---------------------------------------------------------------------------
TC = ssm.STATE_INTERVAL


def _chunked(a, n_chunks):
    """(Bt, L, ...) zero-padded to n_chunks * TC steps, as (Bt, n_chunks, TC, ...)."""
    pad = n_chunks * TC - a.shape[1]
    a = torch.cat([a, a.new_zeros((a.shape[0], pad) + a.shape[2:])], 1)
    return a.reshape((a.shape[0], n_chunks, TC) + a.shape[2:])


def _local_adjoints(delta, A, Cm, g):
    """Pass 1: each chunk's carry out, a_{t0} lambda_{t0}, from a zero carry in
    (Bt, n_chunks, D, N), and its sum of delta (Bt, n_chunks, D).  Past L the
    inputs are 0 and a step changes nothing."""
    carry = torch.zeros(delta.shape[:2] + (delta.shape[3], A.shape[1]))
    for t in range(TC - 1, -1, -1):
        lam = carry + Cm[:, :, t, None, :] * g[:, :, t, :, None]
        carry = torch.exp(delta[:, :, t, :, None] * A) * lam
    return carry, delta.sum(2)


def _true_carries(local, dsum, A):
    """Pass 2: carry_in(c) = local(c + 1) + gain(c + 1) carry_in(c + 1),
    carry_in(last) = 0, gain(c) = exp(A sum delta over chunk c)."""
    carry = torch.zeros_like(local)
    v = torch.zeros_like(local[:, 0])
    for c in range(local.shape[1] - 1, -1, -1):
        carry[:, c] = v
        v = local[:, c] + torch.exp(A * dsum[:, c, :, None]) * v
    return carry


def _chunk_bodies(x, delta, A, Bm, Cm, g, states, carry):
    """Pass 3: every chunk at once from its true carry: the states recomputed
    forward from the chunk's entry state, then the reverse sweep.  Returns
    the chunked dx, ddelta, dB, dC and dA's per-chunk partials."""
    h = states.transpose(2, 3)  # (Bt, n_chunks, D, N)
    hist = [h]
    for t in range(TC):
        dt = delta[:, :, t, :, None]
        h = torch.exp(dt * A) * h + (dt * x[:, :, t, :, None]) * Bm[:, :, t, None, :]
        hist.append(h)
    dx, dd, dB, dC = [], [], [], []
    dA = torch.zeros_like(h)
    for t in range(TC - 1, -1, -1):
        dt, xt, gt = delta[:, :, t, :, None], x[:, :, t, :, None], g[:, :, t, :, None]
        a = torch.exp(dt * A)
        lam = carry + Cm[:, :, t, None, :] * gt
        sum_lb = (lam * Bm[:, :, t, None, :]).sum(-1)
        gain = lam * a * hist[t]
        dx.append(delta[:, :, t] * sum_lb)
        dd.append(x[:, :, t] * sum_lb + (gain * A).sum(-1))
        dB.append((lam * dt * xt).sum(2))
        dC.append((gt * hist[t + 1]).sum(2))
        dA = dA + gain * dt
        carry = lam * a
    rev = lambda parts: torch.stack(parts[::-1], dim=2)  # noqa: E731
    return rev(dx), rev(dd), rev(dB), rev(dC), dA


def split_time_bwd(x, delta, A, Bm, Cm, g):
    """(dx, ddelta, dA, dB, dC) through K7's three passes, from the chunk-entry
    states the forward saves."""
    Bt, L, _ = x.shape
    _, states = ssm.selective_scan_ref(x, delta, A, Bm, Cm, return_states=True)
    n_chunks = states.shape[1]
    xc, dc, Bc, Cc, gc = (_chunked(a, n_chunks) for a in (x, delta, Bm, Cm, g))
    local, dsum = _local_adjoints(dc, A, Cc, gc)
    carry = _true_carries(local, dsum, A)
    dx, dd, dB, dC, dA = _chunk_bodies(xc, dc, A, Bc, Cc, gc, states, carry)
    flat = lambda a: a.reshape((Bt, n_chunks * TC) + a.shape[3:])[:, :L]  # noqa: E731
    return flat(dx), flat(dd), dA.sum((0, 1)), flat(dB), flat(dC)


@pytest.mark.parametrize("L", [1, 31, 33, 77, 333, 1025], ids=lambda L: f"L{L}")
def test_split_time_bwd_matches_jax_grad(L):
    x, delta, A, Bm, Cm, _ = _inputs(2, L, 6, 16, seed=20 + L)
    w = np.random.default_rng(21).normal(size=x.shape).astype(np.float32)
    want = _jax_grads(jssm._selective_scan_ref, x, delta, A, Bm, Cm, w)
    got = split_time_bwd(*map(t, (x, delta, A, Bm, Cm, w)))
    for name, gv, wv in zip(GRADS, got, want):
        assert gv.dtype == torch.float32 and gv.shape == np.asarray(wv).shape, name
        _close(gv, wv, name=name)


@pytest.mark.parametrize("L", [33, 77], ids=lambda L: f"L{L}")
def test_split_time_bwd_matches_pallas_backward(monkeypatch, L):
    """The native Pallas backward in interpret mode (LCASR_NATIVE_SSM_BWD=force)."""
    monkeypatch.setenv("LCASR_NATIVE_SSM_BWD", "force")
    x, delta, A, Bm, Cm, _ = _inputs(1, L, 128, 16, seed=22)
    w = np.random.default_rng(23).normal(size=x.shape).astype(np.float32)
    want = _jax_grads(jssm._selective_scan_fast, x, delta, A, Bm, Cm, w)
    got = split_time_bwd(*map(t, (x, delta, A, Bm, Cm, w)))
    for name, gv, wv in zip(GRADS, got, want):
        _close(gv, wv, name=name)


def test_chip_smoke_ssm_cases_hold_the_split_edges():
    """chip_smoke.py holds K7 against `selective_scan_bwd_ref` on the card at
    the edges of its split: D not a multiple of the 128-channel block, L on
    either side of a 32-step chunk and one past 64 chunks, one row.  And K6
    against `selective_scan_ref` at the edges of its own (`fwd_segments`):
    one segment and several, multi-chunk segments with L one step past and
    one step short of a segment's end, a one-step last segment at one row
    and at a D cut by the 64-channel block, rows that are not 16-byte
    aligned, and every main shape."""
    import chip_smoke

    cases = chip_smoke.ssm_cases(torch)
    Ls, Ds = {c[2] for c in cases}, {c[3] for c in cases}
    assert {31, 33, 64 * TC + 1} <= Ls and {100, 160} <= Ds
    assert any(c[1] == 1 for c in cases)
    assert chip_smoke.SSM_LONG_SHAPE[:3] in {c[1:4] for c in cases}

    def split(c):
        _, Bt, L, D = c[:4]
        S = ssm.fwd_segments(Bt, L, D)
        return S, -(-ssm._n_chunks(L) // S) * TC, L, D

    splits = [split(c) for c in cases]
    assert any(S == 1 for S, *_ in splits)
    multi = [(S, seg, L) for S, seg, L, _ in splits if S > 2 and seg > TC]
    assert any(L % seg == 1 for _, seg, L in multi) and any(L % seg == seg - 1 for _, seg, L in multi)
    assert any(S > 1 and L % seg == 1 and D % ssm.FWD_CHANNELS for S, seg, L, D in splits)
    assert any(c[1] == 1 and split(c)[0] > 1 for c in cases)
    assert any(c[6] == "odd" and c[3] % 4 for c in cases)  # x's rows unaligned too
    assert {shape[:3] for shape in chip_smoke.SSM_MAIN_SHAPES.values()} <= {c[1:4] for c in cases}


def test_scan_experiment_patches_apply_to_the_source():
    """scripts/scan_bwd_experiments.py patches copies of the scan's source:
    every planted fault and design variant must still find its text exactly
    once, or the script checks or measures nothing."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "scan_bwd_experiments", os.path.join(root, "scripts", "scan_bwd_experiments.py"))
    exp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(exp)
    source = open(os.path.join(root, exp.SOURCE)).read()
    assert exp.CONTROLS
    for name, patches in {**exp.CONTROLS, **exp.VARIANTS}.items():
        text = source
        for old, new in patches:
            assert text.count(old) == 1, (name, old[:60])
            text = text.replace(old, new)
        assert text != source, name


# ---------------------------------------------------------------------------
# K6's split of the time axis, written out in torch: the algebra the kernel
# implements (csrc/selective_scan.cu, `selective_scan_fwd_local` and
# `selective_scan_fwd_body`), held against the JAX reference, the Pallas
# forward and the plain version's chunk-entry states before the card runs
# it.  Kept out of the package, which keeps one plain version,
# `selective_scan_ref`.
# ---------------------------------------------------------------------------
def _run_segments(delta, x, A, Bm, Cm, h):
    """Every segment at once from its entry h (Bt, S, D, N): y (Bt, S, T, D),
    the state at every step's entry (Bt, S, T, D, N) and the exit.  Past L
    the inputs are 0 and a step leaves h as it is."""
    ys, entries = [], []
    for t in range(delta.shape[2]):
        entries.append(h)
        dt = delta[:, :, t, :, None]
        h = torch.exp(dt * A) * h + (dt * x[:, :, t, :, None]) * Bm[:, :, t, None, :]
        ys.append((h * Cm[:, :, t, None, :]).sum(-1))
    return torch.stack(ys, 2), torch.stack(entries, 2), h


def split_time_fwd(x, delta, A, Bm, Cm, segments):
    """y (Bt, L, D) and the chunk-entry states (Bt, ceil(L / 32), N, D)
    through K6's passes: each segment's exit from a zero entry and its sum of
    delta; every entry folded from the exits before it,
    entry(i + 1) = exit0(i) + exp(A sum delta(i)) entry(i); every segment's
    body from its true entry."""
    Bt, L, D = x.shape
    n_chunks = ssm._n_chunks(L)
    per = -(-n_chunks // segments)
    assert -(-n_chunks // per) == segments, "an empty segment"
    seg = per * TC
    pad = lambda a: torch.cat(  # noqa: E731
        [a, a.new_zeros((Bt, segments * seg - L) + a.shape[2:])], 1).reshape(
        (Bt, segments, seg) + a.shape[2:])
    xs, ds, Bs, Cs = (pad(a) for a in (x, delta, Bm, Cm))
    zero = torch.zeros((Bt, segments, D, A.shape[1]))
    _, _, exits = _run_segments(ds, xs, A, Bs, Cs, zero)  # pass 1
    dsum = ds.sum(2)
    entry, h = torch.zeros_like(zero), torch.zeros_like(zero[:, 0])
    for i in range(segments):
        entry[:, i] = h
        h = exits[:, i] + torch.exp(A * dsum[:, i, :, None]) * h
    y, step_entries, _ = _run_segments(ds, xs, A, Bs, Cs, entry)  # pass 2
    y = y.reshape(Bt, segments * seg, D)[:, :L]
    states = step_entries.reshape((Bt, segments * seg) + step_entries.shape[3:])
    return y, states[:, :L:TC].transpose(2, 3).contiguous()


# the JAX reference compiled once per shape: op by op its associative scan
# takes seconds at a few thousand steps
_jax_scan_ref = jax.jit(jssm._selective_scan_ref)


def _hold_split(Bt, L, D, segments, seed):
    x, delta, A, Bm, Cm, _ = _inputs(Bt, L, D, 16, seed=seed)
    y, states = split_time_fwd(*map(t, (x, delta, A, Bm, Cm)), segments)
    want = _jax_scan_ref(*map(jnp.asarray, (x, delta, A, Bm, Cm)))
    _close(y, want, name="y")
    _, want_states = ssm.selective_scan_ref(*map(t, (x, delta, A, Bm, Cm)), return_states=True)
    assert states.shape == want_states.shape == (Bt, ssm._n_chunks(L), 16, D)
    _close(states, want_states.numpy(), name="states")
    return x, delta, A, Bm, Cm, y


# (L, chunks a segment): a segment of 2 chunks (64 steps) with L one step
# short of it, on it, one past it, and one past several; one-chunk segments
# around the first chunk's edge
SPLIT_EDGES = [(1, 1), (31, 1), (32, 1), (33, 1), (63, 2), (64, 2), (65, 2), (3 * 64 + 1, 2),
               (5 * 32 + 1, 1)]


@pytest.mark.parametrize("L,per", SPLIT_EDGES, ids=lambda v: str(v))
def test_split_time_fwd_matches_jax_reference(L, per):
    """Bt 1 and D 70, which is not a multiple of K6's 64-channel block."""
    segments = -(-ssm._n_chunks(L) // per)
    _hold_split(1, L, 70, segments, seed=30 + L)


@pytest.mark.parametrize("L", [33, 97], ids=lambda L: f"L{L}")
def test_split_time_fwd_matches_pallas_interpret(L):
    """The Pallas forward in interpret mode, with the segment count the
    wrapper gives this shape (one-chunk segments at two rows of 128
    channels)."""
    segments = ssm.fwd_segments(2, L, 128)
    assert segments == ssm._n_chunks(L) > 1
    x, delta, A, Bm, Cm, y = _hold_split(2, L, 128, segments, seed=40 + L)
    want = jssm._scan_pallas(*map(jnp.asarray, (x, delta, A, Bm, Cm)))
    _close(y, want)


def test_split_time_fwd_at_a_multi_chunk_segment_choice():
    """The wrapper's own choice where its segments hold several chunks: 16
    rows of 64 channels over 4,225 steps (133 chunks) give 67 segments of
    two chunks, the last of one step.  The split is held at 8 channels: up
    to 64 channels are one block, so the wrapper chooses the same 67
    segments, and the channels are independent of each other."""
    L = 66 * 64 + 1
    segments = ssm.fwd_segments(16, L, 64)
    assert segments == 67 == ssm.fwd_segments(16, L, 8) and L == (segments - 1) * 64 + 1
    _hold_split(16, L, 8, segments, seed=50)


MAIN_SHAPES = {"decode": (32, 2048, 768), "16384x4": (8, 2048, 768), "8192x8": (16, 1024, 768),
               "120000x1": (2, 15000, 768)}


@pytest.mark.parametrize("label", list(MAIN_SHAPES))
def test_fwd_grids_fill_the_card_at_the_main_shapes(label):
    """Each of K6's launches has a block for every one of an H100's 132 SMs
    at the four shapes the Mamba family runs; the decode shape fills the
    card without a split (one exp per (t, d, n))."""
    Bt, L, D = MAIN_SHAPES[label]
    grids = ssm.fwd_grids(Bt, L, D)
    for name, (gx, gy, gz) in grids.items():
        assert name.startswith("selective_scan_fwd_")
        assert gx * gy * gz >= 132, (name, (gx, gy, gz))
        assert gx == -(-D // ssm.FWD_CHANNELS) and gz == Bt
    S = ssm.fwd_segments(Bt, L, D)
    assert (S == 1) == (label == "decode")
    assert set(grids) == ({"selective_scan_fwd_body"} if S == 1 else
                          {"selective_scan_fwd_local", "selective_scan_fwd_body"})


def test_fwd_segments_depend_on_the_shape_alone_and_leave_no_segment_empty():
    """The count is a function of (Bt, L, D): nothing about the states can
    change y.  Segments are whole chunks, of ceil(n_chunks / S) each but the
    last, which is not empty."""
    import inspect

    assert list(inspect.signature(ssm.fwd_segments).parameters) == ["Bt", "L", "D"]
    for Bt in (1, 2, 3, 8, 32):
        for D in (1, 37, 64, 100, 768, 1536):
            for L in (1, 2, 31, 32, 33, 64, 65, 1000, 2048, 15000):
                S = ssm.fwd_segments(Bt, L, D)
                n = ssm._n_chunks(L)
                per = -(-n // S)
                assert 1 <= S <= n and -(-n // per) == S and (S - 1) * per < n, (Bt, L, D)
                blocks = Bt * -(-D // ssm.FWD_CHANNELS)
                if blocks >= ssm.FWD_FILL_BLOCKS:
                    assert S == 1
                else:  # the shortest segments of whole chunks that keep S
                    # within the segments the fill asks for
                    want = min(1 + -(-ssm.FWD_SPLIT_BLOCKS // blocks), n)
                    assert S <= want and (per == 1 or -(-n // (per - 1)) > want)


def test_fwd_wrapper_refuses_nothing_the_cpu_takes_and_counts_nothing():
    """On CPU tensors the wrapper runs the plain version whatever the split
    would be, with and without the states, and counts no launch."""
    from lcasr_torch import kernels

    kernels.reset_launch_counts()
    x, delta, A, Bm, Cm, _ = _inputs(2, 65, 37, 16, seed=60)
    args = list(map(t, (x, delta, A, Bm, Cm)))
    y = ssm.selective_scan_fwd(*args)
    y_s, states = ssm.selective_scan_fwd(*args, return_states=True)
    assert torch.equal(y, y_s) and states.shape == (2, 3, 16, 37)
    assert kernels.launch_counts["selective_scan_fwd"] == 0


def test_scan_fwd_experiment_patches_apply_to_the_sources():
    """scripts/scan_fwd_experiments.py patches copies of the port: every
    planted fault of K6's split (three of them) and every design variant must
    find its text exactly once, or the script checks or measures nothing."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "scan_fwd_experiments", os.path.join(root, "scripts", "scan_fwd_experiments.py"))
    exp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(exp)
    assert set(exp.CONTROLS) == {"carry_dropped", "half_gain", "zero_entry"}
    assert "first_kernel" in exp.VARIANTS
    for name, patches in {**exp.CONTROLS, **exp.VARIANTS}.items():
        texts = {}
        for rel, old, new in patches:
            text = texts.setdefault(rel, open(os.path.join(root, rel)).read())
            assert text.count(old) == 1, (name, rel, old[:60])
            texts[rel] = text.replace(old, new)
        assert any(texts[rel] != open(os.path.join(root, rel)).read() for rel in texts), name


# ---------------------------------------------------------------------------
# d_state other than 16: the plain version against the Pallas kernels, and
# the wrappers' padding up to a built d_state
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("N", [8, 32], ids=lambda n: f"N{n}")
def test_plain_scan_matches_the_pallas_kernels_at_other_d_states(monkeypatch, N):
    """`_scan_pallas` and the native Pallas backward (interpret mode,
    LCASR_NATIVE_SSM_BWD=force) at d_state 8 and 32: y and all five
    gradients of the plain versions within REL of their largest value."""
    monkeypatch.setenv("LCASR_NATIVE_SSM_BWD", "force")
    x, delta, A, Bm, Cm, _ = _inputs(1, 24, 128, N, seed=70 + N)
    w = np.random.default_rng(71 + N).normal(size=x.shape).astype(np.float32)
    want_y = jssm._scan_pallas(*map(jnp.asarray, (x, delta, A, Bm, Cm)))
    _close(ssm.selective_scan_ref(*map(t, (x, delta, A, Bm, Cm))), want_y, name="y")
    want = _jax_grads(jssm._selective_scan_fast, x, delta, A, Bm, Cm, w)
    got = ssm.selective_scan_bwd_ref(*map(t, (x, delta, A, Bm, Cm, w)))
    for name, g, wv in zip(GRADS, got, want):
        assert g.shape == wv.shape
        _close(g, wv, name=name)


@pytest.mark.parametrize("N", [1, 8, 20, 33, 64], ids=lambda n: f"N{n}")
def test_padding_d_state_up_changes_no_output_and_no_gradient(N):
    """What the wrappers do before a kernel runs: pad N up to the built
    d_state (zero columns of B and C, -1 in A).  The plain versions on the
    padded inputs give y, the states and the five gradients of the first N
    states of the unpadded run, and exactly 0 for the padded ones."""
    n_to = ssm.kernel_d_state(N)
    assert n_to == min(b for b in ssm.KERNEL_D_STATES if b >= N)
    x, delta, A, Bm, Cm, _ = _inputs(2, 45, 6, N, seed=80 + N)
    g = torch.from_numpy(np.random.default_rng(81 + N).normal(size=x.shape).astype(np.float32))
    args = list(map(t, (x, delta, A, Bm, Cm)))
    Ap, Bp, Cp = ssm.pad_d_state(*args[2:], n_to)
    assert Ap.shape == (6, n_to) and Bp.shape == Cp.shape == (2, 45, n_to)
    assert (Ap[:, N:] == -1).all() and not Bp[..., N:].any() and not Cp[..., N:].any()
    y, states = ssm.selective_scan_ref(*args, return_states=True)
    y_p, states_p = ssm.selective_scan_ref(*args[:2], Ap, Bp, Cp, return_states=True)
    _close(y_p, y.numpy(), rel=1e-6, name="y")
    assert torch.equal(states_p[:, :, :N], states) and not states_p[:, :, N:].any()
    grads = ssm.selective_scan_bwd_ref(*args, g)
    grads_p = ssm.selective_scan_bwd_ref(*args[:2], Ap, Bp, Cp, g)
    for name, a, b in zip(GRADS, grads, grads_p):
        if name in ("dA", "dB", "dC"):
            assert not b[..., N:].any(), name
            b = b[..., :N]
        _close(b, a.numpy(), rel=1e-6, name=name)


def test_d_state_above_the_largest_built_one_raises_by_name():
    assert ssm.kernel_d_state(64) == 64 and ssm.MAX_D_STATE == 64
    with pytest.raises(ValueError, match="d_state up to 64"):
        ssm.kernel_d_state(65)
    x, delta, A, Bm, Cm, _ = _inputs(1, 3, 4, 65, seed=90)
    with pytest.raises(ValueError, match="d_state up to 64"):
        ssm._kernel_args(*map(t, (x, delta, A, Bm, Cm)))
    # the padded inputs are what the kernels take
    (_, _, A16, B16, C16), tail = ssm._kernel_args(*map(t, _inputs(1, 3, 4, 9, seed=91)[:5]))
    assert A16.shape == (4, 16) and B16.shape == C16.shape == (1, 3, 16) and tail[3] == 16
