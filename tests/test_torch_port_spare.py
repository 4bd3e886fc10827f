"""The spare components against their flax counterparts on the CPU: SwiGLU,
Conv1DSubsampling (train and eval), TimeReductionModule (odd T, lengths) and
ScaledSinuEmbedding.  Same numpy inputs and the same weights (flax init ->
`randomize` -> `state_dict_from_flax` -> strict load); fp32 on both sides, so
the tolerance is fp32 rounding of sums of a few hundred terms: 1e-5 absolute
(1e-4 for the SiLU chain of Conv1DSubsampling, whose values reach ~10)."""
import jax
import numpy as np
import pytest
import torch

from lcasr_torch.models.import_jax import flax_from_state_dict, state_dict_from_flax
from tests.test_torch_port_ops import assert_close, load_port, randomize, t


def test_swiglu_matches_jax():
    from lcasr_tpu.ops.mlp import SwiGLU as JSwiGLU
    from lcasr_torch.ops.mlp import SwiGLU

    x = np.random.default_rng(0).normal(size=(2, 11, 32)).astype(np.float32)
    jm = JSwiGLU(32, expansion_factor=3)
    variables = randomize(jm.init(jax.random.PRNGKey(0), x), seed=1)
    port = load_port(SwiGLU(32, expansion_factor=3), variables)
    assert_close(port(t(x)), jm.apply(variables, x))


@pytest.mark.parametrize("train,batch_norm", [(False, True), (True, True), (False, False)],
                         ids=["eval_norm", "train_norm", "no_norm"])
def test_conv1d_subsampling_matches_jax(train, batch_norm):
    from lcasr_tpu.ops.conv import Conv1DSubsampling as JSub
    from lcasr_torch.ops.conv import Conv1DSubsampling

    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 37, 16)).astype(np.float32)
    lengths = np.array([37, 20, 5], np.int32)
    jm = JSub(subsampling_factor=4, feat_in=16, feat_out=24, conv_channels=8,
              batch_norm=batch_norm)
    variables = randomize(jm.init(jax.random.PRNGKey(0), x, lengths, train=train), seed=3)
    port = load_port(Conv1DSubsampling(4, 16, 24, 8, batch_norm=batch_norm), variables)
    if train:
        (want, want_len), mutated = jm.apply(variables, x, lengths, train=True,
                                             mutable=["batch_stats"])
    else:
        want, want_len = jm.apply(variables, x, lengths, train=False)
    got, got_len = port(t(x), t(lengths), train=train)
    assert_close(got, want, atol=1e-4)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    if train:  # the running statistics move as flax's do
        new = flax_from_state_dict(port.state_dict())["batch_stats"]
        for i in range(2):
            for name in ("running_mean", "running_std", "num_batches_tracked"):
                assert_close(torch.from_numpy(np.asarray(new[f"norm_{i}"][name])),
                             mutated["batch_stats"][f"norm_{i}"][name], atol=1e-6)


@pytest.mark.parametrize("T,with_lengths", [(23, True), (24, True), (23, False)],
                         ids=["odd_lengths", "even_lengths", "odd_no_lengths"])
def test_time_reduction_matches_jax(T, with_lengths):
    from lcasr_tpu.ops.conv import TimeReductionModule as JTR
    from lcasr_torch.ops.conv import TimeReductionModule

    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, T, 16)).astype(np.float32)
    lengths = np.array([T, T - 8], np.int32) if with_lengths else None
    jm = JTR(d_model=16, out_dim=12)
    variables = randomize(jm.init(jax.random.PRNGKey(0), x, lengths), seed=5)
    port = load_port(TimeReductionModule(16, 12), variables)
    want, want_len = jm.apply(variables, x, lengths)
    got, got_len = port(t(x), None if lengths is None else t(lengths))
    assert got.shape == want.shape
    assert_close(got, want)
    if with_lengths:
        assert got.shape[1] == -(-T // 2)
        np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    else:
        assert got_len is None and want_len is None


def test_time_reduction_init_is_the_jax_uniform_bounds():
    from lcasr_torch.ops.conv import TimeReductionModule

    torch.manual_seed(0)
    m = TimeReductionModule(64, 32, kernel_size=5)
    for p, bound in ((m.dw_kernel, 5 ** -0.5), (m.dw_bias, 5 ** -0.5),
                     (m.pw.weight, 64 ** -0.5), (m.pw.bias, 64 ** -0.5)):
        assert p.abs().max().item() <= bound and p.abs().max().item() > 0.8 * bound


def test_scaled_sinu_embedding_matches_jax():
    from lcasr_tpu.models.positional import ScaledSinuEmbedding as JSinu
    from lcasr_torch.models.positional import ScaledSinuEmbedding

    x = np.random.default_rng(6).normal(size=(2, 50, 32)).astype(np.float32)
    jm = JSinu(32)
    variables = randomize(jm.init(jax.random.PRNGKey(0), x), seed=7)
    port = load_port(ScaledSinuEmbedding(32), variables)
    # sin / cos of fp32 arguments up to 49: fp32 rounding of the argument
    assert_close(port(t(x)), jm.apply(variables, x), atol=2e-5)


def test_spare_components_round_trip_through_the_converter():
    """Every spare component's flax names load strictly, come back the same
    through `flax_from_state_dict`, and an unknown name still raises."""
    from lcasr_tpu.ops.conv import Conv1DSubsampling as JSub, TimeReductionModule as JTR

    x = np.zeros((1, 16, 8), np.float32)
    lengths = np.array([16], np.int32)
    for jm, args in ((JSub(4, 8, 8, 8, batch_norm=True), (x, lengths)),
                     (JTR(8, 8), (x, lengths))):
        variables = randomize(jm.init(jax.random.PRNGKey(0), *args), seed=8)
        back = flax_from_state_dict(state_dict_from_flax(variables))
        for path, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]:
            node = back
            for k in path:
                node = node[k.key]
            np.testing.assert_array_equal(node, np.asarray(leaf))
    with pytest.raises(ValueError, match="unknown"):
        state_dict_from_flax({"params": {"pw": {"dw_weight": np.zeros(3, np.float32)}}})
