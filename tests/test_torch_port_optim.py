"""lcasr_torch's optimizers, decay mask and schedulers against lcasr_tpu's,
on the CPU in fp32.

MADGRAD and MirrorMADGRAD run several steps on the tiny model's
parameters with the same numpy gradients, weight decay on the decay
mask's leaves, the global-norm clip at 0.8 (both branches: clipped and
not) and a learning rate changed by `set_learning_rate` every step.
Tolerance: the same fp32 elementwise arithmetic, with PyTorch's x^(1/3)
for JAX's cbrt and another order for the global norm's sum, keeps the
parameters within a few ulps of their O(1) values: 2e-6 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcasr_torch.models.import_jax import flax_from_state_dict, flax_path, state_dict_from_flax
from tests.test_torch_port_model import TINY
from tests.test_torch_port_ops import randomize

LRS = [3e-4, 1e-3, 0.0, 2e-3, 5e-4]
GRAD_SCALES = [1.0, 1e-4, 1.0, 3.0, 1e-4]  # 1e-4: global norm below the clip


def _model_pair():
    from lcasr_tpu.models.sconformer_xl import SCConformerXL as JModel
    from lcasr_torch.models.sconformer_xl import SCConformerXL

    jm = JModel(**TINY)
    variables = randomize(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 128))), seed=3)
    port = SCConformerXL(**TINY, device="cpu")
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jm, variables, port


def test_decay_mask_matches_jax():
    from lcasr_tpu.models.base import decay_mask as jax_mask
    from lcasr_torch.models.base import decay_mask

    jm, variables, port = _model_pair()
    want = {tuple(k.key for k in path): bool(v) for path, v in
            jax.tree_util.tree_leaves_with_path(jax_mask(variables["params"], model=jm))}
    params = dict(port.named_parameters())
    got = {flax_path(k, params[k])[1]: v for k, v in decay_mask(port).items()}
    assert got == want
    assert any(want.values()) and not all(want.values())


@pytest.mark.parametrize("name", ["madgrad", "mirror_madgrad"])
def test_optimizer_trajectory_matches_jax(name):
    from lcasr_tpu.models.base import decay_mask as jax_mask
    from lcasr_tpu.optim.factory import build_optimizer as jax_build
    from lcasr_tpu.optim.factory import set_learning_rate as jax_set_lr
    from lcasr_torch.models.base import decay_mask
    from lcasr_torch.optim.factory import build_optimizer, set_learning_rate

    jm, variables, port = _model_pair()
    params = jax.tree.map(jnp.asarray, variables["params"])
    opt_j = jax_build(name, lr=LRS[0], weight_decay=0.01, clip_value=0.8,
                      weight_decay_mask=jax_mask(params, model=jm))
    state_j = opt_j.init(params)
    opt_t = build_optimizer(port.named_parameters(), name, lr=LRS[0], weight_decay=0.01,
                            clip_value=0.8, weight_decay_mask=decay_mask(port))
    rng = np.random.default_rng(4)
    for lr, gs in zip(LRS, GRAD_SCALES):
        grads = jax.tree.map(lambda p: (rng.normal(size=p.shape) * gs).astype(np.float32), params)
        state_j = jax_set_lr(state_j, lr)
        upd, state_j = opt_j.update(grads, state_j, params)
        params = jax.tree.map(lambda p, u: p + u, params, upd)

        sd_grads = state_dict_from_flax({"params": grads})
        named = dict(port.named_parameters())
        for key, g in sd_grads.items():
            named[key].grad = g.clone()
        set_learning_rate(opt_t, lr)
        opt_t.step()
        opt_t.zero_grad()

        got = flax_from_state_dict(port.state_dict())["params"]
        for (path, w), (_, g) in zip(jax.tree_util.tree_leaves_with_path(params),
                                     jax.tree_util.tree_leaves_with_path(got)):
            np.testing.assert_allclose(g, np.asarray(w), atol=2e-6, rtol=0,
                                       err_msg=jax.tree_util.keystr(path))


def test_lr_zero_leaves_params_frozen():
    from lcasr_torch.optim.factory import build_optimizer

    p = torch.nn.Parameter(torch.ones(3))
    opt = build_optimizer([("w", p)], "madgrad", lr=0.0, clip_value=0.8)
    p.grad = torch.ones(3)
    opt.step()
    assert torch.equal(p.detach(), torch.ones(3))


def test_cosine_scheduler_sequence_and_state_match_jax():
    from lcasr_tpu.optim.scheduling import CosineLRScheduler as J
    from lcasr_torch.optim.scheduling import CosineLRScheduler as T

    a, b = J(warmup_steps=3, peak_value=3e-4, final_value=3e-5), T(3, 3e-4, 3e-5)
    seq_a, seq_b = [], []
    for s, pod in zip(range(12), range(2, 26, 2)):
        for sch, seq in ((a, seq_a), (b, seq_b)):
            if sch.is_warmup and not sch.is_warming_up():
                sch.set_cosine_schedule(total_recordings=30, cur_podcast=pod)
            seq.append(sch.get_last_lr())
            sch.step() if sch.is_warmup else sch.step(epoch=pod)
    assert seq_a == seq_b and seq_a[0] == 0.0 and min(seq_a[4:]) < 3e-4
    assert a.state_dict() == b.state_dict()
    c = T(0, 1.0, 0.0)
    c.load_state_dict(b.state_dict())
    assert c.get_last_lr() == b.get_last_lr()


def test_sequence_warmup_manager_matches_jax():
    from lcasr_tpu.optim.scheduling import SequenceWarmupManager as J
    from lcasr_torch.optim.scheduling import SequenceWarmupManager as T

    kw = dict(increase_every=8, stop_after=10 ** 9, start_after=0, initial_sequence_length=8192,
              initial_batch_size=8, max_sequence_length=16384)
    a, b = J(**kw), T(**kw)
    outs_a = [a.step(steps=s) for s in (8, 4, 4, 4, 4)]
    outs_b = [b.step(steps=s) for s in (8, 4, 4, 4, 4)]
    assert outs_a == outs_b and outs_a[0] == (True, 16384, 4)
    assert a.state_dict() == b.state_dict()
