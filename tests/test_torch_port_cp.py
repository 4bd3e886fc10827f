"""lcasr_torch's context parallelism against lcasr_tpu's, on the CPU in fp32:
one spawned gloo world {seq: 4} (see test_torch_port_parallel.py for how
worlds are spawned and timed out) runs every check, and the JAX references
run on the forced 8-device CPU mesh in the test process meanwhile.

  * the halo exchange (left 2, right 3 frames) and its backward against
    JAX `halo_exchange` under shard_map: exact values, gradients 1e-6;
  * gather and ring attention, forward and the gradients of q, k and v,
    with windows (-1, -1) and (64, 64), against JAX
    `context_parallel_attention` / `ring_attention`: outputs 1e-5,
    gradients 1e-4 of their largest entry (the ring merges partial
    softmaxes in another order);
  * the full-model forward (gather with full attention, ring with an (8, 8)
    band) against JAX `context_parallel_apply`: log-probs 1e-4 (the bound
    of the single-device model tests);
  * one CP training step through `context_parallel_apply` (ring, band
    (8, 8), CTC loss of the gathered log-probs): loss 1e-4 relative,
    gradients as in test_torch_port_parallel.py, running statistics 2e-5;
  * two optimizer steps of the Trainer under {seq: 4} against the JAX
    Trainer with the same mesh: logged losses 1e-4 relative, parameters
    and running statistics 2e-5 absolute;
  * `evaluate` in windowed_attention mode with `context_parallel` on the
    checkpoint those steps wrote: the single pass through
    make_cp_windowed_model_fn on {seq: 4}, log-probs within 1e-4 of the
    single pass without it.
"""
import os

import numpy as np
import pytest
import torch

from tests.test_torch_port_parallel import _config, _losses, assert_evaluate_on_mesh, \
    assert_grads_close, evaluate_spied, join_world, spawn_world

N = 4
TINY = dict(vocab_size=16, d_model=64, n_layers=2, n_heads=2, head_dim=32,
            subsampling_conv_channels=32, use_rotary=True, rotary_base_freq=1.5e6)
ATT = dict(B=2, T=256, H=2, D=32)
ATT_LENS = np.array([256, 201], np.int32)
WINDOWS = [(-1, -1), (64, 64)]
HALO = dict(shape=(2, 4 * 8, 6), left=2, right=3)
MODEL_T = 256  # a multiple of 4 shards x subsampling 8
MODEL_LENS = np.array([256, 190], np.int32)
FORWARDS = {"gather": (-1, -1), "ring": (8, 8)}
CP_DURATIONS = [256, 256, 256, 256]


def _cp_step_batch(seed=31):
    rng = np.random.default_rng(seed)
    return {"labels": rng.integers(1, TINY["vocab_size"], size=(2, 8)).astype(np.int64),
            "label_lengths": np.array([7, 4], np.int32),
            "weight": np.array([1.0, 1.0], np.float32)}


def cp_world(mesh, tmp):
    """Rank work of {seq: 4}."""
    import torch.distributed as dist

    from lcasr_torch.config import Config
    from lcasr_torch.data.dataloading import VariableBatchSimpleDataloader
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.models.registry import load_model
    from lcasr_torch.models.sconformer_xl import SCConformerXL
    from lcasr_torch.ops.ctc import ctc_loss
    from lcasr_torch.parallel.collectives import halo_exchange
    from lcasr_torch.parallel.context_parallel import context_parallel_attention
    from lcasr_torch.parallel.cp_model import context_parallel_apply, shard_time
    from lcasr_torch.parallel.ring_attention import ring_attention
    from lcasr_torch.training.trainer import Trainer

    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    axis, i = mesh.axis("seq"), mesh.index("seq")
    out = {}

    x = shard_time(torch.from_numpy(inp["halo_x"]), mesh, dim=1).clone().requires_grad_()
    y = halo_exchange(x, axis, HALO["left"], HALO["right"], dim=1)
    (y * torch.from_numpy(inp["halo_w"][i])).sum().backward()
    out["halo"] = (y.detach().numpy(), x.grad.numpy())

    lens = torch.from_numpy(ATT_LENS)
    for window in WINDOWS:
        for name, fn in (("gather", context_parallel_attention), ("ring", ring_attention)):
            q, k, v = (shard_time(torch.from_numpy(inp[n]), mesh, dim=1).clone()
                       .requires_grad_() for n in ("q", "k", "v"))
            o = fn(q, k, v, axis, lengths=lens, window=window)
            (o * shard_time(torch.from_numpy(inp["do"]), mesh, dim=1)).sum().backward()
            out[("attention", name, window)] = (o.detach().numpy(), q.grad.numpy(),
                                                k.grad.numpy(), v.grad.numpy())

    audio = torch.from_numpy(inp["audio"])
    local = shard_time(audio, mesh)
    mlens = torch.from_numpy(MODEL_LENS)
    for impl, window in FORWARDS.items():
        m = SCConformerXL(**TINY, attention_window_size=window[0], attention_cp_impl=impl,
                          device="cpu")
        m.load_state_dict(inp["state"], strict=True)
        with torch.no_grad():
            res = context_parallel_apply(m, local, mesh, lengths=mlens, gather=True)
        out[("forward", impl)] = res["final_posteriors"].numpy()

    m = SCConformerXL(**TINY, attention_window_size=8, attention_cp_impl="ring", device="cpu")
    m.load_state_dict(inp["state"], strict=True)
    b = {k: torch.from_numpy(v) for k, v in inp["step"].items()}
    res = context_parallel_apply(m, local, mesh, lengths=mlens, train=True, gather=True)
    nll = ctc_loss(res["final_posteriors"].float(), b["labels"], res["length"],
                   b["label_lengths"], blank_id=TINY["vocab_size"], reduction="none")
    loss = (torch.where(nll < 1e29, nll, torch.zeros_like(nll)) * b["weight"]).sum()
    loss.backward()
    grads = {}
    for name, p in m.named_parameters():
        g = p.grad.clone()
        dist.all_reduce(g, group=axis.group)
        grads[name] = g.numpy()
    out["step"] = {"loss": float(loss), "grads": grads,
                   "stats": {k: v.numpy().copy() for k, v in m.state_dict().items()
                             if "running" in k}}

    tok = load_tokenizer()
    ckpt = os.path.join(tmp, "train")
    cfg = Config(_config(ckpt, {"seq": N}, batch_size=2))
    model = load_model(cfg, tok.vocab_size(), device="cpu")
    model.load_state_dict(inp["trainer_state"], strict=True)
    tr = Trainer(cfg, model, tok, device="cpu")
    assert tr.cp == N
    tr.init_state()
    tr.train(VariableBatchSimpleDataloader(pairs=inp["corpus"], tokenizer=tok, batch_size=2,
                                           chunk_size=256, chunk_overlap=0))
    out["train"] = {k: v.numpy().copy() for k, v in tr.model.state_dict().items()}
    if mesh.rank == 0:
        out["losses"] = _losses(os.path.join(ckpt, "metrics.jsonl"))
    # the evaluation entry point's windowed single pass on that checkpoint
    dist.barrier()  # rank 0 has written it
    out["evaluate"] = {cp: evaluate_spied(ckpt, evaluation_mode="windowed_attention",
                                          context_parallel=cp) for cp in (False, True)}
    return out


def _jax_model(**kw):
    from lcasr_tpu.models.sconformer_xl import SCConformerXL as JModel

    return JModel(**TINY, **kw)


@pytest.fixture(scope="module")
def cp_run(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from lcasr_tpu.models.sconformer_xl import SCConformerXL as JModel
    from lcasr_torch.models.import_jax import state_dict_from_flax
    from tests.test_torch_port_ops import randomize
    from tests.test_torch_port_parallel import MODEL_KW
    from tests.test_train_trajectory_parity import _make_corpus

    tmp = tmp_path_factory.mktemp("cp_world")
    rng = np.random.default_rng(30)
    shape = (ATT["B"], ATT["T"], ATT["H"], ATT["D"])
    inp = {n: rng.normal(size=shape).astype(np.float32) for n in ("q", "k", "v", "do")}
    inp["halo_x"] = rng.normal(size=HALO["shape"]).astype(np.float32)
    t = HALO["shape"][1] // N + HALO["left"] + HALO["right"]
    inp["halo_w"] = rng.normal(size=(N, HALO["shape"][0], t, HALO["shape"][2])).astype(
        np.float32)
    inp["audio"] = rng.normal(size=(2, 80, MODEL_T)).astype(np.float32)
    variables = randomize(_jax_model().init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 256))),
                          seed=32)
    inp["state"] = state_dict_from_flax(variables)
    inp["step"] = _cp_step_batch()
    corpus = _make_corpus(tmp, CP_DURATIONS, seed=33)
    jm = JModel(vocab_size=4095, **MODEL_KW)
    trainer_vars = randomize(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 256))), seed=34)
    inp["trainer_state"] = state_dict_from_flax(trainer_vars)
    inp["corpus"] = corpus
    torch.save(inp, tmp / "inputs.pt")
    procs = spawn_world("tests.test_torch_port_cp", "cp_world", {"seq": N}, tmp)
    return {"procs": procs, "tmp": tmp, "inp": inp, "variables": variables,
            "trainer_vars": trainer_vars, "outs": None}


def _outs(run):
    if run["outs"] is None:
        run["outs"] = join_world(run["procs"], run["tmp"])
    return run["outs"]


def _mesh():
    from lcasr_tpu.parallel.mesh import make_mesh

    return make_mesh({"seq": N})


def _cat(outs, key, part=None):
    return np.concatenate([o[key] if part is None else o[key][part] for o in outs], axis=1)


def test_halo_exchange_matches_jax(cp_run):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from lcasr_tpu.ops.conv import halo_exchange

    inp = cp_run["inp"]
    fn = shard_map(lambda x: halo_exchange(x, "seq", HALO["left"], HALO["right"], axis=1),
                   mesh=_mesh(), in_specs=P(None, "seq", None), out_specs=P(None, "seq", None),
                   check_vma=False)
    w = np.concatenate(list(inp["halo_w"]), axis=1)
    y_j = np.asarray(fn(jnp.asarray(inp["halo_x"])))
    g_j = np.asarray(jax.grad(lambda x: (fn(x) * w).sum())(jnp.asarray(inp["halo_x"])))
    outs = _outs(cp_run)
    np.testing.assert_array_equal(np.concatenate([o["halo"][0] for o in outs], 1), y_j)
    np.testing.assert_allclose(np.concatenate([o["halo"][1] for o in outs], 1), g_j,
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("impl", ["gather", "ring"])
@pytest.mark.parametrize("window", WINDOWS, ids=["full", "band64"])
def test_cp_attention_matches_jax(cp_run, impl, window):
    import jax
    import jax.numpy as jnp

    from lcasr_tpu.parallel.context_parallel import context_parallel_attention
    from lcasr_tpu.parallel.ring_attention import ring_attention

    fn = {"gather": context_parallel_attention, "ring": ring_attention}[impl]
    inp, mesh = cp_run["inp"], _mesh()
    lens = jnp.asarray(ATT_LENS)

    def f(q, k, v):
        return (fn(q, k, v, mesh, lengths=lens, window=window) * inp["do"]).sum()

    qkv = [jnp.asarray(inp[n]) for n in ("q", "k", "v")]
    want = [np.asarray(fn(*qkv, mesh, lengths=lens, window=window))]
    want += [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(*qkv)]
    outs = _outs(cp_run)
    got = [np.concatenate([o[("attention", impl, window)][j] for o in outs], 1)
           for j in range(4)]
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(), rtol=0)


@pytest.mark.slow  # as JAX's full-model CP tests: its side compiles for ~40 s
@pytest.mark.parametrize("impl", list(FORWARDS))
def test_full_model_cp_forward_matches_jax(cp_run, impl):
    """Subsampling and conv halos, rotary at global positions, the CP
    attention: the gathered log-probs against JAX context_parallel_apply."""
    import jax.numpy as jnp

    from lcasr_tpu.parallel.cp_model import context_parallel_apply

    window = FORWARDS[impl]
    jm = _jax_model(attention_window_size=window[0], attention_cp_impl=impl)
    want = context_parallel_apply(jm, cp_run["variables"], jnp.asarray(cp_run["inp"]["audio"]),
                                  _mesh(), lengths=jnp.asarray(MODEL_LENS))
    want = np.asarray(want["final_posteriors"])
    got = _outs(cp_run)
    for o in got:  # gathered: every rank holds the whole sequence
        np.testing.assert_allclose(o[("forward", impl)], want, atol=1e-4, rtol=0)


@pytest.mark.slow  # as JAX's CP training-step test: its side compiles for ~200 s
def test_cp_training_step_matches_jax(cp_run):
    """One ring-attention training step through context_parallel_apply:
    the loss, the gradient summed over seq and the running statistics."""
    import jax
    import jax.numpy as jnp

    from lcasr_tpu.ops.ctc import ctc_loss as jax_ctc
    from lcasr_tpu.parallel.cp_model import context_parallel_apply
    from lcasr_torch.models.import_jax import state_dict_from_flax

    jm = _jax_model(attention_window_size=8, attention_cp_impl="ring")
    v, step = cp_run["variables"], _cp_step_batch()
    mesh, audio = _mesh(), jnp.asarray(cp_run["inp"]["audio"])

    def f(params):
        out, mut = context_parallel_apply(jm, {"params": params, "batch_stats": v["batch_stats"]},
                                          audio, mesh, lengths=jnp.asarray(MODEL_LENS),
                                          train=True, mutable=True)
        nll = jax_ctc(out["final_posteriors"].astype(jnp.float32), step["labels"],
                      out["length"], step["label_lengths"], blank_id=TINY["vocab_size"],
                      reduction="none")
        return (jnp.where(nll < 1e29, nll, 0.0) * step["weight"]).sum(), mut

    (loss_j, mut), g_j = jax.value_and_grad(f, has_aux=True)(v["params"])
    want = state_dict_from_flax({"params": jax.tree.map(np.asarray, g_j)})
    stats = state_dict_from_flax({"batch_stats": jax.tree.map(np.asarray, mut["batch_stats"])})
    for o in _outs(cp_run):
        np.testing.assert_allclose(o["step"]["loss"], float(loss_j), rtol=1e-4)
        assert_grads_close(o["step"]["grads"], {k: w.numpy() for k, w in want.items()})
        for name, w in stats.items():
            if "running" in name:
                np.testing.assert_allclose(o["step"]["stats"][name], w.numpy(), atol=2e-5,
                                           err_msg=name)


def test_cp_trainer_matches_jax_trainer(cp_run, tmp_path):
    """Two optimizer steps (chunk 256 x batch 2, 4 time shards of 64
    frames) of both Trainers under {seq: 4}."""
    import jax

    from lcasr_tpu.data.dataloading import VariableBatchSimpleDataloader as JLoader
    from lcasr_torch.models.import_jax import state_dict_from_flax
    from tests.test_torch_port_parallel import _jax_trainer

    jtr, jtok, state = _jax_trainer(_config(tmp_path, {"seq": N}, batch_size=2),
                                    cp_run["trainer_vars"])
    assert jtr.cp_shards == N
    state = jtr.train(state, JLoader(pairs=cp_run["inp"]["corpus"], tokenizer=jtok,
                                     batch_size=2, chunk_size=256, chunk_overlap=0,
                                     prefetch=False))
    want = state_dict_from_flax({c: jax.tree.map(np.asarray, state[c])
                                 for c in ("params", "batch_stats")})
    outs = _outs(cp_run)
    losses_j = _losses(tmp_path / "metrics.jsonl")
    assert len(losses_j) == len(outs[0]["losses"]) == 2
    np.testing.assert_allclose(outs[0]["losses"], losses_j, rtol=1e-4)
    for name, w in want.items():
        for o in outs:
            np.testing.assert_allclose(o["train"][name], w.numpy(), atol=2e-5, rtol=0,
                                       err_msg=name)


def test_evaluate_context_parallel_shards_the_single_pass(cp_run):
    """`evaluate(evaluation_mode="windowed_attention", context_parallel=True)`
    in the {seq: 4} world runs the single pass through
    make_cp_windowed_model_fn on {seq: 4} (1,000 frames padded to 1,024, four
    shards of 256): on every rank its log-probs equal the single pass
    without it within 1e-4 (the full-model CP forward's bound above)."""
    for out in _outs(cp_run):
        assert_evaluate_on_mesh(out["evaluate"], {"data": 1, "model": 1, "seq": N}, 1e-4)
