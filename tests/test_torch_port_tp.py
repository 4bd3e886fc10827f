"""lcasr_torch's tensor parallelism and ZeRO against lcasr_tpu's, on the CPU
in fp32, and the training CLI under two gloo processes.

The world {data: 2, model: 2} with `zero_optimizer: true` (spawned as in
test_torch_port_parallel.py) trains two optimizer steps on B = 3 (padded to
4): every attention cut by heads, every feed-forward by hidden units, the
decoder by classes, and MADGRAD's three state tensors on half of each
parameter a rank.  The parameters, gathered back to whole tensors, and the running
statistics equal the single-device JAX Trainer's (2e-5 absolute, the
single-device Trainer test's bound) and the JAX Trainer's under the same
mesh up to that run's own departure from the single-device one (logged
losses 1e-4 relative).  The
checkpoint written there holds whole tensors: it loads into a model with no
mesh, whose log-probs equal the JAX model's with the single-device JAX
Trainer's parameters (1e-4), resumes a Trainer with no mesh, and resumes a Trainer
on the same mesh (the same bits).  The layout of ZeRO is checked too: one
flat parameter buffer whose views are the parameters and the optimizer's
pieces, one gradient buffer, the state of this rank's pieces only.

The CLI: `python -m lcasr_torch.cli.train --device cpu` in two processes
with `-o parallel.mesh.data=2` logs, from rank 0 only, the losses of the
single-process run on the same global batch (1e-4 relative).
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tests.test_torch_port_parallel import (
    JOIN_TIMEOUT, MODEL_KW, ROOT, _config, _jax_trainer, _losses, join_world, spawn_world)

TP_MESH = {"data": 2, "model": 2}
TP_DURATIONS = [256, 224, 256, 256, 192, 256]  # two batches of B = 3


def tp_world(mesh, tmp):
    """Rank work of {data: 2, model: 2} under ZeRO."""
    from lcasr_torch.config import Config
    from lcasr_torch.data.dataloading import VariableBatchSimpleDataloader
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.models.registry import load_model
    from lcasr_torch.training.trainer import Trainer

    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    tok = load_tokenizer()
    ckpt = os.path.join(tmp, "train")
    cfg = Config(_config(ckpt, TP_MESH, zero=True))

    def trainer():
        model = load_model(cfg, tok.vocab_size(), device="cpu")
        model.load_state_dict(inp["state"], strict=True)
        tr = Trainer(cfg, model, tok, device="cpu")
        tr.init_state()
        return tr

    tr = trainer()
    assert (tr.dp, tr.tp, tr.zero_opt) == (2, 2, True)
    # half of the heads' projections a rank
    qkv = tr.model.layers[0].attend.qkv_proj.weight
    assert qkv.shape[0] == 3 * MODEL_KW["head_dim"] * MODEL_KW["n_heads"] // 2
    tr.train(VariableBatchSimpleDataloader(pairs=inp["corpus"], tokenizer=tok, batch_size=3,
                                           chunk_size=256, chunk_overlap=0))
    buf = tr._zero.flat.untyped_storage().data_ptr()
    layout = {
        "params_in_buffer": all(p.untyped_storage().data_ptr() == buf for p in tr._params()),
        "pieces_in_buffer": all(t.untyped_storage().data_ptr() == buf
                                for t in tr._zero_slices),
        "param_values": sum(p.numel() for p in tr._params()),
        "piece_values": sum(t.numel() for t in tr._zero_slices),
        "state_values": sum(t.numel() for st in tr.optimizer.inner.state.values()
                            for t in st.values() if torch.is_tensor(t) and t.dim() > 0),
        "grad_buffer": tr._flat_acc.numel(), "buffer": tr._zero.flat.numel()}
    model_state, opt_state = tr._whole_state()
    out = {"train": {k: v.numpy().copy() for k, v in model_state.items()}, "layout": layout}
    if mesh.rank == 0:
        out["losses"] = _losses(os.path.join(ckpt, "metrics.jsonl"))
    again = trainer()
    again.resume()
    m2, o2 = again._whole_state()
    out["resumed_equal"] = (all(torch.equal(model_state[k], m2[k]) for k in model_state)
                            and all(torch.equal(torch.as_tensor(v),
                                                torch.as_tensor(o2["state"][i][n]))
                                    for i, st in opt_state["state"].items()
                                    for n, v in st.items()))
    return out


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from lcasr_tpu.models.sconformer_xl import SCConformerXL as JModel
    from lcasr_torch.models.import_jax import state_dict_from_flax
    from tests.test_torch_port_ops import randomize
    from tests.test_train_trajectory_parity import _make_corpus

    tmp = tmp_path_factory.mktemp("tp_world")
    corpus = _make_corpus(tmp, TP_DURATIONS, seed=41)
    jm = JModel(vocab_size=4095, **MODEL_KW)
    variables = randomize(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 256))), seed=42)
    torch.save({"state": state_dict_from_flax(variables), "corpus": corpus}, tmp / "inputs.pt")
    procs = spawn_world("tests.test_torch_port_tp", "tp_world", TP_MESH, tmp)
    return {"procs": procs, "tmp": tmp, "variables": variables, "corpus": corpus,
            "outs": None}


def _outs(run):
    if run["outs"] is None:
        run["outs"] = join_world(run["procs"], run["tmp"])
    return run["outs"]


@pytest.fixture(scope="module")
def jax_tp_trained(tp_run, tmp_path_factory):
    """The JAX Trainer under the same mesh and ZeRO, and without a mesh."""
    import jax

    from lcasr_tpu.data.dataloading import VariableBatchSimpleDataloader as JLoader
    from tests.test_torch_port_parallel import _jax_trainer_single

    out = {}
    for tag, mesh in (("mesh", TP_MESH), ("single", None)):
        tmp = tmp_path_factory.mktemp(f"tp_jax_{tag}")
        if mesh:
            jtr, jtok, state = _jax_trainer(_config(tmp, mesh, zero=True), tp_run["variables"])
            assert jtr.zero_opt
        else:
            jtr, jtok, state = _jax_trainer_single(_config(tmp), tp_run["variables"])
        state = jtr.train(state, JLoader(pairs=tp_run["corpus"], tokenizer=jtok, batch_size=3,
                                         chunk_size=256, chunk_overlap=0, prefetch=False))
        out[tag] = ({c: jax.tree.map(np.asarray, state[c]) for c in ("params", "batch_stats")},
                    _losses(tmp / "metrics.jsonl"))
    return out


def test_tp_zero_two_steps_match_jax_trainer(tp_run, jax_tp_trained):
    """The parameters and running statistics within 2e-5 of the JAX
    Trainer's without a mesh, and of its run under the same mesh up to
    that run's own departure from the single-device one (XLA's sharded
    layout moves the depthwise kernels' gradients: ~5e-5 after two steps)."""
    from lcasr_torch.models.import_jax import state_dict_from_flax

    (trained, losses_j), (single, _) = jax_tp_trained["mesh"], jax_tp_trained["single"]
    want, want_single = state_dict_from_flax(trained), state_dict_from_flax(single)
    outs = _outs(tp_run)
    assert len(losses_j) == len(outs[0]["losses"]) == 2
    np.testing.assert_allclose(outs[0]["losses"], losses_j, rtol=1e-4)
    assert all("losses" not in o for o in outs[1:])  # only rank 0 writes metrics
    for name, w in want.items():
        ws = want_single[name].numpy()
        jax_own = float(np.abs(w.numpy() - ws).max())
        for o in outs:
            np.testing.assert_allclose(o["train"][name], ws, atol=2e-5, rtol=0, err_msg=name)
            np.testing.assert_allclose(o["train"][name], w.numpy(), atol=2e-5 + jax_own, rtol=0,
                                       err_msg=name)
    assert all(o["resumed_equal"] for o in outs)


def test_zero_keeps_one_parameter_buffer_and_a_shard_of_the_state(tp_run):
    """Under ZeRO every parameter and every optimizer piece is a view of one
    flat buffer, the gradient is accumulated in one buffer of the same
    layout, and MADGRAD holds its three tensors for this rank's pieces only:
    the two data ranks' pieces partition the parameters of their model
    shard."""
    outs = _outs(tp_run)
    for o in outs:
        lay = o["layout"]
        assert lay["params_in_buffer"] and lay["pieces_in_buffer"]
        assert lay["grad_buffer"] == lay["buffer"] < lay["param_values"] + TP_MESH["data"]
        assert lay["state_values"] == 3 * lay["piece_values"]
    for m in range(TP_MESH["model"]):  # ranks (d, m) = d * model + m
        ranks = [outs[d * TP_MESH["model"] + m]["layout"] for d in range(TP_MESH["data"])]
        assert sum(r["piece_values"] for r in ranks) == ranks[0]["param_values"]


def test_tp_zero_checkpoint_loads_without_a_mesh(tp_run, jax_tp_trained):
    import jax.numpy as jnp

    from lcasr_tpu.models.sconformer_xl import SCConformerXL as JModel
    from lcasr_torch.config import Config
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.models.registry import load_model
    from lcasr_torch.training import checkpointing
    from lcasr_torch.training.trainer import Trainer

    _outs(tp_run)
    latest = checkpointing.find_latest_checkpoint(str(tp_run["tmp"] / "train"))
    arrays, _ = checkpointing.load_checkpoint(latest)
    tok = load_tokenizer()
    cfg = Config(_config(tp_run["tmp"] / "nomesh"))
    model = load_model(cfg, tok.vocab_size(), device="cpu")
    model.load_state_dict(arrays["model"], strict=True)  # whole tensors, the port's names
    audio = np.random.default_rng(43).normal(size=(2, 80, 256)).astype(np.float32)
    lens = np.array([256, 180], np.int32)
    with torch.no_grad():
        got = model(torch.from_numpy(audio), length=torch.from_numpy(lens))["final_posteriors"]
    trained, _ = jax_tp_trained["single"]
    want = JModel(vocab_size=4095, **MODEL_KW).apply(trained, jnp.asarray(audio),
                                                       length=jnp.asarray(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want["final_posteriors"]), atol=1e-4,
                               rtol=0)
    tr = Trainer(Config(_config(tp_run["tmp"] / "train")), model, tok, device="cpu")
    step, _, _ = tr.resume()  # the gathered optimizer state fits one device's optimizer
    assert step == 6
    shapes = {n: p.shape for n, p in model.named_parameters()}
    for i, st in tr.optimizer.state_dict()["state"].items():
        assert st["grad_sum_sq"].shape == shapes[tr._opt_names[i]]


# ---------------------------------------------------------------------------
# the CLI in two processes
# ---------------------------------------------------------------------------
def _cli_config(tmp, corpus):
    import yaml

    cfg = _config(tmp / "ckpt", batch_size=2)
    cfg["data"]["path"] = str(tmp / "pairs.json")
    json.dump(corpus, open(tmp / "pairs.json", "w"))
    yaml.safe_dump(cfg, open(tmp / "cfg.yaml", "w"))
    return tmp / "cfg.yaml"


def test_cli_two_gloo_processes_match_one(tmp_path):
    """Four recordings, batch 2: two optimizer steps; the data-2 run splits
    each batch 1 + 1."""
    from tests.test_train_trajectory_parity import _make_corpus

    corpus = _make_corpus(tmp_path, [256, 256, 240, 256], seed=44)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    runs = {}
    for name, n in (("one", 1), ("two", 2)):
        d = tmp_path / name
        d.mkdir()
        cfg = _cli_config(d, corpus)
        cmd = [sys.executable, "-m", "lcasr_torch.cli.train", "-config", str(cfg),
               "--device", "cpu"]
        if n > 1:
            cmd += ["--coordinator_address", f"file://{d}/pg", "--num_processes", str(n),
                    "--dist_timeout", "90", "-o", f"parallel.mesh.data={n}"]
        procs = [subprocess.Popen(cmd + (["--process_id", str(r)] if n > 1 else []), cwd=ROOT,
                                  env=env, stdout=open(d / f"log{r}.txt", "w"),
                                  stderr=subprocess.STDOUT) for r in range(n)]
        deadline = time.monotonic() + JOIN_TIMEOUT
        for r, p in enumerate(procs):
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                rc = "timeout"
            assert rc == 0, f"{name} rank {r}: {rc}\n{open(d / f'log{r}.txt').read()[-3000:]}"
        runs[name] = _losses(d / "ckpt" / "metrics.jsonl")
    assert len(runs["one"]) == 2
    # rank 1 wrote nothing: the shared metrics file holds one run's rows
    assert len(runs["two"]) == len(runs["one"])
    np.testing.assert_allclose(runs["two"], runs["one"], rtol=1e-4)


def test_chip_smoke_tp_config_is_the_yaml():
    """chip_smoke.py carries configs/lcasr_3l_2048d_16h_tp.yaml as a dict (the
    card's machine is not promised pyyaml): every section it keeps equals the
    file's."""
    import yaml

    import chip_smoke

    with open(ROOT / "configs" / "lcasr_3l_2048d_16h_tp.yaml") as f:
        want = yaml.safe_load(f)
    assert set(chip_smoke.TP_CONFIG) <= set(want)
    for section, value in chip_smoke.TP_CONFIG.items():
        assert value == want[section], section


def test_tensor_and_context_parallelism_name_the_family_they_refuse():
    """Only SCConformerXL has a tensor-parallel layout and a time-sharded
    path; the Mamba and the encoder-decoder family raise by name (data
    parallelism works for every family the Trainer trains)."""
    from lcasr_torch.models.enc_dec_sconformer import EncDecSconformer
    from lcasr_torch.models.mamba import Mamba
    from lcasr_torch.parallel.cp_model import bind_mesh
    from lcasr_torch.parallel.tensor_parallel import parallelize

    for model in (Mamba(vocab_size=16, d_model=32, n_layers=1, subsampling_conv_channels=8,
                        device="cpu"),
                  EncDecSconformer(vocab_size=16, d_model=32, n_layers=1, n_heads=1,
                                   head_dim=32, decoder_layers=1,
                                   subsampling_conv_channels=8, device="cpu")):
        name = type(model).__name__
        with pytest.raises(NotImplementedError, match=f"tensor parallelism .*{name}"):
            parallelize(model, None)
        with pytest.raises(NotImplementedError, match=f"context parallelism .*{name}"):
            bind_mesh(model, None, seq_axis="seq")
