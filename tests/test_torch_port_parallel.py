"""lcasr_torch's parallel layer against lcasr_tpu's, on the CPU in fp32.

In one process: the partition rules on every leaf of the flagship's and the
tensor-parallel config's flax trees, `merge`, the ring schedule's per-block
compute over n blocks against JAX `ring_attention` on the forced 8-device
CPU mesh, and `make_mesh`'s errors.

Spawned gloo worlds: `spawn_world` starts one Python process per rank
(workers import torch and lcasr_torch only, never jax), each joins the group
through a file in the test's temporary directory (no ports to race for),
with a 90 s collective timeout and a 120 s join limit, so that a deadlock
fails one test and does not hang the suite.  Each world shape is one
module-scoped spawn that runs all its checks; the JAX references are
computed in the test process while the workers run.  This file holds the
data-parallel world {data: 2} with B = 3 (one padded row): one Trainer micro
step (loss, all-reduced gradient, renorm running statistics) against the
JAX Trainer's micro step, two optimizer steps of both Trainers (logged
losses, parameters after MADGRAD, running statistics), the mesh decode
against JAX `StreamingDecoder(mesh=...)`, and `evaluate(data_parallel=True)`
on the checkpoint those steps wrote against `evaluate` without it.

Tolerances: losses 1e-4 relative (sums over ~300 frames in another order);
gradients 1e-4 of each tensor's largest entry, never below 1e-6 of the
largest gradient of all (the bound of the single-device gradient test in
test_torch_port_train.py); parameters after two MADGRAD steps and running
statistics 2e-5 absolute (that file's Trainer bound); decode log-probs
1e-4 absolute (test_torch_port_streaming.py's bound), `evaluate`'s on the
mesh against its own without one 1e-5; partition specs and merges exact
or 1e-6.
"""
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
COLLECTIVE_TIMEOUT = 90  # s, every collective of a spawned group
JOIN_TIMEOUT = 120  # s, a whole spawned world


# ---------------------------------------------------------------------------
# spawning gloo worlds (the workers import no jax)
# ---------------------------------------------------------------------------
def run_rank(module: str, fn: str, rank: int, n: int, shape: str, tmp: str) -> None:
    """A worker: join the gloo world, build the mesh, run `module.fn(mesh,
    tmp)` and save what it returns to tmp/out<rank>.pt."""
    import torch.distributed as dist

    from lcasr_torch.parallel.mesh import make_mesh, maybe_init_distributed

    torch.set_num_threads(1)
    maybe_init_distributed(num_processes=n, process_id=rank, device="cpu",
                           init_method=f"file://{tmp}/pg", timeout=COLLECTIVE_TIMEOUT)
    mesh = make_mesh(json.loads(shape))
    out = getattr(importlib.import_module(module), fn)(mesh, tmp)
    torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def spawn_world(module: str, fn: str, shape: dict, tmp) -> list:
    """Start one process per rank of `shape`; returns them (`join_world`)."""
    n = int(np.prod(list(shape.values())))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    procs = []
    for r in range(n):
        code = (f"from tests.test_torch_port_parallel import run_rank; "
                f"run_rank({module!r}, {fn!r}, {r}, {n}, {json.dumps(shape)!r}, {str(tmp)!r})")
        log = open(os.path.join(tmp, f"log{r}.txt"), "w")
        procs.append((subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                                       stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def join_world(procs, tmp) -> list:
    """Wait (JOIN_TIMEOUT in all) and return each rank's output; kill the
    world and fail with the logs' tails on a timeout or an error."""
    import time

    deadline = time.monotonic() + JOIN_TIMEOUT
    failed = []
    for r, (p, log) in enumerate(procs):
        try:
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            rc = "timeout"
        if rc != 0:
            failed.append((r, rc))
    for p, log in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()
    if failed:
        tails = "\n".join(f"--- rank {r} ({rc}):\n" + open(os.path.join(tmp, f"log{r}.txt"))
                          .read()[-3000:] for r, rc in failed)
        pytest.fail(f"spawned world failed: {failed}\n{tails}")
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(len(procs))]


def assert_grads_close(got: dict, want: dict):
    """Each tensor within 1e-4 of its largest entry, never below 1e-6 of the
    largest gradient of all (a bias in front of BatchRenorm has a gradient
    that is 0 up to rounding)."""
    assert set(got) == set(want)
    gmax = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        tol = 1e-4 * max(float(np.abs(w).max()), 1e-2 * gmax)
        np.testing.assert_allclose(np.asarray(got[name]), np.asarray(w), atol=tol, rtol=0,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# in one process
# ---------------------------------------------------------------------------
def _flax_shapes(model_kw):
    import jax
    import jax.numpy as jnp

    from lcasr_tpu.models.sconformer_xl import SCConformerXL as JModel

    jm = JModel(**model_kw)
    return jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 256))))


def _yaml_model(name):
    import yaml

    cfg = yaml.safe_load(open(ROOT / "configs" / name))
    return dict(cfg["model"], vocab_size=4095), cfg.get("parallel", {})


@pytest.mark.parametrize("config", ["lcasr_9l_768d_6h.yaml", "lcasr_3l_2048d_16h_tp.yaml"])
def test_partition_specs_match_jax_on_every_leaf(config):
    """param_spec, the divisibility fallback of param_shardings and
    zero_spec on every leaf, under the config's own mesh and under data 2 x
    model 4."""
    import jax
    from jax.sharding import NamedSharding

    from lcasr_tpu.parallel import partition as jp
    from lcasr_tpu.parallel.mesh import make_mesh as jax_mesh
    from lcasr_torch.parallel import partition as tp

    model_kw, par = _yaml_model(config)
    model_kw = {k: v for k, v in model_kw.items() if k not in ("dtype",)}
    shapes = _flax_shapes(model_kw)["params"]
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert len(leaves) > 50
    for mesh_shape in (dict(par.get("mesh", {})), {"data": 2, "model": 4}):
        n = int(np.prod(list(mesh_shape.values())))
        if n > jax.device_count():
            continue
        mesh = jax_mesh(dict(mesh_shape))
        shardings = jp.param_shardings(shapes, mesh)
        sh_leaves = jax.tree_util.tree_leaves(shardings,
                                              is_leaf=lambda x: isinstance(x, NamedSharding))
        for (path, leaf), sh in zip(leaves, sh_leaves):
            names = [p.key for p in path]
            assert tp.param_spec(names) == tuple(jp.param_spec(path)), names
            spec = tp.leaf_spec(names, leaf.shape, mesh.shape)
            assert spec == tuple(sh.spec), names
            assert tp.zero_spec(spec, leaf.shape, mesh.shape) == tuple(
                jp.zero_spec(sh.spec, leaf.shape, mesh)), names


def test_tp_layout_follows_param_spec():
    """Every Dense the port cuts is one JAX shards (and the other way round
    where heads and widths divide), with the port's by-head qkv cut."""
    from lcasr_torch.models.sconformer_xl import SCConformerXL
    from lcasr_torch.parallel import partition as tp

    m = SCConformerXL(vocab_size=15, d_model=64, n_layers=2, n_heads=4, head_dim=16,
                      subsampling_conv_channels=16, device="cpu")
    layout = tp.tp_layout(m, 2)
    assert layout["layers.0.attend.qkv_proj"] == "col_heads"
    assert layout["layers.1.ff2.fc2"] == "row"
    assert layout["decoder.ff"] == "col_gather" and layout["decoder.reprojection"] == "row_split"
    assert not any("pointwise" in k or "subsampling" in k for k in layout)
    assert "layers.0.attend.qkv_proj" not in tp.tp_layout(m, 3)  # 4 heads: replicated
    full = dict(m.state_dict())
    heads = {p: 4 for p, mode in layout.items() if mode == "col_heads"}
    shards = [tp.shard_state_dict(full, layout, i, 2, heads) for i in range(2)]
    w = full["layers.0.attend.qkv_proj.weight"].view(3, 4, 16, 64)
    np.testing.assert_array_equal(shards[1]["layers.0.attend.qkv_proj.weight"].numpy(),
                                  w[:, 2:].reshape(-1, 64).numpy())
    assert shards[0]["decoder.reprojection.bias"] is full["decoder.reprojection.bias"]


def test_merge_matches_jax():
    import jax.numpy as jnp

    from lcasr_tpu.parallel.ring_attention import _merge
    from lcasr_torch.parallel.ring_attention import merge

    rng = np.random.default_rng(0)
    B, T, H, D = 2, 7, 3, 8
    num, o = (rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(2))
    den = rng.uniform(0.5, 2, (B, T, H, 1)).astype(np.float32)
    m = rng.normal(size=(B, T, H, 1)).astype(np.float32)
    lse = rng.normal(size=(B, H, T)).astype(np.float32)
    lse[0, 1, 2] = -1e30  # a fully-masked row of the block
    m[1, 3] = -1e30  # and a row with nothing merged yet
    want = _merge(*(jnp.asarray(a) for a in (num, den, m, o, lse)))
    got = merge(*(torch.from_numpy(a) for a in (num, den, m, o, lse)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("window", [(-1, -1), (16, 16)], ids=["full", "band16"])
def test_ring_blocks_match_jax_ring_attention(window):
    """The per-block compute (`ring_step_fwd` / `merge` / `ring_finish`,
    then `ring_step_bwd` against the merged lse), run for every rank and
    step of a 4-block ring in one process, against JAX ring_attention on a
    {seq: 4} mesh: outputs 1e-5, gradients 1e-4 of their largest entry."""
    import jax
    import jax.numpy as jnp

    from lcasr_tpu.parallel.mesh import make_mesh as jax_mesh
    from lcasr_tpu.parallel.ring_attention import ring_attention as jring
    from lcasr_torch.parallel import ring_attention as tr

    n, B, T, H, D = 4, 2, 128, 2, 32
    rng = np.random.default_rng(1)
    q, k, v, do = (rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(4))
    lens = np.array([128, 77], np.int32)
    mesh = jax_mesh({"seq": n})

    def f(q, k, v):
        return (jring(q, k, v, mesh, lengths=jnp.asarray(lens), window=window) * do).sum()

    out_j = np.asarray(jring(q, k, v, mesh, lengths=jnp.asarray(lens), window=window))
    grads_j = [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]

    t = T // n
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    lt = torch.from_numpy(lens)
    blk = lambda x, i: x[:, i * t:(i + 1) * t]  # noqa: E731
    outs, lses = [], []
    for i in range(n):
        acc = tr.ring_init(blk(qt, i))
        for s in range(n):
            j = (i - s) % n
            o_s, lse_s = tr.ring_step_fwd(blk(qt, i), blk(kt, j), blk(vt, j), lt, window,
                                          None, i * t, j * t)
            acc = tr.merge(*acc, o_s, lse_s)
        o, lse = tr.ring_finish(*acc, torch.float32)
        outs.append(o)
        lses.append(lse)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), out_j, atol=1e-5, rtol=0)
    dq = torch.zeros_like(qt)
    dk, dv = torch.zeros_like(kt), torch.zeros_like(vt)
    for i in range(n):
        for j in range(n):
            dq_s, dk_s, dv_s = tr.ring_step_bwd(blk(qt, i), blk(kt, j), blk(vt, j), outs[i],
                                                lses[i], blk(dot, i), lt, window, None,
                                                i * t, j * t)
            blk(dq, i).add_(dq_s)
            blk(dk, j).add_(dk_s)
            blk(dv, j).add_(dv_s)
    for g, w in zip((dq, dk, dv), grads_j):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max(), rtol=0)


def test_make_mesh_errors():
    """Without a world: a mesh of more than one rank raises JAX's text, an
    unknown axis raises, and a mesh of one needs a process group."""
    from lcasr_torch.parallel.mesh import make_mesh, maybe_init_distributed

    with pytest.raises(ValueError, match=r"needs 2 devices, have 1"):
        make_mesh({"data": 2})
    with pytest.raises(ValueError, match=r"needs 8 devices, have 1"):
        make_mesh({"data": 2, "model": 2, "seq": 2})
    with pytest.raises(ValueError, match="unknown axes"):
        make_mesh({"pipe": 1})
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh({"data": 1})
    assert maybe_init_distributed() is False  # nothing asks for a world
    if not torch.cuda.is_available():  # NCCL only on the GPU: no quiet gloo instead
        with pytest.raises(RuntimeError, match="device='cpu'"):
            maybe_init_distributed(num_processes=1, process_id=0,
                                   init_method="file:///nonexistent/pg")


# ---------------------------------------------------------------------------
# the data-parallel world {data: 2}
# ---------------------------------------------------------------------------
MODEL_KW = dict(d_model=64, n_layers=2, n_heads=2, head_dim=32, subsampling_conv_channels=32,
                use_rotary=True, checkpoint_every_n_layers=1, remat_subsampling=True)
DP_DURATIONS = [256, 256, 224, 256, 192, 256]  # two batches of B = 3
DECODE = dict(spec_n=700, seq_len=256, overlap=192, wb=3)  # 8 windows, W 3 -> 4


def _config(ckpt_dir, mesh=None, batch_size=3, zero=False):
    cfg = {
        "model_class": "SCConformerXL",
        "model": dict(MODEL_KW),
        "data": {"path": ""},
        "audio_chunking": {"size": 256, "overlap": 0},
        "training": {"batch_size": batch_size, "backprop_every": 1, "max_epochs": 1,
                     "clip_value": 0.8, "random_seed": 12345},
        "optimizer": {"name": "madgrad", "args": {"lr": 1e-3}},
        "scheduler": {"warmup_steps": 1, "final_value": 0.0},
        "checkpointing": {"dir": str(ckpt_dir), "save_every_n_steps": 10 ** 6},
    }
    if mesh:
        cfg["parallel"] = {"mesh": dict(mesh), "zero_optimizer": zero}
    return cfg


def dp_chunk(seed=3):
    """One (3, 80, 256) chunk: a short row and a finished (weight 0) one."""
    rng = np.random.default_rng(seed)
    return {"audio": rng.normal(size=(3, 80, 256)).astype(np.float32),
            "audio_lengths": np.array([256, 200, 0], np.int32),
            "labels": rng.integers(1, 4095, size=(3, 64)).astype(np.int64),
            "label_lengths": np.array([9, 6, 0], np.int32),
            "weight": np.array([1.0, 1.0, 0.0], np.float32)}


def _losses(path):
    return [json.loads(line)["loss"] for line in open(path) if '"loss"' in line]


# fp32 uploads: the windowed single pass without a mesh uploads through
# StreamingDecoder (bf16 by default), the context-parallel one does not
EVAL_KW = dict(dataset="synthetic", seq_len=256, overlap=192, verbose=False, device="cpu",
               transfer_dtype="float32", dataset_kwargs={"n_recordings": 1, "n_frames": 1000})


def evaluate_spied(checkpoint, **kw):
    """`evaluate.evaluate` in a worker, with what it decoded: the log-probs
    its greedy decoder read and the mesh shape its decode was given
    (StreamingDecoder's `mesh`, make_cp_windowed_model_fn's)."""
    from lcasr_torch.evaluation import run as trun

    seen = {"logits": [], "mesh": []}
    real = (trun.GreedyCTCDecoder, trun.StreamingDecoder, trun.make_cp_windowed_model_fn)

    class Greedy(real[0]):
        def __call__(self, emission, *a, **k):
            seen["logits"].append(np.array(emission))
            return super().__call__(emission, *a, **k)

    def streaming(*a, mesh=None, **k):
        seen["mesh"].append(None if mesh is None else mesh.shape)
        return real[1](*a, mesh=mesh, **k)

    def cp_fn(model, mesh, *a, **k):
        seen["mesh"].append(mesh.shape)
        return real[2](model, mesh, *a, **k)

    trun.GreedyCTCDecoder, trun.StreamingDecoder, trun.make_cp_windowed_model_fn = (
        Greedy, streaming, cp_fn)
    try:
        summary = trun.evaluate(checkpoint, **EVAL_KW, **kw)
    finally:
        trun.GreedyCTCDecoder, trun.StreamingDecoder, trun.make_cp_windowed_model_fn = real
    return dict(seen, words=[r["words"] for r in summary["rows"]])


def assert_evaluate_on_mesh(out, mesh_shape, atol):
    """The spied `evaluate` with the parallel flag against the one without:
    the decode got the mesh, its log-probs equal within `atol`, greedy ids
    equal away from near-ties."""
    plain, par = out[False], out[True]
    assert plain["mesh"] in ([], [None]) and par["mesh"] == [mesh_shape]
    assert par["words"] == plain["words"] and len(par["logits"]) == len(plain["logits"]) == 1
    got, want = par["logits"][0], plain["logits"][0]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    top2 = np.sort(want, axis=-1)[:, -2:]
    far = (top2[:, 1] - top2[:, 0]) > atol
    np.testing.assert_array_equal(got.argmax(-1)[far], want.argmax(-1)[far])


def dp_world(mesh, tmp):
    """Rank work of {data: 2}: a micro step, two optimizer steps, a decode."""
    import torch.distributed as dist

    from lcasr_torch.config import Config
    from lcasr_torch.data.dataloading import VariableBatchSimpleDataloader
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.evaluation.streaming import StreamingDecoder
    from lcasr_torch.models.registry import load_model
    from lcasr_torch.training.trainer import Trainer

    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    tok = load_tokenizer()
    out = {}

    def trainer(ckpt):
        cfg = Config(_config(ckpt, {"data": 2}))
        model = load_model(cfg, tok.vocab_size(), device="cpu")
        model.load_state_dict(inp["state"], strict=True)
        tr = Trainer(cfg, model, tok, device="cpu")
        assert tr.mesh is not None and tr.dp == 2
        tr.init_state()
        return tr

    tr = trainer(os.path.join(tmp, "micro"))
    loss, blank = tr.micro_step(inp["chunk"])
    grads = {}
    for name, p in tr.model.named_parameters():
        g = p.grad.clone()
        dist.all_reduce(g, group=mesh.group("data"))
        grads[name] = g.numpy()
    out["micro"] = {"loss": float(loss), "blank_p": float(blank), "grads": grads,
                    "stats": {k: v.numpy().copy() for k, v in tr.model.state_dict().items()
                              if "running" in k}}

    ckpt = os.path.join(tmp, "train")
    tr = trainer(ckpt)
    tr.train(VariableBatchSimpleDataloader(pairs=inp["corpus"], tokenizer=tok, batch_size=3,
                                           chunk_size=256, chunk_overlap=0))
    out["train"] = {k: v.numpy().copy() for k, v in tr.model.state_dict().items()}
    if mesh.rank == 0:
        out["losses"] = _losses(os.path.join(ckpt, "metrics.jsonl"))
    # the evaluation entry point on the checkpoint just written
    dist.barrier()  # rank 0 has written it
    out["evaluate"] = {dp: evaluate_spied(ckpt, data_parallel=dp) for dp in (False, True)}

    model = load_model(Config(_config(tmp)), tok.vocab_size(), device="cpu")
    model.load_state_dict(inp["state"], strict=True)
    dec = StreamingDecoder(model, tok.vocab_size() + 1, window_batch_size=DECODE["wb"],
                           transfer_dtype=torch.float32, device="cpu", mesh=mesh)
    out["decode"] = dec.logits(inp["spec"], DECODE["seq_len"], DECODE["overlap"])
    out["greedy"] = dec.greedy(inp["spec"], DECODE["seq_len"], DECODE["overlap"])
    return out


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """Start the {data: 2} world; the JAX side runs while it works."""
    from lcasr_tpu.models.sconformer_xl import SCConformerXL as JModel
    from lcasr_torch.models.import_jax import state_dict_from_flax
    from tests.test_torch_port_ops import randomize
    from tests.test_train_trajectory_parity import _make_corpus
    import jax
    import jax.numpy as jnp

    tmp = tmp_path_factory.mktemp("dp_world")
    corpus = _make_corpus(tmp, DP_DURATIONS, seed=21)
    jm = JModel(vocab_size=4095, **MODEL_KW)
    variables = randomize(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 256))), seed=22)
    spec = np.random.default_rng(23).normal(size=(1, 80, DECODE["spec_n"])).astype(np.float32)
    torch.save({"state": state_dict_from_flax(variables), "chunk": dp_chunk(), "corpus": corpus,
                "spec": spec}, tmp / "inputs.pt")
    procs = spawn_world("tests.test_torch_port_parallel", "dp_world", {"data": 2}, tmp)
    return {"procs": procs, "tmp": tmp, "variables": variables, "corpus": corpus,
            "spec": spec, "outs": None}


def _outs(run):
    if run["outs"] is None:
        run["outs"] = join_world(run["procs"], run["tmp"])
    return run["outs"]


def _jax_trainer(cfg_dict, variables):
    import jax
    import jax.numpy as jnp

    from lcasr_tpu.config import Config as JConfig
    from lcasr_tpu.data.tokenizer import load_tokenizer as jax_tokenizer
    from lcasr_tpu.models.registry import load_model as jax_load_model
    from lcasr_tpu.training.trainer import Trainer as JTrainer

    jtok = jax_tokenizer()
    jcfg = JConfig(cfg_dict)
    jtr = JTrainer(jcfg, jax_load_model(jcfg, jtok.vocab_size()), jtok)
    state = jtr.init_state(jax.random.PRNGKey(0))
    state["params"] = jax.device_put(jax.tree.map(jnp.asarray, variables["params"]),
                                     jtr._param_sh)
    state["batch_stats"] = jax.tree.map(jnp.asarray, variables["batch_stats"])
    state["opt_state"] = jax.jit(jtr.optimizer.init, out_shardings=jtr._opt_sh)(state["params"])
    return jtr, jtok, state


def _jax_trainer_single(cfg_dict, variables):
    """The JAX Trainer without a mesh, from `variables`."""
    import jax
    import jax.numpy as jnp

    from lcasr_tpu.config import Config as JConfig
    from lcasr_tpu.data.tokenizer import load_tokenizer as jax_tokenizer
    from lcasr_tpu.models.registry import load_model as jax_load_model
    from lcasr_tpu.training.trainer import Trainer as JTrainer

    jtok = jax_tokenizer()
    jcfg = JConfig(cfg_dict)
    jtr = JTrainer(jcfg, jax_load_model(jcfg, jtok.vocab_size()), jtok)
    state = jtr.init_state(jax.random.PRNGKey(0))
    state["params"] = jax.tree.map(jnp.asarray, variables["params"])
    state["batch_stats"] = jax.tree.map(jnp.asarray, variables["batch_stats"])
    state["opt_state"] = jtr.optimizer.init(state["params"])
    return jtr, jtok, state


def test_dp_micro_step_matches_jax_trainer(dp_run, tmp_path):
    """The loss, the gradient summed over data and the running statistics
    of one micro step on B = 3 (padded to 4, split 2 + 2) equal the JAX
    Trainer's micro step under {data: 2}."""
    import jax

    from lcasr_torch.models.import_jax import state_dict_from_flax

    jtr, _, state = _jax_trainer(_config(tmp_path, {"data": 2}), dp_run["variables"])
    zero = jtr._zero_grads_fn(state["params"])(state["params"])
    loss_j, grads_j, stats_j, blank_j = jtr._micro_step_fn()(
        state["params"], state["batch_stats"], jtr._device_batch(dp_chunk()),
        jax.random.PRNGKey(1), zero)
    want = state_dict_from_flax({"params": jax.tree.map(np.asarray, grads_j)})
    stats = state_dict_from_flax({"batch_stats": jax.tree.map(np.asarray, stats_j)})
    outs = _outs(dp_run)
    for out in outs:  # every rank reports the whole chunk's loss
        np.testing.assert_allclose(out["micro"]["loss"], float(loss_j), rtol=1e-4)
        assert out["micro"]["blank_p"] == pytest.approx(float(blank_j), abs=1e-6)
    assert_grads_close(outs[0]["micro"]["grads"], {k: v.numpy() for k, v in want.items()})
    for name, w in stats.items():
        if "running" in name:
            for out in outs:
                np.testing.assert_allclose(out["micro"]["stats"][name], w.numpy(), atol=2e-5,
                                           err_msg=name)


def test_dp_two_optimizer_steps_match_jax_trainer(dp_run, tmp_path):
    """Two batches of B = 3 under {data: 2}: rank 0's logged losses, and the
    parameters and running statistics on both ranks after two MADGRAD steps,
    equal the JAX Trainer's with the same mesh."""
    import jax

    from lcasr_tpu.data.dataloading import VariableBatchSimpleDataloader as JLoader
    from lcasr_torch.models.import_jax import state_dict_from_flax

    jtr, jtok, state = _jax_trainer(_config(tmp_path, {"data": 2}), dp_run["variables"])
    state = jtr.train(state, JLoader(pairs=dp_run["corpus"], tokenizer=jtok, batch_size=3,
                                     chunk_size=256, chunk_overlap=0, prefetch=False))
    want = state_dict_from_flax({c: jax.tree.map(np.asarray, state[c])
                                 for c in ("params", "batch_stats")})
    outs = _outs(dp_run)
    losses_j = _losses(tmp_path / "metrics.jsonl")
    assert len(losses_j) == len(outs[0]["losses"]) == 2
    np.testing.assert_allclose(outs[0]["losses"], losses_j, rtol=1e-4)
    assert "losses" not in outs[1]  # only rank 0 writes metrics
    moved = 0.0
    for name, w in want.items():
        for out in outs:
            np.testing.assert_allclose(out["train"][name], w.numpy(), atol=2e-5, rtol=0,
                                       err_msg=name)
        if name.endswith("weight"):
            moved = max(moved, float(np.abs(w.numpy() - state_dict_from_flax(
                {"params": dp_run["variables"]["params"]})[name].numpy()).max()))
    assert moved > 1e-4


def test_mesh_decode_matches_jax(dp_run):
    """The data-parallel decode (8 windows, W 3 padded to 4, 2 a rank)
    against JAX StreamingDecoder(mesh={data: 2}): log-probs 1e-4, ids equal
    away from near-ties; both ranks return the same."""
    import jax.numpy as jnp

    from lcasr_tpu.evaluation.streaming import StreamingDecoder as JDec
    from lcasr_tpu.models.sconformer_xl import SCConformerXL as JModel
    from lcasr_tpu.parallel.mesh import make_mesh as jax_mesh

    jm = JModel(vocab_size=4095, **MODEL_KW)
    jdec = JDec(jm, dp_run["variables"], 4096, window_batch_size=DECODE["wb"],
                transfer_dtype=jnp.float32, mesh=jax_mesh({"data": 2}))
    want = np.asarray(jdec.logits(dp_run["spec"], DECODE["seq_len"], DECODE["overlap"]))
    outs = _outs(dp_run)
    for out in outs:
        assert out["decode"].shape == want.shape
        np.testing.assert_allclose(out["decode"], want, atol=1e-4, rtol=0)
    top2 = np.sort(want, axis=-1)[:, -2:]
    far = (top2[:, 1] - top2[:, 0]) > 1e-4
    np.testing.assert_array_equal(outs[0]["greedy"][far], want.argmax(-1)[far])
    np.testing.assert_array_equal(outs[0]["greedy"], outs[1]["greedy"])


def test_evaluate_data_parallel_decodes_on_the_mesh(dp_run):
    """`evaluate(data_parallel=True)` in the {data: 2} world decodes through
    StreamingDecoder(mesh={data: 2}), as the JAX function does on a data
    mesh of all devices: on both ranks its log-probs equal the decode
    without it within 1e-5 (the same windows' fp32 sums, added in another
    order), its greedy ids away from near-ties."""
    for out in _outs(dp_run):
        assert_evaluate_on_mesh(out["evaluate"], {"data": 2, "model": 1, "seq": 1}, 1e-5)
