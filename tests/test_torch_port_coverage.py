"""Every file and public top-level name of the JAX package has its
counterpart in the port: a file of the same path under lcasr_torch/ and a
name of the same name in it, or an entry below that names the port's
counterpart (which must exist) or says why the name is JAX's alone.  Both
packages are read with `ast`; nothing is imported, so JAX is not loaded.  A
new JAX name, a port name that goes, or an entry that no longer matches a
JAX name fails by name."""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "lcasr_tpu", "lcasr_torch"

# a JAX file whose names live in another port file
FILES = {"ops/subsampling_pallas.py": "ops/subsampling.py"}

# (JAX file, name) -> "port/file.py:name" (its counterpart there), or
# "JAX only: why"
NAMES = {
    ("data/dataloading.py", "SimpleDataloader"):
        "data/dataloading.py:VariableBatchSimpleDataloader",
    ("decoding/beam_search.py", "FlaxLMScorer"): "decoding/beam_search.py:TorchLMScorer",
    ("models/base.py", "print_total_params"): "models/base.py:count_params",
    ("models/registry.py", "register_model"): "models/registry.py:_REGISTRY",
    ("models/registry.py", "model_kwargs_from_config"): "models/registry.py:load_model",
    ("native/__init__.py", "load_beam_native"): "native/__init__.py:library",
    ("native/__init__.py", "load_bpe_native"): "native/__init__.py:library",
    ("native/__init__.py", "load_npy_native"): "native/__init__.py:library",
    ("ops/conv.py", "halo_exchange"): "parallel/collectives.py:halo_exchange",
    ("ops/flash_attention.py", "NEG_INF"): "ops/attention.py:NEG_INF",
    ("ops/qdense.py", "quant_dot_general"): "ops/qdense.py:apply_quant_policy",
    ("ops/qdense.py", "w8a8_dot_general"): "ops/qdense.py:w8a8_linear",
    ("ops/subsampling_pallas.py", "dw_striding_chain_lax"): "ops/subsampling.py:dw_striding_chain",
    ("optim/factory.py", "load_optimizer"): "optim/factory.py:build_optimizer",
    ("optim/madgrad.py", "madgrad"): "optim/madgrad.py:MADGRAD",
    ("optim/madgrad.py", "mirror_madgrad"): "optim/madgrad.py:MirrorMADGRAD",
    ("utils/__init__.py", "enable_compilation_cache"):
        "JAX only: XLA's persistent compilation cache; the port compiles no graphs",
    ("ops/flash_attention.py", "DEFAULT_BLOCK_Q"):
        "JAX only: the Pallas kernels' tile sizes; the CUDA kernels choose their own tiles",
    ("ops/flash_attention.py", "DEFAULT_BLOCK_K"):
        "JAX only: the Pallas kernels' tile sizes; the CUDA kernels choose their own tiles",
    ("optim/madgrad.py", "MadgradState"):
        "JAX only: optax's state class; torch.optim keeps the state in the optimizer",
    ("optim/madgrad.py", "MirrorMadgradState"):
        "JAX only: optax's state class; torch.optim keeps the state in the optimizer",
    ("optim/madgrad.py", "ScalarOrSchedule"):
        "JAX only: optax's type of a learning rate; the port sets it on the optimizer",
    ("parallel/partition.py", "batch_sharding"):
        "JAX only: a NamedSharding builder; the port shards by rank (parallel/mesh.py)",
    ("parallel/partition.py", "sequence_sharding"):
        "JAX only: a NamedSharding builder; the port shards by rank (parallel/mesh.py)",
    ("parallel/partition.py", "replicated"):
        "JAX only: a NamedSharding builder; the port shards by rank (parallel/mesh.py)",
    ("parallel/partition.py", "param_shardings"):
        "JAX only: a NamedSharding builder; the port shards by rank (parallel/mesh.py)",
    ("parallel/partition.py", "opt_state_shardings"):
        "JAX only: a NamedSharding builder; the port shards by rank (parallel/mesh.py)",
    ("parallel/partition.py", "zero_shardings"):
        "JAX only: a NamedSharding builder; the port shards by rank (parallel/mesh.py)",
    ("parallel/partition.py", "shard_params"):
        "JAX only: device_put by NamedSharding; the port's is shard_state_dict",
    ("parallel/ring_attention.py", "make_ring_local"):
        "JAX only: wraps the ring in shard_map; the port's ring runs in each rank's process",
    ("ops/attention.py", "banded_attention_chunked"):
        "JAX only: the non-TPU memory fallback of banded attention; on the card K1 runs "
        "the band and skips the tiles outside it",
}


def _public_names(path: str) -> set:
    tree = ast.parse(open(path, encoding="utf-8").read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return names


def _package(pkg: str) -> dict:
    """{relative path: every top-level name} of every .py file of pkg."""
    out = {}
    base = os.path.join(ROOT, pkg)
    for root, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                out[os.path.relpath(path, base).replace(os.sep, "/")] = _public_names(path)
    return out


JAX = _package(JAX_PKG)
PORT = _package(PORT_PKG)


@pytest.mark.parametrize("rel", sorted(JAX))
def test_every_jax_file_and_name_has_its_port_counterpart(rel):
    port_rel = FILES.get(rel, rel)
    assert port_rel in PORT, f"{JAX_PKG}/{rel} has no {PORT_PKG}/{port_rel}"
    missing = []
    for name in sorted(n for n in JAX[rel] if not n.startswith("_")):
        entry = NAMES.get((rel, name))
        if entry is None:
            if name not in PORT[port_rel]:
                missing.append(name)
        elif not entry.startswith("JAX only: "):
            file, counterpart = entry.split(":")
            assert counterpart in PORT.get(file, ()), (
                f"{JAX_PKG}/{rel}:{name} maps to {PORT_PKG}/{file}:{counterpart}, which is gone")
    assert not missing, (f"{JAX_PKG}/{rel}: {missing} have no counterpart of the same name "
                         f"in {PORT_PKG}/{port_rel} and no entry in NAMES")


def test_every_entry_matches_a_jax_name_and_gives_a_counterpart_or_a_reason():
    for (rel, name), entry in NAMES.items():
        assert name in JAX.get(rel, ()), f"NAMES has {rel}:{name}, which the JAX package lacks"
        assert entry.startswith("JAX only: ") or ":" in entry, entry
    for rel, port_rel in FILES.items():
        assert rel in JAX and port_rel in PORT, (rel, port_rel)
