"""lcasr_torch SCConformerXL against lcasr_tpu's, on the CPU in fp32, plus
the flax-variables converter and the port's import isolation.

Both models run exact fp32 attention on the CPU (lcasr_tpu's jnp oracle,
lcasr_torch's plain kernel version).  Log-probs are compared at atol 1e-4:
the same fp32 arithmetic in another order through a few layers of GEMMs
over up to 3072 terms and a 4096-way log-softmax, whose values are about
-8, leaves differences of a few 1e-6; 1e-4 keeps a margin and still
catches any wrong weight layout, mask or op order (those move log-probs by
1e-2 or more).
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcasr_torch.models.import_jax import state_dict_from_flax
from tests.test_torch_port_ops import randomize

ATOL = 1e-4

TINY = dict(vocab_size=16, d_model=64, n_layers=2, n_heads=2, head_dim=32,
            subsampling_conv_channels=32, use_rotary=True, rotary_base_freq=1.5e6)


def _pair(cfg, T, seed=0):
    from lcasr_tpu.models.sconformer_xl import SCConformerXL as JModel
    from lcasr_torch.models.sconformer_xl import SCConformerXL

    jm = JModel(**cfg)
    variables = randomize(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 80, T))), seed=seed)
    port = SCConformerXL(**cfg, device="cpu")
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jm, variables, port


def _compare(jm, variables, port, audio, lengths):
    want = jm.apply(variables, audio, length=None if lengths is None else jnp.asarray(lengths))
    with torch.no_grad():
        got = port(torch.from_numpy(audio),
                   length=None if lengths is None else torch.from_numpy(lengths))
    lp = got["final_posteriors"]
    assert lp.dtype == torch.float32 and lp.shape == want["final_posteriors"].shape
    np.testing.assert_array_equal(got["length"].numpy(), np.asarray(want["length"]))
    np.testing.assert_allclose(lp.numpy(), np.asarray(want["final_posteriors"]),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("variant", ["lengths", "no_lengths", "window", "rms_sandwich"])
def test_tiny_model_matches_jax(variant):
    cfg = dict(TINY)
    if variant == "window":
        cfg.update(attention_window_size=6, attention_window_size_right=3)
    if variant == "rms_sandwich":
        cfg.update(default_norm="rms_norm", sandwich_norm=True, bias_in_ff=True,
                   decoder_norm=True, learned_rotary=True)
    jm, variables, port = _pair(cfg, 300, seed=1)
    rng = np.random.default_rng(2)
    audio = rng.normal(size=(3, 80, 300)).astype(np.float32)
    lengths = None if variant == "no_lengths" else np.array([300, 211, 97], np.int32)
    _compare(jm, variables, port, audio, lengths)


@pytest.mark.parametrize("option", [
    dict(fourier_pos_enc=True, use_rotary=False), dict(fourier_pos_enc=True),
    dict(subsampling="stacking"), dict(subsampling="stacking", subsampling_norm_out=True),
    dict(subsampling="striding"), dict(subsampling="vggnet", subsampling_act="relu"),
    dict(conv_norm="batch_norm"), dict(conv_norm="layer_norm"), dict(conv_norm="group_norm"),
    dict(conv_norm="none"),
    # flax makes no decoder reprojection here: the port must not either
    dict(self_conditioning=False), dict(n_layers=1),
], ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_model_options_match_jax(option):
    """The options of the decode slice, through flax init -> randomize ->
    state_dict_from_flax -> strict load -> compare."""
    cfg = dict(TINY, **option)
    jm, variables, port = _pair(cfg, 300, seed=7)
    for tree in (variables.get("batch_stats", {}),):
        for layer in tree.values():  # BatchNorm keeps a variance: positive
            norm = layer.get("conv", {}).get("norm", {})
            if "running_var" in norm:
                norm["running_var"] = np.abs(norm["running_var"]) + 0.5
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    rng = np.random.default_rng(8)
    audio = rng.normal(size=(3, 80, 300)).astype(np.float32)
    _compare(jm, variables, port, audio, np.array([300, 211, 97], np.int32))


@pytest.mark.parametrize("family", ["SCConformerXL", "Mamba"])
@pytest.mark.parametrize("n_layers,self_conditioning", [(2, True), (2, False), (1, True)])
def test_state_dict_keys_are_flax_keys(family, n_layers, self_conditioning):
    """Both ways between the flax tree and the port's state_dict: the same
    keys, with a decoder reprojection exactly where a layer projects back
    (self-conditioning with more than one layer)."""
    import importlib

    from lcasr_torch.models.import_jax import flax_from_state_dict

    mod = "sconformer_xl" if family == "SCConformerXL" else "mamba"
    JModel = getattr(importlib.import_module(f"lcasr_tpu.models.{mod}"), family)
    Port = getattr(importlib.import_module(f"lcasr_torch.models.{mod}"), family)
    cfg = dict(vocab_size=16, d_model=64, n_layers=n_layers, subsampling_conv_channels=32,
               self_conditioning=self_conditioning)
    if family == "SCConformerXL":
        cfg.update(n_heads=2, head_dim=32)
    variables = JModel(**cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 64)))
    variables = jax.tree.map(np.asarray, dict(variables))
    port = Port(**cfg, device="cpu")
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    back = flax_from_state_dict(port.state_dict())
    paths = lambda tree: {jax.tree_util.keystr(p) for p, _ in
                          jax.tree_util.tree_leaves_with_path(tree)}
    assert paths(back) == paths(variables)
    reprojects = self_conditioning and n_layers > 1
    assert ("decoder.reprojection.weight" in port.state_dict()) == reprojects


def test_flagship_widths_match_jax():
    from lcasr_torch.models.sconformer_xl import FLAGSHIP

    cfg = dict(FLAGSHIP, n_layers=2)
    jm, variables, port = _pair(cfg, 256, seed=3)
    rng = np.random.default_rng(4)
    audio = rng.normal(size=(2, 80, 256)).astype(np.float32)
    _compare(jm, variables, port, audio, np.array([256, 170], np.int32))


def test_flagship_copy_matches_graft_entry():
    from __graft_entry__ import FLAGSHIP as REPO_FLAGSHIP
    from lcasr_torch.models.sconformer_xl import FLAGSHIP

    assert FLAGSHIP == REPO_FLAGSHIP


def test_bf16_model_runs_and_tracks_fp32():
    """Compute dtype bf16 (the decode path's) on the CPU: finite fp32
    log-probs that normalise, close to the fp32 model's."""
    from lcasr_torch.models.sconformer_xl import SCConformerXL, init_weights_

    rng = np.random.default_rng(5)
    audio = torch.from_numpy(rng.normal(size=(2, 80, 256)).astype(np.float32))
    lengths = torch.tensor([256, 100], dtype=torch.int32)
    outs = {}
    for dt in (torch.float32, torch.bfloat16):
        m = init_weights_(SCConformerXL(**TINY, dtype=dt, device="cpu"), seed=6)
        with torch.no_grad():
            outs[dt] = m(audio, length=lengths)["final_posteriors"]
    lp = outs[torch.bfloat16]
    assert lp.dtype == torch.float32 and torch.isfinite(lp).all()
    np.testing.assert_allclose(lp.exp().sum(-1).numpy(), 1.0, atol=1e-4)
    # bf16 keeps ~3 significant digits through two layers
    assert (lp - outs[torch.float32]).abs().max() < 0.25


def test_unported_options_raise():
    from lcasr_torch.models.sconformer_xl import SCConformerXL

    small = dict(vocab_size=8, d_model=32, n_layers=1, n_heads=1, head_dim=32,
                 subsampling_conv_channels=8, device="cpu")
    for kw in (dict(quant_w8a8=True), dict(conv_type="longconv"), dict(capture_qkv=True)):
        with pytest.raises(NotImplementedError):
            SCConformerXL(**small, **kw)
    with pytest.raises(TypeError):
        SCConformerXL(**small, no_such_option=1)
    # context parallelism is ported: its options need a mesh to run, and
    # unknown forms or axes raise
    m = SCConformerXL(**small, seq_axis_name="seq", attention_cp_impl="ring")
    with pytest.raises(ValueError, match="needs a mesh"):
        m(torch.zeros(1, 80, 64))
    for kw in (dict(attention_cp_impl="ulysses"), dict(stat_axes=("batch",))):
        with pytest.raises(ValueError):
            SCConformerXL(**small, **kw)
    # names that do not exist raise as in the JAX model
    for kw in (dict(subsampling="conv1d"), dict(conv_norm="instance_norm")):
        with pytest.raises(ValueError):
            SCConformerXL(**small, **kw)


def test_model_without_device_raises_when_no_gpu():
    from lcasr_torch.models.sconformer_xl import SCConformerXL

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None means cuda there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SCConformerXL(**TINY)


# ---------------------------------------------------------------------------
# converter
# ---------------------------------------------------------------------------
def test_converter_loads_strict_and_maps_layouts():
    from lcasr_torch.models.sconformer_xl import SCConformerXL

    jm, variables, port = _pair(TINY, 128)
    sd = state_dict_from_flax(variables)
    assert set(sd) == set(port.state_dict())
    p = variables["params"]
    np.testing.assert_array_equal(sd["layers.1.attend.qkv_proj.weight"].numpy(),
                                  p["layers_1"]["attend"]["qkv_proj"]["kernel"].T)
    np.testing.assert_array_equal(sd["subsampling.conv_in.weight"].numpy(),
                                  p["subsampling"]["conv_in"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["layers.0.conv.depthwise_kernel"].numpy()[:, 0, :],
                                  p["layers_0"]["conv"]["depthwise_kernel"].T)
    np.testing.assert_array_equal(
        sd["layers.0.conv.norm.running_std"].numpy(),
        variables["batch_stats"]["layers_0"]["conv"]["norm"]["running_std"])
    # a missing tensor fails the strict load
    del sd["decoder.ff.bias"]
    with pytest.raises(RuntimeError):
        SCConformerXL(**TINY, device="cpu").load_state_dict(sd, strict=True)


@pytest.mark.parametrize("bad", ["leaf", "module", "collection"])
def test_converter_raises_on_unknown_names(bad):
    _, variables, _ = _pair(TINY, 128)
    variables = dict(variables)
    params = dict(variables["params"])
    if bad == "leaf":
        params["decoder"] = dict(params["decoder"], extra=np.zeros(3, np.float32))
    elif bad == "module":
        params["mystery"] = {"kernel": np.zeros((2, 2), np.float32)}
    else:
        variables["intermediates"] = {"x": np.zeros(1, np.float32)}
    variables["params"] = params
    with pytest.raises(ValueError, match="unknown"):
        state_dict_from_flax(variables)


# ---------------------------------------------------------------------------
# isolation
# ---------------------------------------------------------------------------
def test_port_imports_no_jax_and_no_lcasr_tpu():
    # the third-party packages the JAX package's frontend and evaluation
    # use are blocked outright: the port must import without them
    code = (
        "import importlib, importlib.abc, pkgutil, sys\n"
        "BLOCKED = ('scipy', 'transformers', 'rapidfuzz', 'regex', 'pandas')\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import lcasr_torch\n"
        "for m in pkgutil.walk_packages(lcasr_torch.__path__, 'lcasr_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'lcasr_tpu', 'yaml', 'triton') + BLOCKED)\n"
        "for name in ('lcasr_torch.ops.ssm', 'lcasr_torch.models.mamba',\n"
        "             'lcasr_torch.ops.subsampling', 'lcasr_torch.models.positional',\n"
        "             'lcasr_torch.evaluation.streaming', 'lcasr_torch.data.audio',\n"
        "             'lcasr_torch.evaluation.run', 'lcasr_torch.evaluation.normalizer',\n"
        "             'lcasr_torch.evaluation.wer', 'lcasr_torch.serving',\n"
        "             'lcasr_torch.serving.server', 'lcasr_torch.serving.__main__',\n"
        "             'lcasr_torch.evaluation.datasets.rev16', 'lcasr_torch.native',\n"
        "             'lcasr_torch.data.utterances', 'lcasr_torch.training.debug_hooks',\n"
        "             'lcasr_torch.ops.ctc', 'lcasr_torch.models.enc_dec_sconformer',\n"
        "             'lcasr_torch.decoding.frame_sync', 'lcasr_torch.models.lm',\n"
        "             'lcasr_torch.decoding.beam_search',\n"
        "             'lcasr_torch.decoding.frame_sync_device', 'lcasr_torch.cli.train_lm',\n"
        "             'lcasr_torch.cli.lm_rescore', 'lcasr_torch.parallel.mesh',\n"
        "             'lcasr_torch.parallel.collectives', 'lcasr_torch.parallel.partition',\n"
        "             'lcasr_torch.parallel.context_parallel',\n"
        "             'lcasr_torch.parallel.ring_attention', 'lcasr_torch.parallel.cp_model',\n"
        "             'lcasr_torch.parallel.tensor_parallel', 'lcasr_torch.optim.zero'):\n"
        "    assert name in sys.modules, name\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('lcasr_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(__import__("pathlib").Path(__file__).parents[1]))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 44  # every module was imported (models.positional too)
