"""The port's own profiler ranges (`lcasr.<span>`, utils/profiling.py): none
without a profiler, where the work happens and nested as the code nests
under one (a decode, a Mamba forward, a Trainer batch, on the CPU), and the
benchmark's reduction of them (lcbench/harness/program_spans.py) on a
synthetic trace."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lcasr_torch.utils import profiling

PREFIX = "lcasr."


def _ranges(prof):
    """[(start, end, thread, span)] of the `lcasr.*` ranges and the aten ops
    of a CPU trace (ops keep their full names)."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns()
        out.append((start, start + ev.duration_ns(), ev.start_thread_id(), ev.name()))
    return out


def _parent(r, ranges):
    """The innermost `lcasr.*` range around r on its thread, or None."""
    s, e, tid, name = r
    around = [o for o in ranges if o is not r and o[3].startswith(PREFIX) and o[2] == tid
              and o[0] <= s and e <= o[1] and (o[0], o[1]) != (s, e)]
    if not around:
        return None
    return max(around, key=lambda o: (o[0], -o[1]))[3][len(PREFIX):]


def _parents(ranges):
    """{span: {its parents' spans}} over every range of the trace."""
    out = {}
    for r in ranges:
        if r[3].startswith(PREFIX):
            out.setdefault(r[3][len(PREFIX):], set()).add(_parent(r, ranges))
    return out


def _tiny_conformer():
    from lcasr_torch.models.sconformer_xl import SCConformerXL

    torch.manual_seed(0)
    return SCConformerXL(vocab_size=15, d_model=64, n_layers=2, n_heads=2, head_dim=32,
                         subsampling_conv_channels=16, device="cpu")


def test_without_a_profiler_a_span_is_the_shared_no_op(monkeypatch):
    from lcasr_torch.ops.ctc import ctc_loss

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.Tensor, "register_hook", refuse)  # no backward span either
    assert profiling.span("norm") is profiling.span("decode.group") is profiling._NO_SPAN
    model = _tiny_conformer()
    out = model(torch.randn(2, 80, 256), length=torch.tensor([256, 200]), train=True)
    lp = out["final_posteriors"].float()
    loss = ctc_loss(lp, torch.tensor([[1, 2, 3], [4, 5, 0]]), out["length"],
                    torch.tensor([3, 2])).sum()
    loss.backward()


def test_a_decode_gives_the_decode_module_and_op_ranges_nested_as_the_code():
    from lcasr_torch.evaluation.streaming import StreamingDecoder

    decoder = StreamingDecoder(_tiny_conformer(), 16, window_batch_size=2, device="cpu")
    spec = np.random.default_rng(0).standard_normal((1, 80, 600)).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        decoder._run(spec, 256, 128)
    parents = _parents(_ranges(prof))
    assert parents["decode.upload"] == parents["decode.finish"] == {None}
    assert parents["decode.group"] == {None}
    assert parents["decode.average"] == parents["subsampling"] == {"decode.group"}
    assert parents["attention"] == {"decode.group"} and parents["ff"] == {"decode.group"}
    assert parents["conv"] == parents["self_cond"] == parents["head"] == {"decode.group"}
    assert parents["attn_fwd"] == {"attention"}
    # the pre-norms in their modules, the layer's output norm, BatchRenorm in the conv
    assert parents["norm"] == {"ff", "attention", "conv", "decode.group"}


def test_a_mamba_forward_gives_the_mixer_and_scan_ranges():
    from lcasr_torch.models.mamba import Mamba

    model = Mamba(vocab_size=15, d_model=32, n_layers=2, subsampling_conv_channels=16,
                  device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
        model(torch.randn(1, 80, 256), length=torch.tensor([256]))
    parents = _parents(_ranges(prof))
    assert parents["mixer"] == parents["subsampling"] == parents["head"] == {None}
    assert parents["self_cond"] == {None}
    assert parents["scan_fwd"] == {"mixer"}
    assert parents["norm"] == {"mixer", "self_cond", "head"}  # the decoder norms


class _OneBatch:
    """The Trainer's loader interface, one batch of two podcasts."""

    batch_size = 2

    def __init__(self, frames=(600, 420)):
        rng = np.random.default_rng(1)
        self.audio = rng.standard_normal((2, 80, max(frames))).astype(np.float32)
        self.lengths = np.array(frames)
        self.words = [[{"word": w, "startTime": f"{0.2 + 0.3 * i:.2f}s",
                        "endTime": f"{0.45 + 0.3 * i:.2f}s"}
                       for i, w in enumerate("the long podcast has words".split() * 3)
                       if 0.45 + 0.3 * i < n / 100 - 0.5] for n in frames]

    def total_recordings(self):
        return 2

    def __iter__(self):
        yield self.audio, self.lengths, self.words, ["a", "b"]


def test_a_trainer_batch_gives_the_train_ranges_and_the_ctc_backward_on_its_thread(tmp_path):
    from lcasr_torch.config import Config
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.models.registry import load_model
    from lcasr_torch.training.trainer import Trainer

    tok = load_tokenizer()
    cfg = Config({
        "model_class": "SCConformerXL",
        "model": dict(d_model=64, n_layers=2, n_heads=2, head_dim=32,
                      subsampling_conv_channels=16, checkpoint_every_n_layers=1),
        "audio_chunking": {"size": 256, "overlap": 0},
        "training": {"batch_size": 2, "backprop_every": 1, "max_epochs": 1,
                     "random_seed": 3},
        "optimizer": {"name": "madgrad", "args": {"lr": 1e-3}},
        "scheduler": {"warmup_steps": 1, "final_value": 0.0},
        "checkpointing": {"dir": str(tmp_path), "save_every_n_steps": 10 ** 6},
    })
    trainer = Trainer(cfg, load_model(cfg, tok.vocab_size(), device="cpu"), tok,
                      checkpoint_dir=str(tmp_path), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train(_OneBatch())
    ranges = _ranges(prof)
    parents = _parents(ranges)
    for phase in ("chunk_audio", "chunk_text", "tokenize", "assemble"):
        assert parents["train." + phase] == {"train.make_chunks"}, phase
    for span in ("data_wait", "make_chunks", "upload", "host_read", "fold", "optimizer_step"):
        assert parents["train." + span] == {None}, span
    assert parents["ctc_fwd"] == {None} and "attn_bwd" in parents and "attn_fwd" in parents
    backward = [r for r in ranges if r[3] == "aten::_ctc_loss_backward"]
    assert backward and {_parent(r, ranges) for r in backward} == {"ctc_bwd"}
    ctc_forward = [r for r in ranges if r[3] == "aten::_ctc_loss"]
    assert ctc_forward and {_parent(r, ranges) for r in ctc_forward} == {"ctc_fwd"}


# ---------------------------------------------------------------------------
# the benchmark's reduction, on a synthetic trace
# ---------------------------------------------------------------------------
class _Ev:
    def __init__(self, name, start, end, tid=1, corr=0, device=False, annotation=False):
        self._v = (name, start, end, tid, corr, device, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return int(self._v[1] * 1e9)

    def duration_ns(self):
        return int((self._v[2] - self._v[1]) * 1e9)

    def start_thread_id(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[5] else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._v[6]


def _synthetic_trace():
    """Window [0, 100) s on thread 1; a [10, 60) around b [20, 40) there, c
    [70, 90) on thread 2 (autograd's); kernels on two streams."""
    host = [("lcbench.window", 0, 100), ("lcasr.a", 10, 60), ("lcasr.b", 20, 40),
            ("lcbench.make_chunks", 10, 60), ("aten::add", 21, 22)]
    evs = [_Ev(n, s, e) for n, s, e in host] + [_Ev("lcasr.c", 70, 90, tid=2)]
    launches = [(1, 15, 1, 16, 30), (1, 25, 2, 30, 45), (1, 5, 3, 5, 8), (2, 75, 4, 76, 80),
                (1, 26, 5, 35, 50)]  # (thread, launch, correlation, kernel start, end)
    for tid, t, corr, ks, ke in launches:
        evs.append(_Ev("cudaLaunchKernel", t, t + 0.5, tid=tid, corr=corr))
        evs.append(_Ev(f"kernel{corr}", ks, ke, corr=corr, device=True))
    evs.append(_Ev("lcasr.a", 16, 50, device=True, annotation=True))  # no work of its own
    evs += [_Ev("cudaStreamSynchronize", 50, 51), _Ev("cudaStreamSynchronize", 65, 66),
            _Ev("cudaMemcpy", 85, 86, tid=2), _Ev("cudaMemcpyAsync", 55, 56, corr=9)]
    return evs


def test_program_spans_credit_the_innermost_span_idle_by_span_and_syncs_inside_spans():
    from lcbench.harness.program_spans import readings, reduce_program

    p = reduce_program(_synthetic_trace())
    # kernel 1 under a, kernels 2 and 5 under b, 3 before any span, 4 on the
    # autograd thread under c: each once, summing to the kernels' 51 s
    assert p["device_s"] == pytest.approx({"a": 14, "b": 30, "c": 4, "(none)": 3})
    assert p["kernel_s"] == pytest.approx(51) and p["busy_s"] == pytest.approx(41)
    # idle [0, 5) [8, 16) [50, 76) [80, 100) cut by thread 1's innermost span
    assert p["idle_s"] == pytest.approx({"(none)": 43, "a": 16})
    assert sum(p["idle_s"].values()) == pytest.approx(p["window_s"] - p["busy_s"])
    # at 50 in a, at 85 in c, at 65 in none; an async copy is no sync
    assert p["syncs"] == {"a": 1, "c": 1, "(none)": 1}
    assert p["host_s"] == pytest.approx({"a": 50, "b": 20, "c": 20})
    assert p["calls"] == {"a": 1, "b": 1, "c": 1}
    p["device_s"].update({"decode.average": 2.05, "norm": 8.2, "ctc_fwd": 1, "ctc_bwd": 3})
    p["idle_s"].update({"train.make_chunks": 5, "train.tokenize": 5})
    p["calls"]["train.optimizer_step"] = 4
    assert readings(p, "decode") == pytest.approx(
        {"decode.average_share": 5.0, "decode.norm_share": 20.0})
    assert readings(p, "train") == pytest.approx(
        {"train.ctc_share": 400 / 41, "idle_share.train.make_chunks": 10.0,
         "train.syncs_per_step": 0.5})
