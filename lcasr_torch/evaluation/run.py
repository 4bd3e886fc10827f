"""Unified eval CLI: checkpoint -> model -> streaming decode -> WER rows
(the port's copy of lcasr_tpu/evaluation/run.py).

Counterpart of reference `eval/run.py:30-148`:
  * the model is rebuilt purely from the checkpoint-embedded config,
  * `evaluation_mode` selects averaged_moving_window | windowed_attention
    (model built with attention_window_size = (seq_len/subsampling)/2 and
    seq_len raised to cover the recording in ONE forward, on K1's band with
    tile skip) | buffered,
  * per-recording greedy decode + Whisper-normalised WER, then aggregate.

Under `torchrun` (one process per GPU) `data_parallel` shards the
averaged-moving-window decode's windows over every rank (the mesh's `data`
axis) and `context_parallel` shards the windowed-attention single pass's
time axis over them (`seq`); every rank returns the same rows, and only
rank 0 prints.

Accepts reference `.pt` checkpoints (converted on the fly by
`models.import_torch`) and checkpoint directories of the port
(`training/checkpointing.py`).  The JAX package's orbax checkpoints are not
read.  `device=None` means the GPU and raises without one; the frontend of
the audio datasets runs there too.

    python -m lcasr_torch.evaluation.run -c CKPT -d synthetic [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

from lcasr_torch.config import Config
from lcasr_torch.data.tokenizer import load_tokenizer
from lcasr_torch.decoding.greedy import GreedyCTCDecoder
from lcasr_torch.device import resolve_device
from lcasr_torch.evaluation.datasets import get_dataset_fn
from lcasr_torch.evaluation.normalizer import normalize
from lcasr_torch.evaluation.streaming import (
    StreamingDecoder,
    fetch_logits,
    fetch_logits_buffered,
    make_cp_windowed_model_fn,
    make_windowed_model_fn,
)
from lcasr_torch.evaluation.wer import word_error_rate_detail
from lcasr_torch.models.registry import load_model

MAX_WINDOWED_SECONDS = 36000  # 10 h cap in windowed-attention mode (ref :41)


def load_any_checkpoint(path: str):
    """Returns (config: Config, the port's model state_dict)."""
    if path.endswith(".pt"):
        from lcasr_torch.models.import_torch import load_torch_checkpoint, state_dict_from_torch

        cfg_dict, sd = load_torch_checkpoint(path)
        cfg = Config.from_dict(dict(cfg_dict))
        return cfg, state_dict_from_torch(sd, cfg.get("model", Config({})).to_dict())
    from lcasr_torch.training.checkpointing import find_latest_checkpoint, load_checkpoint

    if not os.path.exists(os.path.join(path, "arrays.pt")):
        latest = find_latest_checkpoint(path)
        if latest is None:
            raise ValueError(
                f"{path} is neither a reference .pt file nor a checkpoint directory of "
                f"lcasr_torch (step_N/ with arrays.pt and meta.json).  The port does not "
                f"read lcasr_tpu's orbax checkpoints: restore one with lcasr_tpu and carry "
                f"its variables over with lcasr_torch.models.import_jax.state_dict_from_flax")
        path = latest
    arrays, meta = load_checkpoint(path, map_location="cpu")
    return Config.from_dict(meta["config"]), arrays["model"]


def build_model(cfg: Config, state_dict, vocab_size: int, device, model_cfg=None):
    """The checkpoint's model (its class and `model` section, or `model_cfg`
    in its place) on `device` with the checkpoint's weights."""
    model_cfg = dict(model_cfg if model_cfg is not None
                     else cfg.get("model", Config({})).to_dict())
    build_cfg = Config({"model": model_cfg,
                        "model_class": cfg.get("model_class", "SCConformerXL")})
    model = load_model(build_cfg, vocab_size, device=device)
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


def evaluate(
    checkpoint: str,
    dataset: str,
    split: str = "test",
    seq_len: int = 16384,
    overlap: int = -1,
    overlap_ratio: float = 0.875,
    evaluation_mode: str = "averaged_moving_window",
    dataset_kwargs: Optional[Dict[str, Any]] = None,
    verbose: bool = True,
    skip_recordings: Optional[set] = None,
    transfer_dtype: Optional[str] = None,  # 'bfloat16' (default) | 'int8' | 'int4' | 'float32'
    pipeline_upload: bool = False,  # stripe uploads to overlap with compute
    data_parallel: bool = False,  # shard decode windows over the world's ranks
    context_parallel: bool = False,  # windowed_attention: shard the time axis
    quant_w8a8: Any = False,  # not ported (ROADMAP queue A6)
    cache_upload: bool = False,  # keep a recording's upload for a second decode
    device=None,
) -> Dict[str, Any]:
    if quant_w8a8:
        raise NotImplementedError("quant_w8a8 (W8A8 projections) is not ported yet "
                                  "(ROADMAP queue A6)")
    device = resolve_device(device)
    cfg, state_dict = load_any_checkpoint(checkpoint)
    tokenizer = load_tokenizer()
    n_classes = tokenizer.vocab_size() + 1

    if overlap == -1:
        overlap = int(seq_len * overlap_ratio)

    model_cfg = cfg.get("model", Config({})).to_dict()
    subsampling_factor = model_cfg.get("subsampling_factor", 8)

    requested_seq_len, requested_overlap = seq_len, overlap
    if evaluation_mode == "windowed_attention":
        # local attention window = downsampled seq_len / 2; single forward
        # covering the recording (reference eval/run.py:38-43)
        model_cfg["attention_window_size"] = (seq_len // subsampling_factor) // 2
        seq_len = MAX_WINDOWED_SECONDS * 100
        overlap = 0
    elif evaluation_mode not in ("buffered", "averaged_moving_window"):
        raise ValueError(f"unknown evaluation_mode {evaluation_mode!r}")
    if evaluation_mode != "averaged_moving_window" and (
        transfer_dtype or pipeline_upload or cache_upload or data_parallel
    ):
        import warnings

        warnings.warn(
            "transfer_dtype/pipeline_upload/cache_upload/data_parallel only apply to "
            "averaged_moving_window decode and are ignored in "
            f"{evaluation_mode!r}", stacklevel=2,
        )
    world = 1
    if data_parallel or context_parallel:
        from lcasr_torch.parallel.mesh import make_mesh, maybe_init_distributed, rank, world_size

        maybe_init_distributed(device=device)  # torchrun's world; a no-op without one
        world = world_size()
        verbose = verbose and rank() == 0

    model = build_model(cfg, state_dict, tokenizer.vocab_size(), device, model_cfg)
    mesh = cp_model_fn = None
    if evaluation_mode == "buffered":
        model_fn = make_windowed_model_fn(model)
    elif evaluation_mode == "windowed_attention" and context_parallel and world > 1:
        # the single pass sharded over the seq axis: the route for a
        # recording whose one-pass forward exceeds one card's memory
        mesh = make_mesh({"seq": world})
        cp_model_fn = make_cp_windowed_model_fn(model, mesh)
    else:
        if data_parallel and world > 1:
            mesh = make_mesh()  # every rank on the data axis
        streamer = StreamingDecoder(
            model, n_classes, subsampling_factor=subsampling_factor,
            transfer_dtype=transfer_dtype,
            pipeline_upload=pipeline_upload, cache_upload=cache_upload, device=device,
            mesh=mesh,
        )

    decoder = GreedyCTCDecoder(tokenizer, blank_id=n_classes - 1)
    data = get_dataset_fn(dataset)(split, **{"device": device, **(dataset_kwargs or {})})

    rows: List[Dict[str, Any]] = []
    total_audio_s, total_wall = 0.0, 0.0
    for item in data:
        if skip_recordings and str(item["id"]) in skip_recordings:
            # crash-resume (eval_manager): already in the results CSV
            continue
        spec, gold = item["process_fn"](item)
        spec = np.asarray(spec)
        t0 = time.perf_counter()
        if evaluation_mode == "buffered":
            logits = fetch_logits_buffered(
                model_fn, spec, seq_len=seq_len, overlap=overlap, n_classes=n_classes,
                subsampling_factor=subsampling_factor,
            )
        elif cp_model_fn is not None:
            logits = fetch_logits(
                cp_model_fn, spec, seq_len=seq_len, overlap=0, n_classes=n_classes,
                subsampling_factor=subsampling_factor, window_batch_size=1,
            )
        else:
            logits = streamer.logits(spec, seq_len=seq_len, overlap=overlap)
        wall = time.perf_counter() - t0
        hyp = normalize(decoder(logits)).lower()
        ref = normalize(gold).lower()
        wer, words, ins_r, del_r, sub_r = word_error_rate_detail([hyp], [ref])
        n_err = len(hyp.split()) if words == 0 else round(wer * words)
        audio_s = spec.shape[-1] / 100.0
        total_audio_s += audio_s
        total_wall += wall
        rows.append(
            {
                "recording": item["id"],
                "wer": wer,
                "words": words,
                "ins_rate": ins_r,
                "del_rate": del_r,
                "sub_rate": sub_r,
                "errors": n_err,
                "audio_seconds": audio_s,
                "wall_seconds": wall,
            }
        )
        if verbose:
            print(f"{item['id']}: WER {wer:.4f} ({words} words, {audio_s:.0f}s audio)")

    # aggregate from the per-recording raw counts (empty-reference rows
    # contribute their hypothesis words as insertions, the batch-call
    # convention)
    words = sum(r["words"] for r in rows)
    if words:
        wer = sum(r["errors"] for r in rows) / words
        ins_r = sum(
            (r["ins_rate"] * r["words"]) if r["words"] else r["errors"]
            for r in rows
        ) / words
        del_r = sum((r["del_rate"] * r["words"]) if r["words"] else 0 for r in rows) / words
        sub_r = sum((r["sub_rate"] * r["words"]) if r["words"] else 0 for r in rows) / words
    else:
        wer = ins_r = del_r = sub_r = float("inf")
    summary = {
        "dataset": dataset,
        "split": split,
        # the requested window (windowed_attention changes the internals; a
        # sweep over seq_len must stay distinguishable)
        "seq_len": requested_seq_len,
        "overlap": requested_overlap,
        "evaluation_mode": evaluation_mode,
        "wer": wer,
        "words": words,
        "ins_rate": ins_r,
        "del_rate": del_r,
        "sub_rate": sub_r,
        "rtfx": total_audio_s / total_wall if total_wall > 0 else None,
        "device": str(device),
        "rows": rows,
    }
    if verbose:
        print(json.dumps({k: v for k, v in summary.items() if k != "rows"}, indent=2))
    return summary


def _parse_value(text: str):
    """A --dataset_kwargs value: JSON where it parses (numbers, booleans,
    lists), else the string itself."""
    try:
        return json.loads(text)
    except ValueError:
        return text


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-c", "--checkpoint", required=True)
    parser.add_argument("-d", "--dataset", required=True)
    parser.add_argument("-split", "--split", default="test")
    parser.add_argument("-seq", "--seq_len", type=int, default=16384)
    parser.add_argument("-overlap", "--overlap", type=int, default=-1)
    parser.add_argument(
        "-mode",
        "--evaluation_mode",
        default="averaged_moving_window",
        choices=["averaged_moving_window", "windowed_attention", "buffered"],
    )
    parser.add_argument(
        "--transfer_dtype", default=None, choices=["bfloat16", "int8", "int4", "float32"],
        help="spectrogram upload dtype (int8 / int4 quantised on the host, "
             "dequantised once on the device)",
    )
    parser.add_argument("--pipeline_upload", action="store_true",
                        help="stripe the spectrogram upload and overlap it with compute")
    parser.add_argument("--cache_upload", action="store_true",
                        help="reuse the device copy when a recording is decoded again")
    parser.add_argument("--data_parallel", action="store_true",
                        help="under torchrun: shard the decode windows over every rank "
                             "(the mesh's data axis)")
    parser.add_argument("--context_parallel", action="store_true",
                        help="windowed_attention mode under torchrun: shard the single "
                             "pass's time axis over every rank (for recordings whose "
                             "forward exceeds one card's memory)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu (the kernels' plain versions)")
    parser.add_argument("--dataset_base_path", default=None)
    parser.add_argument(
        "--dataset_kwargs", nargs="*", default=[],
        help="extra adapter kwargs as key=value (e.g. pairs_path=... snr_db=5)",
    )
    args = parser.parse_args()
    dk = {k: _parse_value(v) for k, _, v in
          (kv.partition("=") for kv in args.dataset_kwargs)}
    if args.dataset_base_path:
        dk["base_path"] = args.dataset_base_path
    evaluate(
        checkpoint=args.checkpoint,
        dataset=args.dataset,
        split=args.split,
        seq_len=args.seq_len,
        overlap=args.overlap,
        evaluation_mode=args.evaluation_mode,
        dataset_kwargs=dk,
        transfer_dtype=args.transfer_dtype,
        pipeline_upload=args.pipeline_upload,
        cache_upload=args.cache_upload,
        data_parallel=args.data_parallel,
        context_parallel=args.context_parallel,
        device=args.device,
    )


if __name__ == "__main__":
    main()
