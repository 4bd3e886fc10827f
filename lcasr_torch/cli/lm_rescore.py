"""LM rescoring pipeline: dump moving-window logits, then beam-search them
(the port's copy of lcasr_tpu/cli/lm_rescore.py).

Counterparts of reference `eval/tedlium/create_logits.py` (per-recording
logits) and `eval/tedlium/tlm_beam.py` (beam search with a transformer LM
over them, alpha / beta grids by shell loops).  Here: `.npz` logit dumps
and a beam stage whose LM runs on the device.

    python -m lcasr_torch.cli.lm_rescore create_logits -c ckpt -d synthetic \
        -o logits_dir [--device cpu]
    python -m lcasr_torch.cli.lm_rescore beam -i logits_dir -alpha 0.45 -beta 1.53
    # an alpha / beta grid in one command:
    python -m lcasr_torch.cli.lm_rescore beam -i logits_dir \
        -alpha 0.3,0.45,0.6 -beta 0.5,1.53 -decoder frame_sync -lm lm_ckpt

Checkpoints are the port's (`training/checkpointing.py` directories) or, for
the acoustic model, reference `.pt` files.  An orbax checkpoint of lcasr_tpu
is restored with lcasr_tpu and carried over with
`lcasr_torch.models.import_jax.state_dict_from_flax`.  The results CSV is
written with the standard library's `csv` (the same columns as the JAX
CLI's, the header once).
"""
from __future__ import annotations

import argparse
import csv
import json
import os
from typing import Optional

import numpy as np

CSV_COLUMNS = ("recording", "wer", "words", "alpha", "beta", "beam_width")


def create_logits(
    checkpoint: str,
    dataset: str,
    split: str,
    out_dir: str,
    seq_len: int = 16384,
    overlap: int = -1,
    dataset_kwargs: Optional[dict] = None,
    device=None,
):
    """Each recording's averaged-moving-window log-probs (T', C) as
    `<out_dir>/<id>.npz` (fp16 `logits`, the normalised `gold` text)."""
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.device import resolve_device
    from lcasr_torch.evaluation.datasets import get_dataset_fn
    from lcasr_torch.evaluation.normalizer import normalize
    from lcasr_torch.evaluation.run import build_model, load_any_checkpoint
    from lcasr_torch.evaluation.streaming import StreamingDecoder

    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    cfg, state_dict = load_any_checkpoint(checkpoint)
    tokenizer = load_tokenizer()
    n_classes = tokenizer.vocab_size() + 1
    if overlap == -1:
        overlap = int(seq_len * 0.875)
    model = build_model(cfg, state_dict, tokenizer.vocab_size(), device)
    streamer = StreamingDecoder(model, n_classes, device=device)

    for item in get_dataset_fn(dataset)(split, **(dataset_kwargs or {})):
        spec, gold = item["process_fn"](item)
        logits = streamer.logits(np.asarray(spec), seq_len=seq_len, overlap=overlap)
        np.savez_compressed(os.path.join(out_dir, f"{item['id']}.npz"),
                            logits=logits.astype(np.float16), gold=normalize(gold).lower())
        print(f"saved {item['id']}: {logits.shape}")


def load_lm_checkpoint(path: str, device=None):
    """A trained `models/lm.py:TransformerLM` from a checkpoint directory of
    the port (`step_N/`, or its parent: the latest step), saved with the
    embedded config -> the model on `device` (None: the GPU)."""
    from lcasr_torch.config import Config
    from lcasr_torch.models.lm import TransformerLM
    from lcasr_torch.training.checkpointing import find_latest_checkpoint, load_checkpoint

    if not os.path.exists(os.path.join(path, "arrays.pt")):
        latest = find_latest_checkpoint(path)
        if latest is None:
            raise ValueError(
                f"{path} is not a checkpoint directory of lcasr_torch (step_N/ with "
                f"arrays.pt and meta.json).  An orbax checkpoint of lcasr_tpu is restored "
                f"with lcasr_tpu and carried over with "
                f"lcasr_torch.models.import_jax.state_dict_from_flax")
        path = latest
    arrays, meta = load_checkpoint(path, map_location="cpu")
    lm_cfg = Config.from_dict(meta["config"]).get("model", Config({})).to_dict()
    lm_cfg.pop("model_class", None)
    model = TransformerLM(**lm_cfg, device=device)
    model.load_state_dict(arrays["model"], strict=True)
    return model.eval()


def beam_stage(
    logits_dir: str,
    alpha: float = 0.45,
    beta: float = 1.53,
    beam_width: int = 25,
    lm: Optional[str] = None,
    results_csv: Optional[str] = None,
    decoder: str = "prefix",
    bos_id: int = 2,
    parallel_recordings: int = 1,
    device_search: bool = False,
    device=None,
):
    """decoder='prefix': prefix beam search (pyctcdecode-style AM merge),
    with the LM's scores fused when `lm` is given; decoder='frame_sync': the
    reference tlm_beam algorithm (per-beam KV caches, one batched LM step a
    frame, `ctc_beam_search.py:93-322`), `lm` required.
    `parallel_recordings=N > 1` (frame_sync only) rescores N recordings at
    once off one wide LM (`decoding/frame_sync.py:rescore_many`; the same
    results per recording).  `device_search=True` (frame_sync only) runs
    each search on the device (`decoding/frame_sync_device.py`).  `device`:
    the LM's (None: the GPU).  Returns the WER over all recordings."""
    from lcasr_torch.data.tokenizer import load_tokenizer
    from lcasr_torch.decoding.beam_search import BeamSearch
    from lcasr_torch.evaluation.normalizer import normalize
    from lcasr_torch.evaluation.wer import word_error_rate_detail

    tokenizer = load_tokenizer()
    lm_model = lm_scores = None
    if lm is not None:
        from lcasr_torch.models.lm import make_lm_scorer

        lm_model = load_lm_checkpoint(lm, device=device)
        lm_scores = make_lm_scorer(lm_model, bos_id=bos_id)

    names, all_logits, golds = [], [], []
    for name in sorted(os.listdir(logits_dir)):
        if not name.endswith(".npz"):
            continue
        data = np.load(os.path.join(logits_dir, name), allow_pickle=True)
        names.append(name)
        all_logits.append(data["logits"].astype(np.float32))
        golds.append(str(data["gold"]))

    if decoder == "frame_sync":
        if lm_model is None:
            raise ValueError("frame_sync decoding needs -lm <checkpoint>")
        from lcasr_torch.decoding.frame_sync import CachedTransformerLM, rescore_many

        # serial decoding is n_slots=1; either way one LM at the global
        # longest length serves every recording
        n_slots = min(max(1, parallel_recordings), max(1, len(all_logits)))
        max_len = max((lg.shape[0] for lg in all_logits), default=1) + 1
        if device_search:
            from lcasr_torch.decoding.frame_sync_device import rescore_device

            texts = rescore_device(
                lm_model, all_logits, tokenizer=tokenizer, decode=True,
                beam_width=beam_width, alpha=alpha, beta=beta,
                blank_id=tokenizer.vocab_size(), bos_id=bos_id,
                max_tokens=max_len, batch_recordings=1,
            )
        else:
            wide_lm = CachedTransformerLM(lm_model, width=n_slots * beam_width,
                                          max_len=max_len, bos_id=bos_id)
            texts = rescore_many(
                wide_lm, all_logits, n_slots, tokenizer=tokenizer, decode=True,
                beam_width=beam_width, alpha=alpha, beta=beta,
                blank_id=tokenizer.vocab_size(), bos_id=bos_id,
            )
    elif decoder == "prefix":
        bs = BeamSearch(
            tokenizer=tokenizer, beam_width=beam_width, blank_id=tokenizer.vocab_size(),
            alpha=alpha, beta=beta, lm_scores=lm_scores,
            pad_id=tokenizer.pad_id(),  # id 0 is never proposed (lcasr)
        )
        texts = [bs.run_search(lg) for lg in all_logits]
    else:
        raise ValueError(f"decoder must be prefix or frame_sync, got {decoder!r}")

    hyps, refs, rows = [], [], []
    for name, text, gold in zip(names, texts, golds):
        hyp = normalize(text).lower()
        wer, words, *_ = word_error_rate_detail([hyp], [gold])
        rows.append({"recording": name[:-4], "wer": wer, "words": words,
                     "alpha": alpha, "beta": beta, "beam_width": beam_width})
        hyps.append(hyp)
        refs.append(gold)
        print(f"{name[:-4]}: WER {wer:.4f}")
    wer, words, *_ = word_error_rate_detail(hyps, refs)
    print(json.dumps({"wer": wer, "words": words, "alpha": alpha, "beta": beta}))
    if results_csv:
        header = not os.path.exists(results_csv)
        with open(results_csv, "a", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=CSV_COLUMNS)
            if header:
                writer.writeheader()
            writer.writerows(rows)
    return wer


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("create_logits")
    c.add_argument("-c", "--checkpoint", required=True)
    c.add_argument("-d", "--dataset", required=True)
    c.add_argument("-split", "--split", default="test")
    c.add_argument("-o", "--out_dir", required=True)
    c.add_argument("-seq", "--seq_len", type=int, default=16384)
    c.add_argument("--dataset_base_path", default=None)
    c.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain versions)")
    b = sub.add_parser("beam")
    b.add_argument("-i", "--logits_dir", required=True)
    b.add_argument("-alpha", default="0.45", help="LM weight; a comma-separated list sweeps")
    b.add_argument("-beta", default="1.53",
                   help="token insertion bonus; a comma-separated list sweeps")
    b.add_argument("-beam_width", type=int, default=25)
    b.add_argument("-lm", "--lm", default=None,
                   help="trained TransformerLM checkpoint directory of the port")
    b.add_argument("-decoder", "--decoder", default="prefix", choices=["prefix", "frame_sync"])
    b.add_argument("-parallel", "--parallel_recordings", type=int, default=1,
                   help="frame_sync only: rescore N recordings at once off one wide LM")
    b.add_argument("-device", "--device_search", action="store_true",
                   help="frame_sync only: run each search on the device")
    b.add_argument("-results", "--results_csv", default=None)
    # (`-device` is --device_search, as in the JAX CLI)
    b.add_argument("--device", dest="torch_device", default=None,
                   help="the LM's torch device (default: cuda; 'cpu' runs on the CPU)")
    args = parser.parse_args()
    if args.cmd == "create_logits":
        create_logits(args.checkpoint, args.dataset, args.split, args.out_dir,
                      seq_len=args.seq_len,
                      dataset_kwargs={"base_path": args.dataset_base_path}
                      if args.dataset_base_path else {},
                      device=args.device)
    else:
        alphas = [float(a) for a in str(args.alpha).split(",")]
        betas = [float(b_) for b_ in str(args.beta).split(",")]
        grid = [(a, b_) for a in alphas for b_ in betas]
        best = None
        for a, b_ in grid:
            wer = beam_stage(args.logits_dir, a, b_, args.beam_width, lm=args.lm,
                             results_csv=args.results_csv, decoder=args.decoder,
                             parallel_recordings=args.parallel_recordings,
                             device_search=args.device_search, device=args.torch_device)
            if best is None or wer < best[0]:
                best = (wer, a, b_)
        if len(grid) > 1:
            print(json.dumps({"best_wer": best[0], "alpha": best[1], "beta": best[2],
                              "grid_points": len(grid)}))


if __name__ == "__main__":
    main()
