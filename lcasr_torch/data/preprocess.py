"""Offline preprocessing: audio files -> fp16 mel spectrograms (counterpart
of lcasr_tpu/data/preprocess.py).

`preprocess_file` runs the port's `processing_chain` on `device` (None: the
GPU) and writes `<name>.spec.npy` in fp16; `main` takes every
`shard_index`-th of `num_shards` files, for array jobs.  `pair_audio_txt`
pairs spectrograms with word-aligned transcript JSONs by the JAX package's
trailing-path key, and `add_durations` reads each spectrogram's length.

    python -m lcasr_torch.data.preprocess -audio DIR [-ext .wav]
        [--shard_index i --num_shards n] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np

from lcasr_torch.data.audio import processing_chain


def preprocess_file(audio_path: str, out_path: Optional[str] = None, device=None) -> str:
    # C order, as the loaders' .npy reader takes it (the mel is a transposed view)
    spec = np.ascontiguousarray(processing_chain(audio_path, device=device).cpu().numpy(),
                                dtype=np.float16)
    out_path = out_path or (os.path.splitext(audio_path)[0] + ".spec.npy")
    np.save(out_path, spec)
    return out_path


def findall_files(path: str, ext: str) -> List[str]:
    out = []
    for root, _, files in os.walk(path):
        for f in files:
            if f.endswith(ext):
                out.append(os.path.join(root, f))
    return sorted(out)


def pair_audio_txt(
    audio_path: str,
    txt_path: str,
    audio_ext: str = ".spec.npy",
    txt_ext: str = ".json",
    save_path: Optional[str] = None,
) -> Dict[str, Dict[str, str]]:
    """{key: {"audio", "txt"}} of the spectrograms that have a transcript; the
    key joins the last four path parts (of an audio part, its first word)."""
    pairs: Dict[str, Dict[str, str]] = {}
    for p in findall_files(audio_path, audio_ext):
        key = "_".join(el.split(" ")[0] for el in p.split("/")[-4:]).replace(audio_ext, "")
        pairs[key] = {"audio": p}
    for p in findall_files(txt_path, txt_ext):
        key = "_".join(p.split("/")[-4:]).replace(txt_ext, "")
        if key in pairs:
            pairs[key]["txt"] = p
    pairs = {k: v for k, v in pairs.items() if "txt" in v}
    if save_path:
        with open(save_path, "w") as f:
            json.dump(pairs, f)
    return pairs


def add_durations(pairs: Dict[str, Dict[str, str]]) -> Dict[str, Dict[str, str]]:
    """Each entry's duration in seconds (100 frames a second), from its
    spectrogram's header."""
    for entry in pairs.values():
        spec = np.load(entry["audio"], mmap_mode="r")
        entry["duration"] = float(spec.shape[-1] / 100.0)
    return pairs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-audio", "--audio_dir", required=True)
    parser.add_argument("-ext", "--audio_ext", default=".wav")
    parser.add_argument("-shard", "--shard_index", type=int, default=0)
    parser.add_argument("-num_shards", "--num_shards", type=int, default=1)
    parser.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = parser.parse_args(argv)

    files = findall_files(args.audio_dir, args.audio_ext)
    mine = files[args.shard_index :: args.num_shards]
    for i, f in enumerate(mine):
        out = preprocess_file(f, device=args.device)
        print(f"[{i + 1}/{len(mine)}] {f} -> {out}")


if __name__ == "__main__":
    main()
