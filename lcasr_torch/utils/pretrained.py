"""Published checkpoints: the manifest, its check, the download and the load
(counterpart of lcasr_tpu/utils/pretrained.py; the same manifest and the
same messages).

`MANIFEST` gives, per published model, its HuggingFace Hub repo and the
sha256 of its file (None until recorded).  The file is `step_105360.pt`,
else `step_105360_repeat_1.pt`; `repeat=N` asks for
`step_105360_repeat_N.pt`.  `manifest_check` raises ValueError on any
mismatch.  `download_pretrained` needs the network and `huggingface_hub`
(imported inside it); `load_pretrained` returns what
`evaluation.run.load_any_checkpoint` returns for the file: (Config, the
port's state_dict).
"""
from __future__ import annotations

import hashlib
import os
from typing import Optional

CHECKPOINT_PREFIX = "step_105360"

# model names (the rows of configs/model_zoo.yaml) -> published hub repos
MANIFEST = {
    "lcasr-9L-768D-6H": {
        "repo": "rjflynn2/lcasr-9L-768D-6H-RB-1p5M", "sha256": None},
    "lcasr-6L-768D-6H": {
        "repo": "rjflynn2/lcasr-6L-768D-6H-RB-1p5M", "sha256": None},
    "lcasr-6L-768D-12H": {
        "repo": "rjflynn2/lcasr-6L-768D-12H-RB-1p5M", "sha256": None},
    "lcasr-6L-768D-24H": {
        "repo": "rjflynn2/lcasr-6L-768D-24H-RB-1p5M", "sha256": None},
    "lcasr-6L-768D-6H-SinePos": {
        "repo": "rjflynn2/lcasr-6L-768D-6H-SinePos", "sha256": None},
    "lcasr-6L-768D-6H-NoPos": {
        "repo": "rjflynn2/lcasr-6L-768D-6H-NoPos", "sha256": None},
    "lcasr-3L-2048D-16H": {
        "repo": "rjflynn2/lcasr-3L-2048D-16H-RB-1p5M", "sha256": None},
    "lcasr-3L-768D-6H": {
        "repo": "rjflynn2/lcasr-3L-768D-6H-RB-1p5M", "sha256": None},
    "lcasr-12L-256D-8H": {
        "repo": "rjflynn2/lcasr-12L-256D-8H-RB-1p5M", "sha256": None},
    "lcasr-6L-256D-8H": {
        "repo": "rjflynn2/lcasr-6L-256D-8H-RB-1p5M", "sha256": None},
}

KNOWN_CHECKPOINTS = {k: v["repo"] for k, v in MANIFEST.items()}


def expected_filenames(repeat: Optional[int] = None) -> list:
    """The checkpoint filenames to try, in order."""
    if repeat is not None:
        return [f"{CHECKPOINT_PREFIX}_repeat_{repeat}.pt"]
    return [f"{CHECKPOINT_PREFIX}.pt", f"{CHECKPOINT_PREFIX}_repeat_1.pt"]


def manifest_check(name: str, path: str, repeat: Optional[int] = None) -> None:
    """Raise ValueError unless `path` is a file of the published scheme for
    the known model `name` with the recorded sha256 (where one is)."""
    if name not in MANIFEST:
        raise ValueError(
            f"unknown pretrained model {name!r}; known: {sorted(MANIFEST)}")
    fname = os.path.basename(path)
    allowed = expected_filenames(repeat)
    if fname not in allowed:
        raise ValueError(
            f"checkpoint filename {fname!r} does not match the published "
            f"scheme for {name!r}: expected one of {allowed} "
            "(reference bin/load_pretrained.py:40-47)")
    if not os.path.isfile(path):
        raise ValueError(f"checkpoint path does not exist: {path}")
    want = MANIFEST[name]["sha256"]
    if want is not None:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for block in iter(lambda: f.read(1 << 20), b""):
                h.update(block)
        got = h.hexdigest()
        if got != want:
            raise ValueError(
                f"sha256 mismatch for {name!r}: manifest {want}, file {got} "
                "— the hub artifact changed or the download is corrupt")


def download_pretrained(
    name_or_repo: str,
    cache_dir: Optional[str] = None,
    repeat: Optional[int] = None,
) -> str:
    """The local path of the downloaded `.pt` (needs the network): the
    filenames of `expected_filenames` tried in order, a known model's file
    held to the manifest."""
    entry = MANIFEST.get(name_or_repo)
    repo = entry["repo"] if entry else name_or_repo
    try:
        from huggingface_hub import hf_hub_download
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("huggingface_hub unavailable") from e
    last_err = None
    for fname in expected_filenames(repeat):
        try:
            path = hf_hub_download(repo, fname, cache_dir=cache_dir)
            break
        except Exception as e:  # noqa: BLE001 — the next name of the scheme
            last_err = e
    else:
        raise RuntimeError(
            f"no checkpoint matching {expected_filenames(repeat)} in "
            f"{repo}") from last_err
    if entry is not None:
        manifest_check(name_or_repo, path, repeat)
    return path


def load_pretrained(
    name_or_repo: str,
    cache_dir: Optional[str] = None,
    repeat: Optional[int] = None,
):
    """Download, then (Config, the port's state_dict) of the checkpoint."""
    from lcasr_torch.evaluation.run import load_any_checkpoint

    path = download_pretrained(name_or_repo, cache_dir=cache_dir, repeat=repeat)
    return load_any_checkpoint(path)
