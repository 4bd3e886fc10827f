"""Data pipeline for training (the port's copy of the parts of
lcasr_tpu/data/dataloading.py that the Trainer uses):

  * `chunk_spectogram` / `chunk_text_json`: split (B, 80, T) podcasts into
    chunk_size windows and their word-aligned transcripts into per-chunk
    strings;
  * `SimpleDataset`: recordings sorted by duration, shuffled in subgroups of
    2000, then shuffled by batch, with `seen_ids` left out for a mid-epoch
    resume.  The numpy RNG calls are the JAX package's, so the same pairs
    JSON and seed give the same batch order (the sort is numpy's quicksort
    argsort, which is what pandas' `sort_values` runs on one column);
  * `VariableBatchSimpleDataloader`, rebuilt at a new batch size when the
    sequence warmup fires.

Spectrograms are `.npy` (or `.pt`, read with torch).  A batch whose specs
are all `.npy` is read by the port's native reader (`lcasr_torch/native`,
a C++ thread pool, the GIL released); with `prefetch=True` (the default,
as in the JAX package) a one-deep background thread loads the next batch
while the caller trains on this one.  Neither changes a batch: the order,
`seen_ids` and the rebuild at a new batch size are the same either way.
"""
from __future__ import annotations

import json
import queue
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

HOP_LENGTH = 160
SR = 16000


def total_seconds(spectogram_length: int) -> float:
    """Frames -> seconds (lcasr_tpu/data/audio.py)."""
    return (spectogram_length * HOP_LENGTH) / SR


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def chunk_spectogram(spec: np.ndarray, chunk_size: int, chunk_overlap: int) -> List[np.ndarray]:
    """(B, feat, T) -> list of (B, feat, <=chunk_size) windows."""
    assert spec.ndim == 3, "Audio must be 3D i.e. (batch, features, time)"
    assert chunk_size > chunk_overlap, "chunk_size must be greater than chunk_overlap"
    return [
        spec[:, :, i : i + chunk_size]
        for i in range(0, spec.shape[2], chunk_size - chunk_overlap)
    ]


def chunk_text_json(
    text: List[Dict[str, str]],
    chunk_size: int,
    chunk_overlap: int,
    spectogram_length: int,
    get_seconds: bool = False,
):
    """Word-aligned transcript JSON -> per-chunk transcript strings.  A word
    belongs to a chunk iff it lies entirely inside the chunk's time span."""
    assert chunk_size > chunk_overlap, "chunk_size must be greater than chunk_overlap"
    text_remaining = text
    splits, start_end = [], []
    for i in range(0, spectogram_length, chunk_size - chunk_overlap):
        c_start_sec = total_seconds(i)
        c_end_sec = total_seconds(i + chunk_size)
        overlap_sec = total_seconds(chunk_overlap)
        c_text: List[str] = []
        max_text_index = 0
        for j, el in enumerate(text_remaining):
            start_t = float(el["startTime"][:-1])
            end_t = float(el["endTime"][:-1])
            if start_t >= c_start_sec and end_t <= c_end_sec:
                c_text.append(el["word"])
            if end_t < c_end_sec - overlap_sec:
                max_text_index = j
            if end_t > c_end_sec:
                break
        text_remaining = text_remaining[max_text_index:]
        splits.append(" ".join(c_text))
        start_end.append((c_start_sec, c_end_sec))
    return (splits, start_end) if get_seconds else splits


def reset_seen_ids(seen_ids: List[str], epoch: int) -> List[str]:
    """Tag ids from a finished epoch so they aren't excluded next epoch."""
    return [f"epoch_{epoch}_{el}" if "epoch_" not in el else el for el in seen_ids]


def load_sample(entry: Dict[str, str]) -> Tuple[np.ndarray, list]:
    """Load (spectrogram (1, 80, T) float32, transcript JSON)."""
    audio_path = entry["audio"]
    if audio_path.endswith(".pt"):
        import torch

        audio = np.asarray(torch.load(audio_path, map_location="cpu", weights_only=False),
                           dtype=np.float32)
    elif audio_path.endswith(".npy"):
        audio = np.load(audio_path).astype(np.float32)
    else:
        raise ValueError(f"unsupported spectrogram format: {audio_path}")
    if audio.ndim == 2:
        audio = audio[None]
    return audio, load_json(entry["txt"])


def decode_item(audio: np.ndarray, txt: dict, rec_id):
    """(F, T) spectrogram and transcript JSON -> ((T, F), words, id)."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 3:
        audio = audio[0]
    words = txt["results"][-1]["alternatives"][0]["words"]
    return audio.T, words, rec_id


def collate(batch):
    """Pad a list of (T, F) specs to (B, F, T_max) + lengths."""
    audio, txt, ids = zip(*batch)
    lengths = np.array([a.shape[0] for a in audio], np.int64)
    out = np.zeros((len(audio), audio[0].shape[1], int(lengths.max())), np.float32)
    for i, a in enumerate(audio):
        out[i, :, : a.shape[0]] = a.T
    return out, lengths, list(txt), list(ids)


class SimpleDataset:
    def __init__(
        self,
        pairs: Dict[str, Dict[str, str]],
        batch_size: int = 8,
        subgroup_shuffle_size: int = 2000,
        random_seed: int = 1234,
        seen_ids: Optional[List[str]] = None,
    ):
        self.batch_size = batch_size
        self.subgroup_shuffle_size = subgroup_shuffle_size
        self.random_seed = random_seed
        seen = set(seen_ids or [])
        rows = [dict(v, id=k) for k, v in pairs.items() if k not in seen]
        order = np.argsort(np.array([r["duration"] for r in rows], dtype=np.float64),
                           kind="quicksort")
        self.rows = [rows[i] for i in order]
        self._create_batches()

    def _create_batches(self):
        np.random.seed(self.random_seed)
        indices = np.arange(len(self))
        groups = [
            np.random.permutation(indices[i : i + self.subgroup_shuffle_size])
            for i in range(0, len(indices), self.subgroup_shuffle_size)
        ]
        indices = np.concatenate(groups) if groups else indices
        batches = [
            indices[i : i + self.batch_size]
            for i in range(0, len(indices), self.batch_size)
        ]
        np.random.shuffle(batches)
        indices = np.concatenate(batches) if batches else indices
        self.rows = [self.rows[i] for i in indices]

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int):
        row = self.rows[idx]
        audio, txt = load_sample(row)
        return decode_item(audio, txt, row["id"])


def prefetched(batches):
    """The items of the iterable `batches`, produced by a background thread
    one item ahead (lcasr_tpu/data/dataloading.py `SimpleDataloader.
    __iter__`).  The worker's exception is raised in the consumer, where
    its batch would have been.  Puts are bounded and watch a stop event, so
    an iterator that is abandoned mid-epoch (the sequence warmup rebuilds
    the loader) releases its worker."""
    q: "queue.Queue" = queue.Queue(maxsize=1)
    sentinel = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in batches:
                if not put(item):
                    return
            put(sentinel)
        except BaseException as e:  # noqa: BLE001
            put(e)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


class VariableBatchSimpleDataloader:
    """Batches of `SimpleDataset`, rebuilt mid-epoch at a new batch size
    when the sequence warmup fires.  Yields (audio (B, 80, T), lengths,
    transcripts, ids).  `prefetch`: load the next batch in a background
    thread; `native`: read all-`.npy` batches with the native reader (the
    Python reader, `np.load`, is the plain version)."""

    def __init__(
        self,
        pairs: Dict[str, Dict[str, str]],
        tokenizer,
        batch_size: int = 5,
        chunk_size: int = 2048,
        chunk_overlap: int = 192,
        random_seed: int = 1234,
        subgroup_shuffle_size: int = 2000,
        seen_ids: Optional[List[str]] = None,
        prefetch: bool = True,
        native: bool = True,
        **kwargs,
    ):
        unknown = set(kwargs) - {"num_workers", "pin_memory"}
        if unknown:  # the others are the JAX loader's and change nothing here
            raise TypeError(f"unknown dataloader argument(s): {sorted(unknown)}")
        self.prefetch = prefetch
        self.native = native
        self.pairs = pairs
        self.tokenizer = tokenizer
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap
        self.batch_size = batch_size
        self.random_seed = random_seed
        self.subgroup_shuffle_size = subgroup_shuffle_size
        self._build(seen_ids or [], random_seed)

    def _build(self, seen_ids: List[str], random_seed: int,
               subgroup_shuffle_size: Optional[int] = None):
        self.dataset = SimpleDataset(
            self.pairs, batch_size=self.batch_size,
            subgroup_shuffle_size=(self.subgroup_shuffle_size
                                   if subgroup_shuffle_size is None else subgroup_shuffle_size),
            random_seed=random_seed, seen_ids=seen_ids,
        )

    def update(self, batch_size: int, seen_ids: Optional[List[str]] = None, random_seed="same"):
        self.batch_size = batch_size
        # as in the JAX package (and the reference): a rebuild shuffles in
        # subgroups of 2000 whatever the constructor said
        self._build(seen_ids or [],
                    self.random_seed if random_seed == "same" else random_seed,
                    subgroup_shuffle_size=2000)

    def total_recordings(self) -> int:
        return len(self.pairs)

    def _load_items(self, dataset: SimpleDataset, lo: int, hi: int):
        """Items [lo, hi) of `dataset`: through the native reader when every
        spec is `.npy`, one thread a file (at most 8)."""
        rows = dataset.rows[lo:hi]
        if self.native and all(r["audio"].endswith(".npy") for r in rows):
            from lcasr_torch.native import read_npy_batch

            specs = read_npy_batch([r["audio"] for r in rows], threads=min(8, len(rows)))
            return [decode_item(spec, load_json(r["txt"]), r["id"])
                    for spec, r in zip(specs, rows)]
        return [dataset[j] for j in range(lo, hi)]

    def _batches(self):
        # the dataset of this iteration: a rebuild (`update`) makes a new one
        # for the next iterator and leaves this one as it was
        dataset, bs = self.dataset, self.batch_size
        n = len(dataset)
        for i in range(0, n, bs):
            yield collate(self._load_items(dataset, i, min(i + bs, n)))

    def __iter__(self):
        return prefetched(self._batches()) if self.prefetch else self._batches()

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)


def chunk_text_and_speakers_json(
    text: List[Dict[str, str]],
    chunk_size: int,
    chunk_overlap: int,
    spectogram_length: int,
    get_seconds: bool = False,
):
    """`chunk_text_json` that also gives, per chunk, the number of distinct
    speakers among its words.  Raises KeyError on a word without a
    `speakerTag`."""
    assert chunk_size > chunk_overlap
    text_remaining = text
    splits, speakers, start_end = [], [], []
    for i in range(0, spectogram_length, chunk_size - chunk_overlap):
        c_start_sec = total_seconds(i)
        c_end_sec = total_seconds(i + chunk_size)
        overlap_sec = total_seconds(chunk_overlap)
        c_text, c_speakers, max_idx = [], [], 0
        for j, el in enumerate(text_remaining):
            start_t, end_t = float(el["startTime"][:-1]), float(el["endTime"][:-1])
            if start_t >= c_start_sec and end_t <= c_end_sec:
                c_text.append(el["word"])
                c_speakers.append(el["speakerTag"])
            if end_t < c_end_sec - overlap_sec:
                max_idx = j
            if end_t > c_end_sec:
                break
        text_remaining = text_remaining[max_idx:]
        splits.append(" ".join(c_text))
        speakers.append(len(set(c_speakers)))
        start_end.append((c_start_sec, c_end_sec))
    return (splits, speakers, start_end) if get_seconds else (splits, speakers)


def chunk_text_json_with_speaker_change(
    text: List[Dict[str, str]],
    chunk_size: int,
    chunk_overlap: int,
    spectogram_length: int,
    get_seconds: bool = False,
    speaker_change_token: str = "¬",
):
    """`chunk_text_json` with `speaker_change_token` inserted before a word
    whose speaker differs from the word before it in the chunk.  Raises
    KeyError on a word without a `speakerTag`."""
    assert chunk_size > chunk_overlap
    text_remaining = text
    splits, start_end = [], []
    for i in range(0, spectogram_length, chunk_size - chunk_overlap):
        c_start_sec = total_seconds(i)
        c_end_sec = total_seconds(i + chunk_size)
        overlap_sec = total_seconds(chunk_overlap)
        c_text, max_idx, prev_speaker = [], 0, None
        for j, el in enumerate(text_remaining):
            prev_speaker = el["speakerTag"] if prev_speaker is None else prev_speaker
            start_t, end_t = float(el["startTime"][:-1]), float(el["endTime"][:-1])
            if start_t >= c_start_sec and end_t <= c_end_sec:
                if el["speakerTag"] != prev_speaker:
                    c_text.append(speaker_change_token)
                c_text.append(el["word"])
                prev_speaker = el["speakerTag"]
            if end_t < c_end_sec - overlap_sec:
                max_idx = j
            if end_t > c_end_sec:
                break
        text_remaining = text_remaining[max_idx:]
        splits.append(" ".join(c_text))
        start_end.append((c_start_sec, c_end_sec))
    return (splits, start_end) if get_seconds else splits
