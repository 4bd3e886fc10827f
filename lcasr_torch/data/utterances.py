"""Presegmented utterances: long recordings chopped into fixed chunks, and
the utterance dataset and loader (the port's copy of
lcasr_tpu/data/utterances.py, after the reference's
`exp/save_utterances.py` and `Utterance_Dataset` / `Utterance_Dataloader`),
the data of `Trainer.train_utterances`.

The files, the order of the files and the shuffle (Python's
`random.Random(seed)`) are the JAX package's, so the same folder and seed
give the same batches.
"""
from __future__ import annotations

import os
import random
from typing import Dict, Iterator, List, Optional

import numpy as np

from lcasr_torch.data.dataloading import chunk_spectogram, chunk_text_json, load_sample


def save_utterances(
    pairs: Dict[str, Dict[str, str]],
    out_dir: str,
    tokenizer,
    chunk_size: int = 2048,
    chunk_overlap: int = 0,
) -> List[str]:
    """Chop word-aligned recordings into chunk_size-frame windows with their
    `chunk_text_json` transcripts, one `.npz` a chunk (fp16 audio, int32
    ids), chunks without text skipped; returns the paths written."""
    os.makedirs(out_dir, exist_ok=True)
    saved = []
    for rec_id, entry in pairs.items():
        audio, txt = load_sample(entry)  # (1, 80, T)
        words = txt["results"][-1]["alternatives"][0]["words"]
        if not words:
            continue
        chunks = chunk_spectogram(audio, chunk_size, chunk_overlap)
        texts = chunk_text_json(words, chunk_size, chunk_overlap, audio.shape[-1])
        encoded = tokenizer.encode_batch(texts)
        for ix, (chunk, ids) in enumerate(zip(chunks, encoded)):
            ids = np.asarray(ids, np.int32)
            if ids.size == 0:
                continue
            path = os.path.join(out_dir, f"{rec_id}_{ix}.npz")
            np.savez_compressed(
                path,
                id=f"{rec_id}_{ix}",
                audio=np.asarray(chunk, np.float16),
                txt=ids,
                txt_lengths=np.asarray([ids.size], np.int64),
                audio_lengths=np.asarray([chunk.shape[-1]], np.int64),
            )
            saved.append(path)
    return saved


class UtteranceDataset:
    """The `.npz` files of a folder, sorted, without the `seen_ids`."""

    def __init__(self, utterance_folder: str, seen_ids: Optional[List[str]] = None):
        files = {f for f in os.listdir(utterance_folder) if f.endswith(".npz")}
        seen = {f"{s}.npz" for s in (seen_ids or [])}
        self.files = sorted(os.path.join(utterance_folder, f) for f in files - seen)

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int):
        data = np.load(self.files[idx], allow_pickle=True)
        return str(data["id"]), data["audio"].astype(np.float32), data["txt"]


def utterance_collate(batch, pad_id: int = 0) -> dict:
    """Pad a batch to its longest audio and text."""
    ids, audio, txt = zip(*batch)
    a_lens = np.array([a.shape[-1] for a in audio], np.int64)
    t_lens = np.array([t.shape[-1] for t in txt], np.int64)
    A = np.zeros((len(batch), 80, int(a_lens.max())), np.float32)
    T = np.full((len(batch), int(t_lens.max())), pad_id, np.int64)
    for i, (a, t) in enumerate(zip(audio, txt)):
        A[i, :, : a.shape[-1]] = a[0]
        T[i, : t.shape[-1]] = t
    return {"ids": list(ids), "audio": A, "text": T, "text_lengths": t_lens,
            "audio_lengths": a_lens}


class UtteranceDataloader:
    """Batches of `UtteranceDataset`, shuffled by `random.Random(random_seed)`."""

    def __init__(
        self,
        utterance_folder: str,
        batch_size: int = 176,
        shuffle: bool = True,
        seen_ids: Optional[List[str]] = None,
        random_seed: int = 1234,
        pad_id: int = 0,
    ):
        self.dataset = UtteranceDataset(utterance_folder, seen_ids=seen_ids)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.random_seed = random_seed
        self.pad_id = pad_id

    def total_recordings(self) -> int:
        return len(self.dataset)

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        order = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.random_seed).shuffle(order)
        for i in range(0, len(order), self.batch_size):
            items = [self.dataset[j] for j in order[i : i + self.batch_size]]
            yield utterance_collate(items, pad_id=self.pad_id)
