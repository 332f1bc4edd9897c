"""Host data pipeline: filelists → numpy feature batches with bucketed
shapes (a copy of dex_tts_tpu/data/dataset.py, with the port's own text
frontend and `fix_len_compatibility`).

Capability equivalent of reference: DEX-TTS/src/dataset.py:13-177
(TextMelSpeakerDataset + dynamic-padding collate). Batch tensors are
padded to *bucketed* lengths (next multiple of a bucket quantum), so a
train step sees a small, bounded set of shapes.
"""

from __future__ import annotations

import os
import random
from typing import Iterator

import numpy as np

from dex_tts_tpu_torch.data.augmentation import augment_feature
from dex_tts_tpu_torch.ops.masks import fix_len_compatibility
from dex_tts_tpu_torch.text import text_to_sequence
from dex_tts_tpu_torch.text.cmudict import CMUDict
from dex_tts_tpu_torch.text.symbols import BLANK_ID
from dex_tts_tpu_torch.utils import intersperse, parse_filelist


def round_to_bucket(length: int, quantum: int) -> int:
    return -(-length // quantum) * quantum


class TextMelDataset:
    """Loads (text ids, mel, [ref/sty mel, lf0], speaker) per item.

    Filelist lines: ``mel_path|text|speaker(|emotion)``. Mel .npy files are
    stored (T, n_mels) and transposed to (n_mels, T) on load
    (reference: DEX-TTS/src/dataset.py:53-55). lf0 paths are derived by the
    /mel/→/lf0/ rewrite (reference: src/dataset.py:57-76).
    """

    def __init__(
        self,
        filelist_path: str,
        cmu_path: str | None = None,
        add_blank: bool = True,
        load_style: bool = False,
        aug_types: tuple[str, str, str] = ("N", "N", "N"),
        seed: int = 100,
    ):
        self.filelist = parse_filelist(filelist_path)
        self.cmudict = CMUDict(cmu_path) if cmu_path else None
        self.add_blank = add_blank
        self.load_style = load_style
        self.aug_types = aug_types
        self.rng = np.random.default_rng(seed)
        shuffle_rng = random.Random(seed)
        shuffle_rng.shuffle(self.filelist)

    def __len__(self) -> int:
        return len(self.filelist)

    def get_text(self, text: str) -> np.ndarray:
        seq = text_to_sequence(text, dictionary=self.cmudict)
        if self.add_blank:
            seq = intersperse(seq, BLANK_ID)
        return np.asarray(seq, np.int32)

    @staticmethod
    def load_mel(path: str) -> np.ndarray:
        return np.load(path).T.astype(np.float32)  # (n_mels, T)

    @staticmethod
    def normalize_lf0(lf0: np.ndarray) -> np.ndarray:
        """Per-utterance normalize over voiced (non-zero) frames.
        reference: DEX-TTS/src/dataset.py:57-70."""
        lf0 = lf0.astype(np.float32).copy()
        voiced = lf0 != 0
        if voiced.any():
            mean = lf0[voiced].mean()
            std = lf0[voiced].std()
            if std == 0:
                lf0 -= mean
            else:
                lf0 = (lf0 - mean) / (std + 1e-8)
            lf0[~voiced] = 0.0
        return lf0

    def load_lf0(self, mel_path: str) -> np.ndarray:
        lf0_path = mel_path.replace("/mel/", "/lf0/").replace("-mel-", "-lf0-")
        return self.normalize_lf0(np.load(lf0_path))

    def __getitem__(self, index: int) -> dict:
        line = self.filelist[index]
        path, text, speaker = line[0], line[1], line[2] if len(line) > 2 else "0"
        item = {
            "x": self.get_text(text),
            "y": self.load_mel(path),
            "spk": np.int32(speaker),
        }
        if self.load_style:
            mel = item["y"]
            # ref and sty are the same mel in the reference pipeline
            # (reference: DEX-TTS/src/dataset.py:41-42)
            item["ref"] = augment_feature(mel, self.rng, self.aug_types[0])
            item["lf0"] = augment_feature(
                self.load_lf0(path), self.rng, self.aug_types[1]
            )
            item["sty"] = augment_feature(mel, self.rng, self.aug_types[2])
        if len(line) > 3:
            item["emotion"] = line[3]
        return item

    def sample_test_batch(self, size: int) -> list[dict]:
        """Random sample of items for periodic train-time synthesis.
        reference: DEX-TTS/src/dataset.py:93-99."""
        idx = self.rng.choice(len(self), size=size, replace=False)
        return [self[int(i)] for i in idx]

    def get_sample_idx(self, spk_list: list[int]) -> list[int]:
        """Indices of items whose speaker is in spk_list.
        reference: DEX-TTS/src/dataset.py:101-108."""
        out = []
        for i, line in enumerate(self.filelist):
            if len(line) > 2 and int(line[2]) in spk_list:
                out.append(i)
        return out

    def eval_item(self, index: int) -> dict:
        item = self[index]
        line = self.filelist[index]
        item["filepath"] = line[0]
        item["raw_text"] = line[1]
        item.setdefault("emotion", "None")
        return item

    def item_lengths(self, index: int) -> tuple[int, int]:
        """(token count, mel frame count) without loading feature data —
        the mel shape comes from the .npy header only. Used by multi-host
        batchers to agree on global bucket shapes while each process loads
        only its local shard."""
        line = self.filelist[index]
        x_len = len(self.get_text(line[1]))
        shape = np.load(line[0], mmap_mode="r").shape  # header read only
        return x_len, int(shape[0])  # stored (T, n_mels)


class BucketBatcher:
    """Groups items into batches padded to bucketed lengths.

    x padded to multiples of ``x_quantum``; mel frames to multiples of
    ``y_quantum`` (≥4 so the U-Net's two downsamples divide evenly,
    reference: DEX-TTS/model/utils.py:13-17). Style/lf0 features share the
    mel-frame bucket.

    Multi-host: with ``process_count > 1`` every process computes the SAME
    global batch order (same seed) but loads/collates only its contiguous
    ``batch_size // process_count`` slice of each batch; bucket shapes are
    derived from header-only length reads of the *whole* global batch so all
    processes see identical step shapes.

    ``prefetch`` > 0 overlaps host-side loading/collation of the next
    batches with device compute via a background thread (the reference used
    multi-worker DataLoaders for this, DEX-TTS/main.py:30-33).
    """

    def __init__(
        self,
        dataset: TextMelDataset,
        batch_size: int,
        x_quantum: int = 32,
        y_quantum: int = 64,
        shuffle: bool = True,
        seed: int = 100,
        drop_last: bool = True,
        sort_by_length: bool = True,
        process_count: int = 1,
        process_index: int = 0,
        prefetch: int = 2,
    ):
        assert batch_size % process_count == 0, (batch_size, process_count)
        assert 0 <= process_index < process_count
        self.ds = dataset
        self.batch_size = batch_size
        self.x_quantum = x_quantum
        self.y_quantum = max(y_quantum, 4)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.sort_by_length = sort_by_length
        self.process_count = process_count
        self.process_index = process_index
        self.prefetch = prefetch
        self.rng = random.Random(seed)
        self._lengths = None

    def _batch_indices(self) -> list[list[int]]:
        idx = list(range(len(self.ds)))
        if self.shuffle:
            self.rng.shuffle(idx)
        if self.sort_by_length:
            # sort within coarse chunks so batches have similar mel lengths
            # (minimizes padding waste and bucket count) while keeping
            # stochasticity across epochs
            chunk = self.batch_size * 32
            if self._lengths is None:
                self._lengths = {
                    i: os.path.getsize(self.ds.filelist[i][0])
                    for i in range(len(self.ds))
                }
            idx = [
                j
                for k in range(0, len(idx), chunk)
                for j in sorted(idx[k : k + chunk], key=self._lengths.get)
            ]
        batches = [
            idx[k : k + self.batch_size]
            for k in range(0, len(idx), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        if self.shuffle:
            self.rng.shuffle(batches)
        return batches

    def collate(
        self, items: list[dict], x_max: int | None = None, y_max: int | None = None
    ) -> dict:
        b = len(items)
        n_feats = items[0]["y"].shape[0]
        if x_max is None:
            x_max = round_to_bucket(
                max(it["x"].shape[0] for it in items), self.x_quantum
            )
        if y_max is None:
            y_max = fix_len_compatibility(
                round_to_bucket(max(it["y"].shape[1] for it in items), self.y_quantum)
            )

        batch = {
            "x": np.zeros((b, x_max), np.int32),
            "x_lengths": np.zeros((b,), np.int32),
            "y": np.zeros((b, n_feats, y_max), np.float32),
            "y_lengths": np.zeros((b,), np.int32),
            "spk": np.zeros((b,), np.int32),
        }
        has_style = "ref" in items[0]
        if has_style:
            for key in ("ref", "sty"):
                batch[key] = np.zeros((b, n_feats, y_max), np.float32)
                batch[f"{key}_lengths"] = np.zeros((b,), np.int32)
            batch["lf0"] = np.zeros((b, y_max), np.float32)
            batch["lf0_lengths"] = np.zeros((b,), np.int32)

        for i, it in enumerate(items):
            tx = it["x"].shape[0]
            ty = it["y"].shape[1]
            batch["x"][i, :tx] = it["x"]
            batch["x_lengths"][i] = tx
            batch["y"][i, :, :ty] = it["y"]
            batch["y_lengths"][i] = ty
            batch["spk"][i] = it["spk"]
            if has_style:
                for key in ("ref", "sty"):
                    feat = it[key]
                    batch[key][i, :, : feat.shape[1]] = feat[:, :y_max]
                    batch[f"{key}_lengths"][i] = min(feat.shape[1], y_max)
                lf0 = it["lf0"]
                batch["lf0"][i, : min(len(lf0), y_max)] = lf0[:y_max]
                batch["lf0_lengths"][i] = min(len(lf0), y_max)
        return batch

    def _make_batch(self, batch_idx: list[int]) -> dict:
        if self.process_count == 1:
            return self.collate([self.ds[i] for i in batch_idx])
        # shapes from the WHOLE global batch (header-only reads); data from
        # this process's contiguous slice only
        lengths = [self.ds.item_lengths(i) for i in batch_idx]
        x_max = round_to_bucket(max(l[0] for l in lengths), self.x_quantum)
        y_max = fix_len_compatibility(
            round_to_bucket(max(l[1] for l in lengths), self.y_quantum)
        )
        per = self.batch_size // self.process_count
        lo = self.process_index * per
        local = batch_idx[lo : lo + per]
        return self.collate([self.ds[i] for i in local], x_max=x_max, y_max=y_max)

    def __iter__(self) -> Iterator[dict]:
        batches = self._batch_indices()
        if self.prefetch <= 0:
            for batch_idx in batches:
                yield self._make_batch(batch_idx)
            return
        # background thread builds the next `prefetch` batches while the
        # consumer's device step runs
        import queue
        import threading

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        sentinel = object()
        errors: list[BaseException] = []

        def worker():
            try:
                for batch_idx in batches:
                    batch = self._make_batch(batch_idx)
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.5)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as exc:  # propagate to consumer
                errors.append(exc)
            finally:
                while not stop.is_set():
                    try:
                        q.put(sentinel, timeout=0.5)
                        break
                    except queue.Full:
                        continue

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            stop.set()
        thread.join()
        if errors:
            raise errors[0]

    def __len__(self) -> int:
        n = len(self.ds) // self.batch_size
        return n if self.drop_last else -(-len(self.ds) // self.batch_size)
