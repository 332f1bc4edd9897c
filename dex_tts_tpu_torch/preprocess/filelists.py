"""Filelist builders: preprocessed metadata → train/valid/test(+_unseen)
splits (a copy of dex_tts_tpu/preprocess/filelists.py: the same seeded
split, so the files are byte-equal to the JAX package's).

Capability equivalent of reference: DEX-TTS/preprocess/make_file/
make_filelist_{ljspeech,vctk,esd,libri}.py — 80/10/10 splits with
seen/unseen (zero-shot) speaker filtering: VCTK holds out 10 random
speakers (make_filelist_vctk.py:95-104), ESD holds out fixed ids [0, 7]
(make_filelist_esd.py:97), LibriTTS filters by duration
(make_filelist_libri.py:12-51).
"""

from __future__ import annotations

import os
import random


def _write(path: str, rows: list[dict], with_emotion: bool) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for r in rows:
            line = f"{r['mel_path']}|{r['text']}|{r['speaker_id']}"
            if with_emotion and r.get("emotion"):
                line += f"|{r['emotion']}"
            f.write(line + "\n")


def make_filelist(
    rows: list[dict],
    out_dir: str,
    dataset: str = "VCTK",
    unseen_speakers: list[int] | None = None,
    n_random_unseen: int = 0,
    split: tuple[float, float] = (0.8, 0.1),
    min_frames: int = 0,
    max_frames: int = 10**9,
    seed: int = 100,
) -> dict[str, int]:
    """Split metadata rows into train/valid/test files under out_dir.

    Unseen speakers (explicit ids, or n_random_unseen sampled) go to
    *_unseen files for zero-shot evaluation; a train_unseen.txt excludes
    them from training.
    """
    rng = random.Random(seed)
    rows = [r for r in rows if min_frames <= r.get("n_frames", 0) <= max_frames]
    speakers = sorted({r["speaker_id"] for r in rows})
    unseen = set(unseen_speakers or [])
    if n_random_unseen and not unseen:
        unseen = set(rng.sample(speakers, min(n_random_unseen, len(speakers))))

    seen_rows = [r for r in rows if r["speaker_id"] not in unseen]
    unseen_rows = [r for r in rows if r["speaker_id"] in unseen]
    rng.shuffle(seen_rows)

    n = len(seen_rows)
    n_train = int(n * split[0])
    n_valid = int(n * split[1])
    train = seen_rows[:n_train]
    valid = seen_rows[n_train : n_train + n_valid]
    test = seen_rows[n_train + n_valid :]

    with_emotion = dataset.upper() == "ESD"
    _write(os.path.join(out_dir, "train.txt"), train, with_emotion)
    _write(os.path.join(out_dir, "valid.txt"), valid, with_emotion)
    _write(os.path.join(out_dir, "test.txt"), test, with_emotion)
    counts = {"train": len(train), "valid": len(valid), "test": len(test)}
    if unseen:
        _write(os.path.join(out_dir, "train_unseen.txt"), train, with_emotion)
        _write(os.path.join(out_dir, "test_unseen.txt"), unseen_rows, with_emotion)
        counts["test_unseen"] = len(unseen_rows)
    return counts
