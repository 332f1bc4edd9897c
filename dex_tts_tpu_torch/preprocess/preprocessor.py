"""Offline feature extraction: raw corpora → mel/lf0 .npy + trimmed wavs
(port of dex_tts_tpu/preprocess/preprocessor.py).

Capability equivalent of reference: DEX-TTS/preprocess/preprocessor/
{preprocessor,ljspeech,vctk,esd}.py: prepare_align (resample, peak-norm,
write wav + .lab transcript) and build_from_path (log-mel, f0 via the
pitch tracker, saved as {spk}-mel-{base}.npy / {spk}-lf0-{base}.npy).
The corpus readers are copies of the JAX package's; the log-mel runs
through the port's `audio/stft.MelSpectrogram` on the preprocessor's
device (CUDA by default), the lf0 on the host. The files are the JAX
package's: the same names and layouts, mels stored (T, n_mels).
"""

from __future__ import annotations

import csv
import os
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from dex_tts_tpu_torch.audio.pitch import extract_lf0
from dex_tts_tpu_torch.audio.stft import MelSpectrogram
from dex_tts_tpu_torch.audio.wav import peak_normalize, read_wav, resample, write_wav
from dex_tts_tpu_torch.utils.device import resolve_device


@dataclass
class PreprocessConfig:
    corpus_path: str = ""
    raw_path: str = "./raw_data"
    out_path: str = "./preprocessed"
    sample_rate: int = 22050
    n_mels: int = 80
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    f_min: float = 0.0
    f_max: float = 8000.0
    max_wav_value: float = 32768.0


def _write_lab(path: str, text: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)


def prepare_align_ljspeech(cfg: PreprocessConfig) -> None:
    """LJSpeech: metadata.csv `id|raw|normalized`.
    reference: preprocess/preprocessor/ljspeech.py."""
    meta = os.path.join(cfg.corpus_path, "metadata.csv")
    speaker = "LJSpeech"
    out_dir = os.path.join(cfg.raw_path, speaker)
    os.makedirs(out_dir, exist_ok=True)
    with open(meta, encoding="utf-8") as f:
        for row in csv.reader(f, delimiter="|", quoting=csv.QUOTE_NONE):
            base, text = row[0], row[2] if len(row) > 2 else row[1]
            wav_path = os.path.join(cfg.corpus_path, "wavs", f"{base}.wav")
            if not os.path.isfile(wav_path):
                continue
            wav, sr = read_wav(wav_path)
            wav = peak_normalize(resample(wav, sr, cfg.sample_rate))
            write_wav(os.path.join(out_dir, f"{base}.wav"), wav, cfg.sample_rate)
            _write_lab(os.path.join(out_dir, f"{base}.lab"), text)


def prepare_align_vctk(cfg: PreprocessConfig) -> None:
    """VCTK: wav48/{spk}/*.wav + txt/{spk}/*.txt.
    reference: preprocess/preprocessor/vctk.py:13-45."""
    wav_root = None
    for cand in ("wav48_silence_trimmed", "wav48", "wav"):
        if os.path.isdir(os.path.join(cfg.corpus_path, cand)):
            wav_root = os.path.join(cfg.corpus_path, cand)
            break
    txt_root = os.path.join(cfg.corpus_path, "txt")
    for spk in sorted(os.listdir(wav_root)):
        spk_dir = os.path.join(wav_root, spk)
        if not os.path.isdir(spk_dir):
            continue
        out_dir = os.path.join(cfg.raw_path, spk)
        os.makedirs(out_dir, exist_ok=True)
        for name in sorted(os.listdir(spk_dir)):
            if not name.endswith((".wav", ".flac")):
                continue
            base = os.path.splitext(name)[0].replace("_mic1", "").replace(
                "_mic2", ""
            )
            txt_path = os.path.join(txt_root, spk, f"{base}.txt")
            if not os.path.isfile(txt_path):
                continue
            wav, sr = read_wav(os.path.join(spk_dir, name))
            wav = peak_normalize(resample(wav, sr, cfg.sample_rate))
            write_wav(os.path.join(out_dir, f"{base}.wav"), wav, cfg.sample_rate)
            with open(txt_path, encoding="utf-8") as f:
                _write_lab(os.path.join(out_dir, f"{base}.lab"), f.read().strip())


def prepare_align_esd(cfg: PreprocessConfig) -> None:
    """ESD: {spk}/{emotion}/{split}/*.wav + {spk}/{spk}.txt metadata with
    emotion labels. reference: preprocess/preprocessor/esd.py:13-94."""
    for spk in sorted(os.listdir(cfg.corpus_path)):
        spk_dir = os.path.join(cfg.corpus_path, spk)
        meta_path = os.path.join(spk_dir, f"{spk}.txt")
        if not os.path.isdir(spk_dir) or not os.path.isfile(meta_path):
            continue
        meta = {}
        with open(meta_path, encoding="utf-8-sig") as f:
            for line in f:
                parts = line.strip().split("\t")
                if len(parts) >= 3:
                    meta[parts[0]] = (parts[1], parts[2])
        out_dir = os.path.join(cfg.raw_path, spk)
        os.makedirs(out_dir, exist_ok=True)
        for root, _, files in os.walk(spk_dir):
            for name in sorted(files):
                base = os.path.splitext(name)[0]
                if not name.endswith(".wav") or base not in meta:
                    continue
                text, emotion = meta[base]
                wav, sr = read_wav(os.path.join(root, name))
                wav = peak_normalize(resample(wav, sr, cfg.sample_rate))
                write_wav(
                    os.path.join(out_dir, f"{base}.wav"), wav, cfg.sample_rate
                )
                _write_lab(os.path.join(out_dir, f"{base}.lab"), text)
                _write_lab(os.path.join(out_dir, f"{base}.emo"), emotion)


def prepare_align_libritts(cfg: PreprocessConfig) -> None:
    """LibriTTS: {subset}/{speaker}/{chapter}/{utt}.wav + {utt}.normalized.txt
    (falls back to .original.txt). corpus_path may be the LibriTTS root
    (subset dirs inside) or a single subset dir (speaker dirs inside).
    The reference *intends* this preprocessor but ships a latent
    ImportError instead (reference: DEX-TTS/preprocess/preprocess.py:6
    imports a `libritts` module that does not exist in-tree); the filelist
    side does exist (make_file/make_filelist_libri.py), so this completes
    the pipeline it expects."""
    def _has_numeric_subdir(path: str) -> bool:
        # numeric-named *directories* only — a stray numeric FILE must not
        # flip the layout detection (it previously discarded all real
        # subset dirs and silently processed nothing)
        return any(
            d.isdigit() and os.path.isdir(os.path.join(path, d))
            for d in os.listdir(path)
        )

    if _has_numeric_subdir(cfg.corpus_path):
        subset_dirs = [cfg.corpus_path]  # corpus_path IS a subset dir
    else:
        subset_dirs = [
            cand
            for name in sorted(os.listdir(cfg.corpus_path))
            # a subset dir contains numeric speaker dirs
            if os.path.isdir(cand := os.path.join(cfg.corpus_path, name))
            and _has_numeric_subdir(cand)
        ]
        if not subset_dirs:
            warnings.warn(
                f"prepare_align_libritts: {cfg.corpus_path!r} matches "
                "neither LibriTTS layout (no numeric speaker dirs at the "
                "root, no subset dirs containing them) — nothing to do."
            )
    for subset in subset_dirs:
        for spk in sorted(os.listdir(subset)):
            spk_dir = os.path.join(subset, spk)
            if not os.path.isdir(spk_dir) or not spk.isdigit():
                continue
            out_dir = os.path.join(cfg.raw_path, spk)
            for chapter in sorted(os.listdir(spk_dir)):
                chap_dir = os.path.join(spk_dir, chapter)
                if not os.path.isdir(chap_dir):
                    continue
                for name in sorted(os.listdir(chap_dir)):
                    if not name.endswith(".wav"):
                        continue
                    base = os.path.splitext(name)[0]
                    text = None
                    for suffix in (".normalized.txt", ".original.txt"):
                        txt = os.path.join(chap_dir, base + suffix)
                        if os.path.isfile(txt):
                            with open(txt, encoding="utf-8") as f:
                                text = f.read().strip()
                            break
                    if not text:
                        continue
                    wav, sr = read_wav(os.path.join(chap_dir, name))
                    wav = peak_normalize(resample(wav, sr, cfg.sample_rate))
                    os.makedirs(out_dir, exist_ok=True)
                    write_wav(
                        os.path.join(out_dir, f"{base}.wav"),
                        wav,
                        cfg.sample_rate,
                    )
                    _write_lab(os.path.join(out_dir, f"{base}.lab"), text)


PREPARE_ALIGN = {
    "LJSpeech": prepare_align_ljspeech,
    "VCTK": prepare_align_vctk,
    "ESD": prepare_align_esd,
    "LibriTTS": prepare_align_libritts,
}


def prepare_align(dataset: str, cfg: PreprocessConfig) -> None:
    try:
        fn = PREPARE_ALIGN[dataset]
    except KeyError:
        raise ValueError(
            f"unknown dataset {dataset!r}; available: {sorted(PREPARE_ALIGN)}"
        ) from None
    fn(cfg)


class Preprocessor:
    """raw_path/{spk}/*.wav+lab → out_path/{mel,lf0,wav}/... + speaker map,
    the log-mels on ``device`` (CUDA by default).
    reference: preprocess/preprocessor/preprocessor.py:41-130."""

    def __init__(self, cfg: PreprocessConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mel = MelSpectrogram(
            n_fft=cfg.n_fft,
            hop_length=cfg.hop_length,
            win_length=cfg.win_length,
            n_mels=cfg.n_mels,
            sample_rate=cfg.sample_rate,
            fmin=cfg.f_min,
            fmax=cfg.f_max,
        )

    def process_utterance(self, spk: str, wav_path: str, text: str):
        cfg = self.cfg
        wav, sr = read_wav(wav_path)
        wav = resample(wav, sr, cfg.sample_rate)
        base = os.path.splitext(os.path.basename(wav_path))[0]

        with torch.no_grad():
            mel, _ = self.mel(torch.from_numpy(wav)[None].to(self.device))
        mel = mel[0].T.cpu().numpy()  # stored (T, n_mels) like the reference
        lf0 = extract_lf0(wav, cfg.sample_rate, cfg.hop_length)
        t = min(mel.shape[0], len(lf0))
        mel, lf0 = mel[:t], lf0[:t]

        for sub in ("mel", "lf0", "wav"):
            os.makedirs(os.path.join(cfg.out_path, sub, spk), exist_ok=True)
        mel_path = os.path.join(
            cfg.out_path, "mel", spk, f"{spk}-mel-{base}.npy"
        )
        np.save(mel_path, mel)
        np.save(
            os.path.join(cfg.out_path, "lf0", spk, f"{spk}-lf0-{base}.npy"), lf0
        )
        write_wav(
            os.path.join(cfg.out_path, "wav", spk, f"{base}.wav"),
            wav,
            cfg.sample_rate,
        )
        return mel_path, text, t

    def build_from_path(self) -> list[dict]:
        """Process every utterance; returns metadata rows for filelists."""
        cfg = self.cfg
        rows = []
        speakers = sorted(
            d
            for d in os.listdir(cfg.raw_path)
            if os.path.isdir(os.path.join(cfg.raw_path, d))
        )
        for spk_id, spk in enumerate(speakers):
            spk_dir = os.path.join(cfg.raw_path, spk)
            for name in sorted(os.listdir(spk_dir)):
                if not name.endswith(".wav"):
                    continue
                base = os.path.splitext(name)[0]
                lab = os.path.join(spk_dir, f"{base}.lab")
                if not os.path.isfile(lab):
                    continue
                with open(lab, encoding="utf-8") as f:
                    text = f.read().strip()
                emo_path = os.path.join(spk_dir, f"{base}.emo")
                emotion = None
                if os.path.isfile(emo_path):
                    with open(emo_path, encoding="utf-8") as f:
                        emotion = f.read().strip()
                mel_path, text, n_frames = self.process_utterance(
                    spk, os.path.join(spk_dir, name), text
                )
                rows.append(
                    {
                        "mel_path": mel_path,
                        "text": text,
                        "speaker": spk,
                        "speaker_id": spk_id,
                        "emotion": emotion,
                        "n_frames": n_frames,
                    }
                )
        with open(os.path.join(cfg.out_path, "speakers.txt"), "w") as f:
            for spk_id, spk in enumerate(speakers):
                f.write(f"{spk}|{spk_id}\n")
        return rows
