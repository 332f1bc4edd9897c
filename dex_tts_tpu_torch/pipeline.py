"""End-to-end inference: text (+ reference speech / style features /
speaker id) → waveform (port of dex_tts_tpu/pipeline.py, `tts` path).

  1. the duration pre-pass (`predict_frames`) predicts the frame count,
  2. the host rounds it up to a frame bucket (×``y_quantum``, U-Net
     compatible) and the text to a ×``x_quantum`` bucket, and pads the
     batch to a power of two (``pad_batches``),
  3. one synthesis at the bucketed shape runs the sampler (50 euler steps
     unless the call asks for other steps, solver or DiT cache) and the
     vocoder (unless ``vocode=False``).

The buckets and batch padding are those of the JAX package, so both pick
the same shapes for the same inputs. Style comes in as reference wav files
(``ref_wavs``, through `prepare_reference`) or as pre-extracted
``ref_feats`` [(mel (F, T), lf0 (T,)), ...]; `tts_stream` and `tts_long`
are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from dex_tts_tpu_torch.audio.pitch import extract_lf0, normalize_lf0
from dex_tts_tpu_torch.audio.stft import MelSpectrogram
from dex_tts_tpu_torch.audio.wav import peak_normalize, read_wav, resample, trim_silence
from dex_tts_tpu_torch.models.edm import SamplerConfig
from dex_tts_tpu_torch.ops.masks import fix_len_compatibility
from dex_tts_tpu_torch.text import CMUDict, text_to_sequence
from dex_tts_tpu_torch.text.symbols import BLANK_ID
from dex_tts_tpu_torch.utils import intersperse, resolve_device

HOP_LENGTH = 256
SAMPLE_RATE = 22050


def _bucket(n: int, quantum: int, minimum: int = 0) -> int:
    return max(minimum, -(-n // quantum) * quantum)


class Synthesizer:
    def __init__(
        self,
        model,
        vocoder=None,
        cmu_path: str | None = None,
        sampler: SamplerConfig | None = None,
        device=None,
        add_blank: bool = True,
        x_quantum: int = 32,
        y_quantum: int = 64,
        pad_batches: bool = True,
    ):
        """model: a DeXTTS / GeDEXTTS with its weights; vocoder: a
        HiFiGANGenerator, a BigVGANGenerator or None. Both are moved to
        ``device`` (CUDA by default; raises if CUDA is missing and "cpu" was
        not asked for). add_blank intersperses the blank token; x_quantum
        and y_quantum are the text and frame bucket quanta; pad_batches
        pads every batch to a power of two (repeating the last row; the
        extra results are dropped), as the JAX package does."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.vocoder = None if vocoder is None else vocoder.to(self.device).eval()
        self.cmudict = CMUDict(cmu_path) if cmu_path else None
        self.add_blank = add_blank
        self.sampler = sampler or SamplerConfig(num_steps=50)
        self.x_quantum = x_quantum
        self.y_quantum = y_quantum
        self.pad_batches = pad_batches
        self.mel_extractor = MelSpectrogram()
        self.hop = HOP_LENGTH
        if vocoder is not None:
            self.hop = int(np.prod(vocoder.cfg.upsample_rates))

    def prepare_text(self, text: str) -> np.ndarray:
        seq = text_to_sequence(text, dictionary=self.cmudict)
        if self.add_blank:
            seq = intersperse(seq, BLANK_ID)
        return np.asarray(seq, np.int32)

    def prepare_reference(self, wav_path: str):
        """Reference wav → (mel (80, T), normalized lf0 (T,)), numpy: trim,
        resample to 22.05 kHz and peak-normalize on the host, log-mel on
        the synthesizer's device, lf0 on the host.
        reference: DEX-TTS/synthesize.py:40-62."""
        wav, sr = read_wav(wav_path)
        wav = trim_silence(wav, top_db=30.0)
        wav = resample(wav, sr, SAMPLE_RATE)
        wav = peak_normalize(wav)
        mel, _ = self.mel_extractor(torch.from_numpy(wav)[None].to(self.device))
        mel = mel[0].cpu().numpy()
        lf0 = normalize_lf0(extract_lf0(wav, SAMPLE_RATE, HOP_LENGTH))
        t = min(mel.shape[1], len(lf0))
        return mel[:, :t], lf0[:t]

    def prepare_batch(self, texts: Sequence[str], spk_ids=None, ref_feats=None):
        """Token ids, lengths and style inputs of one batch, bucketed and
        padded → (inputs dict of device tensors, true batch size)."""
        seqs = [self.prepare_text(t) for t in texts]
        b = len(seqs)
        x_max = _bucket(max(len(s) for s in seqs), self.x_quantum)
        x = np.zeros((b, x_max), np.int64)
        x_lengths = np.zeros((b,), np.int64)
        for i, s in enumerate(seqs):
            x[i, : len(s)] = s
            x_lengths[i] = len(s)
        inputs = {"x": x, "x_lengths": x_lengths}
        if spk_ids is not None:
            inputs["spk"] = np.asarray(spk_ids, np.int64)
        if ref_feats is not None:
            # mel and lf0 can disagree in length for pre-extracted
            # features: truncate each pair to the common length
            pairs = [
                (m[:, : min(m.shape[1], len(l))], l[: min(m.shape[1], len(l))])
                for m, l in ref_feats
            ]
            t_max = _bucket(max(m.shape[1] for m, _ in pairs), self.y_quantum, 4)
            ref = np.zeros((b, pairs[0][0].shape[0], t_max), np.float32)
            lf0 = np.zeros((b, t_max), np.float32)
            lens = np.zeros((b,), np.int64)
            for i, (m, l) in enumerate(pairs):
                ref[i, :, : m.shape[1]] = m
                lf0[i, : len(l)] = l
                lens[i] = m.shape[1]
            inputs.update(ref=ref, ref_lengths=lens, sty=ref, sty_lengths=lens,
                          lf0=lf0, lf0_lengths=lens)
        b_pad = 1 << (b - 1).bit_length() if self.pad_batches else b
        if b_pad != b:
            # repeat the last row: padding stays a valid input; the extra
            # rows are dropped from the results
            inputs = {
                k: np.concatenate([v, np.repeat(v[-1:], b_pad - b, axis=0)])
                for k, v in inputs.items()
            }
        inputs = {k: torch.from_numpy(v).to(self.device) for k, v in inputs.items()}
        return inputs, b

    @torch.no_grad()
    def predict_frames(self, inputs: dict, length_scale=1.0) -> int:
        """Host-side frame estimate from the duration predictor."""
        cond = {k: v for k, v in inputs.items() if k not in ("x", "x_lengths")}
        logw, x_mask = self.model.predict_durations(inputs["x"], inputs["x_lengths"], **cond)
        w = np.exp(logw[:, :, 0].cpu().numpy()) * x_mask[:, :, 0].cpu().numpy()
        frames = np.ceil(w).sum(axis=1) * length_scale
        return int(frames.max())

    def frame_bucket(self, inputs: dict, length_scale=1.0, max_frames: int = 2048) -> int:
        """The static frame count synthesis runs at for this batch."""
        n_frames = self.predict_frames(inputs, length_scale)
        return fix_len_compatibility(min(_bucket(n_frames, self.y_quantum, 8), max_frames))

    @torch.no_grad()
    def tts(
        self,
        texts: Sequence[str],
        generator: torch.Generator | None = None,
        n_timesteps: int | None = None,
        dit_cache_interval: int | None = None,
        solver: str | None = None,
        temperature: float = 1.5,
        length_scale: float = 1.0,
        spk_ids: Sequence[int] | None = None,
        ref_wavs: Sequence[str] | None = None,
        ref_feats: Sequence[tuple] | None = None,
        vocode: bool = True,
        max_frames: int = 2048,
    ) -> list[dict]:
        """Synthesize a batch of sentences → [{mel, wav, n_frames}] (no
        "wav" without a vocoder or with ``vocode=False``). Style comes from
        ``ref_wavs`` (one wav path per sentence) or else ``ref_feats``.
        Noise comes from ``generator`` (a generator on the synthesizer's
        device; a fresh one seeded with 0 when None). ``n_timesteps``,
        ``solver`` (e.g. "dpmpp2m") and ``dit_cache_interval`` override
        the synthesizer's sampler for this call only."""
        overrides = {}
        if n_timesteps is not None and n_timesteps != self.sampler.num_steps:
            overrides["num_steps"] = n_timesteps
        if dit_cache_interval is not None and dit_cache_interval != self.sampler.dit_cache_interval:
            overrides["dit_cache_interval"] = dit_cache_interval
        if solver is not None and solver != self.sampler.solver:
            overrides["solver"] = solver
        # a per-call local, never written to self: concurrent calls on one
        # Synthesizer each keep their own sampler
        sampler = dataclasses.replace(self.sampler, **overrides) if overrides else self.sampler
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        if ref_wavs is not None:
            ref_feats = [self.prepare_reference(p) for p in ref_wavs]

        inputs, b = self.prepare_batch(texts, spk_ids, ref_feats)
        y_len = self.frame_bucket(inputs, length_scale, max_frames)
        cond = {k: v for k, v in inputs.items() if k not in ("x", "x_lengths")}
        _, mel, _, y_lengths = self.model.synthesize(
            inputs["x"], inputs["x_lengths"], y_max_length=y_len, sampler=sampler,
            temperature=temperature, length_scale=length_scale,
            generator=generator, **cond,
        )
        with_voc = vocode and self.vocoder is not None
        wavs = self.vocoder(mel).cpu().numpy() if with_voc else None
        mels = mel.cpu().numpy()
        lens = y_lengths.cpu().numpy()
        results = []
        for i in range(b):
            item = {"mel": mels[i, :, : lens[i]].copy(), "n_frames": int(lens[i])}
            if with_voc:
                item["wav"] = wavs[i, : lens[i] * self.hop].copy()
            results.append(item)
        return results
