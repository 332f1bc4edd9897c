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
(``ref_wavs``, through `prepare_reference`, at the synthesizer's
`AudioConfig`) or as pre-extracted ``ref_feats`` [(mel (F, T), lf0 (T,)),
...]. Long texts go through
`split_sentences` and `tts_stream` (batches ramping 1 → 2 → … →
max_batch, one result per sentence as its batch completes) or
`tts_long` (full batches, one WAV with pauses).

With a ``mesh`` (`parallel.make_mesh`; every rank of it makes the same
calls) the batch is padded to a multiple of the dp size, each dp rank
synthesizes its rows (the noise is the global batch's draw, the frame
bucket the largest any rank predicts) and the results are gathered, so
every rank returns the whole batch; with tp > 1 the model's RetNet and DiT
matmuls are split over the tp group (`parallel.shard_tensor_parallel`).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Sequence

import numpy as np
import torch

from dex_tts_tpu_torch.audio.pitch import extract_lf0, normalize_lf0
from dex_tts_tpu_torch.audio.stft import MelSpectrogram
from dex_tts_tpu_torch.audio.wav import peak_normalize, read_wav, resample, trim_silence
from dex_tts_tpu_torch.models.edm import SamplerConfig
from dex_tts_tpu_torch.ops.masks import fix_len_compatibility
from dex_tts_tpu_torch.parallel import collectives
from dex_tts_tpu_torch.parallel.mesh import shard_rows
from dex_tts_tpu_torch.parallel.tp import shard_tensor_parallel
from dex_tts_tpu_torch.text import CMUDict, text_to_sequence
from dex_tts_tpu_torch.text.symbols import BLANK_ID
from dex_tts_tpu_torch.utils import intersperse, profiling, resolve_device

HOP_LENGTH = 256
SAMPLE_RATE = 22050


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """The audio a Synthesizer works in (a config's ``preprocess``
    section): the rate its waveforms have and reference wavs are
    resampled to, and the log-mel and lf0 front end of a reference wav.
    The defaults are the reference's 22.05 kHz, 80-band front end;
    ``f_max`` None is the Nyquist rate."""

    sample_rate: int = SAMPLE_RATE
    hop_length: int = HOP_LENGTH
    n_fft: int = 1024
    win_length: int = 1024
    n_mels: int = 80
    f_min: float = 0.0
    f_max: float | None = 8000.0

    def mel_spectrogram(self) -> MelSpectrogram:
        return MelSpectrogram(n_fft=self.n_fft, hop_length=self.hop_length,
                              win_length=self.win_length, n_mels=self.n_mels,
                              sample_rate=self.sample_rate, fmin=self.f_min, fmax=self.f_max)


def split_sentences(text: str, max_chars: int = 400) -> list[str]:
    """Split a paragraph into sentence-sized chunks for batched synthesis.

    Splits after sentence-final punctuation followed by whitespace (so
    ellipses stay one chunk and decimals like "3.14" never split); chunks
    with no word character are dropped. A chunk still longer than
    ``max_chars`` is further split at the comma or space nearest its
    midpoint, recursively. Never returns empty chunks."""
    out = [
        c.strip()
        for c in re.split(r"(?<=[.!?;])\s+", text.strip())
        if re.search(r"\w", c)
    ]

    def shorten(s: str) -> list[str]:
        if len(s) <= max_chars:
            return [s]
        mid = len(s) // 2
        for sep in (",", " "):
            cands = [i for i, c in enumerate(s) if c == sep and 0 < i < len(s) - 1]
            if cands:
                cut = min(cands, key=lambda i: abs(i - mid)) + 1
                left, right = s[:cut].strip(), s[cut:].strip()
                if left and right:
                    return shorten(left) + shorten(right)
        return [s]  # one unbreakable token — let bucketing cap it

    return [c for s in out for c in shorten(s)]


def _bucket(n: int, quantum: int, minimum: int = 0) -> int:
    return max(minimum, -(-n // quantum) * quantum)


def ramp_spans(n: int, max_batch: int, first_batch: int = 1) -> list[tuple[int, int]]:
    """(lo, hi) spans covering range(n) with sizes ramping
    ``first_batch → 2x → … → max_batch`` — the batching schedule shared by
    `Synthesizer.tts_stream` and the server's /tts_stream endpoint (small
    first batch for time-to-first-audio, full batches for the tail)."""
    max_batch = max(1, max_batch)
    size = max(1, min(first_batch, max_batch))
    spans, lo = [], 0
    while lo < n:
        hi = min(n, lo + size)
        spans.append((lo, hi))
        lo, size = hi, min(max_batch, size * 2)
    return spans


class Synthesizer:
    audio = AudioConfig()

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
        mesh=None,
        audio: AudioConfig | None = None,
    ):
        """model: a DeXTTS / GeDEXTTS with its weights; vocoder: a
        HiFiGANGenerator, a BigVGANGenerator or None. Both are moved to
        ``device`` (CUDA by default; raises if CUDA is missing and "cpu" was
        not asked for). add_blank intersperses the blank token; x_quantum
        and y_quantum are the text and frame bucket quanta; pad_batches
        pads every batch to a power of two (repeating the last row; the
        extra results are dropped), as the JAX package does. mesh: data-
        and tensor-parallel serving (module docstring); the model is
        tensor-parallel-sharded in place when the mesh's tp size is > 1.
        audio: the rate and reference front end (`AudioConfig`, its
        22.05 kHz defaults when None); ``hop``, the samples per frame, is
        the vocoder's upsampling, else the audio's hop. Raises if a given
        audio's hop is not the vocoder's upsampling."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.mesh = mesh
        if mesh is not None:
            shard_tensor_parallel(self.model, mesh)
        self.vocoder = None if vocoder is None else vocoder.to(self.device).eval()
        self.cmudict = CMUDict(cmu_path) if cmu_path else None
        self.add_blank = add_blank
        self.sampler = sampler or SamplerConfig(num_steps=50)
        self.x_quantum = x_quantum
        self.y_quantum = y_quantum
        self.pad_batches = pad_batches
        if audio is not None:
            self.audio = audio
        self.mel_extractor = self.audio.mel_spectrogram()
        self.hop = self.audio.hop_length
        if vocoder is not None:
            self.hop = int(np.prod(vocoder.cfg.upsample_rates))
            if audio is not None and self.hop != audio.hop_length:
                raise ValueError(f"the vocoder upsamples x{self.hop} but the audio's hop is"
                                 f" {audio.hop_length}")

    def prepare_text(self, text: str) -> np.ndarray:
        seq = text_to_sequence(text, dictionary=self.cmudict)
        if self.add_blank:
            seq = intersperse(seq, BLANK_ID)
        return np.asarray(seq, np.int32)

    def prepare_reference(self, wav_path: str):
        """Reference wav → (mel (n_mels, T), normalized lf0 (T,)), numpy:
        trim, resample to the audio's rate and peak-normalize on the host,
        log-mel on the synthesizer's device, lf0 at the audio's hop on the
        host; raises if the audio's bands are not the model's.
        reference: DEX-TTS/synthesize.py:40-62."""
        audio = self.audio
        if audio.n_mels != self.model.cfg.n_feats:
            raise ValueError(f"the reference front end gives {audio.n_mels} mel bands, the model"
                             f" takes {self.model.cfg.n_feats}: pass its AudioConfig")
        wav, sr = read_wav(wav_path)
        wav = trim_silence(wav, top_db=30.0)
        wav = resample(wav, sr, audio.sample_rate)
        wav = peak_normalize(wav)
        mel, _ = self.mel_extractor(torch.from_numpy(wav)[None].to(self.device))
        mel = mel[0].cpu().numpy()
        lf0 = normalize_lf0(extract_lf0(wav, audio.sample_rate, audio.hop_length))
        t = min(mel.shape[1], len(lf0))
        return mel[:, :t], lf0[:t]

    def prepare_batch(self, texts: Sequence[str], spk_ids=None, ref_feats=None):
        """Token ids, lengths and style inputs of one batch, bucketed and
        padded → (inputs dict of device tensors, true batch size)."""
        with profiling.span("tts.prep"):
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
            if self.mesh is not None:  # every dp rank takes as many rows
                b_pad = -(-b_pad // self.mesh.dp_size) * self.mesh.dp_size
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
        """The static frame count synthesis runs at for this batch (the
        largest over the mesh's ranks)."""
        with profiling.span("tts.prepass"):
            n_frames = collectives.agree_max(self.predict_frames(inputs, length_scale), self.mesh)
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
        # the waveform's rate is the audio's where the vocoder gives its hop
        rate = {"sample_rate": self.audio.sample_rate} if self.hop == self.audio.hop_length else {}
        with profiling.span("tts", batch=len(texts), steps=sampler.num_steps,
                            solver=sampler.solver, **rate):
            if ref_wavs is not None:
                ref_feats = [self.prepare_reference(p) for p in ref_wavs]

            inputs, b = self.prepare_batch(texts, spk_ids, ref_feats)
            profiling.note(padded_batch=inputs["x"].shape[0], text_bucket=inputs["x"].shape[1])
            if self.mesh is not None:
                inputs = shard_rows(inputs, self.mesh)
            y_len = self.frame_bucket(inputs, length_scale, max_frames)
            profiling.note(frame_bucket=y_len)
            cond = {k: v for k, v in inputs.items() if k not in ("x", "x_lengths")}
            with_voc = vocode and self.vocoder is not None
            with collectives.data_parallel(self.mesh):
                _, mel, _, y_lengths = self.model.synthesize(
                    inputs["x"], inputs["x_lengths"], y_max_length=y_len, sampler=sampler,
                    temperature=temperature, length_scale=length_scale,
                    generator=generator, **cond,
                )
                if with_voc:
                    with profiling.span("tts.vocoder", self.device):
                        wav = self.vocoder(mel)
                with profiling.span("tts.readback"):
                    wavs = collectives.gather_rows(wav).cpu().numpy() if with_voc else None
                    mels = collectives.gather_rows(mel).cpu().numpy()
                    lens = collectives.gather_rows(y_lengths).cpu().numpy()
                    results = []
                    for i in range(b):
                        item = {"mel": mels[i, :, : lens[i]].copy(), "n_frames": int(lens[i])}
                        if with_voc:
                            item["wav"] = wavs[i, : lens[i] * self.hop].copy()
                        results.append(item)
        return results

    def tts_stream(
        self,
        text: str,
        generator: torch.Generator | None = None,
        max_chars: int = 400,
        max_batch: int = 16,
        first_batch: int = 1,
        **tts_kwargs,
    ):
        """Incremental long-form synthesis: a generator yielding one
        result dict per sentence, in order, as its batch completes.

        Sentence batches ramp ``first_batch → 2x → … → max_batch``, so the
        first audio is ready after one small synthesis (time-to-first-
        audio) while the tail rides full batches (throughput). Each yielded
        dict is a `tts` result plus ``index`` (sentence position) and
        ``text``. One ``generator`` (a fresh one seeded with 0 when None)
        feeds every batch in turn.

        Per-sentence conditioning (`spk_ids`/`ref_wavs`/`ref_feats`) in
        ``tts_kwargs`` may be a single value — it is broadcast to every
        sentence (a single reference wav is prepared once, not per
        sentence).

        Splitting and validation happen at the call (a bad ``text`` raises
        here, not at the first ``next()``); the returned generator only
        synthesizes."""
        chunks = split_sentences(text, max_chars=max_chars)
        if not chunks:
            raise ValueError("no synthesizable text")
        n = len(chunks)
        tts_kwargs = dict(tts_kwargs)
        if tts_kwargs.get("ref_wavs") is not None and len(tts_kwargs["ref_wavs"]) == 1:
            tts_kwargs["ref_feats"] = [self.prepare_reference(tts_kwargs.pop("ref_wavs")[0])]
        for k in ("spk_ids", "ref_wavs", "ref_feats"):
            v = tts_kwargs.get(k)
            if v is not None and len(v) == 1 and n > 1:
                tts_kwargs[k] = list(v) * n
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        spans = ramp_spans(n, max_batch, first_batch)
        return self._tts_stream_gen(chunks, generator, spans, tts_kwargs)

    def _tts_stream_gen(self, chunks, generator, spans, tts_kwargs):
        for lo, hi in spans:
            group_kwargs = dict(tts_kwargs)
            for k in ("spk_ids", "ref_wavs", "ref_feats"):
                if group_kwargs.get(k) is not None:
                    group_kwargs[k] = group_kwargs[k][lo:hi]
            for i, r in enumerate(self.tts(chunks[lo:hi], generator=generator, **group_kwargs)):
                r = dict(r)
                r["index"] = lo + i
                r["text"] = chunks[lo + i]
                yield r

    def tts_long(
        self,
        text: str,
        generator: torch.Generator | None = None,
        pause_ms: float = 200.0,
        max_chars: int = 400,
        max_batch: int = 16,
        **tts_kwargs,
    ) -> dict:
        """Paragraph synthesis: `split_sentences`, batched calls of up to
        ``max_batch`` sentences (`tts_stream` without the ramp), and the
        waveforms joined with ``pause_ms`` of silence (at the audio's
        rate) between sentences.
        → {"wav", "sentences": [per-sentence dicts]} (no "wav" when the
        sentences have none)."""
        results = list(self.tts_stream(text, generator=generator, max_chars=max_chars,
                                       max_batch=max_batch, first_batch=max_batch,
                                       **tts_kwargs))
        if "wav" not in results[0]:
            return {"sentences": results}
        gap = np.zeros(int(self.audio.sample_rate * pause_ms / 1e3), np.float32)
        parts: list[np.ndarray] = []
        for i, r in enumerate(results):
            if i:
                parts.append(gap)
            parts.append(np.asarray(r["wav"], np.float32))
        return {"wav": np.concatenate(parts), "sentences": results}
