"""Objective evaluation metrics (port of dex_tts_tpu/eval/metric.py).

Capability equivalent of reference: DEX-TTS/src/metric.py:15-95 (CER/WER
via wav2vec2 ASR + jiwer, speaker cosine similarity via Resemblyzer), plus
the mel-MAE parity metric and the DTW-aligned mel-cepstral distortion.

The distances are plain numpy copies of the JAX package's. WER/CER edit
distances are implemented here directly (jiwer is not a dependency); the
ASR and speaker-encoder backends are optional: they need pretrained
weights, so they report unavailable (None) instead of failing the
evaluation. The ASR and the built-in GE2E encoder run on the evaluation's
device (CUDA by default).
"""

from __future__ import annotations

import numpy as np
import torch

from dex_tts_tpu_torch.audio.wav import resample
from dex_tts_tpu_torch.eval.speaker import BuiltinVoiceEncoder
from dex_tts_tpu_torch.utils.device import resolve_device


def mel_mae(a: np.ndarray, b: np.ndarray) -> float:
    """Mean absolute error between two (n_mels, T) log-mels, cropped to the
    shorter length."""
    t = min(a.shape[-1], b.shape[-1])
    return float(np.mean(np.abs(a[..., :t] - b[..., :t])))


def mel_to_cepstra(log_mel: np.ndarray, n_coeffs: int = 13) -> np.ndarray:
    """(n_mels, T) log-mel → (T, n_coeffs) cepstra via an orthonormal
    DCT-II over the mel axis, dropping c0 (frame energy): the MCD feature,
    computed from the log-mel rather than WORLD MCEPs."""
    n_mels = log_mel.shape[0]
    k = np.arange(n_coeffs + 1)[:, None]
    basis = np.cos(
        np.pi * k * (2 * np.arange(n_mels)[None, :] + 1) / (2 * n_mels)
    ) * np.sqrt(2.0 / n_mels)
    return (basis @ np.asarray(log_mel, np.float64)).T[:, 1:]


def _dtw_mean_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Mean per-step euclidean distance along the optimal DTW path between
    feature sequences a (Ta, D) and b (Tb, D).

    Pairwise distances are computed in row blocks (bounded temporary
    memory; the |a|²−2ab form is avoided because its rounding breaks
    dist(x,x)==0 exactly) and the DP recurrence is vectorized over
    anti-diagonals: cells (i,j) with i+j=s depend only on diagonals s−1
    and s−2, so each wavefront is one elementwise minimum."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    dist = np.empty((a.shape[0], b.shape[0]))  # (Ta, Tb)
    block = 256
    for lo in range(0, a.shape[0], block):
        chunk = a[lo : lo + block]
        dist[lo : lo + block] = np.sqrt(
            ((chunk[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        )
    ta, tb = dist.shape
    acc = np.full((ta + 1, tb + 1), np.inf)
    acc[0, 0] = 0.0
    for s in range(2, ta + tb + 1):
        i = np.arange(max(1, s - tb), min(ta, s - 1) + 1)
        j = s - i
        acc[i, j] = dist[i - 1, j - 1] + np.minimum(
            np.minimum(acc[i - 1, j], acc[i, j - 1]), acc[i - 1, j - 1]
        )
    # path length by backtrace (MCD averages over DTW steps)
    i, j, steps = ta, tb, 0
    while i > 1 or j > 1:
        steps += 1
        moves = ((acc[i - 1, j - 1], i - 1, j - 1),
                 (acc[i - 1, j], i - 1, j),
                 (acc[i, j - 1], i, j - 1))
        _, i, j = min(moves, key=lambda m: m[0])
    return float(acc[ta, tb] / (steps + 1))


_MCD_SCALE = 10.0 * np.sqrt(2.0) / np.log(10.0)


def mel_cepstral_distortion(
    mel_ref: np.ndarray, mel_syn: np.ndarray, n_coeffs: int = 13
) -> float:
    """MCD (dB) between two (n_mels, T) log-mels, DTW-aligned (lower is
    better). MCD = 10·√2/ln10 · mean_path ‖Δcepstra‖₂."""
    ca = mel_to_cepstra(mel_ref, n_coeffs)
    cb = mel_to_cepstra(mel_syn, n_coeffs)
    if len(ca) == 0 or len(cb) == 0:
        return float("nan")
    return _MCD_SCALE * _dtw_mean_distance(ca, cb)


def _edit_distance(ref: list, hyp: list) -> int:
    """Levenshtein distance (insert/delete/substitute, all cost 1)."""
    m, n = len(ref), len(hyp)
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[n]


def normalize_transcript(text: str) -> str:
    """Upper-case, strip punctuation: the normalization the reference
    applies before scoring (reference: DEX-TTS/src/metric.py:46-95)."""
    keep = [c for c in text.upper() if c.isalnum() or c == " " or c == "'"]
    return " ".join("".join(keep).split())


def wer(ref: str, hyp: str) -> float:
    ref_w = normalize_transcript(ref).split()
    hyp_w = normalize_transcript(hyp).split()
    if not ref_w:
        return 0.0 if not hyp_w else 1.0
    return _edit_distance(ref_w, hyp_w) / len(ref_w)


def cer(ref: str, hyp: str) -> float:
    ref_c = list(normalize_transcript(ref).replace(" ", ""))
    hyp_c = list(normalize_transcript(hyp).replace(" ", ""))
    if not ref_c:
        return 0.0 if not hyp_c else 1.0
    return _edit_distance(ref_c, hyp_c) / len(ref_c)


class ASRScorer:
    """wav2vec2-based transcription (optional backend), on ``device``
    (CUDA by default). reference: DEX-TTS/src/metric.py:17-45
    (wav2vec2-large-960h-lv60-self).

    ``transformers`` is imported here, never at module level (it can pull
    flax/jax in). Without the package or the pretrained weights the scorer
    is unavailable and `transcribe` returns None.

    ``model_name="random-init"`` builds the same wav2vec2 CTC architecture
    and processor locally (no download), seeded as the JAX package's: the
    real transformers inference path runs with random weights, so
    transcripts, and therefore CER/WER, are meaningless. It exists to check
    the evaluation's plumbing; never report its scores."""

    def __init__(self, model_name: str = "facebook/wav2vec2-large-960h-lv60-self",
                 device=None):
        self.device = resolve_device(device)
        try:
            if model_name == "random-init":
                self._init_random()
            else:
                from transformers import Wav2Vec2ForCTC, Wav2Vec2Processor

                self.processor = Wav2Vec2Processor.from_pretrained(model_name)
                self.model = Wav2Vec2ForCTC.from_pretrained(model_name).eval()
            self.model.to(self.device)
            self.available = True
        except Exception:  # no transformers, or no weights offline
            self.available = False

    def _init_random(self):
        """Local, download-free construction of the wav2vec2 CTC stack:
        the 32-token target vocab (chars + word delimiter |) of the 960h
        English checkpoints, the standard 16 kHz feature extractor, and a
        small random-init Wav2Vec2ForCTC (``torch.manual_seed(0)``)."""
        import json
        import tempfile

        from transformers import (
            Wav2Vec2Config,
            Wav2Vec2CTCTokenizer,
            Wav2Vec2FeatureExtractor,
            Wav2Vec2ForCTC,
            Wav2Vec2Processor,
        )

        vocab = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4}
        for ch in "ETAONIHSRDLUMWCFGYPBVK'XJQZ":
            vocab[ch] = len(vocab)
        with tempfile.NamedTemporaryFile(
            "w", suffix=".json", delete=False
        ) as f:
            json.dump(vocab, f)
            vocab_file = f.name
        tokenizer = Wav2Vec2CTCTokenizer(
            vocab_file, unk_token="<unk>", pad_token="<pad>",
            word_delimiter_token="|",
        )
        extractor = Wav2Vec2FeatureExtractor(
            feature_size=1, sampling_rate=16000, padding_value=0.0,
            do_normalize=True, return_attention_mask=False,
        )
        self.processor = Wav2Vec2Processor(
            feature_extractor=extractor, tokenizer=tokenizer
        )
        torch.manual_seed(0)
        cfg = Wav2Vec2Config(
            vocab_size=len(vocab), hidden_size=64, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=128,
            conv_dim=(32, 32, 32, 32, 32, 32, 32),
        )
        self.model = Wav2Vec2ForCTC(cfg).eval()

    def transcribe(self, wav: np.ndarray, sample_rate: int = 22050) -> str | None:
        if not self.available:
            return None
        wav16 = resample(wav, sample_rate, 16000)
        inputs = self.processor(
            wav16, sampling_rate=16000, return_tensors="pt", padding=True
        )
        with torch.no_grad():
            logits = self.model(inputs.input_values.to(self.device)).logits
        ids = logits.argmax(dim=-1).cpu()
        return self.processor.batch_decode(ids)[0]


class SpeakerScorer:
    """GE2E d-vector speaker-embedding cosine similarity.
    reference: DEX-TTS/src/metric.py:15-22,69-95 (resemblyzer VoiceEncoder).

    Backends:
    - ``"auto"`` (default): the resemblyzer package when importable; else
      the built-in torch GE2E encoder (`eval/speaker.py`) on ``device``
      when a ``weights`` path to resemblyzer's ``pretrained.pt`` is given
      (the same network, so the real metric); else unavailable (cosine →
      None).
    - ``"resemblyzer"`` / ``"builtin"``: force one (forced resemblyzer
      without the package raises ImportError, builtin without weights
      raises ValueError: an accidental random-score path must be loud).
    - ``"random-init"``: the built-in encoder with random weights: runs the
      full embedding path offline but the cosines are MEANINGLESS;
      plumbing checks only; never report its scores. With weights it
      raises."""

    def __init__(self, backend: str = "auto", weights: str | None = None, device=None):
        self.encoder = None
        self.builtin = None
        if backend not in ("auto", "resemblyzer", "builtin", "random-init"):
            raise ValueError(f"unknown speaker backend {backend!r}")
        if backend == "random-init" and weights is not None:
            raise ValueError(
                "backend='random-init' ignores weights — pass "
                "backend='builtin' (or 'auto') with the weights path for "
                "the real metric"
            )
        if backend in ("auto", "resemblyzer"):
            try:
                from resemblyzer import VoiceEncoder

                self.encoder = VoiceEncoder()
            except Exception as e:
                if backend == "resemblyzer":
                    # a forced backend must not degrade to cosine()->None
                    # quietly (as backend='builtin' without weights raises)
                    raise ImportError(
                        "backend='resemblyzer' was forced but the "
                        "resemblyzer package is unavailable "
                        f"({type(e).__name__}: {e}); use backend='auto' "
                        "for graceful fallback, or backend='builtin' with "
                        "a pretrained.pt weights path for the package-free "
                        "GE2E encoder"
                    ) from e
        if self.encoder is None and (
            backend in ("builtin", "random-init")
            or (backend == "auto" and weights is not None)
        ):
            if backend == "builtin" and weights is None:
                raise ValueError(
                    "backend='builtin' needs a weights path; use "
                    "backend='random-init' for the explicit plumbing-only "
                    "random encoder"
                )
            self.builtin = BuiltinVoiceEncoder(
                weights=None if backend == "random-init" else weights, device=device
            )
        self.available = self.encoder is not None or self.builtin is not None

    def cosine(self, wav_a, wav_b, sample_rate: int = 22050) -> float | None:
        if not self.available:
            return None
        if self.encoder is not None:  # the resemblyzer package
            from resemblyzer import preprocess_wav

            ea = self.encoder.embed_utterance(preprocess_wav(wav_a, sample_rate))
            eb = self.encoder.embed_utterance(preprocess_wav(wav_b, sample_rate))
        else:
            ea = self.builtin.embed_utterance(wav_a, source_sr=sample_rate)
            eb = self.builtin.embed_utterance(wav_b, source_sr=sample_rate)
        return float(np.dot(ea, eb) / (np.linalg.norm(ea) * np.linalg.norm(eb)))


def mean_and_stderr(values: list[float]) -> tuple[float, float]:
    arr = np.asarray(values, np.float64)
    if len(arr) == 0:
        return float("nan"), float("nan")
    if len(arr) == 1:  # stderr undefined for a single sample
        return float(arr[0]), 0.0
    return float(arr.mean()), float(arr.std(ddof=1) / np.sqrt(len(arr)))
