"""A run with the timed path broken underneath comes out not correct:
the harness's own run (everything but its look for a card), at the tiny
size on the CPU, once per fault a synthesis cell can have. (One card: no
exchange between chips to leave out.)"""

import pytest
import torch

from benchmark.run import run_cell
from benchmark.tests.tiny import tiny_cell, workloads


def _state_unchanged(monkeypatch):
    """Every sampler step returns its state: the denoised estimate is the
    input itself."""
    from dex_tts_tpu_torch.models import edm

    monkeypatch.setattr(edm, "apply_precond", lambda fn, x, sigma, *a, **k: x)


def _half_batch(monkeypatch):
    """Text→mel runs on the first half of the batch; the second half
    repeats it."""
    from dex_tts_tpu_torch.models.tts import GeDEXTTS

    original = GeDEXTTS.synthesize

    def half(self, x, x_lengths, *args, **kwargs):
        h = x.shape[0] // 2
        cut = {k: v[:h] if isinstance(v, torch.Tensor) and v.dim() and v.shape[0] == x.shape[0]
               else v for k, v in kwargs.items()}
        out = original(self, x[:h], x_lengths[:h], *args, **cut)
        return tuple(torch.cat([o, o]) for o in out)

    monkeypatch.setattr(GeDEXTTS, "synthesize", half)


def _token_altered(monkeypatch):
    """The front end gives one wrong symbol per sentence."""
    from dex_tts_tpu_torch import pipeline

    original = pipeline.text_to_sequence

    def altered(text, *args, **kwargs):
        seq = original(text, *args, **kwargs)
        return [seq[0] % 40 + 1] + seq[1:]

    monkeypatch.setattr(pipeline, "text_to_sequence", altered)


def _answer_altered(monkeypatch):
    """The vocoder's first waveform comes out sign-flipped in its second
    half."""
    from dex_tts_tpu_torch.models.vocoder import BigVGANGenerator, HiFiGANGenerator

    for cls in (HiFiGANGenerator, BigVGANGenerator):
        original = cls.forward

        def altered(self, mel, _original=original):
            wav = _original(self, mel).clone()
            wav[0, wav.shape[1] // 2:] *= -1
            return wav

        monkeypatch.setattr(cls, "forward", altered)


def _wav_truncated(monkeypatch):
    """The vocoder returns the first half of each waveform."""
    from dex_tts_tpu_torch.models.vocoder import BigVGANGenerator, HiFiGANGenerator

    for cls in (HiFiGANGenerator, BigVGANGenerator):
        original = cls.forward

        def truncated(self, mel, _original=original):
            wav = _original(self, mel)
            return wav[:, : wav.shape[1] // 2]

        monkeypatch.setattr(cls, "forward", truncated)


def _bias_dropped(monkeypatch):
    """The vocoder's layers run without their bias adds."""
    from dex_tts_tpu_torch.models.vocoder import BigVGANGenerator, HiFiGANGenerator

    for cls in (HiFiGANGenerator, BigVGANGenerator):
        original = cls.forward

        def dropped(self, mel, _original=original):
            biases = [p for n, p in self.named_parameters() if n.endswith("bias")]
            saved = [p.detach().clone() for p in biases]
            with torch.no_grad():
                for p in biases:
                    p.zero_()
            try:
                return _original(self, mel)
            finally:
                with torch.no_grad():
                    for p, v in zip(biases, saved):
                        p.copy_(v)

        monkeypatch.setattr(cls, "forward", dropped)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "token_altered": _token_altered, "answer_altered": _answer_altered,
          "wav_truncated": _wav_truncated, "bias_dropped": _bias_dropped}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", workloads())
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = run_cell(tiny_cell(workload), seed=2**32 + 11, seconds=0.0, trace=False,
                      device="cpu")
    assert not result["correct"], result["checks"]
