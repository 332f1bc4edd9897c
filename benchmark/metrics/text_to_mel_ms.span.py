"""text_to_mel_ms.span: milliseconds per call in the program's
``tts.text_to_mel`` span (the model's whole `synthesize`: encoders,
alignment and the EDM sampler over the U-Net and DiT), by CUDA events at
its entry and exit; the mean over the window's calls of the traced run.
The twin of ``text_to_mel_ms.synth``."""

from benchmark.program_spans import mean_per_call, total_ms


def read(run):
    return mean_per_call(run, lambda call: total_ms(call, "tts.text_to_mel", device=True))
