"""vocoder_ms.span: milliseconds per call in the program's ``tts.vocoder``
span (HiFi-GAN or BigVGAN), by CUDA events at its entry and exit; the
mean over the window's calls of the traced run. The twin of
``vocoder_ms.synth``."""

from benchmark.program_spans import mean_per_call, total_ms


def read(run):
    return mean_per_call(run, lambda call: total_ms(call, "tts.vocoder", device=True))
