"""prepass_ms.span: milliseconds per call in the program's ``tts.prepass``
span (`Synthesizer.frame_bucket`: the duration pre-pass's text and style
encoders, ending in a host read), by the host clock; the mean over the
window's calls of the traced run. The twin of ``prepass_ms.synth``."""

from benchmark.program_spans import mean_per_call, total_ms


def read(run):
    return mean_per_call(run, lambda call: total_ms(call, "tts.prepass", device=False))
