"""readback_ms.span: milliseconds per call in the program's
``tts.readback`` span (from the vocoder's return to the call's: the
gather, the copies to the host that wait for the card, the per-item
slices), by the host clock; the mean over the window's calls of the
traced run."""

from benchmark.program_spans import mean_per_call, total_ms


def read(run):
    return mean_per_call(run, lambda call: total_ms(call, "tts.readback", device=False))
