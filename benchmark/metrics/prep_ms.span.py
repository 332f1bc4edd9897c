"""prep_ms.span: milliseconds per call in the program's ``tts.prep`` span
(`pipeline.Synthesizer.prepare_batch`: text front end, buckets, padding,
copy to the card), by the host clock; the mean over the window's calls of
the traced run. The twin of ``prep_ms.synth``, read inside the program."""

from benchmark.program_spans import mean_per_call, total_ms


def read(run):
    return mean_per_call(run, lambda call: total_ms(call, "tts.prep", device=False))
