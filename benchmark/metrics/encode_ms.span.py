"""encode_ms.span: milliseconds per call in the program's
``text_to_mel.encode`` span (everything `synthesize` does before the
sampler: the text and style encoders, run a second time after the
pre-pass, the alignment, mu_y and the noise draw), by CUDA events; the
mean over the window's calls of the traced run."""

from benchmark.program_spans import mean_per_call, total_ms


def read(run):
    return mean_per_call(run, lambda call: total_ms(call, "text_to_mel.encode", device=True))
