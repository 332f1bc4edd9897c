"""dit_ms.span: milliseconds per call in the program's ``dit`` spans (the
DiT middle block with the style adaptors before it, skipped on the DiT
cache's reusing steps), by CUDA events, summed over the steps; the mean
over the window's calls of the traced run."""

from benchmark.program_spans import mean_per_call, total_ms


def read(run):
    return mean_per_call(run, lambda call: total_ms(call, "dit", device=True))
