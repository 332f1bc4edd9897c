"""vocoder_last_stage_ms.span: milliseconds per call in the program's
last ``vocoder.stage`` span (the last transposed convolution, its
residual blocks and the head: the fewest channels at the output rate,
bound by memory), by CUDA events; the mean over the window's calls of the
traced run. Silent where the program has no stage spans."""

from benchmark.program_spans import mean_per_call


def stage_ms(call) -> float | None:
    spans = [s for s in call.spans if s.name == "vocoder.stage"]
    if not spans or any(s.device_s is None for s in spans):
        return None
    last = max(s.attrs["stage"] for s in spans)
    return 1e3 * sum(s.device_s for s in spans if s.attrs["stage"] == last)


def read(run):
    return mean_per_call(run, stage_ms)
