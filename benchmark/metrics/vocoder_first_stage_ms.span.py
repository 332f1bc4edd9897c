"""vocoder_first_stage_ms.span: milliseconds per call in the program's
first ``vocoder.stage`` span (``conv_pre``, the first transposed
convolution and its residual blocks: the most channels at the lowest
rate, bound by compute), by CUDA events; the mean over the window's calls
of the traced run. Silent where the program has no stage spans."""

from benchmark.program_spans import mean_per_call


def stage_ms(call) -> float | None:
    spans = [s for s in call.spans if s.name == "vocoder.stage" and s.attrs.get("stage") == 0]
    if not spans or any(s.device_s is None for s in spans):
        return None
    return 1e3 * sum(s.device_s for s in spans)


def read(run):
    return mean_per_call(run, stage_ms)
