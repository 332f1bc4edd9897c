"""sampler_ms.span: milliseconds per call in the sampler's own work, the
self time of the program's ``sampler.step`` spans (each step less its
``denoiser`` calls: the step's arithmetic, the preconditioning and the
σ tensors), by CUDA events; the mean over the window's calls of the
traced run."""

from benchmark.program_spans import mean_per_call, self_ms


def read(run):
    return mean_per_call(run, lambda call: self_ms(call, "sampler.step"))
