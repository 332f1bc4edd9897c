"""unet_ms.span: milliseconds per call in the denoiser's U-Net, the self
time of the program's ``denoiser`` spans (each call less its ``dit``
span: convolutions, GroupNorm, Mish, masks, linear attention, the time
MLPs), by CUDA events, summed over the steps; the mean over the window's
calls of the traced run."""

from benchmark.program_spans import mean_per_call, self_ms


def read(run):
    return mean_per_call(run, lambda call: self_ms(call, "denoiser"))
