"""text_to_mel_ms.synth: milliseconds per call in the sampler and denoiser, the
model's `synthesize` (the EDM sampler over the U-Net and DiT), by CUDA
events at its entry and exit; the mean over the
window's calls of the traced run."""

LAYER = "text_to_mel"


def read(run):
    values = [c[LAYER + "_s"] for c in run.calls if LAYER + "_s" in c]
    return 1e3 * sum(values) / len(values) if values else None
