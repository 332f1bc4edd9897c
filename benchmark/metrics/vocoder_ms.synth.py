"""vocoder_ms.synth: milliseconds per call in the vocoder's `forward` (HiFi-GAN
or BigVGAN), by CUDA events at its entry and exit; the mean over the
window's calls of the traced run."""

LAYER = "vocoder"


def read(run):
    values = [c[LAYER + "_s"] for c in run.calls if LAYER + "_s" in c]
    return 1e3 * sum(values) / len(values) if values else None
