"""prepass_ms.synth: milliseconds per call in the duration pre-pass,
`Synthesizer.frame_bucket` (text and style encoders, ending in a host
read), by the host clock; the mean over the
window's calls of the traced run."""

LAYER = "prepass"


def read(run):
    values = [c[LAYER + "_s"] for c in run.calls if LAYER + "_s" in c]
    return 1e3 * sum(values) / len(values) if values else None
