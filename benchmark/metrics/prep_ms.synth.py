"""prep_ms.synth: milliseconds per call in the entry, `pipeline.Synthesizer.prepare_batch`
(text front end, buckets, padding, copy to the card), by the host clock; the mean over the
window's calls of the traced run."""

LAYER = "prep"


def read(run):
    values = [c[LAYER + "_s"] for c in run.calls if LAYER + "_s" in c]
    return 1e3 * sum(values) / len(values) if values else None
