"""rtf: all the wall time of the window's calls over all the audio seconds
they returned (the waveforms' true lengths, not the padded bucket)."""


def read(run):
    return run.window_s / sum(c["audio_s"] for c in run.calls)
