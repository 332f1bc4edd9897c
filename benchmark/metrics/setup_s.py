"""setup_s: process start to the end of the warm-up calls: imports, the
kernels' build or load, weights on the device, the Synthesizer and one
call at each shape the traffic uses."""


def read(run):
    return run.setup_s
