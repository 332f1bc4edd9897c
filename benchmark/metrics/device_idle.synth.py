"""device_idle.synth: the share of one profiled call's wall time in which
no operation ran on the device (torch.profiler), in percent."""


def read(run):
    if run.trace is None or not run.trace.window_s:
        return None
    return 100 * (1 - run.trace.busy_s / run.trace.window_s)
