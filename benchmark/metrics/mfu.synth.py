"""mfu.synth: the FLOPs of one call (matrix products and convolutions, 2
per multiply-add, counted by FlopCounterMode over the plain reference at
the call's shapes) over the mean wall time per call of the traced run's
window and the card's 989.4 TFLOP/s bf16 peak, in percent."""

from benchmark.roofline import MFU_PEAK_FLOPS


def read(run):
    if not run.flops_per_call or not run.calls:
        return None
    per_call_s = sum(c["wall_s"] for c in run.calls) / len(run.calls)
    return 100 * run.flops_per_call / per_call_s / MFU_PEAK_FLOPS
