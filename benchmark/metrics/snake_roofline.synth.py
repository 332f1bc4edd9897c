"""snake_roofline.synth: the least time BigVGAN's anti-aliased snake
calls need (`benchmark.roofline.snake_bound_ms` from each call's (B, T, C)
input and filter taps) over all device time of the work launched inside
those calls, in one profiled call. Silent where the vocoder has no
snake."""

from benchmark.roofline import snake_bound_ms

SPANS = {"snake": ("dex_tts_tpu_torch.models.vocoder.bigvgan", "snake_antialias")}


def read(run):
    calls = run.kernel_calls.get("snake")
    device_s = run.trace.span_device_s("snake") if calls else 0.0
    if not device_s:
        return None
    bound_ms = 0.0
    for call in calls:
        (b, t, c), dtype = call["args"][0]
        bound_ms += snake_bound_ms(b, t, c, dtype, call["kwargs"].get("kernel_size", 12))
    return 100 * bound_ms / 1e3 / device_s
