"""attention_roofline.synth: the least time the DiT's attention calls
need (q, k, v read once, o written once, 4·B·H·T²·hd operations, at the
card's peaks; `benchmark.roofline.attention_bound_ms` from each call's
(B, T, 3, H, hd) input) over all device time of the work launched inside
those calls, whatever kernels implement them, in one profiled call."""

from benchmark.roofline import attention_bound_ms

SPANS = {"attention": ("dex_tts_tpu_torch.models.dit", "flash_attention_qkv")}


def read(run):
    calls = run.kernel_calls.get("attention")
    device_s = run.trace.span_device_s("attention") if calls else 0.0
    if not device_s:
        return None
    bound_ms = 0.0
    for call in calls:
        (b, t, _, h, hd), dtype = call["args"][0]
        bound_ms += attention_bound_ms(b, t, h, hd, dtype)
    return 100 * bound_ms / 1e3 / device_s
