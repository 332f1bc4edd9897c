from dex_tts_tpu_torch.utils.device import resolve_device
from dex_tts_tpu_torch.utils.misc import intersperse

__all__ = ["intersperse", "resolve_device"]
