from dex_tts_tpu_torch.utils.device import resolve_device
from dex_tts_tpu_torch.utils.misc import intersperse, parse_filelist

__all__ = ["intersperse", "parse_filelist", "resolve_device"]
