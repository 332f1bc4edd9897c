from dex_tts_tpu_torch.models.vocoder.bigvgan import BigVGANConfig, BigVGANGenerator
from dex_tts_tpu_torch.models.vocoder.hifigan import HiFiGANConfig, HiFiGANGenerator

__all__ = ["BigVGANConfig", "BigVGANGenerator", "HiFiGANConfig", "HiFiGANGenerator"]
