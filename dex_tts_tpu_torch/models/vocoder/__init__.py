from dex_tts_tpu_torch.models.vocoder.hifigan import HiFiGANConfig, HiFiGANGenerator

__all__ = ["HiFiGANConfig", "HiFiGANGenerator"]
