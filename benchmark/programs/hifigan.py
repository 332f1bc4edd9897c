"""The program's HiFi-GAN generator from a configuration's ``vocoder``
section."""

from benchmark.program import tuples


def build(config: dict):
    from dex_tts_tpu_torch.models.vocoder import HiFiGANConfig, HiFiGANGenerator

    return HiFiGANGenerator(HiFiGANConfig(**{k: tuples(v) for k, v in config["vocoder"].items()}))
