"""The plain HiFi-GAN V1 generator from a configuration's ``vocoder``
section."""

from benchmark.reference.vocoders import HiFiGAN


def build(config: dict) -> HiFiGAN:
    return HiFiGAN(config["vocoder"]).eval()
