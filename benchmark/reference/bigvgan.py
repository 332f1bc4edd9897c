"""The plain BigVGAN generator (alias-free snake with the exact sine) from
a configuration's ``vocoder`` section."""

from benchmark.reference.vocoders import BigVGAN


def build(config: dict) -> BigVGAN:
    return BigVGAN(config["vocoder"]).eval()
