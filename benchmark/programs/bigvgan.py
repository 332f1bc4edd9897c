"""The program's BigVGAN generator (its snake through the program's
kernel) from a configuration's ``vocoder`` section."""

from benchmark.program import tuples


def build(config: dict):
    from dex_tts_tpu_torch.models.vocoder import BigVGANConfig, BigVGANGenerator

    return BigVGANGenerator(BigVGANConfig(**{k: tuples(v) for k, v in config["vocoder"].items()}))
