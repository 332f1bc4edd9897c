"""The program's DeX-TTS / GeDEX-TTS (`dex_tts_tpu_torch.models.tts`) from
a configuration's ``tts`` and ``dit`` sections."""

from benchmark.program import tuples


def build(config: dict):
    from dex_tts_tpu_torch.models.dit import DiTConfig
    from dex_tts_tpu_torch.models.tts import TTSConfig, build_tts

    tts = {k: tuples(v) for k, v in config["tts"].items()}
    return build_tts(TTSConfig(**tts, dit=DiTConfig(**config["dit"])))
