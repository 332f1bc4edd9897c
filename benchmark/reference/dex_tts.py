"""The plain DeX-TTS / GeDEX-TTS (`benchmark.reference.model.TTS`) from a
configuration's ``tts`` and ``dit`` sections. It implements the keys of
`FIXED` at those values only and refuses any other: a configuration
that needs another names a reference module of its own."""

from benchmark.reference.model import TTS

FIXED = {"tts": {"enc_kernel": 3, "use_softmax": True, "use_decay": False},
         "dit": {"overlap": True, "pos_embed_time": "conv2d", "use_decoder": False}}


def build(config: dict) -> TTS:
    for name, fixed in FIXED.items():
        for key, want in fixed.items():
            if config[name].get(key, want) != want:
                raise ValueError(f"the reference implements {name}.{key} = {want!r} only")
    return TTS({**config["tts"], "dit": config["dit"]}).eval()
