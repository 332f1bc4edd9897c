from dex_tts_tpu_torch.eval.evaluation import load_synthesizer, load_vocoder

__all__ = ["load_synthesizer", "load_vocoder"]
