from dex_tts_tpu_torch.audio.mel import mel_filterbank
from dex_tts_tpu_torch.audio.stft import MelSpectrogram, stft_magnitude

__all__ = ["mel_filterbank", "MelSpectrogram", "stft_magnitude"]
