from dex_tts_tpu_torch.eval.evaluation import (
    gt_wav_path,
    load_synthesizer,
    load_vocoder,
    run_objective_eval,
)
from dex_tts_tpu_torch.eval.metric import (
    ASRScorer,
    SpeakerScorer,
    cer,
    mean_and_stderr,
    mel_cepstral_distortion,
    mel_mae,
    wer,
)

__all__ = ["load_synthesizer", "load_vocoder", "gt_wav_path", "run_objective_eval", "ASRScorer",
           "SpeakerScorer", "mel_mae", "mel_cepstral_distortion", "wer", "cer",
           "mean_and_stderr"]
