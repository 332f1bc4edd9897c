from dex_tts_tpu_torch.preprocess.filelists import make_filelist
from dex_tts_tpu_torch.preprocess.preprocessor import PreprocessConfig, Preprocessor, prepare_align

__all__ = ["PreprocessConfig", "Preprocessor", "prepare_align", "make_filelist"]
