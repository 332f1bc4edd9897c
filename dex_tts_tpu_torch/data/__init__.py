from dex_tts_tpu_torch.data.augmentation import augment_feature
from dex_tts_tpu_torch.data.dataset import BucketBatcher, TextMelDataset

__all__ = ["BucketBatcher", "TextMelDataset", "augment_feature"]
