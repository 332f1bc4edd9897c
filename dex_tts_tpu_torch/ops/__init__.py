from dex_tts_tpu_torch.ops.attention import attention_reference, flash_attention
from dex_tts_tpu_torch.ops.masks import (
    fix_len_compatibility,
    generate_path,
    sequence_mask,
)

__all__ = [
    "attention_reference",
    "fix_len_compatibility",
    "flash_attention",
    "generate_path",
    "sequence_mask",
]
