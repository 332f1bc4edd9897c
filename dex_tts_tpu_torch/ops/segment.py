"""Random fixed-size segment cut (port of dex_tts_tpu/ops/segment.py).

reference: DEX-TTS/model/tts.py:116-140. Offsets are drawn per item on the
tensors' device; the cut is one gather, so shapes stay fixed and nothing
comes to the host.
"""

from __future__ import annotations

import torch

from dex_tts_tpu_torch.ops.masks import sequence_mask
from dex_tts_tpu_torch.parallel import collectives


def random_segment(y, attn, y_lengths, out_size: int, generator=None, u=None):
    """Cut a random ``out_size``-frame window from mel + alignment.

    y (B, n_feats, Ty), attn (B, Tx, Ty), y_lengths (B,). The offset is
    floor(u · max(len - out_size, 1)), capped at len - out_size, with
    ``u`` (B,) uniform in [0, 1) drawn from ``generator`` unless given (the
    global batch's draw when data-parallel).
    Returns (y_cut (B, n_feats, out_size), attn_cut (B, Tx, out_size),
    y_cut_lengths (B,), y_cut_mask (B, 1, out_size))."""
    b = y.shape[0]
    max_offset = torch.clamp(y_lengths - out_size, min=0)
    if u is None:
        u = collectives.rand((b,), generator=generator, device=y.device)
    offset = torch.floor(u * torch.clamp(max_offset, min=1).to(u.dtype)).to(y_lengths.dtype)
    offset = torch.minimum(offset, max_offset)
    idx = offset[:, None] + torch.arange(out_size, device=y.device, dtype=offset.dtype)

    def cut(arr):
        return torch.gather(arr, 2, idx[:, None, :].expand(-1, arr.shape[1], -1).long())

    y_cut_lengths = torch.clamp(y_lengths, max=out_size)
    y_cut_mask = sequence_mask(y_cut_lengths, out_size)[:, None, :].to(y.dtype)
    return cut(y) * y_cut_mask, cut(attn) * y_cut_mask, y_cut_lengths, y_cut_mask
