"""PyTorch/CUDA port of DEX-TTS synthesis.

Mirrors the module layout of the JAX package (`dex_tts_tpu`), which stays
the numerical reference. This package imports torch, numpy and scipy only;
its hand-written kernels (the DiT's flash attention, BigVGAN's
anti-aliased snake) live in `csrc/` and are built for Hopper (sm_90a) at
first use.

Device policy: entry points default to ``device="cuda"`` and raise when
CUDA is missing, unless the caller asks for ``"cpu"`` explicitly.
"""
