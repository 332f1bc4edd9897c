"""PyTorch/CUDA port of DEX-TTS synthesis.

Mirrors the module layout of the JAX package (`dex_tts_tpu`), which stays
the numerical reference. This package imports torch, numpy and scipy only;
its one hand-written kernel (the DiT's flash attention) lives in `csrc/`
and is built for Hopper (sm_90a) at first use.

Device policy: entry points default to ``device="cuda"`` and raise when
CUDA is missing, unless the caller asks for ``"cpu"`` explicitly.
"""
