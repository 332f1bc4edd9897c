"""Torch modules of the port, one file per module of dex_tts_tpu/models."""
