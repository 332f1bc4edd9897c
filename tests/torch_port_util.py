"""Shared pieces of the port's parity tests (tests/test_torch_*.py): tiny
configs built once for both frameworks, JAX init with every parameter
perturbed, and the carry-over into the port through its own converter.

Every parameter is perturbed because the JAX package zero-initialises
adaLN_modulation, final_layer.linear, the prenet projection and the
Rezero gates: a fresh model would hide whole branches from a comparison.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dex_tts_tpu.models.dit import DiTConfig as JaxDiTConfig
from dex_tts_tpu.models.edm import SamplerConfig as JaxSamplerConfig
from dex_tts_tpu.models.tts import DeXTTS as JaxDeXTTS
from dex_tts_tpu.models.tts import GeDEXTTS as JaxGeDEXTTS
from dex_tts_tpu.models.vocoder import BigVGANConfig as JaxBigVGANConfig
from dex_tts_tpu.models.vocoder import BigVGANGenerator as JaxBigVGAN
from dex_tts_tpu_torch.convert import (
    bigvgan_flax_to_torch,
    dex_tts_flax_to_torch,
    load_numpy_state,
)
from dex_tts_tpu_torch.models.dit import DiTConfig
from dex_tts_tpu_torch.models.tts import TTSConfig, build_tts
from dex_tts_tpu_torch.models.vocoder import BigVGANConfig, BigVGANGenerator

N_FEATS = 12


def tiny_cfg(**overrides) -> TTSConfig:
    """A few layers at narrow widths; DiT hd = 16."""
    dit = dict(patch_size=3, stride_size=2, hidden_size=32, depth=2, num_heads=2,
               mlp_ratio=2.0, conv_pos=4, conv_pos_groups=2)
    dit.update(overrides.pop("dit", {}))
    base = dict(
        n_vocab=149, n_feats=N_FEATS, enc_channels=16, enc_filter_channels=24,
        enc_filter_channels_dp=10, enc_heads=2, enc_layers=2, dec_dim=8,
        dec_dim_mults=(1, 2), tv_c_h=10, tv_c_out=16, tv_c_out_g=14,
        tv_layers=2, tv_n_emb=8, lf0_c_h=8, lf0_c_out=16, lf0_c_out_g=14,
        lf0_layers=2, tiv_c_h=16, tiv_c_out=6, tiv_layers=2, use_style=True,
        dit=DiTConfig(**dit),
    )
    base.update(overrides)
    return TTSConfig(**base)


def jax_model(cfg: TTSConfig):
    """The JAX facade with the same fields as the port's config."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    use_style = fields.pop("use_style")
    fields["dit"] = JaxDiTConfig(**cfg.dit.__dict__)
    if not use_style:
        for k in [k for k in fields if k.split("_")[0] in ("tv", "lf0", "tiv")]:
            fields.pop(k)
        return JaxGeDEXTTS(**fields)
    return JaxDeXTTS(**fields)


def style_inputs(rng, b, t, lengths=None, n_feats=N_FEATS):
    """Numpy reference-style inputs (ref = sty, lf0) with lengths."""
    ref = (rng.standard_normal((b, n_feats, t)) * 0.5).astype(np.float32)
    lf0 = rng.standard_normal((b, t)).astype(np.float32)
    lens = np.asarray(lengths if lengths is not None else [t] * b, np.int32)
    return {"ref": ref, "ref_lengths": lens, "sty": ref, "sty_lengths": lens,
            "lf0": lf0, "lf0_lengths": lens}


def perturb(variables, seed=0, scale=0.05):
    """Every leaf moved by seeded noise; BN variances stay positive and
    the VQ codebook is spread out so nearest-code choices are far from
    ties."""
    rng = np.random.default_rng(seed)

    def walk(tree, path):
        if isinstance(tree, dict) or hasattr(tree, "items"):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        a = np.asarray(tree, np.float32)
        noise = rng.standard_normal(a.shape).astype(np.float32)
        if path[-1] == "var":
            return np.abs(a + scale * noise) + 0.5
        if path[-1] in ("embedding", "ema_weight") and path[0] == "vq_stats":
            return noise
        return a + scale * noise

    return walk(variables, ())


def build_pair(cfg: TTSConfig, seed=0, b=2, tx=9, t_ref=11):
    """(JAX model, perturbed JAX variables as numpy, port model on CPU
    with the same weights)."""
    model = jax_model(cfg)
    style = style_inputs(np.random.default_rng(seed), b, t_ref) if cfg.use_style else {}
    if cfg.n_spks > 1:
        style["spk"] = np.zeros((b,), np.int32)

    @jax.jit
    def init(style):
        # jitted: flax's eager init dispatches thousands of small ops
        return model.init(
            {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)},
            jax.random.PRNGKey(2),
            jnp.ones((b, tx), jnp.int32),
            jnp.full((b,), tx, jnp.int32),
            y_max_length=16,
            sampler=JaxSamplerConfig(num_steps=2),
            method=type(model).synthesize,
            **style,
        )

    variables = init({k: jnp.asarray(v) for k, v in style.items()})
    variables = perturb(jax.tree_util.tree_map(np.asarray, dict(variables)), seed)
    port = build_tts(cfg)
    load_numpy_state(port, dex_tts_flax_to_torch(variables, cfg))
    return model, variables, port


# rates (4, 2): hop 8
BIGVGAN_TINY = dict(num_mels=12, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                    upsample_initial_channel=32, resblock_kernel_sizes=(3, 5),
                    resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)))


def bigvgan_pair(seed=3, **overrides):
    """(JAX config, perturbed JAX params as numpy, port generator on the
    CPU with the same weights). Every parameter is perturbed, snake alpha
    and beta included, so the snakes shape the output."""
    jcfg = JaxBigVGANConfig(**BIGVGAN_TINY, **overrides)
    params = JaxBigVGAN(jcfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, jcfg.num_mels, 8)))
    params = perturb(jax.tree_util.tree_map(np.asarray, dict(params)), seed)["params"]
    port = BigVGANGenerator(BigVGANConfig(**BIGVGAN_TINY, **overrides)).eval()
    load_numpy_state(port, bigvgan_flax_to_torch(params, jcfg))
    return jcfg, params, port


def t(x, dtype=None):
    """numpy → torch (CPU)."""
    out = torch.from_numpy(np.ascontiguousarray(x))
    return out if dtype is None else out.to(dtype)
