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
from dex_tts_tpu_torch.ops import mas
from dex_tts_tpu_torch.models.dit import DiTConfig
from dex_tts_tpu_torch.models.tts import TTSConfig, build_tts
from dex_tts_tpu_torch.models.vocoder import BigVGANConfig, BigVGANGenerator

N_FEATS = 12

# the test run puts several worker processes on one machine: torch's
# default of one thread per core in each of them oversubscribes the CPU,
# and the tiny models' many small ops then wait on each other's threads
torch.set_num_threads(min(torch.get_num_threads(), 2))


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


def tf32_rna(x):
    """cvt.rna.tf32.f32 by bit arithmetic: the 13 low mantissa bits rounded
    off, to nearest with ties away from zero (sign and magnitude are apart
    in the bits, so adding half of the dropped unit rounds |x| up)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul_tf32(a, b, products):
    """a @ b as the kernel's m16n8k8 TF32 products accumulate it in f32:
    one product of the TF32-rounded operands, or three of their big and
    small parts (small·big, big·small, then big·big)."""
    a_big, b_big = tf32_rna(a), tf32_rna(b)
    if products == 1:
        return a_big @ b_big
    a_small, b_small = tf32_rna(a - a_big), tf32_rna(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def port_inputs(inputs: dict) -> dict:
    """numpy batch → CPU tensors (integer arrays as int64)."""
    return {k: t(v, torch.long) if v.dtype.kind == "i" else t(v) for k, v in inputs.items()}


def planted_batch(port, cfg: TTSConfig, b=2, tx=9, ty=32, out_size=16, spk=None, seed=0):
    """A compute_loss batch (numpy) whose mel follows the port encoder's
    mu_x along evenly spread durations plus small noise, so MAS is decisive
    (a near-tie could flip one step of the path between two orders of f32
    additions), and JAX's draws for key 5 as its compute_loss splits them
    (tts.py:261, edm.py:107-113). → (inputs, draws, key, planted path)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, 30, (b, tx)).astype(np.int32)
    x_lengths = np.asarray([tx] + [tx - 3] * (b - 1), np.int32)
    y_lengths = np.asarray([ty] + [ty - 11] * (b - 1), np.int32)
    for i in range(b):
        x[i, x_lengths[i]:] = 0
    extra = style_inputs(rng, b, 19, lengths=[19] + [12] * (b - 1)) if cfg.use_style else {}
    if spk is not None:
        extra["spk"] = np.asarray(spk, np.int32)
    with torch.no_grad():
        cond = port._cond_from_inputs(**port_inputs({k: v for k, v in extra.items() if k != "spk"}))
        mu_x, _, _ = port._encode(t(x, torch.long), t(x_lengths, torch.long),
                                  spk=t(extra["spk"], torch.long) if spk is not None else None,
                                  sty=cond.get("sty_enc"))
    path = np.zeros((b, tx, ty), np.float32)
    for i in range(b):
        ends = np.round(np.linspace(0, y_lengths[i], x_lengths[i] + 1)).astype(int)
        for j in range(x_lengths[i]):
            path[i, j, ends[j]:ends[j + 1]] = 1.0
    y = np.einsum("bxt,bxf->bft", path, mu_x.numpy()) + 0.05 * rng.standard_normal((b, cfg.n_feats, ty))
    y *= np.arange(ty)[None, None] < y_lengths[:, None, None]
    with torch.no_grad():  # the plain MAS recovers the planted path
        log_prior = -0.5 * ((t(y.astype(np.float32))[:, None] - mu_x[..., None]) ** 2).sum(2)
        assert torch.equal(mas.maximum_path(log_prior, t(path).amax(1, keepdim=True)
                                            * (t(x) > 0).float()[:, :, None]), t(path))
    key = jax.random.PRNGKey(5)
    k_seg, k_diff = jax.random.split(key)
    k_sigma, k_noise = jax.random.split(k_diff)
    draws = {"u": np.asarray(jax.random.uniform(k_seg, (b,))),
             "sigma": np.asarray(jax.random.normal(k_sigma, (b, 1, 1))),
             "noise": np.asarray(jax.random.normal(k_noise, (b, cfg.n_feats, out_size)))}
    inputs = dict(x=x, x_lengths=x_lengths, y=y.astype(np.float32), y_lengths=y_lengths, **extra)
    return inputs, draws, key, path


def loss_and_grads(model, variables, port, cfg, inputs, draws, key, out_size):
    """JAX value_and_grad of compute_loss (train=False; one compile) and
    the port's compute_loss + backward on the same inputs and draws →
    (JAX losses as floats, JAX grads as port-named arrays, port losses
    without the MAS guard's count);
    the port's grads are left in ``port``'s parameters."""
    others = jax.tree_util.tree_map(jnp.asarray, {k: v for k, v in variables.items()
                                                   if k != "params"})

    def loss_fn(params, inputs):
        losses = model.apply({"params": params, **others}, key, out_size=out_size, train=False,
                             method=type(model).compute_loss, **inputs)
        return sum(losses.values()), losses

    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], {k: jnp.asarray(v) for k, v in inputs.items()})
    want_grads = dex_tts_flax_to_torch(
        jax.tree_util.tree_map(np.asarray, {"params": grads, **others}), cfg)
    port.zero_grad(set_to_none=True)
    got = port.compute_loss(**port_inputs(inputs), out_size=out_size, train=False,
                            draws={k: t(v) for k, v in draws.items()})
    assert got.pop(mas.MAS_ERRORS).item() == 0
    sum(got.values()).backward()
    return {k: float(v) for k, v in want.items()}, want_grads, got


def assert_grads_match(port, want_grads, rel: float) -> int:
    """Per parameter |g − g_jax| ≤ rel × (max|g_jax| + 1e-3 × the model's
    largest gradient); the floor covers gradients that are 0 in exact
    arithmetic (biases in front of a GroupNorm). → parameters checked."""
    top = max(np.abs(v).max() for v in want_grads.values())
    n = 0
    for name, p in port.named_parameters():
        got = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
        want = want_grads[name]
        if "bias_hh" in name:
            # the converter folds the GRU's r/z hidden biases into bias_ih
            # (convert._gru): their gradients are bias_ih's, and 0 in the map
            h = want.shape[0] // 3
            ih = port.get_parameter(name.replace("bias_hh", "bias_ih")).grad.numpy()
            np.testing.assert_allclose(got[:2 * h], ih[:2 * h], rtol=1e-6, atol=1e-9)
            got, want = got[2 * h:], want[2 * h:]
        bound = rel * (np.abs(want).max() + 1e-3 * top)
        np.testing.assert_allclose(got, want, atol=bound, rtol=0, err_msg=name)
        n += 1
    return n
