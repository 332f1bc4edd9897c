"""Port vs JAX package: the DiT variants, the time position embedding
``pos_embed_time="conv1d"`` and the decoder (``use_decoder``), alone and
together, on the einsum and flash routes (the plain version on the CPU),
in eval and in train mode; the variant denoiser and `synthesize` with the
variables carried over by the port's converter; the conversion, the
strict loading and the tensor-parallel rules of the variants."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dex_tts_tpu.convert import _dit as jax_torch_to_flax_dit  # noqa: E402
from dex_tts_tpu.convert import dex_tts_torch_to_flax  # noqa: E402
from dex_tts_tpu.models import dit as jdit  # noqa: E402
from dex_tts_tpu.models.edm import SamplerConfig as JaxSamplerConfig  # noqa: E402
from dex_tts_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from dex_tts_tpu.parallel import tp_state_shardings  # noqa: E402
from dex_tts_tpu_torch import parallel  # noqa: E402
from dex_tts_tpu_torch.convert import _dit, dex_tts_flax_to_torch, load_numpy_state  # noqa: E402
from dex_tts_tpu_torch.models import dit as pdit  # noqa: E402
from dex_tts_tpu_torch.models.edm import SamplerConfig  # noqa: E402
from dex_tts_tpu_torch.models.tts import build_tts  # noqa: E402
from dex_tts_tpu_torch.parallel.tp import partition  # noqa: E402
from tests import torch_parallel_ranks as ranks  # noqa: E402
from tests.test_torch_denoiser import DIT, _denoiser_inputs, _run_both  # noqa: E402
from tests.torch_port_util import jax_model, perturb, style_inputs, t, tiny_cfg  # noqa: E402

VARIANTS = {
    "conv1d": dict(pos_embed_time="conv1d"),
    "decoder": dict(use_decoder=True),
    "both": dict(pos_embed_time="conv1d", use_decoder=True),
}
ATOL, RTOL = 1e-4, 1e-3  # f32, as the conv2d DiT's own test (test_torch_denoiser.py)
BF16_REL = 0.05  # × max|out|: both sides round every layer to bf16 in different places


def _inputs(seed=0, b=2, h=6, w=23):
    """(B, H, W, C) features, (B, W) mask, (B,) noise levels; W not a
    multiple of the patch, so the pad and the crop run."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, 16)).astype(np.float32)
    mask = (np.arange(w)[None] < np.asarray([w, 15])[:, None]).astype(np.float32)
    return x, mask, rng.uniform(-1.5, 1.0, b).astype(np.float32)


def _port_args(x, mask, tt):
    return t(x.transpose(0, 3, 1, 2)), t(mask[:, None, None, :]), t(tt)


@functools.cache
def _jax_params(variant: str):
    """Perturbed JAX DiT variables of a variant (the parameter tree does
    not depend on the attention route, the mode or the dtype)."""
    cfg = jdit.DiTConfig(**DIT, **VARIANTS[variant])
    x, mask, tt = _inputs()
    params = jdit.DiT(cfg).init(jax.random.PRNGKey(0), jnp.asarray(x),
                                jnp.asarray(mask[:, None, :, None]), jnp.asarray(tt))
    return perturb(jax.tree_util.tree_map(np.asarray, dict(params)))


def _port_dit(cfg: dict, params) -> pdit.DiT:
    state = {}
    _dit(state, params["params"], "vit", cfg["depth"], use_decoder=cfg.get("use_decoder", False))
    port = pdit.DiT(pdit.DiTConfig(**cfg))
    load_numpy_state(port, {k[len("vit."):]: v for k, v in state.items()})
    return port


def _both(variant, dtype="float32", train=False, seed=0, **cfg):
    cfg = dict(DIT, **VARIANTS[variant], dtype=dtype, **cfg)
    params = _jax_params(variant)
    x, mask, tt = _inputs(seed)
    want = jdit.DiT(jdit.DiTConfig(**cfg)).apply(
        params, jnp.asarray(x), jnp.asarray(mask[:, None, :, None]), jnp.asarray(tt),
        train=train, mask_ratio=0.0)
    with torch.no_grad():
        got = _port_dit(cfg, params)(*_port_args(x, mask, tt), train=train, mask_ratio=0.0)
    return got.float().numpy().transpose(0, 2, 3, 1), np.asarray(want, np.float32)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("attention", ["einsum", "flash"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_dit_variant_matches_jax(variant, attention, train):
    got, want = _both(variant, attention=attention, train=train)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_dit_variants_bf16_match_jax():
    """Both variants at the bf16 compute dtype, attention "flash_bf16"."""
    got, want = _both("both", dtype="bfloat16", attention="flash_bf16", seed=1)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=BF16_REL * np.abs(want).max(), rtol=0)


def test_decoder_runs_over_the_whole_sequence_in_train_mode_with_a_mask():
    """With masked tokens the decoder sees all of them (the masked ones
    put back as zeros): its attention takes the full token count."""
    cfg = pdit.DiTConfig(**DIT, use_decoder=True)
    port = _port_dit(dataclasses.asdict(cfg), _jax_params("decoder"))
    x, mask, tt = _inputs()
    seen = []
    for blk in port.decoder_blocks:
        blk.attn.register_forward_hook(lambda m, args, out: seen.append(args[0].shape[1]))
    enc_seen = []
    port.blocks[0].attn.register_forward_hook(lambda m, args, out: enc_seen.append(args[0].shape[1]))
    from dex_tts_tpu_torch.models.layers import dropout_generator

    with torch.no_grad(), dropout_generator(torch.Generator().manual_seed(0)):
        out = port(*_port_args(x, mask, tt), train=True, mask_ratio=0.5)
    n = pdit.token_count(cfg, x.shape[2])
    assert seen == [n] * cfg.depth and enc_seen == [int(n * 0.5)]
    assert torch.isfinite(out).all()


@pytest.fixture(scope="module")
def variant_pair():
    """(config, JAX model, its variables as numpy, the port model with the
    same weights) for a tiny DeX with both DiT variants: the port's init
    with every parameter and buffer moved by seeded noise, through JAX's
    reader and the port's converter back (no JAX init to compile). JAX's
    reader has no case for the conv1d time position: its flax kernel (k,
    in/groups, out) is put in by hand."""
    cfg = tiny_cfg(dit=dict(attention="auto", auto_flash_min_tokens=16, **VARIANTS["both"]))
    torch.manual_seed(0)
    port = build_tts(cfg)
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in port.state_dict().items():
        v = v.numpy()
        noise = rng.standard_normal(v.shape).astype(np.float32)
        if k.endswith("running_var"):
            v = np.abs(v + 0.05 * noise) + 0.5
        elif k.endswith(("vq.embedding", "vq.ema_weight")):
            v = noise
        elif v.dtype == np.float32:
            v = v + 0.05 * noise
        sd[k] = v
    vit = "decoder.denoise_fn.vit"
    weight, bias = sd.pop(f"{vit}.pos_conv1d.0.weight"), sd.pop(f"{vit}.pos_conv1d.0.bias")
    sd[f"{vit}.pos_conv.0.weight"] = np.zeros((1, 1, 1, 1), np.float32)  # read, then replaced
    model = jax_model(cfg)
    variables = jax.tree_util.tree_map(np.asarray, dex_tts_torch_to_flax(sd, model))
    variables["params"]["decoder"]["dit"]["time_pos"] = {
        "pos_conv1d": {"kernel": weight.transpose(2, 1, 0), "bias": bias}}
    load_numpy_state(port, dex_tts_flax_to_torch(variables, cfg))
    return cfg, model, variables, port


def test_variant_denoiser_matches_jax(variant_pair):
    cfg, _, variables, _ = variant_pair
    got, want = _run_both(cfg, variables, _denoiser_inputs())
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_variant_synthesize_matches_jax(variant_pair):
    """The tiny variant DeX's `synthesize` (2 euler steps, the DiT on the
    flash route) against JAX's with the same noise: the bounds of the
    conv2d model's own test (tests/test_torch_tts.py)."""
    cfg, model, variables, port = variant_pair
    rng = np.random.default_rng(0)
    b, tx, tr, y_max = 2, 9, 11, 32
    x = rng.integers(1, 30, (b, tx)).astype(np.int32)
    x_lengths = np.asarray([tx, 6], np.int32)
    x[1, 6:] = 0
    style = style_inputs(rng, b, tr, lengths=[tr, 8])
    noise = rng.standard_normal((b, cfg.n_feats, y_max)).astype(np.float32)
    assert pdit.resolve_attention_mode(
        cfg.dit_config(), pdit.token_count(cfg.dit_config(), y_max // 2)) == "flash_bf16"

    @jax.jit
    def run(variables, x, x_lengths, noise, style):
        return model.apply(
            variables, jax.random.PRNGKey(0), x, x_lengths, y_max_length=y_max,
            sampler=JaxSamplerConfig(num_steps=2), temperature=1.5,
            latents_noise=noise, method=type(model).synthesize, **style,
        )

    want = [np.asarray(a) for a in run(variables, jnp.asarray(x), jnp.asarray(x_lengths),
                                       jnp.asarray(noise),
                                       {k: jnp.asarray(v) for k, v in style.items()})]
    with torch.no_grad():
        got = port.synthesize(
            t(x, torch.long), t(x_lengths, torch.long), y_max_length=y_max,
            sampler=SamplerConfig(num_steps=2), temperature=1.5,
            latents_noise=t(noise), **{k: t(v) for k, v in style.items()},
        )
    got = [a.numpy() for a in got]
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[0], want[0], atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(got[1], want[1], atol=2e-3, rtol=1e-2)


def test_pos_conv1d_converts_to_the_torch_conv_layout():
    """flax (k, in/groups, out) → the port's Conv1d (out, in/groups, k),
    under its own name: nothing else maps there."""
    params = _jax_params("conv1d")["params"]
    state = {}
    _dit(state, params, "vit", DIT["depth"])
    kernel = params["time_pos"]["pos_conv1d"]["kernel"]
    assert kernel.shape == (DIT["conv_pos"], 32 // DIT["conv_pos_groups"], 32)
    np.testing.assert_array_equal(state["vit.pos_conv1d.0.weight"], kernel.transpose(2, 1, 0))
    assert not any(k.startswith("vit.pos_conv.") for k in state)


def test_decoder_state_round_trips_through_the_jax_converter():
    """The port's decoder DiT state dict → JAX's torch→flax `_dit` → the
    port's flax→torch `_dit`: the same tensors under the same names."""
    torch.manual_seed(0)
    port = pdit.DiT(pdit.DiTConfig(**DIT, use_decoder=True))
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    tree = jax_torch_to_flax_dit({f"vit.{k}": v for k, v in sd.items()}, "vit", DIT["depth"],
                                 use_decoder=True)
    back = {}
    _dit(back, tree, "vit", DIT["depth"], use_decoder=True)
    assert sorted(back) == sorted(f"vit.{k}" for k in sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[f"vit.{k}"], v)


def test_conv2d_state_dict_does_not_load_into_a_conv1d_dit():
    """Different math under a different name: a conv2d model's weights fail
    a strict load, as JAX's distinct ``pos_conv1d`` makes its tree fail."""
    conv2d = pdit.DiT(pdit.DiTConfig(**DIT))
    conv1d = pdit.DiT(pdit.DiTConfig(**DIT, pos_embed_time="conv1d"))
    with pytest.raises(RuntimeError, match="pos_conv1d.0.weight"):
        conv1d.load_state_dict(conv2d.state_dict(), strict=True)
    with pytest.raises(RuntimeError, match="pos_conv.0.weight"):
        conv2d.load_state_dict(conv1d.state_dict(), strict=True)


def test_unknown_pos_embed_time_raises_as_jax_does():
    x, mask, tt = _inputs()
    with pytest.raises(ValueError, match="'conv3d'"):
        jdit.DiT(jdit.DiTConfig(**DIT, pos_embed_time="conv3d")).init(
            jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask[:, None, :, None]),
            jnp.asarray(tt))
    with pytest.raises(ValueError, match="'conv3d'"):
        pdit.DiT(pdit.DiTConfig(**DIT, pos_embed_time="conv3d"))


def test_tp_rules_shard_the_decoder_blocks_as_jax_does():
    """At tp 2 the decoder blocks' qkv / fc1 (column) and proj / fc2 (row)
    are split, the token position conv stays replicated, and the split
    parameters are those JAX's `tp_state_shardings` splits."""
    torch.manual_seed(0)
    port = pdit.DiT(pdit.DiTConfig(**DIT, use_decoder=True))
    kinds = {name: partition(name, mod, 2) for name, mod in port.named_modules()}
    for i in range(DIT["depth"]):
        base = f"decoder_blocks.{i}"
        assert kinds[f"{base}.attn.qkv"] == kinds[f"{base}.mlp.fc1"] == "column"
        assert kinds[f"{base}.attn.proj"] == kinds[f"{base}.mlp.fc2"] == "row"
    assert kinds["decoder_pos_conv.0"] is None
    got = set()
    for name, kind in kinds.items():
        if kind:
            got.add(f"{name}.weight")
            if kind == "column":
                got.add(f"{name}.bias")
    sd = {f"vit.{k}": v.numpy() for k, v in port.state_dict().items()}
    tree = jax_torch_to_flax_dit(sd, "vit", DIT["depth"], use_decoder=True)
    shardings = tp_state_shardings(tree, jax_make_mesh(2, tp_size=2))
    markers = jax.tree_util.tree_map(
        lambda v, s: np.full(np.shape(v), float(s.spec != jax.sharding.PartitionSpec()),
                             np.float32), tree, shardings)
    named = {}
    _dit(named, markers, "vit", DIT["depth"], use_decoder=True)
    want = {k[len("vit."):] for k, v in named.items() if (v == 1).all()}
    assert got == want and any(k.startswith("decoder_blocks.") for k in got)


def test_tp2_decoder_dit_matches_one_process_and_gathers_back():
    """Two gloo ranks at dp1×tp2: the sharded decoder DiT computes the
    one-process output, and `full_state_dict` gives back the one-process
    state dict."""
    cfg = pdit.DiTConfig(**DIT, use_decoder=True, pos_embed_time="conv1d")
    port = _port_dit(dataclasses.asdict(cfg), _jax_params("both"))
    x, mask, tt = _inputs()
    with torch.no_grad():
        want = port(*_port_args(x, mask, tt)).numpy()
    inputs = {"x": x.transpose(0, 3, 1, 2).copy(), "mask": mask[:, None, None, :].copy(),
              "t": tt}
    sd = {k: v.clone() for k, v in port.state_dict().items()}
    got = parallel.launch(ranks.dit_tp_round_trip, 2, args=(cfg, sd, inputs),
                          devices=["cpu"] * 2, timeout=240)
    for r in got:
        assert r["shard_count"] > 0
        np.testing.assert_allclose(r["out"], want, atol=1e-5, rtol=1e-5)
        assert sorted(r["state"]) == sorted(sd)
        for k, v in sd.items():
            np.testing.assert_array_equal(r["state"][k], v.numpy())
