"""JAX-package variables → this port's torch state_dict, and the readers
of reference-format torch checkpoints.

A copy of the mapping in dex_tts_tpu/export.py (``dex_tts_flax_to_torch``,
``hifigan_flax_to_torch`` and ``bigvgan_flax_to_torch``; the vocoder
critics' ``discriminators_flax_to_torch`` has no JAX counterpart), which writes
the reference torch layout: the layout this port's modules use. Input:
the JAX variables (``params``, ``batch_stats``, ``vq_stats``) as nested
dicts of numpy arrays; output: a flat dict of numpy arrays that
``load_state_dict(strict=True)`` accepts (see `load_numpy_state`). The
``model`` argument only needs the facade's config attributes, so a
`TTSConfig` or a JAX facade both work. Vocoder weight norm is folded, as
the port's generators hold plain convs.

The readers at the end (`fold_weight_norm`, `load_torch_checkpoint`,
`load_torch_trainer_checkpoint`) are copies of dex_tts_tpu/convert.py's:
a reference `.pth` (or one of this port's checkpoints, which use the
reference trainer's layout) comes out as a flat {name: numpy array}
dict in the reference's parameter names, which are the port's.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return np.asarray(x)



# --- primitive layout maps (flax kernel → torch weight) ---


def _dense(out, p, name):
    out[f"{name}.weight"] = np.transpose(_np(p["kernel"]))
    if "bias" in p:
        out[f"{name}.bias"] = _np(p["bias"])


def _conv1d(out, p, name):
    out[f"{name}.weight"] = np.transpose(_np(p["kernel"]), (2, 1, 0))
    if "bias" in p:
        out[f"{name}.bias"] = _np(p["bias"])


_convT1d = _conv1d  # same layout both directions (transpose_kernel=True)


def _dense_to_conv1x1(out, p, name):
    out[f"{name}.weight"] = np.transpose(_np(p["kernel"]))[:, :, None]
    if "bias" in p:
        out[f"{name}.bias"] = _np(p["bias"])


def _conv2d(out, p, name):
    out[f"{name}.weight"] = np.transpose(_np(p["kernel"]), (3, 2, 0, 1))
    if "bias" in p:
        out[f"{name}.bias"] = _np(p["bias"])


def _convT2d(out, p, name):
    # flax (kh, kw, out, in) → torch (in, out, kh, kw)
    out[f"{name}.weight"] = np.transpose(_np(p["kernel"]), (3, 2, 0, 1))
    out[f"{name}.bias"] = _np(p["bias"])


def _channel_ln(out, p, name):
    out[f"{name}.gamma"] = _np(p["gamma"])
    out[f"{name}.beta"] = _np(p["beta"])


def _basic_conv(out, p, stats, name, norm=None):
    """Reference BasicConv (model/base.py:34-65; conv has no bias)."""
    out[f"{name}.conv.weight"] = np.transpose(
        _np(p["Conv1d_0"]["Conv_0"]["kernel"]), (2, 1, 0)
    )
    if norm == "bn":
        out[f"{name}.bn.weight"] = _np(p["BatchNorm_0"]["scale"])
        out[f"{name}.bn.bias"] = _np(p["BatchNorm_0"]["bias"])
        if not stats or "BatchNorm_0" not in stats:
            # refuse to fabricate identity running stats — a strict torch
            # load would succeed but eval-mode audio would silently degrade
            raise KeyError(
                f"missing BatchNorm running stats (batch_stats) for {name}"
            )
        bn = stats["BatchNorm_0"]
        out[f"{name}.bn.running_mean"] = _np(bn["mean"])
        out[f"{name}.bn.running_var"] = _np(bn["var"])
        out[f"{name}.bn.num_batches_tracked"] = np.asarray(0, np.int64)
    elif norm == "ln":
        out[f"{name}.ln.weight"] = _np(p["LayerNorm_0"]["scale"])
        out[f"{name}.ln.bias"] = _np(p["LayerNorm_0"]["bias"])


def _projection(out, p, name):
    _conv1d(out, p["conv_1"]["Conv_0"], f"{name}.conv_1")
    _channel_ln(out, p["norm_1"], f"{name}.norm_1")
    _conv1d(out, p["conv_2"]["Conv_0"], f"{name}.conv_2")
    _channel_ln(out, p["norm_2"], f"{name}.norm_2")
    _dense_to_conv1x1(out, p["proj"], f"{name}.proj")


def _gru(out, p, name, num_layers):
    """Flax GRU cells → torch nn.GRU. Flax folds torch's r/z
    hidden-side biases into the input-side ones (identical math), so the
    inverse puts the combined bias on bias_ih and zeros on bias_hh's r/z
    slots — numerically identical to the original torch GRU."""
    for layer in range(num_layers):
        for direction, tag in (("", "fwd"), ("_reverse", "bwd")):
            cell = p[f"{tag}_{layer}"]
            w_ih = np.concatenate(
                [np.transpose(_np(cell[g]["kernel"])) for g in ("ir", "iz", "in")]
            )
            w_hh = np.concatenate(
                [np.transpose(_np(cell[g]["kernel"])) for g in ("hr", "hz", "hn")]
            )
            h = _np(cell["hr"]["kernel"]).shape[0]
            zeros = np.zeros(h, np.float32)
            b_ih = np.concatenate(
                [_np(cell["ir"]["bias"]), _np(cell["iz"]["bias"]),
                 _np(cell["in"]["bias"])]
            )
            b_hh = np.concatenate([zeros, zeros, _np(cell["hn"]["bias"])])
            base = f"{name}.weight_ih_l{layer}{direction}"
            out[base] = w_ih
            out[f"{name}.weight_hh_l{layer}{direction}"] = w_hh
            out[f"{name}.bias_ih_l{layer}{direction}"] = b_ih
            out[f"{name}.bias_hh_l{layer}{direction}"] = b_hh


def _res_conv_block(out, p, stats, name, norm):
    _basic_conv(out, p["conv1"], (stats or {}).get("conv1"),
                f"{name}.conv_block.0", norm)
    _basic_conv(out, p["conv2"], None, f"{name}.conv_block.1", None)


def _unet_resnet(out, p, name):
    _dense(out, p["mlp"], f"{name}.mlp.1")
    for blk in ("block1", "block2"):
        _conv2d(out, p[blk]["Conv_0"], f"{name}.{blk}.block.0")
        out[f"{name}.{blk}.block.1.weight"] = _np(p[blk]["GroupNorm_0"]["scale"])
        out[f"{name}.{blk}.block.1.bias"] = _np(p[blk]["GroupNorm_0"]["bias"])
    if "res_conv" in p:
        _conv2d(out, p["res_conv"], f"{name}.res_conv")


def _unet_attn(out, p, name):
    # re-fuse the q/k/v dense kernels into the reference's to_qkv 1x1 conv
    # weight, out-channel order [q; k; v] (reference diffusion.py:88)
    fn = p["fn"]
    w = np.concatenate(
        [np.transpose(_np(fn[f"to_{g}"]["kernel"])) for g in ("q", "k", "v")]
    )
    out[f"{name}.fn.fn.to_qkv.weight"] = w[:, :, None, None]
    _conv2d(out, fn["to_out"], f"{name}.fn.fn.to_out")
    out[f"{name}.fn.g"] = _np(p["g"])


def _dit(out, p, prefix, depth, use_decoder=False):
    _conv2d(out, p["x_embedder"]["dw_conv"], f"{prefix}.x_embedder.proj.0")
    _conv2d(out, p["x_embedder"]["pw_conv"], f"{prefix}.x_embedder.proj.2")
    _dense(out, p["t_embedder"]["fc1"], f"{prefix}.t_embedder.mlp.0")
    _dense(out, p["t_embedder"]["fc2"], f"{prefix}.t_embedder.mlp.2")
    if "pos_conv1d" in p["time_pos"]:
        # pos_embed_time="conv1d": no reference layout (the JAX export has no
        # such case); the port's Conv1d in the same (out, in/groups, k) layout
        _conv1d(out, p["time_pos"]["pos_conv1d"], f"{prefix}.pos_conv1d.0")
    else:
        _conv2d(out, p["time_pos"]["pos_conv"], f"{prefix}.pos_conv.0")
    out[f"{prefix}.freq_new_pos_embed"] = np.transpose(
        _np(p["freq_pos_embed"]), (0, 3, 1, 2)
    )
    _dense(out, p["final_layer"]["adaLN_modulation"],
           f"{prefix}.final_layer.adaLN_modulation.1")
    _dense(out, p["final_layer"]["linear"], f"{prefix}.final_layer.linear")

    def blocks(tree_key, torch_list):
        for i in range(depth):
            blk = p[f"{tree_key}{i}"]
            base = f"{prefix}.{torch_list}.{i}"
            _dense(out, blk["attn"]["qkv"], f"{base}.attn.qkv")
            _dense(out, blk["attn"]["proj"], f"{base}.attn.proj")
            _dense(out, blk["mlp_fc1"], f"{base}.mlp.fc1")
            _dense(out, blk["mlp_fc2"], f"{base}.mlp.fc2")
            _dense(out, blk["adaLN_modulation"], f"{base}.adaLN_modulation.1")

    blocks("block_", "blocks")
    if use_decoder:
        _conv1d(out, p["decoder_pos_conv"]["pos_conv"],
                f"{prefix}.decoder_pos_conv.0")
        blocks("decoder_block_", "decoder_blocks")


# ---------------------------------------------------------------------------


def denoiser_flax_to_torch(
    dec: dict,
    out: dict,
    prefix: str = "decoder.denoise_fn",
    n_res: int = 2,
    dit_depth: int = 4,
    use_style: bool = True,
    n_spks: int = 1,
    dit_use_decoder: bool = False,
) -> None:
    """The denoiser's part of `dex_tts_flax_to_torch`."""
    d = prefix
    _dense(out, dec["time_fc1"], f"{d}.mlp.0")
    _dense(out, dec["time_fc2"], f"{d}.mlp.2")
    _conv2d(out, dec["final_block"]["Conv_0"], f"{d}.final_block.block.0")
    out[f"{d}.final_block.block.1.weight"] = _np(
        dec["final_block"]["GroupNorm_0"]["scale"]
    )
    out[f"{d}.final_block.block.1.bias"] = _np(
        dec["final_block"]["GroupNorm_0"]["bias"]
    )
    _conv2d(out, dec["final_conv"], f"{d}.final_conv")

    if use_style:
        _dense(out, dec["adap_fc1"], f"{d}.mlp_adap.0")
        _dense(out, dec["adap_fc2"], f"{d}.mlp_adap.2")
        _dense(out, dec["adap_sty_fc1"], f"{d}.mlp_adap_sty.0")
        _dense(out, dec["adap_sty_fc2"], f"{d}.mlp_adap_sty.2")
        for name in ("w_q", "w_k", "w_v", "linear"):
            _dense(out, dec["tv_adaptor"][name], f"{d}.tv_adaptor.{name}")
        _dense(out, dec["tiv_adaptor"]["mean_sap"]["W"],
               f"{d}.tiv_adaptor.mean_sap.W")
        _dense(out, dec["tiv_adaptor"]["std_sap"]["W"],
               f"{d}.tiv_adaptor.std_sap.W")
    elif n_spks > 1:
        _dense(out, dec["spk_fc1"], f"{d}.spk_mlp.0")
        _dense(out, dec["spk_fc2"], f"{d}.spk_mlp.2")

    for i in range(n_res):
        _unet_resnet(out, dec[f"down_{i}_res1"], f"{d}.downs.{i}.0")
        _unet_resnet(out, dec[f"down_{i}_res2"], f"{d}.downs.{i}.1")
        _unet_attn(out, dec[f"down_{i}_attn"], f"{d}.downs.{i}.2")
        if i < n_res - 1:
            _conv2d(out, dec[f"down_{i}_downsample"]["Conv_0"],
                    f"{d}.downs.{i}.3.conv")
    for j in range(n_res - 1):
        _unet_resnet(out, dec[f"up_{j}_res1"], f"{d}.ups.{j}.0")
        _unet_resnet(out, dec[f"up_{j}_res2"], f"{d}.ups.{j}.1")
        _unet_attn(out, dec[f"up_{j}_attn"], f"{d}.ups.{j}.2")
        _convT2d(out, dec[f"up_{j}_upsample"]["ConvTranspose_0"],
                 f"{d}.ups.{j}.3.conv")
    _dit(out, dec["dit"], f"{d}.vit", dit_depth, use_decoder=dit_use_decoder)


def retnet_flax_to_torch(retnet: dict, out: dict, prefix: str, num_layers: int,
                        use_adaln: bool) -> None:
    """A JAX `RetNetEncoder`'s params → the port's `RetNetEncoder` under
    ``prefix`` (the text encoder's is ``encoder.encoder``)."""
    out[f"{prefix}.layer_norm.weight"] = _np(retnet["norm"]["weight"])
    for i in range(num_layers):
        base = f"{prefix}.layers.{i}"
        layer = retnet[f"layer_{i}"]
        out[f"{base}.retention_layer_norm.weight"] = _np(
            layer["retention_norm"]["weight"]
        )
        out[f"{base}.final_layer_norm.weight"] = _np(
            layer["final_norm"]["weight"]
        )
        for p_name in ("q", "k", "v", "g", "out"):
            _dense(out, layer["retention"][f"{p_name}_proj"],
                   f"{base}.retention.{p_name}_proj")
        for f_name in ("gate", "fc1", "fc2"):
            _dense(out, layer["ffn"][f_name], f"{base}.ffn.{f_name}")
        if use_adaln:
            for a in ("adaln_1", "adaln_2"):
                _dense(out, layer[a]["W_scale"], f"{base}.{a}.W_scale")
                _dense(out, layer[a]["W_bias"], f"{base}.{a}.W_bias")


def dex_tts_flax_to_torch(variables: dict, model) -> dict:
    """Flax variables {params[, batch_stats, vq_stats]} of a DeXTTS/GeDEXTTS
    facade → flat reference-named torch state_dict (numpy arrays).

    The dict loads strictly into this port's DeXTTS / GeDEXTTS.
    """
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {}) or {}
    vq_stats = variables.get("vq_stats", {}) or {}
    use_style = getattr(model, "use_style", False)
    out: dict = {}

    # ---- text encoder ----
    enc = params["encoder"]
    out["encoder.emb.weight"] = _np(enc["emb"]["embedding"])
    _dense_to_conv1x1(out, enc["prenet"]["proj"], "encoder.prenet.proj")
    for i in range(3):
        _conv1d(out, enc["prenet"][f"conv_{i}"]["Conv_0"],
                f"encoder.prenet.conv_layers.{i}")
        _channel_ln(out, enc["prenet"][f"norm_{i}"],
                    f"encoder.prenet.norm_layers.{i}")

    retnet_flax_to_torch(enc["encoder"], out, "encoder.encoder", model.enc_layers, use_style)
    _dense_to_conv1x1(out, enc["proj_m"], "encoder.proj_m")
    _projection(out, enc["proj_w"], "encoder.proj_w")

    if "spk_emb" in params:
        out["spk_emb.weight"] = _np(params["spk_emb"]["embedding"])

    # ---- style encoders (DEX) ----
    if use_style:
        _dense_to_conv1x1(out, params["conv_sty"], "conv_sty")

        tv = params["tv_encoder"]
        tv_stats = batch_stats.get("tv_encoder", {})
        _basic_conv(out, tv["in_conv"], None, "tv_encoder.in_conv", "ln")
        for i in range(model.tv_layers):
            _res_conv_block(out, tv[f"block_{i}"], None,
                            f"tv_encoder.conv_blocks.{i}", "ln")
        _basic_conv(out, tv["out_conv"], None, "tv_encoder.out_conv", None)
        _projection(out, tv["proj_0"], "tv_encoder.proj_0")
        _basic_conv(out, tv["proj_1"], tv_stats.get("proj_1"),
                    "tv_encoder.proj_1", "bn")
        vq = vq_stats["tv_encoder"]["vq"]
        out["tv_encoder.vq.embedding"] = _np(vq["embedding"])
        out["tv_encoder.vq.ema_count"] = _np(vq["ema_count"])
        out["tv_encoder.vq.ema_weight"] = _np(vq["ema_weight"])

        tiv = params["tiv_encoder"]
        tiv_stats = batch_stats.get("tiv_encoder", {})
        _basic_conv(out, tiv["in_conv"], tiv_stats.get("in_conv"),
                    "tiv_encoder.in_conv", "bn")
        for i in range(model.tiv_layers):
            _res_conv_block(out, tiv[f"block_{i}"],
                            tiv_stats.get(f"block_{i}"),
                            f"tiv_encoder.conv_blocks.{i}", "bn")
        _basic_conv(out, tiv["out_conv"], tiv_stats.get("out_conv"),
                    "tiv_encoder.out_conv", "bn")

        lf0 = params["lf0_encoder"]
        _basic_conv(out, lf0["in_conv"], None, "lf0_encoder.in_conv", "ln")
        _basic_conv(out, lf0["out_conv"], None, "lf0_encoder.out_conv", "ln")
        _gru(out, lf0["rnn"], "lf0_encoder.rnn_layer", model.lf0_layers)
        _projection(out, lf0["proj"], "lf0_encoder.proj")

    # ---- denoiser ----
    denoiser_flax_to_torch(
        params["decoder"],
        out,
        prefix="decoder.denoise_fn",
        n_res=len(model.dec_dim_mults),
        dit_depth=(model.dit.depth if model.dit is not None else 4),
        use_style=use_style,
        n_spks=getattr(model, "n_spks", 1),
        dit_use_decoder=(
            model.dit.use_decoder if model.dit is not None else False
        ),
    )
    return out


# ---------------------------------------------------------------------------
# Vocoder generator


def hifigan_flax_to_torch(params: dict, cfg) -> dict:
    """HiFiGANGenerator flax params → the port's generator state_dict
    (plain convs, weight norm folded)."""
    out: dict = {}
    _conv1d(out, params["conv_pre"], "conv_pre")
    _conv1d(out, params["conv_post"], "conv_post")
    n_kernels = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        _convT1d(out, params[f"up_{i}"], f"ups.{i}")
        for j in range(n_kernels):
            idx = i * n_kernels + j
            block = params[f"resblock_{i}_{j}"]
            for m in range(len(cfg.resblock_dilation_sizes[j])):
                _conv1d(out, block[f"conv1_{m}"], f"resblocks.{idx}.convs1.{m}")
                _conv1d(out, block[f"conv2_{m}"], f"resblocks.{idx}.convs2.{m}")
    return out


def bigvgan_flax_to_torch(params: dict, cfg) -> dict:
    """BigVGANGenerator flax params → the port's generator state_dict
    (reference names, bigvgan/models.py:140-218: upsamplers at
    ``ups.{i}.0``, snake parameters at
    ``resblocks.{m}.activations.{j}.act.{alpha,beta}``; plain convs)."""
    out: dict = {}
    _conv1d(out, params["conv_pre"], "conv_pre")
    _conv1d(out, params["conv_post"], "conv_post")

    def snake(p, prefix):
        out[f"{prefix}.alpha"] = _np(p["alpha"])
        if "beta" in p:
            out[f"{prefix}.beta"] = _np(p["beta"])

    snake(params["act_post"], "activation_post.act")
    n_kernels = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        _convT1d(out, params[f"up_{i}"], f"ups.{i}.0")
        for j in range(n_kernels):
            m = i * n_kernels + j
            block = params[f"resblock_{i}_{j}"]
            n_dil = len(cfg.resblock_dilation_sizes[j])
            if cfg.resblock == "1":
                for d in range(n_dil):
                    _conv1d(out, block[f"conv1_{d}"], f"resblocks.{m}.convs1.{d}")
                    _conv1d(out, block[f"conv2_{d}"], f"resblocks.{m}.convs2.{d}")
                    snake(block[f"act1_{d}"], f"resblocks.{m}.activations.{2 * d}.act")
                    snake(block[f"act2_{d}"], f"resblocks.{m}.activations.{2 * d + 1}.act")
            else:
                for d in range(min(n_dil, 2)):
                    _conv1d(out, block[f"conv_{d}"], f"resblocks.{m}.convs.{d}")
                    snake(block[f"act_{d}"], f"resblocks.{m}.activations.{d}.act")
    return out


def discriminators_flax_to_torch(params: dict, cfg) -> dict:
    """The vocoder critics' flax params {"mpd": ..., "mrd": ...} → the state
    dict of ``nn.ModuleDict(mpd=MultiPeriodDiscriminator(cfg),
    mrd=MultiResolutionDiscriminator(cfg))`` (`train.vocoder`'s
    ``critics``): flax HWIO kernels as OIHW, names kept
    (``mpd.p{period}.conv_{i}``, ``mrd.r{i}.conv_{i}``, ``conv_post``)."""
    out: dict = {}
    subs = [("mpd", f"p{p}") for p in cfg.mpd_periods]
    subs += [("mrd", f"r{i}") for i in range(len(cfg.mrd_resolutions))]
    for critic, sub in subs:  # every sub-critic: conv_0 … conv_4, conv_post
        for name in [f"conv_{i}" for i in range(5)] + ["conv_post"]:
            _conv2d(out, params[critic][sub][name], f"{critic}.{sub}.{name}")
    return out


def load_numpy_state(module: torch.nn.Module, state: dict) -> None:
    """Load a flat numpy state dict strictly into ``module``."""
    module.load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()},
        strict=True,
    )


# ---------------------------------------------------------------------------
# Reference-format torch checkpoints


def fold_weight_norm(state: dict) -> dict:
    """Fold weight_norm (weight_g, weight_v) pairs into plain weights —
    what the reference's remove_weight_norm() does at load
    (reference: DEX-TTS/hifigan/models.py:166-173). On numpy in float64,
    cast to float32, as the JAX package folds."""
    out = {}
    for key, value in state.items():
        if key.endswith("weight_g"):
            continue
        if key.endswith("weight_v"):
            base = key[: -len("_v")]
            g = np.asarray(state[base + "_g"], np.float64)
            v = np.asarray(value, np.float64)
            axes = tuple(range(1, v.ndim))
            norm = np.sqrt(np.sum(v**2, axis=axes, keepdims=True))
            out[base] = (g * v / norm).astype(np.float32)
        else:
            out[key] = np.asarray(value)
    return out


def load_torch_checkpoint(path: str, key: str | None = None) -> dict:
    """Load a .pth/.pth.tar/.pth.tar.zip file into a {name: np.ndarray} dict.

    Handles the distribution formats the reference points users at
    (reference: DEX-TTS/src/utils.py:251-281): a torch-serialized file
    (zip-format or legacy pickle) or a *plain* zip archive wrapping one
    (e.g. ``generator_universal.pth.tar.zip`` from the HiFi-GAN release).

    key: select a specific sub-dict of a trainer checkpoint instead of the
    auto-unwrap — e.g. "ema" for the EMA weights of a reference TTS
    checkpoint {'scores','state_dict','ema','optimizer'}
    (reference: DEX-TTS/src/train.py:112-122).
    """
    ckpt = _load_torch_raw(path)
    if key is not None:
        ckpt = ckpt[key]
    else:
        if isinstance(ckpt, dict) and "generator" in ckpt:
            ckpt = ckpt["generator"]
        if isinstance(ckpt, dict) and "state_dict" in ckpt:
            ckpt = ckpt["state_dict"]
    return _tensors_to_numpy(ckpt)


def _tensors_to_numpy(state: dict) -> dict:
    return {k: v.numpy() for k, v in state.items() if hasattr(v, "numpy")}


def load_torch_trainer_checkpoint(path: str) -> tuple[dict, dict | None]:
    """One disk read of a reference trainer checkpoint → (state_dict, ema).

    ema is None when the file is a bare state_dict (no trainer wrapper) or
    the wrapper has no 'ema' key. reference: DEX-TTS/src/train.py:112-122.
    """
    ckpt = _load_torch_raw(path)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        sd = _tensors_to_numpy(ckpt["state_dict"])
        ema = ckpt.get("ema")
        return sd, (_tensors_to_numpy(ema) if isinstance(ema, dict) else None)
    return _tensors_to_numpy(ckpt), None


def _load_torch_raw(path: str):
    def _load_file(p):
        return torch.load(p, map_location="cpu", weights_only=True)

    try:
        ckpt = _load_file(path)
    except Exception as first_exc:
        # maybe an outer plain zip wrapping the checkpoint file: extract the
        # largest member and load that. NB a torch zip-format file that
        # merely failed weights_only deserialization is also a valid
        # zipfile — detect it by its data.pkl record and re-raise the
        # original error rather than extracting a raw storage blob.
        import tempfile
        import zipfile

        if not zipfile.is_zipfile(path):
            raise
        with zipfile.ZipFile(path) as zf:
            members = [n for n in zf.namelist() if not n.endswith("/")]
            if not members or any(n.endswith("data.pkl") for n in members):
                raise
            inner = max(members, key=lambda n: zf.getinfo(n).file_size)
            with tempfile.TemporaryDirectory() as td:
                try:
                    ckpt = _load_file(zf.extract(inner, td))
                except Exception:
                    raise first_exc  # wrapper theory wrong: original error
    return ckpt
