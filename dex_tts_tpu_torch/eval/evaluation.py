"""Checkpoint loading and objective evaluation (port of
dex_tts_tpu/eval/evaluation.py: `load_vocoder`,
`_find_torch_tts_checkpoint`, `load_synthesizer`, `gt_wav_path`,
`run_objective_eval`).

Capability equivalent of reference: DEX-TTS/src/evaluation.py:20-149
(test() + Tester.synthesize): load the checkpoint (EMA per the preset),
synthesize dataset sentences, vocode, write 22.05 kHz int16 wavs next to
copies of the ground truth, and report mel-MAE and MCD always, plus
CER/WER and speaker cosine when their optional backends are available.

Differences from the JAX package, on purpose:
  * a missing checkpoint raises (`FileNotFoundError`, naming what was
    tried) unless the caller passes ``random_init=True``; the JAX loader
    falls back to random weights with only a warning;
  * where the JAX loader reads its vocoder trainer's orbax directories
    (``gen_best``/``gen_last``), this one reads the port's vocoder
    trainer's files ``gen_best.pth``/``gen_last.pth``;
  * the evaluation's noise is one ``torch.Generator`` seeded once and
    drawn by every item in turn (JAX splits a PRNG key per item; the two
    streams cannot be matched);
  * a ground-truth copy that fails raises its OSError (the JAX package
    skips it silently).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import warnings

import torch

from dex_tts_tpu_torch.audio.wav import read_wav, resample, write_wav
from dex_tts_tpu_torch.config import Preset, build_model, build_vocoder
from dex_tts_tpu_torch.convert import (
    fold_weight_norm,
    load_numpy_state,
    load_torch_checkpoint,
    load_torch_trainer_checkpoint,
)
from dex_tts_tpu_torch.data import TextMelDataset
from dex_tts_tpu_torch.eval.metric import (
    ASRScorer,
    SpeakerScorer,
    cer,
    mean_and_stderr,
    mel_cepstral_distortion,
    mel_mae,
    wer,
)
from dex_tts_tpu_torch.models.edm import SamplerConfig
from dex_tts_tpu_torch.models.vocoder import BigVGANConfig
from dex_tts_tpu_torch.pipeline import Synthesizer
from dex_tts_tpu_torch.utils.device import resolve_device

# config.json keys that set a generator's architecture
# (reference: DEX-TTS/src/utils.py:255-262)
ARCH_KEYS = ("num_mels", "upsample_rates", "upsample_kernel_sizes",
             "upsample_initial_channel", "resblock_kernel_sizes", "resblock_dilation_sizes")
BIGVGAN_ARCH_KEYS = ARCH_KEYS + ("activation", "snake_logscale")
# the reference BigVGAN's alias-free activations keep their fixed
# Kaiser-sinc taps as persistent buffers; the port computes them from the
# config, so the reader drops them
BIGVGAN_FILTER_SUFFIXES = (".upsample.filter", ".downsample.lowpass.filter")


def read_vocoder_arch(path: str, bigvgan: bool) -> dict:
    """The architecture keys of ``config.json`` beside a vocoder checkpoint,
    as the JAX loader reads them (lists as tuples, nested lists as tuples
    of tuples); {} when there is no such file."""
    cfg_json = os.path.join(path, "config.json") if path else ""
    if not os.path.isfile(cfg_json):
        return {}
    with open(cfg_json) as f:
        j = json.load(f)
    return {
        k: tuple(tuple(e) if isinstance(e, list) else e for e in j[k])
        if isinstance(j[k], list)
        else j[k]
        for k in (BIGVGAN_ARCH_KEYS if bigvgan else ARCH_KEYS)
        if k in j
    }


def load_vocoder(preset: Preset, strict: bool = True, device=None, random_init: bool = False):
    """The preset's HiFi-GAN or BigVGAN with the reference torch weights
    under ``preset.vocoder_path``, on ``device`` (CUDA by default).
    reference: DEX-TTS/src/utils.py:251-281.

    The architecture is the preset's vocoder config with the keys of a
    ``config.json`` beside the checkpoint. Candidates: first the port's
    vocoder trainer's ``gen_best.pth`` and ``gen_last.pth`` (as the JAX
    loader tries its trainer's ``gen_best``/``gen_last`` first), then for
    HiFi-GAN ``generator_LJSpeech.pth.tar.zip``,
    ``generator_universal.pth.tar.zip``, ``generator_universal.pth.tar``
    and the path itself; for BigVGAN ``g_05000000`` and the path. Weight
    norm is folded and the weights load with
    ``load_state_dict(strict=strict)``. No file raises
    `FileNotFoundError` unless ``random_init`` (smoke runs only).

    dtype: ``preset.vocoder_dtype``. The JAX loader's "auto" picks bf16 for
    BigVGAN on the TPU and f32 everywhere else; its counterpart here is
    bf16 for BigVGAN on CUDA (the K2 snake kernel), f32 on the CPU, and f32
    for HiFi-GAN. Any other value is the dtype ("float32": the
    checkpoint's exact output)."""
    device = resolve_device(device)
    bigvgan = isinstance(preset.vocoder, BigVGANConfig)
    path = preset.vocoder_path
    arch = read_vocoder_arch(path, bigvgan)
    dtype = preset.vocoder_dtype
    if dtype == "auto":
        dtype = "bfloat16" if bigvgan and device.type == "cuda" else "float32"
    arch["dtype"] = dtype
    vocoder = build_vocoder(dataclasses.replace(preset.vocoder, **arch), device=device)
    names = ["gen_best.pth", "gen_last.pth"]  # train_vocoder's serving handoff
    if bigvgan:
        names += ["g_05000000"]
    else:
        names += ["generator_LJSpeech.pth.tar.zip", "generator_universal.pth.tar.zip",
                  "generator_universal.pth.tar"]
    candidates = [os.path.join(path, n) for n in names] + [path] if path else []
    for cand in candidates:
        if os.path.isfile(cand):
            state = fold_weight_norm(load_torch_checkpoint(cand))
            if bigvgan:
                state = {k: v for k, v in state.items()
                         if not k.endswith(BIGVGAN_FILTER_SUFFIXES)}
            vocoder.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in state.items()},
                                    strict=strict)
            return vocoder
    kind = "bigvgan" if bigvgan else "hifigan"
    if not random_init:
        raise FileNotFoundError(
            f"no {kind} checkpoint under vocoder_path={path!r} (tried "
            f"{candidates or 'nothing: the path is unset'}); pass random_init=True for "
            "random weights (smoke runs only)"
        )
    warnings.warn(f"no {kind} checkpoint under {path!r}: RANDOM-INIT vocoder "
                  "(smoke/debug only; output is noise)")
    return vocoder


# reference checkpoint names per tag (reference: DEX-TTS/src/train.py:112-122)
REFERENCE_NAMES = {
    "best-train": "model-train-best.pth",
    "best-val": "model-val-best.pth",
    "last": "model-last.pth",
}


def _torch_tts_candidates(exp_dir: str, tag: str) -> list[str]:
    cands = [REFERENCE_NAMES.get(tag, f"model-{tag}.pth")]
    if tag == "best-train":
        # the default tag: any reference checkpoint qualifies (reference
        # runs always have model-last.pth; bests only when val improved)
        cands += ["model-val-best.pth", "model-last.pth"]
    return [os.path.join(exp_dir, name) for name in cands]


def _find_torch_tts_checkpoint(exp_dir: str, tag: str) -> str | None:
    """Locate a reference-format torch TTS checkpoint for a tag.

    Migration path: a user coming from the reference can point the CLIs
    straight at their trained experiment dir (or a .pth file); naming per
    reference DEX-TTS/src/train.py:112-122 (model-{train,val}-best.pth,
    model-last.pth, model-{epoch}.pth)."""
    if os.path.isfile(exp_dir):
        return exp_dir
    for cand in _torch_tts_candidates(exp_dir, tag):
        if os.path.isfile(cand):
            return cand
    return None


def load_synthesizer(preset: Preset, exp_dir: str, n_timesteps: int = 50,
                     tag: str = "best-train", dit_cache_interval: int = 1,
                     solver: str = "euler", device=None,
                     random_init: bool = False) -> Synthesizer:
    """A Synthesizer with the preset's model and vocoder, weights from disk.

    The checkpoint is, in this order, the port's own ``<exp_dir>/ckpt/
    <tag>.pth`` (`train.checkpoint.CheckpointManager`, `main.train`), or a
    reference ``.pth``: ``exp_dir`` itself when it is a file, else the
    reference names for ``tag`` under it. With ``preset.ema`` the EMA
    weights are used (the raw ones, with a warning, when the file has
    none). A missing checkpoint raises `FileNotFoundError` unless
    ``random_init`` (smoke runs only; the vocoder then may be random too)."""
    if dit_cache_interval > 1 and n_timesteps % dit_cache_interval:
        # fail fast at startup — otherwise a misconfigured server boots
        # healthy and 500s every request
        raise ValueError(
            f"n_timesteps {n_timesteps} must be a multiple of "
            f"dit_cache_interval {dit_cache_interval}"
        )
    if solver not in ("euler", "heun", "dpmpp2m"):
        raise ValueError(f"unknown solver {solver!r}")
    if solver != "euler" and dit_cache_interval > 1:
        raise ValueError("dit_cache_interval>1 requires the euler solver")
    device = resolve_device(device)
    model = build_model(preset.model, device=device)
    own = os.path.join(exp_dir, "ckpt", f"{tag}.pth")
    path = own if os.path.isfile(own) else _find_torch_tts_checkpoint(exp_dir, tag)
    if path is not None:
        state_dict, ema_dict = load_torch_trainer_checkpoint(path)
        if preset.ema:
            if ema_dict is None:
                warnings.warn(f"preset.ema is set but {path} has no 'ema' weights; "
                              "using the raw state_dict")
            else:
                state_dict = ema_dict
        load_numpy_state(model, state_dict)
    elif random_init:
        warnings.warn(f"no checkpoint {tag!r} under {exp_dir}: synthesizing with "
                      "RANDOM-INIT weights (smoke/debug only; output is noise)")
    else:
        raise FileNotFoundError(
            f"no checkpoint for tag {tag!r}: tried "
            f"{[own] + _torch_tts_candidates(exp_dir, tag)}; pass random_init=True "
            "for random weights (smoke runs only)"
        )
    vocoder = load_vocoder(preset, device=device, random_init=random_init)
    return Synthesizer(
        model, vocoder, cmu_path=preset.cmu_path, add_blank=preset.add_blank,
        sampler=SamplerConfig(num_steps=n_timesteps, solver=solver,
                              dit_cache_interval=dit_cache_interval),
        device=device,
    )


def gt_wav_path(filelist_path: str) -> str:
    """Ground-truth wav path for a filelist entry.

    Filelists store the mel path ``.../mel/{spk}/{spk}-mel-{base}.npy``; the
    preprocessor writes the trimmed wav next to it at
    ``.../wav/{spk}/{base}.wav`` (`preprocess/preprocessor.py`). Entries
    that already point at a wav are returned unchanged
    (reference: DEX-TTS/src/evaluation.py:60-67 copies GT wavs)."""
    if filelist_path.endswith(".wav"):
        return filelist_path
    d, name = os.path.split(filelist_path.replace("/mel/", "/wav/"))
    if "-mel-" in name and name.endswith(".npy"):
        base = name.split("-mel-", 1)[1][: -len(".npy")]
        return os.path.join(d, base + ".wav")
    return ""


def run_objective_eval(
    preset: Preset,
    exp_dir: str,
    sample_size: int = 10,
    n_timesteps: int = 50,
    test_file: str | None = None,
    seed: int = 0,
    asr: ASRScorer | None = None,
    spk_scorer: SpeakerScorer | None = None,
    dit_cache_interval: int = 1,
    solver: str = "euler",
    spk_encoder: str | None = None,
    tag: str = "best-train",
    device=None,
    random_init: bool = False,
) -> dict:
    """Synthesize the first ``sample_size`` items of ``preset.val_path``
    (or lines of ``test_file``) with the checkpoint under ``exp_dir`` (an
    experiment dir or a ``.pth`` file; `load_synthesizer`), on ``device``
    (CUDA by default), and score them → {metric: (mean, stderr)}, the JAX
    package's dict.

    Writes ``<dir>/eval/{i:03d}_syn.wav``, a copy of each item's ground
    truth as ``{i:03d}_ref.wav`` and ``report.txt`` (``name: mean ±
    stderr``), where ``<dir>`` is ``exp_dir``, or the directory of the
    ``.pth`` file. mel_mae and mcd hold the synthesized mel against the
    item's; wer/cer need an available ASR, cos an available speaker scorer
    and the ground-truth wav (resampled to 22.05 kHz). ``asr`` and
    ``spk_scorer`` may be injected (tests); otherwise the default ASR and
    a `SpeakerScorer` with ``spk_encoder`` (resemblyzer's pretrained.pt)
    run on the same device. DeX items take their own mel and lf0 as the
    reference style; the temperature is ``preset.temperature``; one
    generator seeded with ``seed`` gives every item's noise in turn.

    dit_cache_interval > 1 evaluates the approximate DiT-cache sampler,
    solver="dpmpp2m" the second-order multistep solver: run either
    against the exact default to measure its quality cost."""
    device = resolve_device(device)
    if test_file:
        with open(test_file) as f:
            sentences = [line.strip() for line in f if line.strip()]
        items = [{"raw_text": s} for s in sentences[:sample_size]]
    else:
        if not (preset.val_path and os.path.isfile(preset.val_path)):
            raise FileNotFoundError(
                f"objective eval needs the val filelist ({preset.val_path}); "
                "synthesize/serve run without a dataset, but `main test` scores "
                "against real items — or pass --test_file for text-only synthesis"
            )
        ds = TextMelDataset(preset.val_path, cmu_path=preset.cmu_path,
                            add_blank=preset.add_blank, load_style=preset.model.use_style)
        items = [ds.eval_item(i) for i in range(min(sample_size, len(ds)))]
    synth = load_synthesizer(preset, exp_dir, n_timesteps, tag=tag,
                             dit_cache_interval=dit_cache_interval, solver=solver,
                             device=device, random_init=random_init)
    root = os.path.dirname(os.path.abspath(exp_dir)) if os.path.isfile(exp_dir) else exp_dir
    out_dir = os.path.join(root, "eval")
    os.makedirs(out_dir, exist_ok=True)

    asr = asr if asr is not None else ASRScorer(device=synth.device)
    if spk_scorer is None:
        spk_scorer = SpeakerScorer(weights=spk_encoder, device=synth.device)
    maes, mcds, wers, cers, coss = [], [], [], [], []
    generator = torch.Generator(synth.device).manual_seed(seed)
    for i, item in enumerate(items):
        kwargs = {}
        if "ref" in item:
            # in-dataset reference features (ref == sty, same mel)
            kwargs["ref_feats"] = [(item["ref"], item["lf0"])]
        out = synth.tts([item["raw_text"]], generator=generator,
                        temperature=preset.temperature, **kwargs)[0]
        write_wav(os.path.join(out_dir, f"{i:03d}_syn.wav"), out["wav"])
        if "y" in item:
            maes.append(mel_mae(item["y"], out["mel"]))
            mcds.append(mel_cepstral_distortion(item["y"], out["mel"]))
        gt_path = gt_wav_path(item.get("filepath", ""))
        if not (gt_path and os.path.isfile(gt_path)):
            gt_path = ""
        copy_src = gt_path or item.get("filepath", "")
        if copy_src and os.path.isfile(copy_src):
            shutil.copy(copy_src, os.path.join(
                out_dir, f"{i:03d}_ref" + os.path.splitext(copy_src)[1]))
        hyp = asr.transcribe(out["wav"]) if asr.available else None
        if hyp is not None:
            wers.append(wer(item["raw_text"], hyp))
            cers.append(cer(item["raw_text"], hyp))
        # speaker cosine similarity vs the ground-truth utterance
        # (reference: DEX-TTS/src/metric.py:80-95, evaluation.py:76-85)
        if spk_scorer.available and gt_path:
            gt_wav, gt_sr = read_wav(gt_path)
            cos = spk_scorer.cosine(out["wav"], resample(gt_wav, gt_sr, 22050),
                                    sample_rate=22050)
            if cos is not None:
                coss.append(cos)

    report = {}
    for name, vals in [("mel_mae", maes), ("mcd", mcds), ("wer", wers),
                       ("cer", cers), ("cos", coss)]:
        if vals:
            report[name] = mean_and_stderr(vals)
    lines = [f"{name}: {mean:.4f} ± {se:.4f}" for name, (mean, se) in report.items()]
    text = "\n".join(lines) if lines else "no metrics available"
    print(text)
    with open(os.path.join(out_dir, "report.txt"), "w") as f:
        f.write(text + "\n")
    return report
