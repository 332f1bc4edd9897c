"""The comparison that decides ``correct`` for batch synthesis: what the
timed path produced for one call of the window against the plain
reference (`benchmark.reference`), number by number, each against its
limit (`benchmark/limits/<workload>.json`).

  ids     token ids that differ from the reference front end's, per item
          and summed (a length difference counts each missing id);
          limit 0
  frames  items whose frame count differs from the reference pre-pass's
          uncapped one (so a cut item counts), plus 1 if the frame bucket
          differs; limit 0
  mel     the largest over items of ‖mel − mel_ref‖ / ‖mel_ref‖ over the
          item's frames: the program's text→mel (encoders, pre-pass,
          sampler, denoiser) against the reference's from the same text,
          style features and initial noise
  wav     the largest over items of ‖wav − voc_ref(mel)‖ / ‖voc_ref(mel)‖
          over the item's samples (frames × hop): the program's vocoder
          against the reference vocoder on the program's own mel (the
          stage alone)

An output of another length than the reference's reads infinite.
"""

from __future__ import annotations

import contextlib
import math
import os

import numpy as np
import torch
import torch.utils.flop_counter

from benchmark import reference
from benchmark.registry import named
from benchmark.weights import state_dicts

# the control: each part computed one precision below the configuration's
# (float32 at PyTorch's defaults runs its convolutions in TF32: bfloat16
# is the next step down; bfloat16's is float8)
LOWER = {"float32": "bfloat16", "bfloat16": "float8_e4m3fn"}


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape:
        return math.inf
    err = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
    return err if math.isfinite(err) else math.inf


def numbers(call: dict, outputs: list[dict], ref: dict, wav_ref: np.ndarray, hop: int,
            per_item: bool = False) -> dict:
    """call: the recorder's record of the checked call (``x``,
    ``x_lengths``, ``bucket``); outputs: what `Synthesizer.tts` returned;
    ref: `reference.tts`'s result; wav_ref: the reference vocoder on the
    program's mels (B, samples); hop: samples per frame."""
    x, x_len = call["x"].cpu().numpy(), call["x_lengths"].cpu().numpy()
    ids = 0
    for i, want in enumerate(ref["ids"]):
        got = x[i, : x_len[i]].tolist()
        ids += sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
    frames = int(call["bucket"] != ref["bucket"]) + abs(len(outputs) - len(ref["frames"]))
    frames += sum(int(o["n_frames"] != int(f)) for o, f in zip(outputs, ref["frames"]))
    mel_ref = ref["mel"].float().cpu().numpy()
    mel = [_rel(np.asarray(o["mel"]), mel_ref[i, :, : o["n_frames"]])
           for i, o in enumerate(outputs)]
    wav = [_rel(np.asarray(o["wav"]), wav_ref[i, : o["n_frames"] * hop])
           for i, o in enumerate(outputs)]
    out = {"ids": ids, "frames": frames, "mel": max(mel), "wav": max(wav)}
    if per_item:
        out.update(mel_items=mel, wav_items=wav)
    return out


@contextlib.contextmanager
def strict_float32():
    """TF32 off for matrix products and cuDNN convolutions."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def reference_models(config: dict, seed: int, device, lower: bool = False) -> dict:
    """{part: the reference's module on ``device`` with the run's
    weights}; with ``lower``, each layer rounded one precision below the
    one the configuration's ``precision`` gives it (`LOWER`; a key is a
    part or a dotted path inside one, the longest that leads to a layer
    is its own)."""
    weights = state_dicts(config, seed, device)
    models = {}
    for part, names in config["parts"].items():
        model = named("reference", names["reference"]).build(config).to(device)
        model.load_state_dict(weights[part], strict=True)
        if lower:
            dtypes = {key.removeprefix(part).removeprefix("."): LOWER[prec]
                      for key, prec in config["precision"].items()
                      if key == part or key.startswith(part + ".")}
            reference.lower_precision(model, dtypes)
        models[part] = model
    return models


def padded(mels: list[np.ndarray], bucket: int) -> np.ndarray:
    out = np.zeros((len(mels), mels[0].shape[0], bucket), np.float32)
    for i, m in enumerate(mels):
        n = min(m.shape[1], bucket)
        out[i, :, :n] = m[:, :n]
    return out


def _cmudict(config: dict, root: str):
    return reference.read_cmudict(os.path.join(root, config["cmu_path"])) \
        if config.get("cmu_path") else None


def reference_call(config: dict, traffic: dict, seed: int, noise_seed: int, batch: dict,
                   mels: list[np.ndarray], bucket: int, device, root: str,
                   count_flops: bool = False):
    """The reference on one call's batch (its text, style features and
    the call's noise seed) and its vocoder on ``mels`` (the program's,
    padded to ``bucket``) → (reference result, waveforms, FLOPs or None)."""
    models = reference_models(config, seed, device)
    counter = torch.utils.flop_counter.FlopCounterMode(display=False) if count_flops else None
    with strict_float32(), counter or contextlib.nullcontext():
        ref = reference.tts(models["tts"], batch["texts"], _cmudict(config, root),
                            batch["ref_feats"], torch.Generator(device).manual_seed(noise_seed),
                            config["synthesizer"], traffic, device)
        with torch.no_grad():
            wav = models["vocoder"](torch.from_numpy(padded(mels, bucket)).to(device))
    return ref, wav.cpu().numpy(), (counter.get_total_flops() if count_flops else None)


def control_numbers(config: dict, traffic: dict, seed: int, noise_seed: int, batch: dict,
                    ref: dict, device, root: str, hop: int) -> dict:
    """The numbers of the control: the reference one precision lower in
    the program's place, against the reference (its vocoder on the
    control's own mels, as the program's is judged on its own)."""
    low = reference_models(config, seed, device, lower=True)
    voc_ref = reference_models(config, seed, device)["vocoder"]
    with strict_float32(), torch.no_grad():
        out = reference.tts(low["tts"], batch["texts"], _cmudict(config, root),
                            batch["ref_feats"], torch.Generator(device).manual_seed(noise_seed),
                            config["synthesizer"], traffic, device)
        lengths = out["lengths"].tolist()
        mels = [out["mel"][i, :, :n].cpu().numpy() for i, n in enumerate(lengths)]
        mel_in = torch.from_numpy(padded(mels, out["bucket"])).to(device)
        wav_low, wav_ref = low["vocoder"](mel_in).cpu().numpy(), voc_ref(mel_in).cpu().numpy()
    x = torch.zeros(len(out["ids"]), max(map(len, out["ids"])), dtype=torch.long)
    for i, s in enumerate(out["ids"]):
        x[i, : len(s)] = torch.tensor(s)
    call = {"x": x, "x_lengths": torch.tensor([len(s) for s in out["ids"]]),
            "bucket": out["bucket"]}
    outputs = [{"mel": m, "wav": wav_low[i, : n * hop], "n_frames": n}
               for i, (m, n) in enumerate(zip(mels, lengths))]
    return numbers(call, outputs, ref, wav_ref, hop, per_item=True)
