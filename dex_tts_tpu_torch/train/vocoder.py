"""Vocoder GAN training: a HiFi-GAN or BigVGAN generator against the MPD
and MRD critics (port of dex_tts_tpu/train/vocoder.py).

The upstream HiFi-GAN/BigVGAN recipe as the JAX package has it: AdamW
(0.8, 0.99, weight decay 0.01) behind a global-norm clip of 1000, a
staircase exponential learning-rate decay per ``steps_per_epoch``
updates, LSGAN + feature matching + ``lambda_mel``·L1 on the full-band
mel. Both mels are computed from the waveform on the device inside the
step; the host feeds waveform segments only.

One step keeps JAX's order: the critics are updated on the generator's
output, detached, then the generator against the *updated* critics. JAX
applies the generator twice to the same parameters; here it runs once,
with grad, and the critics' update takes its output detached: the same
numbers. BigVGAN's snakes run the snake kernel on the card under
autograd (`ops.snake.SnakeKernelFunction`: kernel forward, plain
backward). A parameter that gets no gradient raises: nothing is filled
with zeros.

Data-parallel (`parallel.make_parallel_train_step`): every loss is a mean
over rows that each rank holds equally many of, so a rank's loss is its
mean over ``dp`` ranks (its share of the global batch's mean), and both
optimizers sum the gradients over the dp group before their clips.

State is one `VocoderTrainState`; checkpoints are ``<root>/<tag>.pth``
files that load under ``torch.load(weights_only=True)``, and
``gen_last.pth`` (the generator's state_dict alone) is what
`eval.evaluation.load_vocoder` serves.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.nn as nn

from dex_tts_tpu_torch.audio.stft import MelSpectrogram
from dex_tts_tpu_torch.models.vocoder import (
    BigVGANConfig,
    BigVGANGenerator,
    HiFiGANConfig,
    HiFiGANGenerator,
)
from dex_tts_tpu_torch.models.vocoder.discriminators import (
    DiscriminatorConfig,
    MultiPeriodDiscriminator,
    MultiResolutionDiscriminator,
    discriminator_loss,
    feature_loss,
    generator_loss,
)
from dex_tts_tpu_torch.parallel import collectives
from dex_tts_tpu_torch.train.checkpoint import _to_host, _write
from dex_tts_tpu_torch.train.state import clip_by_global_norm_
from dex_tts_tpu_torch.utils.device import resolve_device

MAX_GRAD_NORM = 1000.0  # a safety net only, as upstream


class VocoderOptimizer:
    """optax.chain(clip_by_global_norm(1000), adamw(schedule, b1, b2,
    weight_decay=0.01)) over a module's parameters: the global-norm clip
    (`clip_by_global_norm_`), `torch.optim.AdamW`, and a `LambdaLR` that
    steps once per update, so update n (counting from 0) runs at
    ``lr · lr_decay ** (n // steps_per_epoch)``."""

    def __init__(self, module: nn.Module, lr: float = 2e-4, lr_decay: float = 0.999,
                 steps_per_epoch: int = 1000, b1: float = 0.8, b2: float = 0.99):
        self.named = list(module.named_parameters())
        self.adamw = torch.optim.AdamW([p for _, p in self.named], lr=lr, betas=(b1, b2),
                                       eps=1e-8, weight_decay=0.01)
        every = max(1, steps_per_epoch)
        self.schedule = torch.optim.lr_scheduler.LambdaLR(
            self.adamw, lambda n: lr_decay ** (n // every))

    def zero_grad(self) -> None:
        for _, p in self.named:
            p.grad = None

    def step(self) -> torch.Tensor:
        """One update from the parameters' gradients (every one must have
        one; summed over the dp group inside a data-parallel block) → the
        global norm before clipping."""
        missing = [n for n, p in self.named if p.grad is None]
        if missing:
            raise RuntimeError(f"{len(missing)} parameters got no gradient (first: {missing[0]})")
        grads = [p.grad for _, p in self.named]
        collectives.reduce_gradients_(grads)
        norm = clip_by_global_norm_(grads, MAX_GRAD_NORM)
        self.adamw.step()
        self.schedule.step()
        return norm

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "schedule": self.schedule.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.schedule.load_state_dict(state["schedule"])


def make_vocoder_optimizer(module: nn.Module, lr: float = 2e-4, lr_decay: float = 0.999,
                           steps_per_epoch: int = 1000, b1: float = 0.8,
                           b2: float = 0.99) -> VocoderOptimizer:
    """The upstream HiFi-GAN/BigVGAN optimizer over ``module``'s parameters
    (ExponentialLR gamma 0.999 per epoch as a staircase per update)."""
    return VocoderOptimizer(module, lr, lr_decay, steps_per_epoch, b1, b2)


@dataclass
class VocoderTrainState:
    """``step`` counts updates; ``critics`` holds ``mpd`` and ``mrd``."""

    step: int
    generator: nn.Module
    critics: nn.ModuleDict
    gen_optimizer: VocoderOptimizer
    disc_optimizer: VocoderOptimizer


def build_critics(cfg: DiscriminatorConfig = DiscriminatorConfig()) -> nn.ModuleDict:
    return nn.ModuleDict({"mpd": MultiPeriodDiscriminator(cfg),
                          "mrd": MultiResolutionDiscriminator(cfg)})


def create_vocoder_train_state(gen_cfg: HiFiGANConfig | BigVGANConfig,
                               disc_cfg: DiscriminatorConfig = DiscriminatorConfig(),
                               lr: float = 2e-4, lr_decay: float = 0.999,
                               steps_per_epoch: int = 1000, seed: int = 100,
                               device=None) -> VocoderTrainState:
    """A fresh state on ``device`` (CUDA by default): the generator and the
    critics initialised on the CPU from ``seed`` (the global RNG is left as
    it was), so every device starts from the same weights; one optimizer
    each."""
    device = resolve_device(device)
    gen_cls = BigVGANGenerator if isinstance(gen_cfg, BigVGANConfig) else HiFiGANGenerator
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        generator = gen_cls(gen_cfg)
        critics = build_critics(disc_cfg)
    generator.to(device).train()
    critics.to(device).train()
    return VocoderTrainState(
        step=0, generator=generator, critics=critics,
        gen_optimizer=make_vocoder_optimizer(generator, lr, lr_decay, steps_per_epoch),
        disc_optimizer=make_vocoder_optimizer(critics, lr, lr_decay, steps_per_epoch),
    )


def vocoder_mels(wav: torch.Tensor, mel_input: MelSpectrogram, mel_loss: MelSpectrogram):
    """(B, S) waveform → (generator input mel (B, n_mels, S / hop), loss
    target mel). S must be a multiple of the input mel's hop."""
    hop = mel_input.hop_length
    if wav.shape[1] % hop:
        raise ValueError(
            f"segment length {wav.shape[1]} must be a multiple of the mel hop {hop}: the "
            "generator upsamples exactly hop x frames, so real and fake waveforms would "
            "mismatch in the discriminators"
        )
    return mel_input(wav)[0][:, :, : wav.shape[1] // hop], mel_loss(wav)[0]


def critic_loss(critics: nn.ModuleDict, wav: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """The MPD's and the MRD's LSGAN objectives, summed."""
    r_p, f_p, _, _ = critics["mpd"](wav, fake)
    r_r, f_r, _, _ = critics["mrd"](wav, fake)
    return discriminator_loss(r_p, f_p)[0] + discriminator_loss(r_r, f_r)[0]


def generator_losses(critics: nn.ModuleDict, wav: torch.Tensor, fake: torch.Tensor,
                     mel_target: torch.Tensor, mel_loss: MelSpectrogram,
                     lambda_mel: float) -> dict:
    """The generator's objective against ``critics`` → {loss_gen (the
    total), loss_mel, loss_adv, loss_fm}."""
    l_mel = torch.mean(torch.abs(mel_loss(fake)[0] - mel_target))
    _, f_p, fmap_rp, fmap_gp = critics["mpd"](wav, fake)
    _, f_r, fmap_rr, fmap_gr = critics["mrd"](wav, fake)
    adv = generator_loss(f_p)[0] + generator_loss(f_r)[0]
    fm = feature_loss(fmap_rp, fmap_gp) + feature_loss(fmap_rr, fmap_gr)
    return {"loss_gen": adv + fm + lambda_mel * l_mel, "loss_mel": l_mel, "loss_adv": adv,
            "loss_fm": fm}


def make_vocoder_train_step(mel_input: MelSpectrogram, mel_loss: MelSpectrogram | None = None,
                            lambda_mel: float = 45.0):
    """One GAN step on a (B, S) waveform batch: (state, {"wav": ...}) →
    metrics as device tensors, updating ``state`` in place. ``mel_loss``
    (the L1 term's mel; upstream uses a full-band one) defaults to
    ``mel_input``."""
    mel_loss = mel_loss or mel_input

    def step(state: VocoderTrainState, batch: dict) -> dict:
        share = 1.0 / collectives.dp_world()  # this rank's part of the global means
        device = next(state.generator.parameters()).device
        wav = torch.as_tensor(batch["wav"]).float().to(device, non_blocking=True)
        mel_in, mel_target = vocoder_mels(wav, mel_input, mel_loss)
        fake = state.generator(mel_in)  # once, with grad: the critics take it detached

        # the critics' update on the generator's output
        state.disc_optimizer.zero_grad()
        loss_d = critic_loss(state.critics, wav, fake.detach()) * share
        loss_d.backward()
        state.disc_optimizer.step()

        # the generator's update against the updated critics, whose
        # parameters take no gradient meanwhile
        state.gen_optimizer.zero_grad()
        state.critics.requires_grad_(False)
        try:
            losses = generator_losses(state.critics, wav, fake, mel_target, mel_loss, lambda_mel)
            losses = {k: v * share for k, v in losses.items()}
            losses["loss_gen"].backward()
        finally:
            state.critics.requires_grad_(True)
        state.gen_optimizer.step()
        state.step += 1
        return {"loss_disc": loss_d.detach(), **{k: v.detach() for k, v in losses.items()}}

    return step


class VocoderCheckpoints:
    """Tags under ``root``: ``<root>/<tag>.pth``. `save` writes the whole
    state (step, generator, critics, both optimizers); `save_generator`
    the generator's state_dict alone (``gen_last``, the serving
    handoff)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def path(self, tag: str) -> str:
        return os.path.join(self.root, f"{tag}.pth")

    def exists(self, tag: str) -> bool:
        return os.path.isfile(self.path(tag))

    def save(self, state: VocoderTrainState, tag: str) -> None:
        _write(_to_host({
            "step": int(state.step),
            "generator": state.generator.state_dict(),
            "critics": state.critics.state_dict(),
            "gen_optimizer": state.gen_optimizer.state_dict(),
            "disc_optimizer": state.disc_optimizer.state_dict(),
        }), self.path(tag))

    def save_generator(self, state: VocoderTrainState, tag: str) -> None:
        _write(_to_host(state.generator.state_dict()), self.path(tag))

    def restore(self, state: VocoderTrainState, tag: str) -> VocoderTrainState:
        """Load ``tag`` into ``state`` in place and return it."""
        ckpt = torch.load(self.path(tag), map_location="cpu", weights_only=True)
        state.generator.load_state_dict(ckpt["generator"])
        state.critics.load_state_dict(ckpt["critics"])
        state.gen_optimizer.load_state_dict(ckpt["gen_optimizer"])
        state.disc_optimizer.load_state_dict(ckpt["disc_optimizer"])
        state.step = int(ckpt["step"])
        return state
