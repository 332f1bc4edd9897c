"""Checkpoints of the full train state as torch files (port of
dex_tts_tpu/train/checkpoint.py).

Each tag is one file ``<root>/<tag>.pth`` in the reference trainer's layout
{scores, state_dict, ema, optimizer} (reference: DEX-TTS/src/train.py:112-122),
plus ``step`` and the generator's state, so a resume repeats the same
steps. The JAX package's `convert.load_torch_trainer_checkpoint` reads
these files. Everything in them loads under ``torch.load(weights_only=True)``.

``async_save=True`` snapshots the tensors to host memory at the call and
writes them in a background thread. `wait` joins it and re-raises what the
writer raised, so a failed write cannot pass unnoticed.

A tensor-parallel state (`parallel.shard_train_state`) is saved in the
one-process layout: its slices are gathered first, a collective that every
rank of the tp group makes (`save_many` on every rank, ``write=False`` on
all but the one that writes). Restore into a one-process-layout state, then
shard it: a checkpoint restores into any world or tp size.
"""

from __future__ import annotations

import os
import shutil
import threading

import torch

from dex_tts_tpu_torch.parallel import tp
from dex_tts_tpu_torch.train.state import TrainState, ema_state_dict


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def state_payload(state: TrainState, scores: dict | None = None) -> dict:
    """The host copy of ``state`` that a checkpoint file holds, in the
    one-process layout (tensor-parallel slices gathered: a collective)."""
    model = state.model
    if tp.shard_count(model):
        sd = tp.full_state_dict(model)
        ema = tp.full_ema(model, state.ema)
        ema = {k: ema.get(k, v) for k, v in sd.items()}
        optimizer = tp.full_optimizer_state(state.optimizer, model)
    else:
        sd, ema, optimizer = model.state_dict(), ema_state_dict(state), state.optimizer.state_dict()
    return _to_host({
        "scores": dict(scores or {}),
        "state_dict": sd,
        "ema": ema,
        "optimizer": optimizer,
        "step": int(state.step),
        "generator": state.generator.get_state(),
    })


def _write(payload: dict, path: str) -> None:
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)  # a reader never sees a half-written file


class CheckpointManager:
    def __init__(self, root: str, async_save: bool = False, write: bool = True):
        """``write=False``: `save_many` makes the payload's collectives
        but writes nothing (a data-parallel rank other than 0)."""
        self.root = os.path.abspath(root)
        self.async_save = async_save
        self.write = write
        os.makedirs(self.root, exist_ok=True)
        self._writer: threading.Thread | None = None
        self._error: BaseException | None = None

    def path(self, tag: str) -> str:
        return os.path.join(self.root, f"{tag}.pth")

    def save(self, state: TrainState, tag: str, scores: dict | None = None) -> None:
        self.save_many(state, [tag], scores)

    def save_many(self, state: TrainState, tags: list[str], scores: dict | None = None) -> None:
        """One payload under several tags: one write for ``tags[0]``, then
        copies for the rest (in the background under ``async_save``)."""
        if not tags:
            return
        self.wait()
        if not self.write:
            if tp.shard_count(state.model):
                state_payload(state, scores)  # the tp group's gathers
            return
        payload = state_payload(state, scores)
        paths = [self.path(t) for t in tags]

        def write():
            _write(payload, paths[0])
            for dst in paths[1:]:
                tmp = f"{dst}.tmp"
                shutil.copyfile(paths[0], tmp)
                os.replace(tmp, dst)

        if not self.async_save:
            write()
            return

        def run():
            try:
                write()
            except BaseException as exc:  # handed to the caller by wait()
                self._error = exc

        self._writer = threading.Thread(target=run, daemon=True)
        self._writer.start()

    def wait(self) -> None:
        """Block until a background write has landed; re-raise its error."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            exc, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from exc

    def exists(self, tag: str) -> bool:
        self.wait()
        return os.path.isfile(self.path(tag))

    def restore(self, state: TrainState, tag: str) -> TrainState:
        """Load ``tag`` into ``state`` in place (model, EMA, optimizer,
        step, generator) and return it."""
        self.wait()
        ckpt = torch.load(self.path(tag), map_location="cpu", weights_only=True)
        state.model.load_state_dict(ckpt["state_dict"])
        with torch.no_grad():
            for name, value in state.ema.items():
                value.copy_(ckpt["ema"][name])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["step"])
        state.generator.set_state(ckpt["generator"])
        return state
