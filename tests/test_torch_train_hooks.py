"""Port vs JAX package: the DeX trainer's hooks. `PreemptionGuard` and
`Trainer.fit` under a SIGTERM raised inside the loader (after JAX's
tests/test_train.py::test_preemption_checkpoints_and_exits), the
``--init_from`` warm start against JAX's `warm_start_state` on one
reference-format file (after tests/test_e2e_train.py::
test_train_warm_start_from_torch_checkpoint), and periodic synthesis
through the train entry point: its WAVs, its errors, and training that
draws the same numbers with it as without it."""

import dataclasses
import importlib.util
import math
import os
import re
import signal

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import write_training_set  # noqa: E402
from dex_tts_tpu_torch import main as port_main  # noqa: E402
from dex_tts_tpu_torch.config import TrainConfig, load_preset  # noqa: E402
from dex_tts_tpu_torch.convert import dex_tts_flax_to_torch  # noqa: E402
from dex_tts_tpu_torch.models import tts as tts_mod  # noqa: E402
from dex_tts_tpu_torch.models.vocoder import HiFiGANConfig, HiFiGANGenerator  # noqa: E402
from dex_tts_tpu_torch.pipeline import Synthesizer  # noqa: E402
from dex_tts_tpu_torch.train import PreemptionGuard, Trainer, create_train_state  # noqa: E402
from dex_tts_tpu_torch.train.trainer import make_train_step, metrics_to_host  # noqa: E402
from tests.test_torch_train import _batch, _tiny_state  # noqa: E402
from tests.torch_port_util import jax_model, tiny_cfg  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CMU = os.path.join(REPO, "resources", "cmu_dictionary")
OUT = 16
HIFIGAN_TINY = dict(num_mels=12, upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
                    upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                    resblock_dilation_sizes=((1, 3),))


def test_guard_flags_signals_and_restores_handlers():
    before = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard()
    try:
        assert not guard.triggered
        signal.raise_signal(signal.SIGTERM)
        assert guard.triggered
    finally:
        guard.restore()
    assert signal.getsignal(signal.SIGTERM) == before


def test_sigterm_in_the_loader_saves_last_and_preempt(tmp_path):
    """SIGTERM while batch 3 is being yielded: the loop polls before using
    it, so two steps ran; ``last`` and ``preempt`` are on disk, `fit`
    returned in its first epoch, and a resume from ``preempt`` repeats the
    next step."""
    cfg, state = _tiny_state(seed=4)
    batches = [_batch(cfg, seed=s) for s in (1, 2, 3)]
    fired = {"n": 0}

    def loader():
        for i in range(50):
            fired["n"] = i + 1
            if i == 2:
                signal.raise_signal(signal.SIGTERM)
            yield batches[i % 3]

    guard = PreemptionGuard()
    try:
        trainer = Trainer(state, str(tmp_path), out_size=OUT, preemption=guard)
        trainer.fit(loader, epochs=3)
    finally:
        guard.restore()
    assert fired["n"] == 3 and state.step == 2
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["last.pth", "preempt.pth"]
    log = (tmp_path / "log.txt").read_text()
    assert "preempted during epoch 1" in log and "epoch 1 |" not in log
    _, fresh = _tiny_state(seed=99)
    trainer.ckpt.restore(fresh, "preempt")
    assert fresh.step == 2
    step = make_train_step(out_size=OUT)
    next_batch = _batch(cfg, seed=7)
    assert metrics_to_host(step(fresh, next_batch)) == metrics_to_host(step(state, next_batch))


@pytest.mark.parametrize("epochs", [1, 3])
def test_sigterm_during_the_last_batch_of_an_epoch(tmp_path, epochs):
    """SIGTERM after the epoch's last poll, as its loader runs out: the
    check after the epoch saves ``last`` and ``preempt`` at once, with no
    validation, no per-epoch checkpoint and no later epoch, in the final
    epoch too."""
    cfg, state = _tiny_state(seed=4)
    batches = [_batch(cfg, seed=s) for s in (1, 2)]
    validated = {"n": 0}

    def loader():
        yield from batches
        signal.raise_signal(signal.SIGTERM)

    def valid_loader():
        validated["n"] += 1
        yield batches[0]

    guard = PreemptionGuard()
    try:
        trainer = Trainer(state, str(tmp_path), out_size=OUT, preemption=guard)
        trainer.fit(loader, valid_loader, epochs=epochs)
    finally:
        guard.restore()
    assert state.step == 2 and validated["n"] == 0
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["last.pth", "preempt.pth"]
    log = (tmp_path / "log.txt").read_text()
    assert "preempted during epoch 1" in log and "epoch 1 |" not in log


def _load_jax_main():
    spec = importlib.util.spec_from_file_location("jax_main_cli", os.path.join(REPO, "main.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class _JaxStateFields:
    """The fields of the JAX TrainState that `warm_start_state` reads and
    replaces."""

    params: object = None
    ema_params: object = None
    batch_stats: object = None
    vq_stats: object = None

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def test_warm_start_matches_jax(tmp_path):
    """One reference-format file (``model-last.pth`` in an experiment dir:
    state_dict + a distinct EMA): the port's weights and buffers equal the
    JAX warm start's variables carried over by the port's converter, the
    EMA too; the optimizer is fresh. Without an ``ema`` entry the EMA is
    the weights; a missing file raises."""
    cfg = tiny_cfg(n_spks=0)
    torch.manual_seed(2)
    source = tts_mod.build_tts(cfg).state_dict()
    for k, v in source.items():
        if "bias_hh" in k:
            # the JAX converter folds the GRU's r/z hidden biases into
            # bias_ih: 0 here, as in a port carrying JAX weights
            v[: 2 * v.shape[0] // 3] = 0.0
        elif v.is_floating_point():
            v.add_(0.01 * torch.randn(v.shape))  # adaLN, the final layer etc. start at 0
    ema = {k: v if "bias_hh" in k else v + 0.5 for k, v in source.items()}
    ref_exp = tmp_path / "ref_exp"
    os.makedirs(ref_exp)
    torch.save({"scores": {}, "state_dict": source, "ema": ema, "optimizer": {}},
               ref_exp / "model-last.pth")

    jstate = _load_jax_main().warm_start_state(_JaxStateFields(), jax_model(cfg), str(ref_exp))
    others = {k: getattr(jstate, k) for k in ("batch_stats", "vq_stats")}
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    want = dex_tts_flax_to_torch(to_np({"params": jstate.params, **others}), cfg)
    want_ema = dex_tts_flax_to_torch(to_np({"params": jstate.ema_params, **others}), cfg)

    torch.manual_seed(5)
    state = create_train_state(tts_mod.build_tts(cfg), seed=5)
    port_main.warm_start_state(state, str(ref_exp))
    got = state.model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k, v in state.ema.items():
        np.testing.assert_array_equal(v.numpy(), want_ema[k], err_msg=k)
    assert len(state.optimizer.state) == 0

    torch.save({"state_dict": source}, tmp_path / "bare.pth")
    port_main.warm_start_state(state, str(tmp_path / "bare.pth"))
    assert all(torch.equal(state.ema[k], source[k]) for k in state.ema)
    with pytest.raises(FileNotFoundError, match="no reference checkpoint"):
        port_main.warm_start_state(state, str(tmp_path / "empty"))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A tiny DeX preset on a dataset written to disk, with a tiny HiFi-GAN
    (12 mels) as the port's vocoder trainer hands it over (``gen_last.pth``)
    at its ``vocoder_path``, synthesis every epoch."""
    root = tmp_path_factory.mktemp("hooks")
    train, valid = write_training_set(str(root / "data"), 14, n_mels=12, frames=(20, 90))
    torch.manual_seed(3)
    os.makedirs(root / "voc")
    torch.save(HiFiGANGenerator(HiFiGANConfig(**HIFIGAN_TINY)).state_dict(),
               root / "voc" / "gen_last.pth")
    preset = dataclasses.replace(
        load_preset("esd"), model=tiny_cfg(), train_path=train, val_path=valid, cmu_path=CMU,
        train=TrainConfig(epoch=2, batch_size=7, lr=1e-3, max_grad=5.0, fix_len=0.2,
                          save_epoch=100, syn_every=1),
        vocoder=HiFiGANConfig(**HIFIGAN_TINY), vocoder_path=str(root / "voc"))
    return root, preset


def _train(preset, exp_dir, **kw):
    return port_main.train(preset, str(exp_dir), seed=1, device="cpu", n_timesteps=2, **kw)


def test_periodic_synthesis_writes_wavs_and_leaves_training_alone(setup, tmp_path, capsys):
    """``syn_every=1``: two WAVs per epoch under ``<exp_dir>/sample``, a
    finite mel MAE printed for each, the model back in train mode; the
    weights, EMA, optimizer and generator after two epochs are bit-equal
    to a run without synthesis."""
    _, preset = setup
    with_syn = _train(preset, tmp_path / "syn")
    names = sorted(os.listdir(tmp_path / "syn" / "sample"))
    assert names == ["epoch1_0.wav", "epoch1_1.wav", "epoch2_0.wav", "epoch2_1.wav"]
    assert all(os.path.getsize(tmp_path / "syn" / "sample" / n) > 44 for n in names)
    maes = [float(m) for m in re.findall(r"syn sample \d: mel_mae=(\S+)", capsys.readouterr().out)]
    assert len(maes) == 4 and all(math.isfinite(m) for m in maes)
    assert with_syn.state.model.training

    plain = dataclasses.replace(preset, train=dataclasses.replace(preset.train, syn_every=0))
    without = _train(plain, tmp_path / "plain")
    assert not os.path.exists(tmp_path / "plain" / "sample")
    assert with_syn.state.step == without.state.step == 4
    for (k, v), w in zip(with_syn.state.model.state_dict().items(),
                         without.state.model.state_dict().values()):
        assert torch.equal(v, w), k
    assert all(torch.equal(with_syn.state.ema[k], without.state.ema[k]) for k in without.state.ema)
    assert torch.equal(with_syn.state.generator.get_state(), without.state.generator.get_state())
    opt_a, opt_b = with_syn.state.optimizer.state_dict(), without.state.optimizer.state_dict()
    assert all(torch.equal(opt_a["state"][i]["exp_avg_sq"], opt_b["state"][i]["exp_avg_sq"])
               for i in opt_b["state"])


def test_periodic_synthesis_skips_a_missing_vocoder_and_raises_the_rest(setup, tmp_path,
                                                                        capsys, monkeypatch):
    _, preset = setup
    missing = dataclasses.replace(preset, vocoder_path=str(tmp_path / "no_vocoder"))
    trainer = _train(missing, tmp_path / "a")
    assert trainer.state.step == 4 and not os.path.exists(tmp_path / "a" / "sample")
    assert capsys.readouterr().out.count("periodic synthesis skipped: no hifigan checkpoint") == 2

    def broken(self, *args, **kwargs):
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(Synthesizer, "tts", broken)
    with pytest.raises(RuntimeError, match="kernel failed"):
        _train(preset, tmp_path / "b")


def test_train_entry_point_warm_start_and_sigterm(setup, tmp_path, monkeypatch):
    """`main.train(init_from=...)` starts from the file's weights; a SIGTERM
    raised in the train loader of the entry point saves ``last`` and
    ``preempt``, returns, and gives the signal handlers back."""
    _, preset = setup
    no_syn = dataclasses.replace(preset, train=dataclasses.replace(preset.train, syn_every=0,
                                                                   epoch=0))
    torch.manual_seed(8)
    source = tts_mod.build_tts(preset.model).state_dict()
    torch.save({"state_dict": source}, tmp_path / "init.pth")
    warm = _train(no_syn, tmp_path / "warm", init_from=str(tmp_path / "init.pth"))
    for k, v in warm.state.model.state_dict().items():
        assert torch.equal(v, source[k]), k

    make_loaders = port_main.make_loaders

    def interrupted(preset, seed):
        train_fn, valid_fn, ds = make_loaders(preset, seed)

        def train_loader():
            for i, batch in enumerate(train_fn()):
                if i == 1:
                    signal.raise_signal(signal.SIGTERM)
                yield batch

        return train_loader, valid_fn, ds

    before = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(port_main, "make_loaders", interrupted)
    stopped = _train(dataclasses.replace(preset, train=dataclasses.replace(preset.train,
                                                                           syn_every=0)),
                     tmp_path / "stop")
    assert stopped.state.step == 1
    assert sorted(os.listdir(tmp_path / "stop" / "ckpt")) == ["last.pth", "preempt.pth"]
    assert signal.getsignal(signal.SIGTERM) == before
    args = port_main.parse_args(["train", "--exp_dir", "x", "--init_from", "ref", "--solver",
                                 "dpmpp2m", "--n_timesteps", "16"])
    assert (args.init_from, args.solver, args.n_timesteps) == ("ref", "dpmpp2m", 16)
    assert port_main.parse_args(["train", "--exp_dir", "x"]).n_timesteps == 50
