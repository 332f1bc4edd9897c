"""Port vs JAX package, the training slice as a whole: `compute_loss` of a
tiny DeX (every loss term and every parameter's gradient, with the JAX
draws replayed and a mel planted along a known alignment; GeDEX's is in
test_torch_gedex.py), the train step, checkpoints that the JAX package's
loader reads, and a resume that repeats the next step exactly."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dex_tts_tpu.convert import dex_tts_torch_to_flax, load_torch_trainer_checkpoint  # noqa: E402
from dex_tts_tpu_torch.models import tts as tts_mod  # noqa: E402
from dex_tts_tpu_torch.ops import mas  # noqa: E402
from dex_tts_tpu_torch.train import CheckpointManager, Trainer, create_train_state  # noqa: E402
from dex_tts_tpu_torch.train.trainer import make_train_step, metrics_to_host  # noqa: E402
from tests.torch_port_util import (  # noqa: E402
    assert_grads_match,
    build_pair,
    loss_and_grads,
    planted_batch,
    port_inputs,
    style_inputs,
    t,
    tiny_cfg,
)

B, TX, TY, OUT = 2, 9, 32, 16
# "flash": on the CPU the port's flash route is the plain attention under
# autograd, and the JAX package's its einsum
CFG = tiny_cfg(dit=dict(attention="flash"))
# gradients: f32 sums in another order through ~40 layers (largest error
# seen 2e-5 of the bound's scale)
GRAD_REL = 2e-4
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    return build_pair(CFG)


@pytest.fixture(scope="module")
def loss_run(pair):
    """One JAX value_and_grad compile: (JAX losses, JAX grads by port
    name, port losses, port model holding its grads)."""
    model, variables, port = pair
    inputs, draws, key, _ = planted_batch(port, CFG, B, TX, TY, OUT)
    want, want_grads, got = loss_and_grads(model, variables, port, CFG, inputs, draws, key, OUT)
    return want, want_grads, got, port


def test_losses_match_jax(loss_run):
    want, _, got, _ = loss_run
    assert sorted(got) == sorted(want) == ["diff_loss", "dur_loss", "prior_loss", "vq_loss"]
    for k in want:
        np.testing.assert_allclose(got[k].item(), want[k], rtol=LOSS_RTOL, err_msg=k)


def test_every_gradient_matches_jax(loss_run):
    """Per tensor within 2e-4 × (max|g_jax| + 1e-3 × the largest gradient)."""
    _, want_grads, _, port = loss_run
    assert assert_grads_match(port, want_grads, GRAD_REL) == len(list(port.parameters())) > 100


def test_shifted_path_moves_the_losses(pair, monkeypatch):
    """The comparison would see a wrong alignment: the same inputs with
    the MAS path shifted by one frame move dur_loss and prior_loss by far
    more than the tolerance."""
    _, _, port = pair
    inputs, draws, _, _ = planted_batch(port, CFG, B, TX, TY, OUT)
    kw = dict(out_size=OUT, train=False, draws={k: t(v) for k, v in draws.items()})
    with torch.no_grad():
        want = port.compute_loss(**port_inputs(inputs), **kw)
        monkeypatch.setattr(tts_mod, "maximum_path", lambda v, m, return_errors: (
            torch.roll(mas.maximum_path(v, m), 1, dims=2) * m, torch.zeros(())))
        shifted = port.compute_loss(**port_inputs(inputs), **kw)
    for k in ("dur_loss", "prior_loss"):
        assert abs(shifted[k].item() - want[k].item()) > 100 * LOSS_RTOL * abs(want[k].item())


def _tiny_state(seed=0):
    torch.manual_seed(seed)
    model = tts_mod.build_tts(CFG)
    return CFG, create_train_state(model, seed=seed, lr=1e-3, max_grad=1.0)


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, 30, (4, TX)).astype(np.int32)
    batch = dict(x=x, x_lengths=np.asarray([TX, 7, 5, TX], np.int32),
                 y=rng.standard_normal((4, cfg.n_feats, TY)).astype(np.float32),
                 y_lengths=np.asarray([TY, 20, 27, 14], np.int32),
                 spk=np.zeros(4, np.int32))
    batch.update(style_inputs(rng, 4, TY, lengths=[TY, 20, 27, 14]))
    return batch


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_updates_everything(accum_steps):
    """One train-mode step: finite metrics, the raw sum of the terms as
    total, the pre-clip global norm, and every piece of state moved
    (weights, Adam, EMA, BatchNorm running statistics, VQ codebook)."""
    cfg, state = _tiny_state()
    model = state.model
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ema_before = {k: v.clone() for k, v in state.ema.items()}
    step = make_train_step(out_size=OUT, ema_decay=0.9, accum_steps=accum_steps)
    metrics = metrics_to_host(step(state, _batch(cfg)))
    assert state.step == 1
    assert all(np.isfinite(v) for v in metrics.values())
    terms = ("vq_loss", "dur_loss", "diff_loss", "prior_loss")
    np.testing.assert_allclose(metrics["total_loss"], sum(metrics[k] for k in terms), rtol=1e-6)
    assert metrics["grad_norm"] > 0
    after = model.state_dict()
    for name in ("encoder.emb.weight", "tiv_encoder.in_conv.bn.running_mean",
                 "tv_encoder.vq.embedding", "tv_encoder.vq.ema_count"):
        assert not torch.equal(after[name], before[name]), name
    assert not torch.equal(state.ema["encoder.emb.weight"], ema_before["encoder.emb.weight"])
    assert len(state.optimizer.state) == len(list(model.parameters()))


def test_train_steps_repeat_from_the_generator():
    """The state's generator alone decides dropout, segments and noise."""
    runs = []
    for _ in range(2):
        cfg, state = _tiny_state(seed=3)
        step = make_train_step(out_size=OUT)
        runs.append([metrics_to_host(step(state, _batch(cfg, seed=s))) for s in (1, 2)])
    assert runs[0] == runs[1]


def test_checkpoint_loads_in_the_jax_package(pair, tmp_path):
    """A port checkpoint in the reference trainer layout goes through the
    JAX package's `load_torch_trainer_checkpoint` + `dex_tts_torch_to_flax`
    back to the variables it came from; the EMA entry too."""
    model, variables, port = pair
    state = create_train_state(port, seed=0)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(state, "last", scores={"epoch": 1})
    sd, ema = load_torch_trainer_checkpoint(ckpt.path("last"))
    for got in (dex_tts_torch_to_flax(sd, model), dex_tts_torch_to_flax(ema, model)):
        flat_want = jax.tree_util.tree_leaves_with_path(variables)
        flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(flat_got) == len(flat_want)
        for path, want in flat_want:
            np.testing.assert_array_equal(np.asarray(flat_got[path]), np.asarray(want))
    raw = torch.load(ckpt.path("last"), weights_only=True)
    assert sorted(raw) == ["ema", "generator", "optimizer", "scores", "state_dict", "step"]


def test_wait_reraises_a_failed_background_write(tmp_path, monkeypatch):
    from dex_tts_tpu_torch.train import checkpoint

    _, state = _tiny_state()
    ckpt = CheckpointManager(str(tmp_path), async_save=True)

    def broken(payload, path):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint, "_write", broken)
    ckpt.save_many(state, ["best-train", "last"])
    with pytest.raises(RuntimeError, match="checkpoint write failed") as info:
        ckpt.wait()
    assert isinstance(info.value.__cause__, OSError)
    ckpt.wait()  # reported once
    monkeypatch.undo()
    ckpt.save_many(state, ["best-train", "last"])
    ckpt.wait()
    assert os.path.isfile(ckpt.path("best-train")) and os.path.isfile(ckpt.path("last"))


def test_fit_saves_tags_and_resume_repeats_the_next_step(tmp_path):
    cfg, state = _tiny_state(seed=4)
    batches = [_batch(cfg, seed=s) for s in (5, 6)]
    trainer = Trainer(state, str(tmp_path), out_size=OUT, save_epoch=2, async_ckpt=True)
    trainer.fit(lambda: iter(batches[:1]), lambda: iter(batches[1:]), epochs=2)
    names = sorted(os.listdir(tmp_path / "ckpt"))
    assert names == ["best-train.pth", "best-val.pth", "epoch-2.pth", "last.pth"]
    assert state.step == 2
    log = (tmp_path / "log.txt").read_text().splitlines()
    assert len(log) == 2 and log[1].startswith("epoch 2 | ") and " | val " in log[1]
    # the next step, straight on and after a resume from "last"
    next_batch = _batch(cfg, seed=7)
    step = make_train_step(out_size=OUT)
    want = metrics_to_host(step(state, next_batch))
    _, fresh = _tiny_state(seed=99)
    trainer.ckpt.restore(fresh, "last")
    assert fresh.step == 2
    got = metrics_to_host(step(fresh, next_batch))
    assert got == want
    for (name, p), q in zip(state.model.named_parameters(), fresh.model.parameters()):
        assert torch.equal(p, q), name
