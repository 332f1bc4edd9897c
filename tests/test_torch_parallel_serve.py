"""Port vs JAX package: data and tensor parallelism outside the DeX train
step. `Synthesizer.tts` over dp2 and dp1×tp2 against one process (the
twin of tests/test_pipeline.py's mesh tests), the vocoder GAN step over
dp2 against one process (the twin of tests/test_vocoder_train.py's dp
test), and the port's `BucketBatcher(process_count=2)` against the JAX
package's single-process batches (the twin of tests/test_train.py::
test_process_sharded_batcher). Two gloo ranks on the CPU run every
case's rank side in one launch (the `synth_setup` fixture)."""

import concurrent.futures
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import write_training_set  # noqa: E402
from dex_tts_tpu.data import BucketBatcher as JaxBatcher  # noqa: E402
from dex_tts_tpu.data import TextMelDataset as JaxDataset  # noqa: E402
from dex_tts_tpu_torch import parallel  # noqa: E402
from dex_tts_tpu_torch.audio.stft import MelSpectrogram  # noqa: E402
from dex_tts_tpu_torch.data import BucketBatcher, TextMelDataset  # noqa: E402
from dex_tts_tpu_torch.models.edm import SamplerConfig  # noqa: E402
from dex_tts_tpu_torch.models.tts import build_tts  # noqa: E402
from dex_tts_tpu_torch.models.vocoder import BigVGANConfig  # noqa: E402
from dex_tts_tpu_torch.models.vocoder.discriminators import DiscriminatorConfig  # noqa: E402
from dex_tts_tpu_torch.pipeline import Synthesizer  # noqa: E402
from dex_tts_tpu_torch.train import vocoder as ptv  # noqa: E402
from tests import torch_parallel_ranks as ranks  # noqa: E402
from tests.torch_port_util import BIGVGAN_TINY, tiny_cfg  # noqa: E402

CFG = tiny_cfg()
CMU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "resources", "cmu_dictionary")
TEXTS = ["one", "two three", "four five six"]


def launch(fn, *args):
    return parallel.launch(fn, 2, args=args, devices=["cpu", "cpu"], timeout=240)


SHARDINGS = [(1, True), (1, False), (2, True)]  # (tp size, pad_batches)
DISC = dict(mpd_periods=(2, 3), mrd_resolutions=((64, 16, 32),), channel_mult=0.125)
MEL = dict(n_fft=64, hop_length=8, win_length=64, n_mels=12)
MAKE_VOCODER_STATE = functools.partial(ptv.create_vocoder_train_state,
                                       BigVGANConfig(**BIGVGAN_TINY), DiscriminatorConfig(**DISC),
                                       seed=0, device="cpu")


def _wav():
    rng = np.random.default_rng(0)
    tt = np.arange(256) / 22050.0
    return (0.5 * np.sin(2 * np.pi * rng.uniform(200, 800, (4, 1)) * tt)
            + 0.05 * rng.standard_normal((4, 256))).astype(np.float32)


@pytest.fixture(scope="module")
def synth_setup():
    """The weights, the style features, and the rank side of every case
    (each sharding's synthesis, then the vocoder step) from one launch of
    two ranks, in the background while the tests build their one-process
    references: → (weights, features, {sharding: results per rank},
    ``vocoder()`` → the vocoder step's results per rank)."""
    torch.manual_seed(7)
    state_dict = build_tts(CFG).state_dict()
    rng = np.random.default_rng(1)
    feats = [(rng.standard_normal((CFG.n_feats, 20)).astype(np.float32),
              rng.standard_normal(20).astype(np.float32)) for _ in TEXTS]
    calls = [(ranks.synthesize, (CFG, state_dict, TEXTS, feats, *s)) for s in SHARDINGS]
    calls.append((ranks.vocoder_step, (MAKE_VOCODER_STATE, MEL, _wav())))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(launch, ranks.sequence, calls)

        def synthesis(sharding):
            i = SHARDINGS.index(sharding)
            return [r[i] for r in future.result()]

        yield state_dict, feats, synthesis, lambda: [r[-1] for r in future.result()]


@pytest.mark.parametrize("tp_size,pad_batches", SHARDINGS)
def test_sharded_synthesis_matches_one_process(synth_setup, tp_size, pad_batches):
    """dp2 (three sentences: padded to 4 rows by the power of two, or
    without it by the dp multiple) and dp1×tp2 (the RetNet and DiT
    matmuls split) give the one-process mels on every rank."""
    state_dict, feats, synthesis, _ = synth_setup
    model = build_tts(CFG)
    model.load_state_dict(state_dict)
    one = Synthesizer(model, None, sampler=SamplerConfig(num_steps=2), device="cpu",
                      x_quantum=8, y_quantum=16, pad_batches=pad_batches)
    want = one.tts(TEXTS, generator=torch.Generator().manual_seed(5), ref_feats=feats)
    got = synthesis((tp_size, pad_batches))
    for r in got:
        assert (r["shard_count"] > 0) == (tp_size > 1)
        assert r["n_frames"] == [w["n_frames"] for w in want]
        for mel, w in zip(r["mels"], want):
            # f32 rounding: the CPU's convolutions block a batch of 2 and
            # one of 4 differently (largest difference seen 3.1e-5)
            np.testing.assert_allclose(mel, w["mel"], atol=1e-4)


def test_dp2_vocoder_step_matches_one_process(synth_setup):
    """A tiny BigVGAN (snakes under autograd) against MPD/MRD: the dp2
    step on 2 × 2 rows gives the one-process step's losses on the 4 rows,
    and both optimizers' summed gradients."""
    state = MAKE_VOCODER_STATE()
    want = ptv.make_vocoder_train_step(MelSpectrogram(**MEL))(state, {"wav": _wav()})
    grads = {f"gen.{n}": p.grad.numpy() for n, p in state.generator.named_parameters()}
    grads.update({f"critics.{n}": p.grad.numpy() for n, p in state.critics.named_parameters()})
    top = max(np.abs(g).max() for g in grads.values())
    for r in synth_setup[3]():
        assert sorted(r["metrics"]) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(r["metrics"][k], v.item(), rtol=1e-4, err_msg=k)
        for n, g in grads.items():
            np.testing.assert_allclose(r["grads"][n], g, rtol=0,
                                       atol=1e-3 * (np.abs(g).max() + 1e-3 * top), err_msg=n)


def test_process_sharded_batcher_matches_jax(tmp_path):
    """``process_count=2``: each process's batch is its half of the JAX
    package's single-process batch, in the same order, at the global
    batch's bucket shapes."""
    train, _ = write_training_set(str(tmp_path), 14, n_mels=12, frames=(20, 90))
    kw = dict(batch_size=4, x_quantum=8, y_quantum=16, seed=3, prefetch=0)
    ds = dict(cmu_path=CMU, load_style=True, seed=3)
    want = list(JaxBatcher(JaxDataset(train, **ds), **kw))
    shards = [list(BucketBatcher(TextMelDataset(train, **ds), process_count=2,
                                 process_index=i, **kw)) for i in range(2)]
    assert len(want) == len(shards[0]) == len(shards[1]) == 3
    for w, a, b in zip(want, *shards):
        assert sorted(a) == sorted(b) == sorted(w)
        for k in w:
            assert a[k].shape == b[k].shape and a[k].shape[0] == w[k].shape[0] // 2, k
            np.testing.assert_array_equal(np.concatenate([a[k], b[k]]), w[k], err_msg=k)
