"""Port vs JAX package: the data pipeline (items, bucketed batches in the
same order from the same filelist and seed), the ``esd`` preset against
its YAML, and the port's train entry point on a tiny model."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import write_training_set  # noqa: E402
from dex_tts_tpu.config import build_model as jax_build_model  # noqa: E402
from dex_tts_tpu.config import load_preset as jax_load_preset  # noqa: E402
from dex_tts_tpu.data import BucketBatcher as JaxBatcher  # noqa: E402
from dex_tts_tpu.data import TextMelDataset as JaxDataset  # noqa: E402
from dex_tts_tpu_torch import main as port_main  # noqa: E402
from dex_tts_tpu_torch.config import TrainConfig, load_preset  # noqa: E402
from dex_tts_tpu_torch.data import BucketBatcher, TextMelDataset  # noqa: E402
from tests.test_torch_config import assert_same_fields  # noqa: E402
from tests.torch_port_util import tiny_cfg  # noqa: E402

CMU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "resources", "cmu_dictionary")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_training_set(str(tmp_path_factory.mktemp("data")), 14, n_mels=12,
                              frames=(20, 90))


def _assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], str):
            assert got[k] == want[k], k
        else:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("aug", [("N", "N", "N"), ("T", "S", "F")])
def test_items_match_jax(dataset, aug):
    train, _ = dataset
    kw = dict(cmu_path=CMU, load_style=True, aug_types=aug, seed=3)
    got, want = TextMelDataset(train, **kw), JaxDataset(train, **kw)
    assert len(got) == len(want) == 14
    for i in range(len(want)):
        _assert_same(got.eval_item(i), want.eval_item(i))
        assert got.item_lengths(i) == want.item_lengths(i)


@pytest.mark.parametrize("shuffle,prefetch", [(True, 2), (False, 0)])
def test_bucketed_batches_match_jax(dataset, shuffle, prefetch):
    """Same filelist and seed → the same batches in the same order, over
    two epochs (the batcher's rng carries on between them)."""
    train, _ = dataset
    kw = dict(cmu_path=CMU, load_style=True, seed=5)
    bq = dict(batch_size=4, x_quantum=32, y_quantum=64, seed=5, shuffle=shuffle,
              prefetch=prefetch)
    got = BucketBatcher(TextMelDataset(train, **kw), **bq)
    want = JaxBatcher(JaxDataset(train, **kw), **bq)
    assert len(got) == len(want) == 3
    for _ in range(2):
        pairs = list(zip(got, want, strict=True))
        assert len(pairs) == 3
        for g, w in pairs:
            _assert_same(g, w)
            assert g["y"].shape[2] % 64 == 0


def test_esd_preset_equals_yaml():
    """The model, the train block and the 2 s segment (172 frames) of
    dex_tts_tpu/config/presets/esd.yaml."""
    cfg = jax_load_preset("esd")
    preset = load_preset("esd")
    assert_same_fields(preset.model, jax_build_model(cfg))
    tr = cfg.train
    assert preset.train == TrainConfig(
        epoch=tr.epoch, batch_size=tr.batch_size, lr=tr.lr, save_epoch=tr.save_epoch,
        syn_every=tr.syn_every, fix_len=tr.fix_len, out_size=tr.out_size,
        max_grad=tr.max_grad, ema_decay=tr.ema_decay, mask_ratio=tr.mask_ratio,
        ref_type=tr.ref_type, sty_type=tr.sty_type, aug_type=tuple(tr.aug_type),
        unseen_spk=tuple(tr.unseen_spk), x_quantum=tr.x_quantum, y_quantum=tr.y_quantum)
    assert (preset.train_path, preset.val_path) == (cfg.path.train_path, cfg.path.val_path)
    assert (preset.sample_rate, preset.hop_length) == (cfg.preprocess.sample_rate,
                                                       cfg.preprocess.hop_length)
    assert preset.out_size() == 172


def test_train_entry_point_writes_checkpoints(dataset, tmp_path):
    """`python -m dex_tts_tpu_torch.main train` as a function: a tiny DeX
    on the fabricated set, one epoch on the CPU, then a resume."""
    train, valid = dataset
    preset = dataclasses.replace(
        load_preset("esd"), model=tiny_cfg(), train_path=train, val_path=valid, cmu_path=CMU,
        train=TrainConfig(epoch=1, batch_size=7, lr=1e-3, max_grad=5.0, fix_len=0.2,
                          save_epoch=1),
    )
    assert preset.out_size() == 20  # 0.2 s → 17 frames, rounded up to a multiple of 4
    trainer = port_main.train(preset, str(tmp_path), seed=1, device="cpu")
    assert trainer.state.step == 2  # 14 items in batches of 7
    names = sorted(os.listdir(tmp_path / "ckpt"))
    assert {"last.pth", "best-train.pth", "epoch-1.pth"} <= set(names)
    again = port_main.train(preset, str(tmp_path), seed=1, resume=True, device="cpu")
    assert again.state.step == 2 + 2
    with pytest.raises(SystemExit):
        port_main.parse_args(["train"])  # --exp_dir is required
    args = port_main.parse_args(["train", "--exp_dir", "x", "--train_path", "a.txt"])
    assert (args.preset, args.seed, args.train_path) == ("esd", 100, "a.txt")
