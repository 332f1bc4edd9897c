"""Port vs JAX package: the objective evaluation (`run_objective_eval`) and
the `main test` action. Both packages' evaluations run with their
`load_synthesizer` replaced by a stub that returns the same mel and WAV
per sentence, on one preprocessed corpus, with the same fake ASR and
speaker scorer (after tests/test_e2e_train.py's eval check): the reports
agree within 1e-6 and the same files are written, byte for byte. With
the random-init GE2E encoder of each package instead of the fake, the
speaker cosines agree within 1e-4 (the encoders agree within rtol 2e-4 /
atol 2e-5, tests/test_torch_speaker.py). Then `python -m
dex_tts_tpu_torch.main test --device cpu` on a tiny preset writes the
WAVs and the report, and a missing tag raises."""

import dataclasses
import os
import sys
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import write_vctk_corpus  # noqa: E402
from dex_tts_tpu.data import TextMelDataset as JaxTextMelDataset  # noqa: E402
from dex_tts_tpu.eval import evaluation as jeval  # noqa: E402
from dex_tts_tpu.eval import metric as jmetric  # noqa: E402
from dex_tts_tpu.utils import Config  # noqa: E402
from dex_tts_tpu_torch import main as port_main  # noqa: E402
from dex_tts_tpu_torch.config import PRESETS, Preset  # noqa: E402
from dex_tts_tpu_torch.eval import evaluation  # noqa: E402
from dex_tts_tpu_torch.eval import metric, speaker  # noqa: E402
from dex_tts_tpu_torch.models import tts as tts_mod  # noqa: E402
from dex_tts_tpu_torch.models.vocoder import HiFiGANConfig, HiFiGANGenerator  # noqa: E402
from dex_tts_tpu_torch.preprocess import __main__ as preprocess_cli  # noqa: E402
from dex_tts_tpu_torch.preprocess.filelists import make_filelist  # noqa: E402
from dex_tts_tpu_torch.preprocess.preprocessor import PreprocessConfig, Preprocessor  # noqa: E402
from dex_tts_tpu_torch.train import create_train_state  # noqa: E402
from dex_tts_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from tests.test_torch_train_hooks import HIFIGAN_TINY  # noqa: E402
from tests.torch_port_util import tiny_cfg  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CMU = os.path.join(REPO, "resources", "cmu_dictionary")


def stub_output(text: str) -> dict:
    """The mel and WAV both stubs return for ``text``."""
    rng = np.random.default_rng(zlib.crc32(text.encode()))
    t = 60 + len(text) % 40
    return {"mel": (rng.standard_normal((80, t)) - 5.0).astype(np.float32),
            "wav": (0.2 * rng.standard_normal(t * 256)).astype(np.float32), "n_frames": t}


class StubSynth:
    device = torch.device("cpu")

    def __init__(self):
        self.calls = []

    def tts(self, texts, temperature, ref_feats=None, **noise):
        (text,) = texts
        self.calls.append((text, temperature, ref_feats))
        return [stub_output(text)]


class FakeASR:
    available = True

    def transcribe(self, wav, sample_rate=22050):
        return "the quick brown fox" if len(wav) % 2 else "hello there friend"


class FakeSpeaker:
    """A cosine that depends on both WAVs, so a wrong one shows."""

    available = True

    def __init__(self):
        self.calls = []

    def cosine(self, wav_a, wav_b, sample_rate=22050):
        self.calls.append((len(wav_a), len(wav_b), sample_rate))
        n = min(len(wav_a), len(wav_b))
        a, b = np.asarray(wav_a[:n], np.float64), np.asarray(wav_b[:n], np.float64)
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A seeded VCTK-layout corpus preprocessed by the port's CLI on the
    CPU → the held-out speaker's filelist (3 items)."""
    root = tmp_path_factory.mktemp("eval_corpus")
    write_vctk_corpus(str(root / "corpus"), n_speakers=2, n_utts=3)
    preprocess_cli.main(["--dataset", "VCTK", "--corpus_path", str(root / "corpus"),
                         "--raw_path", str(root / "raw"), "--out_path", str(root / "pre"),
                         "--filelist_dir", str(root / "fl"), "--n_random_unseen", "1",
                         "--device", "cpu"])
    return str(root / "fl" / "test_unseen.txt")


def _eval_files(exp_dir):
    d = os.path.join(exp_dir, "eval")
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("scorer", ["fake", "random-init"])
def test_objective_eval_equals_jax(corpus, tmp_path, monkeypatch, capsys, scorer):
    jstub, pstub = StubSynth(), StubSynth()
    jds = JaxTextMelDataset(corpus, cmu_path=CMU, add_blank=True, load_style=True)
    monkeypatch.setattr(jeval, "load_synthesizer", lambda *a, **k: (jstub, jds))
    monkeypatch.setattr(evaluation, "load_synthesizer", lambda *a, **k: pstub)
    cfg = Config({"path": {"val_path": corpus}, "test": {"temperature": 1.3}})
    preset = Preset(model=tiny_cfg(n_feats=80), val_path=corpus, cmu_path=CMU, temperature=1.3)
    if scorer == "fake":
        jspk, pspk = FakeSpeaker(), FakeSpeaker()
    else:
        jspk = jmetric.SpeakerScorer(backend="random-init")
        pspk = metric.SpeakerScorer(backend="random-init", device="cpu")
    want = jeval.run_objective_eval(cfg, str(tmp_path / "jax"), sample_size=8, asr=FakeASR(),
                                    spk_scorer=jspk)
    got = evaluation.run_objective_eval(preset, str(tmp_path / "port"), sample_size=8,
                                        asr=FakeASR(), spk_scorer=pspk, device="cpu")
    assert sorted(got) == sorted(want) == ["cer", "cos", "mcd", "mel_mae", "wer"]
    tol = {"cos": 1e-4} if scorer == "random-init" else {}
    for name, (mean, se) in want.items():
        assert abs(got[name][0] - mean) <= tol.get(name, 1e-6), (name, got[name], want[name])
        assert abs(got[name][1] - se) <= tol.get(name, 1e-6), (name, got[name], want[name])
    # the same items, in the same order, with the same style and temperature
    assert len(pstub.calls) == len(jstub.calls) == 3
    for (pt, ptemp, pref), (jt, jtemp, jref) in zip(pstub.calls, jstub.calls):
        assert pt == jt and ptemp == jtemp == 1.3
        np.testing.assert_array_equal(pref[0][0], jref[0][0])  # ref mel
        np.testing.assert_array_equal(pref[0][1], jref[0][1])  # lf0
    if scorer == "fake":
        assert pspk.calls == jspk.calls and all(a > 0 and b > 0 for a, b, _ in pspk.calls)
    jfiles, pfiles = _eval_files(str(tmp_path / "jax")), _eval_files(str(tmp_path / "port"))
    assert sorted(pfiles) == sorted(jfiles) == sorted(
        [f"{i:03d}_{k}.wav" for i in range(3) for k in ("syn", "ref")] + ["report.txt"])
    for name, data in jfiles.items():
        if name != "report.txt" or scorer == "fake":
            assert pfiles[name] == data, name
    assert "mcd: " in capsys.readouterr().out


def test_gt_wav_path_equals_jax():
    for path in ("/d/pre/mel/p225/p225-mel-p225_001.npy", "/d/wav/p225/x.wav", "/d/mel/x.npy",
                 "", "relative/mel/s/s-mel-a-mel-b.npy"):
        assert evaluation.gt_wav_path(path) == jeval.gt_wav_path(path)


@pytest.fixture(scope="module")
def tiny_setup(tmp_path_factory, corpus):
    """A tiny DeX (12 mels) saved as ``best-train`` through
    `CheckpointManager`, a tiny HiFi-GAN as ``gen_last.pth``, a GE2E state
    dict from `init_params`, and the corpus preprocessed at 12 mels →
    (preset, exp_dir, the held-out speaker's filelist, GE2E .pt)."""
    root = tmp_path_factory.mktemp("eval_tiny")
    corpus_dir = os.path.join(os.path.dirname(os.path.dirname(corpus)), "raw")
    cfg = PreprocessConfig(raw_path=corpus_dir, out_path=str(root / "pre"), n_mels=12)
    rows = Preprocessor(cfg, device="cpu").build_from_path()
    make_filelist(rows, str(root / "fl"), n_random_unseen=1)
    torch.manual_seed(4)
    model = tts_mod.build_tts(tiny_cfg())
    CheckpointManager(str(root / "exp" / "ckpt")).save(create_train_state(model), "best-train")
    os.makedirs(root / "voc")
    torch.save(HiFiGANGenerator(HiFiGANConfig(**HIFIGAN_TINY)).state_dict(),
               root / "voc" / "gen_last.pth")
    torch.save({"model_state": {k: torch.from_numpy(v)
                                for k, v in speaker.init_params(seed=5).items()}},
               root / "ge2e.pt")
    preset = Preset(model=tiny_cfg(), vocoder=HiFiGANConfig(**HIFIGAN_TINY), cmu_path=CMU,
                    vocoder_path=str(root / "voc"), n_mels=12)
    return preset, str(root / "exp"), str(root / "fl" / "test_unseen.txt"), str(root / "ge2e.pt")


def test_main_test_action_on_the_cpu(tiny_setup, monkeypatch, capsys):
    preset, exp_dir, filelist, ge2e = tiny_setup
    monkeypatch.setitem(PRESETS, "tiny_eval", lambda: preset)
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setitem(sys.modules, "transformers", None)  # as on the card: no ASR
    argv = ["test", "--preset", "tiny_eval", "--test_checkpoint", exp_dir, "--val_path", filelist,
            "--sample_size", "2", "--n_timesteps", "2", "--spk_encoder", ge2e, "--device", "cpu"]
    report = port_main.main(argv)
    assert sorted(report) == ["cos", "mcd", "mel_mae"]
    assert all(np.isfinite(v).all() for v in report.values())
    assert report["mcd"][0] > 0 and -1.0 <= report["cos"][0] <= 1.0
    files = sorted(os.listdir(os.path.join(exp_dir, "eval")))
    assert files == ["000_ref.wav", "000_syn.wav", "001_ref.wav", "001_syn.wav", "report.txt"]
    with open(os.path.join(exp_dir, "eval", "report.txt")) as f:
        lines = f.read().splitlines()
    assert [line.split(":")[0] for line in lines] == ["mel_mae", "mcd", "cos"]
    assert " ± " in lines[0] and lines[0] in capsys.readouterr().out
    with pytest.raises(FileNotFoundError, match="no checkpoint for tag 'nope'"):
        port_main.main(argv + ["--tag", "nope"])
    # text only (--test_file) with a GeDEX, from a reference-format .pth:
    # the eval directory goes beside the file
    gedex = dataclasses.replace(preset, model=tiny_cfg(use_style=False))
    monkeypatch.setitem(PRESETS, "tiny_eval_gedex", lambda: gedex)
    root = os.path.dirname(exp_dir)
    os.makedirs(os.path.join(root, "gedex"))
    pth = os.path.join(root, "gedex", "model-last.pth")
    torch.save({"state_dict": tts_mod.build_tts(gedex.model).state_dict()}, pth)
    sentences = os.path.join(root, "sentences.txt")
    with open(sentences, "w") as f:
        f.write("Hello there.\n\nGood morning.\nA third line.\n")
    report = port_main.main(["test", "--preset", "tiny_eval_gedex", "--test_checkpoint", pth,
                             "--test_file", sentences, "--sample_size", "2", "--n_timesteps", "2",
                             "--device", "cpu"])
    assert report == {}
    assert sorted(os.listdir(os.path.join(root, "gedex", "eval"))) == [
        "000_syn.wav", "001_syn.wav", "report.txt"]
    args = port_main.parse_args(["test", "--test_checkpoint", "x"])
    assert (args.tag, args.sample_size, args.n_timesteps, args.solver, args.dit_cache_interval,
            args.spk_encoder, args.random_init) == ("best-train", 10, 50, "euler", 1, None, False)


def test_missing_val_filelist_raises(tiny_setup, tmp_path):
    preset, exp_dir, _, _ = tiny_setup
    missing = dataclasses.replace(preset, val_path=str(tmp_path / "none.txt"))
    with pytest.raises(FileNotFoundError, match="needs the val filelist"):
        evaluation.run_objective_eval(missing, exp_dir, device="cpu")
