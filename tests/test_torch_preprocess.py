"""Port vs JAX package: corpus preprocessing (`preprocess/`), on a seeded
corpus of each layout the JAX package reads (LJSpeech, VCTK, ESD,
LibriTTS). Both packages run prepare_align + Preprocessor + make_filelist
into the same directories in turn: transcripts, emotion labels, speaker
map, filelists, WAVs and lf0 files are byte-equal; the log-mels (float32
FFTs of two libraries) agree within MEL_REL of the largest mel value. The CLI resolves its device
before it writes anything. The pinyin text frontend equals the JAX
package's."""

import io
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import SENTENCES, speech_like, write_int16_wav, write_vctk_corpus  # noqa: E402
from dex_tts_tpu.preprocess import filelists as jfilelists  # noqa: E402
from dex_tts_tpu.preprocess import preprocessor as jpre  # noqa: E402
from dex_tts_tpu.preprocess import text_frontend as jfront  # noqa: E402
from dex_tts_tpu_torch.preprocess import __main__ as cli  # noqa: E402
from dex_tts_tpu_torch.preprocess import filelists, preprocessor, text_frontend  # noqa: E402

# mel bound: float32 FFTs of two libraries, compared in the linear domain
# relative to the utterance's largest mel value, since log(clamp(x, 1e-5))
# magnifies differences near the clamp (measured: 2.6e-7 here; the
# log-mels themselves differ by up to 8.5e-5)
MEL_REL = 1e-5


def write_ljspeech(root, rng):
    os.makedirs(os.path.join(root, "wavs"))
    lines = []
    for i in range(4):
        base = f"LJ001-{i:04d}"
        if i != 2:  # a metadata row without its wav is skipped
            write_int16_wav(os.path.join(root, "wavs", base + ".wav"), speech_like(rng, 22050),
                            22050)
        lines.append(f"{base}|raw {i}|{SENTENCES[i]}" if i != 3 else f"{base}|{SENTENCES[i]}")
    with open(os.path.join(root, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")


def write_vctk(root, rng):
    write_vctk_corpus(root, n_speakers=2, n_utts=2, seed=int(rng.integers(1 << 30)))
    # a mic suffix is dropped from the name; a wav without a transcript is skipped
    os.rename(os.path.join(root, "wav48", "p225", "p225_002.wav"),
              os.path.join(root, "wav48", "p225", "p225_002_mic1.wav"))
    write_int16_wav(os.path.join(root, "wav48", "p226", "p226_009.wav"),
                    speech_like(rng, 48000), 48000)


def write_esd(root, rng):
    for s, spk in enumerate(("0011", "0012")):
        meta = []
        for e, emotion in enumerate(("Neutral", "Happy")):
            d = os.path.join(root, spk, emotion, "train")
            os.makedirs(d)
            for k in range(2):
                base = f"{spk}_{350 * e + k + 1:06d}"
                write_int16_wav(os.path.join(d, base + ".wav"), speech_like(rng, 16000), 16000)
                meta.append(f"{base}\t{SENTENCES[4 * s + 2 * e + k]}\t{emotion}")
        # ESD's metadata files start with a byte-order mark
        with open(os.path.join(root, spk, f"{spk}.txt"), "w", encoding="utf-8-sig") as f:
            f.write("\n".join(meta) + "\n")


def write_libritts(root, rng):
    for spk, chap in (("19", "198"), ("26", "495")):
        d = os.path.join(root, "train-clean-100", spk, chap)
        os.makedirs(d)
        for utt in range(2):
            base = f"{spk}_{chap}_{utt:06d}_000000"
            write_int16_wav(os.path.join(d, base + ".wav"), speech_like(rng, 24000), 24000)
            suffix = ".normalized.txt" if utt == 0 else ".original.txt"
            with open(os.path.join(d, base + suffix), "w", encoding="utf-8") as f:
                f.write(SENTENCES[int(spk) % 7 + utt] + "\n")
    # a numeric FILE at the root must not flip the layout detection
    with open(os.path.join(root, "123"), "w") as f:
        f.write("not a speaker directory\n")


LAYOUTS = {"LJSpeech": (write_ljspeech, {}),
           "VCTK": (write_vctk, {"n_random_unseen": 1}),
           "ESD": (write_esd, {"unseen_speakers": [1]}),
           "LibriTTS": (write_libritts, {"min_frames": 10})}


def _snapshot(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _run(pkg, make, dataset, work, corpus, filelist_kw):
    cfg = pkg.PreprocessConfig(corpus_path=corpus, raw_path=os.path.join(work, "raw"),
                               out_path=os.path.join(work, "pre"))
    pkg.prepare_align(dataset, cfg)
    proc = pkg.Preprocessor(cfg) if pkg is jpre else pkg.Preprocessor(cfg, device="cpu")
    rows = proc.build_from_path()
    counts = make(rows, os.path.join(work, "fl"), dataset=dataset, **filelist_kw)
    return rows, counts, _snapshot(work)


@pytest.mark.parametrize("dataset", sorted(LAYOUTS))
def test_preprocessing_equals_jax(dataset, tmp_path):
    write, filelist_kw = LAYOUTS[dataset]
    corpus = str(tmp_path / "corpus")
    os.makedirs(corpus)
    write(corpus, np.random.default_rng(sorted(LAYOUTS).index(dataset)))
    work = str(tmp_path / "work")
    rows_j, counts_j, files_j = _run(jpre, jfilelists.make_filelist, dataset, work, corpus,
                                     filelist_kw)
    shutil.rmtree(work)
    rows_p, counts_p, files_p = _run(preprocessor, filelists.make_filelist, dataset, work, corpus,
                                     filelist_kw)
    assert rows_p == rows_j and counts_p == counts_j
    assert sorted(files_p) == sorted(files_j)
    n_mels = 0
    for rel, data in files_j.items():
        if rel.startswith(os.path.join("pre", "mel")):
            mel_j, mel_p = _npy(data), _npy(files_p[rel])
            assert mel_p.shape == mel_j.shape and mel_p.shape[1] == 80, rel
            lin_j = np.exp(mel_j.astype(np.float64))
            err = np.abs(np.exp(mel_p.astype(np.float64)) - lin_j).max() / lin_j.max()
            assert err <= MEL_REL, (rel, err)
            n_mels += 1
        else:  # .lab/.emo, WAVs, lf0, speakers.txt, filelists
            assert files_p[rel] == data, rel
    assert n_mels == len(rows_j) >= 3
    lines = files_p[os.path.join("fl", "train.txt")].decode().splitlines()
    assert all(len(line.split("|")) == (4 if dataset == "ESD" else 3) for line in lines)


def _npy(data: bytes) -> np.ndarray:
    return np.load(io.BytesIO(data))


def test_cli_equals_the_steps_and_raises_without_cuda(tmp_path, monkeypatch):
    """`python -m dex_tts_tpu_torch.preprocess`: the root preprocess.py's
    flags plus --device; the device is resolved before anything is
    written (no card: RuntimeError unless --device cpu)."""
    corpus = str(tmp_path / "corpus")
    write_vctk_corpus(corpus, n_speakers=2, n_utts=3)
    argv = ["--dataset", "VCTK", "--corpus_path", corpus, "--raw_path", str(tmp_path / "raw"),
            "--out_path", str(tmp_path / "pre"), "--filelist_dir", str(tmp_path / "fl"),
            "--n_random_unseen", "1", "--seed", "3"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv)
    assert not os.path.exists(tmp_path / "raw") and not os.path.exists(tmp_path / "pre")
    rows, counts = cli.main(argv + ["--device", "cpu"])
    assert len(rows) == 6 and counts["test_unseen"] == 3
    assert counts["train"] + counts["valid"] + counts["test"] == 3
    with open(tmp_path / "pre" / "speakers.txt") as f:
        assert f.read() == "p225|0\np226|1\n"
    args = cli.parse_args(["--dataset", "ESD", "--corpus_path", "c"])
    assert (args.raw_path, args.out_path, args.sample_rate, args.seed, args.device) == (
        "./raw_data", "./preprocessed", 22050, 100, None)


@pytest.mark.parametrize("text", [
    "Hello, world!",
    "{HH AH0 L OW1} there {@sil} friend.",
    "ni3 hao3 {n i3 h ao3 sp} {zh ong1 g uo2 rr}",
    "Mixed {AA1 @spn sil} text; with {b ian4} pinyin.",
])
def test_text_frontend_equals_jax(text):
    assert text_frontend.symbols == jfront.symbols
    seq = text_frontend.text_to_sequence(text)
    assert seq == jfront.text_to_sequence(text)
    assert text_frontend.sequence_to_text(seq) == jfront.sequence_to_text(seq)
    assert text_frontend.clean_text(text) == jfront.clean_text(text)
    with pytest.raises(ValueError, match="Unknown cleaner"):
        text_frontend.clean_text(text, ("no_such_cleaner",))
