"""Port vs JAX package: `split_sentences`, `ramp_spans`, and the long-form
paths `Synthesizer.tts_stream` / `tts_long` around a deterministic stub
of `tts` (and of `prepare_reference`) on both sides: chunk order,
``index`` and ``text``, the batch spans, the conditioning each batch gets,
the concatenated waveform with its pauses, and the one generator that
feeds every batch of the port."""

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from dex_tts_tpu.pipeline import Synthesizer as JaxSynthesizer  # noqa: E402
from dex_tts_tpu.pipeline import ramp_spans as jax_ramp_spans  # noqa: E402
from dex_tts_tpu.pipeline import split_sentences as jax_split_sentences  # noqa: E402
from dex_tts_tpu_torch.pipeline import Synthesizer, ramp_spans, split_sentences  # noqa: E402

LONG = ("alpha " * 40 + ", " + "beta " * 40).strip() + "."
SPLIT_CASES = [
    ("One. Two! Three?", 400),
    ("Wait... what?", 400),
    ("Pi is 3.14. Nice.", 400),
    ("!? . Hello.", 400),
    (LONG, 120),
    ("   ", 400),
    ("x" * 50, 10),
    ("Semi; colon: comma, end.  Two  spaces.\nNew line!", 12),
    ("A, b, c, d, e, f, g, h.", 5),
    ("No punctuation at all here", 8),
]


@pytest.mark.parametrize("text,max_chars", SPLIT_CASES)
def test_split_sentences_matches_jax(text, max_chars):
    assert split_sentences(text, max_chars) == jax_split_sentences(text, max_chars)


@settings(max_examples=300, deadline=None)
@given(st.text(alphabet=st.sampled_from(list("ab .,!?;:'-\n3")), max_size=120),
       st.integers(1, 40))
def test_split_sentences_matches_jax_drawn(text, max_chars):
    assert split_sentences(text, max_chars) == jax_split_sentences(text, max_chars)


@pytest.mark.parametrize("n,max_batch,first_batch", [
    (0, 16, 1), (1, 16, 1), (5, 2, 1), (6, 16, 1), (7, 4, 4), (20, 16, 3), (9, 0, 1),
    (9, 4, 0), (9, 4, 9), (33, 8, 2)])
def test_ramp_spans_matches_jax(n, max_batch, first_batch):
    assert ramp_spans(n, max_batch, first_batch) == jax_ramp_spans(n, max_batch, first_batch)


@settings(max_examples=300, deadline=None)
@given(st.integers(0, 100), st.integers(-2, 20), st.integers(-2, 20))
def test_ramp_spans_matches_jax_drawn(n, max_batch, first_batch):
    spans = ramp_spans(n, max_batch, first_batch)
    assert spans == jax_ramp_spans(n, max_batch, first_batch)
    assert [i for lo, hi in spans for i in range(lo, hi)] == list(range(n))


def _feats_key(v):
    return [(np.asarray(m).tolist(), np.asarray(l).tolist()) for m, l in v]


def stub(cls, vocode=True):
    """A Synthesizer of ``cls`` whose `tts` and `prepare_reference` are
    deterministic functions of their inputs; records every call."""
    synth = object.__new__(cls)
    calls = {"tts": [], "prepare_reference": [], "rng": []}

    def tts(texts, key=None, generator=None, **kw):
        calls["rng"].append(generator if cls is Synthesizer else key)
        rec = {k: (_feats_key(v) if k == "ref_feats" else list(v))
               for k, v in kw.items() if v is not None and k in ("spk_ids", "ref_wavs", "ref_feats")}
        rec.update({k: v for k, v in kw.items() if k not in ("spk_ids", "ref_wavs", "ref_feats")})
        calls["tts"].append((list(texts), rec))
        out = []
        for i, text in enumerate(texts):
            r = {"mel": np.full((2, len(text)), i, np.float32), "n_frames": len(text)}
            if vocode:
                r["wav"] = np.linspace(-0.5, 0.5, 5 * len(text) + i, dtype=np.float32)
            out.append(r)
        return out

    def prepare_reference(path):
        calls["prepare_reference"].append(path)
        return (np.full((3, 4), len(path), np.float32), np.arange(4, dtype=np.float32))

    synth.tts = tts
    synth.prepare_reference = prepare_reference
    synth.device = torch.device("cpu")
    return synth, calls


TEXT = ("The first one. Then a second! A third? Fourth; fifth. Sixth sentence here. "
        "And the seventh.")
FEATS = [(np.ones((3, 5), np.float32) * 2, np.zeros(5, np.float32))]
CONDITIONING = {
    "none": {},
    "one_speaker": {"spk_ids": [3]},
    "per_sentence_speakers": {"spk_ids": list(range(7))},
    "one_ref_wav": {"ref_wavs": ["ref.wav"]},
    "per_sentence_ref_wavs": {"ref_wavs": [f"r{i}.wav" for i in range(7)]},
    "one_ref_feats": {"ref_feats": FEATS},
}


def _same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("cond", list(CONDITIONING))
@pytest.mark.parametrize("max_batch,first_batch", [(2, 1), (16, 1), (4, 4), (3, 2)])
def test_tts_stream_matches_jax(cond, max_batch, first_batch):
    """The same batches in the same order with the same per-batch
    conditioning, the same results with ``index`` and ``text``; a single
    reference wav is prepared once; the port hands its one generator to
    every batch."""
    port, port_calls = stub(Synthesizer)
    jsynth, jax_calls = stub(JaxSynthesizer)
    kw = dict(max_batch=max_batch, first_batch=first_batch, temperature=1.1, **CONDITIONING[cond])
    gen = torch.Generator().manual_seed(5)
    got = list(port.tts_stream(TEXT, generator=gen, **kw))
    want = list(jsynth.tts_stream(TEXT, key=jax.random.PRNGKey(5), **kw))
    _same_results(got, want)
    assert [r["index"] for r in got] == list(range(7))
    assert [r["text"] for r in got] == jax_split_sentences(TEXT)
    assert port_calls["tts"] == jax_calls["tts"]
    assert [len(texts) for texts, _ in port_calls["tts"]] == [
        hi - lo for lo, hi in jax_ramp_spans(7, max_batch, first_batch)]
    assert port_calls["prepare_reference"] == jax_calls["prepare_reference"]
    assert len(port_calls["prepare_reference"]) == (1 if cond == "one_ref_wav" else 0)
    assert all(g is gen for g in port_calls["rng"])


def test_tts_stream_default_generator_and_eager_errors():
    """Without a generator the port makes one (seeded 0) and reuses it for
    every batch; an empty text raises at the call on both sides."""
    port, calls = stub(Synthesizer)
    list(port.tts_stream(TEXT, max_batch=2))
    assert len(calls["rng"]) == 4 and all(isinstance(g, torch.Generator) for g in calls["rng"])
    assert len({id(g) for g in calls["rng"]}) == 1
    assert calls["rng"][0].initial_seed() == 0
    jsynth, _ = stub(JaxSynthesizer)
    for synth in (port, jsynth):
        with pytest.raises(ValueError, match="no synthesizable text"):
            synth.tts_stream(" !? ")


@pytest.mark.parametrize("vocode", [True, False])
@pytest.mark.parametrize("pause_ms,max_batch", [(200.0, 16), (50.0, 2), (0.0, 3)])
def test_tts_long_matches_jax(vocode, pause_ms, max_batch):
    """Full batches from the start (no ramp), the waveforms joined with
    ``pause_ms`` of silence; without waveforms only the sentences."""
    port, port_calls = stub(Synthesizer, vocode)
    jsynth, jax_calls = stub(JaxSynthesizer, vocode)
    kw = dict(pause_ms=pause_ms, max_batch=max_batch, ref_wavs=["ref.wav"])
    got = port.tts_long(TEXT, generator=torch.Generator().manual_seed(1), **kw)
    want = jsynth.tts_long(TEXT, key=jax.random.PRNGKey(1), **kw)
    assert sorted(got) == sorted(want) == (["sentences", "wav"] if vocode else ["sentences"])
    _same_results(got["sentences"], want["sentences"])
    assert port_calls["tts"] == jax_calls["tts"]
    assert [len(texts) for texts, _ in port_calls["tts"]] == [
        hi - lo for lo, hi in jax_ramp_spans(7, max_batch, max_batch)]
    assert port_calls["prepare_reference"] == ["ref.wav"]
    if vocode:
        np.testing.assert_array_equal(got["wav"], want["wav"])
        gap = int(22050 * pause_ms / 1e3)
        lens = [len(r["wav"]) for r in got["sentences"]]
        assert got["wav"].shape == (sum(lens) + gap * (len(lens) - 1),)
        assert not got["wav"][lens[0]:lens[0] + gap].any()
