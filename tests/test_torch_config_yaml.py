"""The port's YAML configs (dex_tts_tpu_torch/utils/config.py,
`config.preset_from_config`, ``--config`` on the entry points) against
PyYAML's safe_load and the JAX package's config system."""

import glob
import json
import math
import os

import numpy as np
import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from dex_tts_tpu.config import build_model as jax_build_model  # noqa: E402
from dex_tts_tpu.utils import Config as JaxConfig  # noqa: E402
from dex_tts_tpu.utils import set_experiment as jax_set_experiment  # noqa: E402
from dex_tts_tpu_torch import main as port_main  # noqa: E402
from dex_tts_tpu_torch import serve, synthesize, train_vocoder  # noqa: E402
from dex_tts_tpu_torch import export as port_export  # noqa: E402
from dex_tts_tpu_torch.config import (  # noqa: E402
    TrainConfig,
    build_vocoder,
    load_preset,
    preset_from_config,
)
from dex_tts_tpu_torch.eval.evaluation import load_vocoder  # noqa: E402
from dex_tts_tpu_torch.models.vocoder import BigVGANConfig, HiFiGANConfig  # noqa: E402
from dex_tts_tpu_torch.utils.config import (  # noqa: E402
    Config,
    load_config,
    set_experiment,
    yaml_dump,
    yaml_load,
)
from tests.test_e2e_train import make_corpus, tiny_cfg  # noqa: E402
from tests.test_torch_config import assert_same_fields  # noqa: E402
from tests.torch_port_util import BIGVGAN_TINY  # noqa: E402

PRESET_YAMLS = sorted(glob.glob(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "dex_tts_tpu", "config", "presets", "*.yaml")))
PRESET_NAMES = [os.path.basename(p)[:-5] for p in PRESET_YAMLS]


def same(a, b) -> bool:
    """Equality that holds NaN equal to NaN and tells 1 from 1.0 and True."""
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(same, a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return type(a) is type(b) and a == b


def tiny_yaml(tmp_path, family: str) -> str:
    """tests/test_e2e_train.py's tiny config over a seeded corpus, written by
    PyYAML as the JAX package's Config.dump writes it."""
    cfg = tiny_cfg(make_corpus(str(tmp_path)), family)
    path = str(tmp_path / f"{family}.yaml")
    cfg.dump(path)
    return path


# -- the reader against PyYAML ----------------------------------------------


@pytest.mark.parametrize("path", PRESET_YAMLS, ids=PRESET_NAMES)
def test_reader_equals_safe_load_on_the_presets(path):
    text = open(path).read()
    assert same(yaml_load(text), yaml.safe_load(text))


@pytest.mark.parametrize("family", ["gedex", "dex"])
def test_reader_equals_safe_load_on_the_dumped_tiny_config(tmp_path, family):
    text = open(tiny_yaml(tmp_path, family)).read()
    want = yaml.safe_load(text)
    assert same(yaml_load(text), want)
    assert want["path"]["cmu_path"] is None and want["path"]["vocoder_path"] == ""


EDGE_CASES = [
    "k: 1e-4", "k: 1.0e-4", "k: 1.0e4", "k: -1.5e+3", "k: -.5", "k: .5", "k: 1.", "k: 1_000",
    "k: 0", "k: -0", "k: +5", "k: yes", "k: Yes", "k: YES", "k: yEs", "k: off", "k: Off",
    "k: ON", "k: oN", "k: true", "k: False", "k: N", "k: n", "k: y", "k: Y", "k: ~",
    "k: null", "k: NULL", "k:", "k: ''", 'k: ""', "k: .inf", "k: -.inf", "k: +.inf",
    "k: .nan", "k: .NaN", "k: a b  c", "k: a:b", "k: a#b", "k: x # comment", "k: 'it''s'",
    'k: "tab\\there \\u00e9 \\x41 \\\\ \\""', "k: [N, N, N]", "k: []", "k: {}",
    "k: [1, 2.5, x y, 'q', \"d\", ]", "k: [18, 22,\n  44]  # wrapped",
    "k:\n- - 3\n  - 4\n- 5", "k:\n  - - a\n    - b\n  - []", "- a: 1\n  b: [1, 2]\n- c",
    "k:\n  a:\n  - x\n  - y\n  b: d", "k: foo\n  bar\n\n  baz\nj: 2", "k: 'x\n\n  y z'",
    '"quoted key": 1\n\'single\': 2', "1: int key\ntrue: bool key\n~: null key",
    "? long key\n: value\n? 'a\n\n  b'\n: - 1\n  - 2", "a: 1 # c\n# a comment line\n\nb: 2",
    "k: 1  \n", "k: -x", "k: ?x", "k: :x", "k: http://host:8901/tts",
]


@pytest.mark.parametrize("text", EDGE_CASES)
def test_reader_equals_safe_load_on_the_resolvers_edge_cases(text):
    assert same(yaml_load(text), yaml.safe_load(text)), yaml.safe_load(text)


KEYS = st.text(st.characters(blacklist_categories=("Cs",)), max_size=150)
SCALARS = (st.none() | st.booleans() | st.integers() | st.floats(allow_nan=False)
           | st.text(st.characters(blacklist_categories=("Cs",)), max_size=200)
           | st.sampled_from(["1e-4", "yes", "N", "~", "", "0x1F", "2001-01-01", "- x", "a: b"]))
TREES = st.recursive(SCALARS, lambda inner: st.lists(inner, max_size=4)
                     | st.dictionaries(KEYS, inner, max_size=4), max_leaves=16)


@settings(max_examples=150, deadline=None, suppress_health_check=list(HealthCheck))
@given(st.dictionaries(KEYS, TREES, max_size=6))
def test_reader_reads_back_what_pyyaml_dumps(data):
    """``yaml.safe_dump(..., sort_keys=False)`` of nested dicts of scalars
    and lists (long and multi-line strings folded, complex keys, escapes)
    reads back as safe_load reads it; and `yaml_dump` writes what both
    readers read back equal."""
    text = yaml.safe_dump(data, sort_keys=False)
    want = yaml.safe_load(text)
    assert same(yaml_load(text), want) and same(want, data)
    mine = yaml_dump(data)
    assert same(yaml.safe_load(mine), data) and same(yaml_load(mine), data)


OUT_OF_SUBSET = {
    "anchor": "a: &x 1", "alias": "a: 1\nb: *x", "tag": "a: !!str 1", "literal": "a: |\n  x",
    "folded": "a: >\n  x", "flow mapping": "a: {b: 1}", "flow pair": "a: [b: 1]",
    "merge key": "base: {}\n<<: 1", "octal": "a: 017", "hex": "a: 0x1F", "binary": "a: 0b11",
    "sexagesimal": "a: 1:30", "sexagesimal float": "a: 1:30.5", "timestamp": "a: 2001-01-01",
    "document start": "---\na: 1", "document end": "a: 1\n...", "directive": "%YAML 1.1\na: 1",
    "nested flow": "a: [[1]]", "tab indent": "a:\n\tb: 1", "tab separator": "a: 1\t# c",
    "key and value on one line": "a: b: c", "sequence after a key": "a: - b",
    "bad indentation": "a:\n  - x\n  b: 1", "unterminated quote": "a: 'x",
    "collection key": "? [a]\n: 1",
}


@pytest.mark.parametrize("text", OUT_OF_SUBSET.values(), ids=OUT_OF_SUBSET.keys())
def test_out_of_subset_constructs_raise_with_their_line(text):
    with pytest.raises(ValueError, match=r"<string>, line \d+: "):
        yaml_load(text)


EDGE_DICT = {"s": ["yes", "1e-4", "1.0e-4", "", " lead", "N", "~", "null", "a: b", "#x", "- x",
                   "é\tü\n", "0x1F", "2001-01-01", "tcp://localhost:8901", "x" * 300],
             "n": [0, -3, 10**30, 1e-4, 1e16, -0.0, math.inf, -math.inf, 2.5],
             "b": [True, False, None], "e": {}, "l": [], "nested": [[1, [2, []]], {"a": {}}],
             7: "int key", None: "null key", "multi\nline key": 1}


@pytest.mark.parametrize("name", PRESET_NAMES + ["edge"])
def test_dump_round_trips_through_pyyaml(tmp_path, name):
    data = EDGE_DICT if name == "edge" else yaml.safe_load(
        open(PRESET_YAMLS[PRESET_NAMES.index(name)]).read())
    path = str(tmp_path / "out.yaml")
    Config(data).dump(path)
    text = open(path).read()
    assert same(yaml.safe_load(text), data) and same(yaml_load(text), data)
    assert same(Config(path).to_dict(), data)


def test_config_attribute_access_overrides_and_copy():
    cfg = load_config(PRESET_YAMLS[PRESET_NAMES.index("vctk")],
                      {"train": {"lr": 3e-4}, "vocoder": "bigvgan"})
    assert cfg.model.dit.attention == "auto" and cfg.train.lr == 3e-4 and cfg.train.epoch == 1000
    assert cfg.vocoder == "bigvgan" and cfg.train.aug_type == ["N", "N", "N"]
    cfg.path.vocoder_path = "elsewhere"
    assert cfg["path"]["vocoder_path"] == "elsewhere"
    with pytest.raises(AttributeError):
        cfg.missing
    want = JaxConfig(PRESET_YAMLS[PRESET_NAMES.index("vctk")])
    want.deep_update({"train": {"lr": 3e-4}, "vocoder": "bigvgan"})
    want.path.vocoder_path = "elsewhere"
    assert same(cfg.to_dict(), want.to_dict())


# -- preset_from_config against the JAX package -----------------------------


@pytest.mark.parametrize("name", PRESET_NAMES + ["tiny_gedex", "tiny_dex"])
def test_preset_from_config_equals_jax_build_model(tmp_path, name):
    path = (tiny_yaml(tmp_path, name[5:]) if name.startswith("tiny")
            else PRESET_YAMLS[PRESET_NAMES.index(name)])
    preset = preset_from_config(Config(path))
    assert_same_fields(preset.model, jax_build_model(JaxConfig(path)))
    if name in ("vctk", "esd", "libritts", "gedex_vctk", "gedex_ljspeech"):
        assert preset.model == load_preset(name).model


@pytest.mark.parametrize("name", PRESET_NAMES + ["tiny_gedex", "tiny_dex"])
def test_preset_from_config_reads_what_the_jax_entry_points_read(tmp_path, name):
    """The train block with main.py's defaults and casts, the test block
    (evaluation.py), path, the preprocess section (train_vocoder.py) and
    the vocoder (load_vocoder: kind, n_mels, vocoder_dtype)."""
    path = (tiny_yaml(tmp_path, name[5:]) if name.startswith("tiny")
            else PRESET_YAMLS[PRESET_NAMES.index(name)])
    cfg = JaxConfig(path)
    preset = preset_from_config(Config(path))
    tr, pre, test = cfg.train, cfg.preprocess, cfg.get("test", {})
    assert preset.train == TrainConfig(
        epoch=int(tr.epoch), batch_size=int(tr.batch_size), lr=float(tr.lr),
        save_epoch=int(tr.get("save_epoch", 200)), syn_every=int(tr.get("syn_every", 0)),
        fix_len=tr.get("fix_len", 2), out_size=tr.get("out_size", True),
        max_grad=float(tr.get("max_grad", 1.0)), ema_decay=float(tr.get("ema_decay", 0.9999)),
        mask_ratio=float(tr.get("mask_ratio", 0.0)), ref_type=tr.get("ref_type", "mel"),
        sty_type=tr.get("sty_type", "mel"), aug_type=tuple(tr.get("aug_type", ["N", "N", "N"])),
        unseen_spk=tuple(tr.get("unseen_spk", [])), x_quantum=tr.get("x_quantum", 32),
        y_quantum=tr.get("y_quantum", 64), accum_steps=int(tr.get("accum_steps", 1)),
        async_ckpt=bool(tr.get("async_ckpt", False)))
    assert (preset.ema, preset.n_timesteps, preset.temperature) == (
        bool(test.get("ema", False)), test.get("n_timesteps", 50), test.get("temperature", 1.5))
    assert (preset.train_path, preset.val_path, preset.cmu_path, preset.vocoder_path) == (
        cfg.path.train_path, cfg.path.val_path, cfg.path.get("cmu_path"),
        cfg.path.get("vocoder_path", ""))
    assert preset.add_blank == cfg.model.get("add_blank", True)
    assert (preset.sample_rate, preset.hop_length, preset.n_fft, preset.win_length,
            preset.n_mels, preset.f_min, preset.f_max) == (
        pre.sample_rate, pre.hop_length, pre.n_fft, pre.win_length, pre.n_mels, pre.f_min,
        pre.f_max)
    assert preset.vocoder == HiFiGANConfig(num_mels=pre.n_mels) and preset.vocoder_dtype == "auto"
    assert preset.out_size() == port_main_out_size(cfg)
    big = preset_from_config(load_config(path, {"vocoder": "BigVGAN", "vocoder_dtype": "float32"}))
    assert big.vocoder == BigVGANConfig(num_mels=pre.n_mels) and big.vocoder_dtype == "float32"


def port_main_out_size(cfg):
    """JAX main.py's compute_out_size, which imports the whole JAX CLI."""
    from dex_tts_tpu.ops import fix_len_compatibility

    if not cfg.train.get("out_size", True):
        return None
    return fix_len_compatibility(int(cfg.train.get("fix_len", 2) * cfg.preprocess.sample_rate
                                     / cfg.preprocess.hop_length))


def test_ignored_tpu_keys_are_accepted(tmp_path):
    """The TPU-only lowering keys load (carried into the configs or not
    read) and change nothing that the port runs."""
    path = PRESET_YAMLS[PRESET_NAMES.index("vctk")]
    plain = preset_from_config(Config(path))
    knobs = preset_from_config(load_config(path, {
        "model": {"dit": {"flash_block_q": 256, "flash_block_k": 512, "pos_conv_impl": "dense"},
                  "decoder": {"linattn_impl": "einsum"}},
        "vocoder_upsample_impl": "subpixel", "vocoder_snake_pallas": True,
        "vocoder_snake_impl": "fold"}))
    assert knobs.model.dit.flash_block_q == 256 and knobs.model.linattn_impl == "einsum"
    assert knobs.vocoder == plain.vocoder
    dumped = str(tmp_path / "knobs.yaml")
    Config(load_config(path, {"model": {"dit": {"flash_block_q": 256}}})).dump(dumped)
    assert_same_fields(preset_from_config(Config(dumped)).model,
                       jax_build_model(JaxConfig(dumped)))


# -- experiment directories and the entry points ------------------------------


@pytest.mark.parametrize("tag", [None, "run"])
def test_set_experiment_names_the_jax_directory(tmp_path, tag):
    def cfg(cls, root):
        c = cls(PRESET_YAMLS[PRESET_NAMES.index("esd")])
        c.checkpoint = str(root)
        return c

    for root in (tmp_path / "jax", tmp_path / "port"):
        os.makedirs(root / "ESD-0")
        os.makedirs(root / "other")
    want = jax_set_experiment(cfg(JaxConfig, tmp_path / "jax"), tag=tag)
    got = set_experiment(cfg(Config, tmp_path / "port"), tag=tag)
    assert os.path.relpath(got.exp_dir, tmp_path / "port") == \
        os.path.relpath(want.exp_dir, tmp_path / "jax") == ("ESD-1-run" if tag else "ESD-1")
    assert sorted(os.listdir(got.exp_dir)) == sorted(os.listdir(want.exp_dir))
    base = yaml.safe_load(open(os.path.join(got.exp_dir, "base.yaml")).read())
    assert same(base, yaml.safe_load(open(os.path.join(want.exp_dir, "base.yaml")).read()) | {
        "checkpoint": str(tmp_path / "port"), "exp_dir": got.exp_dir})


def test_main_train_config_creates_the_experiment(tmp_path):
    """``main train --config`` without ``--exp_dir`` takes its step into
    ``{checkpoint}/{dataset}-0-{tag}`` with the config in base.yaml."""
    cfg = tiny_cfg(make_corpus(str(tmp_path)), "gedex")
    cfg.train.epoch, cfg.train.batch_size = 1, 8  # the 8 training items: one step
    path = str(tmp_path / "cfg.yaml")
    cfg.dump(path)
    trainer = port_main.main(["train", "--config", path, "--tag", "t1", "--device", "cpu"])
    exp_dir = os.path.join(cfg.checkpoint, "Tiny-0-t1")
    assert trainer.state.step == 1 and os.listdir(cfg.checkpoint) == ["Tiny-0-t1"]
    assert {"sample", "image", "result", "eval", "ckpt", "base.yaml"} <= set(os.listdir(exp_dir))
    assert os.path.isfile(os.path.join(exp_dir, "ckpt", "last.pth"))
    assert same(yaml.safe_load(open(os.path.join(exp_dir, "base.yaml")).read()),
                cfg.to_dict() | {"exp_dir": exp_dir})


def test_entry_points_take_config_or_preset(tmp_path, capsys):
    path = PRESET_YAMLS[PRESET_NAMES.index("esd")]
    both = ["--config", path, "--preset", "esd"]
    for parse, extra in ((synthesize.parse_args, ["--input_text", "x"]), (serve.parse_args, [])):
        args = parse(["--config", path, "--weight_path", "w"] + extra)
        assert (args.config, args.preset) == (path, None)
        with pytest.raises(SystemExit):
            parse(both + ["--weight_path", "w"] + extra)
        with pytest.raises(SystemExit):  # one of the two is required
            parse(["--weight_path", "w"] + extra)
    with pytest.raises(SystemExit):
        train_vocoder.parse_args(["--data", "d"] + both)
    with pytest.raises(SystemExit):
        port_export.parse_args(both + ["--vocoder"])
    with pytest.raises(SystemExit):  # TTS export needs the experiment
        port_export.parse_args(["--config", path])
    with pytest.raises(SystemExit):
        port_main.parse_args(["train"] + both)
    with pytest.raises(SystemExit):  # --preset has no experiment to create
        port_main.parse_args(["train", "--preset", "esd"])
    args = port_main.parse_args(["train", "--config", path, "--tag", "x"])
    assert (args.exp_dir, args.tag) == (None, "x")
    assert port_main.parse_args(["test", "--config", path, "--test_checkpoint", "e"]).tag \
        == "best-train"
    capsys.readouterr()


def test_train_vocoder_reads_the_preprocess_section(tmp_path):
    """``train_vocoder --config``: the mel parameters as train_vocoder.py
    reads them (the preprocess section, its defaults, ``--sample_rate``
    for a missing rate); nothing else of the config is needed."""
    path = str(tmp_path / "pre.yaml")
    Config({"preprocess": {"sample_rate": 16000, "n_mels": 64, "f_max": 7600}}).dump(path)
    args = train_vocoder.parse_args(["--data", "d", "--config", path, "--sample_rate", "44100"])
    assert train_vocoder.mel_settings(args) == dict(
        n_fft=1024, hop_length=256, win_length=1024, n_mels=64, sample_rate=16000, fmin=0.0,
        fmax=7600.0)
    Config({"preprocess": {}}).dump(path)
    assert train_vocoder.mel_settings(args)["sample_rate"] == 44100
    esd = train_vocoder.parse_args(["--data", "d", "--config",
                                    PRESET_YAMLS[PRESET_NAMES.index("esd")]])
    assert train_vocoder.mel_settings(esd) == train_vocoder.mel_settings(
        train_vocoder.parse_args(["--data", "d", "--preset", "esd"]))


@pytest.mark.parametrize("dtype", ["auto", "float32", "bfloat16"])
def test_load_vocoder_takes_the_config_dtype(tmp_path, dtype):
    torch.manual_seed(0)
    gen = build_vocoder(BigVGANConfig(**BIGVGAN_TINY), device="cpu")
    torch.save(gen.state_dict(), tmp_path / "gen_last.pth")
    path = str(tmp_path / "cfg.yaml")
    cfg = load_config(PRESET_YAMLS[PRESET_NAMES.index("vctk")],
                      {"vocoder": "bigvgan", "path": {"vocoder_path": str(tmp_path)},
                       "preprocess": {"n_mels": BIGVGAN_TINY["num_mels"]}})
    if dtype != "auto":
        cfg.vocoder_dtype = dtype
    cfg.dump(path)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(BIGVGAN_TINY, f)
    vocoder = load_vocoder(preset_from_config(Config(path)), device="cpu")
    want = "bfloat16" if dtype == "bfloat16" else "float32"  # "auto": f32 on the CPU
    assert vocoder.cfg.dtype == want
    mel = torch.randn(1, BIGVGAN_TINY["num_mels"], 8, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y = vocoder(mel).float()
        ref = gen(mel)
    assert np.isfinite(y.numpy()).all()
    assert torch.equal(y, ref) if want == "float32" else \
        (y - ref).abs().max().item() <= 5e-2 * ref.abs().max().item()
