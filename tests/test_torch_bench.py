"""The port's benches against the JAX package's (bench.py, bench_train.py):
the same inputs, flags, defaults, flag errors, vocoder presets and JSON
keys; a tiny run of each on the CPU; and no silent fall-back to the CPU."""

import argparse
import ast
import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bench as jax_bench  # noqa: E402
import bench_train as jax_bench_train  # noqa: E402
from __graft_entry__ import _style_inputs  # noqa: E402
from dex_tts_tpu.models.vocoder import BigVGANConfig as JaxBigVGANConfig  # noqa: E402
from dex_tts_tpu.models.vocoder import HiFiGANConfig as JaxHiFiGANConfig  # noqa: E402
from dex_tts_tpu_torch import bench, bench_train  # noqa: E402
from dex_tts_tpu_torch.config import Preset, load_preset  # noqa: E402
from dex_tts_tpu_torch.models.vocoder import HiFiGANConfig  # noqa: E402
from tests.torch_port_util import tiny_cfg  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOT_PORTED = {"help"}


class _Parsed(Exception):
    pass


def jax_parser(module, monkeypatch) -> argparse.ArgumentParser:
    """The parser a JAX bench's main() builds, caught at its parse_args
    (before anything is built)."""
    caught = {}

    def catch(self, *a, **k):
        caught["parser"] = self
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        m.setattr(sys, "argv", [module.__file__])
        with pytest.raises(_Parsed):
            module.main()
    return caught["parser"]


def flags(parser) -> dict:
    return {a.dest: (a.option_strings, a.default, a.choices, a.type)
            for a in parser._actions if a.dest not in NOT_PORTED}


def json_keys(path: str) -> set:
    """The keys of the dict literal that the script's json.dumps prints."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps"
                and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError(f"no json.dumps of a dict literal in {path}")


def test_bench_inputs_equal_bench_py():
    with open(os.path.join(REPO, "bench.py"), encoding="utf-8") as f:
        src = f.read()
    assert "b, tx, ty, t_ref = args.batch, 96, 768, 256" in src
    assert "np.random.default_rng(1).integers(1, 148, (b, tx))" in src
    assert (bench.TX, bench.TY, bench.T_REF) == (96, 768, 256)
    for b in (3, 16):
        got = bench.bench_inputs(b, "dex")
        np.testing.assert_array_equal(got["x"], np.random.default_rng(1).integers(1, 148, (b, 96)))
        assert got["x"].dtype == np.int32
        np.testing.assert_array_equal(got["x_lengths"], np.full((b,), 96))
        want = _style_inputs(b, 80, 256)
        for k, v in want.items():
            assert got[k].dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
        assert set(bench.bench_inputs(b, "gedex")) == {"x", "x_lengths"}  # GeDEX: no style


def test_train_batch_equals_bench_train_py():
    for kw in (dict(b=32, frames=256), dict(b=3, frames=40, n_feats=12, tx=7)):
        want = jax_bench_train.synthetic_batch(**kw)
        got = bench_train.synthetic_batch(**kw)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("module,port_parser", [
    (jax_bench, bench.build_parser),
    (jax_bench_train, bench_train.build_parser),
], ids=["bench", "bench_train"])
def test_flags_and_defaults_match(module, port_parser, monkeypatch):
    want = flags(jax_parser(module, monkeypatch))
    got = flags(port_parser())
    assert got.pop("device") == (["--device"], "cuda", None, None)
    assert got == want


@pytest.mark.parametrize("argv", [
    ["--dit_cache", "3"],
    ["--dit_cache", "4", "--steps", "16", "--solver", "heun"],
    ["--solver", "dpmpp2m", "--steps", "16", "--dit_cache", "2"],
    ["--vocoder", "wavenet"],
])
def test_flag_errors_match_bench_py(argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["bench.py", *argv])
    with pytest.raises(SystemExit) as want:
        jax_bench.main()
    want_err = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as got:
        bench.parse_args(argv)
    got_err = capsys.readouterr().err.strip().splitlines()[-1]
    assert got.value.code == want.value.code == 2
    assert got_err.split("error: ")[1] == want_err.split("error: ")[1]


@pytest.mark.parametrize("argv", [
    [], ["--vocoder", "bigvgan"], ["--vocoder", "bigvgan", "--vocoder_dtype", "float32",
                                   "--snake_impl", "fold", "--conv_impl", "packed"],
    ["--upsample_impl", "subpixel"],
])
def test_vocoder_preset_matches_bench_py(argv):
    """The JAX bench's vocoder config for the same flags (bench.py:108-125),
    field for field."""
    args = bench.parse_args(argv)
    got = bench.vocoder_config(args)
    dtype = args.vocoder_dtype
    if dtype == "auto":
        dtype = "bfloat16" if args.vocoder == "bigvgan" else "float32"
    if args.vocoder == "bigvgan":
        want = JaxBigVGANConfig(num_mels=80, snake_impl=args.snake_impl, dtype=dtype,
                                upsample_impl=args.upsample_impl, conv_impl=args.conv_impl)
    else:
        want = JaxHiFiGANConfig(num_mels=80, dtype=dtype, upsample_impl=args.upsample_impl)
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


TINY_VOC = dict(num_mels=80, upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
                upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                resblock_dilation_sizes=((1, 3),))


@pytest.mark.parametrize("argv", [
    ["--batch", "2", "--steps", "2"],
    ["--batch", "2", "--steps", "4", "--dit_cache", "2", "--family", "gedex"],
    ["--batch", "2", "--steps", "3", "--solver", "dpmpp2m"],
], ids=["euler", "gedex_dit_cache", "dpmpp2m"])
def test_bench_line_on_cpu(argv, monkeypatch, capsys, tmp_path):
    """A tiny model at an 80-band width through the bench on the CPU
    (asked for), tracing into ``--profile``: one JSON line holding every
    key of bench.py's line, the FLOP count filled and the MFU fields null
    (no card, no peak)."""
    models = {"vctk_bench": tiny_cfg(n_feats=80),
              "gedex_bench": tiny_cfg(n_feats=80, use_style=False)}
    monkeypatch.setattr(bench, "load_preset", lambda name: Preset(model=models[name]))
    monkeypatch.setattr(bench, "vocoder_config", lambda args: HiFiGANConfig(**TINY_VOC))
    monkeypatch.setattr(bench, "TY", 32)
    line = bench.main([*argv, "--device", "cpu", "--profile", str(tmp_path)])
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 1 and printed[0].startswith("{")
    assert json_keys(os.path.join(REPO, "bench.py")) <= set(line)
    assert line["device"] == "cpu" and line["card"] is None and line["vs_baseline"] is None
    # kernels launch on CUDA only
    assert line["launches"] == {"flash_attention": 0, "snake": 0, "group_norm": 0}
    assert line["value"] > 0 and np.isfinite(line["text_to_mel_rtf"])
    assert line["tflops_per_dispatch"] > 0
    assert line["mfu"] is line["mfu_text_to_mel"] is line["peak_tflops"] is None
    assert [p.suffix for p in tmp_path.iterdir()] == [".json"]


def test_bench_train_line_on_cpu(monkeypatch, capsys, tmp_path):
    esd = load_preset("esd")
    monkeypatch.setattr(bench_train, "load_preset",
                        lambda name: dataclasses.replace(esd, model=tiny_cfg(n_feats=80)))
    line = bench_train.main(["--batch", "2", "--frames", "32", "--steps", "1", "--device", "cpu",
                             "--profile", str(tmp_path)])
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 1
    assert json_keys(os.path.join(REPO, "bench_train.py")) <= set(line)
    assert {"peak_mem_gib", "card"} <= set(line) and line["card"] is None
    assert line["launches"] == dict(flash_attention=0, flash_attention_bwd=0, maximum_path=0)
    assert np.isfinite(line["final_loss"]) and line["value"] > 0
    assert line["tflops_per_step"] > 0 and line["mfu"] is line["peak_tflops"] is None
    assert [p.suffix for p in tmp_path.iterdir()] == [".json"]


def test_benches_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (bench.main, bench_train.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([])
