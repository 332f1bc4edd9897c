"""The port's own spans and counters (`utils/profiling.py`), on the CPU:
off by default and then free of records, the span tree of one tiny
`Synthesizer.tts` call, outputs bit for bit the same with tracing on and
off, the spans on the profiler's clock, the ``cast_bytes`` counter
against an independent count, the bound on the record and one stack per
thread."""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.overrides import TorchFunctionMode  # noqa: E402

from dex_tts_tpu_torch.models.dit import DiTConfig  # noqa: E402
from dex_tts_tpu_torch.models.edm import SamplerConfig  # noqa: E402
from dex_tts_tpu_torch.models.tts import TTSConfig, build_tts  # noqa: E402
from dex_tts_tpu_torch.models.vocoder import (  # noqa: E402
    BigVGANConfig,
    BigVGANGenerator,
    HiFiGANConfig,
    HiFiGANGenerator,
)
from dex_tts_tpu_torch.pipeline import Synthesizer  # noqa: E402
from dex_tts_tpu_torch.utils import profiling  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FEATS = 16
TEXTS = ["Printing, in the only sense.", "It differs.", "From most arts."]
SAMPLERS = {
    "euler": dict(num_steps=3),
    "heun": dict(num_steps=3, solver="heun"),
    "dpmpp2m": dict(num_steps=3, solver="dpmpp2m"),
    "dit_cache": dict(num_steps=4, dit_cache_interval=2),
}


def _tts_cfg(style: bool, dtype: str) -> TTSConfig:
    dit = DiTConfig(patch_size=3, stride_size=2, hidden_size=32, depth=1, num_heads=2,
                    mlp_ratio=2.0, conv_pos=4, conv_pos_groups=2)
    return TTSConfig(
        n_vocab=149, n_feats=N_FEATS, enc_channels=16, enc_filter_channels=24,
        enc_filter_channels_dp=10, enc_heads=2, enc_layers=1, dec_dim=8, dec_dim_mults=(1, 2),
        tv_c_h=10, tv_c_out=16, tv_c_out_g=14, tv_layers=1, tv_n_emb=8, lf0_c_h=8,
        lf0_c_out=16, lf0_c_out_g=14, lf0_layers=1, tiv_c_h=16, tiv_c_out=6, tiv_layers=1,
        use_style=style, dit=dit, compute_dtype=dtype)


def _synth(family: str, dtype: str = "float32", **sampler) -> Synthesizer:
    """A tiny DeX + HiFi-GAN ("dex") or GeDEX + BigVGAN ("gedex") on the CPU,
    with every parameter drawn, so that no zero-initialised branch hides."""
    torch.manual_seed(0)
    model = build_tts(_tts_cfg(family == "dex", dtype))
    if family == "dex":
        voc = HiFiGANGenerator(HiFiGANConfig(
            num_mels=N_FEATS, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
            upsample_initial_channel=16, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 3, 5),), dtype=dtype))
    else:
        voc = BigVGANGenerator(BigVGANConfig(
            num_mels=N_FEATS, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
            upsample_initial_channel=16, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 3, 5),), dtype=dtype, snake_logscale=False))
    with torch.no_grad():
        for p in list(model.parameters()) + list(voc.parameters()):
            p.add_(0.05 * torch.randn_like(p))
    return Synthesizer(model, voc, sampler=SamplerConfig(**(sampler or SAMPLERS["euler"])),
                       device="cpu")


def _call(syn: Synthesizer, **kwargs) -> list:
    rng = np.random.default_rng(5)
    feats = None
    if syn.model.cfg.use_style:
        feats = [(rng.standard_normal((N_FEATS, n)).astype(np.float32) * 0.5,
                  rng.standard_normal(n).astype(np.float32)) for n in (30, 41, 25)]
    return syn.tts(TEXTS, generator=torch.Generator().manual_seed(7), ref_feats=feats, **kwargs)


@pytest.fixture(scope="module")
def dex():
    return _synth("dex")


@pytest.fixture(scope="module")
def traced_call(dex):
    with profiling.tracing():
        _call(dex)
    return profiling.calls()[-1]


def _children(call, span):
    return [s for s in call.spans if s.parent == span.id]


def test_tracing_starts_off_in_a_fresh_interpreter():
    code = ("import dex_tts_tpu_torch.pipeline\nfrom dex_tts_tpu_torch.utils import profiling\n"
            "print(profiling.TRACING, len(profiling.calls()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["False", "0"]


def test_off_records_nothing(dex):
    with profiling.tracing(False):
        before = profiling.calls()
        assert profiling.span("a") is profiling.span("b", torch.device("cpu"), index=1)
        with profiling.span("a") as rec:
            profiling.count("cast_bytes", 4)
            profiling.note(x=1)
        assert rec is None
        _call(dex)
        after = profiling.calls()
    assert len(after) == len(before) and all(a is b for a, b in zip(after, before))


def test_a_tts_call_gives_the_span_tree(traced_call):
    call = traced_call
    root = call.root
    assert root.name == "tts" and root.parent is None and root.call == root.id
    assert root.attrs == {"batch": 3, "padded_batch": 4, "steps": 3, "solver": "euler",
                          "text_bucket": root.attrs["text_bucket"],
                          "frame_bucket": root.attrs["frame_bucket"]}
    assert root.attrs["text_bucket"] % 32 == 0 and root.attrs["frame_bucket"] % 64 == 0
    assert all(s.call == root.id for s in call.spans)
    ids = {s.id for s in call.spans}
    assert all(s.parent in ids for s in call.spans[1:])
    assert [s.name for s in _children(call, root)] == [
        "tts.prep", "tts.prepass", "tts.text_to_mel", "tts.vocoder", "tts.readback"]
    t2m = next(s for s in call.spans if s.name == "tts.text_to_mel")
    parts = _children(call, t2m)
    assert [s.name for s in parts] == ["text_to_mel.encode"] + ["sampler.step"] * 3
    assert [s.attrs["index"] for s in parts[1:]] == [0, 1, 2]
    assert parts[1].attrs["sigma"] == pytest.approx(80.0)
    for step in parts[1:]:
        (den,) = _children(call, step)
        (dit,) = _children(call, den)
        assert (den.name, dit.name, _children(call, dit)) == ("denoiser", "dit", [])
    for s in call.spans:
        assert s.t0 <= s.t1 and (s.parent is None or call.spans[0].t0 <= s.t0)
        # device spans read the host clock on the CPU; host-only spans have none
        host_only = s.name in ("tts", "tts.prep", "tts.prepass", "tts.readback")
        assert (s.device_s is None) == host_only
        assert host_only or s.device_s == pytest.approx(s.host_s)


def test_self_times_add_up_to_the_parent(traced_call):
    call = traced_call
    by_name = lambda n: [s for s in call.spans if s.name == n]
    t2m, = by_name("tts.text_to_mel")
    steps, dens, dits = by_name("sampler.step"), by_name("denoiser"), by_name("dit")
    encode, = by_name("text_to_mel.encode")
    step_self = sum(s.device_s for s in steps) - sum(s.device_s for s in dens)
    unet_self = sum(s.device_s for s in dens) - sum(s.device_s for s in dits)
    dit = sum(s.device_s for s in dits)
    assert step_self > 0 and unet_self > 0 and dit > 0
    parts = encode.device_s + step_self + unet_self + dit
    # what is left is the sampler's set-up and the final masking
    assert 0 <= t2m.device_s - parts < 0.05 * t2m.device_s
    # children lie inside their parent on the host clock
    ids = {s.id: s for s in call.spans}
    for s in call.spans[1:]:
        assert ids[s.parent].t0 <= s.t0 <= s.t1 <= ids[s.parent].t1


def test_counters_land_on_the_innermost_span():
    with profiling.tracing():
        with profiling.span("outer") as outer:
            profiling.count("n", 2)
            with profiling.span("inner") as inner:
                profiling.count("n", 3)
                profiling.count("n", 4)
                profiling.note(k="v")
            profiling.count("m", 1)
    profiling.count("n", 100)  # no span open: dropped
    assert outer.counts == {"n": 2, "m": 1} and inner.counts == {"n": 7}
    assert inner.attrs == {"k": "v"} and inner.parent == outer.id == inner.call
    assert profiling.calls()[-1].spans == [outer, inner]


def test_the_record_keeps_the_last_calls():
    with profiling.tracing():
        for i in range(profiling.MAX_CALLS + 6):
            with profiling.span("bounded", index=i):
                pass
    kept = [c for c in profiling.calls() if c.root.name == "bounded"]
    assert len(profiling.calls()) == profiling.MAX_CALLS
    assert len(kept) == profiling.MAX_CALLS
    assert [c.root.attrs["index"] for c in kept] == list(range(6, profiling.MAX_CALLS + 6))


def test_threads_keep_their_own_stacks():
    barrier = threading.Barrier(2, timeout=30)
    roots = {}

    def work(tag):
        with profiling.span(f"root.{tag}") as root:
            barrier.wait()  # both roots are open before either nests
            with profiling.span(f"child.{tag}"):
                barrier.wait()
                profiling.count("n", 1)
        roots[tag] = root

    with profiling.tracing():
        threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    calls = {c.root.name: c for c in profiling.calls()[-2:]}
    for tag in "ab":
        call = calls[f"root.{tag}"]
        assert call.root is roots[tag]
        assert [s.name for s in call.spans] == [f"root.{tag}", f"child.{tag}"]
        assert call.spans[1].parent == call.root.id and call.spans[1].counts == {"n": 1}


@pytest.mark.parametrize("family", ["dex", "gedex"])
@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
def test_outputs_are_the_same_with_tracing_on_and_off(family, sampler):
    syn = _synth(family, **SAMPLERS[sampler])
    with profiling.tracing(False):
        off = _call(syn)
    with profiling.tracing():
        on = _call(syn)
    call = profiling.calls()[-1]
    steps = [s for s in call.spans if s.name == "sampler.step"]
    assert len(steps) == SAMPLERS[sampler]["num_steps"]
    # heun's last step has no correction; the DiT cache reuses the DiT on odd steps
    denoisers = {"euler": 3, "heun": 5, "dpmpp2m": 3, "dit_cache": 4}[sampler]
    assert sum(s.name == "denoiser" for s in call.spans) == denoisers
    assert sum(s.name == "dit" for s in call.spans) == (2 if sampler == "dit_cache" else denoisers)
    assert len(off) == len(on) == 3
    for a, b in zip(off, on):
        assert a.keys() == b.keys() == {"mel", "wav", "n_frames"}
        np.testing.assert_array_equal(a["mel"], b["mel"])
        np.testing.assert_array_equal(a["wav"], b["wav"])


def test_spans_sit_on_the_profilers_clock(dex, tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        _call(dex)
    call = profiling.calls()[-1]
    with open(prof.trace_path) as f:
        chrome = json.load(f)
    base = chrome["baseTimeNanoseconds"]
    events = sorted((e for e in chrome["traceEvents"] if e.get("cat") == "user_annotation"),
                    key=lambda e: (e["ts"], -e["dur"]))
    names = {s.name for s in call.spans}
    events = [e for e in events if e["name"] in names]
    assert len(events) == len(call.spans)

    def enclosing(e):
        inside = [o for o in events if o is not e and o["ts"] <= e["ts"]
                  and e["ts"] + e["dur"] <= o["ts"] + o["dur"]]
        return max(inside, key=lambda o: o["ts"])["name"] if inside else None

    by_id = {s.id: s for s in call.spans}
    worst = 0.0
    for s, e in zip(call.spans, events):  # both in opening order
        assert e["name"] == s.name
        assert enclosing(e) == (by_id[s.parent].name if s.parent else None)
        worst = max(worst, abs(call.wall_ns(s.t0) - (base + e["ts"] * 1e3)))
    assert worst < 0.5e6, worst


@pytest.mark.parametrize("family", ["dex", "gedex"])
def test_cast_bytes_match_an_independent_count(family):
    """The counter against the bytes every `.to` of a parameter to
    another dtype makes, counted by a TorchFunctionMode around one
    denoiser evaluation (× steps) and one vocoder call."""

    class ParameterCasts(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.bytes = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (func is torch.Tensor.to and isinstance(args[0], torch.nn.Parameter)
                    and out.dtype != args[0].dtype):
                self.bytes += out.numel() * out.element_size()
            return out

    syn = _synth(family, dtype="bfloat16")
    seen = {}

    def keep(name):
        return lambda module, args, kwargs: seen.setdefault(name, (args, kwargs))

    hooks = [syn.model.decoder.denoise_fn.register_forward_pre_hook(keep("denoiser"),
                                                                   with_kwargs=True),
             syn.vocoder.register_forward_pre_hook(keep("vocoder"), with_kwargs=True)]
    with profiling.tracing(), ParameterCasts() as whole:
        _call(syn)
    for h in hooks:
        h.remove()
    call = profiling.calls()[-1]
    with torch.no_grad():
        with ParameterCasts() as denoiser:
            syn.model.decoder.denoise_fn(*seen["denoiser"][0], **seen["denoiser"][1])
        with ParameterCasts() as vocoder:
            syn.vocoder(*seen["vocoder"][0], **seen["vocoder"][1])
    counted = lambda names: sum(s.counts.get("cast_bytes", 0) for s in call.spans
                                if s.name in names)
    steps = call.root.attrs["steps"]
    assert denoiser.bytes > 0 and vocoder.bytes > 0
    assert counted(("denoiser", "dit")) == steps * denoiser.bytes
    assert counted(("tts.vocoder",)) == vocoder.bytes
    assert counted({s.name for s in call.spans}) == whole.bytes == (
        steps * denoiser.bytes + vocoder.bytes)


def test_a_tensor_parallel_linear_counts_its_cast(monkeypatch):
    """`TensorParallelLinear` casts its own slice (one rank of one here,
    the collectives stubbed): the bytes of its bf16 weight and bias."""
    from types import SimpleNamespace

    from dex_tts_tpu_torch.parallel import tp

    monkeypatch.setattr(tp._CopyToGroup, "apply", lambda x, group: x)
    monkeypatch.setattr(tp._GatherLast, "apply", lambda x, group, rank, size: x)
    layer = tp.TensorParallelLinear(torch.nn.Linear(6, 10), "column",
                                    SimpleNamespace(tp_group=None, tp_rank=0, tp_size=1))
    with profiling.tracing():
        with profiling.span("root") as root:
            layer(torch.randn(3, 6), torch.bfloat16)
            layer(torch.randn(3, 6), torch.float32)  # no cast: nothing counted
    assert root.counts == {"cast_bytes": (10 * 6 + 10) * 2}
