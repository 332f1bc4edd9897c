"""The port's bench tooling: the FLOP count and MFU (`utils/mfu.py`), the
profiler's trace (`utils/profiling.py`) and the full-size entry
(`entry.py`), on the CPU.
The FLOP formulas of what the counter cannot see (the kernels, cuDNN's
RNN) are held against the count of what the CPU computes instead."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from dex_tts_tpu_torch.models import dit as pdit  # noqa: E402
from dex_tts_tpu_torch.models.edm import SamplerConfig  # noqa: E402
from dex_tts_tpu_torch.models.tts import build_tts  # noqa: E402
from dex_tts_tpu_torch.ops.attention import attention_flops, attention_reference  # noqa: E402
from dex_tts_tpu_torch.ops.snake import snake_antialias_reference, snake_flops  # noqa: E402
from dex_tts_tpu_torch.utils import mfu  # noqa: E402
from dex_tts_tpu_torch.utils import profiling  # noqa: E402
from dex_tts_tpu_torch.utils.profiling import span, trace  # noqa: E402
from tests.torch_port_util import style_inputs, t, tiny_cfg  # noqa: E402


def test_count_of_one_matmul():
    a, b = torch.randn(3, 5), torch.randn(5, 7)
    assert mfu.count_flops(torch.matmul, a, b) == 2 * 3 * 5 * 7
    assert mfu.count_flops(lambda: mfu.kernel_flops(a, 1234)) == 1234
    # what a kernel wrapper calls: counted under a count, nothing outside one
    assert mfu.count_flops(lambda: mfu.note_kernel_flops(a, 1234)) == 1234
    mfu.note_kernel_flops(a, 1234)


DIT = dict(hidden_size=32, num_heads=2, mlp_ratio=2.0, depth=1, in_channels=8, grid_h=2)


def _block_inputs(b=2, n=40, d=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, n, d, generator=g), torch.randn(b, d, generator=g)


def test_dit_block_count_by_hand():
    """qkv, the attention's two products, proj, the MLP and adaLN's
    modulation, 2 FLOPs per multiply-add; nothing else."""
    b, n, d, h = 2, 40, 32, 2
    blk = pdit.DiTBlock(pdit.DiTConfig(**DIT, attention="einsum"))
    x, c = _block_inputs(b, n, d)
    hidden = int(d * DIT["mlp_ratio"])
    want = (2 * b * n * d * 3 * d + 4 * b * h * n * n * (d // h) + 2 * b * n * d * d
            + 2 * 2 * b * n * d * hidden + 2 * b * d * 6 * d)
    with torch.no_grad():
        assert mfu.count_flops(blk, x, c) == want


def _block_count(attention, backward, dtype="float32"):
    torch.manual_seed(0)
    blk = pdit.DiTBlock(pdit.DiTConfig(**DIT, attention=attention, dtype=dtype))
    x, c = _block_inputs()
    x.requires_grad_(backward)

    def run():
        out = blk(x, c, train=backward)
        if backward:
            out.float().sum().backward()

    return mfu.count_flops(run)


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "train"])
def test_count_does_not_depend_on_the_attention_route(backward):
    counts = {a: _block_count(a, backward) for a in ("einsum", "flash", "flash_bf16")}
    assert len(set(counts.values())) == 1, counts
    assert _block_count("flash_bf16", backward, "bfloat16") == counts["einsum"]


def test_train_step_count_does_not_depend_on_the_attention_route():
    """A tiny DeX train step (forward, backward, clip, Adam, EMA: the
    updates count 0) counts the same under "einsum" and "flash_bf16"."""
    from dex_tts_tpu_torch.train import create_train_state, make_train_step
    from tests.torch_port_util import planted_batch

    counts = {}
    for attention in ("einsum", "flash_bf16"):
        cfg = tiny_cfg(dit=dict(attention=attention))
        torch.manual_seed(0)
        state = create_train_state(build_tts(cfg), seed=0, lr=1e-3, max_grad=1.0)
        batch = planted_batch(state.model, cfg)[0]
        step = make_train_step(out_size=16)
        counts[attention] = mfu.count_flops(step, state, batch)
    assert counts["einsum"] == counts["flash_bf16"] > 0


def test_attention_formula_is_the_plain_versions_count():
    """What the kernel wrappers count on the card (`attention_flops`, twice
    it for the backward) is what autograd through the plain version counts
    on the CPU."""
    b, t_, h, hd = 2, 37, 2, 16
    q, k, v = (torch.randn(b, t_, h, hd, requires_grad=True) for _ in range(3))
    with torch.no_grad():
        fwd = mfu.count_flops(attention_reference, q, k, v, hd**-0.5)
    both = mfu.count_flops(lambda: attention_reference(q, k, v, hd**-0.5).sum().backward())
    assert fwd == attention_flops(b, t_, h, hd)
    assert both - fwd == 2 * attention_flops(b, t_, h, hd)


@pytest.mark.parametrize("k", [8, 12, 16])
def test_snake_formula_is_the_plain_versions_count(k):
    x, alpha, inv_beta = torch.randn(2, 37, 5), torch.rand(5), torch.rand(5)
    assert mfu.count_flops(snake_antialias_reference, x, alpha, inv_beta, k) == snake_flops(
        2, 37, 5, k)


@pytest.mark.parametrize("layers,batch_first,x_grad", [(1, True, False), (2, True, True),
                                                      (2, False, False)])
def test_cudnn_rnn_formulas_are_the_cpu_cells_count(layers, batch_first, x_grad):
    """cuDNN's fused GRU (what the card runs) counts what the CPU's
    decomposed cells count, forward and backward."""
    gru = torch.nn.GRU(5, 7, layers, batch_first=batch_first, bidirectional=True)
    shape = (3, 11, 5) if batch_first else (11, 3, 5)
    x = torch.randn(*shape, requires_grad=x_grad)
    with torch.no_grad():
        fwd = mfu.count_flops(gru, x)
    both = mfu.count_flops(lambda: gru(x)[0].sum().backward())
    common = (shape, None, 0, None, None, None, 3, 7, 0, layers, batch_first, 0.0, True, True, [])
    assert fwd == mfu._cudnn_rnn_formula(*common)
    assert both - fwd == mfu._cudnn_rnn_backward_formula(
        *common[:6], None, None, None, None, *common[6:], None, None, [x_grad, False, False, True])


@pytest.fixture(scope="module")
def tiny_dex():
    torch.manual_seed(0)
    cfg = tiny_cfg(dit=dict(attention="auto", auto_flash_min_tokens=16))
    model = build_tts(cfg)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(1, 30, (2, 9))).long()
    style = {k: t(v, torch.long) if v.dtype.kind == "i" else t(v)
             for k, v in style_inputs(rng, 2, 11).items()}
    return model, x, torch.tensor([9, 6]), style


@pytest.mark.parametrize("solver,dit_cache", [("euler", 1), ("heun", 1), ("dpmpp2m", 1),
                                              ("euler", 2)])
def test_extrapolated_count_equals_the_direct_count(tiny_dex, solver, dit_cache):
    model, x, x_lengths, style = tiny_dex

    def at(steps):
        @torch.no_grad()
        def run():
            model.synthesize(x, x_lengths, y_max_length=32, generator=torch.Generator().manual_seed(1),
                             sampler=SamplerConfig(num_steps=steps, solver=solver,
                                                   dit_cache_interval=dit_cache), **style)
        return run

    steps = 8
    assert mfu.extrapolated_scan_flops(at, steps, unit=dit_cache) == mfu.count_flops(at(steps))
    with pytest.raises(ValueError, match="whole units"):
        mfu.extrapolated_scan_flops(at, 7, unit=2)


def test_no_peak_and_no_mfu_without_a_known_card(monkeypatch):
    assert mfu.peak_flops_per_chip("cpu") is None
    assert mfu.mfu(1e12, 1.0, "cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, peak in [("NVIDIA H100 80GB HBM3", 989.4e12), ("NVIDIA H100 PCIe", 756e12),
                       ("NVIDIA A100-SXM4-80GB", None)]:
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None, n=name: n)
        assert mfu.peak_flops_per_chip("cuda") == peak
        assert mfu.peak_flops_per_chip("cpu") is None
        assert mfu.mfu(peak or 1.0, 2.0, "cuda") == (0.5 if peak else None)


def test_trace_writes_a_chrome_trace(tmp_path):
    """The trace turns the program's spans on inside it, and only there."""
    with profiling.tracing(False):
        with trace(str(tmp_path / "prof")) as prof:
            with span("the_span"):
                torch.randn(8, 8) @ torch.randn(8, 8)
        assert not profiling.TRACING
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "prof")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "the_span" and e.get("cat") == "user_annotation"
               for e in events)
    assert profiling.calls()[-1].root.name == "the_span"


def test_entry_builds_at_full_width_on_the_cpu():
    """The full-size DeX and its inputs (not run: full widths are too
    heavy for a CPU test); its DiT takes K1's route on the card."""
    from dex_tts_tpu_torch.config import load_preset
    from dex_tts_tpu_torch.entry import B, T_REF, TX, TY, entry

    fn, args = entry("cpu")
    x, x_lengths, ref, ref_lengths, sty, sty_lengths, lf0, lf0_lengths = args
    assert x.shape == (B, TX) == (2, 64) and x_lengths.tolist() == [64, 64]
    assert ref.shape == sty.shape == (2, 80, T_REF) and lf0.shape == (2, T_REF)
    assert ref_lengths.tolist() == sty_lengths.tolist() == lf0_lengths.tolist() == [T_REF] * 2
    assert all(a.device.type == "cpu" for a in args) and callable(fn)
    dit_cfg = load_preset("vctk_bench").model.dit_config()
    tokens = pdit.token_count(dit_cfg, TY // 2)
    assert tokens == 1300 and pdit.resolve_attention_mode(dit_cfg, tokens) == "flash_bf16"


def test_entry_refuses_without_cuda(monkeypatch):
    from dex_tts_tpu_torch.entry import entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()


def test_plain_attention_on_the_cpu_calls_no_kernel_marker():
    """On the CPU the flash route's plain version is counted as itself: no
    `kernel_flops` call adds the kernel's count a second time."""
    calls = []
    mapping = {**mfu.FORMULAS,
               torch.ops.dex_tts_torch.kernel_flops: lambda *a, **k: calls.append(a) or 0}
    torch.manual_seed(0)
    blk = pdit.DiTBlock(pdit.DiTConfig(**DIT, attention="flash_bf16"))
    with torch.no_grad(), FlopCounterMode(display=False, custom_mapping=mapping) as counter:
        blk(*_block_inputs())
    assert calls == [] and counter.get_total_flops() == _block_count("einsum", False)
