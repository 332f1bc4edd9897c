"""The U-Net Block's epilogue (ops/group_norm.py): the route of each call
(K5 on the card, the plain ops everywhere else), the plain path held bit
for bit against the U-Net's unfused order, the kernel's chunks, and its
arithmetic and indexing (csrc/group_norm.cu) emulated in numpy against
the plain version."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dex_tts_tpu_torch.models import unet  # noqa: E402
from dex_tts_tpu_torch.models.layers import run_in  # noqa: E402
from dex_tts_tpu_torch.models.tts import build_tts  # noqa: E402
from dex_tts_tpu_torch.ops import group_norm as gn  # noqa: E402
from dex_tts_tpu_torch.ops.group_norm import mish  # noqa: E402
from dex_tts_tpu_torch.utils import profiling  # noqa: E402
from tests.torch_port_util import N_FEATS, tiny_cfg  # noqa: E402

CSRC = Path(gn.__file__).resolve().parent.parent / "csrc" / "group_norm.cu"
H100_SMS = 132
# the benchmark cells' Blocks (batch 16, 768-frame bucket, dec_dim 64,
# dim_mults (1, 2)) and a short serving request (batch 1, 64 frames)
CELL_SHAPES = [(16, 64, 80, 768), (16, 128, 40, 384), (16, 64, 40, 384)]


def _inputs(b=2, c=16, h=6, w=10, dtype=torch.float32, seed=0, tail=3):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(b, c, h, w, generator=g) * 1.7 + 0.4).to(dtype)
    weight = torch.rand(c, generator=g) + 0.5
    bias = torch.randn(c, generator=g) * 0.3
    mask = torch.ones(b, 1, 1, w)
    mask[-1, ..., w - tail:] = 0.0
    shift = torch.randn(b, c, generator=g)
    return x, weight, bias, mask.to(dtype), shift


class CudaLike:
    """A tensor's attributes that `fusable` reads, on a CUDA device."""

    device = torch.device("cuda", 0)

    def __init__(self, t, requires_grad=False):
        self.t, self.requires_grad = t, requires_grad
        self.dtype, self.shape = t.dtype, t.shape

    def dim(self):
        return self.t.dim()

    def is_contiguous(self):
        return self.t.is_contiguous()

    def numel(self):
        return self.t.numel()


def _cuda_like(dtype=torch.bfloat16, grad=(), **kw):
    x, weight, bias, mask, shift = _inputs(dtype=dtype, **kw)
    names = ("h", "weight", "bias", "mask", "shift")
    return [CudaLike(v, n in grad) for n, v in zip(names, (x, weight, bias, mask, shift))]


# --- which path a call takes ------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_shift", [False, True])
def test_cpu_tensors_take_the_plain_path(dtype, with_shift):
    x, weight, bias, mask, shift = _inputs(dtype=dtype)
    shift = shift if with_shift else None
    before = gn.group_norm_mish.launches
    assert not gn.fusable(x, weight, bias, mask, shift)
    got = gn.group_norm_mish(x, weight, bias, mask, shift, groups=4)
    want = gn.group_norm_mish_reference(x, weight, bias, mask, shift, groups=4)
    assert got.dtype == dtype and torch.equal(got, want)
    assert gn.group_norm_mish.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_tensors_at_inference_are_fused(dtype):
    assert gn.fusable(*_cuda_like(dtype), groups=4)
    assert gn.fusable(*_cuda_like(dtype)[:4], None, groups=4)


def test_grad_takes_the_plain_path():
    args = _cuda_like(grad=("weight",))
    with torch.enable_grad():
        assert not gn.fusable(*args, groups=4)
    with torch.no_grad():  # parameters require grad at inference too
        assert gn.fusable(*args, groups=4)
    with torch.enable_grad():
        assert not gn.fusable(*_cuda_like(grad=("h",)), groups=4)
        assert gn.fusable(*_cuda_like(), groups=4)


@pytest.mark.parametrize("case", ["float16", "float64", "channels_last", "cpu_mask",
                                  "groups", "bf16_weight", "mask_shape", "shift_shape"])
def test_unsupported_inputs_take_the_plain_path(case):
    h, weight, bias, mask, shift = _cuda_like()
    if case in ("float16", "float64"):
        h = CudaLike(h.t.to(getattr(torch, case)))
    elif case == "channels_last":
        h = CudaLike(h.t.to(memory_format=torch.channels_last))
    elif case == "cpu_mask":
        mask = mask.t
    elif case == "bf16_weight":
        weight = CudaLike(weight.t.bfloat16())
    elif case == "mask_shape":
        mask = CudaLike(mask.t[:, :, :, :-1])
    elif case == "shift_shape":
        shift = CudaLike(shift.t[:, :-1])
    assert gn.fusable(h, weight, bias, mask, shift, groups=4) == (case == "groups")
    if case == "groups":
        assert not gn.fusable(h, weight, bias, mask, shift, groups=3)


def test_a_mask_row_beyond_shared_memory_takes_the_plain_path():
    w = gn.MAX_DYNAMIC_SMEM // 4
    h = CudaLike(torch.empty(1, 8, 1, w, dtype=torch.bfloat16))
    p = CudaLike(torch.empty(8))
    assert not gn.fusable(h, p, p, CudaLike(torch.empty(1, 1, 1, w)), None, groups=8)
    assert gn.fusable(CudaLike(torch.empty(1, 8, 1, w // 2, dtype=torch.bfloat16)), p, p,
                      CudaLike(torch.empty(1, 1, 1, w // 2)), None, groups=8)


def _denoiser(dtype):
    cfg = tiny_cfg(compute_dtype=dtype)
    assert tuple(cfg.dec_dim_mults) == (1, 2)  # 13 Blocks, as in the benchmark's models
    torch.manual_seed(0)
    return build_tts(cfg).decoder.denoise_fn


def _denoise(fn, b=2, w=24, seed=3):
    g = torch.Generator().manual_seed(seed)
    mask = (torch.arange(w)[None] < torch.tensor([w, w - 4])[:, None]).float()[:, None]
    return fn(torch.randn(b, N_FEATS, w, generator=g), mask,
              torch.randn(b, N_FEATS, w, generator=g), torch.rand(b, generator=g),
              ref=(torch.randn(b, 2, 16, generator=g), torch.rand(b, 2, 16, generator=g) + 0.5),
              sty=torch.randn(b, 5, 16, generator=g), sty_lengths=torch.tensor([5, 3]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocks_plain_counts_13_per_denoiser_call(dtype):
    fn = _denoiser(dtype)
    with torch.no_grad(), profiling.tracing():
        _denoise(fn)
        _denoise(fn)
    calls = profiling.calls()[-2:]
    for call in calls:
        assert call.root.name == "denoiser"
        counts = [s.counts for s in call.spans]
        assert sum(c.get("blocks_plain", 0) for c in counts) == 13
        assert sum(c.get("blocks_fused", 0) for c in counts) == 0
        assert call.root.counts["blocks_plain"] == 13  # on the denoiser's own span
    with torch.no_grad(), profiling.tracing(False):  # off: nothing counted, nothing recorded
        n = len(profiling.calls())
        _denoise(fn)
        assert len(profiling.calls()) == n


# --- the plain path is the U-Net's old order, bit for bit ----------------


def _old_block(block, x, mask, dtype):
    """Block.forward before the epilogue became `group_norm_mish`: the
    U-Net's GroupNorm (f32 statistics, then four passes in dtype), Mish,
    the mask."""
    conv, norm = block.block
    h = run_in(conv, x.to(dtype) * mask.to(dtype), dtype)
    b, c, hh, w = h.shape
    xg = h.reshape(b, norm.num_groups, c // norm.num_groups, hh * w)
    xf = xg.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf**2).mean(dim=(2, 3), keepdim=True) - mean**2
    inv = torch.rsqrt(var + norm.eps)
    out = (xg * inv.to(dtype) - (mean * inv).to(dtype)).reshape(b, c, hh, w)
    out = out * norm.weight.to(dtype)[:, None, None] + norm.bias.to(dtype)[:, None, None]
    return mish(out) * mask.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_with_shift_equals_block_then_add(dtype):
    torch.manual_seed(1)
    block = unet.Block(6, 16, groups=8)
    x, _, _, mask, _ = _inputs(b=3, c=6, h=8, w=12, dtype=dtype, seed=2)
    shift = torch.randn(3, 16)  # the time MLP's output, f32
    with torch.no_grad():
        got = block(x, mask, dtype, shift=shift)
        want = _old_block(block, x, mask, dtype) + shift[:, :, None, None].to(dtype)
        assert got.dtype == dtype and torch.equal(got, want)
        assert torch.equal(block(x, mask, dtype), _old_block(block, x, mask, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", [(8, 16), (16, 16)])
def test_resnet_block_equals_the_unfused_order(dtype, dims):
    torch.manual_seed(2)
    res = unet.ResnetBlock(*dims, time_emb_dim=12, groups=8)
    x, _, _, mask, _ = _inputs(b=2, c=dims[0], h=4, w=10, dtype=dtype, seed=4)
    t_emb = torch.randn(2, 12)
    with torch.no_grad():
        got = res(x, mask, t_emb, dtype)
        h = _old_block(res.block1, x, mask, dtype)
        h = h + res.mlp(t_emb)[:, :, None, None].to(dtype)
        h = _old_block(res.block2, h, mask, dtype)
        skip = run_in(res.res_conv, x * mask, dtype) if dims[0] != dims[1] else x * mask
        assert torch.equal(got, h + skip)


def test_plain_path_keeps_gradients():
    torch.manual_seed(3)
    block = unet.Block(4, 8, groups=4)
    x, _, _, mask, _ = _inputs(b=2, c=4, h=4, w=6, seed=5)
    shift = torch.randn(2, 8, requires_grad=True)
    block(x, mask, torch.float32, shift=shift).sum().backward()
    assert block.block[1].weight.grad is not None and shift.grad is not None
    assert torch.isfinite(block.block[0].weight.grad).all()


# --- the kernel's chunks ---------------------------------------------------


def _chunks(shape, dtype, groups=8):
    b, c, h, w = shape
    vec = gn.vector_width(shape, dtype)
    return gn.two_pass_chunks(b * groups, c // groups * h * w // vec, H100_SMS)


def test_constants_match_the_kernel_source():
    src = CSRC.read_text()
    consts = {m.group(1): m.group(2) for m in re.finditer(r"constexpr int (k\w+) = ([^;]+);", src)}
    assert int(consts["kThreads"]) == gn.THREADS
    assert int(consts["kMaxDynamic"]) == gn.MAX_DYNAMIC_SMEM


def test_the_cells_blocks_chunks():
    """bf16 at the benchmark's shapes: at most 8 loads a thread, and never
    fewer CTAs than two per SM."""
    assert [_chunks(shape, torch.bfloat16) for shape in CELL_SHAPES] == [15, 8, 4]
    assert gn.vector_width(CELL_SHAPES[0], torch.bfloat16) == 8
    assert all(16 * 8 * _chunks(shape, torch.bfloat16) >= 2 * H100_SMS for shape in CELL_SHAPES)


def test_chunks_of_other_shapes():
    assert _chunks(CELL_SHAPES[0], torch.float32) == 30  # f32: twice the loads
    # short batches at a 64-frame bucket spread over the card, one load a thread at least
    assert [_chunks((b, 64, 80, 64), torch.bfloat16) for b in (1, 3, 4)] == [10, 10, 9]
    # a 2048-frame bucket; batch 1 at 768 frames spreads over the card
    assert _chunks((16, 64, 80, 2048), torch.bfloat16) == 40
    assert 8 * _chunks((1, 64, 80, 768), torch.bfloat16) >= 2 * H100_SMS
    assert _chunks((1, 8, 1, 7), torch.float32) == 1
    assert gn.two_pass_chunks(8, 7, H100_SMS) == 1  # at least one load per thread


# --- the kernel's arithmetic and indexing, emulated ---------------------------


def _fast_div(d):
    if d == 1:
        return 1, 0, 0
    log2 = (d - 1).bit_length()
    p = 31 + log2
    return d, ((1 << p) + d - 1) // d, p - 32


def _div(f, n):
    d, mul, shift = f
    return n if d == 1 else ((n.astype(np.uint64) * mul) >> np.uint64(32 + shift)).astype(np.int64)


def _mish_kernel(v):
    e = np.exp(np.minimum(v, 20.0)).astype(np.float32)
    p = e * (e + np.float32(2))
    return np.where(v > 20, v, v * (p / (p + np.float32(2)))).astype(np.float32)


def emulate_kernel(h, weight, bias, mask, shift, groups, eps, chunks, vec):
    """csrc/group_norm.cu in numpy: the slab's chunks as `part_range` cuts
    them, each part's f32 sums added in part order, the per-channel
    coefficients, the element → (channel, frame) split by multiply-high
    division, the exp form of Mish, one rounding."""
    b, c, hh, w = h.shape
    cpg, hw = c // groups, hh * w
    n, np_ = cpg * hw, cpg * hw // vec
    per = -(-np_ // chunks)
    x = h.float().numpy().reshape(b * groups, n)
    m = mask.float().numpy()
    out = np.empty_like(x)
    i = np.arange(n, dtype=np.int64)
    cl = _div(_fast_div(hw), i)
    hw_i = i - cl * hw
    fw = hw_i - _div(_fast_div(w), hw_i) * w
    for slab in range(b * groups):
        bi, g = divmod(slab, groups)
        s = ss = np.float32(0)
        for k in range(chunks):
            seg = x[slab, min(np_, k * per) * vec:min(np_, k * per + per) * vec]
            s = np.float32(s + seg.sum(dtype=np.float32))
            ss = np.float32(ss + (seg * seg).sum(dtype=np.float32))
        mean = np.float32(s / np.float32(n))
        inv = np.float32(1) / np.sqrt(np.float32(ss / np.float32(n) - mean * mean) + np.float32(eps))
        ch = g * cpg + cl
        scale = (inv * weight.numpy()[ch]).astype(np.float32)
        v = ((x[slab] - mean) * scale + bias.numpy()[ch]).astype(np.float32)
        sh = 0 if shift is None else shift.numpy()[bi, ch]
        out[slab] = _mish_kernel(v) * m[bi, 0, 0, fw] + sh
    return torch.from_numpy(out.reshape(h.shape)).to(h.dtype)


def test_kernel_mish_form_matches_torch():
    v = torch.linspace(-60, 60, 200001)
    got = torch.from_numpy(_mish_kernel(v.numpy()))
    torch.testing.assert_close(got, mish(v), rtol=2e-6, atol=1e-30)
    big = torch.tensor([20.0, 20.5, 25.0, 88.0, 1e4])
    assert torch.equal(torch.from_numpy(_mish_kernel(big.numpy())), mish(big))


@pytest.mark.parametrize("shape,groups,chunks", [
    ((2, 16, 6, 10), 4, 8),
    ((2, 16, 6, 10), 4, 5),
    ((3, 8, 5, 7), 8, 3),       # H·W odd: one element per load
    ((1, 8, 1, 8), 8, 8),       # fewer packs than chunks in a slab
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_emulation_matches_the_plain_version(shape, groups, chunks, dtype):
    b, c, hh, w = shape
    x, weight, bias, mask, shift = _inputs(b, c, hh, w, dtype=dtype, seed=7, tail=w // 2)
    mask = torch.cat([mask, torch.zeros_like(mask)], dim=-1)[..., ::2]  # strided, as the U-Net's
    mask[0, ..., -2:] = 0  # lower resolutions
    vec = gn.vector_width(shape, dtype)
    got = emulate_kernel(x, weight, bias, mask, shift, groups, 1e-5, chunks, vec)
    want = gn.group_norm_mish_reference(x.float(), weight, bias, mask.float(), shift, groups)
    # f32: the sums' order and exp's rounding; bf16: one rounding of the
    # result against the plain version's f32 value
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=2**-8, atol=2**-9)
    torch.testing.assert_close(got.float(), want, **tol)
    assert torch.equal(got[mask.expand_as(got) == 0].float(),
                       shift[:, :, None, None].expand_as(got)[mask.expand_as(got) == 0]
                       .to(dtype).float())
