"""Port vs JAX package: monotonic alignment search. The port's plain
version (the CPU path of `maximum_path`, the oracle of kernel K4 on the
card) against the JAX scan form, the TPU kernel K4 in Pallas interpret
mode, and the native C++ kernel; exact equality of the 0/1 paths. The
path guard raises on a corrupt path."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dex_tts_tpu.native import maximum_path_native  # noqa: E402
from dex_tts_tpu.ops.mas import maximum_path_pallas, maximum_path_scan as jax_scan  # noqa: E402
from dex_tts_tpu_torch.ops import mas  # noqa: E402
from tests.torch_port_util import t  # noqa: E402

# (t_x, t_y) per item: t_x = 1, t_x = t_y, t_y < Ty, full items
RAGGED = [(5, 12), (3, 3), (1, 7), (8, 20), (7, 8), (8, 8), (2, 19), (1, 1)]


def _batch(seed, lengths, t_x_max, t_y_max, offset=0.0):
    rng = np.random.default_rng(seed)
    value = (rng.standard_normal((len(lengths), t_x_max, t_y_max)) + offset).astype(np.float32)
    mask = np.zeros_like(value)
    for i, (lx, ly) in enumerate(lengths):
        mask[i, :lx, :ly] = 1.0
    return value, mask


CASES = {
    "ragged": (RAGGED, 8, 20, 0.0),
    "full": ([(9, 31)] * 3, 9, 31, 0.0),
    # log-prior-like scores (large negative): ties decided by the order of
    # f32 additions, which the plain version keeps
    "log_prior": ([(6, 40), (11, 17), (1, 3), (11, 40)], 11, 40, -40.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_scan(case):
    lengths, tx, ty, offset = CASES[case]
    value, mask = _batch(3, lengths, tx, ty, offset)
    want = np.asarray(jax_scan(jnp.asarray(value), jnp.asarray(mask)))
    got = mas.maximum_path(t(value), t(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.sum((1, 2)), [ly for _, ly in lengths])


def test_plain_matches_tpu_kernel_interpret():
    value, mask = _batch(7, RAGGED, 8, 20)
    want = np.asarray(maximum_path_pallas(jnp.asarray(value), jnp.asarray(mask), interpret=True))
    np.testing.assert_array_equal(mas.maximum_path_scan(t(value), t(mask)).numpy(), want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_native(case):
    lengths, tx, ty, offset = CASES[case]
    value, mask = _batch(5, lengths, tx, ty, offset)
    want = np.asarray(maximum_path_native(value, mask), np.float32)
    np.testing.assert_array_equal(mas.maximum_path_scan(t(value), t(mask)).numpy(), want)


def test_path_is_monotonic_and_covers_every_frame():
    value, mask = _batch(9, RAGGED, 8, 20)
    path = mas.maximum_path(t(value), t(mask)).numpy()
    for i, (lx, ly) in enumerate(RAGGED):
        tokens = path[i, :, :ly].argmax(0)
        assert (path[i, :, :ly].sum(0) == 1).all()
        assert tokens[0] == 0 and tokens[-1] == lx - 1
        assert set(np.diff(tokens)) <= {0, 1}
        assert path[i, :, ly:].sum() == 0 and path[i, lx:].sum() == 0


def test_guard_raises_on_corrupt_path():
    value, mask = _batch(1, RAGGED, 8, 20)
    path = mas.maximum_path(t(value), t(mask))
    bad = path.clone()
    bad[2] = 0.0  # all-zero alignment, the failure the guard exists for
    with pytest.raises(mas.MASPathError, match=r"batch items \[2\]"):
        mas.check_mas_path(bad, t(mask))
    assert mas.check_mas_path(path, t(mask)) is path


def test_guard_deferred_check_raises_at_the_host_read():
    """In a train step nothing is read: the count of broken paths stays a
    device scalar among the step's metrics, and `metrics_to_host` (the
    step's one host read) raises on it and does not return it."""
    from dex_tts_tpu_torch.train.trainer import metrics_to_host

    value, mask = _batch(1, RAGGED, 8, 20)
    path, errors = mas.maximum_path(t(value), t(mask), return_errors=True)
    assert torch.equal(path, mas.maximum_path(t(value), t(mask)))
    assert errors.shape == () and errors.item() == 0  # the plain version is not guarded
    assert metrics_to_host({"loss": torch.tensor(1.5), mas.MAS_ERRORS: errors}) == {"loss": 1.5}
    bad = path.clone()
    bad[0, 0, 0] = 0.0
    bad[3] = 0.0
    errors = mas.path_errors(bad, t(mask))  # no raise yet
    assert errors.item() == 2
    with pytest.raises(mas.MASPathError, match="2 item paths"):
        metrics_to_host({"loss": torch.tensor(1.5), mas.MAS_ERRORS: errors})


def test_backend_settings_and_devices():
    value, mask = _batch(2, RAGGED, 8, 20)
    want = mas.maximum_path(t(value), t(mask))
    for backend in ("scan", None):
        mas.set_mas_backend(backend)
        assert torch.equal(mas.maximum_path(t(value), t(mask)), want)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mas.set_mas_backend("pallas")
    assert any("CUDA kernel" in str(w.message) for w in caught)
    assert torch.equal(mas.maximum_path(t(value), t(mask)), want)
    with pytest.raises(ValueError, match="unknown MAS backend"):
        mas.set_mas_backend("cuda")
    with pytest.raises(ValueError, match="no maximum_path for devices"):
        mas.maximum_path(t(value).to("meta"), t(mask).to("meta"))
    with pytest.raises(ValueError, match="alike"):
        mas.maximum_path(t(value), t(mask)[:, :, :5])


# --- the kernel's schedule (csrc/mas.cu), emulated on the CPU ------------
#
# A numpy emulation that follows K4 step by step. Warp route: value and
# mask arrive through a ring of STAGES tiles of F frames laid out
# [F/4][32K rows][4 frames], only rows < t_x and frames < t_y copied (other
# words stay stale, NaN at first); value·mask is taken on read, 4 frames at
# a time, in whole groups of 4 (frames ≥ t_y computed and unused); each
# cell takes x - 1 of the frame before (in the kernel from the lane before,
# lane 31 of the cell before, or the DP warp before), the band as c2 ≤ 0 ≤
# min(c2 + t_y - t_x, t_x - 1 - x); the bits are the frame's bit string,
# ballot word x // 32, bit x % 32; the backtrace runs in blocks of 32
# frames, each frame's 32-token window [i - 31, i] (diagonal set, tokens ≤
# 0 cleared) walked with the index as a position in the window. Wide route: the
# block kernel, staged tiles of tile_y frames, one byte per cell. The
# route and its K, F and tile sizes come from `mas.plan`, which mirrors
# the launcher. f32 numpy arithmetic rounds each product and sum once, as
# __fmul_rn/__fadd_rn do.

import re  # noqa: E402
from pathlib import Path  # noqa: E402

from dex_tts_tpu.ops.mas import maximum_path_scan as _jax_scan  # noqa: E402

CSRC = Path(mas.__file__).resolve().parent.parent / "csrc" / "mas.cu"
NEG = np.float32(-1e9)


def _lengths(mask):
    return int(mask[:, 0].sum(dtype=np.float32)), int(mask[0, :].sum(dtype=np.float32))


def _write_path(mask, idx):
    x = np.arange(mask.shape[0])[:, None]
    return np.where(idx[None, :] == x, mask, np.float32(0)).astype(np.float32)


def _emulate_warp(value, mask, k, f):
    t_x_max, t_y_max = value.shape
    tx, ty = _lengths(mask)
    fy, rx = min(max(ty, 0), t_y_max), min(max(tx, 0), t_x_max)
    rows = 32 * k
    xs = np.arange(rows)  # lane l, cell k own x = 32k + l
    ring = np.full((mas.STAGES, 2, f // 4, rows, 4), np.nan, np.float32)
    tiles = -(-fy // f)

    def issue(t):  # the copying warp: rows < t_x, frames < t_y of tile t
        stage, y0 = ring[t % mas.STAGES], t * f
        nf = min(f, fy - y0)
        for yy in range(nf):
            stage[0, yy // 4, :rx, yy % 4] = value[:rx, y0 + yy]
            stage[1, yy // 4, :rx, yy % 4] = mask[:rx, y0 + yy]

    prev = np.full(rows, NEG, np.float32)
    bits = np.zeros((-(-t_y_max // 4) * 4, rows), bool)  # Ty rounded up to 4 frames
    y = 0
    with np.errstate(invalid="ignore"):
        for t in range(tiles):
            issue(t)  # ahead of the DP warps in the kernel
            vs, ms = ring[t % mas.STAGES]
            for j in range(-(-min(f, fy - t * f) // 4)):  # whole groups of 4 frames
                pr = (vs[j] * ms[j]).T  # (frame, row)
                for c in range(4):
                    # x - 1: lane l - 1's cell k by a rotating shuffle, for
                    # lane 0 lane 31's cell k - 1; -1e9 left of token 0
                    s = np.concatenate([[NEG], prev[:-1]]).astype(np.float32)
                    bits[y] = s > prev  # ballot word x // 32, bit x % 32
                    first = np.where(xs == 0, np.float32(0.0) if y == 0 else NEG, s)
                    c2 = tx - ty + y - xs  # the band: c2 ≤ 0 ≤ min(c2 + t_y - t_x, t_x - 1 - x)
                    hi = np.minimum(c2 + ty - tx, tx - 1 - xs)
                    v_cur = np.where(c2 + ty - tx == 0, NEG, prev)
                    cand = pr[c] + np.maximum(v_cur, first)
                    prev = np.where((c2 <= 0) & (hi >= 0), cand, NEG).astype(np.float32)
                    y += 1
    assert y == -(-fy // 4) * 4

    def window(yl, i):  # tokens [i - 31, i] of frame yl's bit string: may the index move there
        base = i - 31
        win = sum(int(bits[yl, base + c]) << c for c in range(32) if base + c >= 0)
        if base <= yl <= i:
            win |= 1 << (yl - base)
        return win & ~((1 << max(0, 1 - base)) - 1)  # tokens ≤ 0 never move

    idx = np.full(t_y_max, -1)
    i = tx - 1
    for y0 in range(fy - 1, -1, -32):  # blocks of 32 frames; lane l takes frame y0 - l
        wins = [window(y0 - lane, i) if y0 - lane >= 0 and i > 0 else 0 for lane in range(32)]
        at = 31
        for s_ in range(min(32, y0 + 1)):
            idx[y0 - s_] = i - 31 + at
            at -= (wins[s_] >> at) & 1
        i += at - 31
    return _write_path(mask, idx)


def _emulate_wide(value, mask, tile_y):
    t_x_max, t_y_max = value.shape
    tx, ty = _lengths(mask)
    xs = np.arange(t_x_max)
    col = np.full(t_x_max, NEG, np.float32)
    bits = np.zeros((t_y_max, t_x_max), np.uint8)
    for y0 in range(0, t_y_max, tile_y):
        tile = value[:, y0:y0 + tile_y] * mask[:, y0:y0 + tile_y]
        for yy in range(tile.shape[1]):
            y = y0 + yy
            s = np.concatenate([[NEG], col[:-1]]).astype(np.float32)
            bits[y] = s > col
            v_cur = np.where(xs == y, NEG, col)
            v_prev = np.where(xs == 0, np.float32(0.0) if y == 0 else NEG, s)
            cand = tile[:, yy] + np.maximum(v_cur, v_prev)
            valid = (xs <= y) & (xs >= tx + y - ty) & (xs < tx) & (y < ty)
            col = np.where(valid, cand, NEG).astype(np.float32)
    idx = np.full(t_y_max, -1)
    index = tx - 1
    for y in range(t_y_max - 1, -1, -1):
        active = y < ty
        idx[y] = index if active else -1
        diag = 0 < index < t_x_max and bits[y, index]
        if active and index != 0 and (index == y or diag):
            index -= 1
    return _write_path(mask, idx)


def emulate_kernel(value, mask, route=None):
    """K4 on (B, Tx, Ty) numpy inputs as the launcher runs it; ``route``
    forces "warp" (with the K and F of the smallest warp plan) or "wide"."""
    _, t_x, t_y = value.shape
    name, k, f, _ = mas.plan(t_x, t_y)
    if route == "wide" and name != "wide":
        f = min(mas.MAX_TILE_Y, t_y)
    name = route or name
    if name == "warp":
        return np.stack([_emulate_warp(v, m, k, f) for v, m in zip(value, mask)])
    assert name == "wide", name
    return np.stack([_emulate_wide(v, m, f) for v, m in zip(value, mask)])


def _full_and_ragged(t_x, t_y):
    """Three items: full, ragged in both, and t_x = t_y."""
    m = min(t_x, t_y)
    lx = max(1, min(t_x - 2, t_y - 5))
    return [(t_x, t_y), (lx, max(lx, t_y - 5)), (m, m)]


# Tx on K boundaries (32 lanes × K tokens), Ty on ring-tile boundaries and
# not a multiple of 4, the cases above (RAGGED, log_prior)
EMULATION_CASES = {
    **{f"tx{t_x}": (_full_and_ragged(t_x, 70), t_x, 70, -40.0) for t_x in (31, 32, 33, 64, 65, 96)},
    **{f"ty{t_y}": (_full_and_ragged(9, t_y), 9, t_y, -40.0) for t_y in (31, 32, 33, 65, 66)},
    "ragged": CASES["ragged"],
    "log_prior": CASES["log_prior"],
}


@pytest.mark.parametrize("case", sorted(EMULATION_CASES))
def test_kernel_emulation_matches_jax(case):
    lengths, tx, ty, offset = EMULATION_CASES[case]
    value, mask = _batch(11, lengths, tx, ty, offset)
    got = emulate_kernel(value, mask)
    np.testing.assert_array_equal(got, np.asarray(_jax_scan(jnp.asarray(value), jnp.asarray(mask))))
    np.testing.assert_array_equal(
        got, np.asarray(maximum_path_pallas(jnp.asarray(value), jnp.asarray(mask), interpret=True)))
    np.testing.assert_array_equal(got.sum((1, 2)), [ly for _, ly in lengths])


@pytest.mark.parametrize("case", ["tx33", "ty33", "ragged", "log_prior"])
def test_wide_route_emulation_matches_jax(case):
    lengths, tx, ty, offset = EMULATION_CASES[case]
    value, mask = _batch(12, lengths, tx, ty, offset)
    want = np.asarray(_jax_scan(jnp.asarray(value), jnp.asarray(mask)))
    np.testing.assert_array_equal(emulate_kernel(value, mask, route="wide"), want)


def test_plan_constants_match_the_kernel_source():
    src = CSRC.read_text()
    consts = {m.group(1): eval(m.group(2), {})  # "227 * 1024" and plain integers
              for m in re.finditer(r"constexpr int (k\w+) = ([\d *]+);", src)}
    assert consts["kSmemBudget"] == mas.SMEM_BUDGET
    assert consts["kMaxWarpTx"] == mas.MAX_WARP_TX == 32 * max(mas.WARP_KS)
    assert consts["kStages"] == mas.STAGES and consts["kMaxTileF"] == mas.MAX_TILE_F
    assert consts["kWarps"] == mas.WARPS
    assert consts["kWideThreads"] == mas.WIDE_THREADS and consts["kMaxTileY"] == mas.MAX_TILE_Y
    ks = re.search(r"constexpr int kWarpKs\[\] = \{([\d, ]+)\};", src).group(1)
    assert tuple(int(v) for v in ks.split(",")) == mas.WARP_KS
    for k in mas.WARP_KS:  # every K the plan picks has its instantiation
        assert f"case {k}: err = launch_warp<{k}>" in src


@pytest.mark.parametrize("shape, route", [
    ((96, 256), "warp"), ((256, 1024), "warp"), ((96, 257), "warp"),
    ((512, 700), "warp"), ((513, 700), "wide"),  # the token boundary
    ((256, 5000), "warp"), ((256, 6000), "wide"),  # the shared-memory boundary
    ((600, 1401), "wide"), ((1000, 64), "wide"),
])
def test_route_by_shape(shape, route):
    name, k, f, smem = mas.plan(*shape)
    assert name == route and smem <= mas.SMEM_BUDGET
    if name == "warp":
        assert 32 * k >= shape[0] and f % 4 == 0 and 4 <= f <= mas.MAX_TILE_F


def test_every_shape_the_earlier_kernel_took_has_a_route():
    """The block kernel before the warp route took (Tx, Ty) when
    4·(2Tx + Ty) + 4·(Tx + 1) ≤ 200 KB; every such shape still has one."""
    for t_x in (1, 31, 100, 512, 513, 1000, 4000, 20000):
        for t_y in (1, 3, 100, 1401, 5000, 20000, 45000):
            if 4 * (2 * t_x + t_y) + 4 * (t_x + 1) <= 200 * 1024:
                assert mas.plan(t_x, t_y)[0] != "none", (t_x, t_y)


@pytest.mark.parametrize("shape, message", [
    ((2, 100, 58000), r"no K4 route for \(B, Tx, Ty\) = \(2, 100, 58000\).*232448-byte limit"),
    ((2, 20000, 1000), r"no K4 route for \(B, Tx, Ty\) = \(2, 20000, 1000\)"),
    ((0, 96, 256), r"the batch is empty, \(B, Tx, Ty\) = \(0, 96, 256\)"),
    ((2, 0, 256), r"Tx and Ty must be positive"),
])
def test_launch_refuses_shapes_without_a_route(shape, message):
    """A shape K4 has no route for, or an empty batch, raises a ValueError
    that names it before any launch: the wrapper checks the shape before
    it loads the library (meta tensors carry no data at all)."""
    value = torch.empty(shape, device="meta")
    with pytest.raises(ValueError, match=message):
        mas._launch(value, value)
    assert mas.launch_plan(32, 96, 256) == mas.plan(96, 256)
