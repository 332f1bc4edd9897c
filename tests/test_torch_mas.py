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
