"""Port vs JAX package: data and tensor parallelism in training. Two gloo
ranks on the CPU (`parallel.launch`, a file store in a temporary
directory, one thread per rank, a timeout that kills them) run every
case's rank side in one launch, in the background while JAX compiles
its oracles (the `runs` fixture). The JAX
oracles: `compute_loss(train=True)`'s value_and_grad on the global batch
(its updated BatchNorm and VQ collections too), and JAX's own
`make_parallel_train_step` on a two-device mesh of the eight CPU
devices that tests/conftest.py sets up. The port's own oracle: its
one-process step on the global batch. Also `dryrun_multichip(2)`."""

import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dex_tts_tpu.convert import dex_tts_torch_to_flax  # noqa: E402
from dex_tts_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from dex_tts_tpu.parallel import make_parallel_train_step as jax_parallel_step  # noqa: E402
from dex_tts_tpu.parallel import shard_count as jax_shard_count  # noqa: E402
from dex_tts_tpu.parallel import tp_state_shardings  # noqa: E402
from dex_tts_tpu.train.state import TrainState as JaxTrainState  # noqa: E402
from dex_tts_tpu.train.state import make_optimizer as jax_optimizer  # noqa: E402
from dex_tts_tpu.train.trainer import make_train_step as jax_train_step  # noqa: E402
from dex_tts_tpu_torch import parallel  # noqa: E402
from dex_tts_tpu_torch.convert import dex_tts_flax_to_torch, load_numpy_state  # noqa: E402
from dex_tts_tpu_torch.dryrun import dryrun_multichip  # noqa: E402
from dex_tts_tpu_torch.models.tts import build_tts  # noqa: E402
from dex_tts_tpu_torch.parallel.tp import partition  # noqa: E402
from dex_tts_tpu_torch.train import CheckpointManager, create_train_state  # noqa: E402
from dex_tts_tpu_torch.train.trainer import make_train_step, metrics_to_host  # noqa: E402
from tests import torch_parallel_ranks as ranks  # noqa: E402
from tests.test_torch_train import _batch  # noqa: E402
from tests.torch_port_util import (  # noqa: E402
    assert_grads_match,
    jax_model,
    planted_batch,
    tiny_cfg,
)

B, TX, TY, OUT = 4, 9, 32, ranks.OUT
CFG = tiny_cfg(dit=dict(attention="flash"))
# the JAX cases: one layer per stack, to keep JAX's compiles short
CFG_JAX = tiny_cfg(enc_layers=1, tv_layers=1, lf0_layers=1, tiv_layers=1,
                   dit=dict(attention="flash", depth=1))
GRAD_REL = 2e-4  # tests/test_torch_train.py's bounds
LOSS_RTOL = 1e-5
TIMEOUT = 240  # seconds for two ranks, start to end


JAX_RNG = 11  # the JAX DP step's state.rng


def launch(fn, *args, world=2):
    return parallel.launch(fn, world, args=args, devices=["cpu"] * world, timeout=TIMEOUT)


def _no_jax_dropout(monkeypatch):
    """JAX's dropout and DropPath off (the port's: `ranks.no_dropout`)."""
    import flax.linen as nn

    from dex_tts_tpu.models import layers as jax_layers

    monkeypatch.setattr(nn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(jax_layers.DropPath, "__call__", lambda self, x, train=False: x)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its variables as numpy, the port model with the same
    weights): the port's init with every parameter and buffer moved by
    seeded noise (BatchNorm variances positive, the codebook spread), sent
    through the JAX package's reader and back (no JAX init to compile)."""
    torch.manual_seed(0)
    port = build_tts(CFG_JAX)
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in port.state_dict().items():
        v = v.numpy()
        noise = rng.standard_normal(v.shape).astype(np.float32)
        if k.endswith("running_var"):
            v = np.abs(v + 0.05 * noise) + 0.5
        elif k.endswith(("vq.embedding", "vq.ema_weight")):
            v = noise
        elif v.dtype == np.float32:
            v = v + 0.05 * noise
        sd[k] = v
    model = jax_model(CFG_JAX)
    variables = jax.tree_util.tree_map(np.asarray, dex_tts_torch_to_flax(sd, model))
    load_numpy_state(port, dex_tts_flax_to_torch(variables, CFG_JAX))
    return model, variables, port


def _port_named(variables, cfg) -> dict:
    """JAX variables (numpy) → the port's state_dict names."""
    return dex_tts_flax_to_torch(jax.tree_util.tree_map(np.asarray, variables), cfg)


def _jax_step_draws() -> dict:
    """The draws JAX's step makes from k_loss (trainer.py: split(rng, 3)[1])."""
    k_loss = jax.random.split(jax.random.PRNGKey(JAX_RNG), 3)[1]
    k_seg, k_diff = jax.random.split(k_loss)
    k_sigma, k_noise = jax.random.split(k_diff)
    return {"u": np.asarray(jax.random.uniform(k_seg, (B,))),
            "sigma": np.asarray(jax.random.normal(k_sigma, (B, 1, 1))),
            "noise": np.asarray(jax.random.normal(k_noise, (B, CFG_JAX.n_feats, OUT)))}


@pytest.fixture(scope="module")
def runs(pair, tmp_path_factory):
    """Every case's rank side in one launch of two ranks, started in a
    background thread → {case: [rank 0's result, rank 1's]}, read through
    ``runs(case)``, which waits for the launch. Also the cases' inputs and
    directories (``runs.inputs``, ``runs.dirs``)."""
    _, _, port = pair
    sd = port.state_dict()
    inputs = {"jax_loss": planted_batch(port, CFG_JAX, B, TX, TY, OUT),
              "jax_step": planted_batch(port, CFG_JAX, B, TX, TY, OUT, seed=2)[0],
              "batch": _batch(CFG), "first": _batch(CFG, seed=1), "second": _batch(CFG, seed=2),
              "preempt": [_batch(CFG, seed=s) for s in range(4)]}
    dirs = {k: tmp_path_factory.mktemp(k) for k in ("ckpt", "preempt")}
    batch = inputs["batch"]
    calls = {
        "jax_loss": (ranks.loss_and_grads, (CFG_JAX, sd, *inputs["jax_loss"][:2])),
        "jax_step": (ranks.train_step, (CFG_JAX, inputs["jax_step"], 1, 0, False, None,
                                        _jax_step_draws(), sd)),
        "dropout": (ranks.train_step, (CFG, batch)),
        "tp2": (ranks.train_step, (CFG, batch, 2)),
        "dp_replicated": (ranks.train_step, (CFG, batch, 1, 0, True)),
        "ckpt_save": (ranks.train_step, (CFG, inputs["first"], 1, 0, False, str(dirs["ckpt"]))),
        "ckpt_restore": (ranks.restore_and_step, (CFG, str(dirs["ckpt"]), inputs["second"], 2)),
        "preempt": (ranks.preempted_fit, (CFG, str(dirs["preempt"]), inputs["preempt"], 1, 2)),
    }
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(launch, ranks.sequence, list(calls.values()))

        def result(case):
            i = list(calls).index(case)
            return [r[i] for r in future.result()]

        result.inputs, result.dirs = inputs, dirs
        yield result


def _assert_buffers(got: dict, want: dict, rtol=1e-5):
    """BatchNorm running statistics and the VQ codebook."""
    names = [k for k in want if "running" in k or ".vq." in k]
    assert len(names) >= 9, names
    for k in names:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=rtol * np.abs(want[k]).max(),
                                   err_msg=k)


def test_dp2_loss_gradients_and_collections_match_jax(pair, runs, monkeypatch):
    """dp2 `compute_loss(train=True)` on the planted global batch: every
    loss term, every summed gradient, the updated BatchNorm statistics and
    the VQ codebook against JAX's value_and_grad on the whole batch."""
    model, variables, port = pair
    inputs, _, key, _ = runs.inputs["jax_loss"]
    _no_jax_dropout(monkeypatch)
    params = variables["params"]
    others = jax.tree_util.tree_map(jnp.asarray, {k: v for k, v in variables.items()
                                                   if k != "params"})

    def loss_fn(p, inputs):
        losses, updates = model.apply(
            {"params": p, **others}, key, out_size=OUT, train=True,
            method=type(model).compute_loss, rngs={"dropout": jax.random.PRNGKey(1)},
            mutable=["batch_stats", "vq_stats"], **inputs)
        return sum(losses.values()), (losses, updates)

    (_, (want, updates)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in inputs.items()})
    want_grads = _port_named({"params": grads, **others}, CFG_JAX)
    want_buffers = _port_named({"params": params, **updates}, CFG_JAX)

    got = runs("jax_loss")
    for r in got:
        assert r["losses"].pop("mas") == 0
        assert sorted(r["losses"]) == sorted(want)
        for k in want:
            np.testing.assert_allclose(r["losses"][k], float(want[k]), rtol=LOSS_RTOL, err_msg=k)
        np.testing.assert_equal(r["grads"], got[0]["grads"])  # summed: equal on both ranks
        _assert_buffers(r["buffers"], want_buffers)
    holder = build_tts(CFG_JAX)
    for name, p in holder.named_parameters():
        p.grad = torch.from_numpy(got[0]["grads"][name])
    assert assert_grads_match(holder, want_grads, GRAD_REL) > 100


def test_dp2_step_matches_jax_parallel_train_step(pair, runs, monkeypatch):
    """The port's dp2 train step against JAX's `make_parallel_train_step`
    over `make_mesh(2)` on the same state, global batch and draws (JAX's
    k_loss replayed; dropout off in both): every loss, the total, the
    global gradient norm, BatchNorm and the codebook after the step."""
    model, variables, _ = pair
    inputs = runs.inputs["jax_step"]
    _no_jax_dropout(monkeypatch)
    tx = jax_optimizer(ranks.LR, 1.0)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, ema_params=params,
                          opt_state=tx.init(params),
                          batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                             variables["batch_stats"]),
                          vq_stats=jax.tree_util.tree_map(jnp.asarray, variables["vq_stats"]),
                          rng=jax.random.PRNGKey(JAX_RNG))
    step = jax_parallel_step(jax_train_step(model, tx, out_size=OUT, ema_decay=0.9),
                             jax_make_mesh(2), donate=False)
    new, want = step(state, {k: jnp.asarray(v) for k, v in inputs.items()})
    for r in runs("jax_step"):  # the port's step replays the draws of _jax_step_draws
        m = r["metrics"]
        assert m.pop("mas_errors") == 0
        for k in ("vq_loss", "dur_loss", "diff_loss", "prior_loss", "total_loss", "grad_norm"):
            np.testing.assert_allclose(m[k], float(want[k]), rtol=1e-4, err_msg=k)
        _assert_buffers(r["state"], _port_named({"params": variables["params"],
                                                 "batch_stats": new.batch_stats,
                                                 "vq_stats": new.vq_stats}, CFG_JAX))


@pytest.mark.parametrize("cfg", [CFG_JAX, CFG], ids=["one_layer", "tiny"])
def test_tp_rules_split_what_jax_splits(cfg):
    """The port's column/row rules on its module names select the same
    parameters, in the same number, as JAX's `tp_state_shardings` on its
    paths (a marker tree of JAX's sharded leaves carried through the
    converter), at tp 2."""
    model = jax_model(cfg)
    port = build_tts(cfg)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    variables = dex_tts_torch_to_flax(sd, model)
    shardings = tp_state_shardings(variables["params"], jax_make_mesh(2, tp_size=2))
    markers = jax.tree_util.tree_map(
        lambda v, s: np.full(np.shape(v), float(s.spec != jax.sharding.PartitionSpec()),
                             np.float32), variables["params"], shardings)
    params = dict(port.named_parameters())
    want = {k for k, v in _port_named({**variables, "params": markers}, cfg).items()
            if k in params and (v == 1).all()}
    got = set()
    for name, mod in port.named_modules():
        kind = partition(name, mod, 2)
        if kind:
            got.add(f"{name}.weight")
            if kind == "column" and mod.bias is not None:
                got.add(f"{name}.bias")
    assert got == want
    assert len(got) == jax_shard_count(shardings) > 0


def _one_process(batch, seed=0):
    torch.manual_seed(seed)
    state = create_train_state(build_tts(CFG), seed=seed, lr=ranks.LR, max_grad=1.0)
    metrics = metrics_to_host(make_train_step(out_size=OUT, ema_decay=0.9)(state, batch))
    grads = {n: p.grad.numpy() for n, p in state.model.named_parameters()}
    return state, metrics, grads


def _assert_step_matches(r, state, metrics, grads):
    """A parallel step's result against the one-process step: metrics to
    f32 summation order, gradients (after the clip) within the parity
    bound, BatchNorm and codebook, weights and EMA within what Adam's first
    update (at most lr per element) can move on a gradient's rounding."""
    got = dict(r["metrics"])
    assert got.pop("mas_errors") == 0
    for k in metrics:
        np.testing.assert_allclose(got[k], metrics[k], rtol=LOSS_RTOL, err_msg=k)
    top = max(np.abs(g).max() for g in grads.values())
    for n, g in grads.items():
        np.testing.assert_allclose(r["grads"][n], g, rtol=0,
                                   atol=GRAD_REL * (np.abs(g).max() + 1e-3 * top), err_msg=n)
    sd = {k: v.numpy() for k, v in state.model.state_dict().items()}
    _assert_buffers(r["state"], sd)
    for k, v in sd.items():
        np.testing.assert_allclose(r["state"][k], v, rtol=0, atol=2 * ranks.LR + 1e-6, err_msg=k)
    for k, v in state.ema.items():
        np.testing.assert_allclose(r["ema"][k], v.numpy(), rtol=0, atol=0.2 * ranks.LR + 1e-6,
                                   err_msg=k)


def test_dp2_step_with_dropout_matches_one_process(runs):
    """Dropout, segment offsets, σ and noise drawn from the state's
    generator: the dp2 step is the one-process step on the global batch."""
    state, metrics, grads = _one_process(runs.inputs["batch"])
    got = runs("dropout")
    assert got[0]["metrics"] == got[1]["metrics"]
    for r in got:
        _assert_step_matches(r, state, dict(metrics), grads)


def test_tp2_and_replicated_dp2_match_one_process(runs):
    """dp1×tp2 (the retention and DiT matmuls split) and dp2 from
    different weights on each rank (`replicate_state` makes them rank 0's)
    both take the one-process step; the TP state gathers back to the DP
    state's layout and values."""
    state, metrics, grads = _one_process(runs.inputs["batch"])
    tp, dp = runs("tp2"), runs("dp_replicated")
    assert tp[0]["shard_count"] == tp[1]["shard_count"] > 0
    assert dp[0]["shard_count"] == 0
    for r in tp + dp:
        _assert_step_matches(r, state, dict(metrics), grads)
    for k, v in dp[0]["state"].items():
        np.testing.assert_allclose(tp[0]["state"][k], v, rtol=0, atol=2 * ranks.LR + 1e-6,
                                   err_msg=k)


def test_dp2_checkpoint_restores_into_one_process_and_tp2(runs):
    """A checkpoint saved by dp2 (rank 0 writes, one-process layout)
    restores into one process and into dp1×tp2; the next step agrees."""
    restored = runs("ckpt_restore")
    ckpt_dir = runs.dirs["ckpt"]
    assert sorted(os.listdir(ckpt_dir)) == ["last.pth"]
    state = create_train_state(build_tts(CFG), seed=5, lr=ranks.LR, max_grad=1.0)
    CheckpointManager(str(ckpt_dir)).restore(state, "last")
    assert state.step == 1
    want = metrics_to_host(make_train_step(out_size=OUT, ema_decay=0.9)(state,
                                                                        runs.inputs["second"]))
    for got in restored:
        got = dict(got)
        assert got.pop("mas_errors") == 0
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)


def test_preemption_on_one_rank_stops_both(runs):
    """The flag rises on rank 1 only, before its third batch: both ranks
    stop there (two steps each), ``last`` and ``preempt`` are written once
    (by rank 0), and the log says so once."""
    for r in runs("preempt"):
        assert r["step"] == 2 and r["preempted"]
        assert r["files"] == ["last.pth", "preempt.pth"]
    log = (runs.dirs["preempt"] / "log.txt").read_text().splitlines()
    assert len(log) == 1 and log[0].startswith("preempted during epoch 1")


def test_dryrun_multichip_two_ranks(capsys):
    """`dex_tts_tpu_torch.dryrun.dryrun_multichip(2)`: dp, dp1×tp2 within
    1e-2 of it, and sharded synthesis equal to one process."""
    r0 = dryrun_multichip(2)
    out = capsys.readouterr().out
    assert out.count(" OK") == 3
    assert np.isfinite(r0["dp"]) and abs(r0["dp_tp"] - r0["dp"]) < 1e-2 * max(1, abs(r0["dp"]))
