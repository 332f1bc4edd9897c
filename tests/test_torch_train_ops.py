"""Port vs JAX package: the training pieces below the model. duration
loss, the random segment cut, the EDM loss weights and loss (with JAX's
draws replayed from the same key splits), BatchNorm batch statistics and
the VQ codebook's EMA update in train mode, the train-mode random masks,
and the optimizer (global-norm clipping, Adam, EMA of the weights)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from dex_tts_tpu.models.edm import edm_loss as jax_edm_loss  # noqa: E402
from dex_tts_tpu.models.edm import edm_loss_weight as jax_edm_loss_weight  # noqa: E402
from dex_tts_tpu.models.layers import BasicConv as JaxBasicConv  # noqa: E402
from dex_tts_tpu.models.ref_encoder import VQEmbeddingEMA as JaxVQ  # noqa: E402
from dex_tts_tpu.ops import duration_loss as jax_duration_loss  # noqa: E402
from dex_tts_tpu.ops import random_segment as jax_random_segment  # noqa: E402
from dex_tts_tpu_torch.models import layers  # noqa: E402
from dex_tts_tpu_torch.models.edm import edm_loss, edm_loss_weight  # noqa: E402
from dex_tts_tpu_torch.models.ref_encoder import VQEmbeddingEMA  # noqa: E402
from dex_tts_tpu_torch.ops.masks import duration_loss  # noqa: E402
from dex_tts_tpu_torch.ops.segment import random_segment  # noqa: E402
from dex_tts_tpu_torch.train import state as train_state  # noqa: E402
from tests.torch_port_util import t  # noqa: E402

LOSS_TYPES = ["base", "base_min_5", "base_log_3", "min_snr_5", "max_snr_1", "snr", "inv_snr"]


def test_duration_loss_matches_jax():
    rng = np.random.default_rng(0)
    logw, logw_ = (rng.standard_normal((3, 7, 1)).astype(np.float32) for _ in range(2))
    lengths = np.asarray([7, 4, 2], np.int32)
    want = float(jax_duration_loss(jnp.asarray(logw), jnp.asarray(logw_), jnp.asarray(lengths)))
    got = duration_loss(t(logw), t(logw_), t(lengths, torch.long)).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_random_segment_matches_jax():
    """The same uniform draw (JAX's, from its key) gives the same cut."""
    key = jax.random.PRNGKey(3)
    b, f, ty, out = 4, 5, 20, 8
    rng = np.random.default_rng(1)
    y = rng.standard_normal((b, f, ty)).astype(np.float32)
    attn = (rng.random((b, 6, ty)) > 0.5).astype(np.float32)
    y_lengths = np.asarray([20, 6, 8, 13], np.int32)
    want = jax_random_segment(key, jnp.asarray(y), jnp.asarray(attn), jnp.asarray(y_lengths), out)
    u = t(np.asarray(jax.random.uniform(key, (b,))))
    got = random_segment(t(y), t(attn), t(y_lengths, torch.long), out, u=u)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # from a generator: a contiguous window inside each item
    y_cut, _, lens, _ = random_segment(t(y), t(attn), t(y_lengths, torch.long), out,
                                       generator=torch.Generator().manual_seed(0))
    for i in range(b):
        start = int(np.argmin(np.abs(y[i, 0] - y_cut[i, 0, 0].item())))
        np.testing.assert_array_equal(y_cut[i, :, :lens[i]].numpy(), y[i, :, start:start + lens[i]])


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_edm_loss_weight_matches_jax(loss_type):
    sigma = np.exp(np.linspace(-4, 3, 17)).astype(np.float32).reshape(17, 1, 1)
    want = np.asarray(jax_edm_loss_weight(jnp.asarray(sigma), loss_type))
    np.testing.assert_allclose(edm_loss_weight(t(sigma), loss_type).numpy(), want, rtol=1e-6)


def test_edm_loss_weight_rejects_unknown():
    with pytest.raises(ValueError, match="unknown loss_type"):
        edm_loss_weight(torch.ones(2, 1, 1), "l1")


@pytest.mark.parametrize("loss_type", ["base", "min_snr_5"])
def test_edm_loss_matches_jax(loss_type):
    """A stand-in network F(x, t) = tanh(x)·(1 + t) + mu, with mu handed
    over as the denoiser's keyword, as the model hands over its own; σ's normal draw
    and the noise replayed from the JAX key's splits (edm.py:107-113)."""
    b, f, w = 3, 4, 10
    rng = np.random.default_rng(2)
    x0, mu = (rng.standard_normal((b, f, w)).astype(np.float32) for _ in range(2))
    mask = (np.arange(w)[None, None] < np.asarray([10, 7, 3])[:, None, None]).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = float(jax_edm_loss(
        key, lambda x, c, m: jnp.tanh(x) * (1 + c[:, None, None]) + m,
        jnp.asarray(x0), jnp.asarray(mask), jnp.asarray(mu), n_feats=f, loss_type=loss_type,
        m=jnp.asarray(mu)))
    k_sigma, k_noise = jax.random.split(key)
    r = np.asarray(jax.random.normal(k_sigma, (b, 1, 1)))
    noise = np.asarray(jax.random.normal(k_noise, x0.shape))
    got = edm_loss(lambda x, c, m: torch.tanh(x) * (1 + c[:, None, None]) + m,
                   t(x0), t(mask), t(mu), n_feats=f, loss_type=loss_type,
                   draws=(t(r), t(noise)), m=t(mu)).item()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_batch_norm_train_statistics_match_jax():
    """BasicConv with BatchNorm in train mode: the output from batch
    statistics and the running statistics' update (momentum 0.99 in flax
    terms), against the JAX module's mutable ``batch_stats``."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 11, 6)) * 2 + 0.5).astype(np.float32)  # (B, T, C)
    jm = JaxBasicConv(5, 3, norm_type="bn")
    variables = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    p, s = variables["params"], variables["batch_stats"]
    mean0 = rng.standard_normal(5).astype(np.float32)
    var0 = (rng.random(5) + 0.5).astype(np.float32)
    stats = {"BatchNorm_0": {"mean": mean0, "var": var0}}
    out, upd = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train=True,
                        mutable=["batch_stats"])
    port = layers.BasicConv(6, 5, relu=True, norm="bn")
    with torch.no_grad():
        port.conv.weight.copy_(t(np.transpose(p["Conv1d_0"]["Conv_0"]["kernel"], (2, 1, 0))))
        port.bn.weight.copy_(t(p["BatchNorm_0"]["scale"]))
        port.bn.bias.copy_(t(p["BatchNorm_0"]["bias"]))
        port.bn.running_mean.copy_(t(mean0))
        port.bn.running_var.copy_(t(var0))
    got = port(t(x).transpose(1, 2), train=True)
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 1), np.asarray(out), atol=1e-5)
    new = upd["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(port.bn.running_mean.numpy(), np.asarray(new["mean"]), atol=1e-6)
    np.testing.assert_allclose(port.bn.running_var.numpy(), np.asarray(new["var"]), atol=1e-6)
    # eval mode reads the running statistics and leaves them alone
    before = port.bn.running_mean.clone()
    port(t(x).transpose(1, 2), train=False)
    assert torch.equal(port.bn.running_mean, before)


def test_vq_ema_update_matches_jax():
    """The codebook's EMA update (counts, weights, embedding), the
    commitment loss, and the straight-through gradient, against the JAX
    module's mutable ``vq_stats`` and jax.grad."""
    n_emb, d = 6, 4
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, d)).astype(np.float32)
    mask = (np.arange(9)[None, :, None] < np.asarray([9, 5])[:, None, None]).astype(np.float32)
    codes = rng.standard_normal((n_emb, d)).astype(np.float32)
    stats = {"embedding": codes, "ema_count": rng.random(n_emb).astype(np.float32),
             "ema_weight": rng.standard_normal((n_emb, d)).astype(np.float32)}
    jm = JaxVQ(n_emb, d, 0.25)
    w = rng.standard_normal(x.shape).astype(np.float32)

    def jax_objective(x):
        (q, loss), upd = jm.apply({"vq_stats": stats}, x, jnp.asarray(mask), train=True,
                                  mutable=["vq_stats"])
        return jnp.sum(q * w) + loss, (q, loss, upd)

    (_, (q, loss, upd)), gx = jax.value_and_grad(jax_objective, has_aux=True)(jnp.asarray(x))
    port = VQEmbeddingEMA(n_emb, d, 0.25)
    for k, v in stats.items():
        getattr(port, k).copy_(t(v))
    xt = t(x).requires_grad_(True)
    pq, ploss = port(xt, t(mask), train=True)
    ((pq * t(w)).sum() + ploss).backward()
    np.testing.assert_allclose(pq.detach().numpy(), np.asarray(q), atol=1e-6)
    np.testing.assert_allclose(ploss.item(), float(loss), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-5)
    for k in stats:
        np.testing.assert_allclose(getattr(port, k).numpy(), np.asarray(upd["vq_stats"][k]),
                                   rtol=1e-5, atol=1e-6)


def test_train_masks_draw_from_the_step_generator():
    x = torch.ones(4000)
    with pytest.raises(RuntimeError, match="needs a generator"):
        layers.dropout(x, 0.5, True)
    with pytest.raises(TypeError, match="needs a torch.Generator"):
        with layers.dropout_generator(None):  # never the global RNG
            pass
    assert layers.dropout(x, 0.5, False) is x and layers.drop_path(x, 0.5, False) is x
    with layers.dropout_generator(torch.Generator().manual_seed(0)):
        a = layers.dropout(x, 0.3, True)
        items = layers.drop_path(torch.ones(64, 3, 5), 0.5, True)
    with layers.dropout_generator(torch.Generator().manual_seed(0)):
        b = layers.dropout(x, 0.3, True)
    assert torch.equal(a, b)  # the generator alone decides the masks
    assert a.unique().tolist() == [0.0, torch.tensor(1 / 0.7).item()]
    assert abs((a > 0).float().mean().item() - 0.7) < 0.03
    # DropPath keeps or drops whole items
    per_item = items.reshape(64, -1)
    assert ((per_item == 0).all(1) | (per_item == 2.0).all(1)).all()


def _optax_run(params, grads_seq, lr, max_grad, decay):
    tx = optax.chain(optax.clip_by_global_norm(max_grad), optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8))
    opt_state = tx.init(params)
    ema = jax.tree_util.tree_map(jnp.copy, params)
    norms = []
    for grads in grads_seq:
        norms.append(float(optax.global_norm(grads)))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        ema = optax.incremental_update(params, ema, step_size=1.0 - decay)
    return params, ema, norms


def test_clipped_adam_and_ema_match_optax():
    """Three updates from the same gradients: global norm above the clip,
    below it, above again."""
    rng = np.random.default_rng(6)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads_seq = [{k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in shapes.items()}
                 for scale in (3.0, 0.05, 10.0)]
    lr, max_grad, decay = 1e-2, 1.0, 0.9
    want_p, want_ema, want_norms = _optax_run(
        jax.tree_util.tree_map(jnp.asarray, params),
        [jax.tree_util.tree_map(jnp.asarray, g) for g in grads_seq], lr, max_grad, decay)

    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(t(v).clone()))
    state = train_state.create_train_state(module, lr=lr, max_grad=max_grad)
    norms = []
    for grads in grads_seq:
        for k, p in module.named_parameters():
            p.grad = t(grads[k]).clone()
        norms.append(train_state.clip_by_global_norm_([p.grad for p in module.parameters()],
                                                      max_grad).item())
        state.optimizer.step()
        train_state.ema_update_(state.ema, module, decay)
    np.testing.assert_allclose(norms, want_norms, rtol=1e-6)
    assert want_norms[0] > max_grad > want_norms[1]
    for k, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want_p[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(state.ema[k].numpy(), np.asarray(want_ema[k]), rtol=1e-6, atol=1e-7)


def test_dit_token_mask_keeps_and_restores_tokens():
    """MAE-style token masking in train mode (reference: dit.py:139-212):
    int(N·(1 − r)) tokens kept, a permutation and its inverse, and zeros
    re-inserted at the dropped positions; off outside train mode."""
    from dex_tts_tpu_torch.models.dit import token_mask

    like = torch.zeros(1)
    with layers.dropout_generator(torch.Generator().manual_seed(0)):
        keep, restore = token_mask(3, 10, 0.3, like)
    assert keep.shape == (3, 7) and restore.shape == (3, 10)
    for i in range(3):
        shuffle = torch.argsort(restore[i])
        assert torch.equal(shuffle[:7], keep[i])
        assert sorted(shuffle.tolist()) == list(range(10))
