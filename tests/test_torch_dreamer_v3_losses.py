"""The port's DreamerV3 training modules and losses against the JAX package's.

The decoders and heads (flax parameters carried over with
``flax_to_torch``), the transposed convolution, the distributions and
helpers the losses use, ``reconstruction_loss``, the Moments, Adam with
its global-norm clip, and the train step with continuous actions, on the
same numpy inputs in both packages.  Tolerances, f32 throughout: 1e-5 for
module outputs and losses (the tolerance the JAX package holds its GRU
kernel to), 1e-6 for the optimizer's parameters; the train step as in
``test_torch_dreamer_v3_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3.loss import reconstruction_loss as jax_reconstruction_loss
from sheeprl_tpu.algos.dreamer_v3.utils import init_moments as jax_init_moments
from sheeprl_tpu.algos.dreamer_v3.utils import update_moments as jax_update_moments
from sheeprl_tpu.optim import build_optimizer as jax_build_optimizer
from sheeprl_tpu.utils import distribution as jd
from sheeprl_tpu.utils import utils as ju
from sheeprl_tpu_torch.algos.dreamer_v3.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments, update_moments
from sheeprl_tpu_torch.optim import build_optimizer
from sheeprl_tpu_torch.utils import distribution as pd
from sheeprl_tpu_torch.utils import utils as pu

from test_torch_dreamer_v3_train import B, H, T, TOL, _t, run_and_compare, tiny_train_pair


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_step_matches_jax_continuous_actions():
    """Continuous actions: the actor's objective is the advantage itself,
    so the gradient flows back through imagination (the port builds the
    rollout's graph only here)."""
    run_and_compare(tiny_train_pair(continuous=True, actions_dim=(2,)), steps=1)


@pytest.fixture(scope="module")
def pair():
    return tiny_train_pair()


def test_decoder_and_heads_match_flax(pair):
    j, agent = pair["jax"], pair["agent"]
    latent = np.random.default_rng(1).normal(size=(3, 2, 32)).astype(np.float32)
    wm_p = j["params"]["world_model"]
    ref = j["wm"].observation_model.apply(wm_p["observation_model"], jnp.asarray(latent))
    with torch.no_grad():
        out = agent.world_model.observation_model(_t(latent))
    assert set(out) == set(ref) == {"rgb", "state"}
    assert out["rgb"].shape == (3, 2, 16, 16, 3)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **TOL)
    for name, module, jmod, p in (
        ("reward", agent.world_model.reward_model, j["wm"].reward_model, wm_p["reward_model"]),
        ("continue", agent.world_model.continue_model, j["wm"].continue_model, wm_p["continue_model"]),
        ("critic", agent.critic, j["critic"], j["params"]["critic"]),
    ):
        with torch.no_grad():
            np.testing.assert_allclose(module(_t(latent)).numpy(), np.asarray(jmod.apply(p, jnp.asarray(latent))), **TOL, err_msg=name)


@pytest.mark.parametrize("size", [(2, 2), (4, 4)])
def test_conv_transpose_matches_flax(size):
    """flax's ConvTranspose(4, stride 2, padding (2, 2)) does not flip its
    kernel; the port's layer is conv_transpose2d(padding=1) with the kernel
    flipped in both spatial axes and laid out (in, out, kh, kw)."""
    import flax.linen as nn
    import torch.nn.functional as F

    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, *size, 5)).astype(np.float32)
    layer = nn.ConvTranspose(3, (4, 4), strides=(2, 2), padding=[(2, 2), (2, 2)])
    p = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(layer.apply(p, jnp.asarray(x)))
    k = np.asarray(p["params"]["kernel"])
    w = np.ascontiguousarray(k[::-1, ::-1].transpose(2, 3, 0, 1))
    out = F.conv_transpose2d(_t(x).permute(0, 3, 1, 2), _t(w), _t(p["params"]["bias"]), stride=2, padding=1)
    assert ref.shape == (2, 2 * size[0], 2 * size[1], 3)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, **TOL)


def test_distributions_and_helpers_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(4, 5, 1)).astype(np.float32)
    x01 = (rng.uniform(size=(4, 5, 1)) < 0.5).astype(np.float32)
    raw = rng.normal(scale=3, size=(4, 5, 1)).astype(np.float32)
    two_hot_logits = rng.normal(size=(4, 5, 15)).astype(np.float32)
    mode = rng.normal(size=(4, 5, 3)).astype(np.float32)
    value = rng.normal(scale=4, size=(4, 5, 3)).astype(np.float32)
    pairs = []
    for cls in ("Bernoulli", "BernoulliSafeMode"):
        a, b = getattr(jd, cls)(logits=jnp.asarray(logits)), getattr(pd, cls)(logits=_t(logits))
        pairs += [(a.log_prob(jnp.asarray(x01)), b.log_prob(_t(x01))), (a.entropy(), b.entropy()), (a.mean, b.mean)]
    pairs.append((jd.BernoulliSafeMode(logits=jnp.asarray(logits)).mode, pd.BernoulliSafeMode(logits=_t(logits)).mode))
    a, b = jd.TwoHotEncodingDistribution(jnp.asarray(two_hot_logits), dims=1), pd.TwoHotEncodingDistribution(_t(two_hot_logits), dims=1)
    pairs += [(a.mean, b.mean), (a.log_prob(jnp.asarray(raw)), b.log_prob(_t(raw)))]
    for cls in ("SymlogDistribution", "MSEDistribution"):
        for dims in (1, 2):
            a, b = getattr(jd, cls)(jnp.asarray(mode), dims=dims), getattr(pd, cls)(_t(mode), dims=dims)
            pairs += [(a.log_prob(jnp.asarray(value)), b.log_prob(_t(value))), (a.mode, b.mode)]
    p_l, q_l = rng.normal(size=(2, 3, 4, 6)).astype(np.float32)
    pairs.append((
        jd.kl_divergence(jd.Independent(jd.OneHotCategorical(logits=jnp.asarray(p_l)), 1), jd.Independent(jd.OneHotCategorical(logits=jnp.asarray(q_l)), 1)),
        pd.kl_divergence(pd.Independent(pd.OneHotCategorical(logits=_t(p_l)), 1), pd.Independent(pd.OneHotCategorical(logits=_t(q_l)), 1)),
    ))
    pairs += [
        (ju.symexp(jnp.asarray(raw)), pu.symexp(_t(raw))),
        (ju.two_hot_encoder(jnp.asarray(raw), 20, 15), pu.two_hot_encoder(_t(raw), 20, 15)),
        (ju.two_hot_encoder(jnp.asarray(np.array([[25.0], [-20.0], [0.0]], np.float32)), 20, 15),
         pu.two_hot_encoder(_t(np.array([[25.0], [-20.0], [0.0]], np.float32)), 20, 15)),
    ]
    rewards, values = rng.normal(size=(2, 6, 5, 1)).astype(np.float32)
    cont = (0.99 * (rng.uniform(size=(6, 5, 1)) > 0.2)).astype(np.float32)
    pairs.append((ju.lambda_values(jnp.asarray(rewards), jnp.asarray(values), jnp.asarray(cont), 0.95),
                  pu.lambda_values(_t(rewards), _t(values), _t(cont), 0.95)))
    for ref, out in pairs:
        assert tuple(out.shape) == tuple(np.shape(ref))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_reconstruction_loss_matches_jax():
    rng = np.random.default_rng(4)
    obs = {"rgb": rng.normal(size=(T, B, 16, 16, 3)).astype(np.float32), "state": rng.normal(size=(T, B, 5)).astype(np.float32)}
    rec = {k: (v + rng.normal(scale=0.3, size=v.shape)).astype(np.float32) for k, v in obs.items()}
    rew_logits, rewards = rng.normal(size=(T, B, 15)).astype(np.float32), rng.normal(size=(T, B, 1)).astype(np.float32)
    pri, post = rng.normal(size=(2, T, B, 4, 4)).astype(np.float32)
    cont_logits, cont = rng.normal(size=(T, B, 1)).astype(np.float32), (rng.uniform(size=(T, B, 1)) > 0.1).astype(np.float32)

    def build(m, arr):
        po = {"rgb": m.MSEDistribution(arr(rec["rgb"]), dims=3), "state": m.SymlogDistribution(arr(rec["state"]), dims=1)}
        return po, m.TwoHotEncodingDistribution(arr(rew_logits), dims=1), m.Independent(m.BernoulliSafeMode(logits=arr(cont_logits)), 1)

    po, pr, pc = build(jd, jnp.asarray)
    ref = jax_reconstruction_loss(po, {k: jnp.asarray(v) for k, v in obs.items()}, pr, jnp.asarray(rewards), jnp.asarray(pri), jnp.asarray(post), 0.5, 0.1, 1.0, 1.0, pc, jnp.asarray(cont), 1.0)
    po, pr, pc = build(pd, _t)
    out = reconstruction_loss(po, {k: _t(v) for k, v in obs.items()}, pr, _t(rewards), _t(pri), _t(post), 0.5, 0.1, 1.0, 1.0, pc, _t(cont), 1.0)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(float(a), float(b), **TOL)


def test_moments_match_jax():
    rng = np.random.default_rng(5)
    sj, st = jax_init_moments(), init_moments()
    for i in range(3):
        x = rng.normal(loc=i, scale=2 + i, size=(H, 37, 1)).astype(np.float32)
        sj, oj, ij = jax_update_moments(sj, jnp.asarray(x), 0.99, 1.0, 0.05, 0.95)
        st, ot, it = update_moments(st, _t(x), 0.99, 1.0, 0.05, 0.95)
        for a, b in ((ot, oj), (it, ij), (st["low"], sj["low"]), (st["high"], sj["high"])):
            np.testing.assert_allclose(float(a), float(b), **TOL)


@pytest.mark.parametrize("clip", [None, 1.0, 1e6])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adam_with_global_norm_clip_matches_optax(clip, weight_decay):
    """Three steps on a random tree: unclipped, a clip below the gradient
    norm (every step clipped) and one far above it (never clipped)."""
    rng = np.random.default_rng(6)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 3)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    cfg = {"_target_": "optax.adam", "learning_rate": 1e-2, "eps": 1e-5, "b1": 0.9, "b2": 0.999, "weight_decay": weight_decay}
    tx = jax_build_optimizer(dict(cfg), clip, "32-true")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    ours = build_optimizer(dict(cfg), clip, "32-true")
    tp = {k: _t(v) for k, v in params.items()}
    ts = ours.init(tp)
    for _ in range(3):
        grads = {k: (3 * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}
        if clip == 1.0:
            assert float(optax.global_norm(grads)) > clip
        upd, js = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        ours.update(tp, {k: _t(v) for k, v in grads.items()}, ts)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)


def test_optimizer_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="bf16-true"):
        build_optimizer({"_target_": "optax.adam", "learning_rate": 1e-4}, None, "bf16-true")
    with pytest.raises(NotImplementedError, match="optax.sgd"):
        build_optimizer({"_target_": "optax.sgd", "learning_rate": 1e-4})


