"""The port's DreamerV3 player modules against the flax ones.

A tiny DreamerV3 (widths of 16, one MLP layer, a 16-px screen) is built in
both packages; the flax parameters are carried into the port with
``flax_to_torch``; the same numpy inputs and the same noise then go through
the encoder, the RSSM recurrent step, the representation and transition
models and the actor of each.  Forward values agree to 1e-5, the tolerance
the JAX package holds its own GRU kernel to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gymnasium as gym

from sheeprl_tpu.algos.dreamer_v3 import agent as jax_agent
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.parallel.mesh import MeshRuntime as JaxRuntime
from sheeprl_tpu.utils import distribution as jax_dist
from sheeprl_tpu_torch.algos.dreamer_v3 import agent as port_agent
from sheeprl_tpu_torch.config import compose as port_compose
from sheeprl_tpu_torch.parallel.mesh import MeshRuntime
from sheeprl_tpu_torch.utils import distribution as port_dist
from sheeprl_tpu_torch.utils.convert import ConversionError, flax_to_torch, load_flax_params

TOL = dict(rtol=1e-5, atol=1e-5)
TINY = [
    "exp=dreamer_v3",
    "env=dummy",
    "algo.mlp_keys.encoder=[state]",
    "algo.mlp_keys.decoder=[state]",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.cnn_keys.decoder=[rgb]",
    "algo.dense_units=16",
    "algo.mlp_layers=1",
    "algo.world_model.encoder.cnn_channels_multiplier=4",
    "algo.world_model.recurrent_model.recurrent_state_size=16",
    "algo.world_model.representation_model.hidden_size=16",
    "algo.world_model.transition_model.hidden_size=16",
    "algo.world_model.stochastic_size=4",
    "algo.world_model.discrete_size=4",
    "algo.world_model.reward_model.bins=15",
    "algo.critic.bins=15",
    "env.screen_size=16",
]
OBS_SPACE = gym.spaces.Dict(
    {
        "rgb": gym.spaces.Box(-np.inf, np.inf, (16, 16, 3), np.float32),
        "state": gym.spaces.Box(-np.inf, np.inf, (5,), np.float32),
    }
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread avoids OpenMP oversubscription
    when the suite runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_pair(actions_dim=(3, 2), continuous=False, fused=False, extra=()):
    """The same tiny DreamerV3 player in both packages, on the same weights."""
    overrides = TINY + [f"algo.world_model.recurrent_model.fused={fused}", *extra]
    cfg_j = jax_compose(overrides=overrides)
    rt = JaxRuntime(devices=1, accelerator="cpu", precision="32-true")
    rt.launch()
    wm, actor, _, params = jax_agent.build_agent(rt, actions_dim, continuous, cfg_j, OBS_SPACE)
    params = {"world_model": params["world_model"], "actor": params["actor"]}
    cfg_t = port_compose(overrides=overrides)
    agent = port_agent.build_player(MeshRuntime(device="cpu", seed=0).launch(), actions_dim, continuous, cfg_t, OBS_SPACE)
    load_flax_params(agent, jax.tree_util.tree_map(np.asarray, params))
    return {"wm": wm, "actor": actor, "params": params, "agent": agent, "cfg": cfg_t}


def random_obs(rows, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "rgb": rng.normal(size=(rows, 16, 16, 3)).astype(np.float32),
        "state": (3 * rng.normal(size=(rows, 5))).astype(np.float32),
    }


def gumbel(rng, shape):
    return (-np.log(-np.log(rng.uniform(1e-12, 1.0, size=shape)))).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


def test_encoder_matches_flax(pair):
    obs = random_obs(5)
    ref = pair["wm"].encoder.apply(pair["params"]["world_model"]["encoder"], {k: jnp.asarray(v) for k, v in obs.items()})
    with torch.no_grad():
        out = pair["agent"].world_model.encoder({k: _t(v) for k, v in obs.items()})
    assert out.shape == (5, 2 * 4 * 16 + 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_recurrent_step_matches_flax(fused):
    p = tiny_pair(fused=fused)
    rng = np.random.default_rng(1)
    inp = rng.normal(size=(6, 16 + 5)).astype(np.float32)
    rec = np.tanh(rng.normal(size=(6, 16))).astype(np.float32)
    ref = p["wm"].rssm.apply(
        p["params"]["world_model"]["rssm"], jnp.asarray(inp), jnp.asarray(rec), method=jax_agent.RSSM.recurrent_step
    )
    with torch.no_grad():
        out = p["agent"].world_model.rssm.recurrent_step(_t(inp), _t(rec))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_representation_with_same_noise(pair):
    rng = np.random.default_rng(2)
    emb = rng.normal(size=(4, 144)).astype(np.float32)
    rec = np.tanh(rng.normal(size=(4, 16))).astype(np.float32)
    noise = gumbel(rng, (4, 4, 4))
    logits_j, stoch_j = pair["wm"].rssm.apply(
        pair["params"]["world_model"]["rssm"], jnp.asarray(emb), None, jnp.asarray(rec), jnp.asarray(noise),
        method=jax_agent.RSSM._representation,
    )
    with torch.no_grad():
        logits, stoch = pair["agent"].world_model.rssm._representation(_t(emb), _t(rec), noise=_t(noise))
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **TOL)
    np.testing.assert_allclose(stoch.numpy(), np.asarray(stoch_j), **TOL)
    np.testing.assert_array_equal(stoch.numpy().argmax(-1), np.asarray(stoch_j).argmax(-1))


def test_initial_states_and_transition_mode(pair):
    rec_j, post_j = pair["wm"].rssm.apply(
        pair["params"]["world_model"]["rssm"], (3,), method=jax_agent.RSSM.get_initial_states
    )
    with torch.no_grad():
        rec, post = pair["agent"].world_model.rssm.get_initial_states((3,))
    np.testing.assert_allclose(rec.numpy(), np.asarray(rec_j), **TOL)
    np.testing.assert_array_equal(post.numpy(), np.asarray(post_j))


def test_compute_stochastic_state_straight_through_value():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(5, 3 * 6)).astype(np.float32)
    noise = gumbel(rng, (5, 3, 6))
    ref = jax_agent.compute_stochastic_state(jnp.asarray(logits), 6, None, noise=jnp.asarray(noise))
    out = port_agent.compute_stochastic_state(_t(logits), 6, noise=_t(noise))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("continuous", [False, True])
@pytest.mark.parametrize("greedy", [True, False])
def test_actor_matches_flax(continuous, greedy):
    """Greedy heads, and sampled heads fed the noise that the flax actor
    draws from its key: per-head Gumbel noise from ``split(key, heads)``
    (discrete), or ``normal(key)`` (continuous)."""
    actions_dim = (2,) if continuous else (3, 2)
    p = tiny_pair(actions_dim=actions_dim, continuous=continuous)
    state = np.random.default_rng(4).normal(size=(7, 16 + 16)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    acts_j, _ = p["actor"].apply(p["params"]["actor"], jnp.asarray(state), greedy, None if greedy else key)
    noise = None
    if not greedy:
        if continuous:
            noise = np.asarray(jax.random.normal(key, (7, 2)))
        else:
            keys = jax.random.split(key, len(actions_dim))
            noise = np.concatenate([np.asarray(jax.random.gumbel(k, (7, d))) for k, d in zip(keys, actions_dim)], -1)
    with torch.no_grad():
        acts, _ = p["agent"].actor(_t(state), greedy, noise=None if noise is None else _t(noise))
    assert len(acts) == len(acts_j)
    for a, a_j in zip(acts, acts_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(a_j), **TOL)
        if not continuous:
            np.testing.assert_array_equal(a.numpy().argmax(-1), np.asarray(a_j).argmax(-1))


def test_flax_to_torch_rejects_unknown_and_missing_leaves(pair):
    tree = jax.tree_util.tree_map(np.asarray, pair["params"])
    flax_to_torch(tree, pair["agent"])  # the real tree converts
    extra = jax.tree_util.tree_map(lambda x: x, tree)
    extra["actor"]["params"]["Dense_9"] = {"kernel": np.zeros((16, 2), np.float32)}
    with pytest.raises(ConversionError, match="no place"):
        flax_to_torch(extra, pair["agent"])
    missing = jax.tree_util.tree_map(lambda x: x, tree)
    del missing["world_model"]["rssm"]["params"]["initial_recurrent_state"]
    with pytest.raises(ConversionError, match="missing"):
        flax_to_torch(missing, pair["agent"])
    wrong = jax.tree_util.tree_map(lambda x: x, tree)
    wrong["actor"]["params"]["Dense_0"]["bias"] = np.zeros((5,), np.float32)
    with pytest.raises(ConversionError, match="Dense_0|heads.0"):
        flax_to_torch(wrong, pair["agent"])


def test_player_dv3_steps_and_resets(pair):
    player = port_agent.PlayerDV3(pair["agent"], (3, 2), num_envs=3, stochastic_size=4, recurrent_state_size=16, discrete_size=4)
    obs = {k: _t(v)[None] for k, v in random_obs(3, seed=7).items()}
    g = torch.Generator().manual_seed(0)
    actions = player.get_actions(obs, greedy=False, generator=g)
    assert [a.shape for a in actions] == [(1, 3, 3), (1, 3, 2)]
    assert player.recurrent_state.shape == (1, 3, 16) and player.stochastic_state.shape == (1, 3, 16)
    init_rec, _ = pair["agent"].world_model.rssm.get_initial_states((1, 1))
    player.init_states([1])
    torch.testing.assert_close(player.recurrent_state[:, 1], init_rec[:, 0])
    assert float(player.actions[:, 1].abs().sum()) == 0.0


@pytest.mark.parametrize("name", ["Normal", "TanhNormal", "Independent", "OneHotCategorical", "OneHotCategoricalStraightThrough"])
def test_distribution_matches_jax(name):
    """log_prob, entropy, mode/mean and noise-fed samples of each
    distribution the player builds, against the JAX classes."""
    rng = np.random.default_rng(6)
    if name.startswith("OneHot"):
        logits = rng.normal(size=(5, 7)).astype(np.float32)
        noise = gumbel(rng, (5, 7))
        x = np.eye(7, dtype=np.float32)[rng.integers(0, 7, 5)]
        j, t = getattr(jax_dist, name)(logits=jnp.asarray(logits)), getattr(port_dist, name)(logits=_t(logits))
        key = jax.random.PRNGKey(2)
        sample_j = j.rsample(key) if name.endswith("Through") else j.sample(key)
        sample_t = t.rsample(_t(np.asarray(jax.random.gumbel(key, (5, 7))))) if name.endswith("Through") else t.sample(
            _t(np.asarray(jax.random.gumbel(key, (5, 7))))
        )
        pairs = [(j.log_prob(jnp.asarray(x)), t.log_prob(_t(x))), (j.entropy(), t.entropy()),
                 (j.mode, t.mode), (j.probs, t.probs), (sample_j, sample_t)]
        del noise
    else:
        loc = rng.normal(size=(5, 3)).astype(np.float32)
        scale = rng.uniform(0.2, 1.5, size=(5, 3)).astype(np.float32)
        eps = rng.normal(size=(5, 3)).astype(np.float32)
        y = np.tanh(rng.normal(size=(5, 3))).astype(np.float32)
        make = {
            "Normal": lambda m, a, b: m.Normal(a, b),
            "TanhNormal": lambda m, a, b: m.TanhNormal(a, b),
            "Independent": lambda m, a, b: m.Independent(m.Normal(a, b), 1),
        }[name]
        j, t = make(jax_dist, jnp.asarray(loc), jnp.asarray(scale)), make(port_dist, _t(loc), _t(scale))
        pairs = [(j.log_prob(jnp.asarray(y)), t.log_prob(_t(y))), (j.mean, t.mean),
                 (j.base.loc + jnp.asarray(eps) * j.base.scale if name != "Normal" else j.loc + jnp.asarray(eps) * j.scale,
                  t.rsample(_t(eps)) if name != "TanhNormal" else t.base.rsample(_t(eps)))]
        if name != "TanhNormal":
            pairs.append((j.entropy(), t.entropy()))
    for ref, out in pairs:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
