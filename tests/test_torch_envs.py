"""The port's device envs (``sheeprl_tpu_torch/envs/``) against the JAX package's.

CartPole and Pendulum, with and without domain randomisation: one step from
the same states and actions (1e-6), a reset from JAX's own uniform draws
(1e-6), and ``vector_step``'s auto-reset, truncation at
``max_episode_steps``, ``final_obs`` and episode totals over a run of
steps with JAX's reset draws fed to the port (dones exact, values 1e-6).
The two packages' noise streams differ (a ``torch.Generator`` against
``fold_in`` key chains): a kept difference, pinned below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.envs.jax import classic as jax_classic
from sheeprl_tpu.envs.jax import core as jax_core
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.device import (
    CartPole,
    DeviceVectorEnv,
    Pendulum,
    make_device_env,
    tree_select,
    vector_reset,
    vector_step,
)

TOL = 1e-6
N = 6
FAMILIES = {"cartpole": (jax_classic.CartPoleJax, CartPole), "pendulum": (jax_classic.PendulumJax, Pendulum)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pair(name, randomize=False, max_steps=None):
    jcls, pcls = FAMILIES[name]
    kw = {"randomize": randomize} if max_steps is None else {"randomize": randomize, "max_episode_steps": max_steps}
    return jcls(**kw), pcls(**kw)


def jax_reset_noise(env_j, keys):
    """The draws JAX's ``reset`` makes from each key, before any arithmetic:
    the noise the port's ``reset`` takes."""

    def one(key):
        k_state, k_params = jax.random.split(key)
        if isinstance(env_j, jax_classic.CartPoleJax):
            out = {"x": jax.random.uniform(k_state, (4,), jnp.float32, -0.05, 0.05)}
        else:
            out = {"init": jax.random.uniform(k_state, (2,), jnp.float32, -1.0, 1.0)}
        if env_j.randomize:
            s = env_j.randomize_scale
            out["params"] = jax.random.uniform(k_params, (2,), jnp.float32, 1.0 - s, 1.0 + s)
        return out

    return {k: torch.from_numpy(np.array(v)) for k, v in jax.vmap(one)(keys).items()}


def random_states(name, rng, n):
    params = rng.uniform(0.7, 1.3, size=(n, 2)).astype(np.float32)
    if name == "cartpole":
        state = {"x": (rng.normal(size=(n, 4)) * 0.15).astype(np.float32), "params": params}
        action = rng.integers(0, 2, size=n).astype(np.int32)
    else:
        state = {"th": rng.uniform(-4, 4, n).astype(np.float32), "thdot": rng.uniform(-9, 9, n).astype(np.float32),
                 "params": params}
        action = rng.uniform(-3, 3, size=(n, 1)).astype(np.float32)
    return state, action


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_step_matches_jax(name):
    env_j, env_p = pair(name)
    state, action = random_states(name, np.random.default_rng(1), 64)
    ns_j, obs_j, rew_j, term_j, _ = jax.vmap(env_j.step)(state, jnp.asarray(action), jax.random.split(jax.random.PRNGKey(0), 64))
    ns_p, obs_p, rew_p, term_p, _ = env_p.step({k: torch.from_numpy(v) for k, v in state.items()}, torch.from_numpy(action))
    for k in ns_j:
        close(ns_p[k], ns_j[k])
    close(obs_p["state"], obs_j["state"])
    close(rew_p, rew_j)
    np.testing.assert_array_equal(term_p.numpy(), np.asarray(term_j))
    if name == "cartpole":
        assert term_p.any() and not term_p.all()


@pytest.mark.parametrize("randomize", [False, True])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_reset_matches_jax_draws(name, randomize):
    env_j, env_p = pair(name, randomize)
    keys = jax.random.split(jax.random.PRNGKey(4), N)
    st_j, obs_j = jax.vmap(env_j.reset)(keys)
    st_p, obs_p = env_p.reset(jax_reset_noise(env_j, keys))
    for k in st_j:
        close(st_p[k], st_j[k])
    close(obs_p["state"], obs_j["state"])
    noise = env_p.reset_noise(N, torch.Generator().manual_seed(0))
    assert set(noise) == ({"x"} if name == "cartpole" else {"init"}) | ({"params"} if randomize else set())


@pytest.mark.parametrize("randomize", [False, True])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_vector_step_autoreset_and_truncation_match_jax(name, randomize):
    """T steps of ``vector_step`` with a short time limit: terminations
    (CartPole), truncations, the auto-reset from JAX's reset draws,
    ``final_obs`` and the episode totals."""
    limit, steps = 11, 40
    env_j, env_p = pair(name, randomize, max_steps=limit)
    base = jax.random.PRNGKey(7)
    idx = jnp.arange(N)
    vs_j = jax_core.vector_reset(env_j, base, N)
    init_keys = jax.vmap(lambda i: jax_core.initial_reset_key(base, i))(idx)
    vs_p = vector_reset(env_p, N, noise=jax_reset_noise(env_j, init_keys))
    close(vs_p["obs"]["state"], vs_j["obs"]["state"])
    rng = np.random.default_rng(3)
    n_trunc = n_term = 0
    for t in range(steps):
        _, action = random_states(name, rng, N)
        if name == "cartpole":
            action[::2] = 1  # half the poles pushed one way: they fall inside the limit
        reset_keys = jax.vmap(lambda i: jax_core.step_keys(base, vs_j["gstep"], i)[1])(idx)
        vs_j, out_j = jax_core.vector_step(env_j, vs_j, jnp.asarray(action), base, limit)
        vs_p, out_p = vector_step(env_p, vs_p, torch.from_numpy(action), limit, reset_noise=jax_reset_noise(env_j, reset_keys))
        for k in ("terminated", "truncated", "done"):
            np.testing.assert_array_equal(out_p[k].numpy(), np.asarray(out_j[k]), err_msg=f"{k} at step {t}")
        for k in ("reward", "ep_return"):
            close(out_p[k], out_j[k])
        np.testing.assert_array_equal(out_p["ep_length"].numpy(), np.asarray(out_j["ep_length"]))
        close(out_p["obs"]["state"], out_j["obs"]["state"])
        close(out_p["final_obs"]["state"], out_j["final_obs"]["state"])
        np.testing.assert_array_equal(vs_p["t"].numpy(), np.asarray(vs_j["t"]))
        n_trunc += int(out_p["truncated"].sum())
        n_term += int(out_p["terminated"].sum())
    assert n_trunc > 0
    assert name == "pendulum" or n_term > 0


def test_noise_streams_are_the_ports_own():
    """The kept difference: the port's reset noise comes from a
    ``torch.Generator``, not JAX's key chains, so the same seed gives other
    initial states than JAX's; the port's own stream is reproducible."""
    env_j, env_p = pair("cartpole")
    vs_j = jax_core.vector_reset(env_j, jax.random.PRNGKey(0), N)
    a = vector_reset(env_p, N, generator=torch.Generator().manual_seed(0))
    b = vector_reset(env_p, N, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(a["obs"]["state"], b["obs"]["state"], rtol=0, atol=0)
    assert not np.allclose(a["obs"]["state"].numpy(), np.asarray(vs_j["obs"]["state"]))
    assert float(a["obs"]["state"].abs().max()) <= 0.05


def test_tree_select_broadcasts_over_trailing_dims():
    pred = torch.tensor([True, False])
    got = tree_select(pred, {"a": torch.ones(2, 3), "b": torch.ones(2)}, {"a": torch.zeros(2, 3), "b": torch.zeros(2)})
    assert got["a"].tolist() == [[1, 1, 1], [0, 0, 0]] and got["b"].tolist() == [1, 0]


def test_vector_step_auto_reset_reports_episodes():
    """``vector_step`` on its own generator: where an env ends, ``out``
    carries the episode's totals and its last obs and the vector state
    starts a fresh episode from a reset obs; elsewhere the obs runs on."""
    env = CartPole(max_episode_steps=5)
    g = torch.Generator().manual_seed(2)
    vs = vector_reset(env, 3, generator=g)
    assert vs["obs"]["state"].shape == (3, 4)
    ended = 0
    for t in range(1, 6):
        prev_len = vs["ep_length"].clone()
        vs, out = vector_step(env, vs, torch.zeros(3, dtype=torch.int64), generator=g)
        done = out["done"]
        assert torch.equal(done, out["terminated"] | out["truncated"])
        assert torch.equal(out["ep_length"], prev_len + 1) and torch.all(out["ep_length"] <= 5)
        assert torch.all(out["truncated"] == ((out["ep_length"] == 5) & ~out["terminated"]))
        assert torch.all(vs["t"][done] == 0) and torch.all(vs["ep_return"][done] == 0)
        assert torch.all(vs["ep_length"][done] == 0) and torch.all(vs["obs"]["state"][done].abs() <= 0.05)
        assert torch.all(out["final_obs"]["state"][done].abs() > 0)
        torch.testing.assert_close(vs["obs"]["state"][~done], out["final_obs"]["state"][~done], rtol=0, atol=0)
        torch.testing.assert_close(out["ep_return"], out["ep_length"].to(torch.float32), rtol=0, atol=0)
        ended += int(done.sum())
    assert ended >= 3


def test_device_vector_env_describes_the_family():
    """``DeviceVectorEnv`` is what the loops read: the family, the count,
    the time limit (the family's unless given), the single-env spaces, and
    the stepping API of the off-policy loops (``test_torch_gridworld.py``)."""
    envs = DeviceVectorEnv(CartPole(max_episode_steps=7), 3, device="cpu")
    assert envs.num_envs == 3 and envs.max_episode_steps == 7 and envs.device.type == "cpu"
    assert envs.single_action_space.n == 2 and envs.single_observation_space["state"].shape == (4,)
    assert DeviceVectorEnv(Pendulum(), 2, max_episode_steps=9, device="cpu").max_episode_steps == 9
    assert callable(envs.step) and callable(envs.reset) and "num_envs=3" in repr(envs)


def test_registry_ids_and_spaces():
    assert isinstance(make_device_env("jax_cartpole").action_space, spaces.Discrete)
    pend = make_device_env("jax_pendulum", randomize=True, max_episode_steps=50)
    assert isinstance(pend.action_space, spaces.Box) and pend.action_space.shape == (1,) and pend.max_episode_steps == 50
    assert pend.observation_space["state"].high.tolist() == [1.0, 1.0, 8.0]
    grid = make_device_env("jax_gridworld", size=7, view=3)
    assert isinstance(grid.action_space, spaces.Discrete) and grid.observation_space["state"].shape == (13,)
    with pytest.raises(ValueError, match="Unknown device env"):
        make_device_env("CartPole-v1")
    assert spaces.MultiDiscrete([2, 3]).nvec.tolist() == [2, 3] and "state" in spaces.Dict({"state": spaces.Discrete(2)})
