"""GridWorld and the stepping ``DeviceVectorEnv`` against the JAX package's.

- GridWorld (``envs/device/gridworld.py``): ``reset`` from JAX's own draws
  (the wall uniforms and the two Gumbel vectors behind
  ``jax.random.categorical``) gives JAX's walls, start, goal and
  observation, bit for bit, also on crowded grids where the draws tie or
  every cell is a wall; ``vector_step`` over several episodes an env, with
  JAX's auto-reset draws fed in, gives JAX's positions, observations,
  rewards, ends and episode totals, bit for bit.
- ``DeviceVectorEnv.reset``/``step`` against ``JaxVectorEnv`` on CartPole,
  Pendulum and GridWorld with JAX's reset draws fed in: observations,
  float64 rewards, ``terminated``, ``truncated``, ``final_obs`` and
  ``final_info["episode"]`` ``r``/``l`` (GridWorld bit for bit, the
  classic families to 1e-6, as ``test_torch_envs.py`` holds their
  dynamics); the seeded action draws of the port's spaces.
- The wrapper chain (``utils/env.py:make_vector_env(..., wrapper_chain=True)``)
  against gymnasium's ``SyncVectorEnv`` over JAX's ``make_env`` with action
  repeat and a time limit, JAX's reset keys recorded and fed in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.envs.jax import JaxVectorEnv
from sheeprl_tpu.envs.jax import core as jax_core
from sheeprl_tpu.envs.jax.classic import CartPoleJax, PendulumJax
from sheeprl_tpu.envs.jax.gridworld import GridWorldJax
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.device import CartPole, DeviceVectorEnv, GridWorld, Pendulum, vector_reset, vector_step

from test_torch_envs import jax_reset_noise as classic_reset_noise

N = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def grid_reset_noise(env_j, keys):
    """JAX's draws of ``GridWorldJax.reset`` from each key, before any
    arithmetic: the wall uniforms and the start and goal Gumbel vectors."""
    size = env_j.size

    def one(key):
        k_walls, k_start, k_goal = jax.random.split(key, 3)
        return {
            "walls": jax.random.uniform(k_walls, (size, size)),
            "start": jax.random.gumbel(k_start, (size * size,)),
            "goal": jax.random.gumbel(k_goal, (size * size,)),
        }

    return {k: torch.from_numpy(np.array(v)) for k, v in jax.vmap(one)(keys).items()}


def reset_noise(env_j, keys):
    return grid_reset_noise(env_j, keys) if isinstance(env_j, GridWorldJax) else classic_reset_noise(env_j, keys)


def same(got, want, err_msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=err_msg)


@pytest.mark.parametrize("density", [0.25, 0.7, 1.0])
def test_reset_matches_jax_draws(density):
    """Walls, start, goal and observation from the same draws; at density
    1.0 every cell is a wall before the two cells are cleared, and both
    draws fall back to cell 0 as ``argmax`` over ``-inf`` does."""
    env_j, env_p = GridWorldJax(size=7, view=3, wall_density=density), GridWorld(size=7, view=3, wall_density=density)
    keys = jax.random.split(jax.random.PRNGKey(11), 64)
    st_j, obs_j = jax.vmap(env_j.reset)(keys)
    st_p, obs_p = env_p.reset(grid_reset_noise(env_j, keys))
    for k in ("walls", "pos", "goal"):
        same(st_p[k].numpy(), st_j[k], k)
    same(obs_p["state"].numpy(), obs_j["state"])
    if density == 1.0:
        assert (st_p["pos"] == 0).all()
    else:
        assert not (st_p["pos"] == st_p["goal"]).all(-1).any()
    noise = env_p.reset_noise(3, torch.Generator().manual_seed(0))
    assert noise["walls"].shape == (3, 7, 7) and noise["start"].shape == noise["goal"].shape == (3, 49)


def test_step_matches_jax():
    """Moves into walls and off the grid stay put; reaching the goal ends."""
    env_j, env_p = GridWorldJax(size=5, view=3), GridWorld(size=5, view=3)
    keys = jax.random.split(jax.random.PRNGKey(2), 128)
    st_j, _ = jax.vmap(env_j.reset)(keys)
    st_p, _ = env_p.reset(grid_reset_noise(env_j, keys))
    rng = np.random.default_rng(0)
    reached = 0
    for t in range(12):
        action = rng.integers(0, 4, size=128).astype(np.int32)
        st_j, obs_j, rew_j, term_j, _ = jax.vmap(env_j.step)(st_j, jnp.asarray(action), keys)
        st_p, obs_p, rew_p, term_p, _ = env_p.step(st_p, torch.from_numpy(action))
        for k in ("pos", "goal"):
            same(st_p[k].numpy(), st_j[k], f"{k} at {t}")
        same(obs_p["state"].numpy(), obs_j["state"])
        same(rew_p.numpy(), rew_j)
        same(term_p.numpy(), term_j)
        reached += int(term_p.sum())
    assert reached > 0


def test_vector_step_over_episodes_matches_jax():
    """``vector_step`` with a short limit: at least two episodes an env,
    goals reached and truncations, JAX's auto-reset draws fed in."""
    limit, steps = 9, 40
    env_j, env_p = GridWorldJax(size=5, view=3), GridWorld(size=5, view=3)
    base = jax.random.PRNGKey(3)
    idx = jnp.arange(N)
    vs_j = jax_core.vector_reset(env_j, base, N)
    vs_p = vector_reset(env_p, N, noise=grid_reset_noise(env_j, jax.vmap(lambda i: jax_core.initial_reset_key(base, i))(idx)))
    rng = np.random.default_rng(5)
    episodes = np.zeros(N, np.int64)
    n_term = n_trunc = 0
    for t in range(steps):
        action = rng.integers(0, 4, size=N).astype(np.int32)
        reset_keys = jax.vmap(lambda i: jax_core.step_keys(base, vs_j["gstep"], i)[1])(idx)
        vs_j, out_j = jax_core.vector_step(env_j, vs_j, jnp.asarray(action), base, limit)
        vs_p, out_p = vector_step(env_p, vs_p, torch.from_numpy(action), limit, reset_noise=grid_reset_noise(env_j, reset_keys))
        for k in ("terminated", "truncated", "done", "reward", "ep_return", "ep_length"):
            same(out_p[k].numpy(), out_j[k], f"{k} at step {t}")
        for k in ("obs", "final_obs"):
            same(out_p[k]["state"].numpy(), out_j[k]["state"], f"{k} at step {t}")
        for k in ("walls", "pos", "goal"):
            same(vs_p["env"][k].numpy(), vs_j["env"][k], f"{k} at step {t}")
        episodes += out_p["done"].numpy()
        n_term += int(out_p["terminated"].sum())
        n_trunc += int(out_p["truncated"].sum())
    assert episodes.min() >= 2 and n_term > 0 and n_trunc > 0


FAMILIES = {
    "cartpole": (lambda: CartPoleJax(max_episode_steps=15), lambda: CartPole(max_episode_steps=15)),
    "pendulum": (lambda: PendulumJax(), lambda: Pendulum()),
    "gridworld": (lambda: GridWorldJax(size=5, view=3), lambda: GridWorld(size=5, view=3)),
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_device_vector_env_matches_jax_vector_env(name):
    """The gymnasium vector contract, step by step, with JAX's reset draws."""
    env_j, env_p = FAMILIES[name][0](), FAMILIES[name][1]()
    limit, steps, seed = 8, 30, 4
    jv = JaxVectorEnv(env_j, N, seed=seed, max_episode_steps=limit)
    pv = DeviceVectorEnv(env_p, N, max_episode_steps=limit, device="cpu")
    base = jax.random.PRNGKey(seed)
    idx = jnp.arange(N)
    obs_j, _ = jv.reset(seed=seed)
    obs_p, info_p = pv.reset(noise=reset_noise(env_j, jax.vmap(lambda i: jax_core.initial_reset_key(base, i))(idx)))
    tol = 0 if name == "gridworld" else 1e-6

    def close(got, want, msg):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol, err_msg=msg)

    close(obs_p["state"], obs_j["state"], "reset obs")
    assert info_p == {} and obs_p["state"].dtype == np.float32
    rng = np.random.default_rng(8)
    ends = 0
    for t in range(steps):
        if name == "pendulum":
            action = rng.uniform(-2, 2, size=(N, 1)).astype(np.float32)
        else:
            action = rng.integers(0, env_p.action_space.n, size=N)
        reset_keys = jax.vmap(lambda i: jax_core.step_keys(base, t, i)[1])(idx)
        o_j, r_j, te_j, tr_j, i_j = jv.step(action)
        o_p, r_p, te_p, tr_p, i_p = pv.step(action, reset_noise=reset_noise(env_j, reset_keys))
        close(o_p["state"], o_j["state"], f"obs at {t}")
        assert r_p.dtype == np.float64 and te_p.dtype == tr_p.dtype == np.bool_
        close(r_p, r_j, f"reward at {t}")
        same(te_p, te_j, f"terminated at {t}")
        same(tr_p, tr_j, f"truncated at {t}")
        assert set(i_p) == set(i_j), f"info keys at {t}"
        if "final_obs" in i_j:
            ends += 1
            same(i_p["_final_obs"], i_j["_final_obs"])
            for i in np.nonzero(i_j["_final_obs"])[0]:
                close(i_p["final_obs"][i]["state"], i_j["final_obs"][i]["state"], f"final obs {i} at {t}")
            ep_p, ep_j = i_p["final_info"]["episode"], i_j["final_info"]["episode"]
            close(ep_p["r"], ep_j["r"], f"episode return at {t}")
            same(ep_p["l"], ep_j["l"], f"episode length at {t}")
            for k in ("_r", "_l", "_t"):
                same(ep_p[k], ep_j[k])
            same(i_p["final_info"]["_episode"], i_j["final_info"]["_episode"])
    assert ends >= 2


CHAIN_FAMILIES = {
    "cartpole": ("jax_cartpole", ["+env.wrapper.max_episode_steps=9"], lambda: CartPoleJax(max_episode_steps=9)),
    "pendulum": ("jax_pendulum", ["+env.wrapper.max_episode_steps=11"], lambda: PendulumJax(max_episode_steps=11)),
    "gridworld": ("jax_gridworld", ["env.wrapper.size=5", "env.wrapper.view=3", "env.wrapper.max_episode_steps=10"],
                  lambda: GridWorldJax(size=5, view=3, max_episode_steps=10)),
}


@pytest.mark.parametrize(
    "name,repeat,limit",
    [("cartpole", 3, 5), ("cartpole", 2, None), ("cartpole", 4, 3), ("pendulum", 2, 7),
     ("gridworld", 2, 6), ("gridworld", 3, 1), ("gridworld", 1, 3)],
)
def test_wrapper_chain_matches_jax_make_env(monkeypatch, name, repeat, limit):
    """``make_vector_env(..., wrapper_chain=True)``, which the DreamerV3 loop
    and the test episodes step, against gymnasium's ``SyncVectorEnv``
    (SAME_STEP) over JAX's ``make_env`` chain: ``ActionRepeat`` and
    ``TimeLimit(env.max_episode_steps)`` over the gym adapter, whose own limit
    counts the family's steps.  JAX's reset keys are recorded as the adapter
    takes them and fed to the port.  Observations, rewards (summed in
    float64), ``terminated``, ``truncated`` (set by the time limit also where
    an episode terminates on its last call), ``final_obs`` and the episode
    totals agree, GridWorld bit for bit, the classic families to 1e-6."""
    from types import SimpleNamespace

    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.envs.jax import gym_adapter
    from sheeprl_tpu.utils.env import make_env
    from sheeprl_tpu_torch.config import compose as port_compose
    from sheeprl_tpu_torch.utils.env import make_vector_env

    import gymnasium as gym

    env_id, family, make_j = CHAIN_FAMILIES[name]
    args = ["exp=dreamer_v3", f"env={env_id}", "algo.env_backend=jax", "algo.cnn_keys.encoder=[]",
            "algo.mlp_keys.encoder=[state]", f"env.action_repeat={repeat}",
            f"env.max_episode_steps={limit if limit else 'null'}", *family]
    taken = []
    jit_reset = gym_adapter._jit_reset

    def recording(env, key):
        taken.append(key)
        return jit_reset(env, key)

    monkeypatch.setattr(gym_adapter, "_jit_reset", recording)
    cfg_j = jax_compose(overrides=args)
    jv = gym.vector.SyncVectorEnv([make_env(cfg_j, 4 + i, 0, vector_env_idx=i) for i in range(N)],
                                  autoreset_mode=gym.vector.AutoresetMode.SAME_STEP)
    pv = make_vector_env(port_compose(overrides=args), "cpu", N, 4, wrapper_chain=True)
    env_j = make_j()
    tol = 0 if name == "gridworld" else 1e-6

    def close(got, want, msg):
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=tol, atol=tol,
                                   err_msg=msg)

    def fed(done):
        """JAX's keys taken in this step, in env order, at the done envs."""
        keys = [jax.random.PRNGKey(0)] * N
        for i, key in zip(np.nonzero(done)[0], taken):
            keys[i] = key
        assert len(taken) == int(np.sum(done))
        taken.clear()
        return reset_noise(env_j, jnp.stack(keys))

    obs_j, _ = jv.reset(seed=4)
    obs_p, _ = pv.reset(noise=fed(np.ones(N, bool)))
    close(obs_p["state"], obs_j["state"], "reset obs")
    rng = np.random.default_rng(8)
    n_term = n_trunc = both = 0
    for t in range(36):
        if name == "pendulum":
            action = rng.uniform(-2, 2, size=(N, 1)).astype(np.float32)
        else:
            action = rng.integers(0, env_j.action_space.n, size=N)
        o_j, r_j, te_j, tr_j, i_j = jv.step(action)
        o_p, r_p, te_p, tr_p, i_p = pv.step(action, reset_noise=fed(te_j | tr_j))
        close(o_p["state"], o_j["state"], f"obs at {t}")
        assert r_p.dtype == np.float64
        close(r_p, r_j, f"reward at {t}")
        same(te_p, te_j, f"terminated at {t}")
        same(tr_p, tr_j, f"truncated at {t}")
        assert set(i_p) == set(i_j), f"info keys at {t}"
        if "final_obs" in i_j:
            same(i_p["_final_obs"], i_j["_final_obs"])
            for i in np.nonzero(i_j["_final_obs"])[0]:
                close(i_p["final_obs"][i]["state"], i_j["final_obs"][i]["state"], f"final obs {i} at {t}")
            ep_p, ep_j = i_p["final_info"]["episode"], i_j["final_info"]["episode"]
            close(ep_p["r"], ep_j["r"], f"episode return at {t}")
            same(ep_p["l"], ep_j["l"], f"episode length at {t}")
            same(i_p["final_info"]["_episode"], i_j["final_info"]["_episode"])
        n_term += int(te_j.sum())
        n_trunc += int(tr_j.sum())
        both += int((te_j & tr_j).sum())
    jv.close()
    assert n_trunc > 0 and (name == "pendulum" or n_term > 0) and (limit != 1 or both > 0)


@pytest.mark.parametrize("algo", ["ppo", "sac"])
def test_vector_env_without_the_chain_refuses_action_repeat(algo):
    """``JaxVectorEnv``, which the JAX package's PPO and SAC loops step on
    ``algo.env_backend=jax``, has no action repeat: the port refuses it
    rather than ignore it; the wrapper chain takes it."""
    from sheeprl_tpu_torch.config import compose as port_compose
    from sheeprl_tpu_torch.utils.env import make_vector_env

    env = "jax_pendulum" if algo == "sac" else "jax_cartpole"
    cfg = port_compose(overrides=[f"exp={algo}", f"env={env}", f"env.id={env}", "algo.env_backend=jax",
                                  "algo.mlp_keys.encoder=[state]", "env.action_repeat=2"])
    with pytest.raises(ValueError, match="action_repeat"):
        make_vector_env(cfg, "cpu", 2, 0, wrapper_chain=False)
    assert make_vector_env(cfg, "cpu", 2, 0, wrapper_chain=True).action_repeat == 2


def test_space_samples_are_seeded_and_in_range():
    gen = torch.Generator().manual_seed(3)
    box = spaces.Box(-2.0, 2.0, shape=(3,))
    a = box.sample(500, gen)
    assert a.shape == (500, 3) and a.dtype == torch.float32 and a.min() >= -2 and a.max() <= 2
    assert torch.equal(a, box.sample(500, torch.Generator().manual_seed(3)))
    d = spaces.Discrete(4).sample(500, gen)
    assert d.dtype == torch.int64 and set(d.tolist()) == {0, 1, 2, 3}
    md = spaces.MultiDiscrete([2, 5]).sample(400, gen)
    assert md.shape == (400, 2) and set(md[:, 0].tolist()) == {0, 1} and set(md[:, 1].tolist()) == set(range(5))
    with pytest.raises(NotImplementedError):
        spaces.Box(np.array([0.0, -np.inf]), np.array([1.0, np.inf])).sample(2, gen)
    vec = DeviceVectorEnv(Pendulum(), 4, device="cpu", seed=9)
    first = vec.sample_actions()
    assert first.shape == (4, 1) and torch.equal(
        first, spaces.Box(-2.0, 2.0, shape=(1,)).sample(4, torch.Generator().manual_seed(9))
    )
