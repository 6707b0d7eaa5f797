"""The port's SAC env loop (``algos/sac/sac.py:main``) against the JAX
package's, on the CPU at small widths.

- the replay rows: JAX's ``main`` and the port's, warm-up only, on the same
  trajectory with the same action draws; every checkpoint's buffer read
  back bit for bit, across episode ends.  The env is a counter family
  defined here for both packages (integer state, observations and rewards
  exact in float32), so that the two trajectories agree to the bit; JAX's
  steps behind ``JaxVectorEnv``, the port's behind its stepping
  ``DeviceVectorEnv`` with JAX's reset draws fed in.  JAX's env construction
  and action draws are patched inside the test only;
- a CLI run on Pendulum with prioritized replay and ``dispatch_batch``: a
  test reward, a checkpoint that JAX's ``load_checkpoint`` reads (JAX's
  actor on its ``"agent"`` gives the port's greedy actions to 1e-5), and a
  resume for exactly one iteration that keeps the pending iterations;
- a CPU rehearsal of ``chip_smoke.py``'s ``sac_cli`` phase;
- the knobs that raise, each naming its ROADMAP item.
"""

import os

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.sac import agent as jax_sac_agent
from sheeprl_tpu.algos.sac import sac as jax_sac
from sheeprl_tpu.cli import run as jax_run
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.envs.jax import JaxVectorEnv
from sheeprl_tpu.envs.jax import core as jax_core
from sheeprl_tpu.envs.jax.core import JaxEnv
from sheeprl_tpu.parallel.mesh import MeshRuntime as JaxRuntime
from sheeprl_tpu.utils.callback import load_checkpoint as jax_load_checkpoint
from sheeprl_tpu_torch.algos.sac.agent import actor_greedy_action, build_agent
from sheeprl_tpu_torch.cli import run
from sheeprl_tpu_torch.config import compose as port_compose
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.device import DeviceVectorEnv, make_device_env
from sheeprl_tpu_torch.envs.device.core import DeviceEnv
from sheeprl_tpu_torch.parallel.mesh import MeshRuntime
from sheeprl_tpu_torch.utils import env as port_env
from sheeprl_tpu_torch.utils.ckpt_format import load_checkpoint
from sheeprl_tpu_torch.utils.convert import load_flax_params

N_ENVS, LIMIT, STEPS, EVERY = 3, 7, 30, 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- the counter family, in both packages
class CounterJax(JaxEnv):
    """State (c, e): reset draws e in [0, 5); a step adds 1, or 2 when the
    action is positive; reward c / 4 - e; terminated once c >= e + 4."""

    max_episode_steps = 100
    observation_space = gym.spaces.Dict({"state": gym.spaces.Box(-np.inf, np.inf, (3,), np.float32)})
    action_space = gym.spaces.Box(-2.0, 2.0, (1,), np.float32)
    _conf = ("counter",)

    @staticmethod
    def _obs(c, e):
        return {"state": jnp.stack([c, e, c * 0.5]).astype(jnp.float32)}

    def reset(self, key):
        e = jax.random.randint(key, (), 0, 5)
        state = {"c": jnp.zeros((), jnp.int32), "e": e.astype(jnp.int32)}
        return state, self._obs(state["c"].astype(jnp.float32), state["e"].astype(jnp.float32))

    def step(self, state, action, key):
        c = state["c"] + 1 + (action.reshape(-1)[0] > 0).astype(jnp.int32)
        cf, ef = c.astype(jnp.float32), state["e"].astype(jnp.float32)
        return {"c": c, "e": state["e"]}, self._obs(cf, ef), cf * 0.25 - ef, c >= state["e"] + 4, {}


class CounterPort(DeviceEnv):
    max_episode_steps = 100
    observation_space = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, shape=(3,), dtype=np.float32)})
    action_space = spaces.Box(-2.0, 2.0, shape=(1,), dtype=np.float32)

    @staticmethod
    def _obs(c, e):
        return {"state": torch.stack([c, e, c * 0.5], -1).to(torch.float32)}

    def reset_noise(self, n, generator=None, device=None):
        return {"e": torch.randint(0, 5, (n,), generator=generator, device=device)}

    def reset(self, noise):
        e = noise["e"].to(torch.int32)
        state = {"c": torch.zeros_like(e), "e": e}
        return state, self._obs(state["c"].float(), e.float())

    def step(self, state, action):
        c = state["c"] + 1 + (action.reshape(-1) > 0).to(torch.int32)
        cf, ef = c.float(), state["e"].float()
        return {"c": c, "e": state["e"]}, self._obs(cf, ef), cf * 0.25 - ef, c >= state["e"] + 4, {}


def counter_noise(keys):
    return {"e": torch.from_numpy(np.array(jax.vmap(lambda k: jax.random.randint(k, (), 0, 5))(keys)))}


class _FedVectorEnv(DeviceVectorEnv):
    """The port's stepping vector env with JAX's reset draws fed in and the
    actions from a list."""

    def __init__(self, *args, actions=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.actions, self.t = actions, 0

    def _keys(self, fn):
        return jax.vmap(fn)(jnp.arange(self.num_envs))

    def reset(self, *, seed=None, noise=None):
        self.base, self.t = jax.random.PRNGKey(int(seed)), 0
        return super().reset(noise=counter_noise(self._keys(lambda i: jax_core.initial_reset_key(self.base, i))))

    def step(self, actions, reset_noise=None):
        t, self.t = self.t, self.t + 1
        return super().step(actions, reset_noise=counter_noise(self._keys(lambda i: jax_core.step_keys(self.base, t, i)[1])))

    def sample_actions(self):
        return torch.from_numpy(self.actions.pop(0))


def _draws():
    rng = np.random.default_rng(2)
    return [rng.uniform(-2, 2, size=(N_ENVS, 1)).astype(np.float32) for _ in range(STEPS + 2)]


def _rows(path, loader):
    rb = loader(path)["rb"]
    rows = rb["buffer_size"] if rb["full"] else rb["pos"]
    out = {k: np.asarray(v)[:rows] for k, v in rb["data"].items()}
    out["pos"], out["full"] = np.asarray(rb["pos"]), np.asarray(rb["full"])
    return out


@pytest.mark.parametrize("sample_next_obs", [False, True])
def test_replay_rows_match_jax_main(tmp_path, monkeypatch, sample_next_obs):
    """Warm-up only: the rows of every checkpoint, data (observations,
    next observations with the final ones where an episode ended, actions,
    rewards, ends), write head and fill flag, bit for bit."""
    common = ["exp=sac", "env=jax_pendulum", "env.id=jax_pendulum", "algo.env_backend=jax", "fabric.accelerator=cpu",
              "metric.log_level=0", "env.capture_video=False", "buffer.memmap=False", "algo.run_test=False",
              f"env.num_envs={N_ENVS}", "algo.mlp_keys.encoder=[state]", "algo.hidden_size=8",
              f"algo.total_steps={STEPS * N_ENVS}", f"algo.learning_starts={10 * STEPS * N_ENVS}",
              f"checkpoint.every={EVERY * N_ENVS}", "checkpoint.save_last=True", "buffer.size=60", "seed=5",
              f"buffer.sample_next_obs={sample_next_obs}"]
    jax_actions = _draws()

    def jax_envs(cfg, runtime, log_dir, prefix="train"):
        envs = JaxVectorEnv(CounterJax(), N_ENVS, seed=int(cfg.seed), max_episode_steps=LIMIT)
        envs.action_space.sample = lambda: jax_actions.pop(0)
        return envs

    monkeypatch.setattr(jax_sac, "make_train_envs", jax_envs)
    jax_run([f"root_dir={tmp_path}/jax", "run_name=rows", *common])

    def port_envs(cfg, runtime, **kwargs):
        return _FedVectorEnv(CounterPort(), N_ENVS, max_episode_steps=LIMIT, device="cpu", actions=_draws())

    monkeypatch.setattr(port_env, "make_train_envs", port_envs)
    out = run([f"root_dir={tmp_path}/port", "run_name=rows", *common])
    assert out["gradient_steps"] == 0

    ckpt_dirs = [tmp_path / pkg / "rows" / "version_0" / "checkpoint" for pkg in ("jax", "port")]
    names = sorted(os.listdir(ckpt_dirs[0]))
    assert names == sorted(os.listdir(ckpt_dirs[1])) and len(names) == STEPS // EVERY
    for name in names:
        want, got = _rows(ckpt_dirs[0] / name, jax_load_checkpoint), _rows(ckpt_dirs[1] / name, load_checkpoint)
        assert set(got) == set(want), name
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, (name, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name}: {k}")
    assert got["terminated"].sum() > 0 and got["truncated"].sum() > 0
    assert ("next_observations" in got) is not sample_next_obs


# ---------------------------------------------------------------- CLI run
def sac_args(tmp_path, name, extra=()):
    return ["exp=sac", "env=jax_pendulum", "env.id=jax_pendulum", "algo.env_backend=jax", "fabric.accelerator=cpu",
            "metric.log_level=0", "algo.mlp_keys.encoder=[state]", "algo.hidden_size=16",
            "algo.per_rank_batch_size=8", "env.num_envs=2", f"root_dir={tmp_path}", f"run_name={name}", *extra]


def test_cli_run_checkpoint_read_by_jax_and_resume(tmp_path, capsys):
    """Prioritized replay, ``dispatch_batch=4`` (rows held back, flushed
    before each draw): a test reward; JAX reads the checkpoint and its actor
    on the checkpoint's parameters gives the port's greedy actions; a
    resume runs exactly one more iteration."""
    extra = ["buffer.prioritized=True", "buffer.per_kernel=pallas", "algo.dispatch_batch=4", "algo.learning_starts=16",
             "algo.total_steps=62"]
    out = run(sac_args(tmp_path, "cli", extra))
    assert out["dispatches"] > 1 and out["gradient_steps"] > 0 and out["iterations"] == 31
    assert "Test - Reward:" in capsys.readouterr().out
    state_j = jax_load_checkpoint(out["checkpoint"])
    assert {"agent", "opt_states", "ratio", "pending_iters", "rb", "replay_priority"} <= set(state_j)
    assert set(state_j["agent"]) == {"actor", "critic", "target_critic", "log_alpha"}

    cfg_j = jax_compose(overrides=sac_args(tmp_path, "cli", extra))
    rt = JaxRuntime(devices=1, accelerator="cpu", precision="32-true")
    rt.launch()
    obs_space = gym.spaces.Dict({"state": gym.spaces.Box(-np.inf, np.inf, (3,), np.float32)})
    act_space = gym.spaces.Box(-2.0, 2.0, (1,), np.float32)
    actor_j, _, params_j, _ = jax_sac_agent.build_agent(rt, cfg_j, obs_space, act_space, state_j["agent"])
    env = make_device_env("jax_pendulum")
    agent, _ = build_agent(MeshRuntime(device="cpu").launch(), port_compose(overrides=sac_args(tmp_path, "cli", extra)),
                           env.observation_space, env.action_space)
    load_flax_params(agent, load_checkpoint(out["checkpoint"])["agent"])
    obs = np.random.default_rng(0).normal(size=(6, 3)).astype(np.float32)
    want = np.asarray(jax_sac_agent.actor_greedy_action(actor_j, params_j["actor"], jnp.asarray(obs)))
    with torch.no_grad():
        got = actor_greedy_action(agent.actor, torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    resumed = run(sac_args(tmp_path, "cli_resumed", ["algo.total_steps=64", f"checkpoint.resume_from={out['checkpoint']}"]))
    assert resumed["iterations"] == 1 and resumed["policy_step"] == 64 and os.path.exists(resumed["checkpoint"])
    again = load_checkpoint(resumed["checkpoint"])
    assert again["iter_num"] == 32 and list(again["pending_iters"]) == list(state_j["pending_iters"])


# ---------------------------------------------------------------- chip_smoke rehearsal and scope
def test_chip_smoke_sac_cli_phase_runs_on_cpu():
    import chip_smoke

    res = chip_smoke.run_sac_cli(
        "cpu", overrides=["algo.hidden_size=16", "algo.per_rank_batch_size=8", "algo.dispatch_batch=8",
                          "algo.learning_starts=16"], dispatches=3, profile=False,
    )
    assert res["dispatches"] == 3 and res["ms_per_dispatch"] > 0 and res["launches"] == {}
    assert res["gradient_steps"] >= 3 * 8 and res["resumed"]["iterations"] == 1 and res["test_reward"] is not None
    assert res["draw_vs_plain"]["bytes_equal"] and set(res["draw_vs_plain"]["kernels"]) == set(chip_smoke.SAC_CLI_KERNELS)


def test_exp_refuses_what_is_not_ported(tmp_path):
    assert port_compose(overrides=["exp=sac"]).buffer.memmap is False
    cases = {
        "buffer.memmap=True": "A2",
        "buffer.rate_limiter.samples_per_insert=2.0": "A2",
        "fabric.devices=2": "A5",
        "algo.sentinel.enabled=True": "A2",
        "metric.tracing=full": "A7",
        "fabric.precision=bf16-true": "A2",
        "env.capture_video=True": "A2",
        "env.action_repeat=2": "JaxVectorEnv",
    }
    for override, item in cases.items():
        with pytest.raises((NotImplementedError, ValueError), match=item):
            run(sac_args(tmp_path, "scope", ["algo.total_steps=8", override]))
    with pytest.raises(ValueError, match="continuous"):
        run(sac_args(tmp_path, "scope", ["algo.total_steps=8", "env=jax_cartpole", "env.id=jax_cartpole"]))
