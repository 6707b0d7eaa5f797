"""The port's DreamerV3 env loop (``algos/dreamer_v3/dreamer_v3.py:main``)
against the JAX package's, on the CPU at tiny widths.

- ``Ratio`` (with pretrain steps, through a ``state_dict`` round trip) and
  ``fetch_actions`` against JAX's;
- the replay rows: JAX's ``main`` and the port's, warm-up only, on the same
  GridWorld trajectory (JAX's ``JaxVectorEnv`` behind JAX's loop, the port's
  stepping ``DeviceVectorEnv`` fed JAX's reset draws) with the same action
  draws; every checkpoint's buffer read back, bit for bit, across episode
  ends (terminations and truncations).  JAX's env construction and action
  draws are patched inside the test only;
- CLI runs on the CPU: GridWorld, and CartPole with the decoupled RSSM and
  prioritized replay.  Each prints a test reward, writes a checkpoint that
  JAX's ``load_checkpoint`` reads (the agent, on which JAX's modules compute
  the port's player step to 1e-5), and resumes for exactly one iteration;
- a CPU rehearsal of ``chip_smoke.py``'s ``dv3_cli`` phase;
- the knobs that raise, each naming its ROADMAP item, and the exp's
  ``buffer.memmap: False``.
"""

import os

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3 import agent as jax_agent
from sheeprl_tpu.cli import run as jax_run
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.envs.jax import JaxVectorEnv
from sheeprl_tpu.envs.jax import core as jax_core
from sheeprl_tpu.envs.jax.gridworld import GridWorldJax
from sheeprl_tpu.parallel.mesh import MeshRuntime as JaxRuntime
from sheeprl_tpu.utils import utils as jax_utils
from sheeprl_tpu.utils.callback import load_checkpoint as jax_load_checkpoint
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_player
from sheeprl_tpu_torch.cli import run
from sheeprl_tpu_torch.config import compose as port_compose
from sheeprl_tpu_torch.envs.device import DeviceVectorEnv, make_device_env
from sheeprl_tpu_torch.parallel.mesh import MeshRuntime
from sheeprl_tpu_torch.utils import env as port_env
from sheeprl_tpu_torch.utils.ckpt_format import load_checkpoint
from sheeprl_tpu_torch.utils.convert import flatten_tree, load_flax_params
from sheeprl_tpu_torch.utils.utils import Ratio, fetch_actions

from test_torch_gridworld import grid_reset_noise

TOL = 1e-5
TINY = [
    "algo.dense_units=16",
    "algo.mlp_layers=1",
    "algo.world_model.recurrent_model.recurrent_state_size=16",
    "algo.world_model.representation_model.hidden_size=16",
    "algo.world_model.transition_model.hidden_size=16",
    "algo.world_model.stochastic_size=4",
    "algo.world_model.discrete_size=4",
    "algo.world_model.reward_model.bins=15",
    "algo.critic.bins=15",
    "algo.per_rank_batch_size=4",
    "algo.per_rank_sequence_length=8",
    "algo.horizon=3",
]
MLP_ONLY = ["algo.cnn_keys.encoder=[]", "algo.cnn_keys.decoder=[]", "algo.mlp_keys.encoder=[state]",
            "algo.mlp_keys.decoder=[state]"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dv3_args(tmp_path, name, env="jax_gridworld", extra=()):
    return ["exp=dreamer_v3", f"env={env}", "algo.env_backend=jax", "fabric.accelerator=cpu", "metric.log_level=0",
            f"root_dir={tmp_path}", f"run_name={name}", *MLP_ONLY, *TINY, *extra]


# ---------------------------------------------------------------- (c) helpers
def test_ratio_matches_jax_through_a_state_dict_round_trip():
    """The gradient steps each call grants, with pretrain steps and a
    fractional ratio, and after a ``state_dict`` round trip midway."""
    for ratio, pretrain in ((0.5, 0), (1.0, 10), (0.25, 3), (2.0, 0), (0.0, 0)):
        mine, theirs = Ratio(ratio, pretrain_steps=pretrain), jax_utils.Ratio(ratio, pretrain_steps=pretrain)
        steps = [7 + 4 * i for i in range(12)]
        got, want = [], []
        for i, step in enumerate(steps):
            if i == 6:
                saved = mine.state_dict()
                assert saved == theirs.state_dict()
                mine = Ratio(99.0).load_state_dict(saved)
            got.append(mine(step))
            want.append(theirs(step))
        assert got == want, (ratio, pretrain)
    with pytest.raises(ValueError):
        Ratio(-1.0)
    with pytest.raises(ValueError):
        Ratio(1.0, pretrain_steps=-1)


@pytest.mark.parametrize("continuous", [False, True])
def test_fetch_actions_matches_jax(continuous):
    rng = np.random.default_rng(0)
    dims = (3,) if continuous else (3, 2)
    heads = [rng.normal(size=(1, 5, d)).astype(np.float32) for d in dims]
    a_p, r_p = fetch_actions([torch.from_numpy(h) for h in heads], dims, continuous, 5)
    a_j, r_j = jax_utils.fetch_actions([jnp.asarray(h) for h in heads], dims, continuous, 5)
    np.testing.assert_array_equal(a_p, a_j)
    np.testing.assert_array_equal(r_p, r_j)
    assert a_p.shape == (1, 5, sum(dims))


# ---------------------------------------------------------------- (d) replay rows
GRID = {"size": 5, "view": 3}
N_ENVS, LIMIT, STEPS, EVERY = 3, 6, 30, 10


class _FedVectorEnv(DeviceVectorEnv):
    """The port's stepping vector env with JAX's reset draws fed in (the
    key chains of ``JaxVectorEnv(seed)``) and the actions from a list."""

    def __init__(self, env_j, *args, actions=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.env_j, self.actions, self.t = env_j, actions, 0

    def _keys(self, fn):
        return jax.vmap(fn)(jnp.arange(self.num_envs))

    def reset(self, *, seed=None, noise=None):
        self.base, self.t = jax.random.PRNGKey(int(seed)), 0
        return super().reset(noise=grid_reset_noise(self.env_j, self._keys(lambda i: jax_core.initial_reset_key(self.base, i))))

    def step(self, actions, reset_noise=None):
        t, self.t = self.t, self.t + 1
        keys = self._keys(lambda i: jax_core.step_keys(self.base, t, i)[1])
        return super().step(actions, reset_noise=grid_reset_noise(self.env_j, keys))

    def sample_actions(self):
        return torch.from_numpy(self.actions.pop(0))


def _draws(seed, n_actions):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, n_actions, size=N_ENVS) for _ in range(STEPS + 2)]


def _buffers(path, loader):
    """Every env's sub-buffer: the rows written so far (the ring's other rows
    are uninitialised), the write head and the fill flag."""
    out = {}
    for i, sub in enumerate(loader(path)["rb"]["sub"]):
        rows = sub["buffer_size"] if sub["full"] else sub["pos"]
        out.update(flatten_tree({f"sub{i}": {k: np.asarray(v)[:rows] for k, v in sub["data"].items()}}))
        out[f"sub{i}/pos"], out[f"sub{i}/full"] = np.asarray(sub["pos"]), np.asarray(sub["full"])
    return out


def test_replay_rows_match_jax_main(tmp_path, monkeypatch):
    """Warm-up only (learning starts after the run): the rows of every env's
    sub-buffer in every checkpoint, data, write head and fill flag, bit
    for bit; the trajectory holds goals reached and time-limit truncations."""
    common = ["env=jax_gridworld", "algo.env_backend=jax", "fabric.accelerator=cpu", "metric.log_level=0",
              "env.capture_video=False", "buffer.memmap=False", "algo.run_test=False", f"env.num_envs={N_ENVS}",
              f"env.max_episode_steps={LIMIT}", "env.wrapper.size=5", "env.wrapper.view=3",
              f"algo.total_steps={STEPS * N_ENVS}", f"algo.learning_starts={10 * STEPS * N_ENVS}",
              f"checkpoint.every={EVERY * N_ENVS}", "checkpoint.save_last=True", "buffer.size=60", "seed=3",
              *MLP_ONLY, *TINY]
    env_j = GridWorldJax(max_episode_steps=128, **GRID)

    jax_actions = _draws(1, 4)
    made = []

    def jax_vector_env(thunks, **kwargs):
        envs = JaxVectorEnv(env_j, len(thunks), seed=3, max_episode_steps=LIMIT)
        envs.action_space.sample = lambda: jax_actions.pop(0)
        made.append(envs)
        return envs

    monkeypatch.setattr(gym.vector, "SyncVectorEnv", jax_vector_env)
    jax_run(["exp=dreamer_v3", f"root_dir={tmp_path}/jax", "run_name=rows", *common])
    assert made

    def port_vector_env(cfg, runtime, **kwargs):
        return _FedVectorEnv(env_j, make_device_env("jax_gridworld", max_episode_steps=128, **GRID), N_ENVS,
                             max_episode_steps=LIMIT, device="cpu", actions=_draws(1, 4))

    monkeypatch.setattr(port_env, "make_train_envs", port_vector_env)
    out = run(["exp=dreamer_v3", f"root_dir={tmp_path}/port", "run_name=rows", *common])
    assert out["gradient_steps"] == 0

    ckpt_dirs = [tmp_path / pkg / "rows" / "version_0" / "checkpoint" for pkg in ("jax", "port")]
    names = sorted(os.listdir(ckpt_dirs[0]))
    assert names == sorted(os.listdir(ckpt_dirs[1])) and len(names) == STEPS // EVERY
    ends = 0
    for name in names:
        want = _buffers(ckpt_dirs[0] / name, jax_load_checkpoint)
        got = _buffers(ckpt_dirs[1] / name, load_checkpoint)
        assert set(got) == set(want), name
        for k in want:
            w, g = np.asarray(want[k]), np.asarray(got[k])
            assert g.dtype == w.dtype and g.shape == w.shape, (name, k)
            np.testing.assert_array_equal(g, w, err_msg=f"{name}: {k}")
    flags = {k: sum(float(np.asarray(got[f"sub{i}/{k}"]).sum()) for i in range(N_ENVS))
             for k in ("terminated", "truncated", "is_first")}
    assert flags["terminated"] > 0 and flags["truncated"] > 0 and flags["is_first"] > N_ENVS


# ---------------------------------------------------------------- (e) CLI runs
def _port_player_steps(player, obs_seq, noise_seq, dims, s, d):
    rssm, n = player.world_model.rssm, obs_seq[0].shape[0]
    rec, stoch = rssm.get_initial_states((n,))
    stoch, act = stoch.reshape(n, -1), torch.zeros(n, sum(dims))
    out = []
    with torch.no_grad():
        for obs, noise in zip(obs_seq, noise_seq):
            emb = player.world_model.encoder({"state": torch.from_numpy(obs)})
            rec = rssm.recurrent_step(torch.cat([stoch, act], -1), rec)
            _, st = rssm._representation(emb, rec, noise=torch.from_numpy(noise))
            stoch = st.reshape(n, s * d)
            heads, _ = player.actor(torch.cat([stoch, rec], -1), True)
            act = torch.cat(heads, -1)
            out.append((rec.numpy(), stoch.numpy(), act.numpy()))
    return out


def _jax_player_steps(cfg_j, state, obs_space, obs_seq, noise_seq, dims, s, d):
    rt = JaxRuntime(devices=1, accelerator="cpu", precision="32-true")
    rt.launch()
    wm, actor, _, params = jax_agent.build_agent(
        rt, dims, False, cfg_j, obs_space, state["world_model"], state["actor"], state["critic"], state["target_critic"]
    )
    p_wm, p_actor = params["world_model"], params["actor"]
    n = obs_seq[0].shape[0]
    rec, stoch = wm.rssm.apply(p_wm["rssm"], (n,), method=jax_agent.RSSM.get_initial_states)
    stoch, act = stoch.reshape(n, -1), jnp.zeros((n, sum(dims)))
    out = []
    for obs, noise in zip(obs_seq, noise_seq):
        emb = wm.encoder.apply(p_wm["encoder"], {"state": jnp.asarray(obs)})
        rec = wm.rssm.apply(p_wm["rssm"], jnp.concatenate([stoch, act], -1), rec, method=jax_agent.RSSM.recurrent_step)
        rec_in = None if cfg_j.algo.world_model.decoupled_rssm else rec
        _, st = wm.rssm.apply(p_wm["rssm"], emb, None, rec_in, jnp.asarray(noise), method=jax_agent.RSSM._representation)
        stoch = st.reshape(n, s * d)
        heads, _ = actor.apply(p_actor, jnp.concatenate([stoch, rec], -1), True, None)
        act = jnp.concatenate(heads, -1)
        out.append((np.asarray(rec), np.asarray(stoch), np.asarray(act)))
    return out


@pytest.mark.parametrize(
    "env,extra",
    [
        ("jax_gridworld", ["algo.world_model.recurrent_model.fused=True", "buffer.device_cache=True",
                           "buffer.per_kernel=pallas"]),
        ("jax_cartpole", ["algo.world_model.decoupled_rssm=True", "algo.world_model.recurrent_model.fused_seq=True",
                          "buffer.prioritized=True", "buffer.per_kernel=pallas"]),
    ],
)
def test_cli_run_checkpoint_read_by_jax_and_resume(tmp_path, capsys, env, extra):
    """Train, test, checkpoint; JAX reads the checkpoint and its modules on
    the checkpoint's parameters compute the port's player steps; a resume
    runs exactly one more iteration."""
    args = dv3_args(tmp_path, "cli", env, [*extra, "algo.learning_starts=32", "algo.total_steps=64"])
    out = run(args)
    assert out["gradient_steps"] > 0 and out["iterations"] == 16 and out["test_reward"] is not None
    assert "Test - Reward:" in capsys.readouterr().out
    state_j = jax_load_checkpoint(out["checkpoint"])
    assert {"world_model", "actor", "critic", "target_critic", "opt_states", "moments", "ratio", "rb"} <= set(state_j)
    if env == "jax_cartpole":
        assert "replay_priority" in state_j

    cfg = port_compose(overrides=args)
    dev_env = make_device_env(env, **({"size": 9, "view": 5} if env == "jax_gridworld" else {}))
    dims = (dev_env.action_space.n,)
    s, d = 4, 4
    player = build_player(MeshRuntime(device="cpu").launch(), dims, False, cfg, dev_env.observation_space)
    load_flax_params(player, {k: load_checkpoint(out["checkpoint"])[k] for k in ("world_model", "actor")})
    rng = np.random.default_rng(0)
    obs_dim = dev_env.observation_space["state"].shape[0]
    obs_seq = [rng.normal(size=(3, obs_dim)).astype(np.float32) for _ in range(4)]
    noise_seq = [(-np.log(-np.log(rng.uniform(1e-12, 1.0, (3, s, d))))).astype(np.float32) for _ in range(4)]
    obs_space = gym.spaces.Dict({"state": gym.spaces.Box(-np.inf, np.inf, (obs_dim,), np.float32)})
    mine = _port_player_steps(player, obs_seq, noise_seq, dims, s, d)
    theirs = _jax_player_steps(jax_compose(overrides=args), state_j, obs_space, obs_seq, noise_seq, dims, s, d)
    for (r_p, s_p, a_p), (r_j, s_j, a_j) in zip(mine, theirs):
        np.testing.assert_allclose(r_p, r_j, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(s_p, s_j, rtol=TOL, atol=TOL)  # straight-through one-hots
        np.testing.assert_array_equal(s_p.reshape(3, s, d).argmax(-1), s_j.reshape(3, s, d).argmax(-1))
        np.testing.assert_array_equal(a_p.argmax(-1), a_j.argmax(-1))

    resumed = run(dv3_args(tmp_path, "cli_resumed", env, [*extra, "algo.total_steps=68",
                                                          f"checkpoint.resume_from={out['checkpoint']}"]))
    assert resumed["iterations"] == 1 and resumed["policy_step"] == 68 and os.path.exists(resumed["checkpoint"])
    assert load_checkpoint(resumed["checkpoint"])["iter_num"] == 17


# ---------------------------------------------------------------- (f) chip_smoke rehearsal
def test_chip_smoke_dv3_cli_phase_runs_on_cpu():
    """``chip_smoke.py``'s ``dv3_cli`` phase at tiny widths: both runs, the
    loop rates, the resume, and the checkpoint's player against a second
    CPU copy (identical here)."""
    import chip_smoke

    res = chip_smoke.run_dv3_cli("cpu", overrides=TINY, learning_starts=32, train_iters=4, profile=False)
    assert set(res) == set(chip_smoke.DV3_CLI_RUNS)
    for row in res.values():
        assert row["gradient_steps"] > 0 and row["policy_steps_per_s_collect"] > 0 and row["test_reward"] is not None
        assert row["training_iterations"] == 5 and row["launches"] == {}  # plain versions on the CPU
        assert row["draw_vs_plain"]["bytes_equal"] and "gather_windows" in row["draw_vs_plain"]["kernels"]
    assert {"sum_tree_sample", "sum_tree_write"} <= set(res["cartpole"]["draw_vs_plain"]["kernels"])
    assert res["gridworld"]["resumed"]["iterations"] == 1
    assert res["gridworld"]["player_vs_plain"]["max_abs_state_err"] == 0.0


# ---------------------------------------------------------------- (g) scope
def test_exp_refuses_what_is_not_ported(tmp_path):
    """``exp=dreamer_v3`` composes ``buffer.memmap: False``; the knobs that
    raise name their ROADMAP items."""
    assert port_compose(overrides=["exp=dreamer_v3"]).buffer.memmap is False
    cases = {
        "buffer.memmap=True": "A2",
        "fabric.devices=2": "A5",
        "algo.sentinel.enabled=True": "A2",
        "metric.telemetry=True": "A7",
        "fabric.precision=bf16-true": "A2",
        "env.capture_video=True": "A2",
        "env.reward_as_observation=True": "A2",
        "env.actions_as_observation.num_stack=2": "A2",
        "env.mask_velocities=True": "A2",
        "algo.cnn_keys.encoder=[rgb]": "A2",
        "algo.env_backend=host": "A2",
    }
    for override, item in cases.items():
        with pytest.raises((NotImplementedError, ValueError), match=item):
            run(dv3_args(tmp_path, "scope", extra=["algo.total_steps=8", override]))
    with pytest.raises(ValueError, match="sync_env"):
        run(dv3_args(tmp_path, "scope", extra=["algo.total_steps=8", "env.sync_env=False"]))
