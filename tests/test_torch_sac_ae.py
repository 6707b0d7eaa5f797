"""The port's SAC-AE (``algos/sac_ae``) against the JAX package's, on the
CPU at small widths (hidden 16, dense 16, features 8, 32 conv channels, a
16x16 screen).

- the modules on JAX's weights: the conv encoder (delta-orthogonal stack,
  dense, LayerNorm, tanh), the MLP encoder, the conv decoder (its stride-2
  transposed conv's ((2, 3), (2, 3)) pads) and the MLP decoder, the Q
  ensemble, the actor's samples and log-probs from JAX's normals and its
  greedy actions, and ``preprocess_obs``;
- the train function over 4 gradient steps against JAX's, from a counter at
  which every cadence both fires and skips (actor and targets every 2,
  decoder every 3), with image and vector keys, and at the published
  cadences with vector keys only: the losses to 1e-3 relative, the
  parameters to 3e-6 after the 4 steps and the five Adam states, as SAC's
  parity holds them;
- the trees and the five Adam states both ways, JAX's layout;
- the replay rows of the port's ``main`` against JAX's, each key and its
  ``next_`` key, bit for bit (``test_torch_sac_loop.py``'s counter env);
- a CLI run whose checkpoint JAX's ``build_agent`` reads, and a resume;
- a CPU rehearsal of ``chip_smoke.py``'s ``sac_ae_cli`` phase.
"""

import os

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.sac.sac import _make_optimizer as jax_make_optimizer
from sheeprl_tpu.algos.sac_ae import agent as jax_agent
from sheeprl_tpu.algos.sac_ae.sac_ae import make_train_fn as jax_make_train_fn
from sheeprl_tpu.algos.sac_ae.utils import preprocess_obs as jax_preprocess_obs
from sheeprl_tpu.cli import run as jax_run
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.envs.jax import JaxVectorEnv
from sheeprl_tpu.parallel.mesh import MeshRuntime as JaxRuntime
from sheeprl_tpu.utils.callback import load_checkpoint as jax_load_checkpoint
from sheeprl_tpu_torch.algos.sac_ae import agent as port_agent
from sheeprl_tpu_torch.algos.sac_ae.sac_ae import make_train_state, opt_groups
from sheeprl_tpu_torch.algos.sac_ae.utils import preprocess_obs
from sheeprl_tpu_torch.cli import run
from sheeprl_tpu_torch.config import compose as port_compose
from sheeprl_tpu_torch.parallel.mesh import MeshRuntime
from sheeprl_tpu_torch.utils import env as port_env
from sheeprl_tpu_torch.utils.ckpt_format import load_checkpoint
from sheeprl_tpu_torch.utils.convert import (
    adam_state_from_tree,
    adam_state_to_tree,
    flatten_tree,
    flax_to_torch,
    load_flax_params,
    opt_state_to_torch,
    torch_to_flax,
)

from test_torch_sac_loop import EVERY, LIMIT, N_ENVS, STEPS, CounterJax, CounterPort, _draws, _FedVectorEnv, _rows

TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 1e-3
PARAM_ATOL = 3e-6
G, BATCH, ACT = 4, 8, 2
SMALL = ["exp=sac_ae", "algo.hidden_size=16", "algo.dense_units=16", "algo.encoder.features_dim=8",
         "algo.cnn_channels_multiplier=1", f"algo.per_rank_batch_size={BATCH}"]
STATE = gym.spaces.Box(-np.inf, np.inf, (5,), np.float32)
RGB = gym.spaces.Box(0, 255, (16, 16, 3), np.uint8)
ACTIONS = gym.spaces.Box(-2.0, 2.0, (ACT,), np.float32)
# name: (overrides, observation keys, the counter of the first step)
CASES = {
    "pixels_cadences": (["algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]",
                         "algo.decoder.per_rank_update_freq=3"], ("rgb", "state"), 1),
    "vectors_published": (["algo.cnn_keys.encoder=[]", "algo.mlp_keys.encoder=[state]"], ("state",), 0),
}
GROUPS = ("critic", "actor", "alpha", "encoder", "decoder")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _obs_space(keys):
    return gym.spaces.Dict({k: {"state": STATE, "rgb": RGB}[k] for k in keys})


def sac_ae_pair(name):
    """The small SAC-AE of ``CASES[name]`` in both packages on the same
    weights and Adam states, with each package's train function; the
    critics' last layers get larger random weights so that the Q values are
    not rounding noise."""
    extra, keys, counter0 = CASES[name]
    overrides = SMALL + extra
    obs_space = _obs_space(keys)
    cfg_j = jax_compose(overrides=overrides)
    rt = JaxRuntime(devices=1, accelerator="cpu", precision="32-true")
    rt.launch()
    modules, params, target_entropy = jax_agent.build_agent(rt, cfg_j, obs_space, ACTIONS)
    params = _np_tree(params)
    rng = np.random.default_rng(7)
    for tree in (params["critic"]["qfs"], params["target"]["qfs"]):
        kernel = tree["params"]["Dense_2"]["kernel"]
        tree["params"]["Dense_2"]["kernel"] = rng.normal(scale=0.3, size=kernel.shape).astype(np.float32)
    algo = cfg_j.algo
    txs = tuple(jax_make_optimizer(algo[g].optimizer, "32-true") for g in GROUPS)
    cpu = jax.devices("cpu")[0]
    jparams = jax.device_put(params, cpu)
    opt = jax.device_put({"critic": txs[0].init(jparams["critic"]), "actor": txs[1].init(jparams["actor"]),
                          "alpha": txs[2].init(jparams["log_alpha"]), "encoder": txs[3].init(jparams["critic"]["encoder"]),
                          "decoder": txs[4].init(jparams["decoder"])}, cpu)
    train_j = jax_make_train_fn(rt, modules, txs, cfg_j, target_entropy)

    cfg_t = port_compose(overrides=overrides)
    runtime = MeshRuntime(device="cpu", seed=0).launch()
    agent, entropy_t = port_agent.build_agent(runtime, cfg_t, obs_space, ACTIONS)
    assert entropy_t == target_entropy
    load_flax_params(agent, params)
    state = make_train_state(runtime, agent, cfg_t, entropy_t)
    opt_np = _np_tree(opt)
    for g, module in opt_groups(agent).items():
        state.opt_states[g] = opt_state_to_torch(opt_np[g], module, g)
    return {"jax": {"params": jparams, "opt": opt, "train": train_j, "device": cpu, "modules": modules},
            "agent": agent, "state": state, "cfg": cfg_t, "keys": keys, "counter0": counter0}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    return sac_ae_pair(request.param)


def batch(rng, keys, g=G):
    data = {"actions": rng.uniform(-2, 2, size=(g, BATCH, ACT)).astype(np.float32),
            "rewards": rng.normal(size=(g, BATCH, 1)).astype(np.float32),
            "terminated": (rng.uniform(size=(g, BATCH, 1)) < 0.2).astype(np.float32),
            "truncated": np.zeros((g, BATCH, 1), np.float32)}
    for k in keys:
        for prefix in ("", "next_"):
            data[prefix + k] = (rng.integers(0, 256, size=(g, BATCH, 16, 16, 3)).astype(np.float32) if k == "rgb"
                                else rng.normal(size=(g, BATCH, 5)).astype(np.float32))
    return data


def jax_noise(key, data, keys):
    """JAX's draws in ``train`` from ``key``: ``split(key, G)`` step keys,
    each ``split(k, 3)`` -> the next actions' normals, the actor's normals
    and the image targets' uniforms (one key for every image key)."""
    out = {"next": [], "actor": [], "pixels": {k: [] for k in keys if k == "rgb"}}
    for k in jax.random.split(key, G):
        k1, k2, k3 = jax.random.split(k, 3)
        out["next"].append(np.asarray(jax.random.normal(k1, (BATCH, ACT))))
        out["actor"].append(np.asarray(jax.random.normal(k2, (BATCH, ACT))))
        for kk in out["pixels"]:
            out["pixels"][kk].append(np.asarray(jax.random.uniform(k3, data[kk].shape[1:])))
    return {"next": _t(np.stack(out["next"])), "actor": _t(np.stack(out["actor"])),
            "pixels": {k: _t(np.stack(v)) for k, v in out["pixels"].items()}}


# ---------------------------------------------------------------- modules
def test_modules_match_jax():
    """The encoders, decoders, Q functions and the actor on JAX's weights,
    image and vector keys, and the 5-bit targets of ``preprocess_obs``."""
    p = sac_ae_pair("pixels_cadences")
    modules, params, agent = p["jax"]["modules"], _np_tree(p["jax"]["params"]), p["agent"]
    rng = np.random.default_rng(1)
    obs = {"rgb": (rng.integers(0, 256, size=(6, 16, 16, 3)) / 255.0).astype(np.float32),
           "state": rng.normal(size=(6, 5)).astype(np.float32)}
    tobs = {k: _t(v) for k, v in obs.items()}
    with torch.no_grad():
        feat = agent.critic.encoder(tobs)
        feat_j = modules.critic_features(params["critic"]["encoder"], obs)
        np.testing.assert_allclose(feat.numpy(), np.asarray(feat_j), **TOL)
        rec, rec_j = agent.decoder(feat), modules.decode(params["decoder"], feat_j)
        assert rec["rgb"].shape == (6, 16, 16, 3)
        for k in ("rgb", "state"):
            np.testing.assert_allclose(rec[k].numpy(), np.asarray(rec_j[k]), **TOL)
        act = rng.uniform(-2, 2, size=(6, ACT)).astype(np.float32)
        np.testing.assert_allclose(agent.critic.qfs(feat, _t(act)).numpy(),
                                   np.asarray(modules.q_values(params["critic"]["qfs"], feat_j, act)), **TOL)
        key = jax.random.PRNGKey(3)
        a_j, logp_j = modules.actions_and_log_probs(params["critic"]["encoder"], params["actor"], obs, key)
        a, logp = port_agent.actions_and_log_probs(agent.actor, agent.critic.encoder, tobs,
                                                   _t(jax.random.normal(key, (6, ACT))))
        np.testing.assert_allclose(a.numpy(), np.asarray(a_j), **TOL)
        np.testing.assert_allclose(logp.numpy(), np.asarray(logp_j), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(port_agent.greedy_actions(agent.actor, agent.critic.encoder, tobs).numpy(),
                                   np.asarray(modules.greedy_actions(params["critic"]["encoder"], params["actor"], obs)),
                                   **TOL)
    raw = rng.integers(0, 256, size=(4, 16, 16, 3)).astype(np.float32)
    u = jax.random.uniform(jax.random.PRNGKey(5), raw.shape)
    np.testing.assert_array_equal(preprocess_obs(_t(raw), _t(u), bits=5).numpy(),
                                  np.asarray(jax_preprocess_obs(jnp.asarray(raw), jax.random.PRNGKey(5), bits=5)))
    with pytest.raises(ValueError, match="even"):
        port_agent.build_agent(MeshRuntime(device="cpu").launch(), p["cfg"],
                               gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (17, 17, 3), np.uint8),
                                                "state": STATE}), ACTIONS)


# ---------------------------------------------------------------- the train function
def test_train_function_matches_jax(pair):
    """Four gradient steps from ``counter0``: each loss (averaged over the
    steps its branch fired), the parameters and the five Adam states."""
    j, state, agent = pair["jax"], pair["state"], pair["agent"]
    data = batch(np.random.default_rng(0), pair["keys"])
    key = jax.random.PRNGKey(11)
    j["params"], j["opt"], mj = j["train"](j["params"], j["opt"], jax.device_put(data, j["device"]),
                                           jax.device_put(key, j["device"]), jnp.asarray(pair["counter0"]))
    noise = jax_noise(key, data, pair["keys"])
    state.opt_states, mt = state.train_fn(state.opt_states, {k: _t(v) for k, v in data.items()}, pair["counter0"],
                                          noise=noise)
    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    want = flax_to_torch(_np_tree(j["params"]), agent)
    got = agent.state_dict()
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=PARAM_ATOL, err_msg=k)
    opt_np = _np_tree(j["opt"])
    fired = {g: 0 for g in GROUPS}
    for step in range(G):
        c = pair["counter0"] + step
        fired["critic"] += 1
        fired["actor"] += c % 2 == 0
        fired["alpha"] += c % 2 == 0
        fired["encoder"] += c % int(pair["cfg"].algo.decoder.per_rank_update_freq) == 0
    fired["decoder"] = fired["encoder"]
    assert 0 < fired["actor"] < G and (pair["counter0"] == 0 or 0 < fired["decoder"] < G)
    for g, module in opt_groups(agent).items():
        ref, mine = opt_state_to_torch(opt_np[g], module, g), state.opt_states[g]
        assert mine.count == ref.count == fired[g], g
        for k in ref.mu:
            for a, b in ((mine.mu[k], ref.mu[k]), (mine.nu[k], ref.nu[k])):
                assert float((a - b).abs().max()) <= 1e-4 * (float(b.abs().max()) + 1e-30), f"{g} {k}"


def test_trees_and_adam_states_both_ways(pair):
    agent, state = pair["agent"], pair["state"]
    tree, jax_tree = torch_to_flax(agent), _np_tree(pair["jax"]["params"])
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(jax_tree)
    back = flax_to_torch(tree, agent)
    for k, v in agent.state_dict().items():
        assert torch.equal(back[k], v), k
    for g, module in opt_groups(agent).items():
        saved = adam_state_to_tree(state.opt_states[g], module, g)
        if g != "alpha":
            want = jax_tree["critic"]["encoder"] if g == "encoder" else jax_tree[g]
            assert flatten_tree(saved["mu"]).keys() == flatten_tree(want).keys(), g
        loaded = adam_state_from_tree(saved, module, g)
        for k in state.opt_states[g].mu:
            assert torch.equal(loaded.mu[k], state.opt_states[g].mu[k]) and torch.equal(loaded.nu[k], state.opt_states[g].nu[k])


# ---------------------------------------------------------------- the env loop
def test_replay_rows_match_jax_main(tmp_path, monkeypatch):
    """Warm-up only: every checkpoint's rows (each key and its ``next_`` key,
    the final observations where an episode ended, actions, rewards, ends),
    write head and fill flag, bit for bit, the counter env behind both."""
    common = ["exp=sac_ae", "env=jax_pendulum", "env.id=jax_pendulum", "algo.env_backend=jax",
              "fabric.accelerator=cpu", "metric.log_level=0", "env.capture_video=False", "buffer.memmap=False",
              "algo.run_test=False", f"env.num_envs={N_ENVS}", "algo.mlp_keys.encoder=[state]",
              "algo.cnn_keys.encoder=[]", "algo.hidden_size=8", f"algo.total_steps={STEPS * N_ENVS}",
              f"algo.learning_starts={10 * STEPS * N_ENVS}", f"checkpoint.every={EVERY * N_ENVS}",
              "checkpoint.save_last=True", "buffer.size=60", "seed=5", "env.sync_env=True"]
    jax_actions = _draws()

    def jax_vector_env(thunks, **kwargs):
        envs = JaxVectorEnv(CounterJax(), len(thunks), seed=5, max_episode_steps=LIMIT)
        envs.action_space.sample = lambda: jax_actions.pop(0)
        return envs

    monkeypatch.setattr(gym.vector, "SyncVectorEnv", jax_vector_env)
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
        assert set(got) == set(want) and {"state", "next_state"} <= set(got), name
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, (name, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name}: {k}")
    assert got["terminated"].sum() > 0 and got["truncated"].sum() > 0


def sac_ae_args(tmp_path, name, extra=()):
    return ["exp=sac_ae", "env=jax_pendulum", "env.id=jax_pendulum", "algo.env_backend=jax", "fabric.accelerator=cpu",
            "metric.log_level=0", f"root_dir={tmp_path}", f"run_name={name}", "algo.mlp_keys.encoder=[state]",
            "algo.cnn_keys.encoder=[]", "algo.hidden_size=16", "algo.dense_units=16", f"algo.per_rank_batch_size={BATCH}",
            *extra]


def test_cli_run_checkpoint_read_by_jax_and_resume(tmp_path, capsys):
    """Through the device cache: a test reward, a checkpoint in JAX's layout
    (JAX's ``build_agent`` takes its ``agent``, and its greedy actions on it
    are the port's), the five Adam states, and a resume for one iteration."""
    extra = ["buffer.device_cache=True", "algo.learning_starts=32", "algo.total_steps=48"]
    out = run(sac_ae_args(tmp_path, "cli", extra))
    assert out["gradient_steps"] > 0 and out["test_reward"] is not None
    assert "Test - Reward:" in capsys.readouterr().out
    state_j = jax_load_checkpoint(out["checkpoint"])
    assert {"agent", "opt_states", "ratio", "rb"} <= set(state_j) and set(state_j["opt_states"]) == set(GROUPS)
    assert state_j["opt_states"]["decoder"]["count"] == out["gradient_steps"]
    rt = JaxRuntime(devices=1, accelerator="cpu", precision="32-true")
    rt.launch()
    obs_space = gym.spaces.Dict({"state": gym.spaces.Box(-np.inf, np.inf, (3,), np.float32)})
    action_space = gym.spaces.Box(-2.0, 2.0, (1,), np.float32)
    modules, params_j, _ = jax_agent.build_agent(rt, jax_compose(overrides=sac_ae_args(tmp_path, "cli", extra)),
                                                 obs_space, action_space, state_j["agent"])
    agent, _ = port_agent.build_agent(MeshRuntime(device="cpu").launch(), port_compose(
        overrides=sac_ae_args(tmp_path, "cli", extra)), obs_space, action_space)
    load_flax_params(agent, load_checkpoint(out["checkpoint"])["agent"])
    obs = {"state": np.random.default_rng(0).normal(size=(3, 3)).astype(np.float32)}
    with torch.no_grad():
        got = port_agent.greedy_actions(agent.actor, agent.critic.encoder, {"state": _t(obs["state"])})
    want = modules.greedy_actions(params_j["critic"]["encoder"], params_j["actor"], obs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    resumed = run(sac_ae_args(tmp_path, "cli_resumed", [*extra, "algo.total_steps=52",
                                                       f"checkpoint.resume_from={out['checkpoint']}"]))
    assert resumed["iterations"] == 1 and resumed["policy_step"] == 52 and os.path.exists(resumed["checkpoint"])


def test_chip_smoke_sac_ae_cli_phase_runs_on_cpu():
    """``chip_smoke.py``'s ``sac_ae_cli`` phase at small widths: the run, its
    draw check, the player against a second CPU copy and two steps against a
    CPU replica (identical here)."""
    import chip_smoke

    row = chip_smoke.run_sac_ae_cli("cpu", overrides=["algo.hidden_size=16", f"algo.per_rank_batch_size={BATCH}"],
                                    learning_starts=32, iters=4, profile=False)
    assert row["gradient_steps"] > 0 and row["dispatches"] >= 4 and row["launches"] == {}
    assert row["draw_vs_plain"]["bytes_equal"] and row["draw_vs_plain"]["kernels"] == ["gather_transitions"]
    assert row["player_vs_plain"]["max_abs_action_err"] == 0.0 and "step_vs_cpu_s" in row["seconds"]
    assert row["step_vs_cpu"]["max_abs_param_err"] == 0.0
