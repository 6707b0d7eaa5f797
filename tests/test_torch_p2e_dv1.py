"""The port's Plan2Explore-DreamerV1 (``algos/p2e_dv1``) against the JAX
package's, on the CPU at small widths (dense 16, one layer, H = 16,
stochastic 4, T = 8, B = 4, horizon 3, ``ensembles.n`` 3).

- the ensembles' forward (predicting the next embedded observation, its
  width the encoder's), member by member in JAX's vmapped order;
- two exploration train steps against JAX's ``make_train_fn`` on converted
  state, JAX's three noise streams rebuilt from its key: continuous actions
  (the published Pendulum case) and discrete actions with
  ``use_continues`` and an image key: every metric, the intrinsic reward
  (scaled by the published multiplier 10,000) among them, to 1e-4
  relative, the parameters and the Adam states;
- the trees and Adam states both ways (no target critics);
- the replay rows of the exploration ``main`` against JAX's, warm-up only,
  bit for bit, no ``is_first`` column;
- a checkpoint in the JAX package's layout finetuned by the port, and a
  port exploration run whose checkpoint JAX's ``build_agent`` reads,
  finetuned (the exploration amount decaying with the policy step) and
  resumed;
- a CPU rehearsal of ``chip_smoke.py``'s ``p2e_dv1_cli`` phase.

Tolerances as ``test_torch_dreamer_v1.py`` holds DreamerV1's step: metrics
1e-4 relative, parameters 2e-5 absolute after two steps, Adam moments 1e-4
of each tensor's largest magnitude; module outputs 1e-5.
"""

import os

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v2.dreamer_v2 import _make_optimizer as jax_make_optimizer
from sheeprl_tpu.algos.p2e_dv1 import agent as jax_agent
from sheeprl_tpu.algos.p2e_dv1.p2e_dv1_exploration import make_train_fn as jax_make_train_fn
from sheeprl_tpu.cli import run as jax_run
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.envs.jax import JaxVectorEnv
from sheeprl_tpu.envs.jax.gridworld import GridWorldJax
from sheeprl_tpu.parallel.mesh import MeshRuntime as JaxRuntime
from sheeprl_tpu.utils.callback import load_checkpoint as jax_load_checkpoint
from sheeprl_tpu.utils.ckpt_format import save_state as jax_save_state
from sheeprl_tpu.utils.utils import save_configs as jax_save_configs
from sheeprl_tpu_torch.algos.dreamer_v1.agent import PlayerDV1
from sheeprl_tpu_torch.algos.p2e_dv1 import agent as port_agent
from sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1_exploration import make_train_state
from sheeprl_tpu_torch.cli import run
from sheeprl_tpu_torch.config import compose as port_compose
from sheeprl_tpu_torch.envs.device import make_device_env
from sheeprl_tpu_torch.parallel.mesh import MeshRuntime
from sheeprl_tpu_torch.utils import env as port_env
from sheeprl_tpu_torch.utils.ckpt_format import load_checkpoint
from sheeprl_tpu_torch.utils.convert import (
    flatten_tree,
    flax_to_torch,
    load_flax_params,
    load_p2e_state,
    opt_state_to_torch,
    p2e_state,
    torch_to_flax,
)

from test_torch_dreamer_v1 import TINY, dv1_batch
from test_torch_dreamer_v2 import MLP_ONLY, actor_noise
from test_torch_dv3_loop import EVERY, GRID, LIMIT, N_ENVS, STEPS, _buffers, _draws, _FedVectorEnv

TOL = dict(rtol=1e-5, atol=1e-5)
STEP_RTOL = 1e-4
PARAM_ATOL = 2e-5
T, B, H = 8, 4, 3
S, REC, N_ENS = 4, 16, 3
P2E_TINY = [*TINY[1:], f"algo.ensembles.n={N_ENS}"]
STATE = gym.spaces.Box(-np.inf, np.inf, (5,), np.float32)
RGB = gym.spaces.Box(0, 255, (64, 64, 3), np.uint8)
# name: (actions_dim, continuous, overrides, observation keys)
CASES = {
    "continuous": ((1,), True, MLP_ONLY, ("state",)),
    "discrete_continues_rgb": (
        (4,), False,
        ["algo.world_model.use_continues=True", "algo.mlp_keys.encoder=[state]", "algo.cnn_keys.encoder=[rgb]"],
        ("state", "rgb"),
    ),
}
# the port's optimizer groups and the JAX tree's names for them
GROUPS = {"world_model": "world_model", "ensembles": "ensembles", "actor": "actor_task", "critic": "critic_task",
          "actor_exploration": "actor_exploration", "critic_exploration": "critic_exploration"}


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


def _mapping(group):
    return {"actor_exploration": "actor", "critic_exploration": "critic"}.get(group, group)


def p2e_pair(name):
    """The tiny P2E-DV1 of ``CASES[name]`` in both packages on the same
    weights and Adam states (the reward model's and both critics' heads
    with larger random weights), with each package's exploration step."""
    actions_dim, continuous, extra, keys = CASES[name]
    overrides = ["exp=p2e_dv1_exploration", *P2E_TINY, *extra]
    obs_space = _obs_space(keys)
    cfg_j = jax_compose(overrides=overrides)
    rt = JaxRuntime(devices=1, accelerator="cpu", precision="32-true")
    rt.launch()
    wm, actor, critic, ensemble, params = jax_agent.build_agent(rt, actions_dim, continuous, cfg_j, obs_space)
    params = _np_tree(params)
    rng = np.random.default_rng(7)
    for tree in (params["critic_task"], params["critic_exploration"], params["world_model"]["reward_model"]):
        kernel = tree["params"]["Dense_0"]["kernel"]
        tree["params"]["Dense_0"]["kernel"] = rng.normal(scale=0.5, size=kernel.shape).astype(np.float32)
    algo = cfg_j.algo

    def tx(node):
        return jax_make_optimizer(node.optimizer, node.clip_gradients, "32-true")

    txs = (tx(algo.world_model), tx(algo.ensembles), tx(algo.actor), tx(algo.critic), tx(algo.actor), tx(algo.critic))
    cpu = jax.devices("cpu")[0]
    jparams = jax.device_put(params, cpu)
    opt = jax.device_put({jg: t.init(jparams[jg]) for jg, t in zip(GROUPS.values(), txs)}, cpu)
    train_j = jax_make_train_fn(rt, wm, actor, critic, ensemble, txs, cfg_j, continuous, actions_dim)

    cfg_t = port_compose(overrides=overrides)
    runtime = MeshRuntime(device="cpu", seed=0).launch()
    agent = port_agent.build_agent(runtime, actions_dim, continuous, cfg_t, obs_space)
    load_flax_params(agent, params)
    state = make_train_state(runtime, agent, cfg_t, continuous, actions_dim)
    opt_np = _np_tree(opt)
    for g, jg in GROUPS.items():
        state.opt_states[g] = opt_state_to_torch(opt_np[jg], getattr(agent, g), _mapping(g))
    return {"jax": {"params": jparams, "opt": opt, "train": train_j, "device": cpu, "ensemble": ensemble,
                    "embedded": jax_agent.embedded_obs_dim(cfg_j, obs_space)},
            "agent": agent, "state": state, "cfg": cfg_t, "actions_dim": actions_dim, "continuous": continuous,
            "keys": keys, "obs_space": obs_space}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    return p2e_pair(request.param)


def p2e_noise(key, actions_dim, continuous):
    """JAX's draws in the exploration step from ``key``: ``split(key, 3)`` ->
    the dynamic loop's normals and the two imaginations' keys, each split
    into ``H`` step keys, each step's ``split(kk)`` -> the actor's draw and
    the transition's normals."""
    k_dyn, k_img_e, k_img_t = jax.random.split(key, 3)

    def imagination(k):
        img, acts = [], []
        for kk in jax.random.split(k, H):
            k_act, k_im = jax.random.split(kk)
            acts.append(actor_noise(k_act, actions_dim, continuous))
            img.append(np.asarray(jax.random.normal(k_im, (T * B, S))))
        return _t(np.stack(img)), _t(np.stack(acts))

    img_e, act_e = imagination(k_img_e)
    img_t, act_t = imagination(k_img_t)
    return {"dyn": _t(jax.random.normal(k_dyn, (T, B, S), jnp.float32)), "img_e": img_e, "act_e": act_e,
            "img_t": img_t, "act_t": act_t}


def _close_scaled(a, b, what):
    scale = float(b.abs().max()) + 1e-30
    assert float((a - b).abs().max()) <= STEP_RTOL * scale, what


# ---------------------------------------------------------------- the agent
def test_ensembles_forward_matches_jax_members_in_order(pair):
    j, agent = pair["jax"], pair["agent"]
    assert port_agent.embedded_obs_dim(pair["cfg"], pair["obs_space"]) == j["embedded"]
    assert agent.ensembles.head_weight.shape[-1] == j["embedded"] and not agent.ensembles.layer_norm
    x = np.random.default_rng(1).normal(size=(2, 5, S + REC + sum(pair["actions_dim"]))).astype(np.float32)
    want = np.asarray(jax.vmap(lambda p: j["ensemble"].apply(p, jnp.asarray(x)))(j["params"]["ensembles"]))
    with torch.no_grad():
        got = agent.ensembles(_t(x)).numpy()
    assert got.shape == want.shape == (N_ENS, 2, 5, j["embedded"])
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------- the exploration step
def test_exploration_steps_match_jax(pair):
    j, state, agent = pair["jax"], pair["state"], pair["agent"]
    rng = np.random.default_rng(0)
    for step in range(2):
        data = dv1_batch(rng, pair["actions_dim"], pair["continuous"], pair["keys"])
        key = jax.random.PRNGKey(100 + step)
        j["params"], j["opt"], mj = j["train"](j["params"], j["opt"], jax.device_put(data, j["device"]),
                                               jax.device_put(key, j["device"]))
        noise = p2e_noise(key, pair["actions_dim"], pair["continuous"])
        state.opt_states, state.moments, mt = state.train_fn(state.opt_states, state.moments,
                                                             {k: _t(v) for k, v in data.items()}, noise=noise)
        assert set(mt) == set(mj) and len(mt) == 22 and float(mj["Rewards/intrinsic"]) > 1.0  # the multiplier's scale
        for k in mj:
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=STEP_RTOL, atol=1e-7, err_msg=f"step {step} {k}")
        want = flax_to_torch(_np_tree(j["params"]), agent)
        got = agent.state_dict()
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=PARAM_ATOL, err_msg=f"step {step} {k}")
        opt_np = _np_tree(j["opt"])
        for g, jg in GROUPS.items():
            ref, mine = opt_state_to_torch(opt_np[jg], getattr(agent, g), _mapping(g)), state.opt_states[g]
            assert mine.count == ref.count == step + 1
            for k in ref.mu:
                _close_scaled(mine.mu[k], ref.mu[k], f"step {step} {g} mu {k}")
                _close_scaled(mine.nu[k], ref.nu[k], f"step {step} {g} nu {k}")


def test_trees_and_adam_states_both_ways(pair):
    agent, state = pair["agent"], pair["state"]
    params = _np_tree(pair["jax"]["params"])
    tree = torch_to_flax(agent)
    assert set(tree) == set(params) == set(GROUPS.values()) | {"world_model"}
    back, want = flatten_tree(tree), flatten_tree(params)
    assert back.keys() == want.keys()
    for k in want:  # the pair may have taken the exploration steps of the test before
        np.testing.assert_allclose(back[k], want[k], rtol=0, atol=PARAM_ATOL, err_msg=k)
    saved = p2e_state(agent, state)
    assert set(saved["opt_states"]) == set(GROUPS.values()) and "moments_task" not in saved
    fresh = p2e_pair("continuous" if pair["continuous"] else "discrete_continues_rgb")
    load_p2e_state(fresh["agent"], fresh["state"], saved)
    for k, v in agent.state_dict().items():
        assert torch.equal(fresh["agent"].state_dict()[k], v), k
    for g in GROUPS:
        a, b = fresh["state"].opt_states[g], state.opt_states[g]
        assert a.count == b.count and all(torch.equal(a.mu[k], b.mu[k]) and torch.equal(a.nu[k], b.nu[k]) for k in a.mu)
    assert agent.target_pairs() == []


# ---------------------------------------------------------------- the env loop
def p2e_args(tmp_path, name, exp="p2e_dv1_exploration", extra=()):
    return [f"exp={exp}", "env=jax_pendulum", "env.id=jax_pendulum", "algo.env_backend=jax", "fabric.accelerator=cpu",
            "metric.log_level=0", f"root_dir={tmp_path}", f"run_name={name}", *MLP_ONLY, *P2E_TINY, *extra]


def test_replay_rows_match_jax_main(tmp_path, monkeypatch):
    """Warm-up only: the exploration ``main``'s rows in every checkpoint, bit
    for bit against JAX's; DreamerV1's rows have no ``is_first`` column."""
    common = ["env=jax_gridworld", "algo.env_backend=jax", "fabric.accelerator=cpu", "metric.log_level=0",
              "env.capture_video=False", "buffer.memmap=False", "algo.run_test=False", f"env.num_envs={N_ENVS}",
              f"env.max_episode_steps={LIMIT}", "env.wrapper.size=5", "env.wrapper.view=3",
              f"algo.total_steps={STEPS * N_ENVS}", f"algo.learning_starts={10 * STEPS * N_ENVS}",
              f"checkpoint.every={EVERY * N_ENVS}", "checkpoint.save_last=True", "buffer.size=60", "seed=3",
              *MLP_ONLY, *P2E_TINY]
    env_j = GridWorldJax(max_episode_steps=128, **GRID)
    jax_actions = _draws(1, 4)

    def jax_vector_env(thunks, **kwargs):
        envs = JaxVectorEnv(env_j, len(thunks), seed=3, max_episode_steps=LIMIT)
        envs.action_space.sample = lambda: jax_actions.pop(0)
        return envs

    monkeypatch.setattr(gym.vector, "SyncVectorEnv", jax_vector_env)
    jax_run(["exp=p2e_dv1_exploration", f"root_dir={tmp_path}/jax", "run_name=rows", *common])

    def port_vector_env(cfg, runtime, **kwargs):
        return _FedVectorEnv(env_j, make_device_env("jax_gridworld", max_episode_steps=128, **GRID), N_ENVS,
                             max_episode_steps=LIMIT, device="cpu", actions=_draws(1, 4))

    monkeypatch.setattr(port_env, "make_train_envs", port_vector_env)
    out = run(["exp=p2e_dv1_exploration", f"root_dir={tmp_path}/port", "run_name=rows", *common])
    assert out["gradient_steps"] == 0

    ckpt_dirs = [tmp_path / pkg / "rows" / "version_0" / "checkpoint" for pkg in ("jax", "port")]
    names = sorted(os.listdir(ckpt_dirs[0]))
    assert names == sorted(os.listdir(ckpt_dirs[1])) and len(names) == STEPS // EVERY
    for name in names:
        want = _buffers(ckpt_dirs[0] / name, jax_load_checkpoint)
        got = _buffers(ckpt_dirs[1] / name, load_checkpoint)
        assert set(got) == set(want) and not any(k.endswith("/is_first") for k in got), name
        for k in want:
            w, g = np.asarray(want[k]), np.asarray(got[k])
            assert g.dtype == w.dtype and g.shape == w.shape, (name, k)
            np.testing.assert_array_equal(g, w, err_msg=f"{name}: {k}")


PENDULUM = gym.spaces.Dict({"state": gym.spaces.Box(-np.inf, np.inf, (3,), np.float32)})


def test_exploration_checkpoint_read_by_jax_then_finetuned(tmp_path, capsys, monkeypatch):
    """A port exploration run on Pendulum through the device cache: its
    checkpoint holds JAX's keys (no target critics) and JAX's
    ``build_agent`` reads it, its ensembles giving the port's values; the
    port's finetuning starts from it, acts with the decaying exploration
    amount, switches to the task actor and resumes."""
    extra = ["buffer.device_cache=True", "buffer.per_kernel=pallas", "algo.learning_starts=32", "algo.total_steps=48",
             "algo.replay_ratio=0.5", "env.max_episode_steps=50", "env.num_envs=1"]
    out = run(p2e_args(tmp_path, "expl", extra=extra))
    assert out["gradient_steps"] > 0 and out["test_reward"] is not None and not out["actor_switched"]
    assert "Test - Reward:" in capsys.readouterr().out
    state_j = jax_load_checkpoint(out["checkpoint"])
    keys = {"world_model", "actor_task", "critic_task", "actor_exploration", "critic_exploration", "ensembles"}
    assert keys | {"opt_states", "ratio", "rb"} <= set(state_j) and "target_critic_task" not in state_j
    cfg_j = jax_compose(overrides=p2e_args(tmp_path, "expl", extra=extra))
    rt = JaxRuntime(devices=1, accelerator="cpu", precision="32-true")
    rt.launch()
    *_, ens_j, params_j = jax_agent.build_agent(rt, (1,), True, cfg_j, PENDULUM, *(
        state_j[k] for k in ("world_model", "ensembles", "actor_task", "critic_task", "actor_exploration",
                             "critic_exploration")))
    agent = port_agent.build_agent(MeshRuntime(device="cpu").launch(), (1,), True,
                                   port_compose(overrides=p2e_args(tmp_path, "expl", extra=extra)), PENDULUM)
    load_flax_params(agent, {k: load_checkpoint(out["checkpoint"])[k] for k in keys})
    ens_in = np.random.default_rng(0).normal(size=(5, S + REC + 1)).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(
            agent.ensembles(_t(ens_in)).numpy(),
            np.asarray(jax.vmap(lambda p: ens_j.apply(p, jnp.asarray(ens_in)))(params_j["ensembles"])), **TOL)

    steps, inner = [], PlayerDV1.get_expl_amount

    def recording(self, step):
        steps.append(step)
        return inner(self, step)

    monkeypatch.setattr(PlayerDV1, "get_expl_amount", recording)
    fine = run(p2e_args(tmp_path, "fine", "p2e_dv1_finetuning", extra=[
        f"checkpoint.exploration_ckpt_path={out['checkpoint']}", "algo.learning_starts=32", "algo.total_steps=40",
        "algo.replay_ratio=0.5", "env.max_episode_steps=50", "env.num_envs=1"]))
    assert fine["actor_switched"] and fine["gradient_steps"] > 0 and fine["test_reward"] is not None
    assert steps[: 40] == list(range(1, 41))  # no random warm-up: the player acts from the first step
    state_f = jax_load_checkpoint(fine["checkpoint"])
    assert {"world_model", "actor_task", "critic_task", "actor_exploration", "opt_states"} <= set(state_f)
    assert "target_critic_task" not in state_f and set(state_f["opt_states"]) == {"world_model", "actor_task",
                                                                                  "critic_task"}
    again = run(p2e_args(tmp_path, "fine_resumed", "p2e_dv1_finetuning", extra=[
        "algo.total_steps=41", "env.max_episode_steps=50", "env.num_envs=1",
        f"checkpoint.resume_from={fine['checkpoint']}"]))
    assert again["iterations"] == 1 and again["policy_step"] == 41 and os.path.exists(again["checkpoint"])


def test_finetuning_starts_from_a_jax_exploration_checkpoint(tmp_path):
    """A checkpoint in the JAX package's layout (optax Adam states, its
    ``config.yaml`` two levels up): the port's finetuning loads the task
    modules, their Adam states and the exploration actor, and trains."""
    args = p2e_args(tmp_path, "jax_expl")
    cfg_j = jax_compose(overrides=args)
    rt = JaxRuntime(devices=1, accelerator="cpu", precision="32-true")
    rt.launch()
    *_, params = jax_agent.build_agent(rt, (1,), True, cfg_j, PENDULUM)
    algo = cfg_j.algo
    txs = {g: jax_make_optimizer(algo[n].optimizer, algo[n].clip_gradients, "32-true")
           for g, n in (("world_model", "world_model"), ("actor_task", "actor"), ("critic_task", "critic"))}
    log_dir = tmp_path / "jax_expl" / "version_0"
    jax_save_configs(cfg_j, str(log_dir))
    ckpt = log_dir / "checkpoint" / "ckpt_64_0.ckpt"
    jax_save_state(str(ckpt), _np_tree({
        **params, "opt_states": {g: t.init(params[g]) for g, t in txs.items()},
        "iter_num": 64, "batch_size": B, "last_log": 0, "last_checkpoint": 64,
    }))
    fine = run(p2e_args(tmp_path, "fine", "p2e_dv1_finetuning", extra=[
        f"checkpoint.exploration_ckpt_path={ckpt}", "algo.learning_starts=32", "algo.total_steps=40",
        "algo.replay_ratio=0.5", "algo.run_test=False", "env.num_envs=1"]))
    assert fine["gradient_steps"] > 0 and fine["actor_switched"]
    saved = load_checkpoint(fine["checkpoint"])
    assert saved["opt_states"]["world_model"]["count"] == fine["gradient_steps"]
    np.testing.assert_array_equal(flatten_tree(saved["actor_exploration"])["params/Dense_0/kernel"],
                                  np.asarray(params["actor_exploration"]["params"]["Dense_0"]["kernel"]))
    wm0, wm1 = flatten_tree(_np_tree(params["world_model"])), flatten_tree(saved["world_model"])
    assert wm0.keys() == wm1.keys() and any(not np.array_equal(wm0[k], wm1[k]) for k in wm0)


# ---------------------------------------------------------------- chip_smoke rehearsal
def test_chip_smoke_p2e_dv1_cli_phase_runs_on_cpu():
    """``chip_smoke.py``'s ``p2e_dv1_cli`` phase at tiny widths."""
    import chip_smoke

    res = chip_smoke.run_p2e_dv1_cli("cpu", overrides=P2E_TINY, learning_starts=32, train_iters=8, finetune_iters=4,
                                     profile=False)
    assert set(res) == set(chip_smoke.P2E_DV1_CLI_RUNS)
    row = res["pendulum"]
    assert row["gradient_steps"] > 0 and row["test_reward"] is not None and row["launches"] == {}
    assert row["draw_vs_plain"]["bytes_equal"] and "gather_windows" in row["draw_vs_plain"]["kernels"]
    assert "resumed" not in row and row["player_vs_plain"]["actor"] == "actor_exploration"
    assert row["step_vs_cpu"]["max_abs_param_err"] == 0.0 and row["step_vs_cpu"]["metrics"]["Rewards/intrinsic"] > 0
    fine = row["finetuning"]
    assert fine["actor_switched"] and fine["gradient_steps"] > 0 and set(row["seconds"]) >= {"run_s", "finetuning_s"}
