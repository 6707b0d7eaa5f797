"""The port's Plan2Explore-DreamerV3 (``algos/p2e_dv3``) against the JAX
package's, on the CPU at tiny widths (H = dense = 16, or 128 decoupled;
T = 8, B = 4, horizon 3, ``ensembles.n`` 3).

- the agent's exploration critics (only those with weight > 0) and its
  raises, against JAX's ``build_agent``;
- two exploration train steps through JAX's ``make_train_fn`` and the
  port's, coupled and decoupled, discrete and continuous, from the same
  converted parameters and Adam states, with JAX's five noise streams fed
  to the port: every metric (the intrinsic reward among them), the task's
  and each exploration critic's Moments, the Adam moments and the
  parameters after each;
- the trees, Adam states and Moments both ways, the ensembles' members in
  JAX's order;
- the replay rows of the exploration ``main`` against JAX's, warm-up only,
  bit for bit (the GridWorld machinery of ``test_torch_dv3_loop.py``);
- a port exploration checkpoint that JAX's finetuning ``build_agent`` reads
  (its modules give the port's values), a finetuning CLI run from it that
  switches to the task actor and resumes, and a finetuning run from a
  checkpoint in the JAX package's layout (optax Adam states included);
- a CPU rehearsal of ``chip_smoke.py``'s ``p2e_dv3_cli`` phase.

Tolerances, f32 throughout, as the DreamerV3 step is held
(``test_torch_dreamer_v3_train.py``): metrics and Moments 1e-4 relative,
Adam moments 1e-4 of each tensor's largest magnitude, parameters 2e-5
absolute after the two steps; module outputs 1e-5.
"""

import copy
import os

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import _make_optimizer as jax_make_optimizer
from sheeprl_tpu.algos.dreamer_v3.utils import init_moments as jax_init_moments
from sheeprl_tpu.algos.p2e_dv3 import agent as jax_agent
from sheeprl_tpu.algos.p2e_dv3.p2e_dv3_exploration import make_train_fn as jax_make_train_fn
from sheeprl_tpu.cli import run as jax_run
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.envs.jax import JaxVectorEnv
from sheeprl_tpu.envs.jax.gridworld import GridWorldJax
from sheeprl_tpu.parallel.mesh import MeshRuntime as JaxRuntime
from sheeprl_tpu.utils.callback import load_checkpoint as jax_load_checkpoint
from sheeprl_tpu.utils.ckpt_format import save_state as jax_save_state
from sheeprl_tpu.utils.utils import save_configs as jax_save_configs
from sheeprl_tpu_torch.algos.p2e_dv3 import agent as port_agent
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import make_train_state
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

from test_torch_dreamer_v3_player import OBS_SPACE, TINY
from test_torch_dreamer_v3_train import tiny_batch
from test_torch_dv3_loop import EVERY, GRID, LIMIT, MLP_ONLY, N_ENVS, STEPS, _buffers, _draws, _FedVectorEnv
from test_torch_dv3_loop import TINY as LOOP_TINY

TOL = 1e-5
STEP_RTOL = 1e-4
PARAM_ATOL = 2e-5
ACTIONS = (3, 2)
T, B, H, N_ENS = 8, 4, 3, 3
S, D = 4, 4
R = 128
DECOUPLED = [
    "algo.world_model.decoupled_rssm=True", "algo.world_model.recurrent_model.fused_seq=True",
    f"algo.world_model.recurrent_model.recurrent_state_size={R}", f"algo.world_model.recurrent_model.dense_units={R}",
    "algo.cnn_keys.encoder=[]", "algo.cnn_keys.decoder=[]",
]
P2E_TINY = [*LOOP_TINY, f"algo.ensembles.n={N_ENS}"]


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


def _overrides(extra=()):
    return ["exp=p2e_dv3_exploration", *TINY[1:], f"algo.horizon={H}", f"algo.per_rank_sequence_length={T}",
            f"algo.per_rank_batch_size={B}", f"algo.ensembles.n={N_ENS}", *extra]


def _groups(agent):
    """The port's optimizer groups: (port name, JAX name, module, mapping)."""
    out = [("world_model", "world_model", agent.world_model, "world_model"),
           ("ensembles", "ensembles", agent.ensembles, "ensembles"),
           ("actor", "actor_task", agent.actor, "actor"), ("critic", "critic_task", agent.critic, "critic"),
           ("actor_exploration", "actor_exploration", agent.actor_exploration, "actor")]
    return out


def p2e_pair(extra=(), continuous=False, actions_dim=ACTIONS):
    """The tiny P2E-DV3 in both packages, on the same weights and Adam
    states.  The reward model's and every critic's output layers start at
    zero (as configured); here they get random weights, so that the
    objectives are real ones."""
    overrides = _overrides(extra)
    cfg_j = jax_compose(overrides=overrides)
    rt = JaxRuntime(devices=1, accelerator="cpu", precision="32-true")
    rt.launch()
    wm, actor, critic, ensemble, critics_cfg, params = jax_agent.build_agent(rt, actions_dim, continuous, cfg_j, OBS_SPACE)
    params = _np_tree(params)
    rng = np.random.default_rng(7)
    heads = [params["critic_task"], params["world_model"]["reward_model"],
             *[c["module"] for c in params["critics_exploration"].values()]]
    for tree in heads:
        kernel = tree["params"]["Dense_0"]["kernel"]
        tree["params"]["Dense_0"]["kernel"] = rng.normal(scale=0.5, size=kernel.shape).astype(np.float32)
    params["target_critic_task"] = copy.deepcopy(params["critic_task"])
    for c in params["critics_exploration"].values():
        c["target_module"] = copy.deepcopy(c["module"])
    algo = cfg_j.algo

    def tx(node):
        return jax_make_optimizer(node.optimizer, node.clip_gradients, "32-true")

    txs = (tx(algo.world_model), tx(algo.ensembles), tx(algo.actor), tx(algo.critic), tx(algo.actor),
           {n: tx(algo.critic) for n in critics_cfg})
    cpu = jax.devices("cpu")[0]
    jparams = jax.device_put(params, cpu)
    opt = jax.device_put({
        "world_model": txs[0].init(jparams["world_model"]), "ensembles": txs[1].init(jparams["ensembles"]),
        "actor_task": txs[2].init(jparams["actor_task"]), "critic_task": txs[3].init(jparams["critic_task"]),
        "actor_exploration": txs[4].init(jparams["actor_exploration"]),
        "critics_exploration": {n: txs[5][n].init(jparams["critics_exploration"][n]["module"]) for n in critics_cfg},
    }, cpu)
    train_j = jax_make_train_fn(rt, wm, actor, critic, ensemble, critics_cfg, txs, cfg_j, continuous, actions_dim)

    cfg_t = port_compose(overrides=overrides)
    runtime = MeshRuntime(device="cpu", seed=0).launch()
    agent = port_agent.build_agent(runtime, actions_dim, continuous, cfg_t, OBS_SPACE)
    load_flax_params(agent, params)
    state = make_train_state(runtime, agent, cfg_t, continuous, actions_dim)
    opt_np = _np_tree(opt)
    for g, jg, module, mapping in _groups(agent):
        state.opt_states[g] = opt_state_to_torch(opt_np[jg], module, mapping)
    for n, pair in agent.critics_exploration.items():
        state.opt_states["critics_exploration"][n] = opt_state_to_torch(opt_np["critics_exploration"][n], pair["module"], "critic")
    return {
        "jax": {"params": jparams, "opt": opt, "train": train_j, "device": cpu, "critics_cfg": critics_cfg,
                "moments_task": jax.device_put(jax_init_moments(), cpu),
                "moments_expl": jax.device_put({n: jax_init_moments() for n in critics_cfg}, cpu),
                "ensemble": ensemble, "actor": actor},
        "agent": agent, "state": state, "cfg": cfg_t, "actions_dim": actions_dim, "continuous": continuous,
    }


def _act_draw(key, actions_dim, continuous, rows):
    if continuous:
        return np.asarray(jax.random.normal(key, (rows, sum(actions_dim))))
    keys = jax.random.split(key, len(actions_dim))
    return np.concatenate([np.asarray(jax.random.gumbel(k, (rows, d))) for k, d in zip(keys, actions_dim)], -1)


def p2e_noise(key, actions_dim=ACTIONS, continuous=False):
    """JAX's draws in the exploration step from ``key``: ``split(key, 5)`` ->
    ``k_dyn`` (the dynamic scan's Gumbel noise), ``k_img_e`` and ``k_img_t``
    (each imagination's: ``split(k, H + 1)``, the first key the actor's at
    the start, then per step ``k_im, k_act = split(k)``, the transition's
    Gumbel noise and the actor's draw, split per discrete head); the two
    policy-objective keys draw nothing the port reads."""
    k_dyn, k_img_e, _, k_img_t, _ = jax.random.split(key, 5)
    rows = T * B

    def imagination(k):
        keys = jax.random.split(k, H + 1)
        acts, img = [_act_draw(keys[0], actions_dim, continuous, rows)], []
        for kk in keys[1:]:
            k_im, k_act = jax.random.split(kk)
            img.append(np.asarray(jax.random.gumbel(k_im, (rows, S, D))))
            acts.append(_act_draw(k_act, actions_dim, continuous, rows))
        return _t(np.stack(img)), _t(np.stack(acts))

    img_e, act_e = imagination(k_img_e)
    img_t, act_t = imagination(k_img_t)
    return {"dyn": _t(jax.random.gumbel(k_dyn, (T, B, S, D), jnp.float32)), "img_e": img_e, "act_e": act_e,
            "img_t": img_t, "act_t": act_t}


def _close_scaled(a, b, what):
    scale = float(b.abs().max()) + 1e-30
    assert float((a - b).abs().max()) <= STEP_RTOL * scale, what


def run_and_compare(pair, steps=2):
    j, state, agent = pair["jax"], pair["state"], pair["agent"]
    rng = np.random.default_rng(0)
    for step in range(steps):
        data = tiny_batch(rng, pair["actions_dim"], pair["continuous"])
        if "rgb" not in pair["cfg"].algo.cnn_keys.encoder:
            data.pop("rgb")
        key = jax.random.PRNGKey(100 + step)
        j["params"], j["opt"], j["moments_task"], j["moments_expl"], mj = j["train"](
            j["params"], j["opt"], j["moments_task"], j["moments_expl"], jax.device_put(data, j["device"]),
            jax.device_put(key, j["device"]),
        )
        noise = p2e_noise(key, pair["actions_dim"], pair["continuous"])
        state.opt_states, state.moments, mt = state.train_fn(
            state.opt_states, state.moments, {k: _t(v) for k, v in data.items()}, noise=noise
        )
        assert set(mt) == set(mj)
        assert "Rewards/intrinsic_intrinsic" in mt and "Loss/value_loss_exploration_extrinsic" in mt
        for k in mj:
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=STEP_RTOL, atol=1e-7, err_msg=f"step {step} {k}")
        moments = [(state.moments["task"], j["moments_task"])]
        moments += [(state.moments["exploration"][n], j["moments_expl"][n]) for n in j["critics_cfg"]]
        for mine, ref in moments:
            for k in ("low", "high"):
                np.testing.assert_allclose(float(mine[k]), float(ref[k]), rtol=STEP_RTOL, atol=1e-6)
        want = flax_to_torch(_np_tree(j["params"]), agent)
        got = agent.state_dict()
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=PARAM_ATOL, err_msg=f"step {step} {k}")
        opt_np = _np_tree(j["opt"])
        pairs = [(state.opt_states[g], opt_state_to_torch(opt_np[jg], m, mp), g) for g, jg, m, mp in _groups(agent)]
        pairs += [(state.opt_states["critics_exploration"][n],
                   opt_state_to_torch(opt_np["critics_exploration"][n], c["module"], "critic"), n)
                  for n, c in agent.critics_exploration.items()]
        for mine, ref, g in pairs:
            assert mine.count == ref.count == step + 1
            for k in ref.mu:
                _close_scaled(mine.mu[k], ref.mu[k], f"step {step} {g} mu {k}")
                _close_scaled(mine.nu[k], ref.nu[k], f"step {step} {g} nu {k}")


# ---------------------------------------------------------------- agent
def test_agent_selects_critics_and_raises_as_jax():
    cfg = port_compose(overrides=_overrides(["algo.critics_exploration.extrinsic.weight=0"]))
    rt = JaxRuntime(devices=1, accelerator="cpu", precision="32-true")
    rt.launch()
    *_, critics_j, params_j = jax_agent.build_agent(rt, ACTIONS, False, jax_compose(overrides=_overrides(
        ["algo.critics_exploration.extrinsic.weight=0"])), OBS_SPACE)
    agent = port_agent.build_agent(MeshRuntime(device="cpu", seed=0).launch(), ACTIONS, False, cfg, OBS_SPACE)
    assert agent.critics_cfg == critics_j == {"intrinsic": {"weight": 0.1, "reward_type": "intrinsic"}}
    assert set(agent.critics_exploration) == set(params_j["critics_exploration"]) == {"intrinsic"}
    for a, b in agent.target_pairs():
        assert torch.equal(a.head.weight, b.head.weight) and not a.head.weight.requires_grad
    assert len(agent.target_pairs()) == 2
    ens = agent.ensembles
    assert ens.head_weight.shape == (N_ENS, 16, S * D) and ens.weights[0].shape == (N_ENS, 16 + S * D + sum(ACTIONS), 16)
    assert not torch.equal(ens.weights[0][0], ens.weights[0][1])  # members drawn independently
    with pytest.raises(RuntimeError, match="intrinsic critic"):
        port_agent.build_agent(MeshRuntime(device="cpu").launch(), ACTIONS, False,
                               port_compose(overrides=_overrides(["algo.critics_exploration.intrinsic.weight=0"])),
                               OBS_SPACE)
    with pytest.raises(ValueError, match="unknown reward_type"):
        port_agent.build_agent(MeshRuntime(device="cpu").launch(), ACTIONS, False,
                               port_compose(overrides=_overrides(["algo.critics_exploration.extrinsic.reward_type=bad"])),
                               OBS_SPACE)


def test_ensembles_forward_matches_jax_members_in_order():
    pair = p2e_pair()
    j, agent = pair["jax"], pair["agent"]
    x = np.random.default_rng(1).normal(size=(2, 5, 16 + S * D + sum(ACTIONS))).astype(np.float32)
    want = np.asarray(jax.vmap(lambda p: j["ensemble"].apply(p, jnp.asarray(x)))(j["params"]["ensembles"]))
    with torch.no_grad():
        got = agent.ensembles(_t(x)).numpy()
    assert got.shape == want.shape == (N_ENS, 2, 5, S * D)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------- the exploration step
@pytest.mark.parametrize("continuous", [False, True])
def test_exploration_step_matches_jax(continuous):
    run_and_compare(p2e_pair(continuous=continuous, actions_dim=(2,) if continuous else ACTIONS))


def test_decoupled_exploration_step_matches_jax():
    pair = p2e_pair(extra=DECOUPLED)
    rssm = pair["agent"].world_model.rssm
    assert rssm.decoupled and rssm.seq_scan_eligible(R)
    run_and_compare(pair)


def test_trees_adam_states_and_moments_both_ways():
    pair = p2e_pair()
    run_and_compare(pair, steps=1)
    j, agent, state = pair["jax"], pair["agent"], pair["state"]
    params = _np_tree(j["params"])
    back = flatten_tree(torch_to_flax(agent))
    want = flatten_tree(params)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(back[k], want[k], rtol=0, atol=PARAM_ATOL, err_msg=k)
    saved = p2e_state(agent, state)
    assert set(saved["opt_states"]) == {"world_model", "ensembles", "actor_task", "critic_task", "actor_exploration",
                                        "critics_exploration"}
    assert flatten_tree(saved["opt_states"]["ensembles"]["mu"]).keys() == flatten_tree(params["ensembles"]).keys()
    fresh = p2e_pair()
    load_p2e_state(fresh["agent"], fresh["state"], saved)
    for k, v in agent.state_dict().items():
        assert torch.equal(fresh["agent"].state_dict()[k], v), k
    for g in ("world_model", "ensembles", "actor", "critic", "actor_exploration"):
        a, b = fresh["state"].opt_states[g], state.opt_states[g]
        assert a.count == b.count and all(torch.equal(a.mu[k], b.mu[k]) and torch.equal(a.nu[k], b.nu[k]) for k in a.mu)
    for n in agent.critics_cfg:
        assert all(torch.equal(fresh["state"].moments["exploration"][n][k], state.moments["exploration"][n][k])
                   for k in ("low", "high"))


# ---------------------------------------------------------------- the env loop
def test_replay_rows_match_jax_main(tmp_path, monkeypatch):
    """Warm-up only: the exploration ``main``'s sub-buffers in every
    checkpoint, bit for bit, GridWorld behind both loops."""
    common = ["env=jax_gridworld", "algo.env_backend=jax", "fabric.accelerator=cpu", "metric.log_level=0",
              "env.capture_video=False", "buffer.memmap=False", "algo.run_test=False", f"env.num_envs={N_ENVS}",
              f"env.max_episode_steps={LIMIT}", "env.wrapper.size=5", "env.wrapper.view=3",
              f"algo.total_steps={STEPS * N_ENVS}", f"algo.learning_starts={10 * STEPS * N_ENVS}",
              f"checkpoint.every={EVERY * N_ENVS}", "checkpoint.save_last=True", "buffer.size=60", "seed=3",
              *MLP_ONLY, *P2E_TINY]
    env_j = GridWorldJax(max_episode_steps=128, **GRID)
    jax_actions = _draws(1, 4)
    made = []

    def jax_vector_env(thunks, **kwargs):
        envs = JaxVectorEnv(env_j, len(thunks), seed=3, max_episode_steps=LIMIT)
        envs.action_space.sample = lambda: jax_actions.pop(0)
        made.append(envs)
        return envs

    monkeypatch.setattr(gym.vector, "SyncVectorEnv", jax_vector_env)
    jax_run(["exp=p2e_dv3_exploration", f"root_dir={tmp_path}/jax", "run_name=rows", *common])
    assert made

    def port_vector_env(cfg, runtime, **kwargs):
        return _FedVectorEnv(env_j, make_device_env("jax_gridworld", max_episode_steps=128, **GRID), N_ENVS,
                             max_episode_steps=LIMIT, device="cpu", actions=_draws(1, 4))

    monkeypatch.setattr(port_env, "make_train_envs", port_vector_env)
    out = run(["exp=p2e_dv3_exploration", f"root_dir={tmp_path}/port", "run_name=rows", *common])
    assert out["gradient_steps"] == 0

    ckpt_dirs = [tmp_path / pkg / "rows" / "version_0" / "checkpoint" for pkg in ("jax", "port")]
    names = sorted(os.listdir(ckpt_dirs[0]))
    assert names == sorted(os.listdir(ckpt_dirs[1])) and len(names) == STEPS // EVERY
    for name in names:
        want = _buffers(ckpt_dirs[0] / name, jax_load_checkpoint)
        got = _buffers(ckpt_dirs[1] / name, load_checkpoint)
        assert set(got) == set(want), name
        for k in want:
            w, g = np.asarray(want[k]), np.asarray(got[k])
            assert g.dtype == w.dtype and g.shape == w.shape, (name, k)
            np.testing.assert_array_equal(g, w, err_msg=f"{name}: {k}")


def p2e_args(tmp_path, name, exp="p2e_dv3_exploration", extra=()):
    return [f"exp={exp}", "env=jax_gridworld", "algo.env_backend=jax", "fabric.accelerator=cpu", "metric.log_level=0",
            f"root_dir={tmp_path}", f"run_name={name}", *MLP_ONLY, *P2E_TINY, *extra]


def test_exploration_checkpoint_read_by_jax_finetuning_then_finetuned(tmp_path, capsys):
    """A port exploration run (fused GRU step, device cache): its checkpoint
    holds JAX's keys, JAX's finetuning ``build_agent`` reads it, and its
    modules (ensembles, exploration actor, task critic) give the port's
    values; a resume runs one more iteration; the port's finetuning starts
    from it, switches to the task actor, writes JAX's finetuning keys, and
    resumes."""
    extra = ["algo.world_model.recurrent_model.fused=True", "buffer.device_cache=True", "algo.learning_starts=32",
             "algo.total_steps=48"]
    out = run(p2e_args(tmp_path, "expl", extra=extra))
    assert out["gradient_steps"] > 0 and out["test_reward"] is not None and not out["actor_switched"]
    assert "Test - Reward:" in capsys.readouterr().out
    state_j = jax_load_checkpoint(out["checkpoint"])
    assert {"world_model", "actor_task", "critic_task", "target_critic_task", "actor_exploration",
            "critics_exploration", "ensembles", "opt_states", "moments_task", "moments_exploration", "ratio",
            "rb"} <= set(state_j)

    cfg_j = jax_compose(overrides=p2e_args(tmp_path, "expl", extra=extra))
    rt = JaxRuntime(devices=1, accelerator="cpu", precision="32-true")
    rt.launch()
    dev_env = make_device_env("jax_gridworld", size=9, view=5)
    obs_dim = dev_env.observation_space["state"].shape[0]
    obs_space = gym.spaces.Dict({"state": gym.spaces.Box(-np.inf, np.inf, (obs_dim,), np.float32)})
    dims = (dev_env.action_space.n,)
    wm_j, actor_j, critic_j, ens_j, _, params_j = jax_agent.build_agent(
        rt, dims, False, cfg_j, obs_space, state_j["world_model"], state_j.get("ensembles"), state_j["actor_task"],
        state_j["critic_task"], state_j["target_critic_task"], state_j["actor_exploration"],
        state_j.get("critics_exploration"),
    )
    agent = port_agent.build_agent(MeshRuntime(device="cpu").launch(), dims, False,
                                   port_compose(overrides=p2e_args(tmp_path, "expl", extra=extra)),
                                   dev_env.observation_space)
    load_flax_params(agent, {k: load_checkpoint(out["checkpoint"])[k] for k in
                            ("world_model", "actor_task", "critic_task", "target_critic_task", "actor_exploration",
                             "critics_exploration", "ensembles")})
    rng = np.random.default_rng(0)
    latent = rng.normal(size=(5, 16 + S * D)).astype(np.float32)
    ens_in = rng.normal(size=(5, 16 + S * D + dims[0])).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(
            agent.ensembles(_t(ens_in)).numpy(),
            np.asarray(jax.vmap(lambda p: ens_j.apply(p, jnp.asarray(ens_in)))(params_j["ensembles"])), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(agent.critic(_t(latent)).numpy(),
                                   np.asarray(critic_j.apply(params_j["critic_task"], jnp.asarray(latent))), rtol=TOL,
                                   atol=TOL)
        heads, _ = agent.actor_exploration(_t(latent), True)
        heads_j, _ = actor_j.apply(params_j["actor_exploration"], jnp.asarray(latent), True, None)
        np.testing.assert_array_equal(heads[0].numpy().argmax(-1), np.asarray(heads_j[0]).argmax(-1))

    resumed = run(p2e_args(tmp_path, "expl_resumed", extra=["algo.total_steps=52",
                                                              f"checkpoint.resume_from={out['checkpoint']}"]))
    assert resumed["iterations"] == 1 and resumed["policy_step"] == 52 and os.path.exists(resumed["checkpoint"])

    # the ensembles' width is not a pinned model key: finetuning builds no ensembles, so this run's do not matter
    fine = run(p2e_args(tmp_path, "fine", "p2e_dv3_finetuning", [
        f"checkpoint.exploration_ckpt_path={out['checkpoint']}", "algo.learning_starts=40", "algo.total_steps=56",
        "buffer.device_cache=True", "algo.ensembles.n=5", "algo.ensembles.mlp_layers=2"]))
    assert fine["actor_switched"] and fine["gradient_steps"] > 0 and fine["test_reward"] is not None
    assert "Test - Reward:" in capsys.readouterr().out
    state_f = jax_load_checkpoint(fine["checkpoint"])
    assert {"world_model", "actor_task", "critic_task", "target_critic_task", "actor_exploration", "opt_states",
            "moments_task"} <= set(state_f) and "ensembles" not in state_f
    assert set(state_f["opt_states"]) == {"world_model", "actor_task", "critic_task"}
    jax_agent.build_agent(rt, dims, False, cfg_j, obs_space, state_f["world_model"], None, state_f["actor_task"],
                          state_f["critic_task"], state_f["target_critic_task"], state_f["actor_exploration"], None)
    again = run(p2e_args(tmp_path, "fine_resumed", "p2e_dv3_finetuning", [
        "algo.total_steps=60", f"checkpoint.resume_from={fine['checkpoint']}"]))
    assert again["iterations"] == 1 and again["policy_step"] == 60 and os.path.exists(again["checkpoint"])


def test_finetuning_starts_from_a_jax_exploration_checkpoint(tmp_path):
    """A checkpoint in the JAX package's layout (its ``_ckpt_state`` keys,
    optax Adam states, its ``config.yaml`` two levels up): the port's
    finetuning loads its modules, Adam and Moments states, and trains."""
    args = p2e_args(tmp_path, "jax_expl")
    cfg_j = jax_compose(overrides=args)
    rt = JaxRuntime(devices=1, accelerator="cpu", precision="32-true")
    rt.launch()
    dev_env = make_device_env("jax_gridworld", size=9, view=5)
    obs_dim = dev_env.observation_space["state"].shape[0]
    obs_space = gym.spaces.Dict({"state": gym.spaces.Box(-np.inf, np.inf, (obs_dim,), np.float32)})
    dims = (dev_env.action_space.n,)
    *_, critics_cfg, params = jax_agent.build_agent(rt, dims, False, cfg_j, obs_space)
    algo = cfg_j.algo
    wm_tx = jax_make_optimizer(algo.world_model.optimizer, algo.world_model.clip_gradients, "32-true")
    actor_tx = jax_make_optimizer(algo.actor.optimizer, algo.actor.clip_gradients, "32-true")
    critic_tx = jax_make_optimizer(algo.critic.optimizer, algo.critic.clip_gradients, "32-true")
    log_dir = tmp_path / "jax_expl" / "version_0"
    jax_save_configs(cfg_j, str(log_dir))
    moments = {"low": np.float32(0.25), "high": np.float32(1.5)}
    ckpt = log_dir / "checkpoint" / "ckpt_64_0.ckpt"
    jax_save_state(str(ckpt), _np_tree({
        **{k: params[k] for k in ("world_model", "actor_task", "critic_task", "target_critic_task",
                                  "actor_exploration", "critics_exploration", "ensembles")},
        "opt_states": {"world_model": wm_tx.init(params["world_model"]), "actor_task": actor_tx.init(params["actor_task"]),
                       "critic_task": critic_tx.init(params["critic_task"])},
        "moments_task": moments, "moments_exploration": {n: moments for n in critics_cfg},
        "iter_num": 64, "batch_size": B, "last_log": 0, "last_checkpoint": 64,
    }))
    fine = run(p2e_args(tmp_path, "fine", "p2e_dv3_finetuning", [
        f"checkpoint.exploration_ckpt_path={ckpt}", "algo.learning_starts=40", "algo.total_steps=44",
        "algo.run_test=False"]))
    assert fine["gradient_steps"] > 0 and fine["actor_switched"]
    saved = load_checkpoint(fine["checkpoint"])
    assert saved["opt_states"]["world_model"]["count"] == fine["gradient_steps"]
    wm0 = flatten_tree(_np_tree(params["world_model"]))
    wm1 = flatten_tree(saved["world_model"])
    assert wm0.keys() == wm1.keys() and any(not np.array_equal(wm0[k], wm1[k]) for k in wm0)
    np.testing.assert_array_equal(flatten_tree(saved["actor_exploration"])["params/Dense_0/kernel"],
                                  np.asarray(params["actor_exploration"]["params"]["Dense_0"]["kernel"]))


def test_finetuning_without_an_exploration_checkpoint_raises(tmp_path):
    assert port_compose(overrides=["exp=p2e_dv3_finetuning"]).checkpoint["exploration_ckpt_path"] == "???"
    with pytest.raises(ValueError, match="exploration_ckpt_path"):
        run(p2e_args(tmp_path, "fine", "p2e_dv3_finetuning", ["algo.total_steps=8"]))


# ---------------------------------------------------------------- chip_smoke rehearsal
def test_chip_smoke_p2e_dv3_cli_phase_runs_on_cpu():
    import chip_smoke

    res = chip_smoke.run_p2e_dv3_cli("cpu", overrides=P2E_TINY, learning_starts=32,
                                     train_iters={"gridworld": 3, "cartpole": 2}, finetune_starts=32, finetune_iters=2,
                                     profile=False)
    assert set(res) == set(chip_smoke.DV3_CLI_RUNS)
    for row in res.values():
        assert row["gradient_steps"] > 0 and row["test_reward"] is not None and row["launches"] == {}
        assert row["draw_vs_plain"]["bytes_equal"] and row["ensembles"] == N_ENS
    assert {"sum_tree_sample", "sum_tree_write"} <= set(res["cartpole"]["draw_vs_plain"]["kernels"])
    grid = res["gridworld"]
    assert grid["resumed"]["iterations"] == 1 and grid["player_vs_plain"]["max_abs_state_err"] == 0.0
    assert grid["player_vs_plain"]["actor"] == "actor_exploration"
    fine = grid["finetuning"]
    assert fine["actor_switched"] and fine["gradient_steps"] > 0 and fine["resumed"]["iterations"] == 1
