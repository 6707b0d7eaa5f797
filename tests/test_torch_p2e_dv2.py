"""The port's Plan2Explore-DreamerV2 (``algos/p2e_dv2``) against the JAX
package's, on the CPU at small widths (dense 16, one layer, H = 16,
stochastic 4 x 4, T = 8, B = 4, horizon 3, ``ensembles.n`` 3).

- the ensembles' forward, member by member in JAX's vmapped order, with and
  without LayerNorm;
- two exploration train steps against JAX's ``make_train_fn`` on converted
  state, JAX's three noise streams rebuilt from its key: discrete actions
  with ``use_continues``, LayerNorms and an image key, and continuous
  actions (the actor's objective through the dynamics): every metric (the
  intrinsic reward among them), the parameters and the Adam states;
- the trees and Adam states both ways, and both target critics' hard copies;
- the replay rows of the exploration ``main`` against JAX's, warm-up only,
  bit for bit (``test_torch_dv3_loop.py``'s GridWorld machinery);
- a checkpoint in the JAX package's layout finetuned by the port (the task
  modules and Adam states loaded as they were saved, the switch to the task
  actor); a port exploration run whose checkpoint JAX's ``build_agent``
  reads, finetuned and resumed;
- a CPU rehearsal of ``chip_smoke.py``'s ``p2e_dv2_cli`` phase and of its
  ``--flip-probe``; the step check's categorical lock and its gate.

Tolerances, f32 throughout, as DreamerV2's step is held
(``test_torch_dreamer_v2.py``): metrics 1e-4 relative, parameters 2e-5
absolute after two steps, Adam moments 1e-4 of each tensor's largest
magnitude; module outputs 1e-5.
"""

import copy
import os

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v2.dreamer_v2 import _make_optimizer as jax_make_optimizer
from sheeprl_tpu.algos.p2e_dv2 import agent as jax_agent
from sheeprl_tpu.algos.p2e_dv2.p2e_dv2_exploration import make_train_fn as jax_make_train_fn
from sheeprl_tpu.cli import run as jax_run
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.envs.jax import JaxVectorEnv
from sheeprl_tpu.envs.jax.gridworld import GridWorldJax
from sheeprl_tpu.parallel.mesh import MeshRuntime as JaxRuntime
from sheeprl_tpu.utils.callback import load_checkpoint as jax_load_checkpoint
from sheeprl_tpu.utils.ckpt_format import save_state as jax_save_state
from sheeprl_tpu.utils.utils import save_configs as jax_save_configs
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import train_steps
from sheeprl_tpu_torch.algos.p2e_dv2 import agent as port_agent
from sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_exploration import make_train_state
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

from test_torch_dreamer_v2 import MLP_ONLY, TINY, actor_noise, dv2_batch
from test_torch_dv3_loop import EVERY, GRID, LIMIT, N_ENVS, STEPS, _buffers, _draws, _FedVectorEnv

TOL = dict(rtol=1e-5, atol=1e-5)
STEP_RTOL = 1e-4
PARAM_ATOL = 2e-5
T, B, H = 8, 4, 3
S, D, REC, N_ENS = 4, 4, 16, 3
P2E_TINY = [*TINY[1:], f"algo.ensembles.n={N_ENS}"]
STATE = gym.spaces.Box(-np.inf, np.inf, (5,), np.float32)
RGB = gym.spaces.Box(0, 255, (64, 64, 3), np.uint8)
# name: (actions_dim, continuous, overrides, observation keys)
CASES = {
    "discrete_continues_rgb_ln": (
        (3, 2), False,
        ["algo.world_model.use_continues=True", "algo.layer_norm=True", "algo.mlp_keys.encoder=[state]",
         "algo.cnn_keys.encoder=[rgb]"],
        ("state", "rgb"),
    ),
    "continuous": ((1,), True, MLP_ONLY, ("state",)),
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
    """The tiny P2E-DV2 of ``CASES[name]`` in both packages on the same
    weights and Adam states, with each package's exploration step.  The
    reward model's and every critic's heads get larger random weights (so
    that the objectives are real ones), and the target critics differ from
    the critics."""
    actions_dim, continuous, extra, keys = CASES[name]
    overrides = ["exp=p2e_dv2_exploration", *P2E_TINY, f"algo.per_rank_batch_size={B}",
                 f"algo.per_rank_sequence_length={T}", f"algo.horizon={H}", *extra]
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
    for src, dst in (("critic_task", "target_critic_task"), ("critic_exploration", "target_critic_exploration")):
        params[dst] = copy.deepcopy(params[src])
        params[dst]["params"]["Dense_0"]["bias"] = np.full((1,), 0.3, np.float32)
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
    return {"jax": {"params": jparams, "opt": opt, "train": train_j, "device": cpu, "ensemble": ensemble},
            "agent": agent, "state": state, "cfg": cfg_t, "actions_dim": actions_dim, "continuous": continuous,
            "keys": keys}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    return p2e_pair(request.param)


def p2e_noise(key, actions_dim, continuous):
    """JAX's draws in the exploration step from ``key``: ``split(key, 3)`` ->
    the dynamic loop's Gumbel noise and the two imaginations' keys; each
    imagination's ``split(k)`` -> ``split(k_img, H)`` step keys (the policy
    key draws nothing the port reads), and each step's ``split(kk)`` -> the
    actor's draw and the transition's Gumbel noise."""
    k_dyn, k_img_e, k_img_t = jax.random.split(key, 3)

    def imagination(k):
        k_img, _ = jax.random.split(k)
        img, acts = [], []
        for kk in jax.random.split(k_img, H):
            k_act, k_im = jax.random.split(kk)
            acts.append(actor_noise(k_act, actions_dim, continuous))
            img.append(np.asarray(jax.random.gumbel(k_im, (T * B, S, D))))
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
        data = dv2_batch(rng, pair["actions_dim"], pair["continuous"], pair["keys"])
        key = jax.random.PRNGKey(100 + step)
        j["params"], j["opt"], mj = j["train"](j["params"], j["opt"], jax.device_put(data, j["device"]),
                                               jax.device_put(key, j["device"]))
        noise = p2e_noise(key, pair["actions_dim"], pair["continuous"])
        state.opt_states, state.moments, mt = state.train_fn(state.opt_states, state.moments,
                                                             {k: _t(v) for k, v in data.items()}, noise=noise)
        assert set(mt) == set(mj) and len(mt) == 22 and float(mj["Rewards/intrinsic"]) > 0
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


# ---------------------------------------------------------------- the agent
def test_ensembles_forward_matches_jax_members_in_order(pair):
    j, agent = pair["jax"], pair["agent"]
    width = S * D + REC + sum(pair["actions_dim"])
    x = np.random.default_rng(1).normal(size=(2, 5, width)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda p: j["ensemble"].apply(p, jnp.asarray(x)))(j["params"]["ensembles"]))
    with torch.no_grad():
        got = agent.ensembles(_t(x)).numpy()
    assert got.shape == want.shape == (N_ENS, 2, 5, S * D)
    assert agent.ensembles.layer_norm == ("rgb" in pair["keys"]) and agent.ensembles.bias
    np.testing.assert_allclose(got, want, **TOL)
    assert not np.allclose(got[0], got[1])  # the members differ


# ---------------------------------------------------------------- the exploration step
def test_exploration_steps_match_jax(pair):
    run_and_compare(pair)


def test_trees_adam_states_and_targets(pair):
    """The trees and Adam states both ways, JAX's layout; both target
    critics take a hard copy before gradient steps 0, freq, 2 freq."""
    agent, state = pair["agent"], pair["state"]
    params = _np_tree(pair["jax"]["params"])
    back = flatten_tree(torch_to_flax(agent))
    want = flatten_tree(params)
    assert back.keys() == want.keys()
    for k in want:  # the pair has taken the exploration steps of the test before
        np.testing.assert_allclose(back[k], want[k], rtol=0, atol=PARAM_ATOL, err_msg=k)
    saved = p2e_state(agent, state)
    assert set(saved["opt_states"]) == set(GROUPS.values())
    assert flatten_tree(saved["opt_states"]["ensembles"]["mu"]).keys() == flatten_tree(params["ensembles"]).keys()
    fresh = p2e_pair("continuous" if pair["continuous"] else "discrete_continues_rgb_ln")
    load_p2e_state(fresh["agent"], fresh["state"], saved)
    for k, v in agent.state_dict().items():
        assert torch.equal(fresh["agent"].state_dict()[k], v), k
    for g in GROUPS:
        a, b = fresh["state"].opt_states[g], state.opt_states[g]
        assert a.count == b.count and all(torch.equal(a.mu[k], b.mu[k]) and torch.equal(a.nu[k], b.nu[k]) for k in a.mu)

    pairs = agent.target_pairs()
    assert [t for t, _ in pairs] == [agent.target_critic, agent.target_critic_exploration]
    cfg = copy.deepcopy(pair["cfg"])
    cfg.algo.critic.per_rank_target_network_update_freq = 2
    rng = np.random.default_rng(4)
    batches = [{k: _t(v) for k, v in dv2_batch(rng, pair["actions_dim"], pair["continuous"], pair["keys"]).items()}
               for _ in range(3)]

    class _Feed:
        def sample(self, batch_size, sequence_length, n_samples):
            return {k: np.stack([b[k].numpy() for b in batches[: int(n_samples)]]) for k in batches[0]}

    seen, inner = [], state.train_fn

    def recording(*args, **kwargs):
        seen.append([[p.detach().clone() for p in m.parameters()] for m in (agent.critic, agent.target_critic,
                                                                             agent.critic_exploration,
                                                                             agent.target_critic_exploration)])
        return inner(*args, **kwargs)

    state.train_fn, state.gradient_steps = recording, 0
    try:
        train_steps(state, _Feed(), None, cfg, 3, torch.Generator().manual_seed(0))
    finally:
        state.train_fn = inner
    for step, (c, tc, ce, tce) in enumerate(seen):
        copied = all(torch.equal(a, b) for a, b in zip(c, tc)) and all(torch.equal(a, b) for a, b in zip(ce, tce))
        assert copied == (step % 2 == 0), step


# ---------------------------------------------------------------- the env loop
def p2e_args(tmp_path, name, exp="p2e_dv2_exploration", env="jax_gridworld", extra=()):
    return [f"exp={exp}", f"env={env}", "algo.env_backend=jax", "fabric.accelerator=cpu", "metric.log_level=0",
            f"root_dir={tmp_path}", f"run_name={name}", *MLP_ONLY, *P2E_TINY, *extra]


def test_replay_rows_match_jax_main(tmp_path, monkeypatch):
    """Warm-up only: the exploration ``main``'s rows in every checkpoint
    (DreamerV2's zero-action seed rows, rows after each step, reset rows
    with ``is_first``), bit for bit against JAX's."""
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
    jax_run(["exp=p2e_dv2_exploration", f"root_dir={tmp_path}/jax", "run_name=rows", *common])

    def port_vector_env(cfg, runtime, **kwargs):
        return _FedVectorEnv(env_j, make_device_env("jax_gridworld", max_episode_steps=128, **GRID), N_ENVS,
                             max_episode_steps=LIMIT, device="cpu", actions=_draws(1, 4))

    monkeypatch.setattr(port_env, "make_train_envs", port_vector_env)
    out = run(["exp=p2e_dv2_exploration", f"root_dir={tmp_path}/port", "run_name=rows", *common])
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


def _gridworld_space():
    dev_env = make_device_env("jax_gridworld", size=9, view=5)
    obs_dim = dev_env.observation_space["state"].shape[0]
    return gym.spaces.Dict({"state": gym.spaces.Box(-np.inf, np.inf, (obs_dim,), np.float32)}), \
        (dev_env.action_space.n,), dev_env.observation_space


def test_exploration_checkpoint_read_by_jax_then_finetuned(tmp_path, capsys):
    """A port exploration run (prioritized starts through the cache): its
    checkpoint holds JAX's keys and JAX's ``build_agent`` reads it, its
    modules giving the port's values; the port's finetuning starts from it,
    switches to the task actor, writes JAX's finetuning keys and resumes."""
    extra = ["buffer.prioritized=True", "buffer.per_kernel=pallas", "algo.learning_starts=32", "algo.total_steps=48",
             "algo.per_rank_pretrain_steps=1", "algo.replay_ratio=0.5"]
    out = run(p2e_args(tmp_path, "expl", extra=extra))
    assert out["gradient_steps"] > 0 and out["test_reward"] is not None and not out["actor_switched"]
    assert "Test - Reward:" in capsys.readouterr().out
    state_j = jax_load_checkpoint(out["checkpoint"])
    keys = {"world_model", "actor_task", "critic_task", "target_critic_task", "actor_exploration",
            "critic_exploration", "target_critic_exploration", "ensembles"}
    assert keys | {"opt_states", "ratio", "rb", "replay_priority"} <= set(state_j)
    obs_space, dims, dev_space = _gridworld_space()
    cfg_j = jax_compose(overrides=p2e_args(tmp_path, "expl", extra=extra))
    rt = JaxRuntime(devices=1, accelerator="cpu", precision="32-true")
    rt.launch()
    _, _, critic_j, ens_j, params_j = jax_agent.build_agent(rt, dims, False, cfg_j, obs_space, *(
        state_j[k] for k in ("world_model", "ensembles", "actor_task", "critic_task", "target_critic_task",
                             "actor_exploration", "critic_exploration", "target_critic_exploration")))
    agent = port_agent.build_agent(MeshRuntime(device="cpu").launch(), dims, False,
                                   port_compose(overrides=p2e_args(tmp_path, "expl", extra=extra)), dev_space)
    load_flax_params(agent, {k: load_checkpoint(out["checkpoint"])[k] for k in keys})
    rng = np.random.default_rng(0)
    latent = rng.normal(size=(5, S * D + REC)).astype(np.float32)
    ens_in = rng.normal(size=(5, S * D + REC + dims[0])).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(
            agent.ensembles(_t(ens_in)).numpy(),
            np.asarray(jax.vmap(lambda p: ens_j.apply(p, jnp.asarray(ens_in)))(params_j["ensembles"])), **TOL)
        np.testing.assert_allclose(agent.critic_exploration(_t(latent)).numpy(),
                                   np.asarray(critic_j.apply(params_j["critic_exploration"], jnp.asarray(latent))),
                                   **TOL)

    fine = run(p2e_args(tmp_path, "fine", "p2e_dv2_finetuning", extra=[
        f"checkpoint.exploration_ckpt_path={out['checkpoint']}", "algo.learning_starts=32", "algo.total_steps=48",
        "buffer.device_cache=True", "algo.ensembles.n=5"]))
    assert fine["actor_switched"] and fine["gradient_steps"] > 0 and fine["test_reward"] is not None
    state_f = jax_load_checkpoint(fine["checkpoint"])
    assert {"world_model", "actor_task", "critic_task", "target_critic_task", "actor_exploration",
            "opt_states"} <= set(state_f) and "ensembles" not in state_f and "moments_task" not in state_f
    assert set(state_f["opt_states"]) == {"world_model", "actor_task", "critic_task"}
    jax_agent.build_agent(rt, dims, False, cfg_j, obs_space, state_f["world_model"], None, state_f["actor_task"],
                          state_f["critic_task"], state_f["target_critic_task"], state_f["actor_exploration"])
    again = run(p2e_args(tmp_path, "fine_resumed", "p2e_dv2_finetuning", extra=[
        "algo.total_steps=52", f"checkpoint.resume_from={fine['checkpoint']}"]))
    assert again["iterations"] == 1 and again["policy_step"] == 52 and os.path.exists(again["checkpoint"])


def test_finetuning_starts_from_a_jax_exploration_checkpoint(tmp_path):
    """A checkpoint in the JAX package's layout (its ``_ckpt_state`` keys,
    optax Adam states, its ``config.yaml`` two levels up): the port's
    finetuning loads the task modules and the exploration actor as saved,
    pins DreamerV2's model keys (``layer_norm`` among them), switches to the
    task actor and trains."""
    args = p2e_args(tmp_path, "jax_expl", extra=["algo.layer_norm=True"])
    cfg_j = jax_compose(overrides=args)
    rt = JaxRuntime(devices=1, accelerator="cpu", precision="32-true")
    rt.launch()
    obs_space, dims, _ = _gridworld_space()
    *_, params = jax_agent.build_agent(rt, dims, False, cfg_j, obs_space)
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
    fine_args = p2e_args(tmp_path, "fine", "p2e_dv2_finetuning", extra=[
        f"checkpoint.exploration_ckpt_path={ckpt}", "algo.learning_starts=32", "algo.total_steps=36",
        "algo.run_test=False", "algo.layer_norm=False"])
    from sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_finetuning import P2E_DV2_FINETUNING_FAMILY as family

    cfg = port_compose(overrides=fine_args)
    state = family.load_state(cfg)
    assert cfg.algo.layer_norm is True  # pinned to the exploration run's
    _, _, dev_space = _gridworld_space()
    setup = family.setup(MeshRuntime(device="cpu").launch(), cfg, dims, False, dev_space, state)
    agent = setup.train_state.agent
    for k in ("world_model", "actor_task", "critic_task", "target_critic_task"):
        want = flatten_tree(_np_tree(params[k]))
        got = flatten_tree(torch_to_flax(agent)[{"actor_task": "actor", "critic_task": "critic",
                                                  "target_critic_task": "target_critic"}.get(k, k)])
        assert want.keys() == got.keys() and all(np.array_equal(want[x], got[x]) for x in want), k
    assert setup.player_actor is not agent.actor and setup.train_actor is agent.actor
    assert setup.train_state.opt_states["world_model"].count == 0

    fine = run(fine_args)
    assert fine["gradient_steps"] > 0 and fine["actor_switched"]
    saved = load_checkpoint(fine["checkpoint"])
    assert saved["opt_states"]["world_model"]["count"] == fine["gradient_steps"]
    np.testing.assert_array_equal(flatten_tree(saved["actor_exploration"])["params/Dense_0/kernel"],
                                  np.asarray(params["actor_exploration"]["params"]["Dense_0"]["kernel"]))


def test_finetuning_without_an_exploration_checkpoint_raises(tmp_path):
    assert port_compose(overrides=["exp=p2e_dv2_finetuning"]).checkpoint["exploration_ckpt_path"] == "???"
    with pytest.raises(ValueError, match="exploration_ckpt_path"):
        run(p2e_args(tmp_path, "fine", "p2e_dv2_finetuning", extra=["algo.total_steps=8"]))


# ---------------------------------------------------------------- chip_smoke rehearsal
def test_chip_smoke_p2e_dv2_cli_phase_runs_on_cpu():
    """``chip_smoke.py``'s ``p2e_dv2_cli`` phase at tiny widths: the
    exploration run with its rates, draw check, the exploration player
    against a second CPU copy and one step against a CPU replica (identical
    here), then finetuning from its checkpoint."""
    import chip_smoke

    res = chip_smoke.run_p2e_dv2_cli("cpu", overrides=P2E_TINY, learning_starts=32, train_iters=8, finetune_iters=4,
                                     profile=False)
    assert set(res) == set(chip_smoke.P2E_DV2_CLI_RUNS)
    row = res["cartpole"]
    assert row["gradient_steps"] > 0 and row["test_reward"] is not None and row["launches"] == {}
    assert row["ensembles"] == N_ENS and row["draw_vs_plain"]["bytes_equal"]
    assert {"gather_windows", "sum_tree_sample", "sum_tree_write"} <= set(row["draw_vs_plain"]["kernels"])
    assert "resumed" not in row and row["player_vs_plain"]["actor"] == "actor_exploration"
    assert row["player_vs_plain"]["max_abs_state_err"] == 0.0 and row["step_vs_cpu"]["max_abs_param_err"] == 0.0
    assert "Rewards/intrinsic" in row["step_vs_cpu"]["metrics"]
    # the categorical draws of the step (posteriors, imagined latents and actions) were step-locked
    assert row["step_vs_cpu"]["categorical_draws"] > 0 and row["step_vs_cpu"]["flips"] == 0
    fine = row["finetuning"]
    assert fine["actor_switched"] and fine["gradient_steps"] > 0 and set(row["seconds"]) >= {"run_s", "finetuning_s"}


def test_chip_smoke_discrete_lock_replays_the_recorded_draws():
    """``chip_smoke._DiscreteLock``: replaying, every ``torch.argmax`` returns
    the recorded result of the same call and counts the elements where its
    own differs; a step that draws more or fewer times than the recorded one
    raises; ``torch.argmax`` is restored."""
    import chip_smoke

    inner = torch.argmax
    with chip_smoke._DiscreteLock() as record:
        first = torch.argmax(torch.tensor([[1.0, 2.0], [3.0, 0.0]]), -1)
        torch.argmax(torch.tensor([0.0, 1.0, 0.5]), dim=-1)
    assert torch.argmax is inner and len(record.calls) == 2
    lock = chip_smoke._DiscreteLock(record.calls, "cpu")
    with lock:
        # the first row's top two swapped: one flip; the second draw agrees
        replayed = torch.argmax(torch.tensor([[2.0, 1.0], [3.0, 0.0]]), -1)
        torch.argmax(torch.tensor([0.0, 1.0, 0.5]), dim=-1)
    assert torch.equal(replayed, first) and lock.flips == 1
    # the swapped row's scores moved by 1 against a gap of 1: a near tie; the others did not move
    assert lock.near_ties == 1 and lock.max_score_diff == 1.0
    with pytest.raises(AssertionError, match="categorical draws"):
        with chip_smoke._DiscreteLock(record.calls, "cpu"):
            torch.argmax(torch.tensor([[2.0, 1.0], [3.0, 0.0]]), -1)
    with pytest.raises(AssertionError, match="no counterpart"):
        with chip_smoke._DiscreteLock(record.calls, "cpu"):
            torch.argmax(torch.tensor([1.0, 0.0]), -1)
    with pytest.raises(AssertionError, match="dimension 0"):
        with chip_smoke._DiscreteLock():
            torch.argmax(torch.tensor([[1.0, 0.0]]), 0)
    assert torch.argmax is inner


@pytest.mark.parametrize("want, have, rtol, passes", [
    (0.0025, 0.0025 * (1 + 5e-5), 1e-4, True),
    # a gradient norm of 0.0025 off by 1e-3 of itself: within an absolute 1e-4, not within 1e-4 of its size
    (0.0025, 0.0025 * (1 + 1e-3), 1e-4, False),
    (0.0, 0.0, 1e-4, True),
    (0.0, 5e-11, 1e-4, True),
    (0.0, 2e-10, 1e-4, False),
    (0.0025, 0.0025 * (1 + 1e-3), None, True),
])
def test_chip_smoke_card_vs_cpu_gate_scales_with_each_metric(want, have, rtol, passes):
    """``chip_smoke._card_vs_cpu``: with ``rtol`` each metric is held to
    ``rtol`` of its own size (of STEP_METRIC_FLOOR below it); without, to
    the DreamerV2/V1 phases' LOSS_RTOL plus LOSS_ATOL; parameters to
    PARAM_ATOL."""
    import chip_smoke

    params = {"w": torch.zeros(3)}
    cpu = {"metrics": {"Grads/actor_exploration": want}, "params": params}
    card = {"metrics": {"Grads/actor_exploration": have}, "params": params}
    if passes:
        res = chip_smoke._card_vs_cpu("step", cpu, card, rtol)
        assert res["max_abs_param_err"] == 0.0 and res["metric_rtol"] == rtol
    else:
        with pytest.raises(AssertionError, match="Grads/actor_exploration"):
            chip_smoke._card_vs_cpu("step", cpu, card, rtol)
    moved = {"metrics": {"Grads/actor_exploration": want}, "params": {"w": torch.full((3,), 2e-3)}}
    with pytest.raises(AssertionError, match="parameters differ"):
        chip_smoke._card_vs_cpu("step", cpu, moved, rtol)


def test_chip_smoke_flip_probe_runs_on_cpu():
    """``chip_smoke.py --flip-probe`` at tiny widths: a short exploration run,
    then a step against a CPU replica on two batches, locked and unlocked
    (identical here: no draw flips on one device)."""
    import chip_smoke

    out = chip_smoke.flip_probe(2, "cpu", overrides=[*P2E_TINY, "algo.learning_starts=32", "algo.total_steps=48"])
    assert [r["batch_seed"] for r in out] == [0, 1]
    for r in out:
        assert r["flips"] == r["near_ties"] == 0 and r["categorical_draws"] > 0 and r["max_abs_param_err"] == 0.0
        assert r["unlocked"]["max_metric_rel_err"] == 0.0 and r["unlocked"]["max_abs_param_err"] == 0.0
