"""The port's recurrent PPO (``sheeprl_tpu_torch/algos/ppo_recurrent/``), its
fused collect, AdamW, its checkpoints and its CLI against the JAX
package's, on the CPU.

A small recurrent PPO (LSTM 8, dense 16, 2 envs, sequences of 4) built by
JAX's ``build_agent`` is carried into the port by ``utils/convert.py``.
With JAX's own draws fed to the port (its Gumbel or normal policy noise,
its reset draws, its epoch permutations), the comparisons and their
tolerances, f32 throughout:

- the agent's forward over a sequence with ``is_first`` resets in its
  middle, ``sample_actions``, ``get_values`` and ``evaluate_actions``
  1e-5 (identical discrete actions), with the pre/post-RNN dense layers
  off, both on, and only the post one; the parameter tree both ways
  bit for bit;
- two ``make_update_fn`` calls 1e-5 on parameters and metrics (the
  tolerance of ``test_torch_ppo.py::test_update_matches_jax``): discrete
  actions, continuous actions with ``anneal_lr`` and weight decay, and the
  carry never reset with a padded last minibatch;
- a fused rollout of 16 steps with a 12-step time limit against JAX's
  ``FusedRecurrentCollector._rollout_fn``: records, ``next_values`` and
  the carry 1e-5, dones identical;
- AdamW against ``optax.adamw`` behind the global-norm clip, the learning
  rate set between steps, 1e-6; its state converted both ways;
- a checkpoint written by the port is read by JAX's ``build_agent``; a
  resumed run ends on the bytes of one not interrupted.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.ppo.ppo import _set_lr as jax_set_lr
from sheeprl_tpu.algos.ppo.ppo import build_ppo_optimizer as jax_build_ppo_optimizer
from sheeprl_tpu.algos.ppo_recurrent import agent as jax_agent
from sheeprl_tpu.algos.ppo_recurrent.ppo_recurrent import make_update_fn as jax_make_update_fn
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.envs.jax import JaxVectorEnv, make_jax_env
from sheeprl_tpu.envs.jax import core as jax_core
from sheeprl_tpu.envs.jax.collect import FusedRecurrentCollector as JaxCollector
from sheeprl_tpu.parallel.mesh import MeshRuntime as JaxRuntime
from sheeprl_tpu_torch.algos.ppo.ppo import build_ppo_optimizer
from sheeprl_tpu_torch.algos.ppo_recurrent.agent import (
    RecurrentPPOPlayer,
    build_agent,
    evaluate_actions,
    get_values,
    sample_actions,
)
from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import make_update_fn, sequence_layout
from sheeprl_tpu_torch.algos.ppo_recurrent.utils import prepare_obs
from sheeprl_tpu_torch.config import compose as port_compose
from sheeprl_tpu_torch.envs.device import DeviceVectorEnv, make_device_env
from sheeprl_tpu_torch.envs.device.collect import FusedRecurrentCollector
from sheeprl_tpu_torch.optim import AdamW
from sheeprl_tpu_torch.parallel.mesh import MeshRuntime
from sheeprl_tpu_torch.utils.convert import (
    _adam_leaf,
    flax_to_torch,
    opt_state_from_tree,
    opt_state_to_tree,
    torch_to_flax,
)
from sheeprl_tpu_torch.utils.utils import polynomial_decay, trainable_params

from test_torch_envs import jax_reset_noise

TOL = 1e-5
OPT_TOL = 1e-6
H = 8
N = 2
BASE = ["algo.env_backend=jax", "fabric.accelerator=cpu", "metric.log_level=0", "algo.dense_units=16",
        "algo.encoder.mlp_features_dim=16", f"algo.rnn.lstm.hidden_size={H}", f"env.num_envs={N}",
        "algo.rollout_steps=16", "algo.per_rank_sequence_length=4", "algo.per_rank_num_batches=2",
        "algo.update_epochs=2"]
SPEC = {"jax_cartpole": ((2,), False, 4), "jax_pendulum": ((1,), True, 3)}
RNN_MLPS = {
    "none": [],
    "pre_and_post": ["algo.rnn.pre_rnn_mlp.apply=True", "algo.rnn.post_rnn_mlp.apply=True"],
    "post_only": ["algo.rnn.post_rnn_mlp.apply=True"],
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def jax_runtime():
    rt = JaxRuntime(devices=1, accelerator="cpu", precision="32-true")
    rt.launch()
    return rt


def rppo_pair(env_id="jax_cartpole", overrides=()):
    """The same small recurrent agent in both packages (the JAX parameters
    carried over), with both configs."""
    ovr = ["exp=ppo_recurrent", f"env={env_id}", *BASE, *overrides]
    cfg_j, cfg_p = jax_compose(overrides=ovr), port_compose(overrides=ovr)
    actions_dim, cont, _ = SPEC[env_id]
    rt = jax_runtime()
    module, params = jax_agent.build_agent(rt, actions_dim, cont, cfg_j, make_jax_env(env_id).observation_space)
    params = _np_tree(params)
    runtime = MeshRuntime(device="cpu", seed=0).launch()
    agent = build_agent(runtime, actions_dim, cont, cfg_p, make_device_env(env_id).observation_space, agent_state=params)
    return {"cfg_j": cfg_j, "cfg_p": cfg_p, "rt": rt, "module": module, "params": params, "runtime": runtime,
            "agent": agent, "actions_dim": actions_dim, "cont": cont, "env_id": env_id}


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def close_tree(got, want, tol=TOL):
    jax.tree_util.tree_map(lambda g, w: close(g, w, tol), got, want)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _a(x):
    return torch.from_numpy(np.array(x))


def jax_policy_noise(p, key, rows):
    """The draws of JAX's ``sample_actions`` from ``key`` for ``rows`` rows
    (T = 1), one array per head."""
    if p["cont"]:
        return [np.array(jax.random.normal(key, (1, rows, sum(p["actions_dim"])), jnp.float32))]
    keys = jax.random.split(key, len(p["actions_dim"]))
    return [np.array(jax.random.gumbel(k, (1, rows, d), jnp.float32)) for k, d in zip(keys, p["actions_dim"])]


@pytest.mark.parametrize("mlps", sorted(RNN_MLPS))
@pytest.mark.parametrize("env_id", sorted(SPEC))
def test_agent_forward_sampling_and_values_match_jax(env_id, mlps):
    """A 5-step sequence of 3 rows whose carry is reset at several steps
    (the first included); then one acting step, the values and the
    log-probs and entropies of the sampled actions over the sequence."""
    p = rppo_pair(env_id, RNN_MLPS[mlps])
    jax.tree_util.tree_map(np.testing.assert_array_equal, torch_to_flax(p["agent"]), p["params"])
    sd = flax_to_torch(torch_to_flax(p["agent"]), p["agent"])
    assert all(torch.equal(sd[k], v) for k, v in p["agent"].state_dict().items())
    rng = np.random.default_rng(0)
    t_len, rows, a_dim = 5, 3, sum(p["actions_dim"])
    obs = {"state": rng.normal(size=(t_len, rows, SPEC[env_id][2])).astype(np.float32)}
    prev = rng.normal(size=(t_len, rows, a_dim)).astype(np.float32)
    is_first = np.zeros((t_len, rows, 1), np.float32)
    is_first[0, 1] = is_first[2, 0] = is_first[3, 2] = is_first[4, 0] = 1.0
    hx, cx = (rng.normal(size=(rows, H)).astype(np.float32) for _ in range(2))
    outs_j, values_j, (hx_j, cx_j) = p["module"].apply(p["params"], obs, prev, is_first, hx, cx)
    outs_p, values_p, (hx_p, cx_p) = p["agent"](_t(obs), _a(prev), _a(is_first), _a(hx), _a(cx))
    for a, b in zip(outs_p, outs_j):
        close(a.detach(), b)
    close(values_p.detach(), values_j)
    close(hx_p.detach(), hx_j)
    close(cx_p.detach(), cx_j)

    key = jax.random.PRNGKey(5)
    obs1 = {"state": obs["state"][:1]}
    flat_j, real_j, logp_j, val_j, (h1_j, c1_j) = jax_agent.sample_actions(
        p["module"], p["params"], obs1, prev[:1], hx, cx, key)
    flat_p, real_p, logp_p, val_p, (h1_p, c1_p) = sample_actions(
        p["agent"], _t(obs1), _a(prev[:1]), _a(hx), _a(cx), [_a(n) for n in jax_policy_noise(p, key, rows)])
    if p["cont"]:
        close(flat_p.detach(), flat_j)
    else:
        np.testing.assert_array_equal(real_p.numpy(), np.asarray(real_j))
        np.testing.assert_array_equal(flat_p.numpy(), np.asarray(flat_j))
    for got, want in ((logp_p, logp_j), (val_p, val_j), (h1_p, h1_j), (c1_p, c1_j)):
        close(got.detach(), want)
    close(get_values(p["agent"], _t(obs1), _a(prev[:1]), _a(hx), _a(cx)).detach(),
          jax_agent.get_values(p["module"], p["params"], obs1, prev[:1], hx, cx))
    greedy_j = jax_agent.sample_actions(p["module"], p["params"], obs1, prev[:1], hx, cx, key, greedy=True)[0]
    close(sample_actions(p["agent"], _t(obs1), _a(prev[:1]), _a(hx), _a(cx), greedy=True)[0].detach(), greedy_j)

    actions = np.concatenate([np.asarray(flat_j)] * t_len, 0)
    lp_j, ent_j, v_j = jax_agent.evaluate_actions(p["module"], p["params"], obs, prev, is_first, hx, cx, actions)
    lp_p, ent_p, v_p = evaluate_actions(p["agent"], _t(obs), _a(prev), _a(is_first), _a(hx), _a(cx), _a(actions))
    for got, want in ((lp_p, lp_j), (ent_p, ent_j), (v_p, v_j)):
        close(got.detach(), want)


def test_player_carries_and_resets_its_state():
    """The player's greedy steps carry (hx, cx, prev_actions) as JAX's
    ``sample_actions`` chained by hand; ``reset_states`` zeroes the done row."""
    p = rppo_pair()
    player = RecurrentPPOPlayer(p["agent"], lambda o: prepare_obs(o, num_envs=3), num_envs=3)
    rng = np.random.default_rng(4)
    hx = cx = np.zeros((3, H), np.float32)
    prev = np.zeros((1, 3, 2), np.float32)
    for _ in range(3):
        obs = {"state": rng.normal(size=(3, 4)).astype(np.float32)}
        flat_j, _, _, val_j, (hx, cx) = jax_agent.sample_actions(
            p["module"], p["params"], {"state": obs["state"][None]}, prev, hx, cx, jax.random.PRNGKey(0), greedy=True)
        close(player.get_values(obs), jax_agent.get_values(p["module"], p["params"], {"state": obs["state"][None]},
                                                            prev, player.hx.numpy(), player.cx.numpy()))
        flat_p, _, _, val_p = player.get_actions(obs, greedy=True)
        prev = np.asarray(flat_j)
        close(flat_p, flat_j)
        close(val_p, val_j)
        close(player.hx, hx)
        close(player.cx, cx)
    player.reset_states(np.array([0, 1, 0]))
    assert float(player.hx[1].abs().sum()) == 0 and float(player.prev_actions[0, 1].abs().sum()) == 0
    assert float(player.hx[0].abs().sum()) > 0


def random_rollout(rng, p, t_len):
    a_dim = sum(p["actions_dim"])
    if p["cont"]:
        actions = rng.normal(size=(t_len, N, a_dim))
    else:
        actions = np.concatenate([np.eye(d)[rng.integers(0, d, size=(t_len, N))] for d in p["actions_dim"]], -1)
    data = {
        "state": rng.normal(size=(t_len, N, SPEC[p["env_id"]][2])),
        "actions": actions,
        "logprobs": rng.normal(size=(t_len, N, 1)) * 0.1 - 0.7,
        "values": rng.normal(size=(t_len, N, 1)),
        "rewards": rng.normal(size=(t_len, N, 1)),
        "dones": (rng.random((t_len, N, 1)) < 0.15).astype(np.float64),
        "prev_hx": rng.normal(size=(t_len, N, H)) * 0.3,
        "prev_cx": rng.normal(size=(t_len, N, H)) * 0.3,
        "prev_actions": np.concatenate([np.zeros((1, N, a_dim)), actions[:-1]], 0),
    }
    return {k: v.astype(np.float32) for k, v in data.items()}, rng.normal(size=(N, 1)).astype(np.float32)


def jax_epoch_perms(key, epochs, n_seqs, n_used):
    """JAX's per-epoch sequence permutations, padded with their heads."""
    perms = []
    for k in jax.random.split(key, epochs):
        perm = np.asarray(jax.random.permutation(k, n_seqs))
        perms.append(np.concatenate([perm, perm[: n_used - n_seqs]]))
    return torch.from_numpy(np.stack(perms).astype(np.int64))


UPDATE_CASES = {
    "discrete": ("jax_cartpole", ["algo.normalize_advantages=True", "algo.clip_vloss=True", "algo.ent_coef=0.01"]),
    "continuous_anneal_lr_weight_decay": ("jax_pendulum", [
        "algo.anneal_lr=True", "algo.optimizer.weight_decay=0.01", "algo.rnn.pre_rnn_mlp.apply=True",
        "algo.rnn.post_rnn_mlp.apply=True"]),
    "no_reset_padded": ("jax_cartpole", ["algo.reset_recurrent_state_on_done=False", "algo.rollout_steps=20",
                                         "algo.per_rank_num_batches=3", "algo.max_grad_norm=0.05"]),
}


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_update_matches_jax(case):
    """Two ``make_update_fn`` calls (two iterations) from the same
    parameters and rollouts, JAX's epoch permutations fed to the port."""
    env_id, ovr = UPDATE_CASES[case]
    p = rppo_pair(env_id, ovr)
    cfg_j, cfg_p = p["cfg_j"], p["cfg_p"]
    t_len = int(cfg_p.algo.rollout_steps)
    n_seqs, mb, n_mb, n_used = sequence_layout(t_len, N, int(cfg_p.algo.per_rank_sequence_length),
                                               int(cfg_p.algo.per_rank_num_batches))
    assert (n_used > n_seqs) == (case == "no_reset_padded")
    tx_j = jax_build_ppo_optimizer(cfg_j.algo.optimizer, cfg_j.algo.max_grad_norm, "32-true")
    update_j = jax_make_update_fn(p["rt"], p["module"], tx_j, cfg_j, ["state"])
    params_j = jax.device_put(p["params"])
    opt_j = tx_j.init(params_j)
    tx_p = build_ppo_optimizer(cfg_p.algo.optimizer, cfg_p.algo.max_grad_norm, "32-true")
    assert isinstance(tx_p, AdamW)
    opt_p = tx_p.init(trainable_params(p["agent"]))
    update_p = make_update_fn(p["runtime"], p["agent"], tx_p, cfg_p, ["state"])
    lr0 = float(cfg_p.algo.optimizer.learning_rate)
    rng = np.random.default_rng(2)
    epochs = int(cfg_p.algo.update_epochs)
    for i in range(2):
        lr = polynomial_decay(i, initial=lr0, final=0.0, max_decay_steps=2) if cfg_p.algo.anneal_lr else lr0
        data, next_values = random_rollout(rng, p, t_len)
        key = jax.random.PRNGKey(10 + i)
        params_j, opt_j, m_j = update_j(
            params_j, opt_j, jax.device_put(data), jax.device_put(next_values), key,
            jnp.float32(cfg_j.algo.clip_coef), jnp.float32(cfg_j.algo.ent_coef), jnp.float32(lr),
        )
        m_p = update_p(opt_p, _t(data), _a(next_values), clip_coef=float(cfg_p.algo.clip_coef),
                       ent_coef=float(cfg_p.algo.ent_coef), lr=lr, perms=jax_epoch_perms(key, epochs, n_seqs, n_used))
        close_tree(torch_to_flax(p["agent"]), _np_tree(params_j))
        assert set(m_p) == set(m_j)
        for k, v in m_j.items():
            close(m_p[k].detach(), v)
    assert opt_p.count == 2 * epochs * n_mb


def jax_rollout_noise(p, key, carry0, base, steps):
    """The draws of JAX's fused recurrent rollout from ``key``: each step's
    policy noise (as :func:`jax_policy_noise`) and each env's reset draws."""
    env_j = make_jax_env(p["env_id"])
    per_step = [jax_policy_noise(p, k, N) for k in jax.random.split(key, steps)]
    policy = [torch.from_numpy(np.stack([s[h][0] for s in per_step])) for h in range(len(per_step[0]))]
    idx = jnp.arange(N)
    resets = [jax_reset_noise(env_j, jax.vmap(lambda i: jax_core.step_keys(base, carry0["gstep"] + t, i)[1])(idx))
              for t in range(steps)]
    return {"policy": policy, "reset": {k: torch.stack([r[k] for r in resets]) for k in resets[0]}}


@pytest.mark.parametrize("env_id", sorted(SPEC))
def test_fused_recurrent_rollout_matches_jax(env_id):
    """16 steps with a 12-step time limit (truncation bootstraps at the
    state after the action) and the carry reset where done, JAX's draws fed
    to the port; Pendulum also clips its rewards.  JAX's package never ran
    this function in a test."""
    steps, limit = 16, 12
    p = rppo_pair(env_id, [f"algo.rollout_steps={steps}", f"env.clip_rewards={env_id == 'jax_pendulum'}"])
    envs_j = JaxVectorEnv(make_jax_env(env_id), N, seed=0, max_episode_steps=limit)
    col_j = JaxCollector(envs=envs_j, module=p["module"], params=p["params"], cfg=p["cfg_j"], runtime=p["rt"],
                         obs_keys=["state"], total_envs=N, world_size=1)
    carry0 = col_j._carry
    key = jax.random.PRNGKey(11)
    carry_j, data_j, events_j, next_values_j = col_j._rollout(jax.device_put(p["params"]), carry0, key, col_j._env_base)
    envs_p = DeviceVectorEnv(make_device_env(env_id), N, max_episode_steps=limit, device="cpu")
    col_p = FusedRecurrentCollector(envs=envs_p, agent=p["agent"], cfg=p["cfg_p"], runtime=p["runtime"],
                                    obs_keys=["state"], total_envs=N)
    vstate0 = {k: v for k, v in carry0["vstate"].items() if k != "gstep"}
    carry_p0 = {**col_p.carry, "vstate": jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x)), vstate0)}
    noise = jax_rollout_noise(p, key, carry0["vstate"], col_j._env_base, steps)
    carry_p, data_p, events_p, next_values_p = col_p.rollout(carry_p0, noise)
    np.testing.assert_array_equal(data_p["dones"].numpy(), np.asarray(data_j["dones"]))
    np.testing.assert_array_equal(events_p["done"].numpy(), np.asarray(events_j["done"]))
    assert bool(events_p["done"].any()) and bool(np.asarray(data_j["dones"])[1:].any())
    assert set(data_p) == set(data_j)
    for k in data_j:
        close(data_p[k], data_j[k])
    assert float(data_p["prev_hx"].abs().max()) > 0
    close(next_values_p, next_values_j)
    close(events_p["ep_return"], events_j["ep_return"])
    close(carry_p["vstate"]["obs"]["state"], carry_j["vstate"]["obs"]["state"])
    for k in ("hx", "cx"):
        close(carry_p[k], carry_j[k])
    close(carry_p["prev_actions"], np.asarray(carry_j["prev_actions"]).reshape(N, -1))


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_matches_optax_and_its_state_converts(weight_decay):
    """Five AdamW steps on the agent's parameters against optax's
    ``adamw`` behind ``clip_by_global_norm`` (as both packages build it from
    ``configs/optim/adamw.yaml``), gradients large enough for the clip in
    some steps, the learning rate changed between steps; then the state
    as a checkpoint holds it against optax's moments, and back."""
    p = rppo_pair()
    optim = {"_target_": "optax.adamw", "learning_rate": 2e-3, "eps": 1e-4, "b1": 0.9, "b2": 0.999,
             "weight_decay": weight_decay}
    tx_j = jax_build_ppo_optimizer(optim, 0.5, "32-true")
    tx_p = build_ppo_optimizer(optim, 0.5, "32-true")
    params = trainable_params(p["agent"])
    opt_p = tx_p.init(params)
    params_j = p["params"]
    opt_j = tx_j.init(params_j)
    rng = np.random.default_rng(7)
    for step, scale in enumerate((0.01, 2.0, 0.05, 3.0, 0.02)):
        grads = {k: torch.from_numpy((rng.normal(size=v.shape) * scale).astype(np.float32)) for k, v in params.items()}
        lr = 2e-3 * (1.0 - 0.15 * step)
        tx_p.learning_rate = lr
        tx_p.update(params, grads, opt_p)
        opt_j = jax_set_lr(opt_j, lr)
        import optax

        updates, opt_j = tx_j.update(torch_to_flax(p["agent"], grads), opt_j, params_j)
        params_j = optax.apply_updates(params_j, updates)
        close_tree(torch_to_flax(p["agent"]), _np_tree(params_j), OPT_TOL)
    adam_j = _adam_leaf(opt_j)
    tree = opt_state_to_tree(opt_p, p["agent"])
    assert tree["count"] == int(adam_j.count) == 5
    close_tree(tree["mu"], _np_tree(adam_j.mu), OPT_TOL)
    close_tree(tree["nu"], _np_tree(adam_j.nu), OPT_TOL)
    back = opt_state_from_tree({"count": int(adam_j.count), "mu": _np_tree(adam_j.mu), "nu": _np_tree(adam_j.nu)},
                               p["agent"], tx_p)
    for k in params:
        close(back.mu[k], opt_p.mu[k], OPT_TOL)
        close(back.nu[k], opt_p.nu[k], OPT_TOL)
    same = opt_state_from_tree(tree, p["agent"], tx_p)
    assert all(torch.equal(same.mu[k], opt_p.mu[k]) and torch.equal(same.nu[k], opt_p.nu[k]) for k in params)


def cli_overrides(tmp_path, run_name, total_iters, env="jax_cartpole", extra=()):
    return [f"exp=ppo_recurrent", f"env={env}", *BASE, f"algo.total_steps={N * 16 * total_iters}",
            f"root_dir={tmp_path}", f"run_name={run_name}", *extra]


@pytest.mark.parametrize("env_id", sorted(SPEC))
def test_checkpoint_is_read_by_jax(tmp_path, env_id):
    """The CLI on the CPU, two iterations: JAX's ``validate_checkpoint``
    accepts the final checkpoint, and JAX's ``build_agent`` takes its
    ``"agent"`` and computes the values and heads of the port's agent
    loaded from the same file."""
    from sheeprl_tpu.utils.ckpt_format import load_state as jax_load_state
    from sheeprl_tpu.utils.ckpt_format import validate_checkpoint as jax_validate
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.ckpt_format import load_checkpoint

    out = run(cli_overrides(tmp_path, "ck", 2, env_id))
    assert out["test_reward"] is not None and out["iterations"] == 2
    summary = jax_validate(out["checkpoint"])
    assert {"agent", "optimizer", "iter_num", "num_batches", "env", "recurrent", "rng"} <= set(summary["keys"])
    state_j = jax_load_state(out["checkpoint"])
    assert state_j["iter_num"] == 2 and state_j["num_batches"] == 2 and out["policy_step"] == 2 * 16 * N
    actions_dim, cont, obs_dim = SPEC[env_id]
    cfg_j = jax_compose(overrides=cli_overrides(tmp_path, "ck", 2, env_id))
    module, params = jax_agent.build_agent(jax_runtime(), actions_dim, cont, cfg_j,
                                           make_jax_env(env_id).observation_space, agent_state=state_j["agent"])
    cfg_p = port_compose(overrides=cli_overrides(tmp_path, "ck", 2, env_id))
    agent = build_agent(MeshRuntime(device="cpu").launch(), actions_dim, cont, cfg_p,
                        make_device_env(env_id).observation_space, agent_state=load_checkpoint(out["checkpoint"])["agent"])
    rng = np.random.default_rng(3)
    obs = {"state": rng.normal(size=(3, 2, obs_dim)).astype(np.float32)}
    prev = rng.normal(size=(3, 2, sum(actions_dim))).astype(np.float32)
    is_first = np.zeros((3, 2, 1), np.float32)
    hx = np.zeros((2, H), np.float32)
    outs_j, v_j, _ = module.apply(params, obs, prev, is_first, hx, hx)
    outs_p, v_p, _ = agent(_t(obs), _a(prev), _a(is_first), _a(hx), _a(hx))
    close(v_p.detach(), v_j)
    close(outs_p[0].detach(), outs_j[0])


def test_resume_continues_the_run(tmp_path):
    """A run of three iterations checkpoints after each; a resume from its
    second checkpoint ends on the bytes of its third: the agent, the AdamW
    state, the envs, the recurrent carry and the generator (``anneal_lr``
    on, so the resumed learning rate counts too)."""
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.ckpt_format import load_checkpoint

    per_iter = N * 16
    extra = ["algo.run_test=False", "algo.anneal_lr=True", f"checkpoint.every={per_iter}"]
    straight = run(cli_overrides(tmp_path, "straight", 3, extra=extra))
    second = os.path.join(straight["log_dir"], "checkpoint", f"ckpt_{2 * per_iter}_0.ckpt")
    resumed = run(cli_overrides(tmp_path, "resumed", 3, extra=extra + [f"checkpoint.resume_from={second}"]))
    assert resumed["iterations"] == 1 and resumed["policy_step"] == straight["policy_step"] == 3 * per_iter
    a, b = load_checkpoint(straight["checkpoint"]), load_checkpoint(resumed["checkpoint"])
    for key in ("agent", "optimizer", "env", "recurrent", "rng"):
        jax.tree_util.tree_map(np.testing.assert_array_equal, a[key], b[key])
    assert a["iter_num"] == b["iter_num"] == 3
    mid = load_checkpoint(second)
    assert float(np.abs(mid["recurrent"]["hx"]).max()) > 0
    assert not np.array_equal(mid["recurrent"]["hx"], a["recurrent"]["hx"])


def test_port_config_matches_jax_and_refusals_name_their_roadmap_items(tmp_path, capsys):
    """``exp=ppo_recurrent`` composes to JAX's values in both packages; the
    registry lists the algorithm; what JAX refuses the port refuses, and
    what the port does not run yet raises, naming its ROADMAP item."""
    from sheeprl_tpu_torch.available_agents import available_agents
    from sheeprl_tpu_torch.cli import run

    ovr = ["exp=ppo_recurrent", "env=jax_cartpole"]
    port, ref = port_compose(overrides=ovr), jax_compose(overrides=ovr)
    for node in ("algo", "env", "buffer"):
        want, got = ref[node].as_dict(), port[node].as_dict()
        if node == "env":  # the env adapter's target names each package's own module
            assert got["wrapper"].pop("_target_").startswith("sheeprl_tpu_torch.")
            want["wrapper"].pop("_target_")
        assert got == want, node
    assert port.algo.optimizer["_target_"] == "optax.adamw" and port.buffer.memmap is False
    assert (port.env.num_envs, port.algo.rollout_steps, port.algo.per_rank_sequence_length,
            port.algo.per_rank_num_batches, port.algo.update_epochs, port.algo.rnn.lstm.hidden_size) == (16, 512, 16, 8,
                                                                                                          8, 64)
    available_agents()
    assert "sheeprl_tpu_torch.algos.ppo_recurrent" in capsys.readouterr().out

    refused = {
        "algo.per_rank_sequence_length=5": (ValueError, "multiple of per_rank_sequence_length"),
        "buffer.size=8": (ValueError, "cannot be lower"),
        "env.wrapper._target_=minedojo.MineDojoWrapper": (ValueError, "MineDojo"),
    }
    scope = {
        "algo.env_backend=host": "A2",
        "fabric.devices=2": "A5",
        "algo.sentinel.enabled=True": "A2",
        "metric.tracing=full": "A7",
        "buffer.memmap=True": "A2",
        "fabric.precision=bf16-mixed": "A2",
    }
    for override, (err, match) in refused.items():
        with pytest.raises(err, match=match):
            run(cli_overrides(tmp_path, "refused", 1, extra=[override]))
    for override, item in scope.items():
        with pytest.raises((NotImplementedError, ValueError), match=item):
            run(cli_overrides(tmp_path, "scope", 1, extra=[override]))


def test_chip_smoke_rppo_phases_run_on_cpu():
    """chip_smoke.py's ``rppo_training`` and ``rppo_cli`` phases at a small
    size on the CPU: the first rollout and update against a CPU replica
    (exact here), both faulted updates caught by the step-locked gate, a
    timed iteration,
    and both envs through the CLI with a resume."""
    import chip_smoke

    small = ["env.num_envs=2", "algo.rollout_steps=16", "algo.per_rank_sequence_length=4",
             "algo.per_rank_num_batches=2", "algo.update_epochs=2", "algo.dense_units=16",
             "algo.encoder.mlp_features_dim=16", f"algo.rnn.lstm.hidden_size={H}"]
    res = chip_smoke.run_rppo_training("cpu", overrides=small, iters=2)
    assert len(res["rollout_ms"]) == len(res["losses"]) == 2 and len(res["update_ms"]) == 1
    assert res["update_ms_recorded"] > 0
    card_vs_cpu = res["card_vs_cpu"]
    assert card_vs_cpu["max_abs_loss_err"] == 0.0 and card_vs_cpu["free_running"]["max_abs_param_err_after_update"] == 0.0
    locked = card_vs_cpu["step_locked"]
    assert locked["steps"] == 2 * 2 and locked["max_abs_param_err_one_step"] == 0.0
    assert chip_smoke._step_gate(locked["faulted_carry"]) and chip_smoke._step_gate(locked["faulted_last_epoch"])
    assert locked["faulted_last_epoch"]["steps_grad_rel_err_above_1e-4"] == 2  # the last epoch's two steps
    cli = chip_smoke.run_rppo_cli("cpu", overrides=small + ["env.max_episode_steps=40"])
    assert set(cli) == {"jax_cartpole", "jax_pendulum"}
    for row in cli.values():
        assert row["test_reward"] is not None and row["iterations"] == 2 and row["resumed"]["iterations"] == 1
