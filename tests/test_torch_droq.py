"""The port's DroQ (``algos/droq``) against the JAX package's, on the CPU at
small widths.

- the explicit dropout of ``models.MLP``: at rate 0 it computes what it
  computed before (linear -> LayerNorm -> activation, bit for bit), and
  with masks given it is flax's ``Dropout`` (keep with probability
  1 - rate, divide by it): JAX's own MLP on the same weights and its own
  masks;
- the critic ensemble's forward against ``droq_ensemble_apply``,
  deterministic and under dropout with JAX's masks fed in.  JAX's masks are
  read back from the dropout layers' outputs (``capture_intermediates``) of
  each critic's flax apply under the key JAX's train function gives it;
- ``make_train_fn`` for two calls, prioritized and not, against JAX's with
  JAX's normals and masks fed in: losses, |delta|, parameters, Adam states;
- the trees and Adam states both ways;
- the replay rows of the port's ``main`` against JAX's, warm-up only, bit
  for bit (the counter env of ``test_torch_sac_loop.py``);
- a CLI run whose checkpoint JAX's ``build_agent`` reads (its critics and
  actor give the port's values), and a resume for one iteration;
- a CPU rehearsal of ``chip_smoke.py``'s ``droq_cli`` phase.

Tolerances, f32 throughout: module outputs 1e-5; losses and |delta| 1e-3
relative, as SAC's step is held (the log-prob's ``log(scale (1 - tanh^2) +
1e-6)`` turns the two libraries' last-ulp ``tanh`` differences into up to
1e-3 of a log-prob, and the critic's target carries it); Adam moments 3e-3
of each tensor's largest magnitude; parameters 2e-5 absolute after the two
calls (Adam moves a weight by up to lr = 3e-4 a step: a fifteenth of one
step).
"""

import os
from types import SimpleNamespace

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.droq import agent as jax_agent
from sheeprl_tpu.algos.droq import droq as jax_droq
from sheeprl_tpu.algos.sac.agent import actor_greedy_action as jax_greedy
from sheeprl_tpu.algos.sac.sac import _make_optimizer as jax_make_optimizer
from sheeprl_tpu.cli import run as jax_run
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.envs.jax import JaxVectorEnv
from sheeprl_tpu.models.models import MLP as JaxMLP
from sheeprl_tpu.parallel.mesh import MeshRuntime as JaxRuntime
from sheeprl_tpu.utils.callback import load_checkpoint as jax_load_checkpoint
from sheeprl_tpu_torch.algos.droq.agent import DroQCritic, build_agent
from sheeprl_tpu_torch.algos.droq.droq import make_train_state
from sheeprl_tpu_torch.algos.sac.agent import actor_greedy_action
from sheeprl_tpu_torch.cli import run
from sheeprl_tpu_torch.config import compose as port_compose
from sheeprl_tpu_torch.models.models import MLP, dropout_mask
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

TOL = 1e-5
RTOL = 1e-3
MOMENT_RTOL = 3e-3
PARAM_ATOL = 2e-5
OBS, ACT, HIDDEN, N_CRITICS = 5, 2, 16, 2
G, B = 3, 8
DROPOUT = 0.25  # large enough that every mask drops units
OVERRIDES = ["exp=droq", f"algo.hidden_size={HIDDEN}", f"algo.per_rank_batch_size={B}", "buffer.memmap=False",
             f"algo.critic.dropout={DROPOUT}"]
OBS_SPACE = {"state": SimpleNamespace(shape=(OBS,))}
ACTION_SPACE = SimpleNamespace(shape=(ACT,), low=-np.ones(ACT, np.float32), high=np.ones(ACT, np.float32))
GROUPS = ("actor", "critic", "alpha")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- JAX's dropout masks
def _flax_masks(module, params, args, key, n_layers):
    """The keep masks of ``module.apply(params, *args, deterministic=False,
    rngs={"dropout": key})``: where each dropout layer's output is nonzero
    (a dense output of exactly 0 has no say in the result either way)."""
    _, state = module.apply(params, *args, deterministic=False, rngs={"dropout": key},
                            capture_intermediates=True, mutable=["intermediates"])
    inter = state["intermediates"]
    while "Dropout_0" not in inter:
        inter = inter[next(k for k in inter if k.startswith("MLP_"))]
    return [np.asarray(inter[f"Dropout_{i}"]["__call__"][0]) != 0 for i in range(n_layers)]


def ensemble_masks(critic, stacked, obs, act, key):
    """(L, N, B, hidden) masks of ``droq_ensemble_apply(..., key)``: one
    split key a critic."""
    keys = jax.random.split(key, jax.tree_util.tree_leaves(stacked)[0].shape[0])
    per = []
    for i, k in enumerate(keys):
        p = jax.tree_util.tree_map(lambda x, i=i: x[i], stacked)
        per.append(_flax_masks(critic, p, (obs, act), k, 2))
    return np.stack([np.stack([m[layer] for m in per]) for layer in range(2)])


def jax_train_noise(key, critic, stacked, obs, act, g=G, b=B):
    """JAX's draws in ``make_train_fn`` from ``key``: ``split(key, g + 3)``;
    step i: ``k_next, k_drop = split(keys[i])``, the next actions' normals
    from ``k_next`` and the online critic's masks from ``k_drop``; the actor's
    normals from ``keys[g]`` and its Q's masks from ``keys[g + 1]``."""
    keys = jax.random.split(key, g + 3)
    nxt, cmasks = [], []
    for i in range(g):
        k_next, k_drop = jax.random.split(keys[i])
        nxt.append(np.asarray(jax.random.normal(k_next, (b, ACT), jnp.float32)))
        cmasks.append(ensemble_masks(critic, stacked, obs, act, k_drop))
    return {
        "next": _t(np.stack(nxt)),
        "critic_masks": _t(np.stack(cmasks)),
        "actor": _t(np.asarray(jax.random.normal(keys[g], (b, ACT), jnp.float32))),
        "actor_masks": _t(ensemble_masks(critic, stacked, obs, act, keys[g + 1])),
    }


# ---------------------------------------------------------------- the explicit-dropout repair
def test_mlp_dropout_zero_is_the_plain_stack_and_masks_give_flax_scaling():
    torch.manual_seed(0)
    x = torch.randn(6, 7)
    plain = MLP(7, (9, 9), output_dim=3, activation="relu", layer_norm=True)
    expect = x
    for lin, norm in zip(plain.layers, plain.norms):
        expect = torch.relu(norm(lin(expect)))
    expect = plain.head(expect)
    assert torch.equal(plain(x), expect)
    assert torch.equal(plain(x, generator=torch.Generator().manual_seed(1)), expect)  # rate 0 draws nothing

    rate = 0.3
    mlp_j = JaxMLP(hidden_sizes=(9, 9), output_dim=3, activation="relu", layer_norm=True, dropout=rate)
    params = mlp_j.init(jax.random.PRNGKey(0), jnp.zeros((1, 7)))
    key = jax.random.PRNGKey(4)
    xj = np.random.default_rng(0).normal(size=(6, 7)).astype(np.float32)
    want = np.asarray(mlp_j.apply(params, jnp.asarray(xj), deterministic=False, rngs={"dropout": key}))
    masks = _flax_masks(mlp_j, params, (jnp.asarray(xj),), key, 2)
    assert all(0 < m.mean() < 1 for m in masks)
    port = MLP(7, (9, 9), output_dim=3, activation="relu", layer_norm=True, dropout=rate)
    tree = _np_tree(params)["params"]
    with torch.no_grad():
        for i in range(2):
            port.layers[i].weight.copy_(_t(tree[f"Dense_{i}"]["kernel"].T))
            port.layers[i].bias.copy_(_t(tree[f"Dense_{i}"]["bias"]))
            port.norms[i].weight.copy_(_t(tree[f"LayerNorm_{i}"]["scale"]))
            port.norms[i].bias.copy_(_t(tree[f"LayerNorm_{i}"]["bias"]))
        port.head.weight.copy_(_t(tree["Dense_2"]["kernel"].T))
        port.head.bias.copy_(_t(tree["Dense_2"]["bias"]))
        got = port(_t(xj), masks=[_t(m) for m in masks]).numpy()
        det = port(_t(xj)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(det, np.asarray(mlp_j.apply(params, jnp.asarray(xj))), rtol=TOL, atol=TOL)
    # a generator draws keep masks at the rate
    kept = dropout_mask((3, 4000), rate, torch.Generator().manual_seed(0)).float().mean()
    assert abs(float(kept) - (1 - rate)) < 0.02
    with torch.no_grad():
        drawn = port(_t(xj), generator=torch.Generator().manual_seed(0)).numpy()
    assert np.isfinite(drawn).all() and not np.allclose(drawn, det)


# ---------------------------------------------------------------- agent and train function
def droq_pair(prioritized, dropout=DROPOUT):
    overrides = OVERRIDES + [f"buffer.prioritized={prioritized}", f"algo.critic.dropout={dropout}"]
    cfg_j = jax_compose(overrides=overrides)
    rt = JaxRuntime(devices=1, accelerator="cpu", precision="32-true")
    rt.launch()
    actor, critic, params, target_entropy = jax_agent.build_agent(rt, cfg_j, OBS_SPACE, ACTION_SPACE)
    params = _np_tree(params)
    # a target that differs from the critic, and LayerNorms away from 1/0, so that both show
    params["target_critic"] = jax.tree_util.tree_map(lambda x: x * np.float32(0.5), params["critic"])
    rng = np.random.default_rng(3)
    for tree in (params["critic"], params["target_critic"]):
        for i in range(2):
            ln = tree["params"]["MLP_0"][f"LayerNorm_{i}"]
            ln["scale"] = (1 + 0.2 * rng.normal(size=ln["scale"].shape)).astype(np.float32)
            ln["bias"] = (0.1 * rng.normal(size=ln["bias"].shape)).astype(np.float32)
    txs = [jax_make_optimizer(cfg_j.algo[g].optimizer, "32-true") for g in GROUPS]
    cpu = jax.devices("cpu")[0]
    jparams = jax.device_put(params, cpu)
    opt = jax.device_put(
        {"actor": txs[0].init(jparams["actor"]), "critic": txs[1].init(jparams["critic"]),
         "alpha": txs[2].init(jparams["log_alpha"])}, cpu,
    )
    train_j = jax_droq.make_train_fn(rt, actor, critic, txs, cfg_j, target_entropy, prioritized=prioritized)

    cfg_t = port_compose(overrides=overrides)
    runtime = MeshRuntime(device="cpu", seed=0).launch()
    agent, target_entropy_t = build_agent(runtime, cfg_t, OBS_SPACE, ACTION_SPACE)
    assert target_entropy_t == target_entropy
    load_flax_params(agent, params)
    state = make_train_state(runtime, agent, cfg_t, target_entropy_t, prioritized)
    for g, module in (("actor", agent.actor), ("critic", agent.critic), ("alpha", agent)):
        state.opt_states[g] = opt_state_to_torch(_np_tree(opt[g]), module, g)
    return {"jax": {"params": jparams, "opt": opt, "train": train_j, "device": cpu, "critic": critic, "actor": actor},
            "agent": agent, "state": state, "cfg": cfg_t}


def _batch(rng, lead, prioritized):
    obs = rng.normal(size=(*lead, OBS)).astype(np.float32)
    data = {
        "observations": obs,
        "next_observations": (obs + 0.1 * rng.normal(size=obs.shape)).astype(np.float32),
        "actions": rng.uniform(-1, 1, size=(*lead, ACT)).astype(np.float32),
        "rewards": rng.normal(size=(*lead, 1)).astype(np.float32),
        "terminated": (rng.uniform(size=(*lead, 1)) < 0.2).astype(np.float32),
        "truncated": np.zeros((*lead, 1), np.float32),
    }
    if prioritized:
        data["is_weights"] = rng.uniform(0.2, 1.0, size=(*lead, 1)).astype(np.float32)
    return data


def _close(a, b, what, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max() if b.size else 0.0
    assert a.shape == b.shape, what
    assert np.abs(a - b).max() <= rtol * max(scale, 1e-12), f"{what}: {np.abs(a - b).max()} vs scale {scale}"


def compare_states(pair):
    j, agent, state = pair["jax"], pair["agent"], pair["state"]
    want = flax_to_torch(_np_tree(j["params"]), agent)
    got = agent.state_dict()
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=PARAM_ATOL, err_msg=k)
    for g, module in (("actor", agent.actor), ("critic", agent.critic), ("alpha", agent)):
        ref = opt_state_to_torch(_np_tree(j["opt"][g]), module, g)
        mine = state.opt_states[g]
        assert mine.count == ref.count
        for k in ref.mu:
            _close(mine.mu[k].numpy(), ref.mu[k].numpy(), f"{g} mu {k}", MOMENT_RTOL)
            _close(mine.nu[k].numpy(), ref.nu[k].numpy(), f"{g} nu {k}", MOMENT_RTOL)


def test_critic_forward_matches_droq_ensemble_apply():
    pair = droq_pair(False)
    j, agent = pair["jax"], pair["agent"]
    stacked = j["params"]["critic"]
    rng = np.random.default_rng(0)
    obs, act = rng.normal(size=(B, OBS)).astype(np.float32), rng.uniform(-1, 1, (B, ACT)).astype(np.float32)
    want = np.asarray(jax_agent.droq_ensemble_apply(j["critic"], stacked, jnp.asarray(obs), jnp.asarray(act)))
    with torch.no_grad():
        got = agent.critic(_t(obs), _t(act)).numpy()
    assert got.shape == (B, N_CRITICS)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)

    key = jax.random.PRNGKey(9)
    want = np.asarray(jax_agent.droq_ensemble_apply(j["critic"], stacked, jnp.asarray(obs), jnp.asarray(act), key))
    masks = ensemble_masks(j["critic"], stacked, jnp.asarray(obs), jnp.asarray(act), key)
    assert masks.shape == (2, N_CRITICS, B, HIDDEN) and 0.5 < masks.mean() < 0.95
    assert not np.array_equal(masks[:, 0], masks[:, 1])  # one key a critic
    with torch.no_grad():
        got = agent.critic(_t(obs), _t(act), masks=_t(masks)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("prioritized", [False, True])
def test_train_fn_matches_jax(prioritized):
    """Two calls of G = 3 critic steps and one actor step, JAX's normals and
    dropout masks fed to the port."""
    pair = droq_pair(prioritized)
    j, state = pair["jax"], pair["state"]
    compare_states(pair)
    rng = np.random.default_rng(1)
    for call in range(2):
        critic_data, actor_data = _batch(rng, (G, B), prioritized), _batch(rng, (B,), False)
        key = jax.random.PRNGKey(20 + call)
        noise = jax_train_noise(key, j["critic"], j["params"]["critic"], jnp.asarray(actor_data["observations"]),
                                jnp.asarray(actor_data["actions"]))
        out_j = j["train"](j["params"], j["opt"], jax.device_put(critic_data, j["device"]),
                           jax.device_put(actor_data, j["device"]), jax.device_put(key, j["device"]))
        j["params"], j["opt"], mj = out_j[:3]
        out_t = state.train_fn(state.opt_states, {k: _t(v) for k, v in critic_data.items()},
                               {k: _t(v) for k, v in actor_data.items()}, noise=noise)
        state.opt_states, mt = out_t[:2]
        assert set(mt) == set(mj) == {"Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss", "Grads/agent"}
        for k in mj:
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=RTOL, atol=1e-7, err_msg=f"call {call} {k}")
        if prioritized:
            assert out_t[2].shape == (G, B)
            np.testing.assert_allclose(out_t[2].numpy(), np.asarray(out_j[3]), rtol=RTOL, atol=1e-7)
        compare_states(pair)


def test_train_fn_at_dropout_zero_draws_no_masks():
    pair = droq_pair(False, dropout=0.0)
    j, state = pair["jax"], pair["state"]
    rng = np.random.default_rng(2)
    critic_data, actor_data = _batch(rng, (G, B), False), _batch(rng, (B,), False)
    key = jax.random.PRNGKey(5)
    keys = jax.random.split(key, G + 3)
    noise = {
        "next": _t(np.stack([np.asarray(jax.random.normal(jax.random.split(keys[i])[0], (B, ACT))) for i in range(G)])),
        "critic_masks": None,
        "actor": _t(np.asarray(jax.random.normal(keys[G], (B, ACT)))),
        "actor_masks": None,
    }
    j["params"], j["opt"], mj = j["train"](j["params"], j["opt"], jax.device_put(critic_data, j["device"]),
                                           jax.device_put(actor_data, j["device"]), jax.device_put(key, j["device"]))
    state.opt_states, mt = state.train_fn(state.opt_states, {k: _t(v) for k, v in critic_data.items()},
                                          {k: _t(v) for k, v in actor_data.items()}, noise=noise)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=RTOL, atol=1e-7, err_msg=k)
    compare_states(pair)


def test_trees_and_adam_states_both_ways():
    pair = droq_pair(True)
    j, agent, state = pair["jax"], pair["agent"], pair["state"]
    params = _np_tree(j["params"])
    back = torch_to_flax(agent)
    flat_want, flat_got = jax.tree_util.tree_leaves_with_path(params), dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_want) == len(flat_got)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]), leaf, err_msg=str(path))
    assert back["critic"]["params"]["MLP_0"]["LayerNorm_1"]["scale"].shape == (N_CRITICS, HIDDEN)
    modules = {"actor": agent.actor, "critic": agent.critic, "alpha": agent}
    for g, module in modules.items():
        tree = adam_state_to_tree(state.opt_states[g], module, g)
        again = adam_state_from_tree(tree, module, g)
        assert again.count == state.opt_states[g].count
        for k in state.opt_states[g].mu:
            assert torch.equal(again.mu[k], state.opt_states[g].mu[k]) and torch.equal(again.nu[k], state.opt_states[g].nu[k])
        if g == "critic":  # the moments in the layout of JAX's critic tree
            assert flatten_tree(tree["mu"]).keys() == flatten_tree(params["critic"]).keys()


def test_build_agent_initialises_like_flax():
    cfg = port_compose(overrides=OVERRIDES + ["algo.hidden_size=64"])
    agent, _ = build_agent(MeshRuntime(device="cpu", seed=5).launch(), cfg, OBS_SPACE, ACTION_SPACE)
    critic = agent.critic
    assert isinstance(critic, DroQCritic) and critic.rate == DROPOUT
    assert [tuple(w.shape) for w in critic.weights] == [(2, OBS + ACT, 64), (2, 64, 64), (2, 64, 1)]
    assert all(float(w.detach().abs().max()) == 1.0 and float(w.detach().min()) == 1.0 for w in critic.norm_weights)
    assert all(float(b.abs().max()) == 0.0 for b in list(critic.biases) + list(critic.norm_biases))
    assert not torch.equal(critic.weights[1][0], critic.weights[1][1])
    for a, b in zip(critic.parameters(), agent.target_critic.parameters()):
        assert torch.equal(a, b) and not b.requires_grad


# ---------------------------------------------------------------- the env loop
def test_replay_rows_match_jax_main(tmp_path, monkeypatch):
    """Warm-up only: every checkpoint's rows (data, write head, fill flag),
    bit for bit, the counter env behind both packages' loops."""
    common = ["exp=droq", "env=jax_pendulum", "env.id=jax_pendulum", "algo.env_backend=jax", "fabric.accelerator=cpu",
              "metric.log_level=0", "env.capture_video=False", "buffer.memmap=False", "algo.run_test=False",
              f"env.num_envs={N_ENVS}", "algo.mlp_keys.encoder=[state]", "algo.hidden_size=8",
              f"algo.total_steps={STEPS * N_ENVS}", f"algo.learning_starts={10 * STEPS * N_ENVS}",
              f"checkpoint.every={EVERY * N_ENVS}", "checkpoint.save_last=True", "buffer.size=60", "seed=5",
              "env.sync_env=True"]
    jax_actions = _draws()
    made = []

    def jax_vector_env(thunks, **kwargs):
        envs = JaxVectorEnv(CounterJax(), len(thunks), seed=5, max_episode_steps=LIMIT)
        envs.action_space.sample = lambda: jax_actions.pop(0)
        made.append(envs)
        return envs

    monkeypatch.setattr(gym.vector, "SyncVectorEnv", jax_vector_env)
    jax_run([f"root_dir={tmp_path}/jax", "run_name=rows", *common])
    assert made

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


def test_run_benchmarks_keeps_the_replay_ratio_as_jax_does(tmp_path, monkeypatch):
    """Under ``run_benchmarks=True`` DroQ takes ``ratio(...)`` gradient steps
    an iteration, as JAX's loop does (``droq.py:368``), where SAC pins one
    (its family's ``benchmark_pin``): the port's count equals the sum of
    what JAX's ratio granted, the counter env behind both loops."""
    common = ["exp=droq", "env=jax_pendulum", "env.id=jax_pendulum", "algo.env_backend=jax", "fabric.accelerator=cpu",
              "metric.log_level=0", "buffer.memmap=False", "algo.run_test=False", f"env.num_envs={N_ENVS}",
              "algo.mlp_keys.encoder=[state]", "algo.hidden_size=8", "algo.per_rank_batch_size=4",
              f"algo.total_steps={8 * N_ENVS}", f"algo.learning_starts={4 * N_ENVS}", "algo.replay_ratio=0.5",
              "buffer.size=60", "seed=5", "env.sync_env=True", "run_benchmarks=True"]
    granted = []

    class CountingRatio(jax_droq.Ratio):
        def __call__(self, step):
            granted.append(super().__call__(step))
            return granted[-1]

    jax_actions = _draws()
    monkeypatch.setattr(jax_droq, "Ratio", CountingRatio)
    monkeypatch.setattr(gym.vector, "SyncVectorEnv", lambda thunks, **kw: _counter_envs(jax_actions))
    jax_run([f"root_dir={tmp_path}/jax", "run_name=bench", *common])
    monkeypatch.setattr(port_env, "make_train_envs", lambda cfg, runtime, **kw: _FedVectorEnv(
        CounterPort(), N_ENVS, max_episode_steps=LIMIT, device="cpu", actions=_draws()))
    out = run([f"root_dir={tmp_path}/port", "run_name=bench", *common])
    iters = out["iterations"] - out["learning_starts"] + 1
    assert len(granted) == iters and out["gradient_steps"] == sum(granted) > iters

    from sheeprl_tpu_torch.algos.sac.sac import SAC_FAMILY
    from sheeprl_tpu_torch.algos.droq.droq import DROQ_FAMILY

    assert SAC_FAMILY.benchmark_pin and not DROQ_FAMILY.benchmark_pin


def _counter_envs(actions):
    envs = JaxVectorEnv(CounterJax(), N_ENVS, seed=5, max_episode_steps=LIMIT)
    envs.action_space.sample = lambda: actions.pop(0)
    return envs


def droq_args(tmp_path, name, extra=()):
    return ["exp=droq", "env=jax_pendulum", "env.id=jax_pendulum", "algo.env_backend=jax", "fabric.accelerator=cpu",
            "metric.log_level=0", "algo.mlp_keys.encoder=[state]", "algo.hidden_size=16",
            "algo.per_rank_batch_size=8", "env.num_envs=2", "algo.replay_ratio=2", f"root_dir={tmp_path}",
            f"run_name={name}", *extra]


def test_cli_run_checkpoint_read_by_jax_and_resume(tmp_path, capsys):
    """Prioritized replay through the cache: a test reward, a checkpoint
    whose ``"agent"`` JAX's ``build_agent`` reads (its critics, deterministic,
    and its greedy actor give the port's values), a resume for one iteration."""
    extra = ["buffer.device_cache=True", "buffer.prioritized=True", "buffer.per_kernel=pallas",
             "algo.learning_starts=16", "algo.total_steps=40"]
    out = run(droq_args(tmp_path, "cli", extra))
    assert out["gradient_steps"] > 0 and out["iterations"] == 20 and out["dispatches"] == 13
    assert "Test - Reward:" in capsys.readouterr().out
    state_j = jax_load_checkpoint(out["checkpoint"])
    assert {"agent", "opt_states", "ratio", "rb", "replay_priority"} <= set(state_j)

    cfg_j = jax_compose(overrides=droq_args(tmp_path, "cli", extra))
    rt = JaxRuntime(devices=1, accelerator="cpu", precision="32-true")
    rt.launch()
    obs_space = gym.spaces.Dict({"state": gym.spaces.Box(-np.inf, np.inf, (3,), np.float32)})
    act_space = gym.spaces.Box(-2.0, 2.0, (1,), np.float32)
    actor_j, critic_j, params_j, _ = jax_agent.build_agent(rt, cfg_j, obs_space, act_space, state_j["agent"])
    from sheeprl_tpu_torch.envs.device import make_device_env

    env = make_device_env("jax_pendulum")
    agent, _ = build_agent(MeshRuntime(device="cpu").launch(), port_compose(overrides=droq_args(tmp_path, "cli", extra)),
                           env.observation_space, env.action_space)
    load_flax_params(agent, load_checkpoint(out["checkpoint"])["agent"])
    rng = np.random.default_rng(0)
    obs, act = rng.normal(size=(6, 3)).astype(np.float32), rng.uniform(-2, 2, (6, 1)).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(actor_greedy_action(agent.actor, _t(obs)).numpy(),
                                   np.asarray(jax_greedy(actor_j, params_j["actor"], jnp.asarray(obs))), rtol=TOL, atol=TOL)
        for name in ("critic", "target_critic"):
            want = jax_agent.droq_ensemble_apply(critic_j, params_j[name], jnp.asarray(obs), jnp.asarray(act))
            np.testing.assert_allclose(getattr(agent, name)(_t(obs), _t(act)).numpy(), np.asarray(want), rtol=TOL, atol=TOL)

    resumed = run(droq_args(tmp_path, "cli_resumed", ["algo.total_steps=42", f"checkpoint.resume_from={out['checkpoint']}"]))
    assert resumed["iterations"] == 1 and resumed["policy_step"] == 42 and os.path.exists(resumed["checkpoint"])
    assert load_checkpoint(resumed["checkpoint"])["iter_num"] == 21


def test_dispatch_batch_is_sac_only(tmp_path):
    """DroQ dispatches every iteration's critic steps, as JAX's loop does,
    whatever ``algo.dispatch_batch`` (a SAC knob) says."""
    extra = ["algo.learning_starts=16", "algo.total_steps=24", "algo.run_test=False"]
    a = run(droq_args(tmp_path, "a", extra))
    b = run(droq_args(tmp_path, "b", [*extra, "algo.dispatch_batch=8"]))
    assert a["dispatches"] == b["dispatches"] == a["iterations"] - a["learning_starts"] + 1


def test_exp_composes_the_published_recipe_and_refuses_what_is_not_ported(tmp_path):
    cfg = port_compose(overrides=["exp=droq"])
    assert cfg.algo.replay_ratio == 20.0 and cfg.algo.critic.dropout == 0.01 and cfg.buffer.memmap is False
    assert cfg.algo.name == "droq" and cfg.algo.critic.n == 2
    for override, item in {"buffer.rate_limiter.samples_per_insert=2.0": "A2", "fabric.devices=2": "A5"}.items():
        with pytest.raises((NotImplementedError, ValueError), match=item):
            run(droq_args(tmp_path, "scope", ["algo.total_steps=8", override]))
    with pytest.raises(ValueError, match="continuous action space is supported for the DroQ agent"):
        run(droq_args(tmp_path, "scope", ["algo.total_steps=8", "env=jax_cartpole", "env.id=jax_cartpole"]))


# ---------------------------------------------------------------- chip_smoke rehearsal
def test_chip_smoke_droq_cli_phase_runs_on_cpu():
    import chip_smoke

    res = chip_smoke.run_droq_cli(
        "cpu", overrides=["algo.hidden_size=16", "algo.per_rank_batch_size=8", "algo.learning_starts=16",
                          "algo.replay_ratio=2"], iters=3, profile=False,
    )
    assert res["dispatches"] == 4 and res["ms_per_training_iteration"] > 0 and res["launches"] == {}
    assert res["gradient_steps"] == 24 and res["resumed"]["iterations"] == 1 and res["test_reward"] is not None
    assert res["draw_vs_plain"]["bytes_equal"] and set(res["draw_vs_plain"]["kernels"]) == set(chip_smoke.SAC_CLI_KERNELS)
    assert res["replay_ratio"] == 2.0 and res["dropout"] == 0.01
