"""The port's SAC train function and dispatch against the JAX package's.

A tiny SAC (5-d observations, 2 actions, hidden 16, 2 critics) runs G = 3
gradient steps of B = 8 through JAX's ``make_train_fn`` and the port's, from
the same converted parameters and Adam states, with the normal noise JAX
draws from its key fed to the port, for ``prioritized`` True and False.
Then one whole ``train_dispatch`` against the JAX sequence flush ->
``sample_transitions_per`` -> train function -> ``update_priorities`` with
the same draws.

Tolerances, f32 throughout: losses, the gradient norm, |delta| and the
priorities built from it 1e-3 relative.  The parameters agree to about
1e-7 after every step, but the log-prob's ``log(scale (1 - tanh(x)^2) + 1e-6)``
turns the last-ulp difference between two libraries' ``tanh`` of a large
pre-activation into up to 1e-3 of a log-prob, and the critic's target
carries it (at the initial weights the log-probs of the two packages differ
by up to 5e-5); the Adam moments, which hold those gradients, 3e-3 of each
tensor's largest magnitude; parameters, the target
critic and ``log_alpha`` 3e-6 absolute: Adam moves a weight by up to
lr = 3e-4 a step whatever its gradient's size, so this is a hundredth of
one step.
"""

import copy
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.sac import agent as jax_agent
from sheeprl_tpu.algos.sac.sac import _make_optimizer as jax_make_optimizer
from sheeprl_tpu.algos.sac.sac import make_train_fn as jax_make_train_fn
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.parallel.mesh import MeshRuntime as JaxRuntime
from sheeprl_tpu.replay import per_beta_schedule as jax_beta_schedule
from sheeprl_tpu_torch.algos.sac.agent import build_agent
from sheeprl_tpu_torch.algos.sac.sac import make_train_state, train_dispatch
from sheeprl_tpu_torch.algos.sac.utils import prepare_obs
from sheeprl_tpu_torch.config import compose as port_compose
from sheeprl_tpu_torch.data.device_buffer import DeviceReplayCache
from sheeprl_tpu_torch.parallel.mesh import MeshRuntime
from sheeprl_tpu_torch.replay import per_beta_schedule
from sheeprl_tpu_torch.utils.convert import ConversionError, flax_to_torch, load_flax_params, opt_state_to_torch

from test_torch_replay import JaxCache

RTOL = 1e-3
MOMENT_RTOL = 3e-3
PARAM_ATOL = 3e-6
OBS, ACT, HIDDEN = 5, 2, 16
G, B = 3, 8
OVERRIDES = [
    "exp=sac_dmc_walker_walk", f"algo.hidden_size={HIDDEN}", f"algo.per_rank_batch_size={B}",
    "buffer.memmap=False", "buffer.device_cache=True",
]
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


def sac_pair(prioritized):
    """The tiny SAC in both packages, on the same weights and Adam states."""
    overrides = OVERRIDES + [f"buffer.prioritized={prioritized}"]
    cfg_j = jax_compose(overrides=overrides)
    rt = JaxRuntime(devices=1, accelerator="cpu", precision="32-true")
    rt.launch()
    actor, critic, params, target_entropy = jax_agent.build_agent(rt, cfg_j, OBS_SPACE, ACTION_SPACE)
    params = _np_tree(params)
    # a target critic that differs from the critic, so that the EMA shows
    params["target_critic"] = jax.tree_util.tree_map(lambda x: x * np.float32(0.5), params["critic"])
    txs = [jax_make_optimizer(cfg_j.algo[g].optimizer, "32-true") for g in GROUPS]
    cpu = jax.devices("cpu")[0]
    jparams = jax.device_put(params, cpu)
    opt = jax.device_put(
        {"actor": txs[0].init(jparams["actor"]), "critic": txs[1].init(jparams["critic"]), "alpha": txs[2].init(jparams["log_alpha"])},
        cpu,
    )
    train_j = jax_make_train_fn(rt, actor, critic, txs, cfg_j, target_entropy, prioritized=prioritized)

    cfg_t = port_compose(overrides=overrides)
    runtime = MeshRuntime(device="cpu", seed=0).launch()
    agent, target_entropy_t = build_agent(runtime, cfg_t, OBS_SPACE, ACTION_SPACE)
    assert target_entropy_t == target_entropy == -ACT
    load_flax_params(agent, params)
    state = make_train_state(runtime, agent, cfg_t, target_entropy_t, prioritized)
    for g, module in (("actor", agent.actor), ("critic", agent.critic), ("alpha", agent)):
        state.opt_states[g] = opt_state_to_torch(_np_tree(opt[g]), module, g)
    return {
        "jax": {"params": jparams, "opt": opt, "train": train_j, "device": cpu, "cfg": cfg_j},
        "agent": agent, "state": state, "cfg": cfg_t,
    }


def sac_batch(rng, prioritized):
    obs = rng.normal(size=(G, B, OBS)).astype(np.float32)
    data = {
        "observations": obs,
        "next_observations": (obs + 0.1 * rng.normal(size=obs.shape)).astype(np.float32),
        "actions": rng.uniform(-1, 1, size=(G, B, ACT)).astype(np.float32),
        "rewards": rng.normal(size=(G, B, 1)).astype(np.float32),
        "terminated": (rng.uniform(size=(G, B, 1)) < 0.2).astype(np.float32),
        "truncated": np.zeros((G, B, 1), np.float32),
    }
    if prioritized:
        data["is_weights"] = rng.uniform(0.2, 1.0, size=(G, B, 1)).astype(np.float32)
    return data


def jax_noise(key, g=G, b=B):
    """JAX's draws: ``split(key, G)``, then per step ``k1, k2 = split(k)``,
    ``normal(k1)`` for the next actions and ``normal(k2)`` for the actor loss."""
    out = []
    for k in jax.random.split(key, g):
        k1, k2 = jax.random.split(k)
        out.append([np.asarray(jax.random.normal(kk, (b, ACT), np.float32)) for kk in (k1, k2)])
    return torch.from_numpy(np.asarray(out))


def _close(a, b, what, rtol):
    """Within ``rtol`` of ``b``'s largest magnitude."""
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


@pytest.mark.parametrize("prioritized", [False, True])
def test_train_fn_matches_jax(prioritized):
    pair = sac_pair(prioritized)
    j, state = pair["jax"], pair["state"]
    compare_states(pair)  # the conversion itself
    rng = np.random.default_rng(1)
    do_ema = np.array([True, False, True])
    for dispatch in range(2):
        data = sac_batch(rng, prioritized)
        key = jax.random.PRNGKey(10 + dispatch)
        out_j = j["train"](j["params"], j["opt"], jax.device_put(data, j["device"]), jax.device_put(key, j["device"]), jax.numpy.asarray(do_ema))
        j["params"], j["opt"], mj = out_j[:3]
        out_t = state.train_fn(state.opt_states, {k: torch.from_numpy(v) for k, v in data.items()}, do_ema, noise=jax_noise(key))
        state.opt_states, mt = out_t[:2]
        assert set(mt) == set(mj) == {"Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss", "Grads/agent"}
        for k in mj:
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=RTOL, atol=1e-7, err_msg=f"dispatch {dispatch} {k}")
        if prioritized:
            assert out_t[2].shape == (G, B)
            np.testing.assert_allclose(out_t[2].numpy(), np.asarray(out_j[3]), rtol=RTOL, atol=1e-7)
        compare_states(pair)


def test_sac_conversion_rejects_bad_trees():
    pair = sac_pair(False)
    params = _np_tree(pair["jax"]["params"])
    with pytest.raises(ConversionError, match="expected keys"):
        flax_to_torch({k: v for k, v in params.items() if k != "log_alpha"}, pair["agent"])
    bad = copy.deepcopy(params)
    bad["critic"]["params"]["MLP_0"]["Dense_0"]["kernel"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ConversionError, match="critic"):
        flax_to_torch(bad, pair["agent"])


def test_build_agent_initialises_like_flax():
    """Zero biases, lecun-normal kernels (variance 1 / fan_in, cut at 2 std),
    a target critic equal to the critic and out of autograd, log_alpha =
    log(alpha), critics of the ensemble drawn independently."""
    cfg = port_compose(overrides=OVERRIDES + ["algo.hidden_size=256"])
    agent, _ = build_agent(MeshRuntime(device="cpu", seed=5).launch(), cfg, {"state": SimpleNamespace(shape=(24,))},
                           SimpleNamespace(shape=(6,), low=-np.ones(6), high=np.ones(6)))
    assert agent.critic.weights[0].shape == (2, 30, 256) and agent.critic.biases[2].shape == (2, 1)
    for a, b in zip(agent.critic.parameters(), agent.target_critic.parameters()):
        assert torch.equal(a, b) and not b.requires_grad
    assert float(agent.log_alpha) == 0.0
    w = agent.critic.weights[1].detach()
    std = (1.0 / 256) ** 0.5
    assert float(w.abs().max()) <= 2 * std / 0.8796 + 1e-6 and 0.9 * std < float(w.std()) < 1.1 * std
    assert not torch.equal(w[0], w[1])
    assert float(agent.actor.trunk.layers[0].bias.abs().max()) == 0.0
    obs = {"state": np.zeros((3, 24))}
    assert prepare_obs(obs, mlp_keys=["state"], num_envs=3).shape == (3, 24)


def _rows(rng, t_len, n_envs):
    """Walker-shaped rows at tiny width, as ``main`` stores them."""
    obs = rng.normal(size=(t_len, n_envs, OBS)).astype(np.float32)
    return {
        "terminated": (rng.uniform(size=(t_len, n_envs, 1)) < 0.05).astype(np.uint8),
        "truncated": np.zeros((t_len, n_envs, 1), np.uint8),
        "actions": rng.uniform(-1, 1, size=(t_len, n_envs, ACT)).astype(np.float32),
        "observations": obs,
        "next_observations": (obs + 0.1).astype(np.float32),
        "rewards": rng.normal(size=(t_len, n_envs, 1)).astype(np.float32),
    }


@pytest.mark.parametrize("prioritized", [False, True])
def test_train_dispatch_matches_the_jax_sequence(prioritized):
    """One dispatch: the windowed flush of the pending rows, the draw, the
    train function and the priority update, against the JAX package's calls
    in the same order with the same draws."""
    pair = sac_pair(prioritized)
    j, state, cfg = pair["jax"], pair["state"], pair["cfg"]
    cap, n_envs = 64, 2
    kw = {"prioritized": prioritized, "kernel": "pallas"}
    jc = JaxCache(cap, n_envs, **kw)
    pc = DeviceReplayCache(cap, n_envs, device="cpu", **kw)
    rng = np.random.default_rng(2)
    first = _rows(rng, 20, n_envs)
    jc.add(first)
    pc.add(first)
    pending = [_rows(rng, 1, n_envs) for _ in range(G)]
    ema = np.array([True, True, False])
    key_sample, key_train = jax.random.PRNGKey(31), jax.random.PRNGKey(32)
    beta_j = jax_beta_schedule(0.4, 1.0, 1000)
    policy_step = 250

    # the JAX sequence (sac.py:500-571)
    jc.add({k: np.concatenate([r[k] for r in pending], 0) for k in pending[0]})
    if prioritized:
        sampled, idx = jc.sample_transitions_per(G, B, key_sample, beta_j(policy_step))
    else:
        sampled, idx = jc.sample_transitions(G, B, key_sample), None
    data = {k: v.astype(np.float32) for k, v in sampled.items()}
    out_j = j["train"](j["params"], j["opt"], data, key_train, jax.numpy.asarray(ema))
    j["params"], j["opt"] = out_j[:2]
    if prioritized:
        jc.update_priorities(idx, out_j[3])

    flat = G * B
    if prioritized:
        draws = {"r01": torch.from_numpy(np.asarray(jax.random.uniform(key_sample, (flat,))))}
    else:
        k_env, k_row = jax.random.split(key_sample)
        draws = {
            "envs": torch.from_numpy(np.asarray(jax.random.randint(k_env, (flat,), 0, n_envs)).astype(np.int32)),
            "u": torch.from_numpy(np.asarray(jax.random.uniform(k_row, (flat,)))),
        }
    metrics = train_dispatch(
        state, None, pc, cfg, ema, policy_step, per_beta_schedule(0.4, 1.0, 1000), pending, draws=draws, noise=jax_noise(key_train)
    )
    assert pending == [] and state.gradient_steps == G
    for k in out_j[2]:
        np.testing.assert_allclose(float(metrics[k]), float(out_j[2][k]), rtol=RTOL, atol=1e-7, err_msg=k)
    compare_states(pair)
    for k, ring in pc.buffers.items():
        np.testing.assert_array_equal(ring.numpy(), np.asarray(jc._bufs[k]), err_msg=k)
    if prioritized:
        np.testing.assert_allclose(pc.tree.tree.numpy()[1:], np.asarray(jc._tree.tree)[1:], rtol=RTOL, atol=0)
        np.testing.assert_allclose(float(pc.tree.max_priority), float(jc._tree.max_priority), rtol=RTOL)


def test_train_dispatch_falls_back_to_the_host_buffer():
    """Without a cache the batch comes from the host buffer: unit IS weights
    for a prioritized train function, no priorities to update."""
    from sheeprl_tpu_torch.data.buffers import ReplayBuffer

    pair = sac_pair(True)
    rb = ReplayBuffer(32, 2)
    rb.add(_rows(np.random.default_rng(4), 10, 2))
    rb.seed(0)
    metrics = train_dispatch(pair["state"], rb, None, pair["cfg"], [True] * G, 10, per_beta_schedule(0.4, 1.0, 100))
    assert all(np.isfinite(float(v)) for v in metrics.values())


def _leaves(node, prefix=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, node


def test_chip_smoke_sac_config_matches_the_composed_one():
    """chip_smoke.py's SAC dict is what the port and the JAX package compose
    for path A's configuration, on every key it holds."""
    from chip_smoke import SAC_WALKER

    overrides = [
        "exp=sac_dmc_walker_walk", "buffer.prioritized=True", "buffer.per_kernel=pallas", "buffer.device_cache=True",
        "buffer.memmap=False", "fabric.precision=32-true",
    ]
    port, ref = port_compose(overrides=overrides), jax_compose(overrides=overrides)
    for path, value in _leaves(SAC_WALKER):
        for cfg in (port, ref):
            node = cfg
            for k in path:
                node = node[k]
            assert node == value, path


def test_chip_smoke_sac_phase_runs_on_cpu():
    """chip_smoke.py's SAC phase at a tiny size on the CPU: the walker replay
    through the host buffer, the factory and windowed adds, both runs of
    ``train_dispatch`` and their comparison."""
    import chip_smoke
    from sheeprl_tpu_torch.config import dotdict

    cfg = copy.deepcopy(chip_smoke.SAC_WALKER)
    cfg["env"]["num_envs"] = 2
    cfg["algo"].update(per_rank_batch_size=8, dispatch_batch=4)
    for k in ("actor", "critic"):
        cfg["algo"][k]["hidden_size"] = 16
    res = chip_smoke.run_sac(dotdict(cfg), "cpu", dispatches=2, capacity=300, profile=False)
    assert len(res["losses_kernels"]) == 2 and res["leaves_identical"]
    assert res["max_abs_param_diff"] == 0.0 and res["max_rel_tree_diff"] == 0.0  # both runs are plain on the CPU
    assert all(v == 0 for v in res["launches"].values())  # CPU tensors never reach a kernel


def test_player_actions_match_jax():
    """The player's greedy action equals JAX's ``actor_greedy_action`` (1e-5)
    and a sampled one equals ``actor_action_and_log_prob``'s on the same
    noise (its log-prob to 1e-4: the saturated ``tanh`` of the module
    docstring); both stay inside the action bounds."""
    from sheeprl_tpu_torch.algos.sac.agent import SACPlayer, actor_action_and_log_prob

    pair = sac_pair(False)
    agent, params = pair["agent"], pair["jax"]["params"]
    actor_j = jax_agent.SACActor(hidden_size=HIDDEN, action_dim=ACT, action_low=ACTION_SPACE.low, action_high=ACTION_SPACE.high)
    obs = {"state": np.random.default_rng(0).normal(size=(4, OBS)).astype(np.float32)}
    player = SACPlayer(agent.actor, lambda o: prepare_obs(o, mlp_keys=["state"], num_envs=4))
    greedy = player.get_actions(obs, greedy=True)
    np.testing.assert_allclose(greedy.numpy(), np.asarray(jax_agent.actor_greedy_action(actor_j, params["actor"], obs["state"])), rtol=1e-5, atol=1e-6)
    key = jax.random.PRNGKey(3)
    want, logp_j = jax_agent.actor_action_and_log_prob(actor_j, params["actor"], obs["state"], key)
    noise = torch.from_numpy(np.asarray(jax.random.normal(key, (4, ACT), np.float32)))
    got, logp = actor_action_and_log_prob(agent.actor, torch.from_numpy(obs["state"]), noise)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(logp.detach().numpy(), np.asarray(logp_j), rtol=1e-4, atol=1e-4)
    sampled = player.get_actions(obs, torch.Generator().manual_seed(0))
    assert sampled.shape == (4, ACT) and float(sampled.abs().max()) <= 1.0


@pytest.mark.parametrize("layer_norm", [False, True])
def test_mlp_matches_flax(layer_norm):
    """``models.MLP`` (linear -> norm -> activation per layer, then a head)
    against flax's ``MLP`` on the same weights: 1e-5."""
    from sheeprl_tpu.models.models import MLP as FlaxMLP
    from sheeprl_tpu_torch.models.models import MLP

    x = np.random.default_rng(0).normal(size=(6, 7)).astype(np.float32)
    ref = FlaxMLP(hidden_sizes=(16, 8), output_dim=3, activation="tanh", layer_norm=layer_norm)
    params = ref.init(jax.random.PRNGKey(0), x)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + np.float32(0.1), params)  # non-trivial LayerNorm parameters
    mlp = MLP(7, (16, 8), 3, activation="tanh", layer_norm=layer_norm)
    p = params["params"]
    with torch.no_grad():
        for i, lin in enumerate([*mlp.layers, mlp.head]):
            lin.weight.copy_(torch.from_numpy(p[f"Dense_{i}"]["kernel"].T.copy()))
            lin.bias.copy_(torch.from_numpy(p[f"Dense_{i}"]["bias"]))
        for i, norm in enumerate(mlp.norms if layer_norm else []):
            norm.weight.copy_(torch.from_numpy(p[f"LayerNorm_{i}"]["scale"]))
            norm.bias.copy_(torch.from_numpy(p[f"LayerNorm_{i}"]["bias"]))
    np.testing.assert_allclose(mlp(torch.from_numpy(x)).detach().numpy(), np.asarray(ref.apply(params, x)), rtol=1e-5, atol=1e-5)
