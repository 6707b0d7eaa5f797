"""The port's DreamerV3 train step against the JAX package's.

The train step runs at tiny widths (T = 8, B = 4, horizon 3)
through JAX's ``make_train_fn`` and the port's, from the same converted
parameters and optimizer states, with the noise JAX draws from its key fed
to the port; two steps, every metric, the Adam moments (the clipped
gradients) and the updated parameters compared.  ``fused=True`` (the GRU
kernel's op) is in ``test_torch_dreamer_v3_train_fused.py``; the modules,
losses, continuous actions and the optimizer in
``test_torch_dreamer_v3_losses.py``.

Tolerances, f32 throughout: module outputs and losses 1e-5 (the tolerance
the JAX package holds its GRU kernel to); train-step metrics 1e-4
relative (sums over thousands of terms in another order, then an
optimizer step); parameters after the steps 2e-5 absolute (Adam moves a
weight by about lr = 1e-4 a step, so this is a fifth of one step).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3 import agent as jax_agent
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_fn as jax_make_train_fn
from sheeprl_tpu.algos.dreamer_v3.utils import init_moments as jax_init_moments
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.optim import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel.mesh import MeshRuntime as JaxRuntime
from sheeprl_tpu_torch.algos.dreamer_v3 import agent as port_agent
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_train_state
from sheeprl_tpu_torch.config import compose as port_compose
from sheeprl_tpu_torch.parallel.mesh import MeshRuntime
from sheeprl_tpu_torch.utils.convert import ConversionError, flax_to_torch, load_flax_params, opt_state_to_torch

from test_torch_dreamer_v3_player import OBS_SPACE, TINY

TOL = dict(rtol=1e-5, atol=1e-5)
STEP_RTOL = 1e-4
PARAM_ATOL = 2e-5
ACTIONS = (3, 2)
T, B, H = 8, 4, 3
GROUPS = ("world_model", "actor", "critic")


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


def tiny_train_pair(fused=False, continuous=False, actions_dim=ACTIONS, extra=()):
    """The whole tiny DreamerV3 in both packages, on the same weights and
    optimizer states, with each package's train step; ``extra`` overrides
    come last.  The reward and critic output layers start at zero in both
    packages (as configured), which leaves every value and the actor's loss
    at rounding noise; here they get random weights so that the actor's
    objective is a real one."""
    overrides = TINY + [
        f"algo.world_model.recurrent_model.fused={fused}", f"algo.horizon={H}",
        f"algo.per_rank_sequence_length={T}", f"algo.per_rank_batch_size={B}", *extra,
    ]
    cfg_j = jax_compose(overrides=overrides)
    rt = JaxRuntime(devices=1, accelerator="cpu", precision="32-true")
    rt.launch()
    wm, actor, critic, params = jax_agent.build_agent(rt, actions_dim, continuous, cfg_j, OBS_SPACE)
    params = _np_tree(params)
    rng = np.random.default_rng(7)
    for tree in (params["critic"], params["world_model"]["reward_model"]):
        kernel = tree["params"]["Dense_0"]["kernel"]
        tree["params"]["Dense_0"]["kernel"] = rng.normal(scale=0.5, size=kernel.shape).astype(np.float32)
    params["target_critic"] = copy.deepcopy(params["critic"])
    txs = [jax_build_optimizer(cfg_j.algo[g].optimizer, cfg_j.algo[g].clip_gradients, "32-true") for g in GROUPS]
    # committed inputs: the jitted step then compiles once, not again on
    # its own (committed) outputs
    cpu = jax.devices("cpu")[0]
    jparams = jax.device_put(params, cpu)
    opt = jax.device_put({g: tx.init(jparams[g]) for g, tx in zip(GROUPS, txs)}, cpu)
    train_j = jax_make_train_fn(rt, wm, actor, critic, txs, cfg_j, continuous, actions_dim)

    cfg_t = port_compose(overrides=overrides)
    runtime = MeshRuntime(device="cpu", seed=0).launch()
    agent = port_agent.build_agent(runtime, actions_dim, continuous, cfg_t, OBS_SPACE)
    load_flax_params(agent, params)
    state = make_train_state(runtime, agent, cfg_t, continuous, actions_dim)
    return {
        "jax": {"wm": wm, "actor": actor, "critic": critic, "params": jparams, "opt": opt, "train": train_j,
                "moments": jax.device_put(jax_init_moments(), cpu), "device": cpu},
        "agent": agent, "state": state, "cfg": cfg_t, "actions_dim": actions_dim, "continuous": continuous,
    }


def tiny_batch(rng, actions_dim=ACTIONS, continuous=False):
    if continuous:
        actions = np.tanh(rng.normal(size=(T, B, sum(actions_dim)))).astype(np.float32)
    else:
        actions = np.concatenate([np.eye(d, dtype=np.float32)[rng.integers(0, d, (T, B))] for d in actions_dim], -1)
    return {
        "rgb": rng.integers(0, 256, size=(T, B, 16, 16, 3)).astype(np.uint8),
        "state": rng.normal(size=(T, B, 5)).astype(np.float32),
        "actions": actions,
        "rewards": rng.normal(size=(T, B, 1)).astype(np.float32),
        "terminated": (rng.uniform(size=(T, B, 1)) < 0.1).astype(np.float32),
        "truncated": np.zeros((T, B, 1), np.float32),
        "is_first": (rng.uniform(size=(T, B, 1)) < 0.1).astype(np.float32),
    }


def jax_step_noise(key, actions_dim=ACTIONS, continuous=False, stoch=4, discrete=4):
    """The draws of JAX's ``train`` from ``key``, in the port's layout:
    ``split(key, 3)`` -> dynamic Gumbel noise; ``split(k_img)`` ->
    imagination Gumbel noise and ``split(k_img_a, H + 1)`` actor keys, each
    split per discrete head (or one normal draw for continuous actions)."""
    k_dyn, k_img, _ = jax.random.split(key, 3)
    dyn = jax.random.gumbel(k_dyn, (T, B, stoch, discrete), jnp.float32)
    k_img_n, k_img_a = jax.random.split(k_img)
    img = jax.random.gumbel(k_img_n, (H, T * B, stoch, discrete), jnp.float32)
    act = []
    for k in jax.random.split(k_img_a, H + 1):
        if continuous:
            act.append(np.asarray(jax.random.normal(k, (T * B, sum(actions_dim)))))
        else:
            keys = jax.random.split(k, len(actions_dim))
            act.append(np.concatenate([np.asarray(jax.random.gumbel(kk, (T * B, d))) for kk, d in zip(keys, actions_dim)], -1))
    return {"dyn": _t(dyn), "img": _t(img), "act": _t(np.stack(act))}


def run_and_compare(pair, steps=2, seed=0):
    """``steps`` train steps through both packages; every metric, the Adam
    states and the parameters compared after each."""
    j, state, agent = pair["jax"], pair["state"], pair["agent"]
    rng = np.random.default_rng(seed)
    for step in range(steps):
        data = tiny_batch(rng, pair["actions_dim"], pair["continuous"])
        key = jax.random.PRNGKey(100 + step)
        j["params"], j["opt"], j["moments"], mj = j["train"](
            j["params"], j["opt"], j["moments"], jax.device_put(data, j["device"]), jax.device_put(key, j["device"])
        )
        noise = jax_step_noise(key, pair["actions_dim"], pair["continuous"])
        state.opt_states, state.moments, mt = state.train_fn(
            state.opt_states, state.moments, {k: _t(v) for k, v in data.items()}, noise=noise
        )
        assert set(mt) == set(mj)
        for k in mj:
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=STEP_RTOL, atol=1e-7, err_msg=f"step {step} {k}")
        for k in ("low", "high"):
            np.testing.assert_allclose(float(state.moments[k]), float(j["moments"][k]), rtol=STEP_RTOL, atol=1e-6)
        want = flax_to_torch(_np_tree(j["params"]), agent)
        got = agent.state_dict()
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=PARAM_ATOL, err_msg=f"step {step} {k}")
        for g, module in (("world_model", agent.world_model), ("actor", agent.actor), ("critic", agent.critic)):
            ref = opt_state_to_torch(_np_tree(j["opt"][g]), module, g)
            mine = state.opt_states[g]
            assert mine.count == ref.count == step + 1
            for k in ref.mu:
                for a, b in ((mine.mu[k], ref.mu[k]), (mine.nu[k], ref.nu[k])):
                    scale = float(b.abs().max()) + 1e-30
                    assert float((a - b).abs().max()) <= STEP_RTOL * scale, f"step {step} {g} {k}"


def test_train_step_matches_jax():
    run_and_compare(tiny_train_pair(fused=False))


def test_full_agent_conversion_rejects_player_trees_and_bad_leaves():
    pair = tiny_train_pair()
    params = _np_tree(pair["jax"]["params"])
    flax_to_torch(params, pair["agent"])
    with pytest.raises(ConversionError, match="expected keys"):
        flax_to_torch({"world_model": params["world_model"], "actor": params["actor"]}, pair["agent"])
    bad = copy.deepcopy(params)
    bad["critic"]["params"]["Dense_0"]["kernel"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ConversionError, match="critic"):
        flax_to_torch(bad, pair["agent"])
    # the player is still served from the full agent's modules
    player = pair["agent"].player()
    player_tree = {"world_model": params["world_model"], "actor": params["actor"]}
    assert flax_to_torch(player_tree, player).keys() == player.state_dict().keys()


def test_build_agent_initialises_like_flax():
    """Zero reward and critic heads (so the XL run starts where JAX's
    does), a target critic equal to the critic and left out of autograd,
    and trunk weights with the fan-average truncated normal's spread."""
    cfg = port_compose(overrides=TINY)
    agent = port_agent.build_agent(MeshRuntime(device="cpu", seed=3).launch(), ACTIONS, False, cfg, OBS_SPACE)
    assert float(agent.critic.head.weight.detach().abs().max()) == 0.0
    assert float(agent.world_model.reward_model.head.weight.detach().abs().max()) == 0.0
    for a, b in zip(agent.critic.parameters(), agent.target_critic.parameters()):
        assert torch.equal(a, b) and not b.requires_grad
    w = agent.world_model.observation_model.cnn_decoder.dense.weight.detach()
    std = (2.0 / sum(w.shape)) ** 0.5
    assert float(w.abs().max()) <= 2 * std / 0.8796 + 1e-6
    assert 0.7 * std < float(w.std()) < 1.3 * std


def test_chip_smoke_training_phase_runs_on_cpu():
    """chip_smoke.py's training phase at tiny widths on the CPU: replay
    fill through the host buffer and the device cache, both runs of
    ``train_steps``, and the comparison between them."""
    import chip_smoke
    from test_torch_serve import _tiny_chip_cfg

    cfg = _tiny_chip_cfg()
    a, wm = cfg.algo, cfg.algo.world_model
    wm.observation_model.update(cnn_channels_multiplier=4, mlp_layers=1, dense_units=16)
    for node in (wm.reward_model, wm.discount_model, a.critic):
        node.update(mlp_layers=1, dense_units=16)
    wm.reward_model.bins = a.critic.bins = 15
    a.update(horizon=3, per_rank_sequence_length=8, per_rank_batch_size=4)

    real = chip_smoke.crafter_transitions

    def small(rng, rows, actions):
        d = real(rng, rows, actions)
        d["rgb"] = np.ascontiguousarray(d["rgb"][:, :, :16, :16])
        return d

    chip_smoke.crafter_transitions = small
    try:
        res = chip_smoke.run_training(cfg, {"rgb": (16, 16, 3), "reward": (1,)}, (17,), "cpu", steps=2, capacity=256)
    finally:
        chip_smoke.crafter_transitions = real
    assert len(res["losses_kernels"]) == 2 and res["categorical_samples"] == 2 * (8 * 4 * 4 + 3 * 32 * 4)
    assert res["max_abs_param_diff"] == 0.0  # on the CPU both runs compute the plain version
