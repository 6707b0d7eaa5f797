"""The port's DreamerV2 (``algos/dreamer_v2``) against the JAX package's, on
the CPU at small widths (dense 16, one layer, H = 16, stochastic 4 x 4,
T = 8, B = 4, horizon 3).

- the modules: the encoder (MLP and the 64x64 conv stages), the decoder,
  the RSSM's methods, the actor's heads (discrete with MineDojo masks,
  ``trunc_normal``, ``tanh_normal``) and ``TruncatedNormal`` (log_prob,
  rsample from given uniforms, entropy, mean);
- two train steps against JAX's ``make_train_fn`` on converted state, JAX's
  noise rebuilt from its key: discrete actions (GridWorld's four) with
  JAX's ``dyn_bptt`` on, and off with ``use_continues`` and an image key;
  continuous actions (Pendulum's one) with ``objective_mix`` 0, so that the
  actor's gradient runs through the imagined dynamics;
- the parameter and Adam trees both ways, and the hard target copy's
  schedule;
- the replay rows of the port's ``main`` against JAX's on ``jax_gridworld``,
  bit for bit (``test_torch_dv3_loop.py``'s machinery), zero-action seed
  rows and reset rows included;
- a CLI run whose checkpoint JAX reads, and a resume for one iteration;
  the raise for ``buffer.type=episode``; a CPU rehearsal of
  ``chip_smoke.py``'s ``dv2_cli`` phase.

Tolerances, f32 throughout: module outputs 1e-5; train-step metrics 1e-4
relative and parameters 2e-5 absolute after two steps, as DreamerV3's
parity holds them.
"""

import copy
import os

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v2 import agent as jax_agent
from sheeprl_tpu.algos.dreamer_v2.dreamer_v2 import make_train_fn as jax_make_train_fn
from sheeprl_tpu.cli import run as jax_run
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.envs.jax import JaxVectorEnv
from sheeprl_tpu.envs.jax.gridworld import GridWorldJax
from sheeprl_tpu.optim import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel.mesh import MeshRuntime as JaxRuntime
from sheeprl_tpu.utils import distribution as jax_dist
from sheeprl_tpu.utils.callback import load_checkpoint as jax_load_checkpoint
from sheeprl_tpu_torch.algos.dreamer_v2 import agent as port_agent
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import make_train_state
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import train_steps
from sheeprl_tpu_torch.cli import run
from sheeprl_tpu_torch.config import compose as port_compose
from sheeprl_tpu_torch.envs.device import make_device_env
from sheeprl_tpu_torch.parallel.mesh import MeshRuntime
from sheeprl_tpu_torch.utils import env as port_env
from sheeprl_tpu_torch.utils.ckpt_format import load_checkpoint
from sheeprl_tpu_torch.utils.convert import (
    adam_state_from_tree,
    adam_state_to_tree,
    flax_to_torch,
    load_flax_params,
    opt_state_to_torch,
    torch_to_flax,
)
from sheeprl_tpu_torch.utils.distribution import TruncatedNormal

from test_torch_dv3_loop import EVERY, GRID, LIMIT, MLP_ONLY, N_ENVS, STEPS, _buffers, _draws, _FedVectorEnv

TOL = dict(rtol=1e-5, atol=1e-5)
STEP_RTOL = 1e-4
PARAM_ATOL = 2e-5
T, B, H = 8, 4, 3
S, D, REC = 4, 4, 16
GROUPS = ("world_model", "actor", "critic")
TINY = [
    "exp=dreamer_v2", "algo.dense_units=16", "algo.mlp_layers=1",
    f"algo.world_model.recurrent_model.recurrent_state_size={REC}",
    "algo.world_model.representation_model.hidden_size=16", "algo.world_model.transition_model.hidden_size=16",
    f"algo.world_model.stochastic_size={S}", f"algo.world_model.discrete_size={D}",
    # 8 channels a multiple: over the 2 of the last decoder LayerNorm at 1, the
    # fast variance cancels and the two packages part by 1e-3
    "algo.world_model.encoder.cnn_channels_multiplier=8", f"algo.per_rank_batch_size={B}",
    f"algo.per_rank_sequence_length={T}", f"algo.horizon={H}",
]
STATE = gym.spaces.Box(-np.inf, np.inf, (5,), np.float32)
RGB = gym.spaces.Box(0, 255, (64, 64, 3), np.uint8)
# name: (actions_dim, continuous, overrides, observation keys)
CASES = {
    "discrete_bptt": ((4,), False, ["algo.world_model.dyn_bptt=True", *MLP_ONLY], ("state",)),
    "discrete_continues_rgb": (
        (4,), False,
        ["algo.world_model.dyn_bptt=False", "algo.world_model.use_continues=True", "algo.layer_norm=True",
         "algo.mlp_keys.encoder=[state]", "algo.cnn_keys.encoder=[rgb]"],
        ("state", "rgb"),
    ),
    "continuous_dynamics": ((1,), True, ["algo.actor.objective_mix=0.0", *MLP_ONLY], ("state",)),
}


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


def dv2_pair(name):
    """The tiny DreamerV2 of ``CASES[name]`` in both packages on the same
    weights and optimizer states, with each package's train step.  The
    reward and critic heads get larger random weights so that the values and
    the actor's objective are not rounding noise."""
    actions_dim, continuous, extra, keys = CASES[name]
    overrides = TINY + extra
    obs_space = _obs_space(keys)
    cfg_j = jax_compose(overrides=overrides)
    rt = JaxRuntime(devices=1, accelerator="cpu", precision="32-true")
    rt.launch()
    wm, actor, critic, params = jax_agent.build_agent(rt, actions_dim, continuous, cfg_j, obs_space)
    params = _np_tree(params)
    rng = np.random.default_rng(7)
    for tree in (params["critic"], params["world_model"]["reward_model"]):
        kernel = tree["params"]["Dense_0"]["kernel"]
        tree["params"]["Dense_0"]["kernel"] = rng.normal(scale=0.5, size=kernel.shape).astype(np.float32)
    params["target_critic"] = copy.deepcopy(params["critic"])
    params["target_critic"]["params"]["Dense_0"]["bias"] = np.full((1,), 0.3, np.float32)  # not the critic
    txs = [jax_build_optimizer(cfg_j.algo[g].optimizer, cfg_j.algo[g].clip_gradients, "32-true") for g in GROUPS]
    cpu = jax.devices("cpu")[0]
    jparams = jax.device_put(params, cpu)
    opt = jax.device_put({g: tx.init(jparams[g]) for g, tx in zip(GROUPS, txs)}, cpu)
    train_j = jax_make_train_fn(rt, wm, actor, critic, txs, cfg_j, continuous, actions_dim)

    cfg_t = port_compose(overrides=overrides)
    runtime = MeshRuntime(device="cpu", seed=0).launch()
    agent = port_agent.build_agent(runtime, actions_dim, continuous, cfg_t, obs_space)
    load_flax_params(agent, params)
    state = make_train_state(runtime, agent, cfg_t, continuous, actions_dim)
    return {"jax": {"wm": wm, "actor": actor, "critic": critic, "params": jparams, "opt": opt, "train": train_j,
                    "device": cpu, "cfg": cfg_j},
            "agent": agent, "state": state, "cfg": cfg_t, "actions_dim": actions_dim, "continuous": continuous,
            "keys": keys}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    return dv2_pair(request.param)


def dv2_batch(rng, actions_dim, continuous, keys, is_first=True):
    if continuous:
        actions = np.tanh(rng.normal(size=(T, B, sum(actions_dim)))).astype(np.float32)
    else:
        actions = np.concatenate([np.eye(d, dtype=np.float32)[rng.integers(0, d, (T, B))] for d in actions_dim], -1)
    data = {
        "state": rng.normal(size=(T, B, 5)).astype(np.float32),
        "actions": actions,
        "rewards": rng.normal(size=(T, B, 1)).astype(np.float32),
        "terminated": (rng.uniform(size=(T, B, 1)) < 0.1).astype(np.float32),
        "truncated": np.zeros((T, B, 1), np.float32),
    }
    if "rgb" in keys:
        data["rgb"] = rng.integers(0, 256, size=(T, B, 64, 64, 3)).astype(np.uint8)
    if is_first:
        data["is_first"] = (rng.uniform(size=(T, B, 1)) < 0.1).astype(np.float32)
    return data


def actor_noise(k, actions_dim, continuous, dist="trunc_normal", rows=T * B):
    """The draws of JAX's actor from ``k`` (one imagination step), in the port's layout."""
    if not continuous:
        keys = jax.random.split(k, len(actions_dim))
        return np.concatenate([np.asarray(jax.random.gumbel(kk, (rows, d))) for kk, d in zip(keys, actions_dim)], -1)
    if dist == "trunc_normal":
        return np.asarray(jax.random.uniform(k, (rows, sum(actions_dim)), minval=1e-6, maxval=1.0 - 1e-6))
    return np.asarray(jax.random.normal(k, (rows, sum(actions_dim))))


def jax_step_noise(key, actions_dim, continuous):
    """JAX's ``train`` draws from ``key``: ``split(key)`` -> the dynamic
    loop's Gumbel noise and ``split(k_img)`` -> imagination's and
    ``split(k_img_a, H + 1)`` actor keys (the last one's draw is unused)."""
    k_dyn, k_img = jax.random.split(key)
    dyn = jax.random.gumbel(k_dyn, (T, B, S, D), jnp.float32)
    k_img_n, k_img_a = jax.random.split(k_img)
    img = jax.random.gumbel(k_img_n, (H, T * B, S, D), jnp.float32)
    act = [actor_noise(k, actions_dim, continuous) for k in jax.random.split(k_img_a, H + 1)[:H]]
    return {"dyn": _t(dyn), "img": _t(img), "act": _t(np.stack(act))}


def compare_params_and_opt(pair, step, params_j, opt_j, state, groups=GROUPS):
    agent = pair["agent"]
    want = flax_to_torch(_np_tree(params_j), agent)
    got = agent.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=PARAM_ATOL, err_msg=f"step {step} {k}")
    for g in groups:
        ref = opt_state_to_torch(_np_tree(opt_j[g]), getattr(agent, g), g)
        mine = state.opt_states[g]
        assert mine.count == ref.count == step + 1
        for k in ref.mu:
            for a, b in ((mine.mu[k], ref.mu[k]), (mine.nu[k], ref.nu[k])):
                scale = float(b.abs().max()) + 1e-30
                assert float((a - b).abs().max()) <= STEP_RTOL * scale, f"step {step} {g} {k}"


def run_and_compare(pair, noise_fn, steps=2, seed=0, is_first=True):
    """``steps`` train steps through both packages; every metric, the
    parameters (the target critic untouched by both) and the Adam states."""
    j, state = pair["jax"], pair["state"]
    rng = np.random.default_rng(seed)
    for step in range(steps):
        data = dv2_batch(rng, pair["actions_dim"], pair["continuous"], pair["keys"], is_first)
        key = jax.random.PRNGKey(100 + step)
        j["params"], j["opt"], mj = j["train"](j["params"], j["opt"], jax.device_put(data, j["device"]),
                                               jax.device_put(key, j["device"]))
        noise = noise_fn(key, pair["actions_dim"], pair["continuous"])
        state.opt_states, state.moments, mt = state.train_fn(state.opt_states, state.moments,
                                                             {k: _t(v) for k, v in data.items()}, noise=noise)
        assert set(mt) == set(mj) and len(mt) == 13
        for k in mj:
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=STEP_RTOL, atol=1e-7, err_msg=f"step {step} {k}")
        compare_params_and_opt(pair, step, j["params"], j["opt"], state)


# ---------------------------------------------------------------- modules
def test_truncated_normal_matches_jax():
    rng = np.random.default_rng(0)
    loc = np.tanh(rng.normal(size=(6, 3))).astype(np.float32)
    scale = (2 / (1 + np.exp(-rng.normal(size=(6, 3)))) + 0.1).astype(np.float32)
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (6, 3), minval=1e-6, maxval=1 - 1e-6))
    mine, theirs = TruncatedNormal(_t(loc), _t(scale)), jax_dist.TruncatedNormal(jnp.asarray(loc), jnp.asarray(scale))
    x = np.clip(rng.normal(size=(6, 3)), -0.99, 0.99).astype(np.float32)
    np.testing.assert_allclose(mine.log_prob(_t(x)).numpy(), np.asarray(theirs.log_prob(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(mine.rsample(_t(u)).numpy(), np.asarray(theirs.rsample(jax.random.PRNGKey(3))), **TOL)
    np.testing.assert_allclose(mine.entropy().numpy(), np.asarray(theirs.entropy()), **TOL)
    np.testing.assert_allclose(mine.mean.numpy(), np.asarray(theirs.mean), **TOL)
    np.testing.assert_array_equal(mine.mode.numpy(), np.asarray(theirs.mode))
    # the reparameterised draw carries the gradient to loc and scale
    loc_t = _t(loc).requires_grad_()
    TruncatedNormal(loc_t, _t(scale)).rsample(_t(u)).sum().backward()
    assert torch.isfinite(loc_t.grad).all() and float(loc_t.grad.abs().sum()) > 0


def _jax_apply(module, params, *args, **kwargs):
    return module.apply(params, *args, **kwargs)


@pytest.mark.parametrize("name", ["discrete_continues_rgb"])
def test_world_model_modules_match_jax(name):
    """Encoder (conv and MLP), decoder, reward and continue heads and the
    RSSM's methods on the same weights."""
    p = dv2_pair(name)
    wm_j, params = p["jax"]["wm"], _np_tree(p["jax"]["params"])["world_model"]
    wm = p["agent"].world_model
    rng = np.random.default_rng(1)
    obs = {"state": rng.normal(size=(2, 3, 5)).astype(np.float32),
           "rgb": (rng.integers(0, 256, (2, 3, 64, 64, 3)) / 255.0 - 0.5).astype(np.float32)}
    with torch.no_grad():
        emb = wm.encoder({k: _t(v) for k, v in obs.items()})
        emb_j = wm_j.encoder.apply(params["encoder"], {k: jnp.asarray(v) for k, v in obs.items()})
        np.testing.assert_allclose(emb.numpy(), np.asarray(emb_j), **TOL)
        latent = rng.normal(size=(2, 3, S * D + REC)).astype(np.float32)
        dec, dec_j = wm.observation_model(_t(latent)), wm_j.observation_model.apply(params["observation_model"], latent)
        for k in ("state", "rgb"):
            np.testing.assert_allclose(dec[k].numpy(), np.asarray(dec_j[k]), **TOL)
        for name_ in ("reward_model", "continue_model"):
            np.testing.assert_allclose(getattr(wm, name_)(_t(latent)).numpy(),
                                       np.asarray(getattr(wm_j, name_).apply(params[name_], latent)), **TOL)
        rssm, rssm_j, rp = wm.rssm, wm_j.rssm, params["rssm"]
        post = np.eye(D, dtype=np.float32)[rng.integers(0, D, (3, S))]
        rec = rng.normal(size=(3, REC)).astype(np.float32)
        act = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 3)]
        first = np.array([[1.0], [0.0], [0.0]], np.float32)
        noise = -np.log(-np.log(rng.uniform(1e-9, 1, (3, S, D)))).astype(np.float32)
        e = np.asarray(emb_j)[0]
        proj = rssm.representation_embed_proj(_t(e))
        proj_j = rssm_j.apply(rp, jnp.asarray(e), method=jax_agent.RSSM.representation_embed_proj)
        np.testing.assert_allclose(proj.numpy(), np.asarray(proj_j), **TOL)
        got = rssm.dynamic_posterior_from_proj(_t(post), _t(rec), _t(act), proj, _t(first), noise=_t(noise))
        want = rssm_j.apply(rp, jnp.asarray(post), jnp.asarray(rec), jnp.asarray(act), proj_j, jnp.asarray(first),
                            None, noise=jnp.asarray(noise), method=jax_agent.RSSM.dynamic_posterior_from_proj)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        got = rssm.imagination(_t(post.reshape(3, -1)), _t(rec), _t(act), noise=_t(noise))
        want = rssm_j.apply(rp, jnp.asarray(post.reshape(3, -1)), jnp.asarray(rec), jnp.asarray(act), None,
                            noise=jnp.asarray(noise), method=jax_agent.RSSM.imagination)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        logits, _ = rssm._transition(_t(rec), sample_state=False)
        logits_j, _ = rssm_j.apply(rp, jnp.asarray(rec), None, sample_state=False, method=jax_agent.RSSM._transition)
        np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **TOL)


@pytest.mark.parametrize("dist", ["discrete", "trunc_normal", "tanh_normal"])
def test_actor_heads_match_jax(dist):
    """The actor's samples from JAX's draws, its greedy actions, the log-probs
    and entropies of its distributions; discrete heads under MineDojo masks."""
    continuous = dist != "discrete"
    actions_dim = (2,) if continuous else (19, 3, 4)
    overrides = TINY + MLP_ONLY + ([f"distribution.type={dist}"] if continuous else [])
    cfg_j, cfg_t = jax_compose(overrides=overrides), port_compose(overrides=overrides)
    rt = JaxRuntime(devices=1, accelerator="cpu", precision="32-true")
    rt.launch()
    _, actor_j, _, params = jax_agent.build_agent(rt, actions_dim, continuous, cfg_j, _obs_space(("state",)))
    runtime = MeshRuntime(device="cpu", seed=0).launch()
    agent = port_agent.build_agent(runtime, actions_dim, continuous, cfg_t, _obs_space(("state",)))
    load_flax_params(agent, _np_tree(params))
    rng = np.random.default_rng(2)
    latent = rng.normal(size=(6, S * D + REC)).astype(np.float32)
    mask = None
    if not continuous:
        mask = {"mask_action_type": rng.uniform(size=(6, 19)) < 0.7, "mask_craft_smelt": rng.uniform(size=(6, 3)) < 0.6,
                "mask_equip_place": rng.uniform(size=(6, 4)) < 0.6, "mask_destroy": rng.uniform(size=(6, 4)) < 0.6}
        for m in mask.values():
            m[:, 0] = True
        mask["mask_action_type"][:3, 15:19] = True  # craft, equip, place and destroy get drawn
    key = jax.random.PRNGKey(5)
    acts_j, dists_j = actor_j.apply(params["actor"], jnp.asarray(latent), False, key,
                                    None if mask is None else {k: jnp.asarray(v) for k, v in mask.items()})
    noise = _t(actor_noise(key, actions_dim, continuous, dist, rows=6))
    tmask = None if mask is None else {k: torch.from_numpy(v) for k, v in mask.items()}
    with torch.no_grad():
        acts, dists = agent.actor(_t(latent), False, noise=noise, mask=tmask)
        greedy, _ = agent.actor(_t(latent), True, mask=tmask)
    greedy_j, _ = actor_j.apply(params["actor"], jnp.asarray(latent), True, None,
                                None if mask is None else {k: jnp.asarray(v) for k, v in mask.items()})
    for a, b, g, gj, d, dj in zip(acts, acts_j, greedy, greedy_j, dists, dists_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), **TOL)
        x = np.asarray(b)
        if continuous:
            np.testing.assert_allclose(d.log_prob(_t(x)).numpy(), np.asarray(dj.log_prob(jnp.asarray(x))), rtol=1e-4,
                                       atol=1e-4)
        else:
            np.testing.assert_allclose(d.probs.numpy(), np.asarray(dj.probs), **TOL)
        if dist != "tanh_normal":
            np.testing.assert_allclose(d.entropy().numpy(), np.asarray(dj.entropy()), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- train steps
def test_train_steps_match_jax(pair):
    run_and_compare(pair, jax_step_noise)


def test_trees_and_adam_states_both_ways(pair):
    """The port's parameters and Adam states written in JAX's layout read
    back to the same tensors, and the parameter tree is JAX's own."""
    agent, state = pair["agent"], pair["state"]
    tree = torch_to_flax(agent)
    jax_tree = _np_tree(pair["jax"]["params"])
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(jax_tree)
    back = flax_to_torch(tree, agent)
    for k, v in agent.state_dict().items():
        assert torch.equal(back[k], v), k
    for g in GROUPS:
        module = getattr(agent, g)
        saved = adam_state_to_tree(state.opt_states[g], module, g)
        assert jax.tree_util.tree_structure(saved["mu"]) == jax.tree_util.tree_structure(jax_tree[g])
        loaded = adam_state_from_tree(saved, module, g)
        for k in state.opt_states[g].mu:
            assert torch.equal(loaded.mu[k], state.opt_states[g].mu[k]) and torch.equal(loaded.nu[k], state.opt_states[g].nu[k])


def test_target_critic_is_a_copy_every_update_freq_steps():
    """``train_steps`` copies the critic into the target critic before the
    gradient steps 0, freq, 2 freq, ... (step 0 included), and only then."""
    p = dv2_pair("discrete_bptt")
    agent, state, cfg = p["agent"], p["state"], p["cfg"]
    cfg.algo.critic.per_rank_target_network_update_freq = 2
    rng = np.random.default_rng(4)
    batches = [{k: _t(v) for k, v in dv2_batch(rng, (4,), False, ("state",)).items()} for _ in range(5)]

    class _Feed:
        """``sequence_batches``' host path with the batches above."""

        def sample(self, batch_size, sequence_length, n_samples):
            return {k: np.stack([b[k].numpy() for b in batches[: int(n_samples)]]) for k in batches[0]}

    before = []
    inner = state.train_fn

    def recording(*args, **kwargs):
        before.append([t.detach().clone() for t in agent.target_critic.parameters()])
        return inner(*args, **kwargs)

    state.train_fn = recording
    critic0 = [t.detach().clone() for t in agent.critic.parameters()]
    assert not all(torch.equal(a, b) for a, b in zip(critic0, agent.target_critic.parameters()))
    train_steps(state, _Feed(), None, cfg, 5, torch.Generator().manual_seed(0))
    assert state.gradient_steps == 5 and "tau" not in cfg.algo.critic
    copies = [i for i in range(1, 5) if not all(torch.equal(a, b) for a, b in zip(before[i], before[i - 1]))]
    assert copies == [2, 4]
    assert all(torch.equal(a, b) for a, b in zip(before[0], critic0))


# ---------------------------------------------------------------- the env loop
def dv2_args(tmp_path, name, env="jax_gridworld", extra=()):
    return ["exp=dreamer_v2", f"env={env}", "algo.env_backend=jax", "fabric.accelerator=cpu", "metric.log_level=0",
            f"root_dir={tmp_path}", f"run_name={name}", *MLP_ONLY, *TINY[1:], *extra]


def test_replay_rows_match_jax_main(tmp_path, monkeypatch):
    """Warm-up only: every checkpoint's rows (the zero-action seed row, the
    rows written after each step, the reset rows with ``is_first``), write
    heads and fill flags, bit for bit against JAX's ``main``."""
    common = ["env=jax_gridworld", "algo.env_backend=jax", "fabric.accelerator=cpu", "metric.log_level=0",
              "env.capture_video=False", "buffer.memmap=False", "algo.run_test=False", f"env.num_envs={N_ENVS}",
              f"env.max_episode_steps={LIMIT}", "env.wrapper.size=5", "env.wrapper.view=3",
              f"algo.total_steps={STEPS * N_ENVS}", f"algo.learning_starts={10 * STEPS * N_ENVS}",
              f"checkpoint.every={EVERY * N_ENVS}", "checkpoint.save_last=True", "buffer.size=60", "seed=3",
              *MLP_ONLY, *TINY[1:]]
    env_j = GridWorldJax(max_episode_steps=128, **GRID)
    jax_actions = _draws(1, 4)

    def jax_vector_env(thunks, **kwargs):
        envs = JaxVectorEnv(env_j, len(thunks), seed=3, max_episode_steps=LIMIT)
        envs.action_space.sample = lambda: jax_actions.pop(0)
        return envs

    monkeypatch.setattr(gym.vector, "SyncVectorEnv", jax_vector_env)
    jax_run(["exp=dreamer_v2", f"root_dir={tmp_path}/jax", "run_name=rows", *common])

    def port_vector_env(cfg, runtime, **kwargs):
        return _FedVectorEnv(env_j, make_device_env("jax_gridworld", max_episode_steps=128, **GRID), N_ENVS,
                             max_episode_steps=LIMIT, device="cpu", actions=_draws(1, 4))

    monkeypatch.setattr(port_env, "make_train_envs", port_vector_env)
    out = run(["exp=dreamer_v2", f"root_dir={tmp_path}/port", "run_name=rows", *common])
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
    flags = {k: sum(float(np.asarray(got[f"sub{i}/{k}"]).sum()) for i in range(N_ENVS))
             for k in ("terminated", "truncated", "is_first")}
    assert flags["terminated"] > 0 and flags["truncated"] > 0 and flags["is_first"] > N_ENVS
    # before the rings wrap, every env's first row is the zero-action seed row
    first = _buffers(ckpt_dirs[1] / names[0], load_checkpoint)
    assert all(float(np.abs(first[f"sub{i}/actions"][0]).sum()) == 0.0 for i in range(N_ENVS))
    assert all(float(first[f"sub{i}/is_first"][0].sum()) == 1.0 for i in range(N_ENVS))


def test_cli_run_checkpoint_read_by_jax_and_resume(tmp_path, capsys):
    """Prioritized starts through the cache: a test reward, a checkpoint in
    JAX's layout (JAX's ``build_agent`` takes its trees; its world model on
    them embeds as the port's), and a resume for exactly one iteration."""
    extra = ["buffer.prioritized=True", "buffer.per_kernel=pallas", "algo.learning_starts=32", "algo.total_steps=64",
             "algo.per_rank_pretrain_steps=1", "algo.replay_ratio=0.5"]
    args = dv2_args(tmp_path, "cli", "jax_cartpole", extra)
    out = run(args)
    assert out["gradient_steps"] > 0 and out["iterations"] == 16 and out["test_reward"] is not None
    assert "Test - Reward:" in capsys.readouterr().out
    state_j = jax_load_checkpoint(out["checkpoint"])
    assert {"world_model", "actor", "critic", "target_critic", "opt_states", "ratio", "rb", "replay_priority"} <= set(state_j)
    cfg_j = jax_compose(overrides=args)
    rt = JaxRuntime(devices=1, accelerator="cpu", precision="32-true")
    rt.launch()
    obs_space = gym.spaces.Dict({"state": gym.spaces.Box(-np.inf, np.inf, (4,), np.float32)})
    wm_j, actor_j, _, params_j = jax_agent.build_agent(rt, (2,), False, cfg_j, obs_space, state_j["world_model"],
                                                       state_j["actor"], state_j["critic"], state_j["target_critic"])
    agent = port_agent.build_agent(MeshRuntime(device="cpu").launch(), (2,), False, port_compose(overrides=args), obs_space)
    load_flax_params(agent, {k: load_checkpoint(out["checkpoint"])[k] for k in ("world_model", "actor", "critic",
                                                                               "target_critic")})
    obs = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)
    with torch.no_grad():
        emb = agent.world_model.encoder({"state": _t(obs)})
    emb_j = wm_j.encoder.apply(params_j["world_model"]["encoder"], {"state": jnp.asarray(obs)})
    np.testing.assert_allclose(emb.numpy(), np.asarray(emb_j), **TOL)

    resumed = run(dv2_args(tmp_path, "cli_resumed", "jax_cartpole",
                           [*extra, "algo.total_steps=68", f"checkpoint.resume_from={out['checkpoint']}"]))
    assert resumed["iterations"] == 1 and resumed["policy_step"] == 68 and os.path.exists(resumed["checkpoint"])
    assert load_checkpoint(resumed["checkpoint"])["iter_num"] == 17


def test_episode_buffer_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="A2"):
        run(dv2_args(tmp_path, "episode", extra=["buffer.type=episode", "algo.total_steps=8"]))


def test_chip_smoke_dv2_cli_phase_runs_on_cpu():
    """``chip_smoke.py``'s ``dv2_cli`` phase at tiny widths: both runs, the
    loop rates, the resume, the checkpoint's player against a second CPU
    copy (identical here) and one gradient step against a CPU replica."""
    import chip_smoke

    res = chip_smoke.run_dv2_cli("cpu", overrides=TINY[1:], learning_starts=32, train_iters=4, profile=False)
    assert set(res) == set(chip_smoke.DV2_CLI_RUNS)
    for row in res.values():
        assert row["gradient_steps"] > 0 and row["policy_steps_per_s_collect"] > 0 and row["test_reward"] is not None
        assert row["launches"] == {}  # plain versions on the CPU
        assert row["draw_vs_plain"]["bytes_equal"] and "gather_windows" in row["draw_vs_plain"]["kernels"]
    assert {"sum_tree_sample", "sum_tree_write"} <= set(res["cartpole"]["draw_vs_plain"]["kernels"])
    first = res["gridworld"]
    assert first["resumed"]["iterations"] == 1
    assert first["player_vs_plain"]["max_abs_state_err"] == 0.0
    assert first["step_vs_cpu"]["max_abs_param_err"] == 0.0
