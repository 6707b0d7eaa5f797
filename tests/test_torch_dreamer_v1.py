"""The port's DreamerV1 (``algos/dreamer_v1``) against the JAX package's, on
the CPU at small widths (dense 16, one layer, H = 16, stochastic 4,
T = 8, B = 4, horizon 3).

- the hand-written flax ``GRUCell`` against ``flax.linen.GRUCell``; the
  Gaussian RSSM's methods;
- two train steps against JAX's ``make_train_fn`` on converted state, JAX's
  normals, uniforms and Gumbel noise rebuilt from its key: continuous
  actions (Pendulum's one, the truncated normal) with JAX's ``dyn_bptt``
  on, and discrete actions (GridWorld's four) with it off, with
  ``use_continues`` and an image key;
- the parameter and Adam trees both ways (no target critic);
- the exploration amount's half-life against ``PlayerDV1.get_expl_amount``
  and the loop passing the policy step;
- the replay rows of the port's ``main`` against JAX's on ``jax_gridworld``,
  bit for bit, with no ``is_first`` column;
- a CLI run whose checkpoint JAX reads, and a resume for one iteration; a
  CPU rehearsal of ``chip_smoke.py``'s ``dv1_cli`` phase.

Tolerances as ``test_torch_dreamer_v2.py``'s.
"""

import os
from types import SimpleNamespace

import flax.linen as fnn
import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v1 import agent as jax_agent
from sheeprl_tpu.algos.dreamer_v1.dreamer_v1 import make_train_fn as jax_make_train_fn
from sheeprl_tpu.cli import run as jax_run
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.envs.jax import JaxVectorEnv
from sheeprl_tpu.envs.jax.gridworld import GridWorldJax
from sheeprl_tpu.optim import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel.mesh import MeshRuntime as JaxRuntime
from sheeprl_tpu.utils.callback import load_checkpoint as jax_load_checkpoint
from sheeprl_tpu_torch.algos.dreamer_v1 import agent as port_agent
from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import make_train_state
from sheeprl_tpu_torch.cli import run
from sheeprl_tpu_torch.config import compose as port_compose
from sheeprl_tpu_torch.envs.device import make_device_env
from sheeprl_tpu_torch.parallel.mesh import MeshRuntime
from sheeprl_tpu_torch.utils import env as port_env
from sheeprl_tpu_torch.utils.ckpt_format import load_checkpoint
from sheeprl_tpu_torch.utils.convert import adam_state_from_tree, adam_state_to_tree, flax_to_torch, load_flax_params, torch_to_flax

from test_torch_dreamer_v2 import STEP_RTOL, TOL, _np_tree, _obs_space, _t, actor_noise, compare_params_and_opt
from test_torch_dv3_loop import EVERY, GRID, LIMIT, MLP_ONLY, N_ENVS, STEPS, _buffers, _draws, _FedVectorEnv

T, B, H = 8, 4, 3
S, REC = 4, 16
GROUPS = ("world_model", "actor", "critic")
TINY = [
    "exp=dreamer_v1", "algo.dense_units=16", "algo.mlp_layers=1",
    f"algo.world_model.recurrent_model.recurrent_state_size={REC}",
    "algo.world_model.representation_model.hidden_size=16", "algo.world_model.transition_model.hidden_size=16",
    f"algo.world_model.stochastic_size={S}", "algo.world_model.encoder.cnn_channels_multiplier=4",
    f"algo.per_rank_batch_size={B}", f"algo.per_rank_sequence_length={T}", f"algo.horizon={H}",
]
CASES = {
    "continuous_bptt": ((1,), True, ["algo.world_model.dyn_bptt=True", *MLP_ONLY], ("state",)),
    "discrete_continues_rgb": (
        (4,), False,
        ["algo.world_model.dyn_bptt=False", "algo.world_model.use_continues=True", "algo.mlp_keys.encoder=[state]",
         "algo.cnn_keys.encoder=[rgb]"],
        ("state", "rgb"),
    ),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dv1_pair(name):
    """The tiny DreamerV1 of ``CASES[name]`` in both packages on the same
    weights and optimizer states (the reward and critic heads with larger
    random weights), with each package's train step."""
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
    txs = [jax_build_optimizer(cfg_j.algo[g].optimizer, cfg_j.algo[g].clip_gradients, "32-true") for g in GROUPS]
    cpu = jax.devices("cpu")[0]
    jparams = jax.device_put(params, cpu)
    opt = jax.device_put({g: tx.init(jparams[g]) for g, tx in zip(GROUPS, txs)}, cpu)
    train_j = jax_make_train_fn(rt, wm, actor, critic, txs, cfg_j, continuous, actions_dim)

    cfg_t = port_compose(overrides=overrides)
    agent = port_agent.build_agent(MeshRuntime(device="cpu", seed=0).launch(), actions_dim, continuous, cfg_t, obs_space)
    load_flax_params(agent, params)
    state = make_train_state(MeshRuntime(device="cpu").launch(), agent, cfg_t, continuous, actions_dim)
    return {"jax": {"wm": wm, "params": jparams, "opt": opt, "train": train_j, "device": cpu},
            "agent": agent, "state": state, "cfg": cfg_t, "actions_dim": actions_dim, "continuous": continuous,
            "keys": keys}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    return dv1_pair(request.param)


def dv1_batch(rng, actions_dim, continuous, keys):
    if continuous:
        actions = np.tanh(rng.normal(size=(T, B, sum(actions_dim)))).astype(np.float32)
    else:
        actions = np.concatenate([np.eye(d, dtype=np.float32)[rng.integers(0, d, (T, B))] for d in actions_dim], -1)
    data = {"state": rng.normal(size=(T, B, 5)).astype(np.float32), "actions": actions,
            "rewards": rng.normal(size=(T, B, 1)).astype(np.float32),
            "terminated": (rng.uniform(size=(T, B, 1)) < 0.1).astype(np.float32),
            "truncated": np.zeros((T, B, 1), np.float32)}
    if "rgb" in keys:
        data["rgb"] = rng.integers(0, 256, size=(T, B, 64, 64, 3)).astype(np.uint8)
    return data


def jax_step_noise(key, actions_dim, continuous):
    """JAX's ``train`` draws from ``key``: ``split(key)`` -> the dynamic
    loop's normals; ``split(k_img)`` -> imagination's normals and
    ``split(k_img_a, H)`` actor keys."""
    k_dyn, k_img = jax.random.split(key)
    dyn = jax.random.normal(k_dyn, (T, B, S), jnp.float32)
    k_img_n, k_img_a = jax.random.split(k_img)
    img = jax.random.normal(k_img_n, (H, T * B, S), jnp.float32)
    act = [actor_noise(k, actions_dim, continuous) for k in jax.random.split(k_img_a, H)]
    return {"dyn": _t(dyn), "img": _t(img), "act": _t(np.stack(act))}


# ---------------------------------------------------------------- modules
def test_gru_cell_matches_flax():
    """flax's ``GRUCell`` (biases on the input denses and ``hn`` only) and
    the port's, on flax's initial weights and on random ones."""
    rng = np.random.default_rng(0)
    x, h = rng.normal(size=(5, 7)).astype(np.float32), rng.normal(size=(5, 6)).astype(np.float32)
    cell_j = fnn.GRUCell(features=6)
    params = _np_tree(cell_j.init(jax.random.PRNGKey(0), jnp.asarray(h), jnp.asarray(x)))["params"]
    for name in ("ir", "iz", "in", "hn"):
        params[name]["bias"] = rng.normal(size=(6,)).astype(np.float32)
    cell = port_agent.GRUCell(7, 6)
    with torch.no_grad():
        cell.input_kernel.copy_(_t(np.concatenate([params[f"i{g}"]["kernel"] for g in "rzn"], -1)))
        cell.input_bias.copy_(_t(np.concatenate([params[f"i{g}"]["bias"] for g in "rzn"], -1)))
        cell.hidden_kernel.copy_(_t(np.concatenate([params[f"h{g}"]["kernel"] for g in "rzn"], -1)))
        cell.hidden_bias.copy_(_t(params["hn"]["bias"]))
        got = cell(_t(h), _t(x))
    assert "bias" not in params["hr"] and "bias" not in params["hz"]
    want, _ = cell_j.apply({"params": params}, jnp.asarray(h), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rssm_matches_jax():
    """The Gaussian RSSM's embed projection, dynamic step, imagination step
    and the prior's mean and deviation, on converted weights."""
    p = dv1_pair("continuous_bptt")
    wm, wm_j, rp = p["agent"].world_model, p["jax"]["wm"], _np_tree(p["jax"]["params"])["world_model"]["rssm"]
    rssm, rssm_j = wm.rssm, wm_j.rssm
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(3, 16)).astype(np.float32)
    post, rec = rng.normal(size=(3, S)).astype(np.float32), rng.normal(size=(3, REC)).astype(np.float32)
    act, noise = np.tanh(rng.normal(size=(3, 1))).astype(np.float32), rng.normal(size=(3, S)).astype(np.float32)
    with torch.no_grad():
        proj = rssm.representation_embed_proj(_t(emb))
        proj_j = rssm_j.apply(rp, jnp.asarray(emb), method=jax_agent.RSSM.representation_embed_proj)
        np.testing.assert_allclose(proj.numpy(), np.asarray(proj_j), **TOL)
        r, z, (m, s) = rssm.dynamic_posterior_from_proj(_t(post), _t(rec), _t(act), proj, noise=_t(noise))
        r_j, z_j, (m_j, s_j) = rssm_j.apply(rp, jnp.asarray(post), jnp.asarray(rec), jnp.asarray(act), proj_j, None,
                                            noise=jnp.asarray(noise), method=jax_agent.RSSM.dynamic_posterior_from_proj)
        for a, b in ((r, r_j), (z, z_j), (m, m_j), (s, s_j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        got = rssm.imagination(_t(post), _t(rec), _t(act), noise=_t(noise))
        want = rssm_j.apply(rp, jnp.asarray(post), jnp.asarray(rec), jnp.asarray(act), None, noise=jnp.asarray(noise),
                            method=jax_agent.RSSM.imagination)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        (pm, ps), _ = rssm._transition(_t(rec), sample_state=False)
        (pm_j, ps_j), _ = rssm_j.apply(rp, jnp.asarray(rec), None, sample_state=False, method=jax_agent.RSSM._transition)
        np.testing.assert_allclose(pm.numpy(), np.asarray(pm_j), **TOL)
        np.testing.assert_allclose(ps.numpy(), np.asarray(ps_j), **TOL)


# ---------------------------------------------------------------- train steps
def test_train_steps_match_jax(pair):
    j, state = pair["jax"], pair["state"]
    rng = np.random.default_rng(0)
    for step in range(2):
        data = dv1_batch(rng, pair["actions_dim"], pair["continuous"], pair["keys"])
        key = jax.random.PRNGKey(100 + step)
        j["params"], j["opt"], mj = j["train"](j["params"], j["opt"], jax.device_put(data, j["device"]),
                                               jax.device_put(key, j["device"]))
        noise = jax_step_noise(key, pair["actions_dim"], pair["continuous"])
        state.opt_states, state.moments, mt = state.train_fn(state.opt_states, state.moments,
                                                             {k: _t(v) for k, v in data.items()}, noise=noise)
        assert set(mt) == set(mj) and len(mt) == 13
        for k in mj:
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=STEP_RTOL, atol=1e-7, err_msg=f"step {step} {k}")
        compare_params_and_opt(pair, step, j["params"], j["opt"], state)


def test_trees_and_adam_states_both_ways(pair):
    agent, state = pair["agent"], pair["state"]
    tree = torch_to_flax(agent)
    jax_tree = _np_tree(pair["jax"]["params"])
    assert set(tree) == {"world_model", "actor", "critic"}
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(jax_tree)
    back = flax_to_torch(tree, agent)
    for k, v in agent.state_dict().items():
        assert torch.equal(back[k], v), k
    for g in GROUPS:
        module = getattr(agent, g)
        loaded = adam_state_from_tree(adam_state_to_tree(state.opt_states[g], module, g), module, g)
        for k in state.opt_states[g].mu:
            assert torch.equal(loaded.mu[k], state.opt_states[g].mu[k]) and torch.equal(loaded.nu[k], state.opt_states[g].nu[k])
    assert agent.target_pairs() == []


def test_exploration_amount_matches_jax():
    """The half-life schedule (and its floor) at a range of policy steps,
    and greedy acting with no noise."""
    cfg = port_compose(overrides=TINY + MLP_ONLY)
    modules = port_agent.build_agent(MeshRuntime(device="cpu").launch(), (1,), True, cfg, _obs_space(("state",))).player()
    for amount, decay, floor in ((0.3, 0.0, 0.0), (0.3, 1000.0, 0.0), (0.5, 200.0, 0.1), (0.0, 10.0, 0.0)):
        ref = SimpleNamespace(expl_amount=amount, expl_decay=decay, expl_min=floor)
        player = port_agent.PlayerDV1(modules, (1,), 2, S, REC, amount, decay, floor)
        for step in (0, 1, 100, 999, 5000, 123456):
            assert player.get_expl_amount(step) == pytest.approx(jax_agent.PlayerDV1.get_expl_amount(ref, step), rel=1e-12)
        assert player._expl_amount(True, 100) == 0.0


# ---------------------------------------------------------------- the env loop
def dv1_args(tmp_path, name, env="jax_pendulum", extra=()):
    env_id = [f"env.id={env}"] if env == "jax_pendulum" else []
    return ["exp=dreamer_v1", f"env={env}", *env_id, "algo.env_backend=jax", "fabric.accelerator=cpu",
            "metric.log_level=0", f"root_dir={tmp_path}", f"run_name={name}", *MLP_ONLY, *TINY[1:], *extra]


def test_replay_rows_match_jax_main(tmp_path, monkeypatch):
    """Warm-up only: every checkpoint's rows, write heads and fill flags,
    bit for bit against JAX's ``main``; no ``is_first`` column."""
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
    jax_run(["exp=dreamer_v1", f"root_dir={tmp_path}/jax", "run_name=rows", *common])

    def port_vector_env(cfg, runtime, **kwargs):
        return _FedVectorEnv(env_j, make_device_env("jax_gridworld", max_episode_steps=128, **GRID), N_ENVS,
                             max_episode_steps=LIMIT, device="cpu", actions=_draws(1, 4))

    monkeypatch.setattr(port_env, "make_train_envs", port_vector_env)
    out = run(["exp=dreamer_v1", f"root_dir={tmp_path}/port", "run_name=rows", *common])
    assert out["gradient_steps"] == 0

    ckpt_dirs = [tmp_path / pkg / "rows" / "version_0" / "checkpoint" for pkg in ("jax", "port")]
    names = sorted(os.listdir(ckpt_dirs[0]))
    assert names == sorted(os.listdir(ckpt_dirs[1])) and len(names) == STEPS // EVERY
    for name in names:
        want = _buffers(ckpt_dirs[0] / name, jax_load_checkpoint)
        got = _buffers(ckpt_dirs[1] / name, load_checkpoint)
        assert set(got) == set(want), name
        assert not any(k.endswith("/is_first") for k in got)
        for k in want:
            w, g = np.asarray(want[k]), np.asarray(got[k])
            assert g.dtype == w.dtype and g.shape == w.shape, (name, k)
            np.testing.assert_array_equal(g, w, err_msg=f"{name}: {k}")
    assert sum(float(np.asarray(got[f"sub{i}/terminated"]).sum()) for i in range(N_ENVS)) > 0


def test_cli_run_checkpoint_read_by_jax_and_resume(tmp_path, capsys, monkeypatch):
    """Pendulum through the device cache: a test reward, a checkpoint in
    JAX's layout (JAX's ``build_agent`` takes its trees; its encoder on them
    embeds as the port's), the exploration amount at every acting policy
    step, and a resume for exactly one iteration."""
    steps = []
    inner = port_agent.PlayerDV1.get_expl_amount

    def recording(self, step):
        steps.append(step)
        return inner(self, step)

    monkeypatch.setattr(port_agent.PlayerDV1, "get_expl_amount", recording)
    extra = ["buffer.device_cache=True", "buffer.per_kernel=pallas", "algo.learning_starts=32", "algo.total_steps=64",
             "algo.replay_ratio=0.5", "env.max_episode_steps=50", "env.num_envs=1"]
    args = dv1_args(tmp_path, "cli", extra=extra)
    out = run(args)
    assert out["gradient_steps"] > 0 and out["iterations"] == 64 and out["test_reward"] is not None
    assert "Test - Reward:" in capsys.readouterr().out
    assert steps == list(range(out["learning_starts"] + 1, 65))  # every acting step, not the greedy test's
    state_j = jax_load_checkpoint(out["checkpoint"])
    assert {"world_model", "actor", "critic", "opt_states", "ratio", "rb"} <= set(state_j)
    assert "target_critic" not in state_j
    rt = JaxRuntime(devices=1, accelerator="cpu", precision="32-true")
    rt.launch()
    obs_space = gym.spaces.Dict({"state": gym.spaces.Box(-np.inf, np.inf, (3,), np.float32)})
    wm_j, _, _, params_j = jax_agent.build_agent(rt, (1,), True, jax_compose(overrides=args), obs_space,
                                                 state_j["world_model"], state_j["actor"], state_j["critic"])
    agent = port_agent.build_agent(MeshRuntime(device="cpu").launch(), (1,), True, port_compose(overrides=args), obs_space)
    load_flax_params(agent, {k: load_checkpoint(out["checkpoint"])[k] for k in ("world_model", "actor", "critic")})
    obs = np.random.default_rng(0).normal(size=(3, 3)).astype(np.float32)
    with torch.no_grad():
        emb = agent.world_model.encoder({"state": _t(obs)})
    np.testing.assert_allclose(emb.numpy(), np.asarray(wm_j.encoder.apply(params_j["world_model"]["encoder"],
                                                                          {"state": jnp.asarray(obs)})), **TOL)

    resumed = run(dv1_args(tmp_path, "cli_resumed", extra=[*extra, "algo.total_steps=65",
                                                           f"checkpoint.resume_from={out['checkpoint']}"]))
    assert resumed["iterations"] == 1 and resumed["policy_step"] == 65 and os.path.exists(resumed["checkpoint"])
    assert load_checkpoint(resumed["checkpoint"])["iter_num"] == 65


def test_chip_smoke_dv1_cli_phase_runs_on_cpu():
    """``chip_smoke.py``'s ``dv1_cli`` phase at tiny widths: the run, its
    rates, the resume, the player against a second CPU copy and one
    gradient step against a CPU replica."""
    import chip_smoke

    res = chip_smoke.run_dv1_cli("cpu", overrides=TINY[1:], learning_starts=32, train_iters=4, profile=False)
    assert set(res) == set(chip_smoke.DV1_CLI_RUNS)
    row = res["pendulum"]
    assert row["gradient_steps"] > 0 and row["policy_steps_per_s_collect"] > 0 and row["test_reward"] is not None
    assert row["launches"] == {} and row["draw_vs_plain"]["bytes_equal"]
    assert row["resumed"]["iterations"] == 1
    assert row["player_vs_plain"]["max_abs_state_err"] == 0.0
    assert row["step_vs_cpu"]["max_abs_param_err"] == 0.0
