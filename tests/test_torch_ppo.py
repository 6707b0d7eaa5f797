"""The port's PPO (``sheeprl_tpu_torch/algos/ppo/``), its fused collect, its
checkpoints and its CLI against the JAX package's, on the CPU.

A small PPO (dense 16, T = 8-16, 4 envs) built by JAX's ``build_agent`` is
carried into the port by ``utils/convert.py``.  With JAX's own draws fed to
the port (its Gumbel or normal policy noise, its reset draws, its epoch
permutations), the comparisons and their tolerances, f32 throughout:

- the agent's forward 1e-5; ``sample_actions`` identical actions, log-probs
  and values 1e-5;
- the losses, ``gae`` and ``vtrace`` 1e-6;
- one ``make_update_fn`` call (3 epochs) 1e-5 on parameters and metrics,
  discrete and continuous actions, with ``anneal_lr`` (two calls) and with
  V-trace;
- a fused rollout of T steps against JAX's ``FusedOnPolicyCollector
  ._rollout_fn``: records 1e-5, dones identical;
- a checkpoint written by the port passes JAX's ``validate_checkpoint`` and
  JAX's ``build_agent`` takes its ``"agent"`` and gives the port's values
  (1e-5); a resumed run ends on the same bytes as one not interrupted;
- no string of the port's config tree names a ``sheeprl_tpu.`` module.
"""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.ppo import agent as jax_agent
from sheeprl_tpu.algos.ppo import loss as jax_loss
from sheeprl_tpu.algos.ppo.ppo import build_ppo_optimizer as jax_build_ppo_optimizer
from sheeprl_tpu.algos.ppo.ppo import make_update_fn as jax_make_update_fn
from sheeprl_tpu.algos.ppo.vtrace import vtrace as jax_vtrace
from sheeprl_tpu.algos.ppo.vtrace import vtrace_pg_advantage as jax_vtrace_pg_advantage
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.envs.jax import JaxVectorEnv, make_jax_env
from sheeprl_tpu.envs.jax import core as jax_core
from sheeprl_tpu.envs.jax.collect import FusedOnPolicyCollector as JaxCollector
from sheeprl_tpu.parallel.mesh import MeshRuntime as JaxRuntime
from sheeprl_tpu.utils import utils as jax_utils
from sheeprl_tpu_torch.algos.ppo import loss as port_loss
from sheeprl_tpu_torch.algos.ppo.agent import PPOPlayer, build_agent, evaluate_actions, sample_actions
from sheeprl_tpu_torch.algos.ppo.utils import prepare_obs
from sheeprl_tpu_torch.algos.ppo.ppo import build_ppo_optimizer, make_update_fn
from sheeprl_tpu_torch.algos.ppo.vtrace import vtrace, vtrace_pg_advantage
from sheeprl_tpu_torch.config import compose as port_compose
from sheeprl_tpu_torch.envs.device import DeviceVectorEnv, make_device_env
from sheeprl_tpu_torch.envs.device.collect import FusedOnPolicyCollector
from sheeprl_tpu_torch.parallel.mesh import MeshRuntime
from sheeprl_tpu_torch.utils import utils as pu
from sheeprl_tpu_torch.utils.convert import torch_to_flax
from sheeprl_tpu_torch.utils.utils import polynomial_decay, trainable_params

from test_torch_envs import jax_reset_noise

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
LOSS_TOL = 1e-6
N, T = 4, 8
BASE = ["algo.env_backend=jax", "fabric.accelerator=cpu", "metric.log_level=0", "algo.dense_units=16",
        "algo.encoder.mlp_features_dim=16", "algo.update_epochs=3", "env.num_envs=4"]
SPEC = {"jax_cartpole": ((2,), False, 4), "jax_pendulum": ((1,), True, 3)}


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


def ppo_pair(env_id="jax_cartpole", overrides=(), exp="ppo"):
    """The same small agent in both packages (the JAX parameters carried
    over), with both configs."""
    ovr = [f"exp={exp}", f"env={env_id}", *BASE, *overrides]
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


def random_rollout(rng, actions_dim, cont, obs_dim, t=T, n=N):
    if cont:
        actions = rng.normal(size=(t, n, sum(actions_dim)))
    else:
        actions = np.concatenate([np.eye(d)[rng.integers(0, d, size=(t, n))] for d in actions_dim], -1)
    data = {
        "state": rng.normal(size=(t, n, obs_dim)),
        "actions": actions,
        "logprobs": rng.normal(size=(t, n, 1)) * 0.1 - 0.7,
        "values": rng.normal(size=(t, n, 1)),
        "rewards": rng.normal(size=(t, n, 1)),
        "dones": (rng.random((t, n, 1)) < 0.15).astype(np.float64),
    }
    data = {k: v.astype(np.float32) for k, v in data.items()}
    return data, {"state": rng.normal(size=(n, obs_dim)).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("env_id", sorted(SPEC))
def test_agent_forward_and_sampling_match_jax(env_id):
    p = ppo_pair(env_id)
    obs = {"state": np.random.default_rng(0).normal(size=(6, SPEC[env_id][2])).astype(np.float32)}
    outs_j, values_j = p["module"].apply(p["params"], obs)
    outs_p, values_p = p["agent"](_t(obs))
    close(values_p.detach(), values_j)
    for a, b in zip(outs_p, outs_j):
        close(a.detach(), b)
    key = jax.random.PRNGKey(5)
    flat_j, real_j, logp_j, _ = jax_agent.sample_actions(p["module"], p["params"], obs, key)
    if p["cont"]:
        noise = [torch.from_numpy(np.array(jax.random.normal(key, (6, 1), jnp.float32)))]
    else:
        noise = [torch.from_numpy(np.array(jax.random.gumbel(k, (6, d), jnp.float32)))
                 for k, d in zip(jax.random.split(key, len(p["actions_dim"])), p["actions_dim"])]
    flat_p, real_p, logp_p, _ = sample_actions(p["agent"], _t(obs), noise)
    if p["cont"]:
        close(flat_p.detach(), flat_j)
    else:
        np.testing.assert_array_equal(real_p.numpy(), np.asarray(real_j))
        np.testing.assert_array_equal(flat_p.numpy(), np.asarray(flat_j))
    close(logp_p.detach(), logp_j)
    lp_j, ent_j, _ = jax_agent.evaluate_actions(p["module"], p["params"], obs, flat_j)
    lp_p, ent_p, _ = evaluate_actions(p["agent"], _t(obs), torch.from_numpy(np.array(flat_j)))
    close(lp_p.detach(), lp_j)
    close(ent_p.detach(), ent_j)
    greedy_j = jax_agent.sample_actions(p["module"], p["params"], obs, key, greedy=True)[0]
    close(sample_actions(p["agent"], _t(obs), greedy=True)[0].detach(), greedy_j)
    player = PPOPlayer(p["agent"], lambda o: prepare_obs(o, num_envs=6))
    close(player.get_values(obs), values_j)
    close(player.get_actions(obs, greedy=True)[0], greedy_j)


@pytest.mark.parametrize("clip_vloss", [False, True])
def test_losses_gae_and_vtrace_match_jax(clip_vloss):
    rng = np.random.default_rng(1)
    a, b, c, d = (rng.normal(size=(32, 1)).astype(np.float32) for _ in range(4))
    w = (rng.random((32, 1)) > 0.3).astype(np.float32)
    for weights in (None, w):
        wt = None if weights is None else torch.from_numpy(weights)
        for red in ("mean", "sum", "none"):
            close(port_loss.policy_loss(*map(torch.from_numpy, (a, b, c)), 0.2, red, wt),
                  jax_loss.policy_loss(a, b, c, 0.2, red, weights), LOSS_TOL)
            close(port_loss.entropy_loss(torch.from_numpy(a), red, wt), jax_loss.entropy_loss(a, red, weights), LOSS_TOL)
        close(port_loss.value_loss(*map(torch.from_numpy, (a, b, c)), 0.2, clip_vloss, "mean", wt),
              jax_loss.value_loss(a, b, c, 0.2, clip_vloss, "mean", weights), LOSS_TOL)
    data, _ = random_rollout(rng, (2,), False, 4, t=12, n=3)
    nv = rng.normal(size=(3, 1)).astype(np.float32)
    args = (data["rewards"], data["values"], data["dones"], nv)
    ret_p, adv_p = pu.gae(*map(torch.from_numpy, args), 0.99, 0.95)
    ret_j, adv_j = jax_utils.gae(*args, 0.99, 0.95)
    close(ret_p, ret_j, LOSS_TOL)
    close(adv_p, adv_j, LOSS_TOL)
    log_rhos = (rng.normal(size=(12, 3, 1)) * 0.3).astype(np.float32)
    vs_p, vadv_p = vtrace(*map(torch.from_numpy, args), torch.from_numpy(log_rhos), 0.99, 0.95, 1.0, 0.9)
    vs_j, vadv_j = jax_vtrace(*args, log_rhos, 0.99, 0.95, 1.0, 0.9)
    close(vs_p, vs_j, LOSS_TOL)
    close(vadv_p, vadv_j, LOSS_TOL)
    close(vtrace_pg_advantage(*map(torch.from_numpy, args), vs_p, torch.from_numpy(log_rhos), 0.99, 0.9),
          jax_vtrace_pg_advantage(*args, np.asarray(vs_j), log_rhos, 0.99, 0.9), LOSS_TOL)
    close(pu.normalize_tensor(torch.from_numpy(a)), jax_utils.normalize_tensor(a), LOSS_TOL)
    assert pu.polynomial_decay(3, initial=1.0, final=0.0, max_decay_steps=4) == jax_utils.polynomial_decay(
        3, initial=1.0, final=0.0, max_decay_steps=4)


def jax_epoch_perms(key, epochs, n_total, n_used):
    perms = []
    for k in jax.random.split(key, epochs):
        perm = np.asarray(jax.random.permutation(k, n_total))
        perms.append(np.tile(perm, -(-n_used // n_total))[:n_used])
    return torch.from_numpy(np.stack(perms).astype(np.int64))


UPDATE_CASES = {
    "discrete": ("jax_cartpole", ["algo.per_rank_batch_size=12", "algo.normalize_advantages=True",
                                  "algo.clip_vloss=True", "algo.ent_coef=0.01"]),
    "continuous_anneal_lr": ("jax_pendulum", ["algo.per_rank_batch_size=8", "algo.anneal_lr=True", "algo.max_grad_norm=0.5"]),
    "vtrace": ("jax_cartpole", ["algo.per_rank_batch_size=8", "+algo.vtrace.enabled=True", "+algo.vtrace.c_clip=0.9"]),
}


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_update_matches_jax(case):
    """One ``make_update_fn`` call (two with ``anneal_lr``) from the same
    parameters and rollout, JAX's epoch permutations fed to the port."""
    env_id, ovr = UPDATE_CASES[case]
    p = ppo_pair(env_id, ovr)
    cfg_j, cfg_p = p["cfg_j"], p["cfg_p"]
    data, next_obs = random_rollout(np.random.default_rng(2), p["actions_dim"], p["cont"], SPEC[env_id][2])
    tx_j = jax_build_ppo_optimizer(cfg_j.algo.optimizer, cfg_j.algo.max_grad_norm, "32-true")
    update_j = jax_make_update_fn(p["rt"], p["module"], tx_j, cfg_j, ["state"])
    params_j = jax.device_put(p["params"])
    opt_j = tx_j.init(params_j)
    tx_p = build_ppo_optimizer(cfg_p.algo.optimizer, cfg_p.algo.max_grad_norm, "32-true")
    opt_p = tx_p.init(trainable_params(p["agent"]))
    update_p = make_update_fn(p["runtime"], p["agent"], tx_p, cfg_p, ["state"])
    mb = int(cfg_p.algo.per_rank_batch_size)
    n_total = T * N
    n_used = -(-n_total // mb) * mb
    lr0 = float(cfg_p.algo.optimizer.learning_rate)
    calls = 2 if cfg_p.algo.anneal_lr else 1
    for i in range(calls):
        lr = polynomial_decay(i, initial=lr0, final=0.0, max_decay_steps=calls) if i else lr0
        key = jax.random.PRNGKey(10 + i)
        params_j, opt_j, m_j = update_j(
            params_j, opt_j, jax.device_put(data), jax.device_put(next_obs), key,
            jnp.float32(cfg_j.algo.clip_coef), jnp.float32(cfg_j.algo.ent_coef), jnp.float32(lr),
        )
        m_p = update_p(opt_p, _t(data), _t(next_obs), clip_coef=float(cfg_p.algo.clip_coef),
                       ent_coef=float(cfg_p.algo.ent_coef), lr=lr,
                       perms=jax_epoch_perms(key, int(cfg_p.algo.update_epochs), n_total, n_used))
        close_tree(torch_to_flax(p["agent"]), _np_tree(params_j))
        for k, v in m_j.items():
            close(m_p[k].detach(), v)
    assert opt_p.count == calls * int(cfg_p.algo.update_epochs) * (n_used // mb)


def jax_rollout_noise(p, key, carry0, base, steps):
    """The draws of JAX's fused rollout from ``key``: each step's policy
    noise and each env's reset draws."""
    env_j = make_jax_env(p["env_id"])
    keys = jax.random.split(key, steps)
    if p["cont"]:
        policy = [np.stack([np.array(jax.random.normal(k, (N, 1), jnp.float32)) for k in keys])]
    else:
        policy = [np.stack([np.array(jax.random.gumbel(jax.random.split(k, 1)[0], (N, 2), jnp.float32)) for k in keys])]
    idx = jnp.arange(N)
    resets = []
    for t in range(steps):
        gstep = carry0["gstep"] + t
        resets.append(jax_reset_noise(env_j, jax.vmap(lambda i: jax_core.step_keys(base, gstep, i)[1])(idx)))
    reset = {k: torch.stack([r[k] for r in resets]) for k in resets[0]}
    return {"policy": [torch.from_numpy(x) for x in policy], "reset": reset}


@pytest.mark.parametrize("env_id", sorted(SPEC))
def test_fused_rollout_matches_jax(env_id):
    """T = 16 steps with a 12-step time limit (truncation bootstraps), the
    JAX draws fed to the port; Pendulum also clips its rewards."""
    steps, limit = 16, 12
    ovr = [f"algo.rollout_steps={steps}", f"env.clip_rewards={env_id == 'jax_pendulum'}"]
    p = ppo_pair(env_id, ovr)
    envs_j = JaxVectorEnv(make_jax_env(env_id), N, seed=0, max_episode_steps=limit)
    col_j = JaxCollector(envs=envs_j, module=p["module"], params=p["params"], cfg=p["cfg_j"], runtime=p["rt"],
                         obs_keys=["state"], total_envs=N, world_size=1)
    carry0 = col_j._carry
    key = jax.random.PRNGKey(11)
    carry_j, data_j, events_j = col_j._rollout(jax.device_put(p["params"]), carry0, key, col_j._env_base)
    envs_p = DeviceVectorEnv(make_device_env(env_id), N, max_episode_steps=limit, device="cpu")
    col_p = FusedOnPolicyCollector(envs=envs_p, agent=p["agent"], cfg=p["cfg_p"], runtime=p["runtime"],
                                   obs_keys=["state"], total_envs=N)
    carry_p0 = jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x)), {k: v for k, v in carry0.items() if k != "gstep"})
    noise = jax_rollout_noise(p, key, carry0, col_j._env_base, steps)
    carry_p, data_p, events_p = col_p.rollout(carry_p0, noise)
    np.testing.assert_array_equal(data_p["dones"].numpy(), np.asarray(data_j["dones"]))
    np.testing.assert_array_equal(events_p["done"].numpy(), np.asarray(events_j["done"]))
    np.testing.assert_array_equal(events_p["ep_length"].numpy(), np.asarray(events_j["ep_length"]))
    assert bool(events_p["done"].any())
    for k in ("state", "values", "actions", "logprobs", "rewards"):
        close(data_p[k], data_j[k])
    close(events_p["ep_return"], events_j["ep_return"])
    close(carry_p["obs"]["state"], carry_j["obs"]["state"])
    assert data_p["rewards"].shape == (steps, N, 1)


def cli_overrides(tmp_path, run_name, total_iters, exp="ppo", env="jax_cartpole", extra=()):
    steps_per_iter = 2 * (16 if exp == "ppo" else 5)
    return [f"exp={exp}", f"env={env}", "algo.env_backend=jax", "fabric.accelerator=cpu", "metric.log_level=0",
            "env.num_envs=2", "algo.dense_units=16", "algo.encoder.mlp_features_dim=16",
            f"algo.total_steps={steps_per_iter * total_iters}", f"root_dir={tmp_path}", f"run_name={run_name}",
            *(["algo.rollout_steps=16", "algo.per_rank_batch_size=8", "algo.update_epochs=2"] if exp == "ppo" else []),
            *extra]


def test_checkpoint_is_read_by_jax(tmp_path):
    """The port's final checkpoint: JAX's ``validate_checkpoint`` accepts it,
    and JAX's ``build_agent`` takes its ``"agent"`` and computes the
    values of the port's agent loaded from the same file."""
    from sheeprl_tpu.utils.ckpt_format import load_state as jax_load_state
    from sheeprl_tpu.utils.ckpt_format import validate_checkpoint as jax_validate
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.ckpt_format import load_checkpoint

    out = run(cli_overrides(tmp_path, "ck", 2, extra=["algo.run_test=False"]))
    summary = jax_validate(out["checkpoint"])
    assert {"agent", "optimizer", "iter_num", "env", "rng"} <= set(summary["keys"])
    state_j = jax_load_state(out["checkpoint"])
    cfg_j = jax_compose(overrides=cli_overrides(tmp_path, "ck", 2))
    module, params = jax_agent.build_agent(jax_runtime(), (2,), False, cfg_j, make_jax_env("jax_cartpole").observation_space,
                                           agent_state=state_j["agent"])
    cfg_p = port_compose(overrides=cli_overrides(tmp_path, "ck", 2))
    agent = build_agent(MeshRuntime(device="cpu").launch(), (2,), False, cfg_p, make_device_env("jax_cartpole").observation_space,
                        agent_state=load_checkpoint(out["checkpoint"])["agent"])
    obs = np.random.default_rng(3).normal(size=(5, 4)).astype(np.float32)
    outs_j, v_j = module.apply(params, {"state": obs})
    outs_p, v_p = agent({"state": torch.from_numpy(obs)})
    close(v_p.detach(), v_j)
    close(outs_p[0].detach(), outs_j[0])
    assert state_j["iter_num"] == 2 and out["policy_step"] == 64


@pytest.mark.parametrize("exp", ["ppo", "a2c"])
def test_resume_continues_the_run(tmp_path, exp):
    """A run of three iterations checkpoints after each; a resume from its
    second checkpoint ends on the bytes of its third: the agent, the
    optimizer state, the envs and the generator (``anneal_lr`` on, so the
    resumed learning rate counts too)."""
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.ckpt_format import load_checkpoint

    per_iter = 2 * (16 if exp == "ppo" else 5)
    extra = ["algo.run_test=False", "algo.anneal_lr=True", f"checkpoint.every={per_iter}"]
    straight = run(cli_overrides(tmp_path, "straight", 3, exp, extra=extra))
    second = os.path.join(straight["log_dir"], "checkpoint", f"ckpt_{2 * per_iter}_0.ckpt")
    resumed = run(cli_overrides(tmp_path, "resumed", 3, exp, extra=extra + [f"checkpoint.resume_from={second}"]))
    assert resumed["iterations"] == 1 and resumed["policy_step"] == straight["policy_step"] == 3 * per_iter
    a, b = load_checkpoint(straight["checkpoint"]), load_checkpoint(resumed["checkpoint"])
    for key in ("agent", "optimizer", "env", "rng"):
        jax.tree_util.tree_map(np.testing.assert_array_equal, a[key], b[key])
    assert a["iter_num"] == b["iter_num"] == 3
    mid = load_checkpoint(second)
    assert not np.array_equal(mid["rng"], a["rng"])


def test_config_tree_names_no_jax_package_module():
    """Every string value of every YAML file under the port's configs: none
    names a ``sheeprl_tpu.`` module; targets of the port's own modules that
    are not ported yet fail with an ImportError that names the port's
    module; JAX-side targets are refused."""
    from sheeprl_tpu_torch.config import instantiate
    from sheeprl_tpu_torch.config.compose import yaml_load

    files = sorted((REPO / "sheeprl_tpu_torch" / "configs").rglob("*.yaml"))
    assert len(files) > 30

    def strings(node):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from strings(k)
                yield from strings(v)
        elif isinstance(node, list):
            for v in node:
                yield from strings(v)
        elif isinstance(node, str):
            yield node

    targets = set()
    for f in files:
        doc = yaml_load(f.read_text()) or {}
        for s in strings(doc):
            assert not s.startswith("sheeprl_tpu.") and "sheeprl_tpu." not in s.replace("sheeprl_tpu_torch.", ""), f"{f}: {s}"
            if s.startswith("sheeprl_tpu_torch."):
                targets.add(s)
    assert "sheeprl_tpu_torch.parallel.mesh.MeshRuntime" in targets
    for target in sorted(targets):
        try:
            instantiate({"_target_": target, "_partial_": True})
        except ImportError as e:
            assert "sheeprl_tpu_torch." in str(e) and "sheeprl_tpu." not in str(e).replace("sheeprl_tpu_torch.", "")
    for bad in ("sheeprl_tpu.parallel.MeshRuntime", "jax.numpy.zeros", "optax.adam"):
        with pytest.raises(ImportError, match="JAX"):
            instantiate({"_target_": bad})


def test_port_scope_raises_name_their_roadmap_items(tmp_path, capsys):
    from sheeprl_tpu_torch.available_agents import available_agents
    from sheeprl_tpu_torch.cli import run

    available_agents()
    table = capsys.readouterr().out
    assert "sheeprl_tpu_torch.algos.ppo" in table and "a2c" in table

    cases = {
        "algo.env_backend=host": "A2",
        "fabric.devices=2": "A5",
        "algo.sentinel.enabled=True": "A2",
        "metric.tracing=full": "A7",
        "metric.telemetry=True": "A7",
        "buffer.memmap=True": "A2",
        "checkpoint.sharded=True": "A5",
        "checkpoint.resume_from=auto": "A6",
        "faults=ckpt_truncate:1": "A6",
        "env.capture_video=True": "A2",
        "fabric.strategy=fsdp": "A5",
    }
    for override, item in cases.items():
        with pytest.raises((NotImplementedError, ValueError), match=item):
            run(cli_overrides(tmp_path, "scope", 1, extra=[override]))
    # the episode buffer's only published users are the pixel host-env exps, which wait for A2's host envs
    with pytest.raises(NotImplementedError, match="A2"):
        run(["exp=dreamer_v2", "env=jax_gridworld", "algo.env_backend=jax", "fabric.accelerator=cpu",
             "metric.log_level=0", f"root_dir={tmp_path}", "run_name=episode", "buffer.type=episode",
             "algo.total_steps=8"])


def test_chip_smoke_ppo_phases_run_on_cpu():
    """chip_smoke.py's ``ppo_training`` and ``ppo_cli`` phases at a small size
    on the CPU: the first rollout and update against a CPU replica, the
    timed iterations, the wide collect, PPO and A2C through the CLI with a
    resume, and the Pendulum iteration."""
    import chip_smoke

    small = ["env.num_envs=2", "algo.rollout_steps=16", "algo.per_rank_batch_size=8", "algo.update_epochs=2",
             "algo.dense_units=16", "algo.encoder.mlp_features_dim=16"]
    res = chip_smoke.run_ppo_training("cpu", overrides=small, iters=2, collect_envs=8, profile=False)
    assert len(res["rollout_ms"]) == len(res["update_ms"]) == 2 and len(res["losses"]) == 2
    assert res["card_vs_cpu"]["max_abs_param_err_after_update"] == 0.0  # both sides run on the CPU here
    assert res["card_vs_cpu"]["max_abs_param_err_faulted_update"] > chip_smoke.PPO_PARAM_TOL
    assert res["wide"]["num_envs"] == 8 and len(res["wide"]["collect_env_steps_per_s"]) == 2
    cli = chip_smoke.run_ppo_cli("cpu", overrides=small + ["env.max_episode_steps=50"])
    assert set(cli) == {"ppo_jax_cartpole", "a2c_jax_cartpole", "ppo_jax_pendulum"}
    for name, row in cli.items():
        assert row["test_reward"] is not None and row["checkpoint"].endswith(".ckpt")
        if "cartpole" in name:
            assert row["resumed"]["iterations"] == 1


def test_checkpoint_manager_cadence_retention_and_refusals(tmp_path):
    """Saves every ``checkpoint.every`` steps and on the last iteration, keeps
    the newest ``keep_last`` files, refuses non-finite agent parameters and
    the knobs that wait (``sharded``, ``device_digests``)."""
    from sheeprl_tpu_torch.config import dotdict
    from sheeprl_tpu_torch.resilience.manager import CheckpointManager, NonFiniteCheckpointError
    from sheeprl_tpu_torch.utils.ckpt_format import load_checkpoint

    def cfg(**kw):
        return dotdict({"checkpoint": {"every": 10, "save_last": True, "keep_last": 2, **kw}})

    runtime = MeshRuntime(device="cpu")
    mgr = CheckpointManager(runtime, cfg(), str(tmp_path))
    written = [mgr.maybe_checkpoint(policy_step=s, is_last=s == 35, state_fn=lambda: {"agent": {"w": torch.ones(2)}, "s": s})
               for s in (5, 10, 15, 20, 35)]
    assert [p is not None for p in written] == [False, True, False, True, True]
    left = sorted(os.listdir(tmp_path / "checkpoint"))
    assert left == ["ckpt_20_0.ckpt", "ckpt_35_0.ckpt"] and load_checkpoint(written[-1])["s"] == 35
    with pytest.raises(NonFiniteCheckpointError, match="/w"):
        mgr.checkpoint_now(policy_step=40, state_fn=lambda: {"agent": {"w": torch.tensor([float("nan")])}})
    for knob, item in (("sharded", "A5"), ("device_digests", "A6")):
        with pytest.raises(NotImplementedError, match=item):
            CheckpointManager(runtime, cfg(**{knob: True}), str(tmp_path))


def test_fabric_node_holds_only_runtime_parameters():
    """Every key of the port's ``fabric`` node is a ``MeshRuntime``
    parameter that the runtime acts on or refuses, so no knob is taken and
    ignored; a key the runtime does not know raises."""
    import inspect

    from sheeprl_tpu_torch.config import compose, instantiate
    from sheeprl_tpu_torch.parallel.mesh import MeshRuntime

    fabric = dict(compose(overrides=["exp=ppo", "env=jax_cartpole", "fabric.accelerator=cpu"]).fabric)
    params = set(inspect.signature(MeshRuntime.__init__).parameters) - {"self"}
    assert set(fabric) - {"_target_"} <= params
    assert instantiate(fabric).device.type == "cpu"
    with pytest.raises(TypeError, match="player_device"):
        instantiate({**fabric, "player_device": "cpu"})


def test_overlap_collect_resolves_off_with_a_notice(tmp_path, capsys):
    """``algo.overlap_collect`` on or ``auto`` runs the serial loop and says
    so, as the JAX package does for ``env_backend=jax``; off says nothing."""
    from sheeprl_tpu_torch.cli import run

    for value, notice in (("True", True), ("auto", True), ("False", False)):
        capsys.readouterr()
        out = run(cli_overrides(tmp_path, f"overlap_{value}", 1, extra=[f"algo.overlap_collect={value}",
                                                                         "algo.run_test=False"]))
        assert out["iterations"] == 1
        assert ("overlap_collect resolved to off" in capsys.readouterr().err) == notice
