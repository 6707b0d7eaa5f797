"""The port's A2C (``sheeprl_tpu_torch/algos/a2c/``) against the JAX package's,
on the CPU.

A2C's exp (T = 5, four envs, minibatches of 5, summed losses, RMSprop)
with dense 16, from parameters that JAX's ``build_agent`` made: one update
(two with ``anneal_lr``) with JAX's permutation fed to the port, parameters
and metrics 1e-5; the port's RMSprop against ``optax.rmsprop`` 1e-6; the
fused rollout at A2C's T; and a CLI run whose checkpoint JAX's
``validate_checkpoint`` accepts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.algos.a2c.a2c import make_update_fn as jax_make_update_fn
from sheeprl_tpu.algos.a2c import loss as jax_loss
from sheeprl_tpu.algos.ppo.ppo import build_ppo_optimizer as jax_build_optimizer
from sheeprl_tpu_torch.algos.a2c import loss as port_loss
from sheeprl_tpu_torch.algos.a2c.a2c import make_update_fn
from sheeprl_tpu_torch.algos.ppo.ppo import build_ppo_optimizer
from sheeprl_tpu_torch.optim import RMSprop, RMSpropState, build_optimizer
from sheeprl_tpu_torch.utils.convert import torch_to_flax
from sheeprl_tpu_torch.utils.utils import polynomial_decay, trainable_params

from test_torch_ppo import N, SPEC, _np_tree, _t, cli_overrides, close, close_tree, ppo_pair, random_rollout

T_A2C = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    a, b = (rng.normal(size=(20, 1)).astype(np.float32) for _ in range(2))
    for red in ("mean", "sum", "none"):
        close(port_loss.policy_loss(torch.from_numpy(a), torch.from_numpy(b), red), jax_loss.policy_loss(a, b, red), 1e-6)
        close(port_loss.value_loss(torch.from_numpy(a), torch.from_numpy(b), red), jax_loss.value_loss(a, b, red), 1e-6)


def test_rmsprop_matches_optax():
    """Five steps of the port's RMSprop against ``optax.rmsprop`` (eps inside
    the square root, the accumulator from zero), behind the global-norm clip."""
    rng = np.random.default_rng(1)
    params = {"w": rng.normal(size=(7, 3)).astype(np.float32), "b": rng.normal(size=(3,)).astype(np.float32)}
    cfg = {"_target_": "optax.rmsprop", "learning_rate": 7e-4, "decay": 0.99, "eps": 1e-5, "momentum": 0.0,
           "centered": False, "weight_decay": 0.0}
    tx_j = jax_build_optimizer(cfg, 0.5, "32-true")
    tx_p = build_optimizer(cfg, 0.5)
    assert isinstance(tx_p, RMSprop)
    pj, sj = params, tx_j.init(params)
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    sp = tx_p.init(pp)
    for _ in range(5):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        upd, sj = tx_j.update(grads, sj, pj)
        pj = optax.apply_updates(pj, upd)
        tx_p.update(pp, {k: torch.from_numpy(v) for k, v in grads.items()}, sp)
    for k in params:
        close(pp[k], pj[k], 1e-6)
    assert isinstance(sp, RMSpropState)
    with pytest.raises(NotImplementedError, match="momentum"):
        RMSprop(1e-3, momentum=0.9)


@pytest.mark.parametrize("env_id,anneal", [("jax_cartpole", False), ("jax_pendulum", True)])
def test_update_matches_jax(env_id, anneal):
    """The gradients of every minibatch at the same parameters, summed, one
    RMSprop step; JAX's permutation fed to the port."""
    p = ppo_pair(env_id, [f"algo.anneal_lr={anneal}", "algo.ent_coef=0.01", "algo.normalize_advantages=True"], exp="a2c")
    cfg_j, cfg_p = p["cfg_j"], p["cfg_p"]
    assert int(cfg_p.algo.rollout_steps) == T_A2C and cfg_p.algo.optimizer["_target_"] == "optax.rmsprop"
    data, next_obs = random_rollout(np.random.default_rng(4), p["actions_dim"], p["cont"], SPEC[env_id][2], t=T_A2C)
    tx_j = jax_build_optimizer(cfg_j.algo.optimizer, cfg_j.algo.max_grad_norm, "32-true")
    update_j = jax_make_update_fn(p["rt"], p["module"], tx_j, cfg_j, ["state"])
    params_j = jax.device_put(p["params"])
    opt_j = tx_j.init(params_j)
    tx_p = build_ppo_optimizer(cfg_p.algo.optimizer, cfg_p.algo.max_grad_norm)
    opt_p = tx_p.init(trainable_params(p["agent"]))
    update_p = make_update_fn(p["runtime"], p["agent"], tx_p, cfg_p, ["state"])
    n_total = T_A2C * N
    lr0 = float(cfg_p.algo.optimizer.learning_rate)
    calls = 2 if anneal else 1
    for i in range(calls):
        lr = polynomial_decay(i, initial=lr0, final=0.0, max_decay_steps=calls) if i else lr0
        key = jax.random.PRNGKey(20 + i)
        params_j, opt_j, m_j = update_j(params_j, opt_j, jax.device_put(data), jax.device_put(next_obs), key, jnp.float32(lr))
        perm = torch.from_numpy(np.asarray(jax.random.permutation(key, n_total)).astype(np.int64))
        m_p = update_p(opt_p, _t(data), _t(next_obs), lr=lr, perm=perm)
        close_tree(torch_to_flax(p["agent"]), _np_tree(params_j))
        for k, v in m_j.items():
            close(m_p[k].detach(), v)


def test_cli_run_writes_a_checkpoint_jax_accepts(tmp_path, capsys):
    """``exp=a2c`` through the port's CLI on the CPU: a test reward printed,
    the final checkpoint accepted by JAX's ``validate_checkpoint``."""
    from sheeprl_tpu.utils.ckpt_format import validate_checkpoint as jax_validate
    from sheeprl_tpu_torch.cli import run

    out = run(cli_overrides(tmp_path, "a2c", 3, "a2c", extra=["env.max_episode_steps=40"]))
    assert "Test - Reward:" in capsys.readouterr().out and out["test_reward"] is not None
    assert 1.0 <= out["test_reward"] <= 40.0
    assert "optimizer" in jax_validate(out["checkpoint"])["keys"]
