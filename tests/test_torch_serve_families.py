"""The port's PPO, SAC and recurrent-PPO serving against the JAX package's,
on the CPU.

Small agents of each family (dense 16, LSTM 8) built by the JAX package
are carried into the port.  The comparisons, f32 throughout, 1e-5 with
identical discrete actions:

- each policy function (``serve/policy.py``: ``make_ppo_policy_fn``,
  ``make_sac_policy_fn``, ``make_recurrent_ppo_session_fns``) against
  JAX's on the same parameters and the same noise (JAX's draws from its
  keys, fed to the port through ``noise=``), greedy and sampled, three
  session steps for recurrent PPO;
- the served path: replies of the port's servers to two clients against
  JAX's functions on the logged observations (greedy);
- a recurrent-PPO session row gives the same outputs and state alone and
  inside a batch with another session and pad rows;
- ``--selftest`` of ``python -m sheeprl_tpu_torch.serve.serve_policy`` for
  each family on a checkpoint; the default-device entry points raise
  without a card.

JAX's ``tests/test_serve/test_sessions.py`` golden-parity tests fail under
XLA on the CPU (straight-through outputs are not bit-identical across batch
shapes) and are no oracle here.  Every server is closed in a
``finally``: ``tests/conftest.py`` fails a worker that leaks a thread.
"""

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from sheeprl_tpu.algos.ppo import agent as jax_ppo_agent
from sheeprl_tpu.algos.sac import agent as jax_sac_agent
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.envs.jax import make_jax_env
from sheeprl_tpu.parallel.mesh import MeshRuntime as JaxRuntime
from sheeprl_tpu.serve import policy as jax_policy
from sheeprl_tpu.utils.ckpt_format import save_state
from sheeprl_tpu_torch.config import compose as port_compose
from sheeprl_tpu_torch.envs.device import make_device_env
from sheeprl_tpu_torch.serve.policy import PPO_OUT_KEYS, RPPO_OUT_KEYS, SAC_OUT_KEYS
from sheeprl_tpu_torch.serve.serve_policy import (
    build_ppo_server,
    build_recurrent_ppo_server,
    build_sac_server,
    family_of,
    load_run,
    main as serve_main,
    run_selftest,
)

from test_torch_ppo import ppo_pair
from test_torch_ppo_recurrent import jax_policy_noise, rppo_pair

TOL = 1e-5
SAC_OVR = ["exp=sac", "env=jax_pendulum", "env.id=jax_pendulum", "algo.env_backend=jax", "fabric.accelerator=cpu",
           "algo.mlp_keys.encoder=[state]", "algo.hidden_size=16", "metric.log_level=0"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=tol, atol=tol)


def _obs(rows, dim, seed):
    return {"state": np.random.default_rng(seed).normal(size=(rows, dim)).astype(np.float32)}


def _same(got, want, discrete):
    if discrete:
        np.testing.assert_array_equal(np.asarray(got["real_actions"]), np.asarray(want["real_actions"]))
        np.testing.assert_array_equal(np.asarray(got["flat_actions"]), np.asarray(want["flat_actions"]))
    for k in want:
        close(got[k], want[k])


def jax_ppo_noise(p, key, rows):
    """The draws of JAX's PPO ``sample_actions`` from ``key``."""
    if p["cont"]:
        return [np.asarray(jax.random.normal(key, (rows, sum(p["actions_dim"])), jnp.float32))]
    keys = jax.random.split(key, len(p["actions_dim"]))
    return [np.asarray(jax.random.gumbel(k, (rows, d), jnp.float32)) for k, d in zip(keys, p["actions_dim"])]


@pytest.mark.parametrize("greedy", [True, False])
@pytest.mark.parametrize("env_id", ["jax_cartpole", "jax_pendulum"])
def test_ppo_policy_fn_matches_jax(env_id, greedy):
    from sheeprl_tpu_torch.serve.policy import make_ppo_policy_fn

    p = ppo_pair(env_id)
    obs = _obs(6, 4 if env_id == "jax_cartpole" else 3, 1)
    key = jax.random.PRNGKey(9)
    want = jax_policy.make_ppo_policy_fn(p["module"], [], greedy=greedy)(p["params"], obs, key)
    fn = make_ppo_policy_fn(p["agent"], [], greedy=greedy)
    got = fn(p["agent"], obs, 9, noise=None if greedy else jax_ppo_noise(p, key, 6))
    assert set(got) == set(want) == set(PPO_OUT_KEYS)
    _same(got, want, not p["cont"])
    again = fn(p["agent"], obs, 9)
    if greedy:
        _same(again, want, not p["cont"])
    else:  # the server's key seeds the draw: the same key, the same actions
        np.testing.assert_array_equal(again["flat_actions"], fn(p["agent"], obs, 9)["flat_actions"])


def sac_pair():
    cfg_j, cfg_p = jax_compose(overrides=SAC_OVR), port_compose(overrides=SAC_OVR)
    env_j = make_jax_env("jax_pendulum")
    rt = JaxRuntime(devices=1, accelerator="cpu", precision="32-true")
    rt.launch()
    actor_j, _, params, _ = jax_sac_agent.build_agent(rt, cfg_j, env_j.observation_space, env_j.action_space)
    params = jax.tree_util.tree_map(np.asarray, params)
    env_p = make_device_env("jax_pendulum")
    return {"cfg_j": cfg_j, "cfg_p": cfg_p, "actor_j": actor_j, "params": params, "obs_space": env_p.observation_space,
            "action_space": env_p.action_space}


@pytest.mark.parametrize("greedy", [True, False])
def test_sac_policy_fn_matches_jax_and_serves(greedy):
    """The SAC adapter against JAX's on the same actor parameters and noise,
    then two clients through the port's stateless server (greedy replies
    against JAX's on the logged observations)."""
    p = sac_pair()
    server, keys = build_sac_server(p["cfg_p"], p["params"]["actor"], p["obs_space"], p["action_space"], device="cpu",
                                    greedy=greedy, deadline_ms=200.0, max_batch=8)
    try:
        obs = _obs(5, 3, 2)
        key = jax.random.PRNGKey(4)
        want = jax_policy.make_sac_policy_fn(p["actor_j"], ["state"], greedy=greedy)(p["params"]["actor"], obs, key)
        got = server.policy_fn(server.params, obs, 4, noise=np.asarray(jax.random.normal(key, (5, 1), jnp.float32)))
        assert set(got) == set(want) == set(SAC_OUT_KEYS)
        close(got["actions"], want["actions"])
        assert float(np.abs(got["actions"]).max()) <= 2.0
        res = run_selftest(server, keys, p["obs_space"], 2, 3, rows=[1, 3])
        assert res["selftest"]["failures"] == 0 and res["acted"] == 6 and res["session_ids"] == [None, None]
        if greedy:
            fn = jax_policy.make_sac_policy_fn(p["actor_j"], ["state"], greedy=True)
            for log in res["log"]:
                for sent, reply in log:
                    close(reply["actions"], fn(p["params"]["actor"], sent, key)["actions"])
    finally:
        server.close()


def jax_session_noise(p, state_j):
    """Each row's draws of JAX's recurrent-PPO session step, from the row's ``_key``."""
    per_row = [jax_policy_noise(p, jax.random.split(k)[1], 1) for k in state_j["_key"]]
    return [np.concatenate([row[h].reshape(1, -1) for row in per_row]) for h in range(len(per_row[0]))]


@pytest.mark.parametrize("greedy", [True, False])
@pytest.mark.parametrize("env_id", ["jax_cartpole", "jax_pendulum"])
def test_recurrent_ppo_session_fns_match_jax(env_id, greedy):
    """Three steps of a 3-row session: replies and carried state against
    JAX's session functions, each row's noise drawn from JAX's row key."""
    from sheeprl_tpu_torch.serve.policy import make_recurrent_ppo_session_fns

    p = rppo_pair(env_id)
    step_j, init_j = jax_policy.make_recurrent_ppo_session_fns(p["module"], greedy=greedy)
    step_p, init_p = make_recurrent_ppo_session_fns(p["agent"], greedy=greedy)
    st_j, st_p = init_j(3, 7, p["params"]), init_p(3, 7, p["agent"])
    for t in range(3):
        obs = _obs(3, 4 if env_id == "jax_cartpole" else 3, 10 + t)
        noise = None if greedy else jax_session_noise(p, st_j)
        out_j, st_j = step_j(p["params"], obs, st_j)
        out_p, st_p = step_p(p["agent"], obs, st_p, noise=noise)
        assert set(out_p) == set(out_j) == set(RPPO_OUT_KEYS)
        _same(out_p, out_j, not p["cont"])
        for k in ("hx", "cx", "prev_actions"):
            close(st_p[k], st_j[k])
    np.testing.assert_array_equal(st_p["_ctr"], [3, 3, 3])


def test_recurrent_ppo_served_sessions_match_jax():
    """Two clients of 2 and 3 rows (each batch padded from 5 to 8) served
    three greedy steps; each session rolled through JAX's session
    functions on the logged observations."""
    p = rppo_pair()
    space = make_device_env("jax_cartpole").observation_space
    server, keys = build_recurrent_ppo_server(p["cfg_p"], p["params"], space, (2,), device="cpu", deadline_ms=200.0,
                                              max_batch=8)
    try:
        res = run_selftest(server, keys, space, 2, 3, rows=[2, 3], close_sessions=False)
        assert res["selftest"]["failures"] == 0 and res["acted"] == 6
        assert set(res["batch_hist"]) <= {"2", "4", "8"}
        step_j, init_j = jax_policy.make_recurrent_ppo_session_fns(p["module"], greedy=True)
        for cid, log in enumerate(res["log"]):
            st = init_j(2 + cid, cid, p["params"])
            for sent, reply in log:
                out, st = step_j(p["params"], sent, st)
                _same(reply, out, True)
            served = server.sessions.lookup(res["session_ids"][cid]).state
            close(served["hx"], st["hx"])
            close(served["cx"], st["cx"])
    finally:
        server.close()


@pytest.mark.parametrize("env_id", ["jax_cartpole", "jax_pendulum"])
def test_recurrent_ppo_session_rows_are_batch_independent(env_id):
    """A 2-row session stepped alone, and inside a batch with a 3-row
    session and 3 pad rows, gives the same outputs and state (sampled
    actions: the noise is each row's own hash)."""
    from sheeprl_tpu_torch.serve.policy import make_recurrent_ppo_session_fns

    p = rppo_pair(env_id)
    dim = 4 if env_id == "jax_cartpole" else 3
    step, init = make_recurrent_ppo_session_fns(p["agent"], greedy=False)
    alone, mixed, other = init(2, 5, p["agent"]), init(2, 5, p["agent"]), init(3, 6, p["agent"])
    for t in range(3):
        obs_a, obs_b = _obs(2, dim, 10 + t), _obs(3, dim, 20 + t)
        out_a, alone = step(p["agent"], obs_a, alone)
        pad = init(3, 0, p["agent"])
        state = {k: np.concatenate([other[k], mixed[k], pad[k]]) for k in mixed}
        obs = {k: np.concatenate([obs_b[k], obs_a[k], np.zeros_like(obs_b[k])]) for k in obs_a}
        out, new = step(p["agent"], obs, state)
        other = {k: v[:3] for k, v in new.items()}
        mixed = {k: v[3:5] for k, v in new.items()}
        if not p["cont"]:
            np.testing.assert_array_equal(out["flat_actions"][3:5], out_a["flat_actions"])
        for k in out_a:
            np.testing.assert_allclose(out[k][3:5], out_a[k], rtol=1e-6, atol=1e-6)
        for k in alone:
            np.testing.assert_allclose(mixed[k], alone[k], rtol=1e-6, atol=1e-6)


def test_ppo_served_replies_match_jax():
    p = ppo_pair("jax_cartpole")
    space = make_device_env("jax_cartpole").observation_space
    server, keys = build_ppo_server(p["cfg_p"], p["params"], space, (2,), device="cpu", deadline_ms=200.0, max_batch=8)
    try:
        res = run_selftest(server, keys, space, 2, 3, rows=[2, 3])
        assert res["selftest"]["failures"] == 0 and res["acted"] == 6
        fn = jax_policy.make_ppo_policy_fn(p["module"], [], greedy=True)
        for log in res["log"]:
            for sent, reply in log:
                _same(reply, fn(p["params"], sent, jax.random.PRNGKey(0)), True)
    finally:
        server.close()


def _write_run(tmp_path, name, cfg, state):
    run = tmp_path / name
    ckpt = run / "checkpoint" / "ckpt_8_0.ckpt"
    save_state(ckpt, {**state, "iter_num": 1})
    (run / "config.yaml").write_text(yaml.safe_dump(cfg.as_dict()))
    return str(ckpt)


def test_selftest_serves_each_family_from_a_checkpoint(tmp_path, capsys):
    """``main --selftest`` on a checkpoint of each family (JAX-package
    parameters, the port's run config): the family from ``algo.name``, the
    loader's subtree, every request answered remote."""
    ppo, rppo, sac = ppo_pair("jax_cartpole"), rppo_pair("jax_cartpole"), sac_pair()
    a2c_cfg = port_compose(overrides=["exp=a2c", "env=jax_cartpole", "algo.env_backend=jax", "algo.dense_units=16",
                                      "algo.encoder.mlp_features_dim=16"])
    runs = {
        "ppo": (ppo["cfg_p"], {"agent": ppo["params"]}),
        "ppo_recurrent": (rppo["cfg_p"], {"agent": rppo["params"]}),
        "sac": (sac["cfg_p"], {"agent": sac["params"]}),
    }
    assert family_of(a2c_cfg) == "ppo" and family_of(sac["cfg_p"]) == "sac"
    for family, (cfg, state) in runs.items():
        ckpt = _write_run(tmp_path, family, cfg, state)
        assert family_of(load_run(ckpt)[0]) == family
        capsys.readouterr()
        rc = serve_main(["--checkpoint", ckpt, "--device", "cpu", "--selftest", "2", "--selftest-requests", "3",
                         "--sample"])
        out = capsys.readouterr().out
        assert rc == 0 and '"failures": 0' in out and '"acted": 6' in out, (family, out)
    actor = load_run(_write_run(tmp_path, "sac_actor", sac["cfg_p"], {"agent": sac["params"]}))[1]
    assert set(actor) == {"params"}
    with pytest.raises(ValueError, match="families"):
        family_of(port_compose(overrides=["exp=ppo", "algo.name=p2e_dv3"]))


def test_default_device_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    ppo, rppo, sac = ppo_pair("jax_cartpole"), rppo_pair("jax_cartpole"), sac_pair()
    space = make_device_env("jax_cartpole").observation_space
    with pytest.raises(RuntimeError, match="CUDA"):
        build_ppo_server(ppo["cfg_p"], None, space, (2,))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_recurrent_ppo_server(rppo["cfg_p"], None, space, (2,))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_sac_server(sac["cfg_p"], None, sac["obs_space"], sac["action_space"])
    from sheeprl_tpu_torch.cli import run

    with pytest.raises(RuntimeError, match="CUDA"):
        run(["exp=ppo_recurrent", "env=jax_cartpole", "algo.env_backend=jax", "metric.log_level=0", "root_dir=unused"])


def test_chip_smoke_serve_families_phase_runs_on_cpu():
    """chip_smoke.py's ``serve_families`` phase on the CPU at the exps'
    widths: every family served to two clients and replayed."""
    import chip_smoke

    res = chip_smoke.run_serve_families("cpu", steps=3, calls=2)
    assert set(res) == {"ppo", "sac", "ppo_recurrent"}
    for family, row in res.items():  # the replay runs unpadded batches: ulps apart at most
        assert row["requests"] == 6 and row["max_abs_err_vs_cpu"] <= 1e-6, (family, row)
        assert row["step64_ms_median"] > 0
