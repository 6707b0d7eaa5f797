"""The port's DreamerV3 session serving against the JAX package's.

A tiny DreamerV3 (widths of 16, one MLP layer, a 16-px screen) is served by
the port's ``SessionInferenceServer`` on the CPU; every served step is held
against the JAX ``_row`` composition (``serve/policy.py:181-215``) with the
port's per-row noise injected, at 1e-5 on the recurrent state with
identical action argmax.  Also here: batch independence, the in-process
selftest, checkpoints written by the JAX package, the ``chip_smoke``
configuration, the import rule and the default device.
"""

import ast
import copy
import os
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3.agent import RSSM
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.serve.sessions import session_knobs as jax_session_knobs
from sheeprl_tpu.utils.ckpt_format import save_state
from sheeprl_tpu_torch.config import compose as port_compose
from sheeprl_tpu_torch.config import dotdict
from sheeprl_tpu_torch.parallel.mesh import MeshRuntime
from sheeprl_tpu_torch.serve.policy import agent_params_loader, make_dreamer_session_fns, row_gumbel, row_seeds
from sheeprl_tpu_torch.serve.sessions import build_server, session_knobs
from sheeprl_tpu_torch.serve.serve_policy import (
    ObsSpec,
    build_dreamer_server,
    load_run,
    main as serve_main,
    run_selftest,
    spaces_from_params,
)
from sheeprl_tpu_torch.utils.ckpt_format import CheckpointCorruptError, load_checkpoint
from sheeprl_tpu_torch.utils.convert import flax_to_torch
from sheeprl_tpu_torch.utils.utils import resolve_device

from test_torch_dreamer_v3_player import OBS_SPACE, TINY, random_obs, tiny_pair

REPO = Path(__file__).resolve().parents[1]
ACTIONS = (3, 2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_fns(pair, greedy=True):
    return make_dreamer_session_fns(
        pair["agent"], actions_dim=ACTIONS, stochastic_size=4, discrete_size=4, recurrent_state_size=16,
        greedy=greedy, device="cpu",
    )


def _jax_row_step(pair):
    """The JAX ``_row`` composition with the stochastic-state noise fed in
    (greedy actor), vmapped per row as the JAX adapter runs it."""
    wm, actor = pair["wm"], pair["actor"]

    def _row(params, obs_row, st, noise_row):
        obs = {k: v[None, None] for k, v in obs_row.items()}
        rec2 = wm.rssm.apply(
            params["world_model"]["rssm"],
            jnp.concatenate([st["stochastic_state"][None, None], st["actions"][None, None]], -1),
            st["recurrent_state"][None, None],
            method=RSSM.recurrent_step,
        )
        embedded = wm.encoder.apply(params["world_model"]["encoder"], obs)
        _, stoch = wm.rssm.apply(
            params["world_model"]["rssm"], embedded, None, rec2, noise_row[None, None], method=RSSM._representation
        )
        stoch2 = stoch.reshape(stoch.shape[:-2] + (16,))
        actions, _ = actor.apply(params["actor"], jnp.concatenate([stoch2, rec2], -1), True, None)
        flat = jnp.concatenate(actions, -1).reshape(sum(ACTIONS))
        return flat, {"actions": flat, "recurrent_state": rec2.reshape(16), "stochastic_state": stoch2.reshape(16)}

    return jax.jit(jax.vmap(_row, in_axes=(None, 0, 0, 0)))


def _jax_init(pair, rows):
    rec, stoch = pair["wm"].rssm.apply(
        pair["params"]["world_model"]["rssm"], (rows,), method=RSSM.get_initial_states
    )
    return {"actions": jnp.zeros((rows, sum(ACTIONS))), "recurrent_state": rec, "stochastic_state": stoch.reshape(rows, 16)}


def _noise(seed, rows, step):
    """The per-row Gumbel noise the port's server draws for a session."""
    seeds = torch.from_numpy(row_seeds(rows, seed))
    return row_gumbel(seeds, torch.full((rows,), step, dtype=torch.int64), 0, 16).reshape(rows, 4, 4).numpy()


@pytest.mark.parametrize("fused", [False, True])
def test_served_sessions_match_jax_row_composition(fused):
    """Two clients (2 and 3 rows, so every batch is padded from 5 to 8) are
    served three steps; each session is then rolled through the JAX
    composition with the same noise."""
    pair = tiny_pair(actions_dim=ACTIONS, fused=fused)
    session_fn, init_fn = _port_fns(pair)
    server = build_server(
        None, pair["agent"], session={"enabled": True}, session_policy_fn=session_fn, init_state_fn=init_fn,
        deadline_ms=200.0, max_batch=8,
    )
    space = {k: OBS_SPACE[k] for k in ("rgb", "state")}
    res = run_selftest(server, ["rgb", "state"], space, 2, 3, rows=[2, 3], close_sessions=False)
    assert res["selftest"]["failures"] == 0 and res["acted"] == 6
    assert set(res["batch_hist"]) <= {"2", "4", "8"}
    step = _jax_row_step(pair)
    for cid, log in enumerate(res["log"]):
        rows = 2 + cid
        st = _jax_init(pair, rows)
        for t, (obs, reply) in enumerate(log):
            flat, st = step(pair["params"], {k: jnp.asarray(v) for k, v in obs.items()}, st, jnp.asarray(_noise(cid, rows, t)))
            for head in (slice(0, 3), slice(3, 5)):
                np.testing.assert_array_equal(
                    reply["flat_actions"][:, head].argmax(-1), np.asarray(flat)[:, head].argmax(-1)
                )
            np.testing.assert_allclose(reply["flat_actions"], np.asarray(flat), rtol=1e-5, atol=1e-5)
        served = server.sessions.lookup(res["session_ids"][cid]).state
        np.testing.assert_allclose(served["recurrent_state"], np.asarray(st["recurrent_state"]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(served["stochastic_state"], np.asarray(st["stochastic_state"]), rtol=1e-5, atol=1e-5)


def test_session_rows_are_batch_independent():
    """A 2-row session stepped alone, and inside a batch with a 3-row
    session and 3 pad rows, gives the same outputs and state."""
    pair = tiny_pair(actions_dim=ACTIONS, fused=True)
    session_fn, init_fn = _port_fns(pair, greedy=False)
    alone, mixed, other = init_fn(2, 5, pair["agent"]), init_fn(2, 5, pair["agent"]), init_fn(3, 6, pair["agent"])
    for t in range(3):
        obs_a, obs_b = random_obs(2, seed=10 + t), random_obs(3, seed=20 + t)
        out_a, alone = session_fn(pair["agent"], obs_a, alone)
        pad = init_fn(3, 0, pair["agent"])
        state = {k: np.concatenate([other[k], mixed[k], pad[k]]) for k in mixed}
        obs = {k: np.concatenate([obs_b[k], obs_a[k], np.zeros_like(obs_b[k])]) for k in obs_a}
        out, new = session_fn(pair["agent"], obs, state)
        other = {k: v[:3] for k, v in new.items()}
        mixed = {k: v[3:5] for k, v in new.items()}
        np.testing.assert_array_equal(out["flat_actions"][3:5], out_a["flat_actions"])
        for k in alone:
            np.testing.assert_allclose(mixed[k], alone[k], rtol=1e-6, atol=1e-6)


def _tiny_chip_cfg():
    from chip_smoke import XL_CRAFTER

    cfg = copy.deepcopy(XL_CRAFTER)
    wm = cfg["algo"]["world_model"]
    cfg["env"]["screen_size"] = 16
    wm.update(stochastic_size=4, discrete_size=4)
    wm["encoder"].update(cnn_channels_multiplier=4, mlp_layers=1, dense_units=16)
    wm["recurrent_model"].update(recurrent_state_size=16, dense_units=16)
    wm["transition_model"]["hidden_size"] = 16
    cfg["algo"]["actor"].update(dense_units=16, mlp_layers=1)
    return dotdict(cfg)


def test_chip_smoke_serving_phases_run_on_cpu():
    """The chip smoke's serving and replay phases, at tiny widths on the
    CPU: two selftests (one filling the 64-row bucket), every request
    answered remote, and the replay through the plain version agreeing."""
    from chip_smoke import replay_plain, serve_sessions

    served = serve_sessions(_tiny_chip_cfg(), {"rgb": (16, 16, 3), "reward": (1,)}, (17,), "cpu", steps=2)
    assert served["bucket64"]["rows_hist"] == {"64": 2}
    assert served["batches"] >= 3
    assert replay_plain(served) <= 1e-6


def test_selftest_two_clients_all_remote_on_cpu():
    cfg = port_compose(overrides=TINY)
    space = {"rgb": ObsSpec((16, 16, 3), np.float32), "state": ObsSpec((5,), np.float32)}
    server, keys = build_dreamer_server(cfg, None, space, ACTIONS, device="cpu")
    res = run_selftest(server, keys, space, 2, 4)
    assert res["selftest"]["failures"] == 0
    assert res["acted"] == 8 and res["sessions"]["closed"] == 2
    assert all(len(log) == 4 for log in res["log"])
    assert not server.alive


def _write_jax_run(tmp_path, pair):
    import yaml

    run = tmp_path / "run"
    ckpt = run / "checkpoint" / "ckpt_8_0.ckpt"
    params = pair["params"]
    save_state(ckpt, {"world_model": params["world_model"], "actor": params["actor"], "iter_num": 8})
    cfg = jax_compose(overrides=TINY + ["algo.world_model.recurrent_model.fused=False"])
    (run / "config.yaml").write_text(yaml.safe_dump(cfg.as_dict()))
    return ckpt


def test_jax_checkpoint_loads_bit_identical(tmp_path):
    pair = tiny_pair(actions_dim=ACTIONS)
    ckpt = _write_jax_run(tmp_path, pair)
    cfg, params = load_run(str(ckpt))
    space, actions_dim = spaces_from_params(cfg, params)
    assert actions_dim == ACTIONS and space["state"].shape == (5,) and space["rgb"].shape == (16, 16, 3)
    direct = flax_to_torch(jax.tree_util.tree_map(np.asarray, pair["params"]), pair["agent"])
    loaded = flax_to_torch(params, pair["agent"])
    assert direct.keys() == loaded.keys()
    for k in direct:
        assert torch.equal(direct[k], loaded[k]), k
    world_model = agent_params_loader("world_model")(str(ckpt))
    for (path, a), (path_b, b) in zip(_leaves(world_model), _leaves(params["world_model"])):
        assert path == path_b and np.array_equal(a, b), path
    rc = serve_main(["--checkpoint", str(ckpt), "--device", "cpu", "--selftest", "2", "--selftest-requests", "2"])
    assert rc == 0


def test_pre_v1_pickle_checkpoints_are_refused(tmp_path):
    path = tmp_path / "old.ckpt"
    path.write_bytes(pickle.dumps({"world_model": {}, "actor": {}}))
    with pytest.raises(CheckpointCorruptError, match="not a sheeprl_tpu_ckpt_v1"):
        load_checkpoint(path)
    truncated = tmp_path / "cut.ckpt"
    save_state(truncated, {"a": np.arange(1000.0)})
    truncated.write_bytes(truncated.read_bytes()[:300])
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint(truncated)


def _leaves(node, prefix=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, node


def _get(cfg, path):
    for k in path:
        cfg = cfg[k]
    return cfg


def test_chip_smoke_config_is_the_composed_xl_crafter():
    """The dict chip_smoke.py serves equals the port's composed
    ``exp=dreamer_v3_XL_crafter`` (fused GRU) on every key it sets, and the
    port composes the same values as the JAX package there."""
    from chip_smoke import CRAFTER_ACTIONS, CRAFTER_OBS, XL_CRAFTER

    overrides = ["exp=dreamer_v3_XL_crafter", "algo.world_model.recurrent_model.fused=True"]
    port, ref = port_compose(overrides=overrides), jax_compose(overrides=overrides)
    for path, value in _leaves(XL_CRAFTER):
        assert _get(port, path) == value, path
        assert _get(ref, path) == value, path
    assert port.algo.actor.cls == "sheeprl_tpu_torch.algos.dreamer_v3.agent.Actor"
    assert list(CRAFTER_OBS) == list(port.algo.cnn_keys.encoder) + list(port.algo.mlp_keys.encoder)
    assert CRAFTER_OBS["rgb"] == (port.env.screen_size, port.env.screen_size, 3) and CRAFTER_ACTIONS == (17,)


@pytest.mark.parametrize(
    "overrides",
    [[], ["algo.serve.sessions.enabled=True", "algo.serve.sessions.capacity=7", "algo.serve.sessions.idle_ttl_s=2.5"]],
)
def test_session_knobs_match_jax(overrides):
    overrides = ["exp=dreamer_v3_XL_crafter"] + overrides
    ours = session_knobs(port_compose(overrides=overrides))
    assert ours == jax_session_knobs(jax_compose(overrides=overrides))
    assert ours["enabled"] == bool(len(overrides) > 1)


def _py_files():
    yield REPO / "chip_smoke.py"
    yield from sorted((REPO / "sheeprl_tpu_torch").rglob("*.py"))


@pytest.mark.parametrize("path", list(_py_files()), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_side_module(path):
    banned = {"jax", "jaxlib", "flax", "optax", "chex", "sheeprl_tpu"}
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            assert name.split(".")[0] not in banned, f"{path.name}:{node.lineno} imports {name}"


def test_default_device_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        MeshRuntime()
    cfg = port_compose(overrides=TINY)
    space = {"rgb": ObsSpec((16, 16, 3), np.float32), "state": ObsSpec((5,), np.float32)}
    with pytest.raises(RuntimeError, match="CUDA"):
        build_dreamer_server(cfg, None, space, ACTIONS)
    assert resolve_device("cpu").type == "cpu"
    assert os.path.exists(REPO / "sheeprl_tpu_torch" / "csrc" / "gru_cell.cu")
