"""The port's DreamerV3 train step with the decoupled RSSM against the JAX
package's, and CPU rehearsals of chip_smoke.py's decoupled DV3-S phase.

Two steps of each package's ``make_train_fn`` with
``decoupled_rssm=True``, from the same converted parameters and optimizer
states, with the noise JAX draws fed to the port, as
``test_torch_dreamer_v3_train.py`` runs the coupled RSSM and at its
tolerances (metrics 1e-4 relative, parameters 2e-5).  The recurrent model
is H = dense = 128 wide, so that ``fused_seq=True`` takes the sequence
route in both packages (Pallas ``gru_sequence`` in interpret mode on the JAX
side, the autograd op's plain forward and efficient-BPTT backward on the
port's); ``fused_seq=False`` takes the loop of gated GRU steps.  MLP
observations only, to keep JAX's compile short.
"""

import copy

import numpy as np
import pytest
import torch

from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu_torch.config import compose as port_compose
from sheeprl_tpu_torch.config import dotdict
from sheeprl_tpu_torch.utils.convert import ConversionError, flax_to_torch

from test_torch_dreamer_v3_train import _np_tree, run_and_compare, tiny_train_pair

R = 128
DECOUPLED = [
    "algo.world_model.decoupled_rssm=True",
    f"algo.world_model.recurrent_model.recurrent_state_size={R}",
    f"algo.world_model.recurrent_model.dense_units={R}",
    "algo.cnn_keys.encoder=[]",
    "algo.cnn_keys.decoder=[]",
]
PACMAN_OVERRIDES = [
    "exp=dreamer_v3_100k_ms_pacman", "algo.world_model.decoupled_rssm=True",
    "algo.world_model.recurrent_model.fused_seq=True", "algo.world_model.recurrent_model.fused=True",
    "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[]", "fabric.precision=32-true",
    "buffer.device_cache=True", "buffer.per_kernel=pallas", "buffer.memmap=False",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fused_seq", [True, False])
def test_decoupled_train_step_matches_jax(fused_seq):
    pair = tiny_train_pair(extra=DECOUPLED + [f"algo.world_model.recurrent_model.fused_seq={fused_seq}"])
    rssm = pair["agent"].world_model.rssm
    assert rssm.decoupled and rssm.seq_scan_eligible(R) is fused_seq
    run_and_compare(pair)


def test_decoupled_world_model_converts():
    """A decoupled tree fills the port's decoupled world model, whose
    representation model reads the embedding alone (E wide, not H + E);
    a coupled tree does not fit it."""
    pair = tiny_train_pair(extra=DECOUPLED)
    agent = pair["agent"]
    params = _np_tree(pair["jax"]["params"])
    state = flax_to_torch(params, agent)
    assert state.keys() == agent.state_dict().keys()
    rep = state["world_model.rssm.representation_model.layers.0.dense.weight"]
    embed = agent.world_model.encoder.mlp_encoder.mlp.layers[-1].dense.weight.shape[0]
    assert rep.shape == (16, embed)
    coupled = tiny_train_pair(extra=[o for o in DECOUPLED if "decoupled" not in o])
    with pytest.raises(ConversionError, match="representation_model"):
        flax_to_torch(_np_tree(coupled["jax"]["params"]), agent)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_chip_smoke_config_is_the_composed_ms_pacman():
    """The dict chip_smoke.py trains the decoupled DV3-S phase with equals
    the composed canonical config 4 of BASELINE.md (with the window-gather kernel on) on
    every key it sets, in the port and in the JAX package."""
    from chip_smoke import PACMAN_ACTIONS, PACMAN_CAPACITY, PACMAN_OBS, S_PACMAN

    port, ref = port_compose(overrides=PACMAN_OVERRIDES), jax_compose(overrides=PACMAN_OVERRIDES)
    for path, value in _leaves(S_PACMAN):
        for cfg in (port, ref):
            node = cfg
            for k in path:
                node = node[k]
            assert node == value, path
    assert list(PACMAN_OBS) == list(port.algo.cnn_keys.encoder) + list(port.algo.mlp_keys.encoder)
    assert PACMAN_OBS["rgb"] == (port.env.screen_size, port.env.screen_size, 3) and PACMAN_ACTIONS == (9,)
    assert PACMAN_CAPACITY == port.buffer.size // port.env.num_envs  # the full ring: no cut


def test_chip_smoke_decoupled_phase_runs_on_cpu():
    """chip_smoke.py's decoupled phase at tiny widths (but an eligible
    H = X = 128) on the CPU: replay fill, both runs of ``train_steps`` and
    their comparison, on the sequence route."""
    import chip_smoke

    cfg = copy.deepcopy(chip_smoke.S_PACMAN)
    a, wm = cfg["algo"], cfg["algo"]["world_model"]
    cfg["env"]["screen_size"] = 16
    wm.update(stochastic_size=4, discrete_size=4)
    wm["encoder"].update(cnn_channels_multiplier=4, mlp_layers=1, dense_units=16)
    wm["observation_model"].update(cnn_channels_multiplier=4, mlp_layers=1, dense_units=16)
    wm["recurrent_model"].update(recurrent_state_size=R, dense_units=R)
    wm["transition_model"]["hidden_size"] = 16
    for node in (wm["reward_model"], wm["discount_model"], a["critic"], a["actor"]):
        node.update(mlp_layers=1, dense_units=16)
    wm["reward_model"]["bins"] = a["critic"]["bins"] = 15
    a.update(horizon=3, per_rank_sequence_length=8, per_rank_batch_size=4)

    def small(rng, rows):
        d = chip_smoke.pacman_transitions(rng, rows)
        d["rgb"] = np.ascontiguousarray(d["rgb"][:, :, :16, :16])
        return d

    res = chip_smoke.run_training(
        dotdict(cfg), {"rgb": (16, 16, 3)}, (9,), "cpu", steps=2, capacity=256, transitions=small, per=False,
        profile=True,
    )
    # (the input product is the cluster route's, which only a card takes)
    assert res["launches_expected"] == {"gru_cell": 2 * 3, "gru_sequence": 2, "gru_input_product": 0, "gather_windows": 2}
    assert len(res["losses_kernels"]) == 2 and res["categorical_samples"] == 2 * (8 * 4 * 4 + 3 * 32 * 4)
    # on the CPU the op's backward (efficient BPTT) meets autograd through the plain loop
    assert res["max_abs_param_diff"] <= chip_smoke.PARAM_ATOL
    assert "per" not in res and "profile" not in res
