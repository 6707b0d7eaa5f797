"""Plan2Explore-DreamerV2's finetuning phase (counterpart of
``sheeprl_tpu/algos/p2e_dv2/p2e_dv2_finetuning.py``).

Starts from the exploration run's checkpoint
(``checkpoint.exploration_ckpt_path``, the port's or the JAX package's): the
world model, both actors, the task critic and its target, with the
optimizer states the checkpoint holds (the ensembles and the exploration
critics are not built); DreamerV2's model keys of the exploration run's
config replace this run's (``p2e_dv2_finetuning.py:72-77``: ``layer_norm``
among them, no ``unimix`` or ``hafner_initialization``);
``buffer.load_from_exploration`` inherits the exploration replay.  It
trains the task behaviour with DreamerV2's step on the Dreamer loop with
DreamerV2's conventions (``env.frame_stack = 1``): the player acts with the
exploration actor from the first step (no random warm-up), switches to the
task actor at the first gradient step (``:339-345``), and the closing test
(few-shot) runs the task actor.  The shared body is
:func:`~sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_finetuning.finetuning_family`.
"""

from __future__ import annotations

from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import make_player, make_train_state
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import run_dreamer
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_finetuning import finetuning_family
from sheeprl_tpu_torch.utils.registry import register_algorithm

__all__ = ["MODEL_KEYS", "P2E_DV2_FINETUNING_FAMILY", "main"]

# the exploration config's keys that fix the models' shapes (p2e_dv2_finetuning.py:72-77)
MODEL_KEYS = ("gamma", "lmbda", "horizon", "layer_norm", "dense_units", "mlp_layers", "dense_act", "cnn_act",
              "world_model", "actor", "critic", "cnn_keys", "mlp_keys")
# DreamerV2's agent's parts and the checkpoint's names for them (also of the optimizer groups)
TASK_KEYS = {"world_model": "world_model", "actor": "actor_task", "critic": "critic_task",
             "target_critic": "target_critic_task"}


def _build_agent(*args):
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent

    return build_agent(*args)


def _build_actor(runtime, actions_dim, is_continuous, cfg):
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_actor

    wm_cfg = cfg.algo.world_model
    latent = int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size) + int(wm_cfg.recurrent_model.recurrent_state_size)
    return build_actor(runtime, actions_dim, is_continuous, cfg, latent)


P2E_DV2_FINETUNING_FAMILY = finetuning_family("P2E-DV2", MODEL_KEYS, TASK_KEYS, _build_agent, _build_actor,
                                              make_train_state, make_player=make_player, generation=2)


@register_algorithm()
def main(runtime, cfg):
    """The finetuning phase on the Dreamer loop (module docstring).
    Returns the run's summary."""
    return run_dreamer(runtime, cfg, P2E_DV2_FINETUNING_FAMILY)
