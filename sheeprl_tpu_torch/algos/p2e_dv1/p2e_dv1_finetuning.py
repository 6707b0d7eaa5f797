"""Plan2Explore-DreamerV1's finetuning phase (counterpart of
``sheeprl_tpu/algos/p2e_dv1/p2e_dv1_finetuning.py``).

P2E-DV2's finetuning (``algos/p2e_dv2/p2e_dv2_finetuning.py``) on
DreamerV1: the world model, both actors and the task critic (no target
critic) from the exploration checkpoint, DreamerV1's step, the player's
exploration amount decaying with the policy step, and the switch to the
task actor at the first gradient step (``p2e_dv1_finetuning.py:301-304``).
"""

from __future__ import annotations

from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import make_player, make_train_state
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import run_dreamer
from sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_finetuning import MODEL_KEYS
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_finetuning import finetuning_family
from sheeprl_tpu_torch.utils.registry import register_algorithm

__all__ = ["P2E_DV1_FINETUNING_FAMILY", "main"]

# DreamerV1's agent's parts and the checkpoint's names for them (also of the optimizer groups)
TASK_KEYS = {"world_model": "world_model", "actor": "actor_task", "critic": "critic_task"}


def _build_agent(*args):
    from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent

    return build_agent(*args)


def _build_actor(runtime, actions_dim, is_continuous, cfg):
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_actor

    wm_cfg = cfg.algo.world_model
    latent = int(wm_cfg.stochastic_size) + int(wm_cfg.recurrent_model.recurrent_state_size)
    return build_actor(runtime, actions_dim, is_continuous, cfg, latent)


P2E_DV1_FINETUNING_FAMILY = finetuning_family("P2E-DV1", MODEL_KEYS, TASK_KEYS, _build_agent, _build_actor,
                                              make_train_state, make_player=make_player, generation=1)


@register_algorithm()
def main(runtime, cfg):
    """The finetuning phase on the Dreamer loop (module docstring).
    Returns the run's summary."""
    return run_dreamer(runtime, cfg, P2E_DV1_FINETUNING_FAMILY)
