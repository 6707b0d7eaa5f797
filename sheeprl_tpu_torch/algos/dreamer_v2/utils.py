"""DreamerV2 helpers (counterpart of ``sheeprl_tpu/algos/dreamer_v2/utils.py``):
the lambda returns with a bootstrap, ``prepare_obs`` and the closing
``test`` episode (DreamerV3's, which compute the same) and the aggregator's
keys."""

from __future__ import annotations

import torch

from sheeprl_tpu_torch.algos.dreamer_v3.utils import prepare_obs, test  # noqa: F401  (the shared pipeline)

__all__ = ["AGGREGATOR_KEYS", "MODELS_TO_REGISTER", "compute_lambda_values", "prepare_obs", "test"]

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/world_model_loss",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "State/post_entropy",
    "State/prior_entropy",
    "State/kl",
    "Grads/world_model",
    "Grads/actor",
    "Grads/critic",
}
MODELS_TO_REGISTER = {"world_model", "actor", "critic", "target_critic"}


def compute_lambda_values(rewards: torch.Tensor, values: torch.Tensor, continues: torch.Tensor,
                          bootstrap: torch.Tensor, lmbda: float = 0.95) -> torch.Tensor:
    """TD(lambda) targets in Hafner's V2 form: ``inputs = r + c V_next (1 -
    lambda)``, then backwards ``agg = inputs_t + c_t lambda agg`` from the
    bootstrap.  Inputs (H, N, 1), ``bootstrap`` (1, N, 1)."""
    next_values = torch.cat([values[1:], bootstrap], 0)
    inputs = rewards + continues * next_values * (1 - lmbda)
    agg = bootstrap[0]
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        agg = inputs[t] + continues[t] * lmbda * agg
        out.append(agg)
    return torch.stack(out[::-1], 0)
