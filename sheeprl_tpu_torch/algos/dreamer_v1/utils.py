"""DreamerV1 helpers (counterpart of ``sheeprl_tpu/algos/dreamer_v1/utils.py``):
the V1 lambda returns and the aggregator's keys; ``prepare_obs`` and
``test`` are DreamerV2's, as in the JAX package."""

from __future__ import annotations

import torch

from sheeprl_tpu_torch.algos.dreamer_v2.utils import prepare_obs, test  # noqa: F401  (the shared pipeline)

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
    "Params/exploration_amount",
    "Grads/world_model",
    "Grads/actor",
    "Grads/critic",
}
MODELS_TO_REGISTER = {"world_model", "actor", "critic"}


def compute_lambda_values(rewards: torch.Tensor, values: torch.Tensor, continues: torch.Tensor,
                          last_values: torch.Tensor, horizon: int = 15, lmbda: float = 0.95) -> torch.Tensor:
    """The V1 recursion over (H, N, 1) inputs, ``last_values`` (N, 1):
    ``horizon - 1`` rows, the accumulator from zero, the last step
    bootstrapped with the whole last value and the earlier ones with
    ``V_{t+1} (1 - lambda)``."""
    next_values = torch.cat([values[1 : horizon - 1] * (1 - lmbda), last_values[None]], 0)
    deltas = rewards[: horizon - 1] + next_values * continues[: horizon - 1]
    agg = torch.zeros_like(last_values)
    out = []
    for t in range(horizon - 2, -1, -1):
        agg = deltas[t] + lmbda * continues[t] * agg
        out.append(agg)
    return torch.stack(out[::-1], 0)
