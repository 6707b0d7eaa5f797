"""A2C runs the PPO agent (counterpart of ``sheeprl_tpu/algos/a2c/agent.py``)."""

from sheeprl_tpu_torch.algos.ppo.agent import (  # noqa: F401
    PPOAgentModule,
    PPOPlayer,
    build_agent,
    evaluate_actions,
    get_values,
    sample_actions,
)
