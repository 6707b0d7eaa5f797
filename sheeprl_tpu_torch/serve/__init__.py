"""sheeprl_tpu_torch.serve — serving of PPO, SAC, recurrent-PPO and
DreamerV3 policies.

The port's counterpart of ``sheeprl_tpu/serve``: clients ship observation
frames over in-process queue channels; the
:class:`~sheeprl_tpu_torch.serve.service.InferenceServer` batches them
(deadline + max-batch, power-of-two buckets) and answers with actions, and
the :class:`~sheeprl_tpu_torch.serve.sessions.SessionInferenceServer` also
keeps each session's recurrent state.
"""

from sheeprl_tpu_torch.serve.client import CircuitBreaker, InferenceClient
from sheeprl_tpu_torch.serve.policy import (
    DREAMER_OUT_KEYS,
    PPO_OUT_KEYS,
    RPPO_OUT_KEYS,
    SAC_OUT_KEYS,
    agent_params_loader,
    make_dreamer_session_fns,
    make_ppo_policy_fn,
    make_recurrent_ppo_session_fns,
    make_sac_policy_fn,
)
from sheeprl_tpu_torch.serve.service import InferenceServer, bucket_for
from sheeprl_tpu_torch.serve.sessions import (
    SessionCache,
    SessionClient,
    SessionInferenceServer,
    build_server,
    session_knobs,
)

__all__ = [
    "CircuitBreaker",
    "DREAMER_OUT_KEYS",
    "InferenceClient",
    "InferenceServer",
    "PPO_OUT_KEYS",
    "RPPO_OUT_KEYS",
    "SAC_OUT_KEYS",
    "SessionCache",
    "SessionClient",
    "SessionInferenceServer",
    "agent_params_loader",
    "bucket_for",
    "build_server",
    "make_dreamer_session_fns",
    "make_ppo_policy_fn",
    "make_recurrent_ppo_session_fns",
    "make_sac_policy_fn",
    "session_knobs",
]
