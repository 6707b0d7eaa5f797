"""sheeprl_tpu_torch.serve — session serving of DreamerV3 policies.

The port's counterpart of ``sheeprl_tpu/serve``: clients ship observation
frames over in-process queue channels, the
:class:`~sheeprl_tpu_torch.serve.sessions.SessionInferenceServer` batches
them (deadline + max-batch, power-of-two buckets), keeps each session's
recurrent state, and answers with actions.
"""

from sheeprl_tpu_torch.serve.client import CircuitBreaker, InferenceClient
from sheeprl_tpu_torch.serve.policy import DREAMER_OUT_KEYS, agent_params_loader, make_dreamer_session_fns
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
    "SessionCache",
    "SessionClient",
    "SessionInferenceServer",
    "agent_params_loader",
    "bucket_for",
    "build_server",
    "make_dreamer_session_fns",
    "session_knobs",
]
