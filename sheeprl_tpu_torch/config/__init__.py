from sheeprl_tpu_torch.config.compose import (
    MISSING,
    ConfigError,
    MissingValueError,
    compose,
    deep_merge,
    dotdict,
    resolve,
)

__all__ = [
    "MISSING",
    "ConfigError",
    "MissingValueError",
    "compose",
    "deep_merge",
    "dotdict",
    "resolve",
]
