from sheeprl_tpu_torch.config.compose import (
    MISSING,
    ConfigError,
    MissingValueError,
    compose,
    _locate,
    deep_merge,
    dotdict,
    instantiate,
    resolve,
)

__all__ = [
    "MISSING",
    "ConfigError",
    "MissingValueError",
    "compose",
    "deep_merge",
    "dotdict",
    "instantiate",
    "resolve",
]
