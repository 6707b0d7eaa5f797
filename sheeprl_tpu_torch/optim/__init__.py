"""Optimizers for the port (counterpart of ``sheeprl_tpu/optim/__init__.py``).

The configs keep the JAX package's ``_target_: optax.adam`` (the port's
``configs/optim/adam.yaml``); :func:`build_optimizer` maps that name to
:class:`Adam`, which computes optax's update:

    mu = (1 - b1) g + b1 mu,   nu = (1 - b2) g^2 + b2 nu,   count += 1
    u  = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
    p  = p - lr u

with ``eps`` outside the square root (optax's ``eps_root`` is 0), and in
front of it optax's
``clip_by_global_norm``: ``g * max_norm / norm`` only when
``norm >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` divides by
``norm + 1e-6`` and scales always, so it is not used).  A nonzero
``weight_decay`` adds ``wd * p`` to the clipped gradient before Adam, as
``optax.add_decayed_weights`` chained in front does.

``optax.adamw`` (recurrent PPO's optimizer) is :class:`AdamW`: the same
moments and state, with the decay decoupled, added after the Adam scaling,

    p = p - lr (u + wd p)

behind the same clip (optax's ``scale_by_adam``, ``add_decayed_weights``,
``scale_by_learning_rate`` chain; its default ``weight_decay`` is 1e-4).

``optax.rmsprop`` (A2C's optimizer) is :class:`RMSprop`, without
centering or momentum (optax's default ``momentum=None``; 0 is the same
update):

    nu = (1 - decay) g^2 + decay nu,   p = p - lr g / sqrt(nu + eps)

with ``eps`` inside the square root and ``nu`` starting at 0 (optax's
``eps_in_sqrt`` and ``initial_scale``), behind the same clip and decay.

Parameters are updated in place.  ``bf16-true`` (f32 master weights over
bf16 parameters) is not ported yet and raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

__all__ = ["Adam", "AdamState", "AdamW", "RMSprop", "RMSpropState", "build_optimizer", "finalize_optimizer", "global_norm"]

# the reference's torch argument names, mapped to optax's
_RENAMES = {"lr": "learning_rate", "alpha": "decay"}


def global_norm(tensors) -> torch.Tensor:
    """``optax.global_norm``: the 2-norm of all the tensors together."""
    tensors = list(tensors)
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


@dataclass
class AdamState:
    """optax ``ScaleByAdamState`` over named parameters."""

    count: int
    mu: Dict[str, torch.Tensor] = field(default_factory=dict)
    nu: Dict[str, torch.Tensor] = field(default_factory=dict)


def _clip(opt, keys, grads, norm):
    """optax's ``clip_by_global_norm``."""
    g = [grads[k] for k in keys]
    if opt.max_grad_norm is not None:
        norm = global_norm(g) if norm is None else norm
        scale = torch.where(norm < opt.max_grad_norm, torch.ones_like(norm), opt.max_grad_norm / norm)
        # (g / norm) * max_norm in optax; scaling by max/norm differs in the last ulp only
        g = torch._foreach_mul(g, scale)
    return g


def _clip_and_decay(opt, params, keys, grads, norm):
    """optax's ``clip_by_global_norm`` then ``add_decayed_weights``."""
    g = _clip(opt, keys, grads, norm)
    if opt.weight_decay:
        g = torch._foreach_add(g, [params[k] for k in keys], alpha=opt.weight_decay)
    return g


class Adam:
    """optax.adam, optionally behind a global-norm clip and weight decay."""

    def __init__(
        self,
        learning_rate: float,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        max_grad_norm: Optional[float] = None,
        weight_decay: float = 0.0,
    ):
        self.learning_rate = float(learning_rate)
        self.b1, self.b2 = float(b1), float(b2)
        self.eps = float(eps)
        self.max_grad_norm = None if not max_grad_norm or max_grad_norm <= 0 else float(max_grad_norm)
        self.weight_decay = float(weight_decay)

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        return AdamState(
            0, {k: torch.zeros_like(p) for k, p in params.items()}, {k: torch.zeros_like(p) for k, p in params.items()}
        )

    @torch.no_grad()
    def update(
        self,
        params: Dict[str, torch.Tensor],
        grads: Dict[str, torch.Tensor],
        state: AdamState,
        norm: Optional[torch.Tensor] = None,
    ) -> None:
        """One step, in place on ``params`` and ``state``.  ``norm`` is the
        gradients' global norm when the caller has it already."""
        keys = list(params)
        step = self._scale(keys, _clip_and_decay(self, params, keys, grads, norm), state)
        torch._foreach_add_([params[k] for k in keys], step, alpha=-self.learning_rate)

    def _scale(self, keys, g, state: AdamState):
        """optax's ``scale_by_adam`` of the gradients ``g``: the moments'
        update (in place on ``state``) and the bias-corrected direction."""
        mu = [state.mu[k] for k in keys]
        nu = [state.nu[k] for k in keys]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        state.count += 1
        mu_hat = torch._foreach_div(mu, 1.0 - self.b1**state.count)
        nu_hat = torch._foreach_div(nu, 1.0 - self.b2**state.count)
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(mu_hat, denom)
        return mu_hat


class AdamW(Adam):
    """optax.adamw, optionally behind a global-norm clip: the decay is
    added to the Adam direction, not to the gradient.  The learning rate
    stays settable between steps (``learning_rate``), as optax's
    ``inject_hyperparams`` has it in the JAX package.  :func:`build_optimizer`
    gives it optax's default ``weight_decay`` of 1e-4 where the config
    names none."""

    @torch.no_grad()
    def update(
        self,
        params: Dict[str, torch.Tensor],
        grads: Dict[str, torch.Tensor],
        state: AdamState,
        norm: Optional[torch.Tensor] = None,
    ) -> None:
        """One step, in place on ``params`` and ``state``."""
        keys = list(params)
        weights = [params[k] for k in keys]
        step = self._scale(keys, _clip(self, keys, grads, norm), state)
        if self.weight_decay:
            torch._foreach_add_(step, weights, alpha=self.weight_decay)
        torch._foreach_add_(weights, step, alpha=-self.learning_rate)


@dataclass
class RMSpropState:
    """optax ``ScaleByRmsState`` over named parameters."""

    nu: Dict[str, torch.Tensor] = field(default_factory=dict)


class RMSprop:
    """optax.rmsprop (not centred, no momentum), optionally behind a
    global-norm clip and weight decay."""

    def __init__(
        self,
        learning_rate: float,
        decay: float = 0.9,
        eps: float = 1e-8,
        momentum: Optional[float] = None,
        centered: bool = False,
        max_grad_norm: Optional[float] = None,
        weight_decay: float = 0.0,
    ):
        if centered or momentum:
            raise NotImplementedError("optax.rmsprop with centered=True or momentum > 0 is not ported yet")
        self.learning_rate = float(learning_rate)
        self.decay = float(decay)
        self.eps = float(eps)
        self.max_grad_norm = None if not max_grad_norm or max_grad_norm <= 0 else float(max_grad_norm)
        self.weight_decay = float(weight_decay)

    def init(self, params: Dict[str, torch.Tensor]) -> RMSpropState:
        return RMSpropState({k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def update(
        self,
        params: Dict[str, torch.Tensor],
        grads: Dict[str, torch.Tensor],
        state: RMSpropState,
        norm: Optional[torch.Tensor] = None,
    ) -> None:
        """One step, in place on ``params`` and ``state``."""
        keys = list(params)
        g = _clip_and_decay(self, params, keys, grads, norm)
        nu = [state.nu[k] for k in keys]
        torch._foreach_mul_(nu, self.decay)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.decay)
        scale = torch._foreach_add(nu, self.eps)
        torch._foreach_rsqrt_(scale)
        torch._foreach_mul_(scale, g)
        torch._foreach_add_([params[k] for k in keys], scale, alpha=-self.learning_rate)


_OPTIMIZERS = {"optax.adam": Adam, "optax.adamw": AdamW, "optax.rmsprop": RMSprop}


def finalize_optimizer(
    tx_kwargs: dict, weight_decay: float, max_grad_norm: Optional[float], precision: str, cls=Adam
):
    """The shared tail of every optimizer build: clip, weight decay,
    precision (``optim/__init__.py:finalize_optimizer``)."""
    if precision == "bf16-true":
        raise NotImplementedError(
            "fabric.precision=bf16-true (f32 master weights) is not ported yet; use 32-true or bf16-mixed"
        )
    return cls(**tx_kwargs, max_grad_norm=max_grad_norm, weight_decay=weight_decay)


def build_optimizer(optim_cfg: dict, max_grad_norm: Optional[float] = None, precision: str = "32-true"):
    """An optimizer from a ``_target_`` config node: ``optax.adam`` is the
    port's :class:`Adam`, ``optax.adamw`` its :class:`AdamW`,
    ``optax.rmsprop`` its :class:`RMSprop`; any other target raises."""
    cfg = dict(optim_cfg)
    target = cfg.pop("_target_")
    if target not in _OPTIMIZERS:
        raise NotImplementedError(f"optimizer '{target}' is not ported yet; the port has {sorted(_OPTIMIZERS)}")
    kwargs = {}
    betas = cfg.pop("betas", None)
    if betas is not None:
        kwargs["b1"], kwargs["b2"] = betas
    for k, v in cfg.items():
        kwargs[_RENAMES.get(k, k)] = float(v) if isinstance(v, str) else v
    default_decay = 1e-4 if target == "optax.adamw" else 0.0
    weight_decay = float(kwargs.pop("weight_decay", default_decay) or 0.0)
    return finalize_optimizer(kwargs, weight_decay, max_grad_norm, precision, _OPTIMIZERS[target])
