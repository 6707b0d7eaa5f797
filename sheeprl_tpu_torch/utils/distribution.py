"""The distributions DreamerV3 samples from and trains on, on torch tensors.

Counterpart of the matching classes of ``sheeprl_tpu/utils/distribution.py``
(Normal, Independent, TanhNormal, OneHotCategorical,
OneHotCategoricalStraightThrough, Bernoulli, BernoulliSafeMode,
SymlogDistribution, MSEDistribution, TwoHotEncodingDistribution and
``kl_divergence``).  Sampling never uses the global RNG: it
takes explicit noise (standard normals, or Gumbel noise for the categorical
draws) or an explicit ``torch.Generator``.  A categorical draw is
``argmax(normalized_logits + gumbel)``, the same Gumbel-max form that
``jax.random.categorical`` uses, so both packages agree when they are handed
the same noise.  Straight-through values are ``(hard + p) - p``, the order
in which the JAX package's ``sg(hard) + p - sg(p)`` evaluates.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from sheeprl_tpu_torch.utils.utils import symexp, symlog, two_hot_encoder

__all__ = [
    "Bernoulli",
    "BernoulliSafeMode",
    "Categorical",
    "Independent",
    "MSEDistribution",
    "Normal",
    "OneHotCategorical",
    "OneHotCategoricalStraightThrough",
    "SymlogDistribution",
    "TanhNormal",
    "TwoHotEncodingDistribution",
    "gumbel_noise",
    "kl_divergence",
    "normal_noise",
    "straight_through",
]

_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def gumbel_noise(shape, *, like: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Standard Gumbel noise, ``-log(-log(u))`` with ``u`` in [tiny, 1)."""
    tiny = torch.finfo(like.dtype).tiny
    u = torch.rand(shape, generator=generator, device=like.device, dtype=like.dtype)
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def normal_noise(shape, *, like: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=like.device, dtype=like.dtype)


class Normal:
    def __init__(self, loc: torch.Tensor, scale: torch.Tensor):
        self.loc = loc
        self.scale = scale

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        var = self.scale**2
        return -((x - self.loc) ** 2) / (2 * var) - torch.log(self.scale) - _HALF_LOG_2PI

    def rsample(self, noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None):
        shape = torch.broadcast_shapes(self.loc.shape, self.scale.shape)
        eps = noise if noise is not None else normal_noise(shape, like=self.loc, generator=generator)
        return self.loc + eps * self.scale

    @property
    def mode(self) -> torch.Tensor:
        return self.loc

    @property
    def mean(self) -> torch.Tensor:
        return self.loc

    def entropy(self) -> torch.Tensor:
        return 0.5 + _HALF_LOG_2PI + torch.log(self.scale)


class Independent:
    """Sums log_prob/entropy over the last ``reinterpreted_batch_ndims`` dims."""

    def __init__(self, base, reinterpreted_batch_ndims: int = 1):
        self.base = base
        self.ndims = reinterpreted_batch_ndims

    def _reduce(self, x: torch.Tensor) -> torch.Tensor:
        if self.ndims == 0:
            return x
        return x.sum(dim=tuple(range(-self.ndims, 0)))

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(self.base.log_prob(x))

    def rsample(self, noise=None, generator=None):
        return self.base.rsample(noise, generator)

    @property
    def mode(self):
        return self.base.mode

    @property
    def mean(self):
        return self.base.mean

    def entropy(self) -> torch.Tensor:
        return self._reduce(self.base.entropy())


class TanhNormal:
    """tanh-squashed diagonal Normal."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
        self.base = Normal(loc, scale)
        self.eps = eps

    def log_prob(self, y: torch.Tensor) -> torch.Tensor:
        x = torch.atanh(torch.clamp(y, -1.0 + self.eps, 1.0 - self.eps))
        log_det = 2.0 * (math.log(2.0) - x - F.softplus(-2.0 * x))
        return self.base.log_prob(x) - log_det

    def rsample(self, noise=None, generator=None):
        return torch.tanh(self.base.rsample(noise, generator))

    @property
    def mode(self):
        return torch.tanh(self.base.loc)

    @property
    def mean(self):
        return torch.tanh(self.base.loc)


class Categorical:
    def __init__(self, logits: Optional[torch.Tensor] = None, probs: Optional[torch.Tensor] = None):
        if logits is None:
            logits = torch.log(torch.clamp(probs, min=1e-10))
        self.logits = logits - torch.logsumexp(logits, dim=-1, keepdim=True)

    @property
    def probs(self) -> torch.Tensor:
        return torch.softmax(self.logits, dim=-1)

    def sample(self, noise: Optional[torch.Tensor] = None, generator=None) -> torch.Tensor:
        g = noise if noise is not None else gumbel_noise(self.logits.shape, like=self.logits, generator=generator)
        return torch.argmax(self.logits + g, dim=-1)

    @property
    def mode(self) -> torch.Tensor:
        return torch.argmax(self.logits, dim=-1)

    def entropy(self) -> torch.Tensor:
        return -(self.probs * self.logits).sum(-1)


class OneHotCategorical:
    def __init__(self, logits: Optional[torch.Tensor] = None, probs: Optional[torch.Tensor] = None):
        self._cat = Categorical(logits=logits, probs=probs)

    @property
    def logits(self) -> torch.Tensor:
        return self._cat.logits

    @property
    def probs(self) -> torch.Tensor:
        return self._cat.probs

    def _one_hot(self, idx: torch.Tensor) -> torch.Tensor:
        return F.one_hot(idx, self.logits.shape[-1]).to(self.logits.dtype)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return (self._cat.logits * x).sum(-1)

    def sample(self, noise: Optional[torch.Tensor] = None, generator=None) -> torch.Tensor:
        return self._one_hot(self._cat.sample(noise, generator))

    @property
    def mode(self) -> torch.Tensor:
        return self._one_hot(self._cat.mode)

    @property
    def mean(self) -> torch.Tensor:
        return self.probs

    def entropy(self) -> torch.Tensor:
        return self._cat.entropy()


class OneHotCategoricalStraightThrough(OneHotCategorical):
    """One-hot samples whose gradient flows to ``probs``."""

    def rsample(self, noise: Optional[torch.Tensor] = None, generator=None) -> torch.Tensor:
        return straight_through(self.sample(noise, generator), self.probs)


def straight_through(hard: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``sg(hard) + p - sg(p)`` in the JAX evaluation order: the value is
    ``(hard + p) - p`` and the gradient flows to ``p``."""
    return (hard + p) - p.detach()


class Bernoulli:
    def __init__(self, logits: Optional[torch.Tensor] = None, probs: Optional[torch.Tensor] = None):
        if logits is None:
            logits = torch.log(torch.clamp(probs, min=1e-10)) - torch.log(torch.clamp(1 - probs, min=1e-10))
        self.logits = logits

    @property
    def probs(self) -> torch.Tensor:
        return torch.sigmoid(self.logits)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        # -BCEWithLogits
        return x * F.logsigmoid(self.logits) + (1 - x) * F.logsigmoid(-self.logits)

    @property
    def mean(self) -> torch.Tensor:
        return self.probs

    def entropy(self) -> torch.Tensor:
        p = self.probs
        return -(p * F.logsigmoid(self.logits) + (1 - p) * F.logsigmoid(-self.logits))


class BernoulliSafeMode(Bernoulli):
    """Bernoulli whose mode is the ``p > 0.5`` indicator (the continue head)."""

    @property
    def mode(self) -> torch.Tensor:
        return (self.probs > 0.5).to(self.logits.dtype)


def _agg(distance: torch.Tensor, dims: tuple, agg: str) -> torch.Tensor:
    if not dims:
        return distance
    return distance.mean(dims) if agg == "mean" else distance.sum(dims)


class SymlogDistribution:
    """log_prob is ``-(mode - symlog(x))^2`` summed over the event dims."""

    def __init__(self, mode: torch.Tensor, dims: int = 1, agg: str = "sum"):
        self._mode = mode
        self._dims = tuple(range(-dims, 0)) if dims else ()
        self._agg = agg

    @property
    def mode(self) -> torch.Tensor:
        return symexp(self._mode)

    @property
    def mean(self) -> torch.Tensor:
        return symexp(self._mode)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return _agg(-((self._mode - symlog(value)) ** 2), self._dims, self._agg)


class MSEDistribution:
    """log_prob is ``-(mode - x)^2`` summed over the event dims."""

    def __init__(self, mode: torch.Tensor, dims: int = 1, agg: str = "sum"):
        self._mode = mode
        self._dims = tuple(range(-dims, 0)) if dims else ()
        self._agg = agg

    @property
    def mode(self) -> torch.Tensor:
        return self._mode

    @property
    def mean(self) -> torch.Tensor:
        return self._mode

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return _agg(-((self._mode - value) ** 2), self._dims, self._agg)


class TwoHotEncodingDistribution:
    """Two-hot categorical over an evenly spaced support in symlog space:
    the reward and critic heads (255 bins over [-20, 20])."""

    def __init__(self, logits: torch.Tensor, dims: int = 1, low: float = -20.0, high: float = 20.0):
        self._raw_logits = logits
        self._dims = tuple(range(-dims, 0))
        self.bins = torch.linspace(low, high, logits.shape[-1], device=logits.device, dtype=logits.dtype)
        self.low, self.high = low, high

    @property
    def logits(self) -> torch.Tensor:
        return self._raw_logits - torch.logsumexp(self._raw_logits, -1, keepdim=True)

    @property
    def probs(self) -> torch.Tensor:
        return torch.softmax(self._raw_logits, -1)

    @property
    def mean(self) -> torch.Tensor:
        return symexp((self.probs * self.bins).sum(-1, keepdim=True))

    @property
    def mode(self) -> torch.Tensor:
        return self.mean

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., 1) raw-space scalars; (...,) summed over the event dims."""
        target = two_hot_encoder(symlog(x), support_range=int(self.high), num_buckets=self.bins.shape[0])
        return (target * self.logits).sum(-1, keepdim=True).sum(self._dims)


def kl_divergence(p, q) -> torch.Tensor:
    """KL(p || q) for the pairs the algorithms need."""
    if isinstance(p, Independent) and isinstance(q, Independent):
        base = kl_divergence(p.base, q.base)
        return base.sum(dim=tuple(range(-p.ndims, 0))) if p.ndims else base
    if isinstance(p, (OneHotCategorical, Categorical)) and isinstance(q, (OneHotCategorical, Categorical)):
        pl, ql = p.logits, q.logits
        return (torch.softmax(pl, -1) * (pl - ql)).sum(-1)
    if isinstance(p, Normal) and isinstance(q, Normal):
        var_ratio = (p.scale / q.scale) ** 2
        t1 = ((p.loc - q.loc) / q.scale) ** 2
        return 0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio))
    raise NotImplementedError(f"KL({type(p).__name__} || {type(q).__name__})")
