"""Carry the JAX package's DreamerV3 player weights into the port's modules.

``flax_to_torch(tree, agent)`` turns the ``{"world_model": ..., "actor": ...}``
parameter tree of ``sheeprl_tpu`` (numpy arrays, as a checkpoint holds them)
into the ``state_dict`` of :class:`~sheeprl_tpu_torch.algos.dreamer_v3.agent.DreamerPlayer`:

- Dense ``kernel`` (in, out) -> ``nn.Linear.weight`` (out, in);
- Conv ``kernel`` HWIO -> ``nn.Conv2d.weight`` OIHW;
- LayerNorm ``scale``/``bias`` -> ``weight``/``bias``;
- ``initial_recurrent_state`` carries over;
- the GRU's ``Dense_0/kernel`` stays (H + X, 3H), the layout the kernel reads.

The world model's decoder and reward/continue heads are not served and are
skipped; every other leaf must find its place and every entry of the
``state_dict`` must be filled, or :class:`ConversionError` is raised.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

__all__ = ["ConversionError", "flax_to_torch", "flatten_tree", "load_flax_params"]

# world-model subtrees of the JAX tree that the player does not run
UNSERVED = ("observation_model", "reward_model", "continue_model")


class ConversionError(ValueError):
    pass


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """``{"a/b/c": leaf}`` over nested dicts."""
    if isinstance(tree, dict):
        out: Dict[str, np.ndarray] = {}
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: np.asarray(tree)}


class _Mapper:
    def __init__(self, flat: Dict[str, np.ndarray]):
        self.flat = flat
        self.used = set()
        self.out: Dict[str, torch.Tensor] = {}

    def take(self, path: str) -> np.ndarray:
        if path not in self.flat:
            raise ConversionError(f"missing flax leaf {path!r}")
        self.used.add(path)
        return self.flat[path]

    def has(self, path: str) -> bool:
        return path in self.flat

    def put(self, key: str, arr: np.ndarray) -> None:
        self.out[key] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))

    def dense(self, src: str, dst: str) -> None:
        self.put(f"{dst}.weight", self.take(f"{src}/kernel").T)
        if self.has(f"{src}/bias"):
            self.put(f"{dst}.bias", self.take(f"{src}/bias"))

    def norm(self, src: str, dst: str) -> None:
        self.put(f"{dst}.weight", self.take(f"{src}/scale"))
        self.put(f"{dst}.bias", self.take(f"{src}/bias"))

    def linear_ln_act(self, src: str, dst: str) -> None:
        self.dense(f"{src}/Dense_0", f"{dst}.dense")
        if self.has(f"{src}/LayerNorm_0/scale"):
            self.norm(f"{src}/LayerNorm_0", f"{dst}.norm")

    def mlp(self, src: str, dst: str, layers: int, head: bool) -> None:
        for i in range(layers):
            self.linear_ln_act(f"{src}/LinearLnAct_{i}", f"{dst}.layers.{i}")
        if head:
            self.dense(f"{src}/Dense_0", f"{dst}.head")


def flax_to_torch(tree: Dict[str, Any], agent: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` for ``agent`` (a ``DreamerPlayer``) from the JAX
    player tree ``{"world_model": {"encoder", "rssm", ...}, "actor"}``."""
    if set(tree) != {"world_model", "actor"}:
        raise ConversionError(f"expected keys world_model and actor, got {sorted(tree)}")
    wm_tree = {k: v for k, v in tree["world_model"].items() if k not in UNSERVED}
    flat = flatten_tree({"world_model": wm_tree, "actor": tree["actor"]})
    m = _Mapper(flat)
    wm = agent.world_model

    enc = "world_model/encoder/params"
    if wm.encoder.cnn_encoder is not None:
        for i in range(len(wm.encoder.cnn_encoder.convs)):
            dst = f"world_model.encoder.cnn_encoder.convs.{i}"
            m.put(f"{dst}.weight", m.take(f"{enc}/cnn_encoder/Conv_{i}/kernel").transpose(3, 2, 0, 1))
            if m.has(f"{enc}/cnn_encoder/Conv_{i}/bias"):
                m.put(f"{dst}.bias", m.take(f"{enc}/cnn_encoder/Conv_{i}/bias"))
            if wm.encoder.cnn_encoder.norms is not None:
                m.norm(f"{enc}/cnn_encoder/LayerNorm_{i}", f"world_model.encoder.cnn_encoder.norms.{i}")
    if wm.encoder.mlp_encoder is not None:
        m.mlp(
            f"{enc}/mlp_encoder/DreamerMLP_0", "world_model.encoder.mlp_encoder.mlp",
            len(wm.encoder.mlp_encoder.mlp.layers), head=False,
        )

    rssm = "world_model/rssm/params"
    m.put("world_model.rssm.initial_recurrent_state", m.take(f"{rssm}/initial_recurrent_state"))
    m.linear_ln_act(f"{rssm}/recurrent_model/LinearLnAct_0", "world_model.rssm.recurrent_model.mlp")
    m.put("world_model.rssm.recurrent_model.gru.weight", m.take(f"{rssm}/recurrent_model/LayerNormGRUCell_0/Dense_0/kernel"))
    m.norm(f"{rssm}/recurrent_model/LayerNormGRUCell_0/LayerNorm_0", "world_model.rssm.recurrent_model.gru.norm")
    m.mlp(f"{rssm}/representation_model", "world_model.rssm.representation_model", 1, head=True)
    m.mlp(f"{rssm}/transition_model", "world_model.rssm.transition_model", 1, head=True)

    m.mlp("actor/params", "actor.trunk", len(agent.actor.trunk.layers), head=False)
    for i in range(len(agent.actor.heads)):
        m.dense(f"actor/params/Dense_{i}", f"actor.heads.{i}")

    unknown = sorted(set(flat) - m.used)
    if unknown:
        raise ConversionError(f"flax leaves with no place in the port: {unknown[:8]}")
    want = agent.state_dict()
    missing = sorted(set(want) - set(m.out))
    if missing:
        raise ConversionError(f"port parameters the tree does not fill: {missing[:8]}")
    for k, v in m.out.items():
        if k not in want:
            raise ConversionError(f"no port parameter {k!r}")
        if tuple(want[k].shape) != tuple(v.shape):
            raise ConversionError(f"{k}: flax gives {tuple(v.shape)}, the port holds {tuple(want[k].shape)}")
    return m.out


def load_flax_params(agent: torch.nn.Module, tree: Dict[str, Any]) -> torch.nn.Module:
    """Convert ``tree`` and load it into ``agent`` (on the agent's device)."""
    agent.load_state_dict(flax_to_torch(tree, agent), strict=True)
    return agent
