"""Carry the JAX package's DreamerV3, Plan2Explore-DreamerV3, DreamerV2,
DreamerV1, SAC, DroQ and PPO/A2C state into the port's modules, and back.

``flax_to_torch(tree, agent)`` turns a parameter tree of ``sheeprl_tpu``
(numpy arrays, as a checkpoint holds them) into a ``state_dict``:

- for a :class:`~sheeprl_tpu_torch.algos.dreamer_v3.agent.DreamerPlayer`,
  the player tree ``{"world_model": ..., "actor": ...}``; the world model's
  decoder and reward/continue heads are not served and are skipped;
- for a :class:`~sheeprl_tpu_torch.algos.dreamer_v3.agent.DreamerAgent`,
  the whole ``params`` tree ``{"world_model", "actor", "critic",
  "target_critic"}``;
- for a DreamerV2 or DreamerV1 agent (DreamerV3's containers around
  blocks that name their layout, ``flax_layout``; :func:`layout`), the same
  trees in their layouts: ``V2MLP_0`` and ``DenseActLn_<i>`` trunks with
  their biases, VALID convs, DreamerV2's GRU cell with its ``Dense_0/bias``,
  DreamerV1's ``recurrent_model/Dense_0`` and flax ``GRUCell_0`` (its
  ``ir``/``iz``/``in`` and ``hr``/``hz``/``hn`` leaves side by side as the
  port's gate blocks), a continue model only with ``use_continues``, and no
  ``target_critic`` for DreamerV1;
- for a :class:`~sheeprl_tpu_torch.algos.sac.agent.SACAgent`, the SAC tree
  ``{"actor", "critic", "target_critic", "log_alpha"}``: the actor's
  ``MLP_0/Dense_{0,1}`` trunk and ``Dense_{0,1}`` mean/log-std heads, the
  stacked critics' ``MLP_0/Dense_i`` kernels (N, in, out) and biases
  (N, out) kept as they are (the layout the batched critic reads), and
  DroQ's stacked ``MLP_0/LayerNorm_i`` scales and biases (N, hidden);
- for a :class:`~sheeprl_tpu_torch.algos.p2e_dv3.agent.P2EDV3Agent`, the
  tree ``{"world_model", "actor_task", "critic_task", "target_critic_task",
  "actor_exploration", "critics_exploration": {name: {"module",
  "target_module"}}, "ensembles"}`` (:data:`P2E_KEYS`, an exploration
  checkpoint's), the ensembles' vmapped ``LinearLnAct_<i>`` and head leaves
  with their leading member axis kept;
- for a :class:`~sheeprl_tpu_torch.algos.ppo.agent.PPOAgentModule` (PPO
  and A2C), the flax variables ``{"params": {"feature_extractor":
  {"mlp_encoder": {"MLP_0": ...}}, "critic", "actor_backbone",
  "actor_heads_<i>"}}``, each MLP's ``Dense_<i>`` (and ``LayerNorm_<i>``)
  hidden layers and its ``Dense_<n>`` head;
- for a :class:`~sheeprl_tpu_torch.algos.ppo_recurrent.agent.RecurrentPPOAgentModule`,
  the same plus ``params/rnn``: ``Scan_ResetLSTMCell_0/OptimizedLSTMCell_0``
  with the input kernels ``ii, if, ig, io`` (no bias) side by side as the
  port's ``input_kernel`` (in, 4H), the recurrent kernels ``hi, hf, hg, ho``
  as ``hidden_kernel`` (H, 4H) and their biases as ``hidden_bias`` (4H);
  and the dense layers, ``MLP_0`` the pre-RNN one where it applies, else
  the post-RNN one, ``MLP_1`` the post-RNN one when both apply.

:func:`torch_to_flax` is the inverse for the PPO family, which the port's
checkpoints write, so that the JAX package's ``build_agent`` reads their
``"agent"``.

Layouts:

- Dense ``kernel`` (in, out) -> ``nn.Linear.weight`` (out, in);
- Conv ``kernel`` HWIO -> ``nn.Conv2d.weight`` OIHW;
- ConvTranspose ``kernel`` (kh, kw, in, out) -> ``ConvTranspose2d.weight``
  (in, out, kh, kw) flipped in both spatial axes (flax does not flip its
  transposed-convolution kernel; ``torch`` does);
- LayerNorm ``scale``/``bias`` -> ``weight``/``bias``;
- ``initial_recurrent_state`` carries over;
- the GRU's ``Dense_0/kernel`` stays (H + X, 3H), the layout the kernel reads.

Every leaf must find its place and every entry of the ``state_dict`` must
be filled, or :class:`ConversionError` is raised.  :func:`opt_state_to_torch`
carries an optax ``clip_by_global_norm`` + ``adam`` state (count, mu, nu)
into the port's :class:`~sheeprl_tpu_torch.optim.AdamState` through the
same mapping (for SAC the groups ``actor``, ``critic`` and ``alpha``), and
:func:`moments_to_torch` the Moments state.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

__all__ = [
    "ConversionError",
    "adam_state_from_checkpoint",
    "adam_state_from_tree",
    "adam_state_to_tree",
    "flatten_tree",
    "flax_to_torch",
    "group_to_flax",
    "layout",
    "load_flax_params",
    "load_group_params",
    "moments_to_torch",
    "opt_state_from_tree",
    "opt_state_to_torch",
    "opt_state_to_tree",
    "load_p2e_state",
    "p2e_state",
    "torch_to_flax",
    "unflatten_tree",
]

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


def unflatten_tree(flat: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`flatten_tree`."""
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = out
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


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
        if key in self.out:
            raise ConversionError(f"two leaves map to {key!r}")
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

    def mlp(self, src: str, dst: str, layers: int, head: bool, block: str = "LinearLnAct") -> None:
        """DreamerV3's ``DreamerMLP`` (``block`` LinearLnAct) or DreamerV2's
        ``V2MLP`` (DenseActLn)."""
        for i in range(layers):
            self.linear_ln_act(f"{src}/{block}_{i}", f"{dst}.layers.{i}")
        if head:
            self.dense(f"{src}/Dense_0", f"{dst}.head")

    def gates(self, srcs, dst: str) -> None:
        """Flax's per-gate leaves ``srcs`` side by side on the last axis."""
        self.put(dst, np.concatenate([self.take(src) for src in srcs], -1))


def layout(module: torch.nn.Module) -> str:
    """Which package's tree ``module`` maps to: ``"dreamer_v1"`` or
    ``"dreamer_v2"`` where it holds their blocks (each marks itself with
    ``flax_layout``), else ``"dreamer_v3"``."""
    kinds = {getattr(sub, "flax_layout", None) for sub in module.modules()}
    return "dreamer_v1" if "dreamer_v1" in kinds else "dreamer_v2" if "dreamer_v2" in kinds else "dreamer_v3"


def _conv_stack(m: _Mapper, src: str, dst: str, n: int, norms, kind: str) -> None:
    """``n`` flax ``Conv_<i>`` (HWIO) or ``ConvTranspose_<i>`` ((kh, kw, in,
    out), flipped for torch) kernels, their biases and ``LayerNorm_<i>``."""
    attr = "convs" if kind == "Conv" else "deconvs"
    for i in range(n):
        kernel = m.take(f"{src}/{kind}_{i}/kernel")
        kernel = kernel.transpose(3, 2, 0, 1) if kind == "Conv" else kernel[::-1, ::-1].transpose(2, 3, 0, 1)
        m.put(f"{dst}.{attr}.{i}.weight", kernel)
        if m.has(f"{src}/{kind}_{i}/bias"):
            m.put(f"{dst}.{attr}.{i}.bias", m.take(f"{src}/{kind}_{i}/bias"))
    for i in range(len(norms or ())):
        m.norm(f"{src}/LayerNorm_{i}", f"{dst}.norms.{i}")


def _trunk(module: torch.nn.Module) -> tuple:
    """The flax names of a Dreamer module's MLP trunks and their blocks:
    DreamerV3's ``DreamerMLP_0`` of ``LinearLnAct_<i>``, V2's and V1's
    ``V2MLP_0`` of ``DenseActLn_<i>``."""
    return ("DreamerMLP_0", "LinearLnAct") if layout(module) == "dreamer_v3" else ("V2MLP_0", "DenseActLn")


def _encoder_rssm(m: _Mapper, wm, src: str, dst: str) -> None:
    """The encoder (conv stages, the MLP trunk) and the RSSM: the recurrent
    model (DreamerV3: its learnable initial state, ``LinearLnAct_0`` and the
    bias-free ``LayerNormGRUCell_0``; V2: ``DenseActLn_0`` and the cell with
    its ``Dense_0/bias``; V1: ``Dense_0`` and flax's ``GRUCell_0``, its
    ``ir``/``iz``/``in`` and ``hr``/``hz``/``hn`` leaves side by side) and
    the one-layer representation and transition models."""
    trunk, block = _trunk(wm)
    enc = f"{src}/encoder/params"
    cnn = wm.encoder.cnn_encoder
    if cnn is not None:
        _conv_stack(m, f"{enc}/cnn_encoder", f"{dst}.encoder.cnn_encoder", len(cnn.convs), cnn.norms, "Conv")
    if wm.encoder.mlp_encoder is not None:
        m.mlp(f"{enc}/mlp_encoder/{trunk}", f"{dst}.encoder.mlp_encoder.mlp", len(wm.encoder.mlp_encoder.mlp.layers),
              head=False, block=block)
    rssm, out = f"{src}/rssm/params/", f"{dst}.rssm."
    if layout(wm) == "dreamer_v1":
        gru = f"{rssm}recurrent_model/GRUCell_0"
        m.dense(f"{rssm}recurrent_model/Dense_0", f"{out}recurrent_model.dense")
        m.gates([f"{gru}/i{g}/kernel" for g in "rzn"], f"{out}recurrent_model.gru.input_kernel")
        m.gates([f"{gru}/i{g}/bias" for g in "rzn"], f"{out}recurrent_model.gru.input_bias")
        m.gates([f"{gru}/h{g}/kernel" for g in "rzn"], f"{out}recurrent_model.gru.hidden_kernel")
        m.put(f"{out}recurrent_model.gru.hidden_bias", m.take(f"{gru}/hn/bias"))
    else:
        if layout(wm) == "dreamer_v3":
            m.put(f"{out}initial_recurrent_state", m.take(f"{rssm}initial_recurrent_state"))
        gru = f"{rssm}recurrent_model/LayerNormGRUCell_0"
        m.linear_ln_act(f"{rssm}recurrent_model/{block}_0", f"{out}recurrent_model.mlp")
        m.put(f"{out}recurrent_model.gru.weight", m.take(f"{gru}/Dense_0/kernel"))
        if m.has(f"{gru}/Dense_0/bias"):
            m.put(f"{out}recurrent_model.gru.bias", m.take(f"{gru}/Dense_0/bias"))
        m.norm(f"{gru}/LayerNorm_0", f"{out}recurrent_model.gru.norm")
    for name in ("representation_model", "transition_model"):
        m.mlp(f"{rssm}{name}", f"{out}{name}", 1, head=True, block=block)


def _training_heads(m: _Mapper, wm, src: str, dst: str) -> None:
    """The observation model (the conv decoder's dense and flipped
    transposed convs, the MLP trunk and ``Dense_<i>`` heads), the reward
    model and the continue model where the world model has one."""
    trunk, block = _trunk(wm)
    obs = f"{src}/observation_model/params"
    cnn = wm.observation_model.cnn_decoder
    if cnn is not None:
        out = f"{dst}.observation_model.cnn_decoder"
        m.dense(f"{obs}/cnn_decoder/Dense_0", f"{out}.dense")
        _conv_stack(m, f"{obs}/cnn_decoder", out, len(cnn.deconvs), cnn.norms, "ConvTranspose")
    mlp = wm.observation_model.mlp_decoder
    if mlp is not None:
        out = f"{dst}.observation_model.mlp_decoder"
        m.mlp(f"{obs}/mlp_decoder/{trunk}", f"{out}.mlp", len(mlp.mlp.layers), head=False, block=block)
        for i in range(len(mlp.heads)):
            m.dense(f"{obs}/mlp_decoder/Dense_{i}", f"{out}.heads.{i}")
    for name in ("reward_model", "continue_model"):
        if getattr(wm, name) is not None:
            m.mlp(f"{src}/{name}/params", f"{dst}.{name}", len(getattr(wm, name).layers), head=True, block=block)


def _actor(m: _Mapper, actor, src: str, dst: str) -> None:
    m.mlp(f"{src}/params", f"{dst}.trunk", len(actor.trunk.layers), head=False, block=_trunk(actor)[1])
    for i in range(len(actor.heads)):
        m.dense(f"{src}/params/Dense_{i}", f"{dst}.heads.{i}")


def _sac_actor(m: _Mapper, actor, src: str, dst: str) -> None:
    for i in range(len(actor.trunk.layers)):
        m.dense(f"{src}/params/MLP_0/Dense_{i}", f"{dst}.trunk.layers.{i}")
    m.dense(f"{src}/params/Dense_0", f"{dst}.mean")
    m.dense(f"{src}/params/Dense_1", f"{dst}.log_std")


def _sac_critic(m: _Mapper, critic, src: str, dst: str) -> None:
    """SAC's stacked critics, or DroQ's with their stacked ``LayerNorm_<i>``."""
    for i in range(len(critic.weights)):
        m.put(f"{dst}.weights.{i}", m.take(f"{src}/params/MLP_0/Dense_{i}/kernel"))
        m.put(f"{dst}.biases.{i}", m.take(f"{src}/params/MLP_0/Dense_{i}/bias"))
    for i in range(len(getattr(critic, "norm_weights", ()))):
        m.put(f"{dst}.norm_weights.{i}", m.take(f"{src}/params/MLP_0/LayerNorm_{i}/scale"))
        m.put(f"{dst}.norm_biases.{i}", m.take(f"{src}/params/MLP_0/LayerNorm_{i}/bias"))


def _stacked_mlp(m: _Mapper, mlp, src: str, dst: str) -> None:
    """A vmapped flax DreamerMLP (``LinearLnAct_<i>/Dense_0``, ``LayerNorm_0``
    or a bias, head ``Dense_0``, every leaf with a leading member axis) as a
    :class:`~sheeprl_tpu_torch.algos.p2e_dv3.agent.StackedDreamerMLP`."""
    for i in range(len(mlp.weights)):
        m.put(f"{dst}.weights.{i}", m.take(f"{src}/LinearLnAct_{i}/Dense_0/kernel"))
        if mlp.layer_norm:
            m.put(f"{dst}.norm_weights.{i}", m.take(f"{src}/LinearLnAct_{i}/LayerNorm_0/scale"))
            m.put(f"{dst}.norm_biases.{i}", m.take(f"{src}/LinearLnAct_{i}/LayerNorm_0/bias"))
        else:
            m.put(f"{dst}.biases.{i}", m.take(f"{src}/LinearLnAct_{i}/Dense_0/bias"))
    m.put(f"{dst}.head_weight", m.take(f"{src}/Dense_0/kernel"))
    m.put(f"{dst}.head_bias", m.take(f"{src}/Dense_0/bias"))


class _Ref:
    """A flax leaf as a mapping takes it: its path and the layout operations
    (``.T``, ``.transpose``, a flip) applied on the way to the port."""

    def __init__(self, path: str, ops: tuple = ()):
        self.path, self.ops = path, ops

    @property
    def T(self) -> "_Ref":
        return _Ref(self.path, self.ops + (("transpose", None),))

    def transpose(self, *axes) -> "_Ref":
        return _Ref(self.path, self.ops + (("transpose", axes),))

    def __getitem__(self, index) -> "_Ref":
        return _Ref(self.path, self.ops + (("flip", index),))


class _Inverse(_Mapper):
    """Runs a flax-to-port mapping backwards over port tensors: every
    ``put(key, take(path)...)`` writes ``tensors[key]`` to ``path`` through
    the inverse layout operations.  A leaf the port does not hold (a bias,
    a LayerNorm) is left out of the tree, as the JAX modules leave it out."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        super().__init__({})
        self.tensors = tensors

    def take(self, path: str) -> _Ref:
        return _Ref(path)

    def has(self, path: str) -> bool:
        return True

    def put(self, key: str, ref: _Ref) -> None:
        if key not in self.tensors:
            return
        arr = self.tensors[key].detach().to("cpu", torch.float32).numpy()
        for op, arg in reversed(ref.ops):
            if op == "transpose":
                arr = arr.T if arg is None else arr.transpose(np.argsort(arg))
            else:  # a flip is its own inverse
                arr = arr[arg]
        if ref.path in self.flat:
            raise ConversionError(f"two port tensors map to {ref.path!r}")
        self.flat[ref.path] = np.ascontiguousarray(arr)
        self.used.add(key)

    def gates(self, srcs, dst: str) -> None:
        if dst not in self.tensors:
            return
        arr = self.tensors[dst].detach().to("cpu", torch.float32).numpy()
        for src, part in zip(srcs, np.split(arr, len(srcs), axis=-1)):
            self.flat[src] = np.ascontiguousarray(part)
        self.used.add(dst)

    def tree(self) -> Dict[str, Any]:
        unused = sorted(set(self.tensors) - self.used)
        if unused:
            raise ConversionError(f"port tensors with no place in the flax tree: {unused[:8]}")
        return unflatten_tree(self.flat)


def _flax_mlp(m, src: str, dst: str, mlp: torch.nn.Module) -> None:
    """A ``models.MLP``: hidden ``Dense_<i>`` (+ ``LayerNorm_<i>``), then
    the head ``Dense_<n>``."""
    n = len(mlp.layers)
    for i in range(n):
        m.dense(f"{src}/Dense_{i}", f"{dst}.layers.{i}")
        if not isinstance(mlp.norms[i], torch.nn.Identity):
            m.norm(f"{src}/LayerNorm_{i}", f"{dst}.norms.{i}")
    if mlp.head is not None:
        m.dense(f"{src}/Dense_{n}", f"{dst}.head")


_LSTM = "params/rnn/Scan_ResetLSTMCell_0/OptimizedLSTMCell_0"
_GATES = "ifgo"  # flax's gate order, the port's column blocks


def _rnn(m, rnn: torch.nn.Module) -> None:
    """Recurrent PPO's ``RecurrentModel``: the LSTM's gate leaves and the
    dense layers' ``MLP_<i>`` (numbered in the order flax creates them)."""
    m.gates([f"{_LSTM}/i{g}/kernel" for g in _GATES], "rnn.lstm.input_kernel")
    m.gates([f"{_LSTM}/h{g}/kernel" for g in _GATES], "rnn.lstm.hidden_kernel")
    m.gates([f"{_LSTM}/h{g}/bias" for g in _GATES], "rnn.lstm.hidden_bias")
    dense = [name for name in ("pre", "post") if getattr(rnn, name) is not None]
    for i, name in enumerate(dense):
        _flax_mlp(m, f"params/rnn/MLP_{i}", f"rnn.{name}", getattr(rnn, name))


def _ppo(m, agent: torch.nn.Module) -> None:
    _flax_mlp(m, "params/feature_extractor/mlp_encoder/MLP_0", "feature_extractor.mlp_encoder.mlp",
              agent.feature_extractor.mlp_encoder.mlp)
    if hasattr(agent, "rnn"):
        _rnn(m, agent.rnn)
    _flax_mlp(m, "params/critic", "critic", agent.critic)
    _flax_mlp(m, "params/actor_backbone", "actor_backbone", agent.actor_backbone)
    for i in range(len(agent.actor_heads)):
        m.dense(f"params/actor_heads_{i}", f"actor_heads.{i}")


def _is_ppo(agent: torch.nn.Module) -> bool:
    return hasattr(agent, "actor_backbone")


def torch_to_flax(agent: torch.nn.Module, tensors: Dict[str, torch.Tensor] = None) -> Dict[str, Any]:
    """The inverse of :func:`flax_to_torch`: the JAX package's tree (numpy
    f32) from ``agent``'s parameters, or from ``tensors`` keyed as its
    ``state_dict`` (an Adam moment, say)."""
    m = _Inverse(agent.state_dict() if tensors is None else tensors)
    if _is_ppo(agent):
        _ppo(m, agent)
    else:
        _map_agent(m, agent)
    return m.tree()


def _is_sac(agent: torch.nn.Module) -> bool:
    return hasattr(agent, "log_alpha")


def _finish(m: _Mapper, want: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    unknown = sorted(set(m.flat) - m.used)
    if unknown:
        raise ConversionError(f"flax leaves with no place in the port: {unknown[:8]}")
    missing = sorted(set(want) - set(m.out))
    if missing:
        raise ConversionError(f"port parameters the tree does not fill: {missing[:8]}")
    for k, v in m.out.items():
        if k not in want:
            raise ConversionError(f"no port parameter {k!r}")
        if tuple(want[k].shape) != tuple(v.shape):
            raise ConversionError(f"{k}: flax gives {tuple(v.shape)}, the port holds {tuple(want[k].shape)}")
    return m.out


def _is_full_agent(agent: torch.nn.Module) -> bool:
    return hasattr(agent, "critic")


def _critics(agent: torch.nn.Module) -> tuple:
    """The agent's critic and, where it keeps one (not DreamerV1), its target critic."""
    return ("critic", "target_critic") if hasattr(agent, "target_critic") else ("critic",)


def flax_to_torch(tree: Dict[str, Any], agent: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` for ``agent`` (a ``DreamerPlayer``, a
    ``DreamerAgent``, a ``P2EDV3Agent``, a ``SACAgent`` or a
    ``PPOAgentModule``) from the JAX tree described in the module
    docstring."""
    if _is_ppo(agent):
        if set(tree) != {"params"}:
            raise ConversionError(f"expected keys ['params'], got {sorted(tree)}")
        m = _Mapper(flatten_tree(tree))
        _ppo(m, agent)
        return _finish(m, agent.state_dict())
    if _is_p2e(agent):
        expect = set(P2E_KEYS)
    elif _is_sac(agent):
        expect = {"actor", "critic", "target_critic", "log_alpha"}
    elif _is_full_agent(agent):
        expect = {"world_model", "actor", *_critics(agent)}
    else:
        expect = {"world_model", "actor"}
    if set(tree) != expect:
        raise ConversionError(f"expected keys {sorted(expect)}, got {sorted(tree)}")
    if _is_full_agent(agent):
        flat = flatten_tree(tree)
    else:
        wm_tree = {k: v for k, v in tree["world_model"].items() if k not in UNSERVED}
        flat = flatten_tree({"world_model": wm_tree, "actor": tree["actor"]})
    m = _Mapper(flat)
    _map_agent(m, agent)
    return _finish(m, agent.state_dict())


# Plan2Explore-DreamerV3: the JAX tree's keys and the port's modules
P2E_KEYS = {"world_model": "world_model", "actor_task": "actor", "critic_task": "critic",
            "target_critic_task": "target_critic", "actor_exploration": "actor_exploration",
            "critics_exploration": "critics_exploration", "ensembles": "ensembles"}


def _is_p2e(agent: torch.nn.Module) -> bool:
    return hasattr(agent, "ensembles")


def _map_p2e(m, agent: torch.nn.Module) -> None:
    """The mapping of a P2E-DV3 agent (:data:`P2E_KEYS`)."""
    _encoder_rssm(m, agent.world_model, "world_model", "world_model")
    _training_heads(m, agent.world_model, "world_model", "world_model")
    for key in ("actor_task", "actor_exploration"):
        _actor(m, getattr(agent, P2E_KEYS[key]), key, P2E_KEYS[key])
    for key in ("critic_task", "target_critic_task"):
        m.mlp(f"{key}/params", P2E_KEYS[key], len(getattr(agent, P2E_KEYS[key]).layers), head=True)
    for name, pair in agent.critics_exploration.items():
        for sub in ("module", "target_module"):
            m.mlp(f"critics_exploration/{name}/{sub}/params", f"critics_exploration.{name}.{sub}",
                  len(pair[sub].layers), head=True)
    _stacked_mlp(m, agent.ensembles, "ensembles/params", "ensembles")


# the P2E-DV3 optimizer groups: the port's name, the JAX checkpoint's, the mapping that lays it out
P2E_OPT_GROUPS = (("world_model", "world_model", "world_model"), ("ensembles", "ensembles", "ensembles"),
                  ("actor", "actor_task", "actor"), ("critic", "critic_task", "critic"),
                  ("actor_exploration", "actor_exploration", "actor"))


def p2e_state(agent, train_state) -> Dict[str, Any]:
    """An exploration checkpoint's model, optimizer and Moments entries in
    the JAX package's keys."""
    modules = {"world_model": agent.world_model, "ensembles": agent.ensembles, "actor": agent.actor,
               "critic": agent.critic, "actor_exploration": agent.actor_exploration}
    opt = {jax_g: adam_state_to_tree(train_state.opt_states[port_g], modules[port_g], mapping)
           for port_g, jax_g, mapping in P2E_OPT_GROUPS}
    opt["critics_exploration"] = {
        n: adam_state_to_tree(train_state.opt_states["critics_exploration"][n], pair["module"], "critic")
        for n, pair in agent.critics_exploration.items()
    }
    return {**torch_to_flax(agent), "opt_states": opt, "moments_task": dict(train_state.moments["task"]),
            "moments_exploration": {n: dict(v) for n, v in train_state.moments["exploration"].items()}}


def load_p2e_state(agent, train_state, state: Dict[str, Any], device=None) -> None:
    """The inverse of :func:`p2e_state`, into ``agent`` and ``train_state``."""
    load_flax_params(agent, {k: state[k] for k in P2E_KEYS})
    modules = {"world_model": agent.world_model, "ensembles": agent.ensembles, "actor": agent.actor,
               "critic": agent.critic, "actor_exploration": agent.actor_exploration}
    for port_g, jax_g, mapping in P2E_OPT_GROUPS:
        train_state.opt_states[port_g] = adam_state_from_tree(state["opt_states"][jax_g], modules[port_g], mapping)
    train_state.opt_states["critics_exploration"] = {
        n: adam_state_from_tree(state["opt_states"]["critics_exploration"][n], pair["module"], "critic")
        for n, pair in agent.critics_exploration.items()
    }
    train_state.moments = {"task": moments_to_torch(state["moments_task"], device),
                           "exploration": {n: moments_to_torch(state["moments_exploration"][n], device)
                                           for n in agent.critics_cfg}}


def _map_agent(m, agent: torch.nn.Module) -> None:
    """The whole mapping of a SAC agent, a P2E-DV3 agent, a DreamerV3 agent
    or a DreamerV3 player."""
    if _is_p2e(agent):
        _map_p2e(m, agent)
        return
    if _is_sac(agent):
        _sac_actor(m, agent.actor, "actor", "actor")
        for name in ("critic", "target_critic"):
            _sac_critic(m, getattr(agent, name), name, name)
        m.put("log_alpha", m.take("log_alpha"))
        return
    wm = agent.world_model
    _encoder_rssm(m, wm, "world_model", "world_model")
    if _is_full_agent(agent):
        _training_heads(m, wm, "world_model", "world_model")
        for name in _critics(agent):
            m.mlp(f"{name}/params", name, len(getattr(agent, name).layers), head=True, block=_trunk(agent.critic)[1])
    _actor(m, agent.actor, "actor", "actor")


def _map_group(m, module: torch.nn.Module, group: str) -> None:
    """The mapping of one optimizer group (world_model, actor or critic)."""
    if group == "world_model":
        _encoder_rssm(m, module, group, group)
        _training_heads(m, module, group, group)
    elif group == "ensembles":
        _stacked_mlp(m, module, f"{group}/params", group)
    elif group == "actor" and hasattr(module, "log_std"):
        _sac_actor(m, module, group, group)
    elif group == "actor":
        _actor(m, module, group, group)
    elif hasattr(module, "biases"):
        _sac_critic(m, module, group, group)
    else:
        m.mlp(f"{group}/params", group, len(module.layers), head=True, block=_trunk(module)[1])


def _group_params(tree: Dict[str, Any], module: torch.nn.Module, group: str) -> Dict[str, torch.Tensor]:
    """One optimizer group's tree in the layout of ``module.named_parameters()``."""
    m = _Mapper(flatten_tree({group: tree}))
    _map_group(m, module, group)
    want = {f"{group}.{k}": v for k, v in module.named_parameters()}
    return {k[len(group) + 1 :]: v for k, v in _finish(m, want).items()}


def _adam_leaf(state: Any) -> Any:
    """The ``ScaleByAdamState`` inside an optax chain state."""
    if hasattr(state, "mu") and hasattr(state, "nu") and hasattr(state, "count"):
        return state
    if isinstance(state, tuple):
        for item in state:
            found = _adam_leaf(item)
            if found is not None:
                return found
    return None


def opt_state_to_torch(state: Any, module: torch.nn.Module, group: str, device=None):
    """An optax ``chain(clip_by_global_norm, adam)`` state of one group as
    the port's :class:`~sheeprl_tpu_torch.optim.AdamState` for ``module``'s
    parameters.  SAC's ``alpha`` group (``module`` the agent) maps its one
    leaf to ``log_alpha``."""
    from sheeprl_tpu_torch.optim import AdamState

    adam = _adam_leaf(state)
    if adam is None:
        raise ConversionError(f"no Adam state (count, mu, nu) in the {group} optimizer state")
    dev = next(module.parameters()).device if device is None else device
    if group == "alpha":
        want = tuple(module.log_alpha.shape)
        moments = []
        for leaf in (adam.mu, adam.nu):
            arr = np.array(leaf, dtype=np.float32)
            if arr.shape != want:
                raise ConversionError(f"alpha: flax gives {arr.shape}, the port holds {want}")
            moments.append({"log_alpha": torch.from_numpy(arr).to(dev)})
        return AdamState(int(np.asarray(adam.count)), *moments)
    mu = {k: v.to(dev) for k, v in _group_params(adam.mu, module, group).items()}
    nu = {k: v.to(dev) for k, v in _group_params(adam.nu, module, group).items()}
    return AdamState(int(np.asarray(adam.count)), mu, nu)


def moments_to_torch(state: Dict[str, Any], device=None) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(float(np.asarray(state[k])), dtype=torch.float32, device=device) for k in ("low", "high")}


def load_flax_params(agent: torch.nn.Module, tree: Dict[str, Any]) -> torch.nn.Module:
    """Convert ``tree`` and load it into ``agent`` (on the agent's device)."""
    agent.load_state_dict(flax_to_torch(tree, agent), strict=True)
    return agent


def load_group_params(module: torch.nn.Module, tree: Dict[str, Any], group: str) -> torch.nn.Module:
    """Load one group's flax tree (``"actor"``: a SAC or DreamerV3 actor;
    ``"critic"``; ``"world_model"``) into ``module``, on its device."""
    dev = next(module.parameters()).device
    module.load_state_dict({k: v.to(dev) for k, v in _group_params(tree, module, group).items()}, strict=True)
    return module


def group_to_flax(tensors: Dict[str, torch.Tensor], module: torch.nn.Module, group: str) -> Dict[str, Any]:
    """The inverse of :func:`_group_params`: one optimizer group's tensors
    (keyed as ``module.named_parameters()``) as the group's flax tree."""
    m = _Inverse({f"{group}.{k}": v for k, v in tensors.items()})
    _map_group(m, module, group)
    return m.tree()[group]


def adam_state_to_tree(state: Any, module: torch.nn.Module, group: str) -> Dict[str, Any]:
    """One group's Adam state for a checkpoint: ``{"count", "mu", "nu"}``,
    its moments in the JAX package's layout of the group (SAC's ``alpha``:
    the ``log_alpha`` leaf)."""
    if group == "alpha":
        return {"count": int(state.count), "mu": state.mu["log_alpha"], "nu": state.nu["log_alpha"]}
    return {"count": int(state.count), "mu": group_to_flax(state.mu, module, group),
            "nu": group_to_flax(state.nu, module, group)}


def adam_state_from_tree(tree: Dict[str, Any], module: torch.nn.Module, group: str, device=None):
    """The inverse of :func:`adam_state_to_tree`, on ``device`` (the module's by default)."""
    from sheeprl_tpu_torch.optim import AdamState

    if not isinstance(tree, dict) or set(tree) != {"count", "mu", "nu"}:
        raise ConversionError(
            f"the checkpoint's {group} optimizer state is not the port's Adam state (keys count, mu, nu); "
            "only checkpoints written by the port resume"
        )
    dev = next(module.parameters()).device if device is None else device
    if group == "alpha":
        mu, nu = ({"log_alpha": torch.as_tensor(np.asarray(tree[k]), dtype=torch.float32, device=dev)} for k in ("mu", "nu"))
    else:
        mu, nu = ({k: v.to(dev) for k, v in _group_params(tree[m], module, group).items()} for m in ("mu", "nu"))
    return AdamState(int(np.asarray(tree["count"])), mu, nu)


def adam_state_from_checkpoint(tree: Any, module: torch.nn.Module, group: str, device=None):
    """One group's Adam state from either package's checkpoint: the port's
    ``{"count", "mu", "nu"}`` (:func:`adam_state_from_tree`) or an optax
    state as the JAX package writes it (:func:`opt_state_to_torch`)."""
    if isinstance(tree, dict) and set(tree) == {"count", "mu", "nu"}:
        return adam_state_from_tree(tree, module, group, device)
    return opt_state_to_torch(tree, module, group, device)


def opt_state_to_tree(state: Any, agent: torch.nn.Module) -> Dict[str, Any]:
    """A PPO/A2C agent's optimizer state for a checkpoint, its moments in the
    JAX package's parameter layout: ``{"count", "mu", "nu"}`` for Adam,
    ``{"nu"}`` for RMSprop."""
    from sheeprl_tpu_torch.optim import AdamState

    if isinstance(state, AdamState):
        return {"count": int(state.count), "mu": torch_to_flax(agent, state.mu), "nu": torch_to_flax(agent, state.nu)}
    return {"nu": torch_to_flax(agent, state.nu)}


def opt_state_from_tree(tree: Dict[str, Any], agent: torch.nn.Module, tx) -> Any:
    """The inverse of :func:`opt_state_to_tree` for ``tx`` (the port's
    ``Adam`` or ``RMSprop``), on the agent's device."""
    from sheeprl_tpu_torch.optim import Adam, AdamState, RMSpropState

    dev = next(agent.parameters()).device
    want = {"count", "mu", "nu"} if isinstance(tx, Adam) else {"nu"}
    if not isinstance(tree, dict) or set(tree) != want:
        raise ConversionError(
            f"the checkpoint's optimizer state is not the port's {type(tx).__name__} state (keys {sorted(want)}); "
            "only checkpoints written by the port resume"
        )

    def moment(t):
        return {k: v.to(dev) for k, v in flax_to_torch(t, agent).items()}

    if isinstance(tx, Adam):
        return AdamState(int(np.asarray(tree["count"])), moment(tree["mu"]), moment(tree["nu"]))
    return RMSpropState(moment(tree["nu"]))
