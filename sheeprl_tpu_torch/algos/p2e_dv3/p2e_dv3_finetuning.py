"""Plan2Explore-DreamerV3's finetuning phase (counterpart of
``sheeprl_tpu/algos/p2e_dv3/p2e_dv3_finetuning.py``).

Starts from the exploration run's checkpoint
(``checkpoint.exploration_ckpt_path``, the port's or the JAX package's): the
world model, both actors and the task critic, with the optimizer and
Moments states the checkpoint holds (the ensembles and the exploration
critics neither train nor act here: they are not built);
the model keys of the exploration run's config (``config.yaml`` two levels
above the checkpoint) replace this run's; ``buffer.load_from_exploration``
inherits the exploration replay.  It trains the task behaviour with
DreamerV3's step on DreamerV3's env loop (``dreamer_v3.py:run_dreamer``):
the player acts with the exploration actor from the first step (no random
warm-up), switches to the task actor at the first gradient step, and the
closing test (few-shot) runs the task actor.
"""

from __future__ import annotations

import pathlib

from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DreamerFamily, DreamerRun, make_train_state, run_dreamer
from sheeprl_tpu_torch.utils.registry import register_algorithm

__all__ = ["P2E_FINETUNING_FAMILY", "finetuning_family", "load_exploration_cfg", "main"]

# the exploration config's keys that fix the models' shapes (p2e_dv3_finetuning.py:67-80)
MODEL_KEYS = ("gamma", "lmbda", "horizon", "dense_units", "mlp_layers", "dense_act", "cnn_act", "unimix",
              "hafner_initialization", "world_model", "actor", "critic", "cnn_keys", "mlp_keys", "cnn_layer_norm",
              "mlp_layer_norm")
# DreamerV3's agent's parts and the checkpoint's names for them (also of the optimizer groups)
TASK_KEYS = {"world_model": "world_model", "actor": "actor_task", "critic": "critic_task",
             "target_critic": "target_critic_task"}


def load_exploration_cfg(ckpt_path: str):
    """The exploration run's config: ``config.yaml`` two levels above the
    checkpoint file (``<log_dir>/checkpoint/ckpt_*.ckpt``)."""
    from sheeprl_tpu_torch.config import dotdict
    from sheeprl_tpu_torch.config.compose import yaml_load

    cfg_path = pathlib.Path(ckpt_path).parent.parent / "config.yaml"
    if not cfg_path.exists():
        raise RuntimeError(f"Cannot find the exploration config at: {cfg_path}")
    with open(cfg_path) as f:
        return dotdict(yaml_load(f.read()))


def finetuning_family(name: str, model_keys, task_keys, build_agent, build_actor, make_state, **family) -> DreamerFamily:
    """A Plan2Explore finetuning family of the Dreamer loop (module
    docstring): ``model_keys`` are pinned to the exploration run's config,
    ``task_keys`` name the agent's parts in the checkpoint, ``build_agent``
    and ``make_state`` build the task agent and its train state,
    ``build_actor(runtime, actions_dim, is_continuous, cfg)`` the
    exploration actor; ``family`` holds the rest of the
    :class:`DreamerFamily` (the player, the generation)."""
    groups = ("world_model", "actor", "critic")

    def load_state(cfg):
        """Pin the model keys to the exploration run's, then the checkpoint to
        start from: this run's own when it resumes, else the exploration's."""
        from sheeprl_tpu_torch.utils.ckpt_format import load_checkpoint

        ckpt_path = cfg.checkpoint.get("exploration_ckpt_path")
        if not ckpt_path or ckpt_path == "???":
            raise ValueError(f"{cfg.algo.name} needs checkpoint.exploration_ckpt_path=<an exploration run's checkpoint>")
        exploration_cfg = load_exploration_cfg(ckpt_path)
        for key in model_keys:
            if key in exploration_cfg.algo:
                cfg.algo[key] = exploration_cfg.algo[key]
        cfg.env.clip_rewards = exploration_cfg.env.clip_rewards
        if cfg.buffer.get("load_from_exploration", False) and exploration_cfg.buffer.checkpoint:
            cfg.env.num_envs = exploration_cfg.env.num_envs
        return load_checkpoint(cfg.checkpoint.resume_from or ckpt_path)

    def setup(runtime, cfg, actions_dim, is_continuous, observation_space, state) -> DreamerRun:
        from sheeprl_tpu_torch.utils.convert import (
            adam_state_from_checkpoint,
            adam_state_to_tree,
            group_to_flax,
            load_flax_params,
            load_group_params,
            moments_to_torch,
            torch_to_flax,
        )

        # what trains, acts or is saved here: the task agent and the exploration actor
        agent = build_agent(runtime, actions_dim, is_continuous, cfg, observation_space)
        load_flax_params(agent, {k: state[key] for k, key in task_keys.items()})
        actor_exploration = load_group_params(build_actor(runtime, actions_dim, is_continuous, cfg),
                                              state["actor_exploration"], "actor")
        train_state = make_state(runtime, agent, cfg, is_continuous, actions_dim)
        saved = state.get("opt_states", {})
        for g in groups:
            if task_keys[g] in saved:
                train_state.opt_states[g] = adam_state_from_checkpoint(saved[task_keys[g]], getattr(agent, g), g)
        keeps_moments = bool(train_state.moments)
        if keeps_moments and "moments_task" in state:
            train_state.moments = moments_to_torch(state["moments_task"], runtime.device)

        def ckpt_state():
            params = torch_to_flax(agent)
            out = {
                **{key: params[k] for k, key in task_keys.items()},
                "actor_exploration": group_to_flax(dict(actor_exploration.named_parameters()), actor_exploration,
                                                   "actor"),
                "opt_states": {task_keys[g]: adam_state_to_tree(train_state.opt_states[g], getattr(agent, g), g)
                               for g in groups},
            }
            if keeps_moments:
                out["moments_task"] = dict(train_state.moments)
            return out

        start = actor_exploration if str(cfg.algo.player.actor_type) == "exploration" else agent.actor
        return DreamerRun(train_state, start, ckpt_state, train_actor=agent.actor, test_actor=agent.actor)

    return DreamerFamily(
        name=name,
        load_state=load_state,
        setup=setup,
        restore_rb=lambda cfg, state: (bool(cfg.checkpoint.resume_from) or bool(cfg.buffer.get("load_from_exploration", False)))
        and "rb" in state,
        random_warmup=False,
        test_name="few-shot",
        **family,
    )


def _build_agent(*args):
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent

    return build_agent(*args)


def _build_actor(*args):
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_actor

    return build_actor(*args)


P2E_FINETUNING_FAMILY = finetuning_family("P2E-DV3", MODEL_KEYS, TASK_KEYS, _build_agent, _build_actor, make_train_state)


@register_algorithm()
def main(runtime, cfg):
    """The finetuning phase on DreamerV3's env loop (module docstring).
    Returns the run's summary."""
    return run_dreamer(runtime, cfg, P2E_FINETUNING_FAMILY)
