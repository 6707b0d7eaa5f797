"""Prioritized replay: the device sum-tree (counterpart of ``sheeprl_tpu/replay``).

The samples-per-insert rate limiter and the remote replay service wait for
later slices."""

from sheeprl_tpu_torch.replay.priority_tree import PriorityTree, per_beta_schedule, priority_from_td

__all__ = ["PriorityTree", "per_beta_schedule", "priority_from_td"]
