"""SAC (counterpart of ``sheeprl_tpu/algos/sac``): the agent, its losses and
the gradient dispatch with uniform or prioritized replay."""
