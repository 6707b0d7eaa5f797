"""DreamerV2 (counterpart of ``sheeprl_tpu/algos/dreamer_v2``): its agent,
world-model loss and gradient step, trained on DreamerV3's env loop as a
family of its own."""
